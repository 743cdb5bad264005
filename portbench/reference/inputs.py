"""The reference's own account of the inputs a run feeds the program.

The benchmark hands the program seeds, a motif problem file and a corpus
seed; the program derives noise, placements and batches from them. This file
derives them again, in plain numpy and torch, from the same seeds, so that
the reference takes none of them from the program:

- sampling noise: one stream a (seed, sample id, step), a CPU torch
  generator seeded from `np.random.SeedSequence([seed, id mod 2^64, step])`;
- features of an unconditional batch, or of a motif problem whose scaffold
  lengths are drawn by rejection from a numpy generator, padded to a bucket;
- the training corpus (random-walk C-alpha traces), its epochs (numpy's
  permutation and one child seed a batch) and Genie 2's motif augmentation
  (Algorithm 1), each item padded to the configuration's maximum length.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

NUM_RESTYPES = 20
RESTYPES_3 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE", "LEU", "LYS", "MET", "PHE",
              "PRO", "SER", "THR", "TRP", "TYR", "VAL")


def stream_noise(seed: int, sample_ids: Sequence[int], step: int, n_res: int) -> torch.Tensor:
    """[B, n_res, 3] standard normal noise on the CPU, one stream a sample."""
    out = []
    for sid in sample_ids:
        state = np.random.SeedSequence([int(seed), int(sid) % 2**64, int(step)]).generate_state(1, np.uint64)
        out.append(torch.randn((n_res, 3), generator=torch.Generator().manual_seed(int(state[0]) & (2**63 - 1))))
    return torch.stack(out)


def empty_features(n: int) -> Dict[str, np.ndarray]:
    return {
        "aatype": np.zeros((n, NUM_RESTYPES)), "num_residues": np.array(n), "atom_positions": np.zeros((n, 3)),
        "residue_mask": np.ones(n), "residue_index": np.arange(n), "chain_index": np.zeros(n),
        "fixed_sequence_mask": np.zeros(n, bool), "fixed_structure_mask": np.zeros((n, n), bool),
        "interface_mask": np.zeros(n, bool),
    }


def pad(f: Dict[str, np.ndarray], n: int) -> Dict[str, np.ndarray]:
    """Zeros past the structure's residues, up to n (both axes of the
    structure mask)."""
    out = {}
    for k, v in f.items():
        if k == "num_residues":
            out[k] = v
        elif k == "fixed_structure_mask":
            out[k] = np.pad(v, [(0, n - v.shape[0])] * 2)
        else:
            out[k] = np.pad(v, [(0, n - v.shape[0])] + [(0, 0)] * (v.ndim - 1))
    return out


def stack(items: List[Dict[str, np.ndarray]], n: int, device) -> Dict[str, torch.Tensor]:
    """Items padded to n residues, stacked, as tensors on `device`."""
    items = [pad(f, n) for f in items]
    out = {}
    for k in items[0]:
        v = np.stack([f[k] for f in items])
        dtype = torch.bool if v.dtype == bool else torch.float32 if k in ("atom_positions",) else torch.int64
        out[k] = torch.as_tensor(v, device=device).to(dtype)
    return out


def read_motif_problem(path: str):
    """(segments, total length bounds, motif residue types, motif CA
    coordinates) of a problem in the REMARK 999 grammar: segments are
    ("scaffold", lo, hi) or ("motif", length, group)."""
    segments, lo, hi, types, coords = [], None, None, [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("REMARK 999 INPUT"):
                if line[18] == " ":
                    segments.append(("scaffold", int(line[19:23]), int(line[23:27])))
                else:
                    group = line[28] if len(line) > 28 and line[28] != " " else "A"
                    segments.append(("motif", int(line[23:27]) - int(line[19:23]) + 1, ord(group) - ord("A") + 1))
            elif line.startswith("REMARK 999 MINIMUM TOTAL LENGTH"):
                lo = int(line[37:])
            elif line.startswith("REMARK 999 MAXIMUM TOTAL LENGTH"):
                hi = int(line[37:])
            elif line.startswith("ATOM") and line[13:15].strip() == "CA":
                types.append(RESTYPES_3.index(line[17:20]))
                coords.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
    return segments, (lo, hi), np.array(types), np.array(coords)


def motif_features(problem, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One placement: scaffold lengths drawn in order, uniformly in their
    bounds, until the total length is within its bounds."""
    segments, (lo, hi), types, coords = problem
    while True:
        seq, groups = [], []
        for kind, a, b in segments:
            n = int(rng.integers(a, b + 1)) if kind == "scaffold" else a
            seq += [kind == "motif"] * n
            groups += [0 if kind == "scaffold" else b] * n
        if lo <= len(seq) <= hi:
            break
    seq, groups = np.array(seq), np.array(groups)
    f = empty_features(len(seq))
    f["aatype"][seq] = np.eye(NUM_RESTYPES)[types]
    f["atom_positions"][seq] = coords
    f["fixed_sequence_mask"] = seq
    f["fixed_structure_mask"] = (groups[:, None] == groups[None, :]) & (groups[:, None] > 0)
    return f


def corpus(n_structures: int, min_len: int, max_len: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """Random-walk C-alpha traces (steps N(0, 1.5^2) + 3.8 A along x), centred,
    with random residue types; lengths uniform in [min_len, max_len]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_structures):
        n = int(rng.integers(min_len, max_len + 1))
        f = empty_features(n)
        coords = np.cumsum(rng.normal(size=(n, 3)) * 1.5 + np.array([3.8, 0, 0]), axis=0)
        f["atom_positions"] = coords - coords.mean(0, keepdims=True)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, n)]
        out.append(f)
    return out


def augment(f: Dict[str, np.ndarray], rng: np.random.Generator, prob: float, pct=(0.05, 0.5), n_seg=(1, 4)):
    """Genie 2 Algorithm 1: with probability `prob`, a motif of a random size
    in random segments, shuffled among single scaffold residues."""
    if rng.random() > prob:
        return f
    n = int(f["num_residues"])
    lo, hi = int(np.floor(n * pct[0])), int(np.ceil(n * pct[1]))
    n_motif = max(1, int(rng.integers(lo, max(hi, lo + 1))))
    k = min(int(rng.integers(n_seg[0], max(min(n_seg[1], n_motif) + 1, n_seg[0] + 1))), n_motif)
    cuts = np.concatenate([[0], np.sort(rng.choice(n_motif - 1, k - 1, replace=False) + 1), [n_motif]])
    parts = [np.ones(length, bool) for length in np.diff(cuts)] + [np.zeros(1, bool)] * (n - n_motif)
    seq = np.concatenate([parts[i] for i in rng.permutation(len(parts))])
    f = dict(f)
    f["fixed_sequence_mask"] = seq
    f["fixed_structure_mask"] = seq[:, None] & seq[None, :]
    return f


def epochs(items: List[Dict[str, np.ndarray]], batch_size: int, seed_rng: np.random.Generator, prob: float
           ) -> Iterator[List[Dict[str, np.ndarray]]]:
    """Batches of one epoch after another: a permutation of the corpus from
    `seed_rng`, one child generator a batch (its seed drawn from `seed_rng`),
    from which each item in turn draws its augmentation; a trailing partial
    batch is dropped."""
    while True:
        order = seed_rng.permutation(len(items))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            batch_rng = np.random.default_rng(seed_rng.integers(2**63))
            yield [augment(items[int(i)], batch_rng, prob) for i in order[start:start + batch_size]]
