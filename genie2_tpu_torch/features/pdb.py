"""Fixed-column PDB I/O for C-alpha traces: CA-only ATOM records, chains
split where the chain id changes, gzip support on reading, mean-centred
coordinates rounded to 3 decimals on writing, the motif group as segment id
at column 72 and element C at column 77 (the reference's layout)."""

from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np

from genie2_tpu_torch.features.residues import NUM_RESTYPES, RESTYPE_1_TO_3, RESTYPE_3_TO_1, RESTYPE_ORDER, RESTYPES
from genie2_tpu_torch.features.schema import Features, create_empty_features


def parse_pdb(filepath: str) -> Tuple[List[List[int]], List[List[List[float]]]]:
    """Per-chain residue-type indices and CA coordinates of a fixed-column
    PDB file. A new chain starts wherever the chain id (column 22) changes,
    so an id that comes back after another chain opens a fresh chain."""
    opener = gzip.open if filepath.endswith(".gz") else open
    with opener(filepath, "rt") as fh:
        records = [ln for ln in fh if ln.startswith("ATOM") and ln[13:15].strip() == "CA"]
    if not records:
        return [], []

    types = np.fromiter(
        (RESTYPE_ORDER[RESTYPE_3_TO_1[ln[17:20]]] for ln in records), dtype=np.int64, count=len(records)
    )
    xyz = np.array([(ln[30:38], ln[38:46], ln[46:54]) for ln in records], dtype=np.float64)
    chain_ids = np.array([ln[21] for ln in records])
    starts = np.flatnonzero(np.concatenate([[True], chain_ids[1:] != chain_ids[:-1]])).tolist()
    bounds = starts + [len(records)]
    seqs = [types[a:b].tolist() for a, b in zip(bounds, bounds[1:])]
    coords = [xyz[a:b].tolist() for a, b in zip(bounds, bounds[1:])]
    return seqs, coords


def summarize_pdb(filepath: str):
    seqs, _ = parse_pdb(filepath)
    return {"num_residues": int(np.sum([len(s) for s in seqs])), "num_chains": len(seqs)}


def features_from_pdb(filepath: str) -> Features:
    """PDB file -> feature dict with one-hot aatype and mean-centred CA
    coordinates (float64), as genie2_tpu's `features_from_pdb` builds it:
    the coordinates are rounded to float32 before they are centred, as
    genie2_tpu's default reader reads them. An 8-column field with three
    decimals rounds to the float32 that C's `strtof` gives it: such a value
    is never near enough a float32 midpoint for its float64 rounding to
    move it onto one."""
    seqs, coords = parse_pdb(filepath)
    features = create_empty_features([len(s) for s in seqs])
    positions = np.concatenate(coords).astype(np.float32).astype(np.float64)
    features["aatype"] = np.eye(NUM_RESTYPES)[np.concatenate(seqs)].astype(int)
    features["atom_positions"] = (positions - positions.mean(axis=0, keepdims=True)).astype(float)
    return features


def save_features_to_pdb(features: Features, filepath: str):
    """Write one structure's features as a CA-only PDB file."""

    def replace(string, index, substring):
        return string[:index] + substring + string[index + len(substring):]

    coords = features["atom_positions"]
    coords = coords - coords.mean(axis=0, keepdims=True)
    coords = np.around(coords, decimals=3)

    with open(filepath, "w") as file:
        for i in range(coords.shape[0]):
            residue_name = RESTYPE_1_TO_3[RESTYPES[int(np.argmax(features["aatype"][i]))]]
            group = (
                " "
                if features["fixed_group"][i] == 0
                else chr(int(features["fixed_group"][i]) - 1 + ord("A"))
            )
            line = " " * 80
            line = replace(line, 0, "ATOM")
            line = replace(line, 6, str(i + 1).rjust(5))
            line = replace(line, 13, "CA")
            line = replace(line, 17, residue_name)
            line = replace(line, 21, chr(ord("A") + int(features["chain_index"][i])))
            line = replace(line, 22, str(int(features["residue_index"][i]) + 1).rjust(4))
            line = replace(line, 30, str(coords[i][0]).rjust(8))
            line = replace(line, 38, str(coords[i][1]).rjust(8))
            line = replace(line, 46, str(coords[i][2]).rjust(8))
            line = replace(line, 72, group.ljust(4))
            line = replace(line, 77, "C")
            file.write(line + "\n")


def save_coords_to_pdb(coords: np.ndarray, filepath: str):
    """Write a bare [N, 3] CA trace as a single-chain all-ALA PDB file."""
    features = create_empty_features([len(coords)])
    features["atom_positions"] = np.asarray(coords, dtype=float)
    save_features_to_pdb(features, filepath)


def read_ca_coords(filepath: str) -> np.ndarray:
    """[N, 3] CA coordinates of a PDB file written by save_features_to_pdb."""
    with open(filepath) as fh:
        rows = [
            (ln[30:38], ln[38:46], ln[46:54])
            for ln in fh
            if ln.startswith("ATOM") and ln[13:15].strip() == "CA"
        ]
    return np.array(rows, dtype=np.float64).reshape(-1, 3)
