"""Training data pipeline (a copy of genie2_tpu/train/data.py; numpy only).

Structures are parsed once into a cache (the packed memmap cache of
train/cache.py by default) and an epoch only slices, samples the motif
masks, pads and stacks. Every batch is padded to the configuration's
(max_n_chain, max_n_res). The train / validation split is kept as name
lists (train.txt / validation.txt) under {rootdir}/{name}/. The data order
is numpy's: a permutation from the epoch's generator and one child seed a
batch, so `start_batch` skips ahead to the same batches; the epochs are
byte-identical to genie2_tpu's (tests/test_torch_train_data.py).

Motif-conditioning augmentation implements Genie 2 Algorithm 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from genie2_tpu_torch.features import (
    Features,
    create_empty_features,
    features_from_pdb,
    pad_features,
    summarize_pdb,
)


def discover_structures(datadir: str) -> List[str]:
    """All .pdb / .pdb.gz basenames in a directory."""
    names = set()
    for fname in sorted(os.listdir(datadir)):
        if fname.endswith(".pdb.gz"):
            names.add(fname[: -len(".pdb.gz")])
        elif fname.endswith(".pdb"):
            names.add(fname[: -len(".pdb")])
    return sorted(names)


def resolve_filepath(datadir: str, name: str) -> Optional[str]:
    """Prefer .pdb.gz, fall back to .pdb."""
    for suffix in (".pdb.gz", ".pdb"):
        path = os.path.join(datadir, name + suffix)
        if os.path.exists(path):
            return path
    return None


def setup_split(
    rootdir: str,
    name: str,
    datadir: str,
    min_n_res: int,
    max_n_res: int,
    max_n_chain: int,
    validation_split: Optional[float] = None,
    seed: int = 100,
):
    """Create (or reuse) persistent train/validation name lists under
    {rootdir}/{name}/. Returns (train_names, validation_names)."""
    basedir = os.path.join(rootdir, name)
    os.makedirs(basedir, exist_ok=True)
    train_path = os.path.join(basedir, "train.txt")
    val_path = os.path.join(basedir, "validation.txt")

    if os.path.exists(train_path):
        train_names = [l.strip() for l in open(train_path) if l.strip()]
        val_names = (
            [l.strip() for l in open(val_path) if l.strip()]
            if os.path.exists(val_path)
            else []
        )
        return train_names, val_names

    names = []
    for n in discover_structures(datadir):
        path = resolve_filepath(datadir, n)
        summary = summarize_pdb(path)
        if (
            min_n_res <= summary["num_residues"] <= max_n_res
            and summary["num_chains"] <= max_n_chain
        ):
            names.append(n)

    rng = np.random.default_rng(seed)
    rng.shuffle(names)
    n_val = int(len(names) * validation_split) if validation_split else 0
    val_names, train_names = names[:n_val], names[n_val:]

    with open(train_path, "w") as f:
        f.write("\n".join(train_names) + ("\n" if train_names else ""))
    if validation_split is not None:
        with open(val_path, "w") as f:
            f.write("\n".join(val_names) + ("\n" if val_names else ""))
    return train_names, val_names


def apply_motif_augmentation(
    features: Features,
    rng: np.random.Generator,
    min_pct_res: float,
    max_pct_res: float,
    min_n_seg: int,
    max_n_seg: int,
) -> Features:
    """Genie 2 Algorithm 1: sample a motif size and a segmentation, shuffle
    segments among scaffold residues, build masks."""
    assert int(features["num_chains"]) == 1, "Input must be monomer"
    n_res = int(features["num_residues"])

    lo = int(np.floor(n_res * min_pct_res))
    hi = int(np.ceil(n_res * max_pct_res))
    # Clamps only bind for very short chains (n_res=16 at 5-50% gives
    # lo=0): at least 1 motif residue and a non-empty integer range keep
    # tiny-structure corpora trainable; normal sizes are unaffected.
    motif_n_res = max(1, int(rng.integers(lo, max(hi, lo + 1))))
    seg_hi = max(min(max_n_seg, motif_n_res) + 1, min_n_seg + 1)
    motif_n_seg = int(rng.integers(min_n_seg, seg_hi))
    motif_n_seg = min(motif_n_seg, motif_n_res)

    indices = np.sort(rng.choice(motif_n_res - 1, motif_n_seg - 1, replace=False) + 1)
    indices = np.concatenate([[0], indices, [motif_n_res]])
    seg_lens = np.diff(indices)

    # Shuffle motif segments among scaffold singletons.
    segs: List[np.ndarray] = [np.ones(l, dtype=bool) for l in seg_lens]
    segs.extend(np.zeros(1, dtype=bool) for _ in range(n_res - motif_n_res))
    order = rng.permutation(len(segs))
    seq_mask = np.concatenate([segs[i] for i in order])

    features = dict(features)
    features["fixed_sequence_mask"] = seq_mask
    features["fixed_structure_mask"] = (seq_mask[:, None] * seq_mask[None, :]).astype(bool)
    return features


@dataclass
class MotifAugmentConfig:
    prob: float = 0.8
    min_pct_res: float = 0.05
    max_pct_res: float = 0.5
    min_n_seg: int = 1
    max_n_seg: int = 4

    @staticmethod
    def from_config(config) -> "MotifAugmentConfig":
        io = config.io
        return MotifAugmentConfig(
            prob=io["motif_prob"],
            min_pct_res=io["motif_min_pct_res"],
            max_pct_res=io["motif_max_pct_res"],
            min_n_seg=io["motif_min_n_seg"],
            max_n_seg=io["motif_max_n_seg"],
        )


class StructureDataset:
    """Parse-once dataset with epoch iteration.

    Each item is a padded feature dict [max_n_res]; batches are stacked
    numpy dicts ready for `features.to_device`. Two cache backends behind
    one `cache_path`: a packed on-disk cache (any path not ending in .npz,
    train/cache.py; host memory stays bounded whatever the corpus size)
    and an in-RAM `.npz` blob for tiny corpora.
    """

    def __init__(
        self,
        filepaths: List[str],
        max_n_res: int,
        max_n_chain: int,
        motif: Optional[MotifAugmentConfig] = None,
        cache_path: Optional[str] = None,
    ):
        self.filepaths = list(filepaths)
        self.max_n_res = max_n_res
        self.max_n_chain = max_n_chain
        self.motif = motif
        self._cache: List[Features] = []
        self._packed = None
        self._load(cache_path)

    def _load(self, cache_path: Optional[str]):
        if cache_path and not cache_path.endswith(".npz"):
            from genie2_tpu_torch.train.cache import (
                PackedCache,
                build_packed_cache_from_files,
                corpus_fingerprint,
                is_packed_cache,
            )

            if is_packed_cache(cache_path):
                cache = PackedCache(cache_path)
                want = corpus_fingerprint(self.filepaths)
                # Empty filepaths = attach-only mode (tools that open a
                # pre-built cache directly); trust the cache as-is.
                if not self.filepaths or cache.meta.get("fingerprint") == want:
                    self._packed = cache
                    return
                # A cache built from a different corpus (e.g. a --test
                # run's 16-file subset) must never be served silently.
                print(
                    f"[cache] {cache_path} was built from a different "
                    f"corpus ({cache.meta.get('fingerprint')} != {want}); "
                    "rebuilding",
                    flush=True,
                )
            self._packed = build_packed_cache_from_files(
                self.filepaths, cache_path
            )
            return
        if cache_path and os.path.exists(cache_path):
            blob = np.load(cache_path, allow_pickle=True)
            self._cache = list(blob["features"])
            return
        for path in self.filepaths:
            self._cache.append(features_from_pdb(path))
        if cache_path:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            np.savez_compressed(
                cache_path, features=np.array(self._cache, dtype=object)
            )

    @property
    def _backend(self):
        # getattr: several tools build bare datasets via __new__ + _cache
        # (synthetic_dataset and friends) without touching _load.
        return getattr(self, "_packed", None)

    def __len__(self):
        packed = self._backend
        return len(packed) if packed is not None else len(self._cache)

    def get(self, idx: int, rng: np.random.Generator) -> Features:
        packed = self._backend
        if packed is not None:
            features = packed.load(idx)
        else:
            features = self._cache[idx]
        if self.motif is not None and rng.random() <= self.motif.prob:
            features = apply_motif_augmentation(
                features,
                rng,
                self.motif.min_pct_res,
                self.motif.max_pct_res,
                self.motif.min_n_seg,
                self.motif.max_n_seg,
            )
        return pad_features(dict(features), self.max_n_chain, self.max_n_res)

    def epoch(
        self,
        batch_size: int,
        rng: np.random.Generator,
        drop_last: bool = True,
        start_batch: int = 0,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled batches of stacked feature dicts; incomplete trailing
        batches are dropped by default to keep shapes static.

        Each batch gets a child generator seeded from the master rng, so
        `start_batch` can skip ahead (mid-epoch resume) while reproducing
        exactly the batches an uninterrupted epoch would have produced."""
        order = rng.permutation(len(self))
        for b, start in enumerate(range(0, len(order), batch_size)):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            seed = rng.integers(2**63)  # always drawn, even when skipping
            if b < start_batch:
                continue
            batch_rng = np.random.default_rng(seed)
            items = [self.get(int(i), batch_rng) for i in idx]
            yield {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}


def synthetic_dataset(
    n_structures: int,
    max_n_res: int,
    rng: Optional[np.random.Generator] = None,
    min_n_res: int = 20,
    motif: Optional[MotifAugmentConfig] = None,
) -> StructureDataset:
    """A dataset of random-walk C-alpha traces for tests and benchmarks
    (no PDB files needed)."""
    rng = rng or np.random.default_rng(0)
    ds = StructureDataset.__new__(StructureDataset)
    ds.filepaths = []
    ds.max_n_res = max_n_res
    ds.max_n_chain = 1
    ds.motif = motif
    ds._cache = []
    ds._packed = None
    for _ in range(n_structures):
        n = int(rng.integers(min_n_res, max_n_res + 1))
        f = create_empty_features([n])
        steps = rng.normal(size=(n, 3)) * 1.5 + np.array([3.8, 0, 0])
        coords = np.cumsum(steps, axis=0)
        f["atom_positions"] = coords - coords.mean(0, keepdims=True)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, n)].astype(int)
        ds._cache.append(f)
    return ds
