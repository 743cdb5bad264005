"""Corpus-scale packed on-disk feature cache (a copy of
genie2_tpu/train/cache.py; numpy only, same layout, so either package reads
the other's cache).

A parsed structure is stored as the three arrays it carries: per-chain
lengths, aatype as int8 indices and float32 CA coordinates (about 17 bytes
a residue), in flat binary files read through numpy memmaps. The rest of
the feature dict is derived by `create_empty_features`, as
`features_from_pdb` builds it, so a cache hit reconstructs the same
feature dict (coordinates through float32).

Layout of a cache directory:
    meta.json          {"version": 1, "n_structures": S, "n_residues": R, "fingerprint": ...}
    res_offsets.npy    [S+1] int64 prefix sums of residue counts
    chain_offsets.npy  [S+1] int64 prefix sums of chain counts
    chain_lens.npy     [total_chains] int32 per-chain residue counts
    aatype.i8          [R] int8 amino-acid indices (raw binary)
    coords.f32         [R, 3] float32 CA coordinates (raw binary)

Builds stream one structure at a time into a temporary directory renamed
into place on success, so an interrupted build never leaves a half-valid
cache.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
from typing import Iterable, Iterator, List, Optional

import numpy as np

from genie2_tpu_torch.features import Features, create_empty_features
from genie2_tpu_torch.features.residues import NUM_RESTYPES

_META_NAME = "meta.json"
_VERSION = 1

# Shared identity lookup for int8 -> one-hot reconstruction.
_EYE_INT = np.eye(NUM_RESTYPES, dtype=int)


def is_packed_cache(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _META_NAME))


def _extract(features: Features):
    """The three stored arrays of a feature dict (the rest is derived)."""
    lengths = np.asarray(features["num_residues_per_chain"], dtype=np.int32)
    lengths = lengths[lengths > 0]
    aatype = np.argmax(features["aatype"], axis=-1).astype(np.int8)
    coords = np.asarray(features["atom_positions"], dtype=np.float32)
    return lengths, aatype, coords


def build_packed_cache(
    feature_iter: Iterable[Features],
    cache_dir: str,
    progress_every: int = 0,
    fingerprint: Optional[str] = None,
) -> "PackedCache":
    """Stream feature dicts into a packed cache directory.

    Memory use is O(one structure); suitable for corpora far larger than
    host RAM. The directory appears atomically (per-process tmp build +
    rename, so concurrent builds — e.g. multi-host training over a
    shared rootdir — cannot corrupt each other; last finisher wins with a
    complete cache). `fingerprint` (corpus identity, see
    corpus_fingerprint) is stored in meta.json and checked on reuse."""
    tmp_dir = f"{cache_dir.rstrip('/')}.building.{os.getpid()}"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)

    res_offsets: List[int] = [0]
    chain_offsets: List[int] = [0]
    chain_lens: List[np.ndarray] = []
    n = 0
    with open(os.path.join(tmp_dir, "aatype.i8"), "wb") as f_aa, open(
        os.path.join(tmp_dir, "coords.f32"), "wb"
    ) as f_xyz:
        for features in feature_iter:
            lengths, aatype, coords = _extract(features)
            f_aa.write(aatype.tobytes())
            f_xyz.write(np.ascontiguousarray(coords).tobytes())
            res_offsets.append(res_offsets[-1] + len(aatype))
            chain_offsets.append(chain_offsets[-1] + len(lengths))
            chain_lens.append(lengths)
            n += 1
            if progress_every and n % progress_every == 0:
                print(f"[cache] packed {n} structures", flush=True)

    np.save(
        os.path.join(tmp_dir, "res_offsets.npy"),
        np.asarray(res_offsets, dtype=np.int64),
    )
    np.save(
        os.path.join(tmp_dir, "chain_offsets.npy"),
        np.asarray(chain_offsets, dtype=np.int64),
    )
    np.save(
        os.path.join(tmp_dir, "chain_lens.npy"),
        np.concatenate(chain_lens).astype(np.int32)
        if chain_lens
        else np.zeros(0, np.int32),
    )
    with open(os.path.join(tmp_dir, _META_NAME), "w") as f:
        json.dump(
            {
                "version": _VERSION,
                "n_structures": n,
                "n_residues": res_offsets[-1],
                "fingerprint": fingerprint,
            },
            f,
        )
    if os.path.exists(cache_dir):
        shutil.rmtree(cache_dir)
    try:
        os.replace(tmp_dir, cache_dir)
    except OSError as exc:
        # Concurrent builds over a shared rootdir: another process
        # completed its rename between our rmtree and replace
        # (os.replace onto a re-created non-empty directory raises
        # ENOTEMPTY). Its cache is complete — the rename publishing it
        # is atomic — so discard ours and attach to the winner's.
        # Anything else (EACCES, EXDEV, ...) is a genuine failure: the
        # winner's cache does not exist, so re-raise instead of handing
        # PackedCache a missing directory.
        if exc.errno not in (errno.ENOTEMPTY, errno.EEXIST, errno.ENOTDIR):
            raise
        if not is_packed_cache(cache_dir):
            raise
    finally:
        # Success renames tmp_dir away; every failure path must not leak
        # a corpus-sized tmp directory into rootdir.
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return PackedCache(cache_dir)


def corpus_fingerprint(filepaths: List[str]) -> str:
    """Identity of a corpus for cache validation: count + sha1 over the
    sorted basenames. Catches the silent-mismatch failure (a cache built
    from a 16-file --test run being reused by a full run, or vice versa)
    without touching file contents."""
    import hashlib

    names = "\n".join(sorted(os.path.basename(p) for p in filepaths))
    return f"{len(filepaths)}:{hashlib.sha1(names.encode()).hexdigest()[:16]}"


def build_packed_cache_from_files(
    filepaths: List[str], cache_dir: str, progress_every: int = 10000
) -> "PackedCache":
    """Parse PDB files straight into a packed cache, one structure resident
    at a time."""
    from genie2_tpu_torch.features import features_from_pdb

    def gen() -> Iterator[Features]:
        for path in filepaths:
            yield features_from_pdb(path)

    return build_packed_cache(
        gen(), cache_dir, progress_every=progress_every,
        fingerprint=corpus_fingerprint(filepaths),
    )


class PackedCache:
    """Random-access reader over a packed cache directory."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        with open(os.path.join(cache_dir, _META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _VERSION:
            raise ValueError(
                f"packed cache version {self.meta.get('version')} != {_VERSION}"
            )
        self._res_offsets = np.load(os.path.join(cache_dir, "res_offsets.npy"))
        self._chain_offsets = np.load(os.path.join(cache_dir, "chain_offsets.npy"))
        self._chain_lens = np.load(os.path.join(cache_dir, "chain_lens.npy"))
        n_res = int(self.meta["n_residues"])
        if n_res == 0:  # zero-byte files cannot be memmapped
            self._aatype = np.zeros((0,), np.int8)
            self._coords = np.zeros((0, 3), np.float32)
        else:
            self._aatype = np.memmap(
                os.path.join(cache_dir, "aatype.i8"), dtype=np.int8, mode="r",
                shape=(n_res,),
            )
            self._coords = np.memmap(
                os.path.join(cache_dir, "coords.f32"), dtype=np.float32, mode="r",
                shape=(n_res, 3),
            )

    def __len__(self) -> int:
        return int(self.meta["n_structures"])

    def load(self, idx: int) -> Features:
        """Reconstruct the full 12-key feature dict for one structure —
        identical (through the float32 device cast) to what
        features_from_pdb produced at build time."""
        lo, hi = int(self._res_offsets[idx]), int(self._res_offsets[idx + 1])
        clo, chi = int(self._chain_offsets[idx]), int(self._chain_offsets[idx + 1])
        lengths = [int(l) for l in self._chain_lens[clo:chi]]
        features = create_empty_features(lengths)
        features["aatype"] = _EYE_INT[np.asarray(self._aatype[lo:hi])]
        features["atom_positions"] = np.asarray(self._coords[lo:hi]).astype(float)
        return features

    def lengths(self) -> np.ndarray:
        """[S] residue counts without touching the data files."""
        return np.diff(self._res_offsets)
