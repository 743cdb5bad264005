"""MotifBench-style motif target loading (a copy of
genie2_tpu/sampling/motif_target.py; numpy and os only).

CA coordinates grouped into segments by TER records, COM-centered jointly
across all segments; the target protein length is read from the PDB's third
line (`... : <length>`)."""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def parse_motif_target_pdb(path: str) -> Tuple[List[np.ndarray], int]:
    """Returns (list of [len_i, 3] segment coords, protein_length)."""
    segments: List[List[List[float]]] = [[]]
    protein_length = None
    with open(path) as f:
        for i, line in enumerate(f):
            if i == 2 and ":" in line:
                try:
                    protein_length = int(line.split(":")[1].strip())
                except ValueError:
                    protein_length = None
            if line.startswith("TER"):
                if segments[-1]:
                    segments.append([])
            elif line.startswith("ATOM") and line[12:16].strip() == "CA":
                segments[-1].append(
                    [float(line[30:38]), float(line[38:46]), float(line[46:54])]
                )
    if not segments[-1]:
        segments.pop()
    coords = [np.asarray(s, dtype=np.float32) for s in segments]
    if protein_length is None:
        raise ValueError(
            f"{path}: missing target-length header on line 3 ('NAME : LENGTH')"
        )

    # COM-center jointly across all segments (sampler/utils.py:153-157).
    all_coords = np.concatenate(coords, axis=0)
    com = all_coords.mean(axis=0, keepdims=True)
    return [c - com for c in coords], protein_length


def motif_target_path(index: int, folder_path: str) -> str:
    files = sorted(
        (f for f in os.listdir(folder_path) if f.endswith(".pdb")),
        key=lambda x: int(x.split("_")[0]),
    )
    return os.path.join(folder_path, files[index])


def load_motif_target(index: int, folder_path: str) -> Tuple[List[np.ndarray], int]:
    """Load the index-th motif problem from a MotifBench-style directory
    (files sorted by their leading number, sampler/utils.py:130-151)."""
    return parse_motif_target_pdb(motif_target_path(index, folder_path))


def load_motif_target_info(index: int, folder_path: str) -> List[dict]:
    """Per-segment source metadata for benchmark manifests: a dict with
    chain / start / end (source residue numbers) per TER-separated segment.
    The reference never needed this (its manifests were written by hand);
    it feeds sampling.manifest.write_benchmark_manifests."""
    segments: List[dict] = []
    current: dict = {}
    with open(motif_target_path(index, folder_path)) as f:
        for line in f:
            if line.startswith("TER"):
                if current:
                    segments.append(current)
                    current = {}
            elif line.startswith("ATOM") and line[12:16].strip() == "CA":
                chain = line[21].strip() or "A"
                resid = int(line[22:26])
                if not current:
                    current = {"chain": chain, "start": resid, "end": resid}
                else:
                    current["end"] = resid
    if current:
        segments.append(current)
    return segments
