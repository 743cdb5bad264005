"""Secondary-structure annotation from C-alpha traces.

The P-SEA geometric criteria (Labesse et al. 1997) on numpy arrays, the
criteria biotite's CA-only annotator applies: per-residue pseudo angles and
dihedrals and short-range CA-CA distances, thresholded into 'a' (helix) /
'b' (strand) / 'c' (coil) and smoothed by minimum run lengths. Gives the
helix / strand / coil fractions that the SSE-guided sampling CLI reports,
and the example twisting-target statistic h(x) = 1 if more than half of the
residues are helical. A copy of genie2_tpu's numpy-only module of the same
name: this package imports nothing of genie2_tpu.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _angle(p0, p1, p2):
    v1 = p0 - p1
    v2 = p2 - p1
    cos = np.sum(v1 * v2, -1) / (
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1) + 1e-9
    )
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def _dihedral(p0, p1, p2, p3):
    b0 = p1 - p0
    b1 = p2 - p1
    b2 = p3 - p2
    n1 = np.cross(b0, b1)
    n2 = np.cross(b1, b2)
    m1 = np.cross(n1, b1 / (np.linalg.norm(b1, axis=-1, keepdims=True) + 1e-9))
    x = np.sum(n1 * n2, -1)
    y = np.sum(m1 * n2, -1)
    return np.degrees(np.arctan2(y, x))


def _dist(a, b):
    return np.linalg.norm(a - b, axis=-1)


def assign_secstruct(coords: np.ndarray) -> np.ndarray:
    """P-SEA assignment for a single chain.

    Args:
        coords: [N, 3] CA positions.

    Returns:
        [N] array of 'a' (helix), 'b' (strand), 'c' (coil).
    """
    n = coords.shape[0]
    sse = np.full(n, "c", dtype="<U1")
    if n < 5:
        return sse

    # Pseudo geometry (indices follow P-SEA's conventions).
    d2i = np.full(n, np.nan)  # d(i, i+2), stored at i+1
    d3i = np.full(n, np.nan)  # d(i, i+3), stored at i+1
    d4i = np.full(n, np.nan)  # d(i, i+4), stored at i+2
    ri = np.full(n, np.nan)   # angle(i-1, i, i+1)
    ai = np.full(n, np.nan)   # dihedral(i-1, i, i+1, i+2), stored at i

    for i in range(1, n - 1):
        ri[i] = _angle(coords[i - 1], coords[i], coords[i + 1])
    for i in range(1, n - 2):
        ai[i] = _dihedral(coords[i - 1], coords[i], coords[i + 1], coords[i + 2])
    for i in range(n - 2):
        d2i[i + 1] = _dist(coords[i], coords[i + 2])
    for i in range(n - 3):
        d3i[i + 1] = _dist(coords[i], coords[i + 3])
    for i in range(n - 4):
        d4i[i + 2] = _dist(coords[i], coords[i + 4])

    # P-SEA thresholds.
    helix = (
        ((d3i >= 4.8) & (d3i <= 6.4) & (d4i >= 4.2) & (d4i <= 7.2))
        | ((ri >= 89) & (ri <= 115) & (ai >= 43) & (ai <= 78))
    )
    strand = (
        ((d2i >= 6.4) & (d2i <= 7.4) & (d3i >= 9.9) & (d3i <= 11.3))
        | ((ri >= 120) & (ri <= 180) & ((ai >= 155) | (ai <= -140)))
    )

    helix = np.nan_to_num(helix.astype(float)).astype(bool)
    strand = np.nan_to_num(strand.astype(float)).astype(bool)

    # Minimum run lengths (helix >= 4, strand >= 3), as P-SEA smooths.
    def runs(mask, min_len):
        out = np.zeros_like(mask)
        start = None
        for i, v in enumerate(mask.tolist() + [False]):
            if v and start is None:
                start = i
            elif not v and start is not None:
                if i - start >= min_len:
                    out[start:i] = True
                start = None
        return out

    helix = runs(helix, 4)
    strand = runs(strand & ~helix, 3)
    sse[helix] = "a"
    sse[strand] = "b"
    return sse


def sec_struct_frac(coords: np.ndarray) -> Tuple[float, float, float]:
    """(helix, strand, coil) fractions of a CA trace."""
    sse = assign_secstruct(np.asarray(coords))
    n = len(sse)
    if n == 0:
        return 0.0, 0.0, 0.0
    helix = float(np.sum(sse == "a")) / n
    strand = float(np.sum(sse == "b")) / n
    return helix, strand, 1.0 - helix - strand


def helix_statistic(coords: np.ndarray, threshold: float = 0.5) -> float:
    """The example twisting-target statistic h(x) = 1 if more than
    `threshold` of the residues are helical."""
    helix, _, _ = sec_struct_frac(coords)
    return 1.0 if helix > threshold else 0.0
