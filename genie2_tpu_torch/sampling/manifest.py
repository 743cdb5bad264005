"""Benchmark manifest emission (a copy of genie2_tpu/sampling/manifest.py;
stdlib only).

The input format of the external scaffolding-benchmark pipeline, one pair
of files per run:

  scaffold_info.csv:  sample_num,motif_placements        e.g. 0,10/A/52
  motif_info.csv:     pdb_name,sample_num,contig,redesign_positions,
                      segment_order                      e.g.
                      06_6E6R,0,10/A1-13/52,A1-13,A

The contig grammar alternates scaffold segment lengths with motif segment
letters (scaffold_info) or chain+residue ranges (motif_info); zero-length
scaffold segments at the ends are omitted.
"""

from __future__ import annotations

import os
import string
from typing import Dict, List, Optional, Sequence, Tuple

Placement = Tuple[Tuple[int, int], ...]  # ((start, end), ...) inclusive


def _segment_letters(n: int) -> List[str]:
    """Segment labels A..Z, then AA, AB, ... (spreadsheet-style) so >26
    motif segments get distinct labels instead of being silently dropped
    by a zip against a truncated list."""
    labels = []
    for i in range(n):
        name = ""
        k = i
        while True:
            name = string.ascii_uppercase[k % 26] + name
            k = k // 26 - 1
            if k < 0:
                break
        labels.append(name)
    return labels


def placement_contig(
    length: int,
    placement: Placement,
    segment_labels: Sequence[str],
) -> str:
    """Alternating scaffold-length / segment-label contig string."""
    parts: List[str] = []
    cursor = 0
    for (start, end), label in zip(placement, segment_labels):
        gap = start - cursor
        if gap > 0:
            parts.append(str(gap))
        parts.append(label)
        cursor = end + 1
    tail = length - cursor
    if tail > 0:
        parts.append(str(tail))
    return "/".join(parts)


def motif_residue_label(chain: str, start: int, end: int) -> str:
    """`A1-13`-style source-residue range label."""
    return f"{chain}{start}-{end}"


def write_benchmark_manifests(
    outdir: str,
    pdb_name: str,
    length: int,
    placements: Sequence[Placement],
    seg_info: Optional[Sequence[Dict]] = None,
) -> None:
    """Write scaffold_info.csv + motif_info.csv for a batch of samples.

    placements: the inferred motif placement per sample (index = sample_num).
    seg_info: per-segment source metadata dicts with keys chain/start/end
        (from sampling.motif_target.load_motif_target_info); when absent,
        motif_info.csv falls back to bare segment letters.
    """
    os.makedirs(outdir, exist_ok=True)
    n_seg = len(placements[0]) if placements else 0
    letters = _segment_letters(n_seg)

    with open(os.path.join(outdir, "scaffold_info.csv"), "w") as f:
        f.write("sample_num,motif_placements\n")
        for i, placement in enumerate(placements):
            f.write(f"{i},{placement_contig(length, placement, letters)}\n")

    if seg_info is not None:
        labels = [
            motif_residue_label(s["chain"], s["start"], s["end"]) for s in seg_info
        ]
    else:
        labels = letters
    redesign = ";".join(labels)
    order = "".join(letters)
    with open(os.path.join(outdir, "motif_info.csv"), "w") as f:
        f.write("pdb_name,sample_num,contig,redesign_positions,segment_order\n")
        for i, placement in enumerate(placements):
            contig = placement_contig(length, placement, labels)
            f.write(f"{pdb_name},{i},{contig},{redesign},{order}\n")
