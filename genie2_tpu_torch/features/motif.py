"""Motif specification parsing and placement sampling.

A motif problem is a PDB file whose `REMARK 999` header lists alternating
motif segments (chain, residue range, group) and scaffold segments (minimum
and maximum length) with bounds on the total length, followed by the motif's
ATOM records.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from genie2_tpu_torch.features.pdb import parse_pdb
from genie2_tpu_torch.features.residues import NUM_RESTYPES
from genie2_tpu_torch.features.schema import Features, create_empty_features


def load_motif_spec(filepath: str) -> Dict:
    """Parse the REMARK 999 grammar."""
    name = None
    min_total_length = None
    max_total_length = None
    structures = []
    with open(filepath) as file:
        for line in file:
            if line.startswith("REMARK 999 INPUT"):
                if line[18] == " ":
                    structures.append(
                        {"type": "scaffold", "min_length": int(line[19:23]), "max_length": int(line[23:27])}
                    )
                else:
                    structures.append(
                        {
                            "type": "motif",
                            "chain": line[18],
                            "start_index": int(line[19:23]),
                            "end_index": int(line[23:27]),
                            "group": line[28] if len(line) > 28 and line[28] != " " else "A",
                        }
                    )
            elif line.startswith("REMARK 999 NAME"):
                name = line[18:]
            elif line.startswith("REMARK 999 MINIMUM TOTAL LENGTH"):
                min_total_length = int(line[37:])
            elif line.startswith("REMARK 999 MAXIMUM TOTAL LENGTH"):
                max_total_length = int(line[37:])
    return {
        "name": name,
        "structures": structures,
        "min_total_length": min_total_length,
        "max_total_length": max_total_length,
    }


def _segment_length(structure: Dict, bound: str) -> int:
    if structure["type"] == "scaffold":
        return structure[bound]
    return structure["end_index"] - structure["start_index"] + 1


def sample_motif_mask(spec: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
    """Rejection-sample scaffold lengths until the total length fits the
    bounds, then build the sequence, structure and group masks. The
    structure mask is block-diagonal per motif group. A spec whose bounds
    no placement can meet raises ValueError."""
    rng = rng or np.random.default_rng()
    lo = sum(_segment_length(s, "min_length") for s in spec["structures"])
    hi = sum(_segment_length(s, "max_length") for s in spec["structures"])
    if hi < spec["min_total_length"] or lo > spec["max_total_length"]:
        raise ValueError(
            f"unsatisfiable motif spec: reachable lengths [{lo}, {hi}] vs "
            f"bounds [{spec['min_total_length']}, {spec['max_total_length']}]"
        )
    while True:
        total_length = 0
        seq_mask = []
        groups = []
        for structure in spec["structures"]:
            if structure["type"] == "scaffold":
                n = int(rng.integers(structure["min_length"], structure["max_length"] + 1))
                seq_mask.extend([0] * n)
                groups.extend([0] * n)
            else:
                n = structure["end_index"] - structure["start_index"] + 1
                seq_mask.extend([1] * n)
                groups.extend([ord(structure["group"]) - ord("A") + 1] * n)
            total_length += n
        if spec["min_total_length"] <= total_length <= spec["max_total_length"]:
            break

    structure_mask = np.zeros((total_length, total_length))
    for g in range(1, int(np.max(groups)) + 1):
        gm = np.equal(groups, g)
        structure_mask += gm[:, None] * gm[None, :]

    return {
        "sequence": np.array(seq_mask).astype(bool),
        "structure": structure_mask.astype(bool),
        "group": np.array(groups).astype(int),
    }


def features_from_motif_pdb(filepath: str, rng: Optional[np.random.Generator] = None) -> Features:
    """Sample a legal placement and scatter the motif's residue types and
    coordinates into a fresh feature dict."""
    spec = load_motif_spec(filepath)
    seqs, coords = parse_pdb(filepath)
    motif_aatype = np.eye(NUM_RESTYPES)[np.concatenate(seqs)]
    motif_positions = np.concatenate(coords)

    mask = sample_motif_mask(spec, rng)
    features = create_empty_features([len(mask["sequence"])])
    features["aatype"][mask["sequence"]] = motif_aatype
    features["atom_positions"][mask["sequence"]] = motif_positions
    features["fixed_sequence_mask"] = mask["sequence"]
    features["fixed_structure_mask"] = mask["structure"]
    features["fixed_group"] = mask["group"]
    return features


def save_motif_pdb(spec_filepath: str, mask: np.ndarray, pdb_filepath: str):
    """Re-index the motif problem's ATOM records onto the sampled placement,
    so that evaluation can align motif and design."""
    spec = load_motif_spec(spec_filepath)
    residue_index_spec = []
    for structure in spec["structures"]:
        if structure["type"] == "motif":
            for i in range(structure["start_index"], structure["end_index"] + 1):
                residue_index_spec.append((structure["chain"], i, structure["group"]))

    residue_index_pdb = [i + 1 for i, elt in enumerate(mask) if elt]
    if len(residue_index_pdb) != len(residue_index_spec):
        raise ValueError(
            f"mask fixes {len(residue_index_pdb)} residues, the motif spec lists {len(residue_index_spec)}"
        )

    index_map = {
        f"{chain}_{idx}": (residue_index_pdb[i], group)
        for i, (chain, idx, group) in enumerate(residue_index_spec)
    }

    with open(spec_filepath) as file:
        lines = [line for line in file if line.startswith("ATOM")]

    updated = []
    for line in lines:
        new_index, group = index_map[f"{line[21]}_{int(line[22:26])}"]
        updated.append(line[:21] + "A" + str(new_index).rjust(4) + line[26:72] + group.ljust(4) + line[76:])

    with open(pdb_filepath, "w") as file:
        file.write("".join(updated))
