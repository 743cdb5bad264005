"""PDB writer for C-alpha traces: CA-only ATOM records, mean-centred
coordinates rounded to 3 decimals, motif group as segment id at column 72,
element C at column 77 (the reference's fixed-column layout)."""

from __future__ import annotations

import numpy as np

from genie2_tpu_torch.features.residues import RESTYPE_1_TO_3, RESTYPES
from genie2_tpu_torch.features.schema import Features


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


def read_ca_coords(filepath: str) -> np.ndarray:
    """[N, 3] CA coordinates of a PDB file written by save_features_to_pdb."""
    with open(filepath) as fh:
        rows = [
            (ln[30:38], ln[38:46], ln[46:54])
            for ln in fh
            if ln.startswith("ATOM") and ln[13:15].strip() == "CA"
        ]
    return np.array(rows, dtype=np.float64).reshape(-1, 3)
