"""Canonical amino-acid tables (one-letter order of the reference)."""

RESTYPE_1_TO_3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}

RESTYPE_3_TO_1 = {v: k for k, v in RESTYPE_1_TO_3.items()}
RESTYPES = list(RESTYPE_1_TO_3.keys())
RESTYPE_ORDER = {restype: i for i, restype in enumerate(RESTYPES)}
NUM_RESTYPES = len(RESTYPES)
