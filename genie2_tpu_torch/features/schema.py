"""The 12-key feature dictionary and its host-side transforms.

Features travel as plain dicts of numpy arrays on the host; `to_device`
makes torch tensors with the reference's dtype table: int32 for
indices/counts/masks, float32 for coordinates, bool for the fixed
conditioning masks.

Keys (per structure, unpadded length N):
    aatype                [N, 20]   one-hot amino-acid types
    num_chains            []        scalar
    num_residues          []        scalar
    num_residues_per_chain[C]
    atom_positions        [N, 3]    C-alpha coordinates
    residue_mask          [N]
    residue_index         [N]
    chain_index           [N]
    fixed_sequence_mask   [N]       motif-sequence conditioning
    fixed_structure_mask  [N, N]    motif-structure conditioning
    fixed_group           [N]       motif group id (0 = scaffold)
    interface_mask        [N]       deprecated, all zeros
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from genie2_tpu_torch.features.residues import NUM_RESTYPES

Features = Dict[str, np.ndarray]


def create_empty_features(lengths: List[int]) -> Features:
    """Zeroed features for a structure with the given per-chain lengths."""
    num_chains = np.array(len(lengths))
    num_residues = int(np.sum(lengths))
    return {
        "aatype": np.zeros((num_residues, NUM_RESTYPES), dtype=int),
        "num_chains": num_chains.astype(int),
        "num_residues": np.array(num_residues).astype(int),
        "num_residues_per_chain": np.array(lengths).astype(int),
        "atom_positions": np.zeros((num_residues, 3), dtype=float),
        "residue_mask": np.ones(num_residues, dtype=int),
        "residue_index": np.concatenate([np.arange(l) for l in lengths]).astype(int),
        "chain_index": np.concatenate([[i] * l for i, l in enumerate(lengths)]).astype(int),
        "fixed_sequence_mask": np.zeros(num_residues, dtype=bool),
        "fixed_structure_mask": np.zeros((num_residues, num_residues), dtype=bool),
        "fixed_group": np.zeros(num_residues, dtype=int),
        "interface_mask": np.zeros(num_residues, dtype=bool),
    }


def pad_features(features: Features, max_n_chain: int, max_n_res: int) -> Features:
    """Zero-pad one structure's features to the given chain/residue counts."""
    out = dict(features)
    n_chain = int(features["num_chains"])
    n_res = int(features["num_residues"])
    for key, val in features.items():
        if key == "num_residues_per_chain":
            out[key] = np.concatenate([val, np.zeros(max_n_chain - n_chain, dtype=val.dtype)])
        elif key == "fixed_structure_mask":
            pad = max_n_res - n_res
            out[key] = np.pad(val, [(0, pad), (0, pad)]).astype(val.dtype)
        elif not key.startswith("num"):
            pad = max_n_res - n_res
            out[key] = np.concatenate([val, np.zeros((pad, *val.shape[1:]), dtype=val.dtype)])
    return out


def batchify(list_features: List[Features]) -> Features:
    """Pad to the batch maxima and stack."""
    max_n_chain = max(int(f["num_chains"]) for f in list_features)
    max_n_res = max(int(f["num_residues"]) for f in list_features)
    padded = [pad_features(f, max_n_chain, max_n_res) for f in list_features]
    return {k: np.stack([p[k] for p in padded], axis=0) for k in list_features[0]}


def debatchify(features: Features) -> List[Features]:
    """Split a batch and strip padding."""
    out = []
    for i in range(features["aatype"].shape[0]):
        n_chain = int(features["num_chains"][i])
        n_res = int(features["num_residues"][i])
        out.append(
            {
                "num_chains": features["num_chains"][i],
                "num_residues": features["num_residues"][i],
                "num_residues_per_chain": features["num_residues_per_chain"][i, :n_chain],
                "aatype": features["aatype"][i, :n_res],
                "atom_positions": features["atom_positions"][i, :n_res],
                "residue_mask": features["residue_mask"][i, :n_res],
                "residue_index": features["residue_index"][i, :n_res],
                "chain_index": features["chain_index"][i, :n_res],
                "fixed_sequence_mask": features["fixed_sequence_mask"][i, :n_res],
                "fixed_structure_mask": features["fixed_structure_mask"][i, :n_res, :n_res],
                "fixed_group": features["fixed_group"][i, :n_res],
                "interface_mask": features["interface_mask"][i, :n_res],
            }
        )
    return out


# Device dtype table.
_DEVICE_DTYPES = {
    "num_chains": torch.int32,
    "num_residues": torch.int32,
    "num_residues_per_chain": torch.int32,
    "aatype": torch.int32,
    "atom_positions": torch.float32,
    "residue_mask": torch.int32,
    "residue_index": torch.int32,
    "chain_index": torch.int32,
    "fixed_sequence_mask": torch.bool,
    "fixed_structure_mask": torch.bool,
    "fixed_group": torch.int32,
    "interface_mask": torch.bool,
}

_HOST_DTYPES = {
    k: (bool if v == torch.bool else (float if v == torch.float32 else int))
    for k, v in _DEVICE_DTYPES.items()
}


def to_device(features: Features, device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on `device` with canonical dtypes."""
    return {
        k: torch.as_tensor(np.asarray(v), dtype=_DEVICE_DTYPES[k], device=device)
        for k, v in features.items()
    }


def to_host(features: Dict[str, torch.Tensor]) -> Features:
    """Device batch -> host numpy with the reference's numpy dtype table."""
    return {
        k: v.detach().float().cpu().numpy().astype(_HOST_DTYPES[k])
        if v.is_floating_point()
        else v.detach().cpu().numpy().astype(_HOST_DTYPES[k])
        for k, v in features.items()
    }
