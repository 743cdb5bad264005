"""Configuration: the reference's `key value` file grammar.

A whitespace-separated `key value` text file with camelCase keys, parsed
into five groups (io / diffusion / model / training / optimization) with the
reference's defaults, plus a `tpu` group of precision / kernel knobs. Same
keys and defaults as `genie2_tpu.config` so one configuration file drives
both packages. A key the port does not read, such as `usePallas` (the port
always routes CUDA tensors through its kernels) or `scanSteps`, is
accepted and ignored.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional


def _parse_value(raw: str):
    if raw == "True":
        return True
    if raw == "False":
        return False
    return raw


def load_config_file(filename: str) -> Dict[str, Any]:
    """Lines with exactly two whitespace-separated tokens; literal
    True/False become booleans; everything else stays a string until
    coerced."""
    config: Dict[str, Any] = {}
    with open(filename) as file:
        for line in file:
            elts = line.split()
            if len(elts) == 2:
                config[elts[0]] = _parse_value(elts[1])
    return config


def _int_or_none(x):
    return int(x) if x is not None else None


def _float_or_none(x):
    return float(x) if x is not None else None


class Config:
    """Five dict groups with the reference's keys and defaults, plus `tpu`."""

    def __init__(self, filename: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None):
        raw = {} if filename is None else load_config_file(filename)
        if overrides:
            # String overrides go through the file parser, so
            # overrides={"remat": "False"} behaves like the line `remat False`.
            raw.update(
                {k: _parse_value(v) if isinstance(v, str) else v for k, v in overrides.items()}
            )
        self._build(raw)

    def _build(self, c: Dict[str, Any]):
        self.io = {
            "name": c.get("name", None),
            "rootdir": c.get("rootDirectory", "runs"),
            "datadir": c.get("dataDirectory", "data/afdbreps_l-256_plddt_80/pdbs"),
            "min_n_res": _int_or_none(c.get("minimumNumResidues", 20)),
            "max_n_res": _int_or_none(c.get("maximumNumResidues", 256)),
            "max_n_chain": _int_or_none(c.get("maximumNumChains", 1)),
            "validation_split": _float_or_none(c.get("validationSplit", None)),
            "motif_prob": float(c.get("motifProbability", 0.8)),
            "motif_min_pct_res": float(c.get("motifMinimumPercentageResidues", 0.05)),
            "motif_max_pct_res": float(c.get("motifMaximumPercentageResidues", 0.5)),
            "motif_min_n_seg": int(c.get("motifMinimumNumberSegments", 1)),
            "motif_max_n_seg": int(c.get("motifMaximumNumberSegments", 4)),
        }
        self.diffusion = {
            "n_timestep": int(c.get("numTimesteps", 1000)),
            "schedule": c.get("schedule", "cosine"),
        }
        self.model = {
            "c_s": int(c.get("singleFeatureDimension", 384)),
            "c_p": int(c.get("pairFeatureDimension", 128)),
            "rescale": float(c.get("rescale", 1)),
            "c_pos_emb": int(c.get("positionalEmbeddingDimension", 256)),
            "c_chain_emb": int(c.get("chainEmbeddingDimension", 64)),
            "c_timestep_emb": int(c.get("timestepEmbeddingDimension", 512)),
            "relpos_k": int(c.get("relativePositionK", 32)),
            "template_dist_min": float(c.get("templateDistanceMinimum", 2)),
            "template_dist_step": float(c.get("templateDistanceStep", 0.5)),
            "template_dist_n_bin": int(c.get("templateDistanceNumBins", 37)),
            "n_pair_transform_layer": int(c.get("numPairTransformLayers", 5)),
            "include_mul_update": bool(c.get("includeTriangularMultiplicativeUpdate", True)),
            "include_tri_att": bool(c.get("includeTriangularAttention", False)),
            "c_hidden_mul": int(c.get("triangularMultiplicativeHiddenDimension", 128)),
            "c_hidden_tri_att": int(c.get("triangularAttentionHiddenDimension", 32)),
            "n_head_tri": int(c.get("triangularAttentionNumHeads", 4)),
            "tri_dropout": float(c.get("triangularDropout", 0.25)),
            "pair_transition_n": int(c.get("pairTransitionN", 4)),
            "n_structure_layer": int(c.get("numStructureLayers", 8)),
            "n_structure_block": int(c.get("numStructureBlocks", 1)),
            "c_hidden_ipa": int(c.get("ipaHiddenDimension", 16)),
            "n_head_ipa": int(c.get("ipaNumHeads", 12)),
            "n_qk_point": int(c.get("ipaNumQkPoints", 4)),
            "n_v_point": int(c.get("ipaNumVPoints", 8)),
            "ipa_dropout": float(c.get("ipaDropout", 0.1)),
            "n_structure_transition_layer": int(c.get("numStructureTransitionLayers", 1)),
            "structure_transition_dropout": float(c.get("structureTransitionDropout", 0.1)),
        }
        self.training = {
            "seed": int(c.get("seed", 100)),
            "n_epoch": int(c.get("numEpoches", 1)),
            "batch_size": int(c.get("batchSize", 1)),
            "log_every_n_step": int(c.get("logEverySteps", 1000)),
            "checkpoint_every_n_epoch": int(c.get("checkpointEveryEpoches", 500)),
            "condition_loss_weight": int(c.get("conditionLossWeight", 1)),
            "ema_decay": float(c.get("emaDecay", 0)),
            "save_state_every_n_step": int(c.get("saveStateEverySteps", 0)),
            "async_checkpoint": bool(c.get("asyncCheckpoint", False)),
            "prefetch_depth": int(c.get("prefetchDepth", 2)),
        }
        self.optimization = {
            "lr": float(c.get("learningRate", 1e-4)),
        }
        self.tpu = {
            # "fp32" (parity mode) or "bf16" activations and weights.
            "compute_dtype": c.get("computeDtype", "fp32"),
            # rot_to_quat extraction in the pair featurizer: "closed" or
            # "eigh"; raw torch checkpoints select "eigh" (utils/model_io.py).
            "rot_to_quat_method": c.get("rotToQuatMethod", "closed"),
            "tri_att_chunk": int(c.get("triangleAttentionChunk", 0)),
            "mesh_data": int(c.get("meshData", -1)),
            "mesh_seq": int(c.get("meshSeq", 1)),
            "mesh_model": int(c.get("meshModel", 1)),
            "remat": bool(c.get("remat", True)),
        }

    def as_dict(self) -> Dict[str, Any]:
        return {
            "io": self.io,
            "diffusion": self.diffusion,
            "model": self.model,
            "training": self.training,
            "optimization": self.optimization,
            "tpu": self.tpu,
        }

    def __repr__(self):
        return f"Config({json.dumps(self.as_dict(), indent=2)})"
