"""Unconditional length-conditioned samplers: empty features for a target
length, outputs written as `{outdir}/pdbs/{prefix}_{offset+i}.pdb` (or under
the given names, for the packed sampler)."""

from __future__ import annotations

import os
from typing import Any, Dict, List

from genie2_tpu_torch.features import create_empty_features, save_features_to_pdb
from genie2_tpu_torch.sampling.base import BaseSampler


class UnconditionalSampler(BaseSampler):
    def setup(self):
        self.add_required_parameter("length")

    def on_sample_start(self, params: Dict[str, Any]):
        os.makedirs(os.path.join(params["outdir"], "pdbs"), exist_ok=True)

    def create_np_features(self, params: Dict[str, Any]):
        return create_empty_features([params["length"]])

    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        for i, np_features in enumerate(list_np_features):
            name = f"{params['prefix']}_{params['offset'] + i}"
            save_features_to_pdb(np_features, os.path.join(params["outdir"], "pdbs", f"{name}.pdb"))


class PackedUnconditionalSampler(UnconditionalSampler):
    """Length-packed variant: one batch mixes target lengths, padded to a
    shared bucket, so every batch of a sweep is full.

    Required params: `lengths` (one per sample) and `names` (the output
    file stem of each sample, e.g. "173_2")."""

    def setup(self):
        self.add_required_parameter("lengths")
        self.add_required_parameter("names")

    def validate_parameters(self, params: Dict[str, Any]) -> bool:
        return super().validate_parameters(params) and len(params["lengths"]) == len(params["names"])

    def create_np_features_batch(self, params: Dict[str, Any]):
        return [create_empty_features([length]) for length in params["lengths"]]

    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        for name, np_features in zip(params["names"], list_np_features):
            save_features_to_pdb(np_features, os.path.join(params["outdir"], "pdbs", f"{name}.pdb"))
