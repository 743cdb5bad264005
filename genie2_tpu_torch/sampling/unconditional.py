"""Unconditional length-conditioned sampler: empty features for a target
length, outputs written as `{outdir}/pdbs/{prefix}_{offset+i}.pdb`."""

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
