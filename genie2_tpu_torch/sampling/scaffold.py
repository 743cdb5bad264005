"""Fixed-placement motif scaffolding sampler.

Motif conditioning flows entirely through the fixed sequence / structure
masks that the feature nets consume; the reverse loop is unchanged. A fresh
legal placement is sampled for every sample, and each design is saved next
to a motif PDB re-indexed onto its placement, for evaluation.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from genie2_tpu_torch.features import features_from_motif_pdb, save_features_to_pdb, save_motif_pdb
from genie2_tpu_torch.parallel.mesh import broadcast_int
from genie2_tpu_torch.sampling.base import BaseSampler


class ScaffoldSampler(BaseSampler):
    """`placement_seed` seeds the generator that draws the placements; the
    default is an unseeded generator. With a mesh every rank draws every
    sample's placement (from rank 0's seed where none is given), so each
    rank's rows are rows of the same global batch."""

    def __init__(self, model, config, bucket: int = 32, dtype: str = None, placement_seed: Optional[int] = None,
                 mesh=None):
        if placement_seed is None and mesh is not None:
            placement_seed = broadcast_int(int(np.random.SeedSequence().generate_state(1, np.uint32)[0]), mesh)
        self._rng = np.random.default_rng(placement_seed)
        super().__init__(model, config, bucket=bucket, dtype=dtype, mesh=mesh)

    def setup(self):
        self.add_required_parameter("filepath")

    def on_sample_start(self, params: Dict[str, Any]):
        os.makedirs(os.path.join(params["outdir"], "pdbs"), exist_ok=True)
        os.makedirs(os.path.join(params["outdir"], "motif_pdbs"), exist_ok=True)

    def create_np_features(self, params: Dict[str, Any]):
        return features_from_motif_pdb(params["filepath"], self._rng)

    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        for i, np_features in enumerate(list_np_features):
            name = f"{params['prefix']}_{params['offset'] + i}"
            save_features_to_pdb(np_features, os.path.join(params["outdir"], "pdbs", f"{name}.pdb"))
            save_motif_pdb(
                params["filepath"], np_features["fixed_sequence_mask"],
                os.path.join(params["outdir"], "motif_pdbs", f"{name}.pdb"),
            )
