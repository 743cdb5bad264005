"""The program under test, built from a configuration file and seeded weights."""

from __future__ import annotations

from typing import Dict

import torch


def build(config: Dict, weights: Dict[str, torch.Tensor]):
    """(the program's Config, its Denoiser holding `weights`). The model is
    made on the meta device and takes the weights' tensors as its
    parameters, so nothing is initialised twice; a weight the model lacks,
    or one it has and `weights` lacks, raises."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.nn import Denoiser

    cfg = Config(overrides=dict(config["configuration"]))
    with torch.device("meta"):
        model = Denoiser.from_config(cfg)
    model.load_state_dict(weights, strict=True, assign=True)
    return cfg, model
