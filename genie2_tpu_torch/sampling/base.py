"""Sampler orchestration: the reference's template-method surface (setup /
on_sample_start / create_np_features / on_sample_end, required-parameter
validation) around the ancestral loop of sampling/ddpm.py."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, debatchify, to_device, to_host
from genie2_tpu_torch.nn.policy import apply_denoiser, compute_dtype
from genie2_tpu_torch.sampling.ddpm import ancestral_sample


def bucket_length(n: int, multiple: int = 32) -> int:
    """Round a sequence length up to a bucket multiple (padded residues are
    masked and do not affect real ones)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def pad_residues(batch: Dict[str, np.ndarray], n_padded: int) -> Dict[str, np.ndarray]:
    """Zero-pad a host batch's residue axis (both axes of
    fixed_structure_mask) to n_padded."""
    pad = n_padded - batch["residue_mask"].shape[1]
    out = dict(batch)
    for k, v in batch.items():
        if k == "fixed_structure_mask":
            out[k] = np.pad(v, [(0, 0), (0, pad), (0, pad)])
        elif not k.startswith("num"):
            out[k] = np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
    return out


class BaseSampler(ABC):
    """Template-method sampler over the ancestral reverse loop. The model
    must already sit on its device in eval mode."""

    def __init__(self, model, config, bucket: int = 32, dtype: str = None):
        self.config = config
        self.device = next(model.parameters()).device
        self.dtype = compute_dtype(dtype or config.tpu.get("compute_dtype", "fp32"))
        self.model = model.to(self.dtype)
        self.schedule = Schedule.create(
            config.diffusion["n_timestep"], config.diffusion["schedule"], device=self.device
        )
        self.bucket = bucket
        self.required = ["scale", "outdir", "num_samples", "prefix", "offset"]
        self.setup()

    @abstractmethod
    def setup(self):
        ...

    @abstractmethod
    def on_sample_start(self, params: Dict[str, Any]):
        ...

    @abstractmethod
    def create_np_features(self, params: Dict[str, Any]):
        ...

    @abstractmethod
    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        ...

    def create_np_features_batch(self, params: Dict[str, Any]) -> List[Dict]:
        return [self.create_np_features(params) for _ in range(params["num_samples"])]

    def add_required_parameter(self, name: str):
        self.required.append(name)

    def validate_parameters(self, params: Dict[str, Any]) -> bool:
        return all(name in params for name in self.required)

    def sample(self, params: Dict[str, Any]):
        if not self.validate_parameters(params):
            missing = [n for n in self.required if n not in params]
            raise ValueError(f"missing required sampling parameters: {missing}")
        self.on_sample_start(params)
        list_np_features = self._sample(params)
        self.on_sample_end(params, list_np_features)
        return list_np_features

    def sample_ids(self, params: Dict[str, Any], n: int) -> List[int]:
        """Per-sample noise-stream ids: offset + position in the batch."""
        return [int(params["offset"]) + i for i in range(n)]

    @torch.inference_mode()
    def _sample(self, params: Dict[str, Any]):
        batch = batchify([dict(f) for f in self.create_np_features_batch(params)])
        n_real = batch["aatype"].shape[0]
        ids = self.sample_ids(params, n_real)

        features = to_device(pad_residues(batch, bucket_length(batch["residue_mask"].shape[1], self.bucket)), self.device)
        # relpos + motif template are the same on every step: computed once.
        static_bias = self.model.pair_feature_net.static_bias(features, self.dtype)

        def model_fn(frames, t_vec):
            return apply_denoiser(self.model, frames, t_vec, features, static_bias, self.dtype)

        trans = ancestral_sample(
            model_fn, self.schedule, features, int(params.get("seed", 0)), ids, float(params["scale"])
        )
        features["atom_positions"] = trans
        return debatchify(to_host(features))[:n_real]
