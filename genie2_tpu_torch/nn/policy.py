"""Precision policy.

"fp32" is the parity mode. "bf16" casts the denoiser's weights once and
runs its activations in bfloat16 (the TriMul kernels take bfloat16 and
accumulate in float32); the noise prediction comes back in float32 and the
reverse-diffusion update (posterior mean, noise, Frenet frames) stays
float32 so coordinate error does not compound over the trajectory.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from genie2_tpu_torch.geometry import Rigid

DTYPES = {"fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown compute_dtype: {name}")
    return DTYPES[name]


def cast_model(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """The model with its floating parameters and buffers in `dtype`: the
    model itself where they already are, else a cast copy, so the caller's
    model keeps its weights (genie2_tpu's samplers cast a copy of the
    parameter tree, `cast_floating`)."""
    tensors = [*model.parameters(), *model.buffers()]
    if all(t.dtype == dtype for t in tensors if t.is_floating_point()):
        return model
    return copy.deepcopy(model).to(dtype)


def without_grad(model: torch.nn.Module) -> torch.nn.Module:
    """The model with parameters that do not require grad: the model itself
    where none does, else a copy with `requires_grad` off. A sampler that
    differentiates with respect to its inputs (TDS) evaluates this one, so
    no weight gradient is computed and the caller's model keeps its flags."""
    if not any(p.requires_grad for p in model.parameters()):
        return model
    return copy.deepcopy(model).requires_grad_(False)


def apply_denoiser(model, ts: Rigid, timesteps: torch.Tensor, features: Dict[str, Any],
                   static_pair_bias=None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The model's noise prediction z in float32, with the frames and the
    floating features cast to `dtype` (the model's weights must already be
    in `dtype`)."""
    if dtype != torch.float32:
        features = {k: v.to(dtype) if v.is_floating_point() else v for k, v in features.items()}
        ts = ts.to(dtype)
    return model(ts, timesteps, features, static_pair_bias=static_pair_bias)["z"].float()
