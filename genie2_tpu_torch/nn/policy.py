"""Precision policy.

"fp32" is the parity mode. "bf16" casts the denoiser's weights once and
runs its activations in bfloat16 (the TriMul kernels take bfloat16 and
accumulate in float32); the noise prediction comes back in float32 and the
reverse-diffusion update (posterior mean, noise, Frenet frames) stays
float32 so coordinate error does not compound over the trajectory.

Training (`apply_denoiser_cast`) keeps float32 master weights and runs the
forward and backward on bf16 casts of them made inside the differentiated
call, so the gradients reach the float32 parameters, as genie2_tpu's
`make_apply_fn(model, "bf16")` casts the parameter tree inside
`jax.value_and_grad`; the samplers keep `cast_model`'s cast copy.
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
    parameter tree, `cast_floating`). The copy of a model split over a
    model group holds the same shards and shares the group."""
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


def _cast_inputs(ts: Rigid, features: Dict[str, Any], dtype: torch.dtype):
    if dtype == torch.float32:
        return ts, features
    return ts.to(dtype), {k: v.to(dtype) if v.is_floating_point() else v for k, v in features.items()}


def apply_denoiser(model, ts: Rigid, timesteps: torch.Tensor, features: Dict[str, Any],
                   static_pair_bias=None, dtype: torch.dtype = torch.float32, generator=None,
                   rows=None) -> torch.Tensor:
    """The model's noise prediction z in float32, with the frames and the
    floating features cast to `dtype` (the model's weights must already be
    in `dtype`). `generator` and `rows`: the dropout generator of a model
    in train() mode and this batch's rows of the global batch
    (nn/denoiser.py)."""
    ts, features = _cast_inputs(ts, features, dtype)
    return model(ts, timesteps, features, static_pair_bias=static_pair_bias, generator=generator,
                 rows=rows)["z"].float()


def apply_denoiser_cast(model, ts: Rigid, timesteps: torch.Tensor, features: Dict[str, Any],
                        dtype: torch.dtype = torch.float32, generator=None, rows=None) -> torch.Tensor:
    """As `apply_denoiser`, for a model with float32 weights: the forward
    runs on `dtype` casts of them made here, under autograd, so that a
    backward reaches the float32 parameters. float32 calls the model as it
    is."""
    if dtype == torch.float32:
        return apply_denoiser(model, ts, timesteps, features, generator=generator, rows=rows)
    ts, features = _cast_inputs(ts, features, dtype)
    cast = {n: p.to(dtype) for n, p in model.named_parameters()}
    out = torch.func.functional_call(model, cast, (ts, timesteps, features), {"generator": generator, "rows": rows})
    return out["z"].float()
