"""Weight bridge: a flax parameter tree of genie2_tpu (as numpy arrays) ->
a state_dict of this package's Denoiser, keyed like the reference's.

The inverse of the reference-checkpoint converter of the JAX package:
  Dense kernel [in, out]        -> Linear weight [out, in]
  LayerNorm scale               -> weight
  layer_{i} under a stack       -> net.{i}
  layer_{j}_linear_{k} of the structure transition -> layers.{j}.linear_{k}
  Dense_0 wrappers              -> dropped
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

_STACKS = ("pair_transform_net", "structure_net")


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """flax path -> (state_dict key, whether the value is a kernel to transpose)."""
    parts = [p for p in path if p != "Dense_0"]
    leaf = parts[-1]
    transpose = leaf == "kernel"
    if leaf in ("kernel", "scale"):
        parts[-1] = "weight"
    out = []
    for i, p in enumerate(parts):
        m = re.fullmatch(r"layer_(\d+)", p)
        if m and i == 1 and parts[0] in _STACKS:
            out += ["net", m.group(1)]
            continue
        m = re.fullmatch(r"layer_(\d+)_(linear_\d+)", p)
        if m:
            out += ["layers", m.group(1), m.group(2)]
            continue
        out.append(p)
    return ".".join(out), transpose


def _walk(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def params_from_flax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax variables ({"params": ...} or the params dict itself) with
    numpy leaves -> state_dict of float32 tensors."""
    params = tree.get("params", tree)
    state = {}
    for path, value in _walk(params):
        key, transpose = _torch_key(path)
        arr = np.asarray(value, dtype=np.float32)
        state[key] = torch.tensor(arr.T if transpose else arr)
    return state


@torch.no_grad()
def randomize_zero_init(model: torch.nn.Module, seed: int, scale: float = 0.5) -> torch.nn.Module:
    """Give the zero-initialised "final" / "gating" Linear weights small
    seeded random values (std scale / sqrt(fan_in)), as trained weights
    would have; otherwise linear_z and linear_out zero every TriMul and IPA
    output and a check of them proves nothing."""
    from genie2_tpu_torch.nn.primitives import Linear

    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Linear) and mod.init_name in ("final", "gating"):
            w = torch.randn(mod.weight.shape, generator=gen) * (scale / mod.weight.shape[1] ** 0.5)
            mod.weight.copy_(w)
    return model
