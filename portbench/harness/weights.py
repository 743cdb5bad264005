"""Seeded weights, made on the device in a few large calls.

The reference names every weight, its shape and its kind
(reference/genie2.py:parameter_spec); one standard normal draw of all of
them from a generator on the device is scaled and shifted by kind, as
trained weights would sit: products at 1 / sqrt(fan in), the zero-initialised
output and gate layers at half that (so that every layer reaches the
output), biases and norms near their initial values. The same seed gives the
same weights, to the program and again to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# kind -> (scale, whether the scale is over sqrt(fan in), offset)
KINDS = {
    "linear": (1.0, True, 0.0),
    "final": (0.5, True, 0.0),
    "gating": (0.5, True, 0.0),
    "bias": (0.1, False, 0.0),
    "gating_bias": (0.1, False, 1.0),
    "ln_weight": (0.1, False, 1.0),
    "ln_bias": (0.1, False, 0.0),
    "head_weights": (0.1, False, 0.541324854612918),  # around softplus^-1(1)
}


def make_weights(spec: List[Tuple[str, Tuple[int, ...], str, int]], seed: int, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `spec`'s (name, shape, kind, fan in), all views of
    one buffer drawn from a generator of `seed` on `device`."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    scale, offset = [], []
    for _, _, kind, fan_in in spec:
        s, per_fan, o = KINDS[kind]
        scale.append(s / math.sqrt(fan_in) if per_fan else s)
        offset.append(o)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat = flat * torch.repeat_interleave(torch.tensor(scale, device=device), counts)
    flat = (flat + torch.repeat_interleave(torch.tensor(offset, device=device), counts)).to(dtype)
    return {name: part.view(shape) for (name, shape, _, _), part in zip(spec, flat.split(sizes))}
