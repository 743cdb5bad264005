"""Sinusoidal encodings (residue index, chain index, diffusion timestep):
interleaved cos (even channels) / sin (odd channels) with base n and a
1-indexed frequency ladder."""

from __future__ import annotations

import math

import torch


def sinusoidal_encoding(v: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """v [*] -> [*, d] float32. Even channels i hold
    cos(v * pi / n^(2*i/d)); odd channels i hold sin(v * pi / n^(2*(i+1)/d))."""
    k = torch.arange(1, d + 1, dtype=torch.float32, device=v.device)
    v = v.to(torch.float32)[..., None]
    sin_enc = torch.sin(v * math.pi / (n ** (2 * k / d)))
    cos_enc = torch.cos(v * math.pi / (n ** (2 * (k - 1) / d)))
    even = torch.arange(d, device=v.device) % 2 == 0
    return torch.where(even, cos_enc, sin_enc)
