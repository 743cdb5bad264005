"""The pair transition (AF2 Algorithm 15) as one kernel, and its plain
version:

    out = mask[..., None] (relu(LN(z) W1^T + b1) W2^T + b2)

over the pair representation z [..., C] and its pair mask [...] (rows of
any leading shape: [B, N, N], or a row block [B, I, N] under sequence
parallelism). csrc/pair_transition.cu computes it with the hidden width H
kept on the SM; `pair_transition_plain` is the same function in plain
torch, the module's own operations.

No TPU kernel is replaced: genie2_tpu leaves the transition to XLA. The
kernel exists because cuBLAS runs float32 products without tensor cores;
it takes float32 with C = 128 and H a multiple of 64 (`takes`).
`pair_transition` launches it for such z on the card and returns the plain
version for anything else (the CPU, bf16, other widths), which autograd
differentiates as it is. Its products are 3xTF32 (csrc/tensor_core.cuh):
within a few float32 ulps a sum of the plain version's cuBLAS products.

Under autograd the kernel goes through `Recomputed` (ops/launch.py): the
kernel forward and the gradient of `pair_transition_plain`, recomputed
inside the span `recompute.pair_transition`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from genie2_tpu_torch.nn.primitives import LN_EPS
from genie2_tpu_torch.ops.launch import Recomputed, launch, on_cpu, records_grad
from genie2_tpu_torch.utils.profiling import count

CHANNELS = 128  # csrc/pair_transition.cu's C
HIDDEN_CHUNK = 64  # its hidden chunk: H a positive multiple of it

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float]


def takes(c: int, hidden: int) -> bool:
    """Whether the kernel computes a transition of `c` channels and `hidden`
    hidden channels."""
    return c == CHANNELS and hidden > 0 and hidden % HIDDEN_CHUNK == 0


def pair_transition_plain(z, mask, ln_w, ln_b, w1, b1, w2, b2, eps: float = LN_EPS) -> torch.Tensor:
    """z [..., C], mask [...] (1 = a pair that counts); ln_w, ln_b [C]; w1
    [H, C], b1 [H]; w2 [C, H], b2 [C]. Returns [..., C] in z's dtype."""
    h = torch.relu(F.linear(F.layer_norm(z, (z.shape[-1],), ln_w, ln_b, eps), w1, b1))
    return F.linear(h, w2, b2) * mask[..., None].to(z.dtype)


count("launch.pair_transition", 0)


def pair_transition(z, mask, ln_w, ln_b, w1, b1, w2, b2, eps: float = LN_EPS) -> torch.Tensor:
    """The kernel for float32 z on the card of widths it takes, the plain
    version for anything else; arguments and result as
    `pair_transition_plain`."""
    args = (z, mask, ln_w, ln_b, w1, b1, w2, b2)
    if on_cpu(z) or z.dtype != torch.float32 or not takes(z.shape[-1], w1.shape[0]):
        return pair_transition_plain(*args, eps=eps)
    if records_grad(args):
        return Recomputed.apply(functools.partial(_pair_transition_kernel, eps=eps),
                                functools.partial(pair_transition_plain, eps=eps), *args)
    return _pair_transition_kernel(*args, eps=eps)


def _pair_transition_kernel(z, mask, ln_w, ln_b, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """One launch of the kernel (no graph) for float32 z on the card, of
    widths it takes."""
    z = z.contiguous()
    C, H = z.shape[-1], w1.shape[0]
    shapes = {"mask": (mask, z.shape[:-1]), "ln_w": (ln_w, (C,)), "ln_b": (ln_b, (C,)), "w1": (w1, (H, C)),
              "b1": (b1, (H,)), "w2": (w2, (C, H)), "b2": (b2, (C,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != tuple(shape) or t.device != z.device:
            raise ValueError(f"pair_transition {name}: {tuple(t.shape)} on {t.device}, expected {tuple(shape)} "
                             f"on {z.device}")
        if name != "mask" and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise ValueError(f"pair_transition {name}: expected a contiguous float32 tensor, got {t.dtype}")
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(z)
    images = torch.empty(H * 4 * CHANNELS, dtype=torch.float32, device=z.device)  # the weights' hi / lo images
    if any(t.data_ptr() % 16 for t in (z, out, images)) or any(t.data_ptr() % 8 for t in (b1, b2)):
        raise ValueError("pair_transition: the kernel needs z and out 16-byte and b1, b2 8-byte aligned")
    launch("pair_transition", "pair_transition", _ARGTYPES, z.device,
           z, mask, ln_w, ln_b, w1, b1, w2, b2, images, out, z.numel() // C, H, float(eps))
    count("launch.pair_transition")
    return out
