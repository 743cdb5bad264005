"""The triangle multiplicative contraction in the model layout.

    out[b, i, j, c] = sum_k a[b, i, k, c] * b[b, j, k, c]   (outgoing)
    out[b, i, j, c] = sum_k a[b, k, i, c] * b[b, k, j, c]   (incoming)

`triangle_multiply` takes and returns [B, N, N, C], as genie2_tpu's
ops/triangle.py does, with two layouts of the work on the card:

  "cm"       the operands are first copied channel-major ([B, C, N, N], k
             last), the kernel runs with unit k stride, and the result is
             copied back to the model layout;
  "nlayout"  no copy: the kernel reads and writes the model layout,
             16-byte groups of the contiguous channel axis at a time.

Both run csrc/triangle_contract.cu. No module of the denoiser calls this
function (the pair stack runs ops/trimul.py, which keeps its activations
channel-major from the projection on); it is the standalone contraction.
"""

from __future__ import annotations

import torch

from genie2_tpu_torch.ops.launch import check_activation, on_cpu
from genie2_tpu_torch.utils.profiling import count
from genie2_tpu_torch.ops.trimul import launch_triangle_contract

LAYOUTS = ("cm", "nlayout")


def triangle_multiply_reference(a: torch.Tensor, b: torch.Tensor, outgoing: bool = True) -> torch.Tensor:
    """The plain version, [B, N, N, C] in and out, float32 accumulation."""
    af, bf = a.float(), b.float()
    eq = "bikc,bjkc->bijc" if outgoing else "bkic,bkjc->bijc"
    return torch.einsum(eq, af, bf).to(a.dtype).contiguous()


count("launch.triangle_multiply_cm", 0)
count("launch.triangle_multiply_nlayout", 0)


def triangle_multiply(a: torch.Tensor, b: torch.Tensor, outgoing: bool = True, layout: str = "cm") -> torch.Tensor:
    """[B, N, N, C] x [B, N, N, C] -> [B, N, N, C] (contiguous)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} ({'|'.join(LAYOUTS)})")
    if on_cpu(a):
        return triangle_multiply_reference(a, b, outgoing)
    check_activation("triangle_multiply a", a, 4)
    check_activation("triangle_multiply b", b, 4, like=a)
    if a.shape[1] != a.shape[2] or b.shape != a.shape:
        raise ValueError(f"triangle_multiply: a {tuple(a.shape)}, b {tuple(b.shape)}")

    B, N, _, C = a.shape
    if layout == "nlayout":
        out = torch.empty_like(a)
        s0, s1, s2, s3 = a.stride()
        # (batch, channel, row, k) of a[b,i,k,c] (outgoing) or a[b,k,i,c].
        operand = (s0, s3, s1, s2) if outgoing else (s0, s3, s2, s1)
        launch_triangle_contract(a, b, out, (B, C, N), operand, operand, (s0, s3, s1, s2), variant=2)
        count("launch.triangle_multiply_nlayout")
        return out

    perm = (0, 3, 1, 2) if outgoing else (0, 3, 2, 1)  # -> [b, c, row, k]
    a_cm, b_cm = a.permute(perm).contiguous(), b.permute(perm).contiguous()
    # The result is written channel-major and copied back: written straight
    # into the model layout through its strides, a block of one channel
    # would store 4 bytes to every 32-byte sector it touches.
    out_cm = torch.empty_like(a_cm)
    launch_triangle_contract(a_cm, b_cm, out_cm, (B, C, N), a_cm.stride(), b_cm.stride(), out_cm.stride(), variant=0)
    count("launch.triangle_multiply_cm")
    return out_cm.permute(0, 2, 3, 1).contiguous()
