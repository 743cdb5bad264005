"""The attention core of triangle attention as one kernel, and its plain
version.

Per sample b, triangle row i, head h and query position j, over the keys k
of the same row:

    s[k] = q[b,i,j,h] . k[b,i,k,h] / sqrt(c) + tb[b,h,j,k] + inf (mask[b,i,k] - 1)
    o[b,i,j,h] = sum_k softmax_k(s)[k] v[b,i,k,h]

`tb` is the triangle bias, the same for every row of a sample; `mask` is the
pair mask, read on the key side. The projections, the gate and the output
projection stay with the caller (nn/primitives.py:Attention).
csrc/tri_att_flash.cu computes it with an online softmax, so nothing of size
I x J x J is written; `tri_attention_plain` is the same function in plain
torch with the kernel's rounding points:

- logits, softmax and both sums are float32 whatever the activation dtype;
  the probabilities stay float32 when they multiply v; only o is rounded;
- `inf (mask - 1)` is added to the logit, not substituted for it, so in
  float32 a masked key sits at exactly -inf = -1e9 (the logit is absorbed)
  and a row whose keys are all masked attends uniformly over all J keys,
  padded ones too, as genie2_tpu's module and its kernel do.

The query positions may differ from the keys (the ending node under
sequence parallelism, nn/pair_stack.py): q [B,I,Jq,H,c] against k, v
[B,I,Jk,H,c], tb [B,H,Jq,Jk] and mask [B,I,Jk]; the square case is Jq =
Jk.

Under autograd the wrapper goes through `Recomputed` (ops/launch.py): the
kernel forward and the gradient of `tri_attention_plain`, recomputed (with
`row_chunk` bounding its logits as in the forward's plain version).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from genie2_tpu_torch.ops.launch import DTYPE_CODES, Recomputed, check_activation, launch, on_cpu, records_grad
from genie2_tpu_torch.utils.profiling import count

MAX_HEAD_WIDTH = 64  # csrc/tri_att_flash.cu keeps a query's c accumulators in registers

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int]


def tri_attention_plain(q, k, v, tb, mask, inf: float = 1e9, row_chunk: int = 0) -> torch.Tensor:
    """q [B,I,Jq,H,c], k, v [B,I,Jk,H,c]; tb [B,H,Jq,Jk]; mask [B,I,Jk]
    (1 = a key that counts). Returns o [B,I,Jq,H,c] in q's dtype. `row_chunk` > 0 bounds the
    logits held at once to [B, row_chunk, H, J, J]: the rows are processed
    that many at a time (the last chunk may be shorter) with the same
    numbers, since a row's softmax is never split."""
    n_row, c = q.shape[1], q.shape[-1]
    tb32, mask32 = tb.float()[:, None], mask.float()

    def rows(lo: int, hi: int) -> torch.Tensor:
        a = torch.einsum("biqhc,bikhc->bihqk", q[:, lo:hi].float(), k[:, lo:hi].float()) / math.sqrt(c)
        a = a + tb32
        a = a + inf * (mask32[:, lo:hi, None, None, :] - 1.0)
        return torch.einsum("bihqk,bikhc->biqhc", torch.softmax(a, dim=-1), v[:, lo:hi].float())

    if row_chunk and n_row > row_chunk:
        o = torch.cat([rows(lo, min(lo + row_chunk, n_row)) for lo in range(0, n_row, row_chunk)], dim=1)
    else:
        o = rows(0, n_row)
    return o.to(q.dtype)


count("launch.tri_attention", 0)


def tri_attention(q, k, v, tb, mask, inf: float = 1e9, row_chunk: int = 0) -> torch.Tensor:
    """The kernel for tensors on the card, the plain version for tensors on
    the CPU; arguments and result as `tri_attention_plain`. The kernel
    holds no logits in device memory, so `row_chunk` has nothing to bound
    there and is not used."""
    if records_grad([q, k, v, tb, mask]) and not on_cpu(q):
        fixed = dict(inf=inf, row_chunk=row_chunk)
        return Recomputed.apply(functools.partial(_tri_attention_forward, **fixed),
                                functools.partial(tri_attention_plain, **fixed), q, k, v, tb, mask)
    return _tri_attention_forward(q, k, v, tb, mask, inf, row_chunk)


def _tri_attention_forward(q, k, v, tb, mask, inf: float, row_chunk: int) -> torch.Tensor:
    """The kernel for tensors on the card (no graph), the plain version for
    tensors on the CPU."""
    if on_cpu(q):
        return tri_attention_plain(q, k, v, tb, mask, inf, row_chunk)
    check_activation("tri_attention q", q, 5)
    B, I, JQ, H, c = q.shape
    JK = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        check_activation(f"tri_attention {name}", t, 5, like=q)
        if tuple(t.shape) != (B, I, JK, H, c):
            raise ValueError(f"tri_attention {name}: {tuple(t.shape)}, expected {(B, I, JK, H, c)}")
    check_activation("tri_attention tb", tb, 4, like=q)
    if tuple(tb.shape) != (B, H, JQ, JK) or tuple(mask.shape) != (B, I, JK) or mask.device != q.device:
        raise ValueError(
            f"tri_attention: tb {tuple(tb.shape)} and mask {tuple(mask.shape)} on {mask.device}, "
            f"expected {(B, H, JQ, JK)} and {(B, I, JK)} on {q.device}"
        )
    if c > MAX_HEAD_WIDTH:
        raise ValueError(f"tri_attention: head width {c} beyond the kernel's limit of {MAX_HEAD_WIDTH}")
    mask = mask.float().contiguous()
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k, v, tb, mask, out)):
        raise ValueError("tri_attention: the kernel reads 16 bytes at a time and needs 16-byte aligned tensors")
    launch(
        "tri_att_flash", "tri_att_flash", _ARGTYPES, q.device,
        q, k, v, tb, mask, out,
        B, I, JQ, JK, H, c, 1.0 / math.sqrt(c), float(inf), DTYPE_CODES[q.dtype],
    )
    count("launch.tri_attention")
    return out

