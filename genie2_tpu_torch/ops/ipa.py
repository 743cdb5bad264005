"""The attention core of invariant point attention as one kernel, and its
plain version.

Per sample, query row i, head h and key j (AF2 Algorithm 22, lines 7-10):

    s[h,i,j] = sqrt(1/(3c)) q[i,h].k[j,h] + sqrt(1/3) bias[i,j,h]
               - 0.5 w_h s_pt sum_p |q_pts[i,h,p] - k_pts[j,h,p]|^2
               + inf (mask[j] - 1)
    p        = softmax_j s
    o[i,h]      = sum_j p v[j,h]
    o_pt[i,h]   = sum_j p v_pts[j,h]        (global frame)
    o_pair[i,h] = sum_j p z[i,j]

with s_pt = sqrt(1/(3 * Pq * 9/2)) and w_h the softplus of the head weight.
The projections, the frame maps and the pair bias `bias = linear_b(z)` stay
with the caller (nn/structure.py). csrc/ipa_attention.cu computes it without
writing anything of size N x N; `ipa_attention_plain` is the same function
in plain torch, with the kernel's rounding points:

- the points are multiplied by sqrt(w_h s_pt) in float32 and rounded to the
  activation dtype, so the squared distance carries the head weight;
- only the key side is masked. The module's square mask inf (m_i m_j - 1)
  equals it on every real row; on a padded row the square mask is a
  constant shift (attention over all keys, padded ones too) while this one
  attends over the real keys. Padded rows are dead downstream;
- logits, softmax statistics and all three sums are float32; in bfloat16
  the probabilities are rounded to bfloat16 before they multiply z.

The queries may be a block of I rows against all N keys (sequence
parallelism, nn/structure.py): q and q_pts [B,I,...], bias [B,I,N,H] and
z [B,I,N,Cz], k, v, their points and the key mask over all N; the square
case is I = N.

Under autograd the wrapper goes through `Recomputed` (ops/launch.py): the
kernel forward and the gradient of `ipa_attention_plain`, recomputed.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from genie2_tpu_torch.ops.launch import DTYPE_CODES, Recomputed, launch, on_cpu, records_grad
from genie2_tpu_torch.utils.profiling import count

# Limits and tiles of csrc/ipa_attention.cu: CONSUMERS * ITEMS o / o_pt
# items a block, CONSUMER_WARPS * UNITS o_pair tiles of 8 channels, TJ keys a
# tile, STAGES tiles in its ring, PAS floats a (row, key) of p.
MAX_HEADS = 16
_MAX_ITEMS = 960
_MAX_TILES = 120
_MAX_SMEM_BYTES = 232448
_TJ, _STAGES, _TI_MAX, _PAS = 16, 2, 4, 24
# The mask's dtype codes of the kernel.
MASK_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2, torch.int64: 3, torch.bool: 4, torch.uint8: 4}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def scale_points(q_pts: torch.Tensor, k_pts: torch.Tensor, head_weights: torch.Tensor):
    """Fold the per-head point weight into the points:
    -0.5 s w_h sum d^2 == -0.5 sum (sqrt(s w_h) d)^2. [.., H, Pq, 3] each,
    returned flat as [.., H, 3 Pq] in the points' dtype."""
    pq = q_pts.shape[-2]
    f = torch.sqrt(head_weights.float() * point_scale(pq))[:, None, None]
    return tuple((p.float() * f).to(p.dtype).flatten(-2) for p in (q_pts, k_pts))


def point_scale(pq: int) -> float:
    """s_pt = sqrt(1 / (3 Pq 9/2)), the points' share of the logit."""
    return math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))


def ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf: float = 1e5) -> Outputs:
    """q [B,I,H,C], k, v [B,N,H,C]; q_pts [B,I,H,Pq,3], k_pts
    [B,N,H,Pq,3]; v_pts [B,N,H,Pv,3] (global frame); bias [B,I,N,H]; z
    [B,I,N,Cz]; head_weights [H] (softplus applied); mask [B,N] (the
    keys'). Returns (o [B,I,H,C], o_pt [B,I,H,Pv,3], o_pair [B,I,H,Cz]) in
    z's dtype."""
    dt = z.dtype
    c = q.shape[-1]
    qp, kp = (p.float() for p in scale_points(q_pts, k_pts, head_weights))
    a = torch.einsum("bihc,bjhc->bhij", q.float(), k.float()) * math.sqrt(1.0 / (3 * c))
    a = a + math.sqrt(1.0 / 3) * bias.float().permute(0, 3, 1, 2)
    diff = qp[:, :, None] - kp[:, None, :]  # [B, I, N, H, 3 Pq]
    a = a - 0.5 * (diff * diff).sum(-1).permute(0, 3, 1, 2)
    a = a + inf * (mask.float()[:, None, None, :] - 1.0)
    p = torch.exp(a - a.amax(-1, keepdim=True))  # [B, H, N, N]
    norm = 1.0 / p.sum(-1).clamp_min(1e-20).transpose(1, 2)  # [B, N, H]
    o = torch.einsum("bhij,bjhc->bihc", p, v.float()) * norm[..., None]
    o_pt = torch.einsum("bhij,bjhpd->bihpd", p, v_pts.float()) * norm[..., None, None]
    o_pair = torch.einsum("bhij,bijc->bihc", p.to(dt).float(), z.float()) * norm[..., None]
    return o.to(dt), o_pt.to(dt), o_pair.to(dt)


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def kernel_layout(H: int, C: int, PQ: int, PV: int, CZ: int, N: int, esize: int) -> Dict[str, int]:
    """The kernel's padded widths (csrc/ipa_attention.cu `launch`), in
    elements of the activation dtype (CQ and QS in floats): a staged key
    row of the slot layout is [k CP][k points QP][v CP][v points VP], KVS
    apart (the bulk layout takes the same room and 16 bytes a key); a query
    row is [q CQ][points], QS apart; HB is the heads rounded to 4."""
    v16 = 16 // esize
    lay = dict(HB=4 * ((H + 3) // 4), CP=_round_up(C, v16), QP=_round_up(3 * PQ, v16), VP=_round_up(3 * PV, v16),
               CQ=_round_up(C, 4), N=N, H=H, CZ=CZ, esize=esize)
    kvs = 2 * lay["CP"] + lay["QP"] + lay["VP"]
    lay["KVS"] = kvs + v16 if (kvs // v16) % 2 == 0 else kvs
    lay["QS"] = lay["CQ"] + _round_up(3 * PQ, 4)
    return lay


def smem_bytes(lay: Dict[str, int], ti: int) -> int:
    """Shared memory of one block with `ti` query rows (the kernel's Smem)."""
    es, H, HB = lay["esize"], lay["H"], lay["HB"]
    stage = _round_up(_TJ * (H * lay["KVS"] * es + 16), 16) + _round_up(ti * _TJ * lay["CZ"] * es, 16)
    stage += _round_up(ti * _TJ * H * es, 16)
    probs = HB * _TJ * _TI_MAX * 4 + ti * _TJ * _PAS * 4  # p by rows (o, o_pt) and by heads (o_pair)
    head = _STAGES * stage + ti * H * lay["QS"] * 4 + probs + 2 * ti * HB * 4 + HB * 4
    return _round_up(head, 8) + 2 * _STAGES * 8 + (lay["N"] + 3) // 4 * 16


def rows_per_block(c_z: int, lay: Dict[str, int] = None) -> int:
    """Query rows one block of the kernel owns: the most (at most 4) that
    keep its o_pair tiles (rows x c_z / 8) within its consumer warps' and,
    given the layout, the block within shared memory."""
    ti = _TI_MAX
    while ti > 1 and (ti * -(-c_z // 8) > _MAX_TILES or (lay is not None and smem_bytes(lay, ti) > _MAX_SMEM_BYTES)):
        ti //= 2
    return ti


def _run_strides(name: str, t: torch.Tensor, points: bool):
    """(batch, row, head, element) element strides of q / k / v [B,N,H,C]
    or of a point set [B,N,H,P,3], whose 3 P values of a head must lie at
    one stride (a view of a contiguous [.., P', 3] tensor does)."""
    if not points:
        return list(t.stride())
    sb, sn, sh, sp, sx = t.stride()
    if t.shape[-2] > 1 and sp != 3 * sx:
        raise ValueError(f"ipa {name}: the points' strides {tuple(t.stride())} do not make one run of 3 P values")
    return [sb, sn, sh, sx]


def kernel_arguments(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask):
    """The tensors and the element strides the kernel reads, as
    `ipa_attention` hands them over: (inputs, strides, dims); strides holds
    four values a tensor for q, k, v, the three point sets, bias and z,
    then the mask's two; dims B, N (the keys), H, C, Pq, Pv, Cz."""
    B, NI, N, CZ = z.shape
    H, C = q.shape[-2:]
    PQ, PV = q_pts.shape[-2], v_pts.shape[-2]
    strides = []
    for name, t, pts in (("q", q, False), ("k", k, False), ("v", v, False), ("q_pts", q_pts, True),
                         ("k_pts", k_pts, True), ("v_pts", v_pts, True), ("bias", bias, False), ("z", z, False)):
        strides += _run_strides(name, t, pts)
    strides += list(mask.stride())
    inputs = [q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask]
    return inputs, strides, (B, N, H, C, PQ, PV, CZ)


count("launch.ipa_attention", 0)


def ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf: float = 1e5) -> Outputs:
    """The kernel for tensors on the card, the plain version for tensors
    on the CPU; arguments and results as `ipa_attention_plain`. The kernel
    reads every argument through its strides (k and v may be strided
    halves of one projection, the points views) and the mask in its own
    dtype: one launch, nothing else."""
    args = (q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask)
    if records_grad(args) and not on_cpu(z):
        return Recomputed.apply(functools.partial(_ipa_attention_forward, inf=inf),
                                functools.partial(ipa_attention_plain, inf=inf), *args)
    return _ipa_attention_forward(*args, inf)


def _ipa_attention_forward(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf: float) -> Outputs:
    """The kernel for tensors on the card (no graph), the plain version for
    tensors on the CPU."""
    if on_cpu(z):
        return ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf)
    if z.dtype not in DTYPE_CODES:
        raise TypeError(f"ipa z: dtype {z.dtype} not supported (float32 or bfloat16)")
    if z.dim() != 4:
        raise ValueError(f"ipa z: expected [B, I, N, Cz], got {tuple(z.shape)}")
    B, NI, N, CZ = z.shape
    H, C = q.shape[-2:]
    PQ, PV = q_pts.shape[-2], v_pts.shape[-2]
    shapes = {
        "q": (q, (B, NI, H, C)), "k": (k, (B, N, H, C)), "v": (v, (B, N, H, C)),
        "q_pts": (q_pts, (B, NI, H, PQ, 3)), "k_pts": (k_pts, (B, N, H, PQ, 3)),
        "v_pts": (v_pts, (B, N, H, PV, 3)), "bias": (bias, (B, NI, N, H)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != z.dtype or t.device != z.device:
            raise ValueError(f"ipa {name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected {shape} {z.dtype} on {z.device}")
    if tuple(mask.shape) != (B, N) or tuple(head_weights.shape) != (H,):
        raise ValueError(f"ipa: z {tuple(z.shape)}, mask {tuple(mask.shape)}, head_weights {tuple(head_weights.shape)}")
    if head_weights.dtype not in DTYPE_CODES or mask.dtype not in MASK_DTYPES or (H > 1 and head_weights.stride(0) != 1) \
            or head_weights.device != z.device or mask.device != z.device:
        raise ValueError(f"ipa: head_weights {head_weights.dtype} on {head_weights.device} "
                         f"mask {mask.dtype} on {mask.device}")
    lay = kernel_layout(H, C, PQ, PV, CZ, N, z.element_size())
    if H > MAX_HEADS or CZ > _MAX_ITEMS or H * (C + 3 * PV + 1) > _MAX_ITEMS \
            or smem_bytes(lay, rows_per_block(CZ, lay)) > _MAX_SMEM_BYTES:
        raise ValueError(
            f"ipa: H={H} C={C} Pq={PQ} Pv={PV} Cz={CZ} N={N} beyond the kernel's limits "
            f"(H <= {MAX_HEADS}, Cz <= {_MAX_ITEMS}, H (C + 3 Pv + 1) <= {_MAX_ITEMS}, "
            f"{_MAX_SMEM_BYTES} bytes of shared memory)"
        )
    inputs, strides, dims = kernel_arguments(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask)
    o = torch.empty((B, NI, H, C), dtype=z.dtype, device=z.device)
    o_pt = torch.empty((B, NI, H, PV, 3), dtype=z.dtype, device=z.device)
    o_pair = torch.empty((B, NI, H, CZ), dtype=z.dtype, device=z.device)
    tensors = [*inputs, o, o_pt, o_pair]
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    c_strides = (ctypes.c_longlong * len(strides))(*strides)
    c_dims = (ctypes.c_int * (len(dims) + 1))(*dims, NI)  # the query rows last
    # `tensors` rides along so that the launch holds every argument.
    launch(
        "ipa_attention", "ipa_attention", _ARGTYPES, z.device,
        ptrs, c_strides, c_dims, float(inf), point_scale(PQ), DTYPE_CODES[z.dtype], MASK_DTYPES[mask.dtype],
        DTYPE_CODES[head_weights.dtype], tensors=tensors,
    )
    count("launch.ipa_attention")
    return o, o_pt, o_pair

