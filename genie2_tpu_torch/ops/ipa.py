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
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from genie2_tpu_torch.ops.launch import DTYPE_CODES, LAUNCHES, check_activation, launch, on_cpu

# Limits of csrc/ipa_attention.cu (THREADS * ITEMS accumulator items a block).
MAX_HEADS = 16
_MAX_ITEMS = 512
_MAX_SMEM_BYTES = 232448
_TJ, _TI_MAX = 32, 2

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def scale_points(q_pts: torch.Tensor, k_pts: torch.Tensor, head_weights: torch.Tensor):
    """Fold the per-head point weight into the points:
    -0.5 s w_h sum d^2 == -0.5 sum (sqrt(s w_h) d)^2. [.., H, Pq, 3] each,
    returned flat as [.., H, 3 Pq] in the points' dtype."""
    pq = q_pts.shape[-2]
    s_pt = math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
    f = torch.sqrt(head_weights.float() * s_pt)[:, None, None]
    return tuple((p.float() * f).to(p.dtype).flatten(-2) for p in (q_pts, k_pts))


def ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf: float = 1e5) -> Outputs:
    """q, k, v [B,N,H,C]; q_pts, k_pts [B,N,H,Pq,3]; v_pts [B,N,H,Pv,3]
    (global frame); bias [B,N,N,H]; z [B,N,N,Cz]; head_weights [H]
    (softplus applied); mask [B,N]. Returns (o [B,N,H,C], o_pt
    [B,N,H,Pv,3], o_pair [B,N,H,Cz]) in z's dtype."""
    dt = z.dtype
    c = q.shape[-1]
    qp, kp = (p.float() for p in scale_points(q_pts, k_pts, head_weights))
    a = torch.einsum("bihc,bjhc->bhij", q.float(), k.float()) * math.sqrt(1.0 / (3 * c))
    a = a + math.sqrt(1.0 / 3) * bias.float().permute(0, 3, 1, 2)
    diff = qp[:, :, None] - kp[:, None, :]  # [B, N, N, H, 3 Pq]
    a = a - 0.5 * (diff * diff).sum(-1).permute(0, 3, 1, 2)
    a = a + inf * (mask.float()[:, None, None, :] - 1.0)
    p = torch.exp(a - a.amax(-1, keepdim=True))  # [B, H, N, N]
    norm = 1.0 / p.sum(-1).clamp_min(1e-20).transpose(1, 2)  # [B, N, H]
    o = torch.einsum("bhij,bjhc->bihc", p, v.float()) * norm[..., None]
    o_pt = torch.einsum("bhij,bjhpd->bihpd", p, v_pts.float()) * norm[..., None, None]
    o_pair = torch.einsum("bhij,bijc->bihc", p.to(dt).float(), z.float()) * norm[..., None]
    return o.to(dt), o_pt.to(dt), o_pair.to(dt)


def rows_per_block(c_z: int) -> int:
    """Query rows one block of the kernel owns: as many (at most 2) as keep
    rows x c_z within its accumulator items."""
    return max(1, min(_TI_MAX, _MAX_ITEMS // c_z))


def ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf: float = 1e5) -> Outputs:
    """The kernel for tensors on the card, the plain version for tensors
    on the CPU; arguments and results as `ipa_attention_plain`."""
    if on_cpu(z):
        return ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf)
    check_activation("ipa z", z, 4)
    B, N, N2, CZ = z.shape
    H, C = q.shape[-2:]
    PQ, PV = q_pts.shape[-2], v_pts.shape[-2]
    shapes = {
        "q": (q, (B, N, H, C)), "k": (k, (B, N, H, C)), "v": (v, (B, N, H, C)),
        "q_pts": (q_pts, (B, N, H, PQ, 3)), "k_pts": (k_pts, (B, N, H, PQ, 3)),
        "v_pts": (v_pts, (B, N, H, PV, 3)), "bias": (bias, (B, N, N, H)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != z.dtype or t.device != z.device:
            raise ValueError(f"ipa {name}: {tuple(t.shape)} {t.dtype} on {t.device}, expected {shape} {z.dtype} on {z.device}")
    if N2 != N or tuple(mask.shape) != (B, N) or tuple(head_weights.shape) != (H,):
        raise ValueError(f"ipa: z {tuple(z.shape)}, mask {tuple(mask.shape)}, head_weights {tuple(head_weights.shape)}")
    ti = rows_per_block(CZ)
    hb = 4 * ((H + 3) // 4)
    smem = 4 * (_TI_MAX * _TJ * hb + 3 * _TI_MAX * hb + (ti + _TJ) * H * ((C + 3 * PQ) | 1))
    if H > MAX_HEADS or CZ > _MAX_ITEMS or H * (C + 3 * PV + 1) > _MAX_ITEMS or smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"ipa: H={H} C={C} Pq={PQ} Pv={PV} Cz={CZ} beyond the kernel's limits "
            f"(H <= {MAX_HEADS}, Cz <= {_MAX_ITEMS}, H (C + 3 Pv + 1) <= {_MAX_ITEMS}, "
            f"{smem} <= {_MAX_SMEM_BYTES} bytes of shared memory)"
        )
    # The kernel reads a tile of keys as one contiguous run: [q | points].
    qp, kp = scale_points(q_pts, k_pts, head_weights)
    qc, kc, vc = torch.cat([q, qp], -1), torch.cat([k, kp], -1), torch.cat([v, v_pts.flatten(-2)], -1)
    oc = torch.empty_like(vc)
    o_pair = torch.empty((B, N, H, CZ), dtype=z.dtype, device=z.device)
    launch(
        "ipa_attention", "ipa_attention", _ARGTYPES, z.device,
        qc, kc, vc, bias.contiguous(), z, mask.float().contiguous(), oc, o_pair,
        B, N, H, C, PQ, PV, CZ, ti, float(inf), DTYPE_CODES[z.dtype],
    )
    LAUNCHES["ipa_attention"] += 1
    return oc[..., :C], oc[..., C:].unflatten(-1, (PV, 3)), o_pair
