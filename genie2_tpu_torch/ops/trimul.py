"""The triangle multiplicative update as three kernels, and their plain versions.

The op (AF2 Algorithms 11/12) is LN_in -> four gated projections -> a masked
per-channel contraction over the third node -> LN_out -> linear_z, times a
sigmoid gate of LN_in(z). It runs as three stages that keep the hidden
activations channel-major, [B, H, N, N], between them:

  project   z [B,N,N,C] -> a, b [B,H,N,N]  (csrc/trimul_project.cu)
  contract  a, b -> x [B,H,N,N]            (csrc/trimul_contract.cu)
              outgoing: x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,j,k]
              incoming: x[b,h,i,j] = sum_k a[b,h,k,i] b[b,h,k,j]
  epilogue  x, z -> out [B,N,N,C]          (csrc/trimul_epilogue.cu)
              LN_out folded into linear_z: r*(x.ws) - r*mu*u + vb,
              times sigmoid(LN_in(z).W_g + b_g) with LN_in recomputed.

Under tensor parallelism (nn/pair_stack.py) each rank holds H_r of the H
hidden channels, and the epilogue's LN_out statistics and x.ws product
are sums over all of them. It then runs as two stages around one
all-reduce of their partial sums (csrc/trimul_epilogue.cu's other modes):

  epilogue_partial  x [B,H_r,N,N] -> part, float32, flat: [B,N,N,D+2]
                      (x.ws over this rank's channels, sum_h x, sum_h x^2)
                      then [2, D] (sum_h ws and W_z.ln_out_bias over them)
  (all-reduce SUM of part over the model group, by the caller)
  epilogue_finish   part, z -> out [B,N,N,C_out]: mu, var over all H,
                      r*(x.ws) - r*mu*u + vb, times the gate as above.

`contract_cm_km` is the same contraction with the right operand stored
k-major, x[b,h,i,j] = sum_k a[b,h,i,k] b[b,h,k,j] (csrc/triangle_contract.cu);
no module's forward calls it, as in genie2_tpu: it runs in the contraction's
backward.

Gradients (ops/launch.py): the contraction's backward is four contractions
of the same kind, all kernels on the card,

  outgoing  da = dx . b   = contract_cm_km(dx, b)
            db = dx^T . a = contract_cm(dx, a, outgoing=False)
  incoming  da = b . dx^T = contract_cm(b, dx, outgoing=True)
            db = a . dx   = contract_cm_km(a, dx)

(a, b, dx per channel, [N, N] each). The projection's backward is a kernel
too, for float32 activations (`ProjectGatedCM`, csrc/trimul_project.cu's
second entry point; `project_gated_cm_backward_plain` is its closed form):
LN_in and the four projections recomputed tile by tile, dz, the weights'
and LN_in's gradients in one pass, the weight sums reduced in a fixed order.
So is the epilogue's, for float32 activations and C_out <= 256
(`EpilogueCM`, csrc/trimul_epilogue.cu's backward entry point;
`epilogue_cm_backward_plain` is its closed form): LN_out's statistics, x.ws,
LN_in and the gate recomputed tile by tile, dx, dz, and the gradients of
W_z, the LN_out scale and bias, b_z, W_g, b_g and the LN_in scale and bias in
one pass. bfloat16 activations, H above 256 (the projection), C_out above
256 (the epilogue) and the epilogue's two stages under tensor parallelism
take the gradient of their plain versions, recomputed (`Recomputed`).

Row blocks (sequence parallelism, nn/pair_stack.py): every stage takes a
block of I rows of the pair representation against all N columns, through
the same kernels with their shape arguments generalized. The projection
reads z [B,I,N,C] with a row mask [B,I] and a column mask [B,N] and
writes a, b [B,H,I,N]; the contraction takes any (I, J, K), a [I,K] and b
[J,K] outgoing, a [K,I] and b [K,J] incoming (the outgoing block: I of
N rows against the gathered b; the incoming partial sums: K of N rows to
x [B,H,N,N]); contract_cm_km a [I,K] and b [K,J]; the epilogue and its
two stages act on the B I N positions of x [B,H,I,N] and z [B,I,N,C].
The square case is I = J = K = N.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a tensor on the card; anything else raises. The plain
versions keep the JAX functions' argument layouts (ops/trimul_fused.py in
genie2_tpu) and their rounding points: normalised activations are rounded
to the activation dtype before each product, and products accumulate in
float32.

Weights use torch's Linear layout: w_ap, w_ag, w_bp, w_bg [H, C]; w_z
[C_out, H]; w_g [C_out, C]; LayerNorm scales and biases are vectors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from genie2_tpu_torch.ops.launch import (
    DTYPE_CODES as _DTYPE_CODES,
    check_activation as _check_activation,
    launch,
    on_cpu as _on_cpu,
    Recomputed,
    records_grad,
)
from genie2_tpu_torch.utils.profiling import count, spanned

LN_EPS = 1e-6

Weights = Dict[str, torch.Tensor]


# --------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------- #


def _ln_lane(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * scale.float() + bias.float()


def project_gated_cm_plain(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, col_mask: torch.Tensor = None):
    """z [B,I,N,C], res_mask [B,I] (the rows') and col_mask [B,N] (the
    columns'; default res_mask, I = N) -> (a, b) each [B,H,I,N] in z's
    dtype."""
    dt = z.dtype
    col_mask = res_mask if col_mask is None else col_mask
    zn = _ln_lane(z, w["ln_in_scale"], w["ln_in_bias"]).to(dt).float()
    mask = (res_mask[:, :, None] * col_mask[:, None, :]).to(dt).float()[:, None]

    def proj(wk, bk):
        out = torch.matmul(zn, w[wk].to(dt).float().t()) + w[bk].float()
        return out.permute(0, 3, 1, 2)

    def gated(p, g):
        gate = torch.sigmoid(proj(f"w_{g}", f"b_{g}"))
        return (proj(f"w_{p}", f"b_{p}") * gate * mask).to(dt).contiguous()

    return gated("ap", "ag"), gated("bp", "bg")


def project_gated_cm_backward_plain(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, da: torch.Tensor,
                                    db: torch.Tensor, col_mask: torch.Tensor = None, weight_grads: bool = True):
    """The gradients of `project_gated_cm_plain` for the cotangents da, db
    [B,H,I,N] in closed form, at autograd's rounding points -> (dz in z's
    dtype, {name: gradient} of PROJECT_PARAMS in each parameter's dtype, or
    None without `weight_grads`). Per position, with P_k = zn.W_k + b_k, s =
    sigmoid(P_ag) and e = da r_i m_j: dP_ap = e s, dP_ag = e P_ap s (1 - s)
    (bp, bg likewise with db); dzn = sum_k dP_k.W_k, rounded to z's dtype;
    dz is LN_in's backward of dzn; dW_k = dP_k^T zn and db_k = sum dP_k over
    positions, d ln_in_scale = sum dzn x^, d ln_in_bias = sum dzn."""
    dt = z.dtype
    col_mask = res_mask if col_mask is None else col_mask
    xf = z.float()
    xc = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + LN_EPS)
    xhat = xc * rstd
    zn = (xhat * w["ln_in_scale"].float() + w["ln_in_bias"].float()).to(dt).float()
    mask = (res_mask[:, :, None] * col_mask[:, None, :]).to(dt).float()[..., None]
    weights = {k: w[f"w_{k}"].to(dt).float() for k in ("ap", "ag", "bp", "bg")}
    dp = {}
    for (pk, gk), cot in ((("ap", "ag"), da), (("bp", "bg"), db)):
        proj = torch.matmul(zn, weights[pk].t()) + w[f"b_{pk}"].float()
        gate = torch.sigmoid(torch.matmul(zn, weights[gk].t()) + w[f"b_{gk}"].float())
        e = cot.float().permute(0, 2, 3, 1) * mask
        dp[pk] = e * gate
        dp[gk] = e * proj * (gate * (1.0 - gate))
    dzn = sum(torch.matmul(dp[k], weights[k]) for k in ("ap", "ag", "bp", "bg")).to(dt).float()
    g = dzn * w["ln_in_scale"].float()
    dz = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    if not weight_grads:
        return dz.to(dt), None
    positions = zn.reshape(-1, zn.shape[-1])
    grads = {}
    for k in ("ap", "ag", "bp", "bg"):
        grads[f"w_{k}"] = torch.matmul(dp[k].reshape(-1, dp[k].shape[-1]).t(), positions).to(dt)
        grads[f"b_{k}"] = dp[k].sum((0, 1, 2))
    grads["ln_in_scale"] = (dzn * xhat).sum((0, 1, 2))
    grads["ln_in_bias"] = dzn.sum((0, 1, 2))
    return dz.to(dt), {k: grads[k].to(w[k].dtype) for k in PROJECT_PARAMS}


def contract_cm_plain(a: torch.Tensor, b: torch.Tensor, outgoing: bool = True) -> torch.Tensor:
    """outgoing a [B,H,I,K] x b [B,H,J,K], incoming a [B,H,K,I] x b
    [B,H,K,J] -> [B,H,I,J], float32 accumulation."""
    af, bf = a.float(), b.float()
    x = torch.matmul(af, bf.transpose(-1, -2)) if outgoing else torch.matmul(af.transpose(-1, -2), bf)
    return x.to(a.dtype)


def contract_cm_km_plain(a: torch.Tensor, b_km: torch.Tensor) -> torch.Tensor:
    """a [B,H,I,K] x b [B,H,K,J] -> [B,H,I,J], float32 accumulation."""
    return torch.matmul(a.float(), b_km.float()).to(a.dtype)


def fold_ln_out(w: Weights, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LN_out folded into linear_z: ws = w_z * scale rounded to the
    activation dtype ([C_out, H], as float32), u = sum_h ws and
    vb = w_z . bias + b_z."""
    w_z = w["w_z"].float()
    ws = (w_z * w["ln_out_scale"].float()[None, :]).to(dtype).float()
    u = ws.sum(1)
    vb = torch.mv(w_z, w["ln_out_bias"].float()) + w["b_z"].float()
    return ws, u, vb


def part_size(B: int, N: int, D: int, rows: int = None) -> int:
    """The number of float32 values of `epilogue_partial`'s flat output
    for `rows` (default N) rows of N positions."""
    return B * (N if rows is None else rows) * N * (D + 2) + 2 * D


def split_part(part: torch.Tensor, B: int, N: int, D: int, rows: int = None):
    """The flat partial sums as (per position [B,I,N,D+2], weight sums [2,
    D]), I = `rows` (default N)."""
    rows = N if rows is None else rows
    n = B * rows * N * (D + 2)
    return part[:n].view(B, rows, N, D + 2), part[n:].view(2, D)


def epilogue_partial_plain(x: torch.Tensor, w_z: torch.Tensor, ln_out_scale: torch.Tensor,
                           ln_out_bias: torch.Tensor) -> torch.Tensor:
    """x [B,H_r,I,N], w_z [C_out,H_r], the LN_out scale and bias [H_r] of
    this rank's channels -> the flat float32 partial sums (module
    docstring): x.ws with ws = w_z * scale rounded to x's dtype, sum_h x,
    sum_h x^2, then sum_h ws and w_z.bias."""
    xf = x.float()
    ws = (w_z.float() * ln_out_scale.float()[None, :]).to(x.dtype).float()
    sums = torch.stack([ws.sum(1), torch.mv(w_z.float(), ln_out_bias.float())])
    main = torch.matmul(xf.permute(0, 2, 3, 1), ws.t())
    per_pos = torch.cat([main, xf.sum(1)[..., None], xf.square().sum(1)[..., None]], dim=-1)
    return torch.cat([per_pos.reshape(-1), sums.reshape(-1)])


def epilogue_finish_plain(part: torch.Tensor, z: torch.Tensor, ln_in_scale: torch.Tensor,
                          ln_in_bias: torch.Tensor, b_z: torch.Tensor, w_g: torch.Tensor, b_g: torch.Tensor,
                          H: int) -> torch.Tensor:
    """The partial sums of all H channels (summed over the ranks) and z
    [B,I,N,C] -> gated output [B,I,N,C_out] (row-major), as
    `epilogue_cm_plain` computes it from x."""
    dt = z.dtype
    B, I, N = z.shape[:3]
    D = w_g.shape[0]
    per_pos, sums = split_part(part, B, N, D, I)
    mu = per_pos[..., D] / H
    var = per_pos[..., D + 1] / H - mu.square()
    r = torch.rsqrt(var + LN_EPS)
    lin = r[..., None] * per_pos[..., :D] - (r * mu)[..., None] * sums[0] + sums[1] + b_z.float()
    zn = _ln_lane(z, ln_in_scale, ln_in_bias).to(dt).float()
    g = torch.matmul(zn, w_g.to(dt).float().t()) + b_g.float()
    return (lin * torch.sigmoid(g)).to(dt)


def epilogue_cm_plain(x: torch.Tensor, z: torch.Tensor, w: Weights) -> torch.Tensor:
    """x [B,H,I,N] + z [B,I,N,C] -> gated output [B,I,N,C_out] (row-major)."""
    dt = z.dtype
    xf = x.float()
    mu = xf.mean(1)
    var = xf.square().mean(1) - mu.square()
    r = torch.rsqrt(var + LN_EPS)
    ws, u, vb = fold_ln_out(w, x.dtype)
    main = torch.matmul(xf.permute(0, 2, 3, 1), ws.t())
    lin = r[..., None] * main - (r * mu)[..., None] * u + vb
    zn = _ln_lane(z, w["ln_in_scale"], w["ln_in_bias"]).to(dt).float()
    g = torch.matmul(zn, w["w_g"].to(dt).float().t()) + w["b_g"].float()
    return (lin * torch.sigmoid(g)).to(dt)


def epilogue_cm_backward_plain(x: torch.Tensor, z: torch.Tensor, w: Weights, dout: torch.Tensor,
                               weight_grads: bool = True):
    """The gradients of `epilogue_cm_plain` for the cotangent dout
    [B,I,N,C_out] in closed form, at autograd's rounding points -> (dx in
    x's dtype, dz in z's dtype, {name: gradient} of EPILOGUE_PARAMS in each
    parameter's dtype, or None without `weight_grads`). Per position, with
    x^ = r (x - mu) over H, lin = x^.ws + vb (fold_ln_out), zn = LN_in(z), g
    = zn.W_g + b_g and s = sigmoid(g): dlin = dout s, dg = dout lin s (1 -
    s); dx^ = dlin.ws, dx = LN_out's backward of dx^, r (dx^ - mean dx^ - x^
    mean(dx^ x^)); dzn = dg.W_g, dz = LN_in's backward of dzn. Over
    positions: d ws = dlin^T x^, d vb = sum dlin, d W_g = dg^T zn, d b_g =
    sum dg, d ln_in_scale = sum dzn z^, d ln_in_bias = sum dzn; then those of
    W_z, LN_out's scale and bias and b_z (`unfold_ln_out_grads`)."""
    dt = z.dtype
    xf = x.float().permute(0, 2, 3, 1)
    mu = xf.mean(-1, keepdim=True)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) - mu.square() + LN_EPS)
    xhat = (xf - mu) * r
    ws, u, vb = fold_ln_out(w, x.dtype)
    lin = r * torch.matmul(xf, ws.t()) - (r * mu) * u + vb
    zf = z.float()
    zc = zf - zf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(zc.square().mean(-1, keepdim=True) + LN_EPS)
    zhat = zc * rstd
    zn = (zhat * w["ln_in_scale"].float() + w["ln_in_bias"].float()).to(dt).float()
    wg = w["w_g"].to(dt).float()
    s = torch.sigmoid(torch.matmul(zn, wg.t()) + w["b_g"].float())
    o = dout.float()
    dlin = o * s
    dg = o * lin * (s * (1.0 - s))
    dxh = torch.matmul(dlin, ws)
    dx = r * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))
    dzn = torch.matmul(dg, wg).to(dt).float()
    gs = dzn * w["ln_in_scale"].float()
    dz = rstd * (gs - gs.mean(-1, keepdim=True) - zhat * (gs * zhat).mean(-1, keepdim=True))
    dx = dx.permute(0, 3, 1, 2).to(x.dtype).contiguous()
    if not weight_grads:
        return dx, dz.to(dt), None
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dws = torch.matmul(flat(dlin).t(), flat(xhat)).to(x.dtype).float()
    grads = unfold_ln_out_grads(w, dws, flat(dlin).sum(0))
    grads.update(w_g=torch.matmul(flat(dg).t(), flat(zn)), b_g=flat(dg).sum(0),
                 ln_in_scale=flat(dzn * zhat).sum(0), ln_in_bias=flat(dzn).sum(0))
    return dx, dz.to(dt), {k: grads[k].to(w[k].dtype) for k in EPILOGUE_PARAMS}


def unfold_ln_out_grads(w: Weights, dws: torch.Tensor, dvb: torch.Tensor) -> Weights:
    """The gradients of W_z, LN_out's scale and bias and b_z from those of
    fold_ln_out's ws [C_out, H] and vb [C_out]: d W_z = d ws * scale + d vb
    bias^T, d scale = sum_d d ws * W_z, d bias = W_z^T d vb, d b_z = d vb."""
    w_z = w["w_z"].float()
    return {"w_z": dws * w["ln_out_scale"].float() + dvb[:, None] * w["ln_out_bias"].float(),
            "ln_out_scale": (dws * w_z).sum(0), "ln_out_bias": torch.mv(w_z.t(), dvb), "b_z": dvb}


# --------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------- #


def _as(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A weight as a contiguous tensor of `dtype` on `device` (a no-op for a
    contiguous parameter of that dtype)."""
    if t.device != device:
        raise ValueError(f"weight on {t.device}, activations on {device}")
    return t.to(dtype).contiguous()


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    """A weight as a contiguous float32 tensor on `device`."""
    return _as(t, torch.float32, device)


def _params(tensors, like: torch.Tensor, device):
    """Kernel parameters as contiguous tensors on `device` in `like`'s dtype
    where the kernels read it (float32 or bfloat16), else float32, and its
    dtype code: a contiguous parameter of that dtype goes in as it is."""
    dt = like.dtype if like.dtype in _DTYPE_CODES else torch.float32
    return [_as(t, dt, device) for t in tensors], _DTYPE_CODES[dt]


_ARGTYPES = {
    "trimul_project": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7,
    "trimul_project_backward": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 7,
    "trimul_project_backward_scratch": [ctypes.c_void_p] + [ctypes.c_int] * 5,
    "trimul_contract": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6,
    "trimul_epilogue": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8,
    "trimul_epilogue_partial": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7,
    "trimul_epilogue_finish": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8,
    "trimul_epilogue_backward": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8,
    "trimul_epilogue_backward_scratch": [ctypes.c_void_p] + [ctypes.c_int] * 6,
}

# The parameters of the projection and of the epilogue (float32 or
# bfloat16), in the order of their C entry points.
PROJECT_PARAMS = ("ln_in_scale", "ln_in_bias", "w_ap", "w_ag", "w_bp", "w_bg", "b_ap", "b_ag", "b_bp", "b_bg")
EPILOGUE_PARAMS = ("ln_in_scale", "ln_in_bias", "w_z", "ln_out_scale", "ln_out_bias", "b_z", "w_g", "b_g")
# The finish stage's parameters, in the order of `epilogue_finish_plain`'s
# arguments.
FINISH_PARAMS = ("ln_in_scale", "ln_in_bias", "b_z", "w_g", "b_g")


def _launch(name: str, device, *args, source: str = None):
    """The entry point `name` of csrc/<source>.cu (default: of the same name)."""
    launch(source or name, name, _ARGTYPES[name], device, *args)


_TRIANGLE_CONTRACT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2


def launch_triangle_contract(a, b, out, dims, sa, sb, so, variant: int):
    """csrc/triangle_contract.cu on [B,C,I,K] / [B,C,J,K] views, dims =
    (B, C, N) or (B, C, I, J, K), given by their element strides (batch,
    channel, row, k): out[b,c,i,j] = sum_k a[b,c,i,k] b[b,c,j,k]. variant
    0: k contiguous in a and b; 1: k contiguous in a, the row in b; 2: the
    channel contiguous in all (square only, I = J = K)."""
    B, C, *ijk = dims
    I, J, K = ijk * 3 if len(ijk) == 1 else ijk
    launch("triangle_contract", "triangle_contract", _TRIANGLE_CONTRACT_ARGTYPES, out.device,
           a, b, out, B, C, I, J, K, *sa, *sb, *so, variant, _DTYPE_CODES[out.dtype])


_MAX_CHANNELS = 256  # the kernels' shared-memory tiles hold at most this many


# The projection's backward kernel holds a cluster of at most 8 blocks of 32
# hidden channels; the epilogue's one of at most 8 blocks of 32 output
# channels.
_BACKWARD_MAX_HIDDEN = 256
_BACKWARD_MAX_OUT = 256


count("launch.trimul_project", 0)


def project_gated_cm(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, col_mask: torch.Tensor = None):
    """z [B,I,N,C], res_mask [B,I] (the rows' mask) and col_mask [B,N]
    (the columns'; default res_mask, I = N) -> (a, b) each [B,H,I,N]
    channel-major."""
    col_mask = res_mask if col_mask is None else col_mask
    params = [w[k] for k in PROJECT_PARAMS]
    if records_grad([z, *params]) and not _on_cpu(z):
        if z.dtype == torch.float32 and w["w_ap"].shape[0] <= _BACKWARD_MAX_HIDDEN:
            return ProjectGatedCM.apply(z, res_mask, col_mask, *params)
        return Recomputed.apply(functools.partial(_PROJECT_KERNEL, col_mask=col_mask),
                                functools.partial(_PROJECT_PLAIN, col_mask=col_mask), z, res_mask, *params)
    return _project_gated_cm_forward(z, res_mask, w, col_mask)


def _project_gated_cm_forward(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, col_mask: torch.Tensor = None):
    """The kernel for a tensor on the card (no graph), the plain version for
    a tensor on the CPU."""
    col_mask = res_mask if col_mask is None else col_mask
    if _on_cpu(z):
        return project_gated_cm_plain(z, res_mask, w, col_mask)
    _check_activation("project z", z, 4)
    B, I, N, C = z.shape
    H = w["w_ap"].shape[0]
    shapes_ok = all(tuple(w[f"w_{k}"].shape) == (H, C) and tuple(w[f"b_{k}"].shape) == (H,)
                    for k in ("ap", "ag", "bp", "bg"))
    if tuple(res_mask.shape) != (B, I) or tuple(col_mask.shape) != (B, N) or C > _MAX_CHANNELS or H < 1 \
            or not shapes_ok:
        raise ValueError(f"project: z {tuple(z.shape)}, row mask {tuple(res_mask.shape)}, column mask "
                         f"{tuple(col_mask.shape)}, H={H}")
    dev = z.device
    a = torch.empty((B, H, I, N), dtype=z.dtype, device=dev)
    b = torch.empty_like(a)
    # The kernel rounds the product weights to the activation dtype and
    # orders them itself, as it stages them; it reads the parameters in
    # float32 or bfloat16, all in W_ap's dtype.
    params, pcode = _params([w[k] for k in PROJECT_PARAMS], w["w_ap"], dev)
    _launch("trimul_project", dev, z, _f32(res_mask, dev), _f32(col_mask, dev), *params, a, b, B, I, N, C, H,
            _DTYPE_CODES[z.dtype], pcode)
    count("launch.trimul_project")
    return a, b


count("launch.trimul_project_backward", 0)


def project_gated_cm_backward(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, da: torch.Tensor,
                              db: torch.Tensor, col_mask: torch.Tensor = None, weight_grads: bool = True):
    """The gradients of `project_gated_cm` for the cotangents da, db
    [B,H,I,N] -> (dz, {name: gradient} of PROJECT_PARAMS or None), as
    `project_gated_cm_backward_plain`: the backward kernel for float32 on
    the card (one launch, and one more that sums the weights' gradients
    where `weight_grads`), the plain closed form on the CPU."""
    col_mask = res_mask if col_mask is None else col_mask
    if _on_cpu(z):
        return project_gated_cm_backward_plain(z, res_mask, w, da, db, col_mask, weight_grads)
    _check_activation("project backward z", z, 4)
    B, I, N, C = z.shape
    H = w["w_ap"].shape[0]
    da, db = da.contiguous(), db.contiguous()
    if z.dtype != torch.float32 or da.shape != (B, H, I, N) or db.shape != da.shape or da.dtype != z.dtype \
            or db.dtype != z.dtype or C > _MAX_CHANNELS or H > _BACKWARD_MAX_HIDDEN:
        raise ValueError(f"project backward: z {tuple(z.shape)} {z.dtype}, da {tuple(da.shape)} {da.dtype}, "
                         f"db {tuple(db.shape)} {db.dtype}, H={H}")
    dev = z.device
    params, pcode = _params([w[k] for k in PROJECT_PARAMS], w["w_ap"], dev)
    dz = torch.empty_like(z)
    part = sums = None
    if weight_grads:
        floats = torch.zeros(1, dtype=torch.int64)  # filled in on the host
        _launch("trimul_project_backward_scratch", dev, floats, B, I, N, C, H, source="trimul_project")
        part = torch.empty(int(floats.item()), dtype=torch.float32, device=dev)
        sums = torch.empty(4 * H * C + 4 * H + 2 * C, dtype=torch.float32, device=dev)
    _launch("trimul_project_backward", dev, z, _f32(res_mask, dev), _f32(col_mask, dev), *params, da, db, dz, part,
            sums, B, I, N, C, H, _DTYPE_CODES[z.dtype], pcode, source="trimul_project")
    count("launch.trimul_project_backward")
    if not weight_grads:
        return dz, None
    dw, dbias, dln = sums.split([4 * H * C, 4 * H, 2 * C])
    grads = dict(zip(("w_ap", "w_ag", "w_bp", "w_bg"), dw.view(4, H, C)))
    grads.update(zip(("b_ap", "b_ag", "b_bp", "b_bg"), dbias.view(4, H)))
    grads.update(ln_in_scale=dln[:C], ln_in_bias=dln[C:])
    return dz, {k: grads[k].to(w[k].dtype) for k in PROJECT_PARAMS}


count("launch.trimul_contract_out", 0)
count("launch.trimul_contract_in", 0)


def contract_cm(a: torch.Tensor, b: torch.Tensor, outgoing: bool = True) -> torch.Tensor:
    """outgoing a [B,H,I,K] x b [B,H,J,K], incoming a [B,H,K,I] x b
    [B,H,K,J] -> [B,H,I,J]; `outgoing` selects which index is k."""
    if records_grad([a, b]) and not _on_cpu(a):
        return ContractCM.apply(a, b, outgoing)
    return _contract_cm_forward(a, b, outgoing)


def _contract_cm_forward(a: torch.Tensor, b: torch.Tensor, outgoing: bool) -> torch.Tensor:
    if _on_cpu(a):
        return contract_cm_plain(a, b, outgoing)
    _check_activation("contract a", a, 4)
    _check_activation("contract b", b, 4)
    B, H = a.shape[:2]
    (I, K), (J, K2) = (a.shape[2:], b.shape[2:]) if outgoing else (a.shape[:1:-1], b.shape[:1:-1])
    if K2 != K or b.shape[:2] != a.shape[:2] or b.dtype != a.dtype or b.device != a.device:
        raise ValueError(f"contract: a {tuple(a.shape)} {a.dtype}, b {tuple(b.shape)} {b.dtype}")
    out = torch.empty((B, H, I, J), dtype=a.dtype, device=a.device)
    _launch("trimul_contract", a.device, a, b, out, B * H, I, J, K, int(outgoing), _DTYPE_CODES[a.dtype])
    count("launch.trimul_contract_out" if outgoing else "launch.trimul_contract_in")
    return out


count("launch.contract_cm_km", 0)


def contract_cm_km(a: torch.Tensor, b_km: torch.Tensor) -> torch.Tensor:
    """a [B,H,I,K] x b [B,H,K,J] -> [B,H,I,J] (right operand k-major)."""
    if _on_cpu(a):
        return contract_cm_km_plain(a, b_km)
    _check_activation("contract_km a", a, 4)
    _check_activation("contract_km b", b_km, 4, like=a)
    B, H, I, K = a.shape
    J = b_km.shape[3]
    if b_km.shape[:3] != (B, H, K):
        raise ValueError(f"contract_km: a {tuple(a.shape)}, b {tuple(b_km.shape)}")
    out = torch.empty((B, H, I, J), dtype=a.dtype, device=a.device)
    sb, sh, s2, s3 = b_km.stride()
    dims = (B, H, I) if I == J == K else (B, H, I, J, K)
    launch_triangle_contract(a, b_km, out, dims, a.stride(), (sb, sh, s3, s2), out.stride(), variant=1)
    count("launch.contract_cm_km")
    return out


count("launch.trimul_epilogue", 0)


def epilogue_cm(x: torch.Tensor, z: torch.Tensor, w: Weights) -> torch.Tensor:
    """x [B,H,I,N] + z [B,I,N,C] -> gated output [B,I,N,C_out] row-major."""
    params = [w[k] for k in EPILOGUE_PARAMS]
    if records_grad([x, z, *params]) and not _on_cpu(x):
        if x.dtype == torch.float32 and w["w_z"].shape[0] <= _BACKWARD_MAX_OUT:
            return EpilogueCM.apply(x, z, *params)
        return Recomputed.apply(_EPILOGUE_KERNEL, _EPILOGUE_PLAIN, x, z, *params)
    return _epilogue_cm_forward(x, z, w)


def _epilogue_cm_forward(x: torch.Tensor, z: torch.Tensor, w: Weights) -> torch.Tensor:
    if _on_cpu(x):
        return epilogue_cm_plain(x, z, w)
    _check_activation("epilogue x", x, 4)
    _check_activation("epilogue z", z, 4)
    B, H, I, N = x.shape
    C = z.shape[-1]
    D = w["w_z"].shape[0]
    if (
        tuple(z.shape) != (B, I, N, C) or z.dtype != x.dtype or z.device != x.device
        or tuple(w["w_z"].shape) != (D, H) or tuple(w["w_g"].shape) != (D, C) or H > _MAX_CHANNELS
        or C > _MAX_CHANNELS
    ):
        raise ValueError(f"epilogue: x {tuple(x.shape)}, z {tuple(z.shape)}, C_out={D}")
    dev = x.device
    out = torch.empty((B, I, N, D), dtype=z.dtype, device=dev)
    # The kernel folds LN_out into linear_z (fold_ln_out) and rounds the
    # product weights to the activation dtype itself, as it stages them; it
    # reads the parameters in float32 or bfloat16, all in W_z's dtype.
    params, pcode = _params([w[k] for k in EPILOGUE_PARAMS], w["w_z"], dev)
    _launch("trimul_epilogue", dev, x, z, *params, out, B, I, N, C, H, D, _DTYPE_CODES[x.dtype], pcode)
    count("launch.trimul_epilogue")
    return out


count("launch.trimul_epilogue_backward", 0)


def epilogue_cm_backward(x: torch.Tensor, z: torch.Tensor, w: Weights, dout: torch.Tensor,
                         weight_grads: bool = True):
    """The gradients of `epilogue_cm` for the cotangent dout [B,I,N,C_out]
    -> (dx, dz, {name: gradient} of EPILOGUE_PARAMS or None), as
    `epilogue_cm_backward_plain`: the backward kernel for float32 on the
    card (one launch, and one more that sums the weights' gradients where
    `weight_grads`), the plain closed form on the CPU."""
    if _on_cpu(x):
        return epilogue_cm_backward_plain(x, z, w, dout, weight_grads)
    _check_activation("epilogue backward x", x, 4)
    _check_activation("epilogue backward z", z, 4, like=x)
    B, H, I, N = x.shape
    C = z.shape[-1]
    D = w["w_z"].shape[0]
    dout = dout.contiguous()
    if x.dtype != torch.float32 or tuple(z.shape) != (B, I, N, C) or tuple(dout.shape) != (B, I, N, D) \
            or dout.dtype != x.dtype or tuple(w["w_z"].shape) != (D, H) or tuple(w["w_g"].shape) != (D, C) \
            or H > _MAX_CHANNELS or C > _MAX_CHANNELS or D > _BACKWARD_MAX_OUT:
        raise ValueError(f"epilogue backward: x {tuple(x.shape)} {x.dtype}, z {tuple(z.shape)}, dout "
                         f"{tuple(dout.shape)} {dout.dtype}, C_out={D}")
    dev = x.device
    params, pcode = _params([w[k] for k in EPILOGUE_PARAMS], w["w_z"], dev)
    dx, dz = torch.empty_like(x), torch.empty_like(z)
    part = sums = None
    if weight_grads:
        floats = torch.zeros(1, dtype=torch.int64)  # filled in on the host
        _launch("trimul_epilogue_backward_scratch", dev, floats, B, I, N, C, H, D, source="trimul_epilogue")
        part = torch.empty(int(floats.item()), dtype=torch.float32, device=dev)
        sums = torch.empty(D * H + D * C + 2 * D + 2 * C, dtype=torch.float32, device=dev)
    _launch("trimul_epilogue_backward", dev, x, z, *params, dout, dx, dz, part, sums, B, I, N, C, H, D,
            _DTYPE_CODES[x.dtype], pcode, source="trimul_epilogue")
    count("launch.trimul_epilogue_backward")
    if not weight_grads:
        return dx, dz, None
    # The kernel sums the gradients of the folded weights (fold_ln_out).
    dws, dwg, dvb, dbg, dls, dlb = sums.split([D * H, D * C, D, D, C, C])
    grads = unfold_ln_out_grads(w, dws.view(D, H), dvb)
    grads.update(w_g=dwg.view(D, C), b_g=dbg, ln_in_scale=dls, ln_in_bias=dlb)
    return dx, dz, {k: grads[k].to(w[k].dtype) for k in EPILOGUE_PARAMS}


count("launch.trimul_epilogue_partial", 0)


def epilogue_partial(x: torch.Tensor, w_z: torch.Tensor, ln_out_scale: torch.Tensor,
                     ln_out_bias: torch.Tensor) -> torch.Tensor:
    """x [B,H_r,I,N] and this rank's epilogue weights -> the flat float32
    partial sums (`epilogue_partial_plain`)."""
    if records_grad([x, w_z, ln_out_scale, ln_out_bias]) and not _on_cpu(x):
        return Recomputed.apply(_epilogue_partial_forward, epilogue_partial_plain, x, w_z, ln_out_scale,
                                ln_out_bias)
    return _epilogue_partial_forward(x, w_z, ln_out_scale, ln_out_bias)


def _epilogue_partial_forward(x, w_z, ln_out_scale, ln_out_bias) -> torch.Tensor:
    if _on_cpu(x):
        return epilogue_partial_plain(x, w_z, ln_out_scale, ln_out_bias)
    _check_activation("epilogue_partial x", x, 4)
    B, H, I, N = x.shape
    D = w_z.shape[0]
    if tuple(w_z.shape) != (D, H) or ln_out_scale.shape != (H,) or ln_out_bias.shape != (H,) or H > _MAX_CHANNELS:
        raise ValueError(f"epilogue_partial: x {tuple(x.shape)}, w_z {tuple(w_z.shape)}")
    dev = x.device
    params, pcode = _params((w_z, ln_out_scale, ln_out_bias), w_z, dev)
    part = torch.empty(part_size(B, N, D, I), dtype=torch.float32, device=dev)
    _launch("trimul_epilogue_partial", dev, x, *params, part, B, I, N, H, D, _DTYPE_CODES[x.dtype], pcode,
            source="trimul_epilogue")
    count("launch.trimul_epilogue_partial")
    return part


count("launch.trimul_epilogue_finish", 0)


def epilogue_finish(part: torch.Tensor, z: torch.Tensor, w: Weights, H: int) -> torch.Tensor:
    """The partial sums of all H channels, summed over the ranks, and z
    [B,I,N,C] -> gated output [B,I,N,C_out] (`epilogue_finish_plain`)."""
    params = [w[k] for k in FINISH_PARAMS]
    kernel, plain = functools.partial(_epilogue_finish_forward, H=H), functools.partial(epilogue_finish_plain, H=H)
    if records_grad([part, z, *params]) and not _on_cpu(z):
        return Recomputed.apply(kernel, plain, part, z, *params)
    return kernel(part, z, *params)


def _epilogue_finish_forward(part, z, ln_in_scale, ln_in_bias, b_z, w_g, b_g, H: int) -> torch.Tensor:
    if _on_cpu(z):
        return epilogue_finish_plain(part, z, ln_in_scale, ln_in_bias, b_z, w_g, b_g, H)
    _check_activation("epilogue_finish z", z, 4)
    B, I, N, C = z.shape
    D = w_g.shape[0]
    if part.dtype != torch.float32 or part.shape != (part_size(B, N, D, I),) or not part.is_contiguous() \
            or tuple(w_g.shape) != (D, C) or C > _MAX_CHANNELS or H < 1:
        raise ValueError(f"epilogue_finish: part {tuple(part.shape)}, z {tuple(z.shape)}, C_out={D}")
    dev = z.device
    u, vb = split_part(part, B, N, D, I)[1]  # the weight sums, float32 views into part
    (ln_s, ln_b, b_z, w_g, b_g), pcode = _params((ln_in_scale, ln_in_bias, b_z, w_g, b_g), w_g, dev)
    out = torch.empty((B, I, N, D), dtype=z.dtype, device=dev)
    _launch("trimul_epilogue_finish", dev, part, z, ln_s, ln_b, u, vb, b_z, w_g, b_g, out, B, I, N, C, H, D,
            _DTYPE_CODES[z.dtype], pcode, source="trimul_epilogue")
    count("launch.trimul_epilogue_finish")
    return out


# --------------------------------------------------------------------- #
# Gradients
# --------------------------------------------------------------------- #


def _flat(fn, names):
    """fn(x, y, w) as a function of (x, y, *params), the parameters of w in
    `names` order, for `Recomputed`."""
    @functools.wraps(fn)
    def flat(x, y, *params):
        return fn(x, y, dict(zip(names, params)))
    return flat


def _project(fn):
    """fn(z, row mask, w, column mask) as a function of (z, row mask,
    *params, col_mask=None: the row mask), for `Recomputed`."""
    @functools.wraps(fn)
    def flat(z, row_mask, *params, col_mask=None):
        return fn(z, row_mask, dict(zip(PROJECT_PARAMS, params)), col_mask)
    return flat


# The projection's and the epilogue's kernel forwards and plain versions, as
# `Recomputed` takes them.
_PROJECT_KERNEL = _project(_project_gated_cm_forward)
_PROJECT_PLAIN = _project(project_gated_cm_plain)
_EPILOGUE_KERNEL = _flat(_epilogue_cm_forward, EPILOGUE_PARAMS)
_EPILOGUE_PLAIN = _flat(epilogue_cm_plain, EPILOGUE_PARAMS)


class ProjectGatedCM(torch.autograd.Function):
    """`project_gated_cm` under autograd for float32 activations:
    apply(z, row mask, column mask, *params in PROJECT_PARAMS order).
    Forward: the projection kernel; backward: its backward kernel
    (`project_gated_cm_backward`), the parameters' gradients only where
    one of them needs one."""

    @staticmethod
    def forward(ctx, z, res_mask, col_mask, *params):
        ctx.save_for_backward(z, res_mask, col_mask, *params)
        return _project_gated_cm_forward(z, res_mask, dict(zip(PROJECT_PARAMS, params)), col_mask)

    @staticmethod
    @once_differentiable
    @spanned("backward.trimul_project")
    def backward(ctx, da, db):
        z, res_mask, col_mask, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        dz, grads = project_gated_cm_backward(z, res_mask, dict(zip(PROJECT_PARAMS, params)), da, db, col_mask,
                                              weight_grads=any(needs))
        dparams = [grads[k] if n else None for k, n in zip(PROJECT_PARAMS, needs)] if grads else [None] * len(needs)
        return (dz if ctx.needs_input_grad[0] else None), None, None, *dparams


class EpilogueCM(torch.autograd.Function):
    """`epilogue_cm` under autograd for float32 activations: apply(x, z,
    *params in EPILOGUE_PARAMS order). Forward: the epilogue kernel;
    backward: its backward kernel (`epilogue_cm_backward`), the parameters'
    gradients only where one of them needs one."""

    @staticmethod
    def forward(ctx, x, z, *params):
        ctx.save_for_backward(x, z, *params)
        return _epilogue_cm_forward(x, z, dict(zip(EPILOGUE_PARAMS, params)))

    @staticmethod
    @once_differentiable
    @spanned("backward.trimul_epilogue")
    def backward(ctx, dout):
        x, z, *params = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        dx, dz, grads = epilogue_cm_backward(x, z, dict(zip(EPILOGUE_PARAMS, params)), dout,
                                             weight_grads=any(needs))
        dparams = [grads[k] if n else None for k, n in zip(EPILOGUE_PARAMS, needs)] if grads else [None] * len(needs)
        return (dx if ctx.needs_input_grad[0] else None), (dz if ctx.needs_input_grad[1] else None), *dparams


class ContractCM(torch.autograd.Function):
    """`contract_cm` under autograd: apply(a, b, outgoing). Forward and
    backward are the contraction kernels (the module docstring's four
    identities)."""

    @staticmethod
    def forward(ctx, a, b, outgoing):
        ctx.save_for_backward(a, b)
        ctx.outgoing = outgoing
        return _contract_cm_forward(a, b, outgoing)

    @staticmethod
    @once_differentiable
    @spanned("backward.trimul_contract")
    def backward(ctx, dx):
        a, b = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        dx = dx.contiguous()
        if ctx.outgoing:
            da = contract_cm_km(dx, b) if need_a else None
            db = contract_cm(dx, a, outgoing=False) if need_b else None
        else:
            da = contract_cm(b, dx, outgoing=True) if need_a else None
            db = contract_cm_km(a, dx) if need_b else None
        return da, db, None


def trimul(z: torch.Tensor, res_mask: torch.Tensor, w: Weights, outgoing: bool = True) -> torch.Tensor:
    """The whole update before the residual, square: z [B,N,N,C] -> [B,N,N,C]."""
    a, b = project_gated_cm(z, res_mask, w)
    x = contract_cm(a, b, outgoing)
    return epilogue_cm(x, z, w)
