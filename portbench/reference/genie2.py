"""A plain Genie 2 denoiser, its training loss and Adam, in float32 PyTorch.

This is the yardstick that decides whether the benchmarked program computed
the right numbers. It is written from the Genie 2 paper (arXiv:2405.15489)
and the AlphaFold 2 supplement it builds on, as straight tensor algebra over
a dict of weights keyed like the released checkpoints. It imports nothing of
the program and no kernel: every einsum is materialised whole.

Where the published model leaves a choice open, this file fixes it as the
configuration of the benchmark states it:
- pairwise orientation quaternions are the top eigenvector of the Davenport
  K-matrix (`rotToQuatMethod eigh`). The eigenvector's sign is the solver's
  choice, so the frames, the K-matrices and the eigh call are written op for
  op as the program's geometry does them: the same matrices on the same card
  give the same sign;
- LayerNorm epsilon 1e-6; IPA with a square mask, inf 1e5; triangle
  attention with a key mask, inf 1e9;
- dropout masks follow `dropout_masks` below: one generator per layer
  application, seeded from a CPU generator of the step's dropout seed.

Products run in the caller's precision settings: `precision(tf32=False)`
for the reference, `precision(tf32=True)` for the benchmark's control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
NUM_RESTYPES = 20
EIGH_BATCH = 16384

# The configuration file's keys this model reads, with Genie 2's defaults.
DEFAULTS = {
    "singleFeatureDimension": 384, "pairFeatureDimension": 128, "rescale": 1.0,
    "positionalEmbeddingDimension": 256, "chainEmbeddingDimension": 64, "timestepEmbeddingDimension": 512,
    "relativePositionK": 32, "templateDistanceMinimum": 2.0, "templateDistanceStep": 0.5,
    "templateDistanceNumBins": 37, "numPairTransformLayers": 5, "includeTriangularMultiplicativeUpdate": True,
    "includeTriangularAttention": False, "triangularMultiplicativeHiddenDimension": 128,
    "triangularAttentionHiddenDimension": 32, "triangularAttentionNumHeads": 4, "triangularDropout": 0.25,
    "pairTransitionN": 4, "numStructureLayers": 8, "numStructureBlocks": 1, "ipaHiddenDimension": 16,
    "ipaNumHeads": 12, "ipaNumQkPoints": 4, "ipaNumVPoints": 8, "ipaDropout": 0.1,
    "numStructureTransitionLayers": 1, "structureTransitionDropout": 0.1, "numTimesteps": 1000,
    "maximumNumResidues": 256, "maximumNumChains": 1, "learningRate": 1e-4, "conditionLossWeight": 1,
}


def sizes(config: Dict) -> Dict:
    """The configuration's values over Genie 2's defaults."""
    out = dict(DEFAULTS)
    out.update({k: v for k, v in config.items() if k in DEFAULTS})
    return out


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in full precision (tf32 False) or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ #
# Weights: names, shapes and kinds
# ------------------------------------------------------------------ #


def parameter_spec(config: Dict) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, kind, fan_in) of every weight, in a fixed order. kind:
    linear, final (a zero-initialised output layer), gating (a gate's
    weight), bias, gating_bias, ln_weight, ln_bias, head_weights."""
    c = sizes(config)
    cs, cp = c["singleFeatureDimension"], c["pairFeatureDimension"]
    spec = []

    def lin(name, n_in, n_out, kind="linear", bias=True):
        spec.append((f"{name}.weight", (n_out, n_in), kind, n_in))
        if bias:
            spec.append((f"{name}.bias", (n_out,), "gating_bias" if kind == "gating" else "bias", n_in))

    def ln(name, n):
        spec.append((f"{name}.weight", (n,), "ln_weight", n))
        spec.append((f"{name}.bias", (n,), "ln_bias", n))

    c_in = (c["positionalEmbeddingDimension"] + c["chainEmbeddingDimension"] + c["timestepEmbeddingDimension"]
            + NUM_RESTYPES + 3)
    lin("single_feature_net.linear", c_in, cs, bias=False)
    k, nb = c["relativePositionK"], c["templateDistanceNumBins"]
    for name, n_in in (("linear_s_p_i", cs), ("linear_s_p_j", cs), ("linear_relpos", 2 * k + 3),
                       ("linear_template", nb + 6), ("linear_motif_template", nb + 2)):
        lin(f"pair_feature_net.{name}", n_in, cp, bias=False)
    h_mul, n_tri, c_tri = (c["triangularMultiplicativeHiddenDimension"], c["triangularAttentionNumHeads"],
                           c["triangularAttentionHiddenDimension"])
    for i in range(c["numPairTransformLayers"]):
        pre = f"pair_transform_net.net.{i}"
        if c["includeTriangularMultiplicativeUpdate"]:
            for d in ("out", "in"):
                m = f"{pre}.tri_mul_{d}"
                ln(f"{m}.layer_norm_in", cp)
                lin(f"{m}.linear_a_p", cp, h_mul)
                lin(f"{m}.linear_a_g", cp, h_mul, "gating")
                lin(f"{m}.linear_b_p", cp, h_mul)
                lin(f"{m}.linear_b_g", cp, h_mul, "gating")
                ln(f"{m}.layer_norm_out", h_mul)
                lin(f"{m}.linear_z", h_mul, cp, "final")
                lin(f"{m}.linear_g", cp, cp, "gating")
        if c["includeTriangularAttention"]:
            for d in ("start", "end"):
                m = f"{pre}.tri_att_{d}"
                ln(f"{m}.layer_norm", cp)
                lin(f"{m}.linear", cp, n_tri, bias=False)
                for q in ("q", "k", "v"):
                    lin(f"{m}.mha.linear_{q}", cp, n_tri * c_tri, bias=False)
                lin(f"{m}.mha.linear_g", cp, n_tri * c_tri, "gating")
                lin(f"{m}.mha.linear_o", n_tri * c_tri, cp, "final")
        ln(f"{pre}.pair_transition.layer_norm", cp)
        lin(f"{pre}.pair_transition.linear_1", cp, c["pairTransitionN"] * cp)
        lin(f"{pre}.pair_transition.linear_2", c["pairTransitionN"] * cp, cp, "final")
    h, ch, pq, pv = c["ipaNumHeads"], c["ipaHiddenDimension"], c["ipaNumQkPoints"], c["ipaNumVPoints"]
    for i in range(c["numStructureLayers"]):
        pre = f"structure_net.net.{i}"
        spec.append((f"{pre}.ipa.head_weights", (h,), "head_weights", h))
        lin(f"{pre}.ipa.linear_q", cs, h * ch)
        lin(f"{pre}.ipa.linear_kv", cs, 2 * h * ch)
        lin(f"{pre}.ipa.linear_q_points", cs, h * pq * 3)
        lin(f"{pre}.ipa.linear_kv_points", cs, h * (pq + pv) * 3)
        lin(f"{pre}.ipa.linear_b", cp, h)
        lin(f"{pre}.ipa.linear_out", h * (cp + ch + pv * 4), cs, "final")
        ln(f"{pre}.ipa_layer_norm", cs)
        for j in range(c["numStructureTransitionLayers"]):
            t = f"{pre}.transition.layers.{j}"
            lin(f"{t}.linear_1", cs, cs)
            lin(f"{t}.linear_2", cs, cs)
            lin(f"{t}.linear_3", cs, cs, "final")
        ln(f"{pre}.transition.layer_norm", cs)
        lin(f"{pre}.bb_update.linear", cs, 6)
    return spec


# ------------------------------------------------------------------ #
# Geometry
# ------------------------------------------------------------------ #


def frenet_frames(coords: torch.Tensor, chain_index: torch.Tensor, mask: torch.Tensor,
                  eps: float = 1e-10) -> torch.Tensor:
    """[B, N, 3] C-alpha traces -> [B, N, 3, 3] rotations with columns
    (tangent, binormal, normal) of residues (j-1, j, j+1); a chain's first
    residue takes its successor's frame, its last its predecessor's, and
    positions past the residue count are the identity."""
    B, N = mask.shape
    d = coords[:, 1:] - coords[:, :-1]
    t = d / torch.sqrt(eps + (d * d).sum(-1, keepdim=True))
    t0, t1 = t[:, :-1], t[:, 1:]
    b = torch.linalg.cross(t0, t1, dim=-1)
    b = b / torch.sqrt(eps + (b * b).sum(-1, keepdim=True))
    n = torch.linalg.cross(b, t1, dim=-1)
    rots = F.pad(torch.stack([t1, b, n], dim=-1), (0, 0, 0, 0, 1, 1))
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device)
    length = mask.to(torch.int64).sum(-1)
    pos = torch.arange(N, device=coords.device)[None, :]
    in_range = pos < length[:, None]
    interior = (pos >= 1) & (pos <= length[:, None] - 2)
    no = torch.zeros((B, 1), dtype=torch.bool, device=coords.device)
    same_as_prev = torch.cat([no, chain_index[:, 1:] == chain_index[:, :-1]], dim=1)
    same_as_next = torch.cat([chain_index[:, :-1] == chain_index[:, 1:], no], dim=1)
    is_start = in_range & (~same_as_prev | (pos == 0))
    is_end = in_range & (~same_as_next | (pos == length[:, None] - 1))

    def where(cond, a, b):
        return torch.where(cond[..., None, None], a, b)

    c0 = where(interior, rots, eye)
    c1 = where(is_start, torch.cat([c0[:, 1:], c0[:, -1:]], dim=1), c0)
    c2 = where(is_end, torch.cat([c1[:, :1], c1[:, :-1]], dim=1), c1)
    return where(in_range, c2, eye)


def k_matrix(rot: torch.Tensor) -> torch.Tensor:
    """The Davenport K-matrix / 3 of rotations [.., 3, 3] -> [.., 4, 4]."""
    xx, xy, xz = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    yx, yy, yz = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    zx, zy, zz = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    k = torch.stack([
        torch.stack([xx + yy + zz, zy - yz, xz - zx, yx - xy], dim=-1),
        torch.stack([zy - yz, xx - yy - zz, xy + yx, xz + zx], dim=-1),
        torch.stack([xz - zx, xy + yx, yy - xx - zz, yz + zy], dim=-1),
        torch.stack([yx - xy, xz + zx, yz + zy, zz - xx - yy], dim=-1),
    ], dim=-2)
    return k / 3.0


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (w, x, y, z) [.., 4]: the eigenvector of K's largest
    eigenvalue, solved in batches of EIGH_BATCH matrices. No gradient flows
    through it: the frames are built from noised inputs."""
    k = k_matrix(rot.detach().float()).reshape(-1, 4, 4)
    v = torch.cat([torch.linalg.eigh(chunk)[1][..., -1] for chunk in k.split(EIGH_BATCH)])
    return v.reshape(*rot.shape[:-2], 4)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    a, b, c, d = q.unbind(-1)
    return torch.stack([
        torch.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)], -1),
        torch.stack([2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)], -1),
        torch.stack([2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d], -1),
    ], -2)


def rot_vec(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (r * v[..., None, :]).sum(-1)


def sinusoid(v: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """[*] -> [*, d]: channel i, with k = i + 1, holds cos(v pi / n^(2(k-1)/d))
    where i is even and sin(v pi / n^(2k/d)) where i is odd."""
    k = torch.arange(1, d + 1, dtype=torch.float32, device=v.device)
    v = v.float()[..., None]
    even = torch.arange(d, device=v.device) % 2 == 0
    return torch.where(even, torch.cos(v * math.pi / n ** (2 * (k - 1) / d)), torch.sin(v * math.pi / n ** (2 * k / d)))


# ------------------------------------------------------------------ #
# Dropout
# ------------------------------------------------------------------ #


def dropout_masks(dropout_seed: Optional[int], config: Dict):
    """The seeds of one forward pass's dropout generators: one a pair layer,
    then one a structure layer application, drawn by a CPU generator of
    `dropout_seed` as integers below 2^62; None without dropout."""
    if dropout_seed is None:
        return None, None
    c = sizes(config)
    n_pair, n_struct = c["numPairTransformLayers"], c["numStructureLayers"] * c["numStructureBlocks"]
    seeds = torch.randint(0, 2**62, (n_pair + n_struct,), generator=torch.Generator().manual_seed(int(dropout_seed)))
    seeds = seeds.tolist()
    return seeds[:n_pair], seeds[n_pair:]


def drop(x: torch.Tensor, rate: float, gen: Optional[torch.Generator], shared_axis: Optional[int] = None):
    """Keep each entry with probability 1 - rate, scaled by 1 / (1 - rate);
    one mask shared along `shared_axis`, drawn as uniforms below 1 - rate."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if shared_axis is not None:
        shape[shared_axis] = 1
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def layer_gen(seeds, i, device):
    return None if seeds is None else torch.Generator(device=device).manual_seed(int(seeds[i]))


# ------------------------------------------------------------------ #
# The denoiser
# ------------------------------------------------------------------ #


def linear(w: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, w[f"{name}.weight"], w.get(f"{name}.bias"))


def layer_norm(w: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def single_features(w, c, t, feats):
    n = feats["residue_mask"].shape[1]
    fixed_seq = feats["fixed_sequence_mask"].float()
    x = torch.cat([
        sinusoid(feats["residue_index"], c["maximumNumResidues"], c["positionalEmbeddingDimension"]),
        sinusoid(feats["chain_index"], c["maximumNumChains"], c["chainEmbeddingDimension"]),
        sinusoid(t[:, None].expand(-1, n), c["numTimesteps"], c["timestepEmbeddingDimension"]),
        feats["aatype"].float() * fixed_seq[..., None], fixed_seq[..., None], fixed_seq[..., None],
        feats["interface_mask"].float()[..., None],
    ], dim=-1)
    return linear(w, "single_feature_net.linear", x) * feats["residue_mask"].float()[..., None]


def distance_bins(c, x, mask):
    """softmax(-4 |d_ij - v|) over the bins v, zero off the mask's pairs."""
    d = torch.sqrt(1e-10 + ((x[:, :, None] - x[:, None, :]) ** 2).sum(-1))
    v = c["templateDistanceMinimum"] + c["templateDistanceStep"] * torch.arange(
        c["templateDistanceNumBins"], dtype=d.dtype, device=d.device)
    bins = torch.softmax(-4.0 * (d[..., None] - v).abs(), dim=-1)
    return bins * (mask[:, :, None] * mask[:, None, :])[..., None]


def pair_features(w, c, s, rots, trans, feats):
    res = feats["residue_mask"].float()
    pair_mask = res[:, :, None] * res[:, None, :]
    fs = feats["fixed_structure_mask"].float()[..., None]
    p = (linear(w, "pair_feature_net.linear_s_p_i", s)[:, :, None]
         + linear(w, "pair_feature_net.linear_s_p_j", s)[:, None])
    # The orientation of pair (i, j) is R_j R_i.
    q = rot_to_quat(torch.matmul(rots[:, None, :, :, :], rots[:, :, None, :, :])) * pair_mask[..., None]
    p = p + linear(w, "pair_feature_net.linear_template", torch.cat([distance_bins(c, trans, res), q, fs, fs], -1))
    k = c["relativePositionK"]
    ri, ci = feats["residue_index"].long(), feats["chain_index"]
    same = ci[:, :, None] == ci[:, None, :]
    offset = ri[:, :, None] - ri[:, None, :]
    d = torch.where(same, torch.clamp(offset + k, 0, 2 * k), torch.full_like(offset, 2 * k + 1))
    relpos = torch.cat([F.one_hot(d, 2 * k + 2).float(), same[..., None].float()], -1)
    p = p + linear(w, "pair_feature_net.linear_relpos", relpos)
    motif = distance_bins(c, feats["atom_positions"].float(), feats["fixed_sequence_mask"].float()) * fs
    p = p + linear(w, "pair_feature_net.linear_motif_template", torch.cat([motif, fs, fs], -1))
    return p * pair_mask[..., None]


def tri_mul(w, m, z, pair_mask, outgoing):
    """AF2 Algorithms 11 (outgoing) and 12 (incoming)."""
    zn = layer_norm(w, f"{m}.layer_norm_in", z)
    a = torch.sigmoid(linear(w, f"{m}.linear_a_g", zn)) * linear(w, f"{m}.linear_a_p", zn) * pair_mask[..., None]
    b = torch.sigmoid(linear(w, f"{m}.linear_b_g", zn)) * linear(w, f"{m}.linear_b_p", zn) * pair_mask[..., None]
    x = torch.einsum("bikc,bjkc->bijc", a, b) if outgoing else torch.einsum("bkic,bkjc->bijc", a, b)
    out = linear(w, f"{m}.linear_z", layer_norm(w, f"{m}.layer_norm_out", x))
    return torch.sigmoid(linear(w, f"{m}.linear_g", zn)) * out


def tri_att(w, c, m, z, pair_mask, starting):
    """AF2 Algorithms 13 (starting node) and 14 (ending node)."""
    if not starting:
        z, pair_mask = z.transpose(1, 2), pair_mask.transpose(1, 2)
    x = layer_norm(w, f"{m}.layer_norm", z)
    H, ch = c["triangularAttentionNumHeads"], c["triangularAttentionHiddenDimension"]
    bias = linear(w, f"{m}.linear", x).permute(0, 3, 1, 2)  # [B, H, J, K]
    q, k, v = (linear(w, f"{m}.mha.linear_{n}", x).unflatten(-1, (H, ch)) for n in "qkv")
    a = torch.einsum("bijhc,bikhc->bihjk", q, k) / math.sqrt(ch) + bias[:, None]
    a = a + 1e9 * (pair_mask[:, :, None, None, :] - 1.0)
    o = torch.einsum("bihjk,bikhc->bijhc", torch.softmax(a, -1), v)
    o = o * torch.sigmoid(linear(w, f"{m}.mha.linear_g", x)).unflatten(-1, (H, ch))
    o = linear(w, f"{m}.mha.linear_o", o.flatten(-2))
    return o if starting else o.transpose(1, 2)


def pair_stack(w, c, p, res_mask, seeds):
    pair_mask = res_mask[:, :, None] * res_mask[:, None, :]
    rate = c["triangularDropout"]
    for i in range(c["numPairTransformLayers"]):
        pre = f"pair_transform_net.net.{i}"
        gen = layer_gen(seeds, i, p.device)
        if c["includeTriangularMultiplicativeUpdate"]:
            p = p + drop(tri_mul(w, f"{pre}.tri_mul_out", p, pair_mask, True), rate, gen, 1)
            p = p + drop(tri_mul(w, f"{pre}.tri_mul_in", p, pair_mask, False), rate, gen, 1)
        if c["includeTriangularAttention"]:
            p = p + drop(tri_att(w, c, f"{pre}.tri_att_start", p, pair_mask, True), rate, gen, 1)
            p = p + drop(tri_att(w, c, f"{pre}.tri_att_end", p, pair_mask, False), rate, gen, 2)
        t = f"{pre}.pair_transition"
        u = linear(w, f"{t}.linear_2", torch.relu(linear(w, f"{t}.linear_1", layer_norm(w, f"{t}.layer_norm", p))))
        p = (p + u * pair_mask[..., None]) * pair_mask[..., None]
    return p


def ipa(w, c, m, s, p, rots, trans, res_mask):
    """AF2 Algorithm 22, with Genie 2's output head over o, the points, their
    norms and the pair values."""
    B, N = s.shape[:2]
    H, ch, pq, pv = c["ipaNumHeads"], c["ipaHiddenDimension"], c["ipaNumQkPoints"], c["ipaNumVPoints"]
    q = linear(w, f"{m}.linear_q", s).view(B, N, H, ch)
    k, v = linear(w, f"{m}.linear_kv", s).view(B, N, H, 2 * ch).split(ch, -1)

    def points(name, n):  # local points, laid out as thirds (x, y, z), to the global frame
        local = torch.stack(linear(w, f"{m}.{name}", s).chunk(3, -1), -1)  # [B, N, H n, 3]
        return (rot_vec(rots[:, :, None], local) + trans[:, :, None]).view(B, N, H, n, 3)

    q_pts = points("linear_q_points", pq)
    k_pts, v_pts = points("linear_kv_points", pq + pv).split([pq, pv], -2)
    gamma = F.softplus(w[f"{m}.head_weights"]) * math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
    a = torch.einsum("bihc,bjhc->bhij", q, k) * math.sqrt(1.0 / (3 * ch))
    a = a + math.sqrt(1.0 / 3) * linear(w, f"{m}.linear_b", p).permute(0, 3, 1, 2)
    d2 = ((q_pts[:, :, None] - k_pts[:, None]) ** 2).sum((-1, -2))  # [B, I, J, H]
    a = a - 0.5 * gamma[None, :, None, None] * d2.permute(0, 3, 1, 2)
    a = a + 1e5 * ((res_mask[:, :, None] * res_mask[:, None, :])[:, None] - 1.0)
    a = torch.softmax(a, -1)
    o = torch.einsum("bhij,bjhc->bihc", a, v).reshape(B, N, H * ch)
    o_pt = torch.einsum("bhij,bjhpx->bihpx", a, v_pts)
    o_pt = rot_vec(rots.transpose(-1, -2)[:, :, None, None], o_pt - trans[:, :, None, None])  # to the local frame
    o_pt_norm = torch.sqrt((o_pt ** 2).sum(-1) + 1e-8).reshape(B, N, H * pv)
    o_pt = o_pt.reshape(B, N, H * pv, 3)
    o_pair = torch.einsum("bhij,bijc->bihc", a, p).reshape(B, N, H * p.shape[-1])
    return linear(w, f"{m}.linear_out", torch.cat([o, o_pt[..., 0], o_pt[..., 1], o_pt[..., 2], o_pt_norm, o_pair], -1))


def structure_net(w, c, s, p, rots, trans, res_mask, seeds):
    n_layer = c["numStructureLayers"]
    for blk in range(c["numStructureBlocks"]):
        for i in range(n_layer):
            m = f"structure_net.net.{i}"
            gen = layer_gen(seeds, blk * n_layer + i, s.device)
            s = layer_norm(w, f"{m}.ipa_layer_norm", drop(s + ipa(w, c, f"{m}.ipa", s, p, rots, trans, res_mask),
                                                          c["ipaDropout"], gen))
            for j in range(c["numStructureTransitionLayers"]):
                t = f"{m}.transition.layers.{j}"
                u = torch.relu(linear(w, f"{t}.linear_2", torch.relu(linear(w, f"{t}.linear_1", s))))
                s = linear(w, f"{t}.linear_3", u) + s
            s = layer_norm(w, f"{m}.transition.layer_norm", drop(s, c["structureTransitionDropout"], gen))
            upd = linear(w, f"{m}.bb_update.linear", s)
            quat = torch.cat([torch.ones_like(upd[..., :1]), upd[..., :3]], -1)
            quat = quat / torch.sqrt((upd[..., :3] ** 2).sum(-1, keepdim=True) + 1.0)
            r = quat_to_rot(quat)
            trans = rot_vec(rots, upd[..., 3:]) + trans
            rots = (rots[..., :, :, None] * r[..., None, :, :]).sum(-2)
    return rots, trans


def denoise(w: Dict, config: Dict, rots: torch.Tensor, trans: torch.Tensor, t: torch.Tensor, feats: Dict,
            dropout_seed: Optional[int] = None) -> torch.Tensor:
    """The predicted noise z [B, N, 3] of noisy frames (rots, trans) at steps
    t [B]; dropout where `dropout_seed` is given."""
    c = sizes(config)
    pair_seeds, struct_seeds = dropout_masks(dropout_seed, config)
    res_mask = feats["residue_mask"].float()
    x = trans * c["rescale"]
    s = single_features(w, c, t, feats)
    p = pair_features(w, c, s, rots, x, feats)
    p = pair_stack(w, c, p, res_mask, pair_seeds)
    _, x_out = structure_net(w, c, s, p, rots, x, res_mask, struct_seeds)
    return trans - x_out / c["rescale"]


# ------------------------------------------------------------------ #
# Diffusion, loss, optimizer
# ------------------------------------------------------------------ #


def cosine_schedule(n_timestep: int, device) -> Dict[str, torch.Tensor]:
    """Nichol-Dhariwal cosine betas (clipped at 0.999, beta_0 = 0) and the
    tables of the posterior, derived in float32 numpy order."""
    import numpy as np

    x = np.linspace(0, n_timestep, n_timestep + 1, dtype=np.float32)
    abar = np.cos((x / np.float32(n_timestep + 1)) * np.float32(math.pi * 0.5)) ** 2
    abar = abar / abar[0]
    betas = np.concatenate([np.zeros(1, np.float32), np.clip(np.float32(1) - abar[1:] / abar[:-1], 0, 0.999)])
    betas = betas.astype(np.float32)
    alphas = np.float32(1.0) - betas
    abar = np.cumprod(alphas, dtype=np.float32)
    tab = {"betas": betas, "alphas": alphas, "sqrt_alphas": np.sqrt(alphas), "sqrt_betas": np.sqrt(betas),
           "sqrt_abar": np.sqrt(abar), "sqrt_one_minus_abar": np.sqrt(np.float32(1.0) - abar)}
    return {k: torch.as_tensor(v.astype(np.float32), device=device) for k, v in tab.items()}


def reverse_step(sched, z: torch.Tensor, x: torch.Tensor, t: int, noise: torch.Tensor, scale: float, mask):
    """x_{t-1} = (x_t - (1 - a_t) / sqrt(1 - abar_t) z) / sqrt(a_t) + scale sqrt(beta_t) noise, masked;
    no noise at t = 1."""
    m = mask.float()[..., None]
    w_z = (1.0 - sched["alphas"][t]) / sched["sqrt_one_minus_abar"][t]
    mean = (1.0 / sched["sqrt_alphas"][t]) * (x - w_z * z) * m
    return mean + scale * sched["sqrt_betas"][t] * noise * m if t > 1 else mean


def noised(sched, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor, mask: torch.Tensor):
    """(masked noise z, x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) z) for steps t [B]."""
    z = noise * mask.float()[..., None]
    return z, sched["sqrt_abar"][t][:, None, None] * x0 + sched["sqrt_one_minus_abar"][t][:, None, None] * z


def loss(z_pred: torch.Tensor, z: torch.Tensor, feats: Dict, condition_weight: float) -> torch.Tensor:
    """Genie 2's training loss: per structure, the motif-weighted mean over
    its residues of |z_pred - z| (the norm, not its square); the batch mean."""
    res = feats["residue_mask"].float()
    fixed = feats["fixed_sequence_mask"].float()
    err = torch.sqrt(1e-10 + ((z_pred - z) ** 2).sum(-1))
    cond, infill = (err * res * fixed).sum(-1), (err * res * (1 - fixed)).sum(-1)
    n_cond, n_infill = (res * fixed).sum(-1), (res * (1 - fixed)).sum(-1)
    return ((condition_weight * cond + infill) / (condition_weight * n_cond + n_infill)).mean()


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            p.addcdiv_(self.m[k], self.v[k].sqrt() / math.sqrt(c2) + 1e-8, value=-self.lr / c1)
