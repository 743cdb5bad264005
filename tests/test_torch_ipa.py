"""genie2_tpu_torch's IPA attention core against genie2_tpu.

`ipa_attention_plain` (the kernel's plain version, which CPU tensors take)
is held against the Pallas kernel of ops/ipa_fused.py run through the
interpreter and against its jnp reference, on the inputs of
tests/test_ipa_fused.py; the port's InvariantPointAttention, which now
runs through `ipa_attention`, against the flax module. The attention core
masks the key side only, so comparisons with the reference and with the
flax module are on real rows.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.nn.structure import InvariantPointAttention as FlaxIPA
from genie2_tpu.ops.ipa_fused import _reference_attention, fused_ipa_attention
from genie2_tpu_torch.geometry import Rigid
from genie2_tpu_torch.nn.structure import InvariantPointAttention
from genie2_tpu_torch.ops import ipa
from genie2_tpu_torch.utils import profiling
from genie2_tpu_torch.utils.weights import params_from_flax

H, C, PQ, PV, CZ = 4, 8, 4, 8, 16
N = 64
# fp32: the two sides sum in another order (online softmax over tiles
# against one pass); the tolerance of tests/test_ipa_fused.py.
TOL = 2e-5


def make_inputs(n=N, seed=0, masked_tail=0):
    """The arrays of tests/test_ipa_fused.py:make_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q, k, v = f(n, H, C), f(n, H, C), f(n, H, C)
    q_pts, k_pts = f(n, H, PQ, 3) * 3, f(n, H, PQ, 3) * 3
    v_pts = f(n, H, PV, 3) * 3
    z = f(n, n, CZ)
    wb, bb = f(CZ, H) * 0.3, f(H) * 0.1
    hw = np.abs(f(H)) + 0.5
    mask = np.ones(n, np.float32)
    if masked_tail:
        mask[-masked_tail:] = 0.0
    return q, k, v, q_pts, k_pts, v_pts, z, wb, bb, hw, mask


def run_plain(args, dtype=torch.float32):
    """One sample through the batched plain version; the pair bias is
    computed outside, as the port's module does."""
    q, k, v, q_pts, k_pts, v_pts, z, wb, bb, hw, mask = (torch.tensor(a) for a in args)
    c = lambda t: t.to(dtype)[None]
    bias = (c(z) @ wb.to(dtype) + bb.to(dtype))
    out = ipa.ipa_attention(c(q), c(k), c(v), c(q_pts), c(k_pts), c(v_pts), bias, c(z), hw, mask[None])
    return [o[0].float().numpy() for o in out]


@pytest.mark.parametrize("masked_tail", [0, 16])
def test_plain_matches_pallas_and_reference(masked_tail):
    args = make_inputs(masked_tail=masked_tail)
    jargs = tuple(jnp.asarray(a) for a in args)
    got = run_plain(args)
    kernel = fused_ipa_attention(*jargs, tile_i=32, tile_j=32, interpret=True)
    reference = _reference_attention(*jargs)
    real = slice(0, N - masked_tail)
    for g, kern, ref, name in zip(got, kernel, reference, ("o", "o_pt", "o_pair")):
        # The plain version follows the kernel on every row, padded ones too.
        np.testing.assert_allclose(g, np.asarray(kern), atol=TOL, rtol=TOL, err_msg=name)
        np.testing.assert_allclose(g[real], np.asarray(ref)[real], atol=TOL, rtol=TOL, err_msg=name)
    assert np.abs(got[2]).max() > 1e-2  # not vacuous


def test_batched_equals_loop_over_samples():
    samples = [make_inputs(seed=s, masked_tail=t) for s, t in ((1, 0), (2, 16))]
    hw = samples[0][9]
    stack = lambda i: torch.tensor(np.stack([s[i] for s in samples]))
    bias = torch.stack([torch.tensor(s[6]) @ torch.tensor(s[7]) + torch.tensor(s[8]) for s in samples])
    batched = ipa.ipa_attention_plain(
        stack(0), stack(1), stack(2), stack(3), stack(4), stack(5), bias, stack(6), torch.tensor(hw), stack(10)
    )
    for b, s in enumerate(samples):
        single = run_plain((*s[:9], hw, s[10]))
        for got, want in zip(batched, single):
            np.testing.assert_allclose(got[b].numpy(), want, atol=1e-6, rtol=1e-6)


def test_bf16_plain_matches_pallas_bf16():
    """bfloat16 inputs, float32 sums, probabilities rounded before p.z on
    both sides; within 3e-2 of max |kernel| (one bf16 ulp is 2^-8, and the
    two sides round the exponentials against another running max)."""
    args = make_inputs(masked_tail=16)
    got = run_plain(args, torch.bfloat16)
    jargs = tuple(jnp.asarray(a, jnp.bfloat16) for a in args[:9]) + (jnp.asarray(args[9]), jnp.asarray(args[10]))
    kernel = fused_ipa_attention(*jargs, tile_i=32, tile_j=32, interpret=True)
    for g, kern, name in zip(got, kernel, ("o", "o_pt", "o_pair")):
        want = np.asarray(kern.astype(jnp.float32))
        assert np.abs(g - want).max() <= 3e-2 * np.abs(want).max(), name


@pytest.mark.parametrize("masked_tail", [0, 7])
def test_module_matches_flax(masked_tail):
    """The port's module through `ipa_attention` against the flax module,
    weights carried by params_from_flax; real rows, 3e-5 as
    tests/test_ipa_fused.py holds its own wrapper to."""
    n, c_s, batch = 24, 16, 2
    rng = np.random.default_rng(3)
    s = rng.normal(size=(batch, n, c_s)).astype(np.float32)
    z = rng.normal(size=(batch, n, n, CZ)).astype(np.float32)
    trans = rng.normal(size=(batch, n, 3)).astype(np.float32) * 5
    rots = np.linalg.qr(rng.normal(size=(batch, n, 3, 3)))[0].astype(np.float32)
    mask = np.ones((batch, n), np.int32)
    if masked_tail:
        mask[1, -masked_tail:] = 0

    flax_ipa = FlaxIPA(c_s=c_s, c_z=CZ, c_hidden=C, no_heads=H, no_qk_points=PQ, no_v_points=PV)
    jt = JRigid(jnp.asarray(rots), jnp.asarray(trans))
    params = flax_ipa.init(jax.random.PRNGKey(0), jnp.asarray(s), jnp.asarray(z), jt, jnp.asarray(mask))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    # linear_out starts at zero: randomise every leaf so the output is not vacuous.
    params = jax.tree_util.tree_unflatten(
        treedef, [0.3 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    )
    want = np.asarray(flax_ipa.apply(params, jnp.asarray(s), jnp.asarray(z), jt, jnp.asarray(mask)))

    mod = InvariantPointAttention(c_s, CZ, C, H, PQ, PV)
    mod.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = mod(torch.tensor(s), torch.tensor(z), Rigid(torch.tensor(rots), torch.tensor(trans)),
                  torch.tensor(mask)).numpy()
    real = mask.astype(bool)
    assert np.abs(want[real]).max() > 1e-2
    np.testing.assert_allclose(got[real], want[real], atol=3e-5, rtol=3e-5)


def test_wrapper_counts_nothing_on_cpu_and_refuses_other_devices():
    args = make_inputs(n=16)
    profiling.reset()
    run_plain(args)
    assert profiling.counters()["launch.ipa_attention"] == 0
    meta = lambda *s: torch.zeros(*s, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ipa.ipa_attention(meta(1, 4, H, C), meta(1, 4, H, C), meta(1, 4, H, C), meta(1, 4, H, PQ, 3),
                          meta(1, 4, H, PQ, 3), meta(1, 4, H, PV, 3), meta(1, 4, 4, H), meta(1, 4, 4, CZ),
                          meta(H), meta(1, 4))


def test_rows_per_block_keeps_items_in_bounds():
    for c_z in (1, 24, 128, 256, 257, 480, 960):
        ti = ipa.rows_per_block(c_z)
        assert 1 <= ti <= 4 and ti * c_z <= 960 and ti * -(-c_z // 8) <= 120
    # The main path's widths take 4 rows a block in float32 and bf16;
    # shared memory bounds the rows where the key rows are wide.
    for esize in (4, 2):
        lay = ipa.kernel_layout(12, 16, 4, 8, 128, 256, esize)
        assert ipa.rows_per_block(128, lay) == 4 and ipa.smem_bytes(lay, 4) <= 232448
    wide = ipa.kernel_layout(16, 16, 8, 8, 128, 256, 4)
    ti = ipa.rows_per_block(128, wide)
    assert ti < 4 and ipa.smem_bytes(wide, ti) <= 232448 < ipa.smem_bytes(wide, 2 * ti)


# --------------------------------------------------------------------- #
# csrc/ipa_attention.cu's index algebra, emulated on the CPU
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("h,c,pq,pv,cz", [(12, 16, 4, 8, 128), (5, 8, 3, 5, 24), (16, 8, 2, 4, 300), (3, 5, 1, 1, 7)])
def test_kernel_layout_aligns_runs_and_spreads_banks(esize, h, c, pq, pv, cz):
    """The slot layout's runs start on 16 bytes (the cp.async
    destinations), the padded widths hold their runs, and key rows are an
    odd number of 16-byte chunks apart, so the eight lanes of a
    quarter-warp that read one chunk of eight consecutive keys hit eight
    distinct bank groups; query rows hold q and its points on 16 bytes."""
    lay = ipa.kernel_layout(h, c, pq, pv, cz, 64, esize)
    v16 = 16 // esize
    assert lay["CP"] >= c and lay["QP"] >= 3 * pq and lay["VP"] >= 3 * pv
    for off in (0, lay["CP"], lay["CP"] + lay["QP"], 2 * lay["CP"] + lay["QP"], lay["KVS"]):
        assert off % v16 == 0, off
    assert lay["KVS"] >= 2 * lay["CP"] + lay["QP"] + lay["VP"] and (lay["KVS"] // v16) % 2 == 1
    assert len({(r * lay["KVS"] // v16) % 8 for r in range(8)}) == 8
    assert lay["CQ"] >= c and lay["CQ"] % 4 == 0 and lay["QS"] >= lay["CQ"] + 3 * pq and lay["QS"] % 4 == 0


def test_bulk_key_block_fits_the_slot_layout():
    """The bulk layout a key (one span of the k / v projection, one of the
    point sets, an odd number of 16-byte chunks in all) fits in the room the
    kernel gives a key (the slot layout's and 16 bytes), at the main path's
    widths in both dtypes."""
    for esize in (4, 2):
        lay = ipa.kernel_layout(12, 16, 4, 8, 128, 256, esize)
        spans = 12 * 2 * 16 * esize + 12 * 3 * (4 + 8) * esize
        js = spans + 16 if (spans // 16) % 2 == 0 else spans
        assert spans % 16 == 0 and (js // 16) % 2 == 1 and js <= 12 * lay["KVS"] * esize + 16


def _strided_inputs(n=N, seed=0, masked_tail=0, dtype=torch.float32):
    """The inputs as nn/structure.py hands them over: k and v the halves of
    one [.., H, 2C] projection, k and v points the parts of one [.., H,
    Pq + Pv, 3] tensor, a batch of two samples."""
    q, k, v, q_pts, k_pts, v_pts, z, wb, bb, hw, mask = make_inputs(n, seed, masked_tail)
    t = lambda a: torch.tensor(a).to(dtype)
    kv = torch.cat([t(k), t(v)], -1)[None].repeat(2, 1, 1, 1)
    kv_pts = torch.cat([t(k_pts), t(v_pts)], -2)[None].repeat(2, 1, 1, 1, 1)
    zz = t(z)[None].repeat(2, 1, 1, 1)
    bias = zz @ t(wb) + t(bb)
    m = torch.tensor(mask)[None].repeat(2, 1)
    m[0] = 1.0
    return (t(q)[None].repeat(2, 1, 1, 1), kv[..., :C], kv[..., C:], t(q_pts)[None].repeat(2, 1, 1, 1, 1),
            kv_pts[..., :PQ, :], kv_pts[..., PQ:, :], bias, zz, torch.tensor(hw), m)


def emulate_kernel(q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask, inf=1e5, tj=ipa._TJ):
    """csrc/ipa_attention.cu's algorithm in torch: every tensor read through
    the element strides `kernel_arguments` hands the kernel (the points as
    one run of 3 P values a head), the points scaled by sqrt(w_h s_pt) and
    rounded to the activation dtype as they are read, keys in tiles of TJ
    with the online softmax (running max, rescale, float32 sums), p rounded
    to the activation dtype before it multiplies z."""
    dt = z.dtype
    inputs, st, (B, n, H, c, pq, pv, cz) = ipa.kernel_arguments(
        q, k, v, q_pts, k_pts, v_pts, bias, z, head_weights, mask)
    view = lambda i, shape: torch.as_strided(inputs[i], shape, st[4 * i:4 * i + len(shape)]).float()
    qq, kk, vv = view(0, (B, n, H, c)), view(1, (B, n, H, c)), view(2, (B, n, H, c))
    qp, kp, vp = view(3, (B, n, H, 3 * pq)), view(4, (B, n, H, 3 * pq)), view(5, (B, n, H, 3 * pv))
    bb, zz = view(6, (B, n, n, H)), view(7, (B, n, n, cz))
    mm = torch.as_strided(inputs[9], (B, n), st[32:34]).float()
    f = torch.sqrt(head_weights.float() * ipa.point_scale(pq))[:, None]
    qp, kp = ((x * f).to(dt).float() for x in (qp, kp))
    m = torch.full((B, n, H), -1e30)
    acc = torch.zeros(B, n, H, c + 3 * pv + 1)
    acc_z = torch.zeros(B, n, H, cz)
    vals = torch.cat([vv, vp, torch.ones(B, n, H, 1)], -1)
    for j0 in range(0, n, tj):
        js = slice(j0, min(j0 + tj, n))
        s = (math.sqrt(1.0 / (3 * c)) * torch.einsum("bihc,bjhc->bijh", qq, kk[:, js])
             + math.sqrt(1.0 / 3) * bb[:, :, js]
             - 0.5 * ((qp[:, :, None] - kp[:, None, js]) ** 2).sum(-1)
             + inf * (mm[:, None, js, None] - 1.0))
        m_new = torch.maximum(m, s.amax(2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, :, None])  # [B, i, j, H]
        acc = acc * alpha[..., None] + torch.einsum("bijh,bjhd->bihd", p, vals[:, js])
        acc_z = acc_z * alpha[..., None] + torch.einsum("bijh,bijc->bihc", p.to(dt).float(), zz[:, :, js])
        m = m_new
    l = acc[..., -1:].clamp_min(1e-20)
    o = acc[..., :-1] / l
    return (o[..., :c].to(dt), o[..., c:].unflatten(-1, (pv, 3)).to(dt), (acc_z / l).to(dt))


@pytest.mark.parametrize("masked_tail", [0, 16])
def test_emulated_kernel_matches_plain_and_pallas(masked_tail):
    """The kernel's algorithm on strided inputs: its tiles and online
    softmax against the plain version (both samples, every row) and
    against the Pallas kernel run through the interpreter (the masked
    sample)."""
    args = _strided_inputs(masked_tail=masked_tail)
    assert not args[1].is_contiguous() and not args[4].is_contiguous()
    got = emulate_kernel(*args)
    for g, w, name in zip(got, ipa.ipa_attention_plain(*args), ("o", "o_pt", "o_pair")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL, err_msg=name)
    jargs = tuple(jnp.asarray(a) for a in make_inputs(masked_tail=masked_tail))
    kernel = fused_ipa_attention(*jargs, tile_i=32, tile_j=32, interpret=True)
    for g, kern, name in zip(got, kernel, ("o", "o_pt", "o_pair")):
        np.testing.assert_allclose(g[1].numpy(), np.asarray(kern), atol=TOL, rtol=TOL, err_msg=name)


def test_emulated_kernel_bf16_rounds_like_the_plain_version():
    """bf16 inputs: the points rounded after scaling and p rounded before
    p.z, as the plain version does; within 3e-2 of max |plain| (values on a
    rounding boundary against another running max), and p.z holds the
    rounding: without it o_pair moves."""
    args = _strided_inputs(masked_tail=16, dtype=torch.bfloat16)
    got = emulate_kernel(*args)
    for g, w, name in zip(got, ipa.ipa_attention_plain(*args), ("o", "o_pt", "o_pair")):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 3e-2 * w.float().abs().max().item(), name


def test_kernel_arguments_refuse_points_that_are_not_one_run():
    """A point set whose P axis is not 3 coordinates apart (here a transposed
    view) cannot be read as one run a head: the wrapper says so."""
    args = list(_strided_inputs(n=8))
    args[3] = args[3].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="run"):
        ipa.kernel_arguments(*args)
    inputs, strides, dims = ipa.kernel_arguments(*_strided_inputs(n=8))
    assert len(strides) == 34 and dims == (2, 8, H, C, PQ, PV, CZ) and len(inputs) == 10
    # k is the first half of a [.., H, 2C] projection: its head stride is 2C.
    assert strides[4:8] == [8 * H * 2 * C, H * 2 * C, 2 * C, 1]


def test_pair_product_fragments_give_p_dot_z():
    """o_pair on the tensor cores: a unit is one m16n8k8 tile (16 heads x 8
    channels) of one query row, summed over the tile's keys 8 at a time;
    lane (g, t) reads p at [key][PAS] (heads past H zero) and z at
    [key][Cz] as the kernel's pair_product does, in float32 (a: (g, t)
    (g+8, t) (g, t+4) (g+8, t+4); b: (t, g) (t+4, g)) and in bf16 (a: keys
    2t, 2t+1 of heads g, g+8; b: keys 2t, 2t+1); the accumulator layout
    (c0, c1 = head g, channels 2t, 2t+1; c2, c3 = head g + 8) gives p^T . z,
    with channels past Cz zero; the p rows of a fragment's keys lie eight
    banks apart, so a fragment load has no conflict."""
    rng = np.random.default_rng(4)
    pas, tj, h, cz = ipa._PAS, ipa._TJ, 12, 13
    p = np.zeros((tj, pas))
    p[:, :h] = rng.random((tj, h))
    z = rng.normal(size=(tj, cz))
    for c0 in range(0, cz, 8):
        for bf16 in (False, True):
            acc = np.zeros((16, 8))
            for k8 in range(0, tj, 8):
                a = np.zeros((16, 8))
                b = np.zeros((8, 8))
                pk, zk = p[k8:k8 + 8], z[k8:k8 + 8]
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    ok = c0 + g < cz
                    if not bf16:
                        for (m, k) in ((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)):
                            a[m, k] = pk[k, m]
                        for k in (t, t + 4):
                            b[k, g] = zk[k, c0 + g] if ok else 0.0
                    else:
                        for m in (g, g + 8):
                            a[m, 2 * t], a[m, 2 * t + 1] = pk[2 * t, m], pk[2 * t + 1, m]
                        b[2 * t, g], b[2 * t + 1, g] = (zk[2 * t, c0 + g], zk[2 * t + 1, c0 + g]) if ok else (0.0, 0.0)
                acc += a @ b
            want = np.zeros((16, 8))
            cols = min(8, cz - c0)
            want[:h, :cols] = p[:, :h].T @ z[:, c0:c0 + cols]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    m, n = g + 8 * (e >> 1), 2 * t + (e & 1)
                    assert abs(acc[m, n] - want[m, n]) < 1e-12
    banks = {(t * pas + g) % 32 for t in range(4) for g in range(8)}
    assert len(banks) == 32
