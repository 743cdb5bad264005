"""The TriMul plain versions and module of genie2_tpu_torch against genie2_tpu.

The JAX side runs the Pallas kernels of ops/trimul_fused.py through the
interpreter on the CPU, and the flax TriangleMultiplicativeUpdate on its
jnp path. Weights are randomised and non-zero (linear_z starts at zero, so
the default init would make every output vacuous). fp32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.ops.trimul_fused as jfused
from genie2_tpu.nn.pair_stack import TriangleMultiplicativeUpdate as FlaxTriMul
from genie2_tpu_torch.nn.pair_stack import TriangleMultiplicativeUpdate
from genie2_tpu_torch.ops import trimul
from genie2_tpu_torch.utils import profiling
from genie2_tpu_torch.utils.weights import params_from_flax

B, N, C = 2, 128, 32
ATOL = 5e-6


def _randomized_params(module, z, mask):
    params = module.init(jax.random.PRNGKey(1), z, mask)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(42), len(leaves))
    leaves = [0.3 * jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, n, n, C)).astype(np.float32)
    res_mask = (rng.uniform(size=(B, n)) > 0.2).astype(np.float32)
    return z, res_mask


@pytest.fixture(scope="module")
def setup():
    z, res_mask = _inputs(N)
    mask = res_mask[:, :, None] * res_mask[:, None, :]
    params = _randomized_params(FlaxTriMul(c_z=C, c_hidden=C), jnp.asarray(z), jnp.asarray(mask))
    jw = FlaxTriMul(c_z=C, c_hidden=C).apply(params, method=FlaxTriMul._fused_weights)
    jw = {k: np.asarray(v) for k, v in jw.items()}
    # JAX kernels are [in, out]; the port takes torch's [out, in].
    tw = {k: torch.tensor(v.T if k.startswith("w_") else v) for k, v in jw.items()}
    return z, res_mask, jw, tw, params


def test_project_plain_matches_pallas(setup):
    z, res_mask, jw, tw, _ = setup
    ja, jb = jfused.project_gated_cm(jnp.asarray(z), jnp.asarray(res_mask), jw, interpret=True)
    ta, tb = trimul.project_gated_cm_plain(torch.tensor(z), torch.tensor(res_mask), tw)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL)


@pytest.mark.parametrize("outgoing", [True, False])
def test_contract_plain_matches_pallas(setup, outgoing):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(B, C, N, N)).astype(np.float32) * 0.2
    b = rng.normal(size=(B, C, N, N)).astype(np.float32) * 0.2
    want = np.asarray(jfused.contract_cm_fullk(jnp.asarray(a), jnp.asarray(b), outgoing=outgoing, interpret=True))
    got = trimul.contract_cm_plain(torch.tensor(a), torch.tensor(b), outgoing).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_epilogue_plain_matches_pallas(setup):
    z, _, jw, tw, _ = setup
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, C, N, N)).astype(np.float32)
    want = np.asarray(jfused.epilogue_cm(jnp.asarray(x), jnp.asarray(z), jw, interpret=True))
    got = trimul.epilogue_cm_plain(torch.tensor(x), torch.tensor(z), tw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("outgoing", [True, False])
def test_pipeline_matches_trimul_fused(setup, outgoing):
    z, res_mask, jw, tw, _ = setup
    want = np.asarray(jfused.trimul_fused(jnp.asarray(z), jnp.asarray(res_mask), jw, outgoing=outgoing, interpret=True))
    got = trimul.trimul(torch.tensor(z), torch.tensor(res_mask), tw, outgoing).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n", [96, 128])
@pytest.mark.parametrize("outgoing", [True, False])
def test_module_matches_flax(n, outgoing):
    """The port's module (plain path on the CPU) against the flax module's
    jnp path, at a length the JAX kernels' N % 128 gate would refuse too."""
    z, res_mask = _inputs(n, seed=n)
    mask = res_mask[:, :, None] * res_mask[:, None, :]
    flax_mod = FlaxTriMul(c_z=C, c_hidden=C, outgoing=outgoing)
    params = _randomized_params(flax_mod, jnp.asarray(z), jnp.asarray(mask))
    want = np.asarray(flax_mod.apply(params, jnp.asarray(z), jnp.asarray(mask)))

    mod = TriangleMultiplicativeUpdate(C, C, outgoing=outgoing)
    mod.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = mod(torch.tensor(z), torch.tensor(res_mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_wrappers_count_nothing_on_cpu(setup):
    z, res_mask, _, tw, _ = setup
    profiling.reset()
    trimul.trimul(torch.tensor(z[:, :32, :32]), torch.tensor(res_mask[:, :32]), tw, True)
    assert all(v == 0 for k, v in profiling.counters().items() if k.startswith("launch."))


def test_wrappers_refuse_other_devices(setup):
    _, _, _, tw, _ = setup
    z = torch.zeros(1, 4, 4, C, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        trimul.project_gated_cm(z, torch.zeros(1, 4, device="meta"), tw)


# --------------------------------------------------------------------- #
# The float32 arithmetic of the tensor-core kernels: three TF32 products
# --------------------------------------------------------------------- #


def _tf32_nearest(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
    one TF32 product's operand."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x):
    """x with its low 13 mantissa bits cleared, as the tensor cores read a
    TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """csrc/tensor_core.cuh split_tf32: hi = x cut to TF32, lo = the exact
    rest x - hi, cut to TF32 by the tensor cores."""
    hi = _tf32_cut(x)
    return hi, _tf32_cut(x - hi)


def _three_products(product, a, b):
    """a.b as the kernels take it in float32: the small terms first, then
    hi.hi, all summed in float32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return product(al, bh) + product(ah, bl) + product(ah, bh)


def _errors(product, a, b):
    """Largest error of three TF32 products and of one, relative to the
    largest |a.b|, against the float64 product."""
    want = product(a.double(), b.double())
    scale = want.abs().max().item()
    three = (_three_products(product, a, b).double() - want).abs().max().item() / scale
    one = (product(_tf32_nearest(a), _tf32_nearest(b)).double() - want).abs().max().item() / scale
    return three, one


@pytest.mark.parametrize("outgoing", [True, False])
def test_contraction_needs_three_tf32_products(outgoing):
    """trimul_contract.cu's float32 arithmetic at the main path's length
    (K = N = 256): three TF32 products stay within 1e-5 of max |x| of the
    float64 product, inside the kernels' 1e-4 float32 tolerance; one TF32
    product does not."""
    rng = np.random.default_rng(11)
    a, b = (torch.tensor(rng.normal(size=(1, 4, 256, 256)).astype(np.float32)) for _ in range(2))
    three, one = _errors(lambda p, q: trimul.contract_cm_plain(p, q, outgoing), a, b)
    assert three <= 1e-5 < 1e-4 < one, (three, one)


def test_epilogue_product_needs_three_tf32_products():
    """trimul_epilogue.cu's main product, x . ws over H = 128 with LN_out
    folded into ws (fold_ln_out): the same holds."""
    rng = np.random.default_rng(12)
    H = 128
    x = torch.tensor(rng.normal(size=(2, H, 48, 48)).astype(np.float32))
    w = {
        "w_z": torch.tensor(rng.normal(size=(H, H)).astype(np.float32) * H ** -0.5),
        "ln_out_scale": torch.tensor(1.0 + 0.1 * rng.normal(size=H).astype(np.float32)),
        "ln_out_bias": torch.zeros(H), "b_z": torch.zeros(H),
    }
    ws, _, _ = trimul.fold_ln_out(w, torch.float32)
    three, one = _errors(lambda p, q: torch.matmul(p.permute(0, 2, 3, 1), q.t()), x, ws)
    assert three <= 1e-5 < 1e-4 < one, (three, one)


def test_projection_needs_three_tf32_products():
    """trimul_project.cu's float32 arithmetic: the projection and its gate,
    [rows, C] x [C, H] with K = C = 128, gated as the kernel gates them:
    with three TF32 products a stays within 1e-5 of max |a| of the float64
    product, with one it misses the kernels' 1e-4 float32 tolerance."""
    rng = np.random.default_rng(13)
    C = H = 128
    z = torch.tensor(rng.normal(size=(1, 48, 48, C)).astype(np.float32))
    w = {k: torch.tensor((rng.normal(size=(H, C)) * C ** -0.5).astype(np.float32)) for k in ("w_ap", "w_ag")}
    w.update({k: torch.tensor((0.1 * rng.normal(size=H)).astype(np.float32)) for k in ("b_ap", "b_ag")})
    zn = trimul._ln_lane(z, torch.ones(C), torch.zeros(C))

    def gated(product):
        return (product(zn, w["w_ap"].t()) + w["b_ap"]) * torch.sigmoid(product(zn, w["w_ag"].t()) + w["b_ag"])

    want = gated(lambda a, b: a.double() @ b.double())
    scale = want.abs().max().item()
    three = (gated(lambda a, b: _three_products(torch.matmul, a, b)).double() - want).abs().max().item() / scale
    one = (gated(lambda a, b: _tf32_nearest(a) @ _tf32_nearest(b)).double() - want).abs().max().item() / scale
    assert three <= 1e-5 < 1e-4 < one, (three, one)


def _kernel_weight_rows(H, hc):
    """trimul_project.cu weight_row: for each chunk of hc hidden channels, its
    4 hc weight rows as (which, h), which 0-3 = w_ap, w_ag, w_bp, w_bg; an
    m16 tile holds the projections of eight channels in rows 0-7 and their
    gates in rows 8-15, a first, then b."""
    rows = []
    for h0 in range(0, H, hc):
        groups = hc // 8
        for r in range(4 * hc):
            mt, within = divmod(r, 16)
            rows.append((2 * (mt // groups) + within // 8, h0 + 8 * (mt % groups) + within % 8))
    return rows


@pytest.mark.parametrize("H,hc", [(128, 64), (128, 128), (40, 32)])
def test_projection_row_order_gives_the_plain_result(H, hc):
    """The kernel takes W . zn^T with the weight rows reordered so that a
    lane's accumulators c0, c1 (row g) and c2, c3 (row g + 8) are the
    projection and the gate of one (h, j): emulated in torch, that order
    and pairing give project_gated_cm_plain's a and b, every channel once;
    channels past H (H = 40 in chunks of 32) are zero rows, never stored."""
    rng = np.random.default_rng(H + hc)
    Bn, n, C = 2, 12, 32
    z = torch.tensor(rng.normal(size=(Bn, n, n, C)).astype(np.float32))
    res_mask = torch.tensor((rng.uniform(size=(Bn, n)) > 0.2).astype(np.float32))
    w = {f"w_{k}": torch.tensor((rng.normal(size=(H, C)) * C ** -0.5).astype(np.float32)) for k in ("ap", "ag", "bp", "bg")}
    w.update({f"b_{k}": torch.tensor((0.1 * rng.normal(size=H)).astype(np.float32)) for k in ("ap", "ag", "bp", "bg")})
    w.update(ln_in_scale=torch.tensor((1 + 0.1 * rng.normal(size=C)).astype(np.float32)),
             ln_in_bias=torch.tensor((0.1 * rng.normal(size=C)).astype(np.float32)))
    names = ("ap", "ag", "bp", "bg")
    rows = _kernel_weight_rows(H, hc)
    weight = torch.stack([w[f"w_{names[k]}"][h] if h < H else torch.zeros(C) for k, h in rows])
    bias = torch.stack([w[f"b_{names[k]}"][h] if h < H else torch.zeros(()) for k, h in rows])
    zn = trimul._ln_lane(z, w["ln_in_scale"], w["ln_in_bias"]).reshape(-1, C)
    acc = weight @ zn.t() + bias[:, None]  # [channel rows, (b, i, j)]: the accumulators, j along a row
    mask = (res_mask[:, :, None] * res_mask[:, None, :]).reshape(-1)
    out = {0: torch.full((Bn, H, n, n), float("nan")), 1: torch.full((Bn, H, n, n), float("nan"))}
    for m0 in range(0, len(rows), 16):
        for g in range(8):
            (kp, h), (kg, h_gate) = rows[m0 + g], rows[m0 + 8 + g]
            assert kg == kp + 1 and kp % 2 == 0 and h_gate == h
            if h < H:
                assert torch.isnan(out[kp // 2][:, h]).all()  # each channel once
                gated = acc[m0 + g] * torch.sigmoid(acc[m0 + 8 + g]) * mask
                out[kp // 2][:, h] = gated.reshape(Bn, n, n)
    a, b = trimul.project_gated_cm_plain(z, res_mask, w)
    np.testing.assert_allclose(out[0].numpy(), a.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1].numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_projection_backward_fragment_order_gives_dw():
    """trimul_project.cu's backward takes dW = dP . zn over a tile's
    positions with positions 2t and 2t + 1 of each 8 standing for k = t and
    t + 4 of m16n8k8's fragments: lane (g, t) gives A dP of rows g, g + 8 at
    those two positions and B zn of those two positions at channel g.
    Placed lane by lane at the PTX layouts (A: (g, t) (g+8, t) (g, t+4)
    (g+8, t+4); B: (k t, n g) (k t+4, n g)), the products over a tile's k
    steps sum to dP . zn."""
    rng = np.random.default_rng(17)
    TJ = 32
    dp, zn = rng.normal(size=(16, TJ)), rng.normal(size=(TJ, 8))
    out = np.zeros((16, 8))
    for kk in range(TJ // 8):
        a, b = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
        for lane in range(32):
            g, t = divmod(lane, 4)
            p0, p1 = 8 * kk + 2 * t, 8 * kk + 2 * t + 1
            a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = dp[g, p0], dp[g + 8, p0], dp[g, p1], dp[g + 8, p1]
            b[t, g], b[t + 4, g] = zn[p0, g], zn[p1, g]
        assert not np.isnan(a).any() and not np.isnan(b).any()  # every fragment element placed
        out += a @ b
    np.testing.assert_allclose(out, dp @ zn, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tj", [64, 16])
def test_projection_backward_rows_split_over_the_cluster(tj):
    """The backward's cluster of nch blocks (one a chunk of 32 hidden
    channels, 1 to 8) finishes LN_in's backward of a tile of tj positions
    block q on rows [q RB, min(tj, (q + 1) RB)), RB = ceil(tj / nch): every
    row exactly once."""
    for nch in range(1, 9):
        rb = -(-tj // nch)
        rows = [r for q in range(nch) for r in range(q * rb, min(tj, (q + 1) * rb))]
        assert rows == list(range(tj)), nch


# csrc/trimul_epilogue.cu's backward: one block holds DC output channels
# (64 at C, H <= 128 in tiles of 32 positions; else 32 in tiles of 16);
# dlin and dg lie position-major [TJ][DC + 8], ws [DC][Hp + 4], W_g
# [DC][Cp + 4], the x tile channel-major [Hp][TJ + 8], the z tile
# position-major [TJ][Cp + 4], the shares of dx^ and dzn with rows of 8 mod
# 16 floats (bwd::Layout).
def _bwd_layout(tj, hp, cp, dc):
    return {"ldw": hp + 4, "ldg": cp + 4, "ldx": tj + 8, "ldz": cp + 4, "ldd": dc + 8,
            "ldsx": -(-hp // 16) * 16 + 8, "ldsz": -(-cp // 16) * 16 + 8}


def _bwd_fragments(product, L, k0, m0, n0, lane):
    """The flat shared-memory offsets lane (g, t) reads for one m16n8k8 step
    of `product`, as the kernel computes them: {(operand, row, slot): (buffer,
    offset)}, A's rows m and B's rows n, slots t and t + 4 of the k step. P2
    and P3 take k = 2t and 2t + 1 for the slots t and t + 4."""
    g, t = divmod(lane, 4)
    out = {}
    if product in ("p2_x", "p2_z"):  # dx^ = dlin . ws, dzn = dg . W_g over the block's channels d
        buf, ld = ("ws", L["ldw"]) if product == "p2_x" else ("wg", L["ldg"])
        for half in range(2):
            base = (m0 + g + 8 * half) * L["ldd"] + k0 + 2 * t  # one float2: slots t, t + 4
            out[("a", g + 8 * half, t)] = ("dl", base)
            out[("a", g + 8 * half, t + 4)] = ("dl", base + 1)
        out[("b", g, t)] = (buf, (k0 + 2 * t) * ld + n0 + g)
        out[("b", g, t + 4)] = (buf, (k0 + 2 * t + 1) * ld + n0 + g)
    else:  # d ws += dlin^T . x^, d W_g += dg^T . zn over the tile's positions j
        pa = (k0 + 2 * t) * L["ldd"] + m0 + g
        out[("a", g, t)], out[("a", g + 8, t)] = ("dl", pa), ("dl", pa + 8)
        out[("a", g, t + 4)], out[("a", g + 8, t + 4)] = ("dl", pa + L["ldd"]), ("dl", pa + L["ldd"] + 8)
        if product == "p3_x":
            base = (n0 + g) * L["ldx"] + k0 + 2 * t  # one float2
            out[("b", g, t)], out[("b", g, t + 4)] = ("xs", base), ("xs", base + 1)
        else:
            out[("b", g, t)] = ("zs", (k0 + 2 * t) * L["ldz"] + n0 + g)
            out[("b", g, t + 4)] = ("zs", (k0 + 2 * t + 1) * L["ldz"] + n0 + g)
    return out


@pytest.mark.parametrize("product", ["p2_x", "p2_z", "p3_x", "p3_z"])
@pytest.mark.parametrize("tj,dc", [(32, 64), (16, 32)])
def test_epilogue_backward_fragment_orders_give_the_products(product, tj, dc):
    """The backward's products P2 (dx^ = dlin . ws and dzn = dg . W_g, K =
    the block's dc channels) and P3 (d ws += dlin^T . x^, d W_g += dg^T . zn,
    K = the tile's positions), with k slots t and t + 4 standing for k = 2t
    and 2t + 1: placed lane by lane at the PTX layouts from the kernel's
    shared-memory offsets, the m16n8k8 steps sum to the products, every
    fragment element placed."""
    rng = np.random.default_rng(19)
    hp, cp = 128, 128
    L = _bwd_layout(tj, hp, cp, dc)
    dlin, ws = rng.normal(size=(tj, dc)), rng.normal(size=(dc, hp))
    xhat, zn = rng.normal(size=(hp, tj)), rng.normal(size=(tj, cp))
    store = {"dl": np.full(tj * L["ldd"], np.nan), "ws": np.full(dc * L["ldw"], np.nan),
             "wg": np.full(dc * L["ldg"], np.nan), "xs": np.full(hp * L["ldx"], np.nan),
             "zs": np.full(tj * L["ldz"], np.nan)}
    for j in range(tj):
        store["dl"][j * L["ldd"]:j * L["ldd"] + dc] = dlin[j]
        store["zs"][j * L["ldz"]:j * L["ldz"] + cp] = zn[j]
    for d in range(dc):
        store["ws"][d * L["ldw"]:d * L["ldw"] + hp] = ws[d]
        store["wg"][d * L["ldg"]:d * L["ldg"] + cp] = ws[d]
    for h in range(hp):
        store["xs"][h * L["ldx"]:h * L["ldx"] + tj] = xhat[h]
    if product.startswith("p2"):
        want, (M, Nn, K) = dlin @ ws, (tj, hp, dc)
    else:
        want = dlin.T @ (xhat.T if product == "p3_x" else zn)
        M, Nn, K = dc, want.shape[1], tj
    got = np.zeros((M, Nn))
    for m0 in range(0, M, 16):
        for n0 in range(0, Nn, 8):
            for k0 in range(0, K, 8):
                a, b = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
                for lane in range(32):
                    for (op, row, slot), (buf, off) in _bwd_fragments(product, L, k0, m0, n0, lane).items():
                        if op == "a":
                            a[row, slot] = store[buf][off]
                        else:
                            b[slot, row] = store[buf][off]
                assert not np.isnan(a).any() and not np.isnan(b).any()
                got[m0:m0 + 16, n0:n0 + 8] += a @ b
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tj,hp,cp,dc", [(32, 128, 128, 64), (16, 256, 256, 32), (32, 40, 48, 64)])
def test_epilogue_backward_loads_fall_in_distinct_banks(tj, hp, cp, dc):
    """The strides of bwd::Layout put each conflict-free load of P2 and P3
    in distinct banks: a 4-byte load's 32 lanes, or each half-warp of an
    8-byte one, touch 32 distinct banks. P3's A loads (dlin^T by position
    pairs) are the one 2-way conflict the strides leave."""
    L = _bwd_layout(tj, hp, cp, dc)

    def worst(product, key, pair):
        offsets = [_bwd_fragments(product, L, 8, 16 if product.startswith("p2") else 0, 8, lane)[key(lane)][1]
                   for lane in range(32)]
        groups = [offsets[:16], offsets[16:]] if pair else [offsets]
        banks = [[(o + e) % 32 for o in grp for e in range(2 if pair else 1)] for grp in groups]
        return max(max(b.count(x) for x in b) for b in banks)

    for product in ("p2_x", "p2_z", "p3_x", "p3_z"):
        pair_b = product == "p3_x"
        assert worst(product, lambda lane: ("b", lane // 4, lane % 4), pair_b) == 1, product
        if product.startswith("p2"):
            assert worst(product, lambda lane: ("a", lane // 4, lane % 4), True) == 1, product
        else:
            assert worst(product, lambda lane: ("a", lane // 4, lane % 4), False) == 2, product
    # The shares' 8-byte stores of P2 (rows g, columns 2t, 2t + 1).
    for ld in (L["ldsx"], L["ldsz"]):
        for half in ((0, 16), (16, 32)):
            banks = [((lane // 4) * ld + 2 * (lane % 4) + e) % 32 for lane in range(*half) for e in range(2)]
            assert len(set(banks)) == 32


def test_smoke_script_bounds_use_tensor_core_rates():
    """chip_smoke.py bounds the kernels' products by the tensor cores' rates
    (float32 as three TF32 products): at the main path's shapes both the
    contraction and the epilogue are bound by bytes, 0.060 ms in float32
    and 0.030 ms in bf16; the projection by operations in float32 (0.104
    ms) and by bytes in bf16 (0.030 ms)."""
    import chip_smoke

    assert chip_smoke.PEAK_OPS_PER_S == {"float32": 495e12 / 3, "bfloat16": 989e12}
    # Every kernel whose products run on the tensor cores must show HMMA or
    # HGMMA in its library, or the device phase fails.
    assert set(chip_smoke.TENSOR_CORE) == {"trimul_project", "trimul_contract", "trimul_epilogue", "tri_attention",
                                           "triangle_multiply_cm", "triangle_multiply_nlayout", "contract_cm_km",
                                           "ipa_attention", "trimul_epilogue_partial", "trimul_epilogue_finish",
                                           "pair_transition"}
    assert set(chip_smoke.TENSOR_CORE) <= {k["name"] for k in chip_smoke.KERNELS}
    for name in ("trimul_contract", "trimul_epilogue"):
        for dtype, esize, want_ms in (("float32", 4, 0.060), ("bfloat16", 2, 0.030)):
            bytes_, ops = chip_smoke.kernel_bytes_ops(name, 2, 256, 128, 128, esize)
            assert ops == 2 * 2 * 128 * 256 ** 3
            bytes_ms, ops_ms = bytes_ / chip_smoke.PEAK_BYTES_PER_S * 1e3, ops / chip_smoke.PEAK_OPS_PER_S[dtype] * 1e3
            assert bytes_ms > ops_ms and abs(bytes_ms - want_ms) < 2e-3, (name, dtype, bytes_ms, ops_ms)
    for dtype, esize, want_ms, by_ops in (("float32", 4, 0.104, True), ("bfloat16", 2, 0.030, False)):
        bytes_, ops = chip_smoke.kernel_bytes_ops("trimul_project", 2, 256, 128, 128, esize)
        assert ops == 2 * 2 * 256 * 256 * 128 * 4 * 128
        bytes_ms, ops_ms = bytes_ / chip_smoke.PEAK_BYTES_PER_S * 1e3, ops / chip_smoke.PEAK_OPS_PER_S[dtype] * 1e3
        assert (ops_ms > bytes_ms) == by_ops and abs(max(bytes_ms, ops_ms) - want_ms) < 2e-3, (dtype, bytes_ms, ops_ms)


def test_kernel_variants_apply_to_the_sources():
    """Every text substitution of tools/torch_kernel_variants.json occurs
    exactly once in its source, as the tool requires, so each variant
    builds from the sources as they stand."""
    import json
    import os

    import tools.torch_kernel_variants as tool
    from genie2_tpu_torch.ops import build

    with open(os.path.join(tool.REPO, "tools", "torch_kernel_variants.json")) as fh:
        variants = {k: v for k, v in json.load(fh).items() if not k.startswith("_")}
    assert {v["source"] for v in variants.values()} == set(tool.KERNEL_NAME)
    for name, v in variants.items():
        for fname, old, _ in v.get("subs", []):
            with open(os.path.join(build.CSRC_DIR, fname)) as fh:
                assert fh.read().count(old) == 1, (name, fname, old[:60])
