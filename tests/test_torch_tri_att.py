"""genie2_tpu_torch's triangle attention against genie2_tpu.

The attention core: seeded numpy inputs go through the Pallas kernel
`flash_tri_attention` (interpret mode, small tiles), through its jnp
reference and through the port's plain version `tri_attention_plain`
(which the wrapper `tri_attention` takes for CPU tensors). Tolerances:
1e-5 in float32 (another summation order), 3e-2 in bfloat16 (inputs and
output rounded to bfloat16, one ulp is 2^-8). All rows are compared, the
fully padded ones too: module, Pallas kernel and plain version agree there
(uniform attention over every key).

The modules `Attention` and `TriangleAttention` (starting and ending node)
are held to the flax modules with the same weights through
`params_from_flax`, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.nn.pair_stack import TriangleAttention as FlaxTriangleAttention
from genie2_tpu.nn.primitives import Attention as FlaxAttention
from genie2_tpu.ops.tri_att_flash import flash_tri_attention, reference_tri_attention
from genie2_tpu_torch.nn import Attention, TriangleAttention
from genie2_tpu_torch.ops import launch
from genie2_tpu_torch.ops.tri_att import tri_attention, tri_attention_plain
from genie2_tpu_torch.utils import profiling
from genie2_tpu_torch.utils.weights import params_from_flax

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def make_inputs(n_i=8, n_j=16, h=2, c=4, seed=0, mask_kind="dense"):
    """q, k, v [I,J,H,c], tb [H,J,J], mask [I,J] as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n_i, n_j, h, c)).astype(np.float32) for _ in range(3))
    tb = rng.normal(size=(h, n_j, n_j)).astype(np.float32)
    mask = np.ones((n_i, n_j), np.float32)
    if mask_kind in ("tail", "rows"):
        mask[:, n_j - 5:] = 0.0  # padded tail keys
    if mask_kind == "rows":
        mask[n_i - 3:, :] = 0.0  # rows whose keys are all padded
    return q, k, v, tb, mask


def plain(args, dtype=torch.float32, **kw):
    """The port's plain version on one sample (a batch axis of 1)."""
    q, k, v, tb, mask = (torch.tensor(a)[None] for a in args)
    out = tri_attention(q.to(dtype), k.to(dtype), v.to(dtype), tb.to(dtype), mask, **kw)
    assert out.dtype == dtype
    return out[0].float().numpy()


@pytest.mark.parametrize("mask_kind", ["dense", "tail", "rows"])
@pytest.mark.parametrize("shape,tiles", [((8, 16, 2, 4), (4, 8, 8)), ((4, 32, 2, 4), (2, 16, 8)), ((4, 8, 3, 8), (4, 8, 8))])
def test_plain_matches_pallas_and_reference(mask_kind, shape, tiles):
    """Dense, a padded tail, fully padded rows; one and several key tiles."""
    args = make_inputs(*shape, seed=shape[1], mask_kind=mask_kind)
    jargs = [jnp.asarray(a) for a in args]
    want_ref = np.asarray(reference_tri_attention(*jargs))
    want_pallas = np.asarray(flash_tri_attention(
        *jargs, tile_rows=tiles[0], tile_q=tiles[1], tile_k=tiles[2], interpret=True))
    got = plain(args)
    np.testing.assert_allclose(got, want_ref, atol=TOL["float32"], rtol=0)
    np.testing.assert_allclose(got, want_pallas, atol=TOL["float32"], rtol=0)


def test_fully_padded_row_attends_uniformly():
    """inf (mask - 1) absorbs the logit in float32: a row without a real key
    averages v over all keys, the padded ones too."""
    args = make_inputs(mask_kind="rows", seed=3)
    got = plain(args)
    v = args[2]
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].mean(0), got[-1].shape), atol=1e-6)
    assert np.isfinite(got).all()


def test_bf16_inputs_float32_accumulation():
    args = make_inputs(seed=2, mask_kind="tail")
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(reference_tri_attention(*jargs))
    bf = [a.astype(jnp.bfloat16) for a in jargs[:4]] + [jargs[4]]
    pallas = np.asarray(flash_tri_attention(*bf, tile_rows=4, tile_q=8, tile_k=8, interpret=True), np.float32)
    got = plain(args, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=0)
    np.testing.assert_allclose(got, pallas, atol=TOL["bfloat16"], rtol=0)


@pytest.mark.parametrize("row_chunk", [0, 4, 5, 64])
def test_row_chunk_gives_the_same_numbers(row_chunk):
    """0 (off), a divisor of I = 12, a non-divisor (a short last chunk) and
    a chunk beyond I."""
    args = make_inputs(n_i=12, n_j=12, seed=5, mask_kind="rows")
    np.testing.assert_allclose(plain(args, row_chunk=row_chunk), plain(args), atol=1e-7, rtol=0)


def test_batched_samples_are_independent():
    a1, a2 = make_inputs(seed=4), make_inputs(seed=5, mask_kind="tail")
    batched = [torch.tensor(np.stack([x, y])) for x, y in zip(a1, a2)]
    got = tri_attention_plain(*batched).numpy()
    np.testing.assert_allclose(got[0], plain(a1), atol=1e-7)
    np.testing.assert_allclose(got[1], plain(a2), atol=1e-7)


# ------------------------------------------------------------------ #
# The tensor-core kernel's arithmetic, emulated on the CPU
# ------------------------------------------------------------------ #


def _tf32_cut(x):
    """x with its low 13 mantissa bits cleared, as the tensor cores read a
    TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_nearest(x):
    """x rounded to TF32 to nearest: one TF32 product's operand."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_tf32(a, b):
    """a @ b as csrc/tensor_core.cuh takes float32: hi = x cut to TF32, lo =
    the rest cut again; lo.hi + hi.lo + hi.hi summed in float32."""
    ah, bh = _tf32_cut(a), _tf32_cut(b)
    al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _one_tf32(a, b):
    return _tf32_nearest(a) @ _tf32_nearest(b)


def _bf16_terms(p, terms):
    """p as the bf16 kernel hands it to the tensor cores: p_hi, or p_hi + p_lo."""
    hi = p.bfloat16().float()
    return hi if terms == 1 else hi + (p - hi).bfloat16().float()


def _emulated_kernel(q, k, v, tb, mask, qk, pv, inf=1e9, tile=64):
    """csrc/tri_att_flash.cu in torch: per key tile of 64, s = qk(q, k^T) /
    sqrt(c) + tb + inf (mask - 1), the online softmax (running max from
    -1e30), o += pv(p, v); o / max(l, 1e-20). Arguments as
    tri_attention_plain, float32."""
    n_b, n_i, n_j, n_h, c = q.shape
    qh, kh, vh = (t.permute(0, 1, 3, 2, 4) for t in (q, k, v))  # [B, I, H, J, c]
    m = torch.full(qh.shape[:-1], -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qh)
    for k0 in range(0, n_j, tile):
        s = qk(qh, kh[..., k0:k0 + tile, :].transpose(-1, -2)) * (1.0 / np.sqrt(c))
        s = s + tb[:, None, :, :, k0:k0 + tile]
        s = s + inf * (mask[:, :, None, None, k0:k0 + tile] - 1.0)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + pv(p, vh[..., k0:k0 + tile, :])
        m = m_new
    return (o / l.clamp_min(1e-20)[..., None]).permute(0, 1, 3, 2, 4)


def _full_width_inputs(dtype=torch.float32):
    """One sample at the configuration's widths (J = 256, 4 heads of 32), 8
    rows, a padded tail of 24 keys; rounded to `dtype`, returned as float32."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.tensor(rng.normal(size=(1, 8, 256, 4, 32)).astype(np.float32)) for _ in range(3))
    tb = torch.tensor(rng.normal(size=(1, 4, 256, 256)).astype(np.float32))
    mask = torch.ones(1, 8, 256)
    mask[..., 256 - 24:] = 0.0
    return [t.to(dtype).float() for t in (q, k, v, tb)] + [mask]


def test_float32_products_need_three_tf32_products():
    """At J = 256, c = 32 the kernel's float32 scheme, three TF32 products
    for q.k and for p.v, holds the 1e-4 tolerance against
    tri_attention_plain (within 1e-5); one TF32 product for either q.k or
    p.v does not."""
    args = _full_width_inputs()
    want = tri_attention_plain(*args).double()
    scale = want.abs().max().item()

    def rel(qk, pv):
        return (_emulated_kernel(*args, qk, pv).double() - want).abs().max().item() / scale

    three, one_qk, one_pv = rel(_three_tf32, _three_tf32), rel(_one_tf32, _three_tf32), rel(_three_tf32, _one_tf32)
    assert three <= 1e-5 and one_qk > 1e-4 and one_pv > 1e-4, (three, one_qk, one_pv)


def test_bf16_probabilities_as_one_bf16_term():
    """bf16 inputs (their products exact in float32): the kernel hands p to
    the tensor cores rounded to bf16, one term. Before o is rounded that
    stays within 3e-3 of float32 p at J = 256, ten times inside the 3e-2
    bf16 tolerance; two terms, p_hi + p_lo, would keep it within 1e-5."""
    args = _full_width_inputs(torch.bfloat16)
    exact = lambda a, b: a @ b  # noqa: E731
    want = _emulated_kernel(*args, exact, exact).double()
    scale = want.abs().max().item()
    one, two = (
        (_emulated_kernel(*args, exact, lambda p, v, n=n: _bf16_terms(p, n) @ v).double() - want).abs().max().item()
        / scale for n in (1, 2)
    )
    assert two <= 1e-5 and 100 * two < one <= 3e-3, (one, two)


def test_pv_fragment_key_order_gives_p_dot_v():
    """The float32 p.v of the kernel: lane (g, t) holds the s accumulators
    (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of an 8-key tile and hands
    them on as its A fragment a0..a3 = (g, t), (g+8, t), (g, t+4), (g+8,
    t+4), while its B fragment reads v rows 2t and 2t+1 at column g (b0 =
    (k t, n g), b1 = (k t+4, n g)). The product over the permuted k index is
    p.v."""
    rng = np.random.default_rng(5)
    p, v = rng.uniform(size=(16, 8)), rng.normal(size=(8, 8))
    a, b = np.full((16, 8), np.nan), np.full((8, 8), np.nan)
    for lane in range(32):
        g, t = divmod(lane, 4)
        acc = (p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t], p[g + 8, 2 * t + 1])
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = acc[0], acc[2], acc[1], acc[3]
        b[t, g], b[t + 4, g] = v[2 * t, g], v[2 * t + 1, g]
    assert not np.isnan(a).any() and not np.isnan(b).any()
    np.testing.assert_allclose(a @ b, p @ v, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ #
# The modules
# ------------------------------------------------------------------ #


def randomized(variables, seed):
    """Zero-initialised leaves ("final", "gating" weights) get small random
    values, so every projection reaches the output."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [0.3 * jax.random.normal(k, l.shape, l.dtype) if not np.any(np.asarray(l)) else l
              for k, l in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def pair_inputs(b=2, n=10, c=12, n_pad=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, n, c)).astype(np.float32)
    res = np.ones((b, n), np.float32)
    res[1, n - n_pad:] = 0.0
    return x, res[:, :, None] * res[:, None, :]


@pytest.mark.parametrize("row_chunk", [0, 3])
def test_attention_matches_flax(row_chunk):
    h, c = 3, 4
    x, mask = pair_inputs()
    rng = np.random.default_rng(1)
    tb = rng.normal(size=(2, h, 10, 10)).astype(np.float32)
    flax_mod = FlaxAttention(c_q=12, c_k=12, c_v=12, c_hidden=c, no_heads=h, row_chunk=row_chunk)
    biases = [jnp.asarray(1e9 * (mask[:, :, None, None, :] - 1.0)), jnp.asarray(tb)[:, None]]
    jx = jnp.asarray(x)
    variables = randomized(flax_mod.init(jax.random.PRNGKey(0), jx, jx, jx, biases), 3)
    want = np.asarray(flax_mod.apply(variables, jx, jx, jx, biases))

    port = Attention(12, 12, 12, c, h, row_chunk=row_chunk)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    tx = torch.tensor(x)
    with torch.inference_mode():
        got = port(tx, tx, tx, torch.tensor(tb), torch.tensor(mask)).numpy()
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("starting", [True, False], ids=["starting", "ending"])
@pytest.mark.parametrize("row_chunk", [0, 4])
def test_triangle_attention_matches_flax(starting, row_chunk):
    x, mask = pair_inputs(seed=2)
    flax_mod = FlaxTriangleAttention(c_in=12, c_hidden=4, no_heads=3, starting=starting, row_chunk=row_chunk)
    variables = randomized(flax_mod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask)), 5)
    want = np.asarray(flax_mod.apply(variables, jnp.asarray(x), jnp.asarray(mask)))

    port = TriangleAttention(12, 4, 3, starting=starting, row_chunk=row_chunk)
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    with torch.inference_mode():
        got = port(torch.tensor(x), torch.tensor(mask)).numpy()
    assert got.shape == x.shape and np.abs(want).max() > 1e-2
    # All rows and columns, the padded ones too.
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_version_is_differentiable_on_the_cpu():
    q, k, v, tb, mask = (torch.tensor(a)[None] for a in make_inputs(seed=6, mask_kind="tail"))
    q.requires_grad_(True)
    tri_attention(q, k, v, tb, mask).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all() and q.grad.abs().max() > 0


# ------------------------------------------------------------------ #
# The gradient rule of the kernel launches
# ------------------------------------------------------------------ #


def test_check_no_grad_raises_only_under_grad_mode():
    """Called directly: on the CPU the wrappers take their plain versions
    and never reach the launch."""
    a, w = torch.zeros(3), torch.nn.Parameter(torch.zeros(3))
    launch.check_no_grad("k", [a, a.clone()])
    with pytest.raises(RuntimeError, match="forward only"):
        launch.check_no_grad("k", [a, w])
    with pytest.raises(RuntimeError, match="forward only"):
        launch.check_no_grad("k", [a, w * 2.0])  # a temporary made from a weight
    with torch.no_grad():
        launch.check_no_grad("k", [a, w])
    with torch.inference_mode():
        launch.check_no_grad("k", [a, w])


def test_launch_checks_gradients_before_it_builds():
    """`launch` refuses before it looks for a compiler, so the rule holds
    wherever the kernels cannot be built either."""
    w = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(RuntimeError, match="forward only"):
        launch.launch("tri_att_flash", "tri_att_flash", [], torch.device("cpu"), w, 1)
    assert profiling.counters()["launch.tri_attention"] == 0


# ------------------------------------------------------------------ #
# The smoke script's counts for this kernel
# ------------------------------------------------------------------ #


def test_smoke_script_counts_triangle_attention():
    """chip_smoke.py's byte and operation counts give the bound the kernel's
    note states, and its expected launches are two per pair layer and
    denoiser call with triangle attention on, none with it off."""
    import chip_smoke

    bytes_, ops = chip_smoke.kernel_bytes_ops("tri_attention", 2, 256, 128, 128, 4)
    assert ops == 4 * 2 * 256 ** 3 * 4 * 32
    assert bytes_ == 4 * (4 * 2 * 256 * 256 * 4 * 32 + 2 * 4 * 256 * 256) + 4 * 2 * 256 * 256
    assert ops / chip_smoke.PEAK_OPS_PER_S["float32"] > bytes_ / chip_smoke.PEAK_BYTES_PER_S  # bound by operations
    assert abs(ops / chip_smoke.PEAK_OPS_PER_S["float32"] * 1e3 - 0.104) < 1e-3
    on, off = chip_smoke.example_config(tri_att=True), chip_smoke.example_config()
    assert on.model["include_tri_att"] and not off.model["include_tri_att"]
    assert (on.model["n_head_tri"], on.model["c_hidden_tri_att"]) == (chip_smoke.TRI_ATT["H"], chip_smoke.TRI_ATT["c"])
    assert chip_smoke.expected_launches(on, 1000)["tri_attention"] == 10000
    assert chip_smoke.expected_launches(off, 1000)["tri_attention"] == 0
    assert chip_smoke.expected_launches(on, 1000)["trimul_project"] == chip_smoke.expected_launches(off, 1000)["trimul_project"]
    assert [k["name"] for k in chip_smoke.KERNELS][-1] == "tri_attention" and len(chip_smoke.KERNELS) == 11
