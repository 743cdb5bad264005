"""genie2_tpu_torch's IPA attention core against genie2_tpu.

`ipa_attention_plain` (the kernel's plain version, which CPU tensors take)
is held against the Pallas kernel of ops/ipa_fused.py run through the
interpreter and against its jnp reference, on the inputs of
tests/test_ipa_fused.py; the port's InvariantPointAttention, which now
runs through `ipa_attention`, against the flax module. The attention core
masks the key side only, so comparisons with the reference and with the
flax module are on real rows.
"""

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
from genie2_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
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
    reset_launch_counts()
    run_plain(args)
    assert LAUNCHES["ipa_attention"] == 0
    meta = lambda *s: torch.zeros(*s, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        ipa.ipa_attention(meta(1, 4, H, C), meta(1, 4, H, C), meta(1, 4, H, C), meta(1, 4, H, PQ, 3),
                          meta(1, 4, H, PQ, 3), meta(1, 4, H, PV, 3), meta(1, 4, 4, H), meta(1, 4, 4, CZ),
                          meta(H), meta(1, 4))


def test_rows_per_block_keeps_items_in_bounds():
    for c_z in (1, 24, 128, 256, 257, 512):
        ti = ipa.rows_per_block(c_z)
        assert 1 <= ti <= 2 and ti * c_z <= 512
