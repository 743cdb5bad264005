"""Sequence parallelism (genie2_tpu_torch/parallel/sequence_parallel.py) on
gloo ranks: the forward, and the kernels' plain versions at the row-block
shapes.

  * the denoiser on two seq ranks against genie2_tpu's seq-sharded forward
    on the virtual CPU mesh (z within 2e-5, as
    tests/test_seq_sharding.py:140 holds genie2_tpu), with and without
    triangle attention, at an N the seq axis divides and at one it does
    not (padded with masked residues); the two ranks' z bit for bit equal,
    each rank's rows of p those of one process, the samplers' static bias
    (Denoiser.static_bias) giving the same z, the bytes all-reduced a
    forward equal to chip_smoke.py:seq_volume;
  * the plain version of each kernel on a row block against the rows of
    the square computation and against genie2_tpu's Pallas kernel
    (interpret mode) or jnp reference, sliced: the projection (rows 1),
    the outgoing contraction of I rows and the incoming partial sums over
    K rows (2), the epilogue and its two stages (3, 3a-3b),
    contract_cm_km (4), the IPA core with I query rows (7) and triangle
    attention with I queries against all keys (8, the ending node);
  * the collectives' gradient rule on two ranks: gather_seq_rows and
    reduce_seq_rows through autograd against one process.

Every multi-process case runs through `parallel/spawn.py:run_ranks`, once
per module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.ops.trimul_fused as jfused
from genie2_tpu.config import Config as JConfig
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.ops.ipa_fused import fused_ipa_attention
from genie2_tpu.ops.tri_att_flash import flash_tri_attention, reference_tri_attention
from genie2_tpu.parallel import create_mesh as jcreate_mesh
from genie2_tpu.parallel import replicate as jreplicate
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import batchify, create_empty_features
from genie2_tpu_torch.ops import ipa, tri_att, trimul
from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.utils.weights import params_from_flax
from tests import torch_ranks
from tests.test_torch_train import TINY

# ------------------------------------------------------------------ #
# The forward
# ------------------------------------------------------------------ #

SEQ_TINY = {**TINY, "numPairTransformLayers": 2, "triangularAttentionHiddenDimension": 4,
            "triangularAttentionNumHeads": 2}
TRI_ATT = {"includeTriangularAttention": "True"}
# (configuration, residues): an even N and an N the seq axis does not divide.
CASES = {
    "plain": ({}, 20),
    "tri_att": (TRI_ATT, 20),
    "uneven": ({}, 19),
    "uneven_tri_att": (TRI_ATT, 19),
}


def _inputs(n_res, batch=2):
    batch_np = batchify([create_empty_features([n_res])] * batch)
    trans = (np.random.default_rng(n_res).normal(size=(batch, n_res, 3)) * 3).astype(np.float32)
    return trans, np.array([3, 7], dtype=np.int32), batch_np


def _genie2_tpu_seq(overrides, inputs):
    """genie2_tpu's forward with its pair tensor sharded over a seq axis of
    two virtual CPU devices, and its (zero leaves randomised) parameters as
    a state dict."""
    from tests.test_torch_train import _randomized

    trans, t, batch = inputs
    config = JConfig(overrides=overrides)
    feats = jto_device(batch)
    x = jnp.asarray(trans)
    frames = JRigid(jfrenet(x, feats["chain_index"], feats["residue_mask"]), x)
    variables = _randomized(jax.jit(FlaxDenoiser.from_config(config).init)(jax.random.PRNGKey(1), frames,
                                                                            jnp.asarray(t), feats))
    mesh = jcreate_mesh(n_data=1, n_seq=2)
    model = FlaxDenoiser.from_config(config, mesh=mesh)
    assert model.pair_sharding is not None
    z = jax.jit(model.apply)(jreplicate(variables, mesh), frames, jnp.asarray(t), feats)["z"]
    return np.asarray(z), params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def forward_runs():
    """Each case through genie2_tpu's seq-sharded forward, the port on two
    seq ranks and the port in one process."""
    cases, want = [], {}
    for name, (extra, n_res) in CASES.items():
        overrides = {**SEQ_TINY, **extra}
        inputs = _inputs(n_res)
        want[name], state_dict = _genie2_tpu_seq(overrides, inputs)
        cases.append((overrides, state_dict, inputs))
    ranks = run_ranks(torch_ranks.seq_forward, 2, (cases, 2))
    alone = torch_ranks.seq_forward(0, cases, 1, distributed=False)
    return {name: (want[name], [r[i] for r in ranks], alone[i], cases[i]) for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_two_seq_ranks_match_genie2_tpu(forward_runs, name):
    """z within 2e-5 of genie2_tpu's seq-sharded forward (of the real
    residues, where N is padded); the two ranks' z bit for bit equal."""
    want, (r0, r1), _, _ = forward_runs[name]
    assert np.abs(want).max() > 1e-3 and r0["z"].shape == want.shape
    np.testing.assert_allclose(r0["z"].numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.equal(r0["z"], r1["z"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_rows_of_p(forward_runs, name):
    """Rank r's p is rows [r N'/2, (r + 1) N'/2) of the padded length N' of
    one process's p (its real rows and columns within 1e-5 of max |p|),
    [B, N'/2, N', c_p]; the samplers' static bias of this rank's rows
    gives the same z."""
    _, ranks, alone, (overrides, _, (trans, _, _)) = forward_runs[name]
    B, n = trans.shape[:2]
    n_pad = -(-n // 2) * 2
    top = alone["p"].abs().max().item()
    for rank, res in enumerate(ranks):
        lo, hi = res["rows"]
        assert (lo, hi) == (rank * n_pad // 2, (rank + 1) * n_pad // 2)
        assert tuple(res["p"].shape) == (B, n_pad // 2, n_pad, overrides["pairFeatureDimension"])
        real = min(hi, n) - lo
        err = (res["p"][:, :real, :n] - alone["p"][:, lo:lo + real]).abs().max().item()
        assert err <= 1e-5 * top, (rank, err, top)
        assert (res["z_static"] - res["z"]).abs().max().item() <= 1e-6
    assert (alone["z_static"] - alone["z"]).abs().max().item() == 0


@pytest.mark.parametrize("name", ["plain", "tri_att", "uneven_tri_att"])
def test_forward_volume_is_its_formula(forward_runs, name):
    """The bytes all-reduced over the seq group in one forward:
    chip_smoke.py:seq_volume at the padded length (each pair layer's two
    TriMul buffers B H N^2, with triangle attention the starting node's
    bias B H_tri N^2 and the ending node's rows B N^2 c_p, each structure
    layer's s and frames B N (c_s + 12), float32)."""
    import chip_smoke

    _, ranks, alone, (overrides, _, (trans, _, _)) = forward_runs[name]
    B, n = trans.shape[:2]
    want = chip_smoke.seq_volume(Config(overrides=overrides), B, -(-n // 2) * 2)
    m = SEQ_TINY
    n_pad = -(-n // 2) * 2
    by_hand = 4 * (m["numPairTransformLayers"] * 2 * B * m["triangularMultiplicativeHiddenDimension"] * n_pad ** 2
                   + B * n_pad * (m["singleFeatureDimension"] + 12))
    if "tri_att" in name:
        by_hand += 4 * m["numPairTransformLayers"] * B * n_pad ** 2 * (2 + m["pairFeatureDimension"])
    assert want == by_hand
    for res in ranks:
        assert res["volume"] == {"forward": want, "backward": 0}
    assert alone["volume"] == {"forward": 0, "backward": 0}


def test_gather_and_reduce_gradients():
    """gather_seq_rows and reduce_seq_rows under autograd on two ranks
    against one process: a loss that every rank computes whole from a
    gathered tensor gives each rank's rows n_seq times their gradient (the
    module docstring's rule); a loss of this rank's rows of reduced partial
    sums (the ranks' losses sum to one process's) gives each rank's
    partial sums the whole gradient; mean_grad_over_seq turns the ranks'
    shares, each counted n_seq times, into the whole gradient."""
    got = run_ranks(torch_ranks.seq_collectives, 2)
    want = torch_ranks.seq_collectives(0, distributed=False)
    for rank, res in enumerate(got):
        rows = slice(rank * 3, (rank + 1) * 3)
        assert torch.equal(res["gathered"], want["gathered"])
        torch.testing.assert_close(res["reduced"], want["reduced"][:, rows])
        torch.testing.assert_close(res["grad_gather"], 2 * want["grad_gather"][:, rows])
        torch.testing.assert_close(res["grad_reduce"], want["grad_reduce"])
        torch.testing.assert_close(res["grad_mean"], want["grad_mean"])
        assert res["volume"]["forward"] > 0 and res["volume"]["backward"] > 0


# ------------------------------------------------------------------ #
# The kernels' plain versions on row blocks
# ------------------------------------------------------------------ #

B, N, C = 1, 32, 16  # genie2_tpu's TriMul kernels take N % 16 == 0 and H = C
ROWS = slice(16, 32)  # the second of two seq ranks
ATOL = 5e-6


@pytest.fixture(scope="module")
def trimul_setup():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(B, N, N, C)).astype(np.float32)
    res_mask = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    f = lambda *s, sc=0.3, off=0.0: (off + sc * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    jw = {"ln_in_scale": f(C, off=1.0), "ln_in_bias": f(C), "ln_out_scale": f(C, off=1.0), "ln_out_bias": f(C),
          "w_z": f(C, C), "b_z": f(C), "w_g": f(C, C), "b_g": f(C)}
    for k in ("ap", "ag", "bp", "bg"):
        jw[f"w_{k}"], jw[f"b_{k}"] = f(C, C), f(C)
    # genie2_tpu's kernels take [in, out]; the port torch's [out, in].
    tw = {k: torch.tensor(v.T if k.startswith("w_") else v) for k, v in jw.items()}
    return z, res_mask, {k: jnp.asarray(v) for k, v in jw.items()}, tw


def test_project_row_block(trimul_setup):
    """Rows I of z with their row mask and every column's mask: the rows
    of the square projection and of genie2_tpu's kernel."""
    z, res_mask, jw, tw = trimul_setup
    ja, jb = jfused.project_gated_cm(jnp.asarray(z), jnp.asarray(res_mask), jw, interpret=True)
    tz, tm = torch.tensor(z), torch.tensor(res_mask)
    a, b = trimul.project_gated_cm_plain(tz[:, ROWS], tm[:, ROWS], tw, tm)
    assert tuple(a.shape) == (B, C, N // 2, N)
    sa, sb = trimul.project_gated_cm_plain(tz, tm, tw)
    for got, square, pallas in ((a, sa, ja), (b, sb, jb)):
        assert torch.equal(got, square[:, :, ROWS])
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas)[:, :, ROWS], atol=ATOL)


def _cm(seed):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(B, C, N, N))).astype(np.float32) for _ in range(2)]


def test_contract_outgoing_row_block():
    """I rows of a against all of b: the rows of the square contraction
    and of genie2_tpu's kernel."""
    a, b = _cm(1)
    pallas = np.asarray(jfused.contract_cm_fullk(jnp.asarray(a), jnp.asarray(b), outgoing=True, interpret=True))
    got = trimul.contract_cm_plain(torch.tensor(a)[:, :, ROWS], torch.tensor(b), True)
    assert tuple(got.shape) == (B, C, N // 2, N)
    np.testing.assert_allclose(got.numpy(), pallas[:, :, ROWS], atol=ATOL)


def test_contract_incoming_partial_sums():
    """Each rank's K rows of a and b give partial sums of every (i, j):
    their sum is the square incoming contraction and genie2_tpu's kernel."""
    a, b = _cm(2)
    pallas = np.asarray(jfused.contract_cm_fullk(jnp.asarray(a), jnp.asarray(b), outgoing=False, interpret=True))
    ta, tb = torch.tensor(a), torch.tensor(b)
    parts = [trimul.contract_cm_plain(ta[:, :, k], tb[:, :, k], False) for k in (slice(0, 16), ROWS)]
    assert all(tuple(p.shape) == (B, C, N, N) for p in parts)
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), pallas, atol=ATOL)


def test_contract_km_row_block():
    """contract_cm_km on I rows of a (the outgoing block's backward,
    da = dx . b): the rows of genie2_tpu's kernel."""
    a, b = _cm(3)
    pallas = np.asarray(jfused.contract_cm_fullk_km(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = trimul.contract_cm_km_plain(torch.tensor(a)[:, :, ROWS], torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), pallas[:, :, ROWS], atol=ATOL)


def test_epilogue_row_block(trimul_setup):
    """x and z of I rows: the rows of the square epilogue and of
    genie2_tpu's kernel; the two stages (two ranks' halves of the hidden
    channels, summed, then the finish) on the same rows."""
    z, _, jw, tw = trimul_setup
    x = np.random.default_rng(9).normal(size=(B, C, N, N)).astype(np.float32)
    pallas = np.asarray(jfused.epilogue_cm(jnp.asarray(x), jnp.asarray(z), jw, interpret=True))
    tx, tz = torch.tensor(x)[:, :, ROWS], torch.tensor(z)[:, ROWS]
    got = trimul.epilogue_cm_plain(tx, tz, tw)
    assert tuple(got.shape) == (B, N // 2, N, C)
    np.testing.assert_allclose(got.numpy(), pallas[:, ROWS], atol=ATOL)
    part = sum(trimul.epilogue_partial_plain(tx[:, h], tw["w_z"][:, h], tw["ln_out_scale"][h], tw["ln_out_bias"][h])
               for h in (slice(0, C // 2), slice(C // 2, C)))
    assert part.shape == (trimul.part_size(B, N, C, N // 2),)
    two = trimul.epilogue_finish(part, tz, tw, C)
    np.testing.assert_allclose(two.numpy(), pallas[:, ROWS], atol=ATOL)


def test_ipa_query_row_block():
    """The IPA core with I query rows (q, q points, the pair bias and z of
    those rows) against every key: the rows of genie2_tpu's kernel."""
    from tests.test_torch_ipa import make_inputs

    n = 32
    args = make_inputs(n=n, seed=4, masked_tail=5)
    q, k, v, q_pts, k_pts, v_pts, z, wb, bb, hw, mask = args
    pallas = fused_ipa_attention(*(jnp.asarray(a) for a in args), tile_i=16, tile_j=16, interpret=True)
    t = lambda x: torch.tensor(x)[None]  # noqa: E731
    rows = slice(16, 32)
    bias = t(z)[:, rows] @ torch.tensor(wb) + torch.tensor(bb)
    got = ipa.ipa_attention(t(q)[:, rows], t(k), t(v), t(q_pts)[:, rows], t(k_pts), t(v_pts), bias, t(z)[:, rows],
                            torch.tensor(hw), t(mask))
    for g, want, name in zip(got, pallas, ("o", "o_pt", "o_pair")):
        assert g.shape[1] == 16
        np.testing.assert_allclose(g[0].numpy(), np.asarray(want)[rows], atol=2e-5, rtol=2e-5, err_msg=name)


def test_tri_attention_queries_against_all_keys():
    """Triangle attention with Jq of the Jk positions as the queries (the
    ending node of a seq rank: its rows of the bias, every key): the
    queries' rows of genie2_tpu's kernel and reference."""
    from tests.test_torch_tri_att import make_inputs

    q, k, v, tb, mask = make_inputs(8, 32, 2, 4, seed=6, mask_kind="tail")
    jargs = [jnp.asarray(a) for a in (q, k, v, tb, mask)]
    ref = np.asarray(reference_tri_attention(*jargs))
    pallas = np.asarray(flash_tri_attention(*jargs, tile_rows=4, tile_q=8, tile_k=8, interpret=True))
    queries = slice(8, 24)
    got = tri_att.tri_attention(torch.tensor(q)[None, :, queries], torch.tensor(k)[None], torch.tensor(v)[None],
                                torch.tensor(tb)[None, :, queries], torch.tensor(mask)[None])
    assert tuple(got.shape) == (1, 8, 16, 2, 4)
    np.testing.assert_allclose(got[0].numpy(), ref[:, queries], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), pallas[:, queries], atol=1e-5, rtol=0)
