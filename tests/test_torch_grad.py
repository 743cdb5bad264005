"""Gradients through genie2_tpu_torch's kernel wrappers and its denoiser.

On the CPU each autograd Function of ops/ runs its forward through the plain
version (what the kernel computes on the card) and its own backward: the
contraction's four kernel identities, the recomputed plain gradient for
the others. Each is held against autograd of the plain forward (float32:
the plain versions compute in float32 whatever their inputs, so there is no
float64 gradcheck; within 1e-5 of max |gradient|). The denoiser's gradient
with respect to the translations, through the Frenet frames and `closed`
quaternions, is held against jax.grad of genie2_tpu's flax Denoiser with
the same weights (within 1e-4 of max |gradient|).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu_torch.features import to_device
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.ops import ipa, tri_att, trimul
from genie2_tpu_torch.ops.launch import Recomputed, recompute_backward, records_grad
from genie2_tpu_torch.utils import profiling
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_denoiser import DIMS, make_batch, randomized_variables

TOL = 1e-5


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _close(got, want, tol=TOL):
    assert got is not None and want is not None
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= tol * scale, (err, scale)


def _grads(out, inputs, cotangents):
    outs = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(outs, inputs, cotangents, allow_unused=True)


def _trimul_weights(C, H, gen, grad=True):
    def r(*shape, scale=1.0, offset=0.0):
        return (offset + scale * torch.randn(*shape, generator=gen)).requires_grad_(grad)

    w = {f"w_{k}": r(H, C, scale=C ** -0.5) for k in ("ap", "ag", "bp", "bg")}
    w.update({f"b_{k}": r(H, scale=0.1) for k in ("ap", "ag", "bp", "bg")})
    w.update(ln_in_scale=r(C, scale=0.1, offset=1.0), ln_in_bias=r(C, scale=0.1),
             ln_out_scale=r(H, scale=0.1, offset=1.0), ln_out_bias=r(H, scale=0.1),
             w_z=r(C, H, scale=H ** -0.5), b_z=r(C, scale=0.1), w_g=r(C, C, scale=C ** -0.5), b_g=r(C, scale=0.1))
    return w


# ------------------------------------------------------------------ #
# The contraction: four kernel identities
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("outgoing", [True, False])
def test_contraction_identities(outgoing):
    """The backward's four formulas against the definitions, per channel:
    outgoing x[i,j] = sum_k a[i,k] b[j,k], incoming x[i,j] = sum_k a[k,i] b[k,j]."""
    g = _gen(1)
    a, b, dx = (torch.randn(2, 3, 9, 9, generator=g, dtype=torch.float64) for _ in range(3))
    if outgoing:
        da_want = torch.einsum("bhij,bhjk->bhik", dx, b)
        db_want = torch.einsum("bhij,bhik->bhjk", dx, a)
        da = trimul.contract_cm_km(dx.float(), b.float())
        db = trimul.contract_cm(dx.float(), a.float(), outgoing=False)
    else:
        da_want = torch.einsum("bhij,bhkj->bhki", dx, b)
        db_want = torch.einsum("bhij,bhki->bhkj", dx, a)
        da = trimul.contract_cm(b.float(), dx.float(), outgoing=True)
        db = trimul.contract_cm_km(a.float(), dx.float())
    _close(da.double(), da_want)
    _close(db.double(), db_want)
    # The same gradients from autograd of the definition.
    a_, b_ = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    eq = "bhik,bhjk->bhij" if outgoing else "bhki,bhkj->bhij"
    ga, gb = torch.autograd.grad(torch.einsum(eq, a_, b_), (a_, b_), dx)
    _close(da_want, ga, 1e-12)
    _close(db_want, gb, 1e-12)


@pytest.mark.parametrize("outgoing", [True, False])
@pytest.mark.parametrize("needs", [(True, True), (True, False), (False, True)])
def test_contract_function_matches_plain_autograd(outgoing, needs):
    g = _gen(2)
    a = torch.randn(2, 4, 11, 11, generator=g).requires_grad_(needs[0])
    b = torch.randn(2, 4, 11, 11, generator=g).requires_grad_(needs[1])
    dx = torch.randn(2, 4, 11, 11, generator=g)
    wanted = [t for t in (a, b) if t.requires_grad]
    got = _grads(trimul.ContractCM.apply(a, b, outgoing), wanted, dx)
    want = _grads(trimul.contract_cm_plain(a, b, outgoing), wanted, dx)
    for x, y in zip(got, want):
        _close(x, y)


def test_contract_backward_takes_a_non_contiguous_cotangent():
    g = _gen(3)
    a, b = (torch.randn(1, 2, 8, 8, generator=g).requires_grad_(True) for _ in range(2))
    dx = torch.randn(1, 2, 8, 8, generator=g).transpose(-1, -2)  # not contiguous
    for x, y in zip(_grads(trimul.ContractCM.apply(a, b, True), (a, b), dx),
                    _grads(trimul.contract_cm_plain(a, b, True), (a, b), dx)):
        _close(x, y)


# ------------------------------------------------------------------ #
# The recomputed backwards
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_project_and_epilogue_functions_match_plain_autograd(weights_need_grad):
    g = _gen(4)
    B, N, C, H = 2, 10, 12, 6
    w = _trimul_weights(C, H, g, grad=weights_need_grad)
    z = torch.randn(B, N, N, C, generator=g).requires_grad_(True)
    res_mask = (torch.arange(N) < N - 2).float().expand(B, N).contiguous()
    da, db = (torch.randn(B, H, N, N, generator=g) for _ in range(2))

    params = [w[k] for k in trimul.PROJECT_PARAMS]
    inputs = [z] + [p for p in params if p.requires_grad]
    got = _grads(Recomputed.apply(trimul._PROJECT_KERNEL, trimul._PROJECT_PLAIN, z, res_mask, *params), inputs,
                 (da, db))
    want = _grads(trimul.project_gated_cm_plain(z, res_mask, w), inputs, (da, db))
    assert len(got) == (1 + len(params) if weights_need_grad else 1)
    for x, y in zip(got, want):
        _close(x, y)

    x = torch.randn(B, H, N, N, generator=g).requires_grad_(True)
    dout = torch.randn(B, N, N, C, generator=g)
    params = [w[k] for k in trimul.EPILOGUE_PARAMS]
    inputs = [x, z] + [p for p in params if p.requires_grad]
    want = _grads(trimul.epilogue_cm_plain(x, z, w), inputs, dout)
    for out in (Recomputed.apply(trimul._EPILOGUE_KERNEL, trimul._EPILOGUE_PLAIN, x, z, *params),
                trimul.EpilogueCM.apply(x, z, *params)):
        got = _grads(out, inputs, dout)
        assert len(got) == len(want)
        for gx, gy in zip(got, want):
            _close(gx, gy)


def test_ipa_function_matches_plain_autograd():
    """The IPA core's Function on k / v and points strided as
    nn/structure.py passes them, every input differentiated."""
    g = _gen(5)
    B, N, H, C, PQ, PV, CZ = 2, 12, 3, 4, 2, 3, 8
    s = torch.randn(B, N, H, 3 * C, generator=g)
    kv_pts = torch.randn(B, N, H, PQ + PV, 3, generator=g) * 3
    leaves = [s, kv_pts, torch.randn(B, N, H, PQ, 3, generator=g) * 3, torch.randn(B, N, N, H, generator=g),
              torch.randn(B, N, N, CZ, generator=g), torch.rand(H, generator=g) + 0.5]
    for t in leaves:
        t.requires_grad_(True)
    s, kv_pts, q_pts, bias, z, hw = leaves
    mask = (torch.arange(N) < N - 3).float().expand(B, N).contiguous()
    args = (s[..., :C], s[..., C:2 * C], s[..., 2 * C:], q_pts, kv_pts[..., :PQ, :], kv_pts[..., PQ:, :], bias, z, hw, mask)
    cot = [torch.randn(B, N, H, C, generator=g), torch.randn(B, N, H, PV, 3, generator=g),
           torch.randn(B, N, H, CZ, generator=g)]
    got = _grads(Recomputed.apply(partial(ipa._ipa_attention_forward, inf=1e5),
                                  partial(ipa.ipa_attention_plain, inf=1e5), *args), leaves, cot)
    want = _grads(ipa.ipa_attention_plain(*args), leaves, cot)
    for x, y in zip(got, want):
        _close(x, y)


def test_tri_attention_function_matches_plain_autograd():
    g = _gen(6)
    B, I, J, H, c = 2, 5, 9, 2, 4
    q, k, v = (torch.randn(B, I, J, H, c, generator=g).requires_grad_(True) for _ in range(3))
    tb = torch.randn(B, H, J, J, generator=g).requires_grad_(True)
    res = (torch.arange(J) < J - 2).float()
    mask = (res[:, None] * res[None, :])[None, :I].expand(B, I, J).contiguous()
    do = torch.randn(B, I, J, H, c, generator=g)
    for row_chunk in (0, 2):
        fixed = dict(inf=1e9, row_chunk=row_chunk)
        got = _grads(Recomputed.apply(partial(tri_att._tri_attention_forward, **fixed),
                                      partial(tri_att.tri_attention_plain, **fixed), q, k, v, tb, mask), (q, k, v, tb), do)
        want = _grads(tri_att.tri_attention_plain(q, k, v, tb, mask), (q, k, v, tb), do)
        for x, y in zip(got, want):
            _close(x, y)


# ------------------------------------------------------------------ #
# The projection's backward in closed form
# ------------------------------------------------------------------ #


def _project_case(gen, rows, masked, weights_need_grad):
    """z [B, I, N, C] with the row mask of its I rows (the last I of N, as
    the last seq rank holds them; I = N square) and the column mask; with
    `masked`, rows and columns of both masked out."""
    B, N, C, H = 2, 9, 12, 6
    I = N if rows is None else rows
    w = _trimul_weights(C, H, gen, grad=weights_need_grad)
    z = torch.randn(B, I, N, C, generator=gen).requires_grad_(True)
    col_mask = torch.ones(B, N)
    if masked:
        col_mask[0, N - 2:] = 0.0
        col_mask[1, 1] = 0.0
    row_mask = col_mask[:, N - I:].contiguous()
    if masked:
        row_mask[1, 0] = 0.0
    cot = (torch.randn(B, H, I, N, generator=gen), torch.randn(B, H, I, N, generator=gen))
    return z, row_mask, col_mask, w, cot


@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_project_backward_plain_matches_autograd(rows, masked, weights_need_grad):
    """project_gated_cm_backward_plain (the backward kernel's closed form)
    against autograd of project_gated_cm_plain: square and a row block of 4
    of 9 rows with its own column mask, masks with zero rows and columns
    (where dz is exactly 0.0), weights with and without requires_grad (no
    weight gradients then)."""
    z, row_mask, col_mask, w, cot = _project_case(_gen(11), rows, masked, weights_need_grad)
    params = [w[k] for k in trimul.PROJECT_PARAMS]
    inputs = [z] + [p for p in params if p.requires_grad]
    want = _grads(trimul.project_gated_cm_plain(z, row_mask, w, col_mask), inputs, cot)
    with torch.no_grad():
        dz, grads = trimul.project_gated_cm_backward_plain(z, row_mask, w, *cot, col_mask,
                                                           weight_grads=weights_need_grad)
    assert (grads is None) != weights_need_grad
    got = [dz] + ([grads[k] for k in trimul.PROJECT_PARAMS] if weights_need_grad else [])
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        _close(x, y)
    off = (row_mask[:, :, None] * col_mask[:, None, :]) == 0
    assert off.any() == masked
    assert (dz[off] == 0.0).all() and (want[0][off] == 0.0).all()


@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_project_function_matches_plain_autograd(rows, weights_need_grad):
    """ProjectGatedCM (the card's Function for float32) on the CPU: the
    plain forward, the closed-form backward; every input's gradient against
    autograd of the plain version, None for what needs none."""
    z, row_mask, col_mask, w, cot = _project_case(_gen(12), rows, True, weights_need_grad)
    params = [w[k] for k in trimul.PROJECT_PARAMS]
    inputs = [z] + [p for p in params if p.requires_grad]
    out = trimul.ProjectGatedCM.apply(z, row_mask, col_mask, *params)
    assert "ProjectGatedCM" in type(out[0].grad_fn).__name__
    got = _grads(out, inputs, cot)
    want = _grads(trimul.project_gated_cm_plain(z, row_mask, w, col_mask), inputs, cot)
    for x, y in zip(got, want):
        _close(x, y)
    w["w_ap"].requires_grad_(True)  # one weight: the others' gradients are None
    grads = torch.autograd.grad(trimul.ProjectGatedCM.apply(z, row_mask, col_mask, *params), [z, w["w_ap"]], cot)
    _close(grads[1], _grads(trimul.project_gated_cm_plain(z, row_mask, w, col_mask), [w["w_ap"]], cot)[0])


# ------------------------------------------------------------------ #
# The epilogue's backward in closed form
# ------------------------------------------------------------------ #


def _epilogue_case(gen, rows, weights_need_grad):
    """x [B, H, I, N] and z [B, I, N, C] of I rows (I = N square), their
    cotangent [B, I, N, C_out] with C_out = C, the weights; the first
    sample's last two columns of x zero, as a padded tail leaves them."""
    B, N, C, H = 2, 9, 12, 6
    I = N if rows is None else rows
    w = _trimul_weights(C, H, gen, grad=weights_need_grad)
    x = 2.0 * torch.randn(B, H, I, N, generator=gen) + 0.5
    x[0, :, :, N - 2:] = 0.0
    z = torch.randn(B, I, N, C, generator=gen)
    dout = torch.randn(B, I, N, C, generator=gen)
    return x.requires_grad_(True), z.requires_grad_(True), w, dout


@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_epilogue_backward_plain_matches_autograd(rows, weights_need_grad):
    """epilogue_cm_backward_plain (the backward kernel's closed form)
    against autograd of epilogue_cm_plain: square and a row block of 4 of 9
    rows, columns of x zero (LN_out's rstd then 1/sqrt(eps)), weights with
    and without requires_grad (no weight gradients then)."""
    x, z, w, dout = _epilogue_case(_gen(13), rows, weights_need_grad)
    params = [w[k] for k in trimul.EPILOGUE_PARAMS]
    inputs = [x, z] + [p for p in params if p.requires_grad]
    want = _grads(trimul.epilogue_cm_plain(x, z, w), inputs, dout)
    with torch.no_grad():
        dx, dz, grads = trimul.epilogue_cm_backward_plain(x, z, w, dout, weight_grads=weights_need_grad)
    assert (grads is None) != weights_need_grad
    got = [dx, dz] + ([grads[k] for k in trimul.EPILOGUE_PARAMS] if weights_need_grad else [])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b)


@pytest.mark.parametrize("rows", [None, 4])
@pytest.mark.parametrize("weights_need_grad", [True, False])
def test_epilogue_function_matches_plain_autograd(rows, weights_need_grad):
    """EpilogueCM (the card's Function for float32) on the CPU: the plain
    forward, the closed-form backward; every input's gradient against
    autograd of the plain version, None for what needs none."""
    x, z, w, dout = _epilogue_case(_gen(14), rows, weights_need_grad)
    params = [w[k] for k in trimul.EPILOGUE_PARAMS]
    inputs = [x, z] + [p for p in params if p.requires_grad]
    out = trimul.EpilogueCM.apply(x, z, *params)
    assert "EpilogueCM" in type(out.grad_fn).__name__
    for a, b in zip(_grads(out, inputs, dout), _grads(trimul.epilogue_cm_plain(x, z, w), inputs, dout)):
        _close(a, b)
    w["w_g"].requires_grad_(True)  # one weight and x: z's and the other weights' gradients are None
    got = torch.autograd.grad(trimul.EpilogueCM.apply(x, z.detach(), *params), [x, w["w_g"]], dout)
    want = _grads(trimul.epilogue_cm_plain(x, z.detach(), w), [x, w["w_g"]], dout)
    for a, b in zip(got, want):
        _close(a, b)


def test_epilogue_backward_routes(monkeypatch):
    """Which Function the wrappers take on the card, as the CPU can show it
    (the device test and the Functions stubbed): a float32 epilogue under
    autograd takes EpilogueCM, its backward kernel; bfloat16 activations,
    C_out above the kernel's 256, and the two stages of tensor parallelism
    (epilogue_partial, epilogue_finish) keep Recomputed."""
    taken = []

    class Taken:
        def __init__(self, name):
            self.name = name

        def apply(self, *args):
            taken.append(self.name)

    monkeypatch.setattr(trimul, "_on_cpu", lambda t: False)
    monkeypatch.setattr(trimul, "EpilogueCM", Taken("EpilogueCM"))
    monkeypatch.setattr(trimul, "Recomputed", Taken("Recomputed"))
    g = _gen(15)
    B, N, C, H = 1, 4, 8, 6
    w = _trimul_weights(C, H, g)
    x = torch.randn(B, H, N, N, generator=g).requires_grad_(True)
    z = torch.randn(B, N, N, C, generator=g)
    trimul.epilogue_cm(x, z, w)
    trimul.epilogue_cm(x.detach().bfloat16().requires_grad_(True), z.bfloat16(),
                       {k: v.detach().bfloat16() for k, v in w.items()})
    wide = dict(w, w_z=torch.randn(257, H, generator=g), w_g=torch.randn(257, C, generator=g))
    trimul.epilogue_cm(x, z, wide)
    trimul.epilogue_partial(x, w["w_z"], w["ln_out_scale"], w["ln_out_bias"])
    trimul.epilogue_finish(torch.zeros(trimul.part_size(B, N, C)), z, w, H)
    assert taken == ["EpilogueCM", "Recomputed", "Recomputed", "Recomputed", "Recomputed"], taken


def test_recompute_backward_skips_inputs_that_need_no_grad():
    calls = []

    def plain(x, w, n):
        calls.append(n)
        return x * w, x + w

    x, w = torch.randn(3), torch.randn(3)
    gx, gw, gn = recompute_backward(plain, (x, w, 7), (True, False, False), (torch.ones(3), None))
    torch.testing.assert_close(gx, w)
    assert gw is None and gn is None and calls == [7]
    assert recompute_backward(plain, (x, w, 7), (False, False, False), (torch.ones(3), None)) == (None, None, None)


def test_wrappers_on_the_cpu_stay_plain_and_count_nothing():
    """On the CPU the wrappers are the plain versions, differentiable by
    autograd directly; the Functions are taken on the card only."""
    profiling.reset()
    a = torch.randn(1, 2, 6, 6, requires_grad=True)
    x = trimul.contract_cm(a, a.detach())
    assert x.grad_fn is not None and "ContractCM" not in type(x.grad_fn).__name__
    assert records_grad([a]) and not records_grad([a.detach()])
    with torch.no_grad():
        assert not records_grad([a])
    assert all(v == 0 for k, v in profiling.counters().items() if k.startswith("launch."))


# ------------------------------------------------------------------ #
# The eigh quaternions' gradient
# ------------------------------------------------------------------ #


def test_top_eigenvector_gradient():
    """`TopEigenvector`'s backward: float64 gradcheck on symmetric
    matrices, eigh's own gradient on generic ones, and on the K-matrices
    of rotations (a triple eigenvalue) finite everywhere and equal to
    torch's and genie2_tpu's eigh gradients wherever theirs are finite."""
    from genie2_tpu.geometry.quat import rot_to_quat as j_rot_to_quat
    from genie2_tpu_torch.geometry.quat import TopEigenvector, _k_matrix, quat_to_rot, rot_to_quat

    g = _gen(8)
    a = torch.randn(12, 4, 4, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda m: TopEigenvector.apply(0.5 * (m + m.transpose(-1, -2))), (a,))
    sym = (a + a.transpose(-1, -2)).detach()
    cot = torch.randn(12, 4, generator=g, dtype=torch.float64)
    ours, theirs = (sym.clone().requires_grad_(True) for _ in range(2))
    (TopEigenvector.apply(ours) * cot).sum().backward()
    (torch.linalg.eigh(theirs)[1][..., -1] * cot).sum().backward()
    _close(ours.grad, theirs.grad, 1e-10)

    q = torch.randn(3000, 4, generator=g)
    rot = quat_to_rot(q / q.norm(dim=-1, keepdim=True))
    cot = torch.randn(3000, 4, generator=g)
    k_ours, k_eigh = (_k_matrix(rot).detach().requires_grad_(True) for _ in range(2))
    (TopEigenvector.apply(k_ours) * cot).sum().backward()
    (torch.linalg.eigh(k_eigh)[1][..., -1] * cot).sum().backward()
    finite = torch.isfinite(k_eigh.grad).flatten(1).all(-1)
    assert torch.isfinite(k_ours.grad).all() and not finite.all()  # eigh's own backward meets 0 / 0
    _close(k_ours.grad[finite], k_eigh.grad[finite])

    # Through rot_to_quat, against jax.grad of genie2_tpu's eigh extraction
    # (the eigenvector signs are each solver's own: the cotangent follows them).
    r = rot.detach().requires_grad_(True)
    quat = rot_to_quat(r, "eigh")
    j_quat = np.asarray(j_rot_to_quat(jnp.asarray(rot.numpy()), "eigh"))
    sign = np.sign((quat.detach().numpy() * j_quat).sum(-1, keepdims=True))
    (quat * cot).sum().backward()
    j_grad = np.asarray(jax.grad(lambda m: jnp.sum(j_rot_to_quat(m, "eigh") * jnp.asarray(cot.numpy() * sign)))(
        jnp.asarray(rot.numpy())))
    j_finite = np.isfinite(j_grad).reshape(3000, -1).all(-1)
    assert torch.isfinite(r.grad).all() and not j_finite.all()
    _close(r.grad[torch.from_numpy(j_finite)], torch.from_numpy(j_grad[j_finite]), 1e-4)


# ------------------------------------------------------------------ #
# The denoiser's gradient against jax.grad
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("padded", [False, True])
def test_denoiser_gradient_wrt_translations_matches_jax(padded):
    """d/dx sum(z . r) over the real residues, through the Frenet frames
    and the denoiser, `closed` quaternions, the port against jax.grad of
    genie2_tpu's apply."""
    flax_model = FlaxDenoiser(remat=False, **DIMS)
    batch = make_batch(padded, with_motif=True)
    variables = randomized_variables(flax_model, make_batch(False, False), jit=True)
    port = Denoiser(**DIMS)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    port.eval().requires_grad_(False)

    rng = np.random.default_rng(3)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3).astype(np.float32)
    trans_np *= batch["residue_mask"][..., None]
    # Real residues only: padded rows of the IPA core differ by design (ops/ipa.py).
    r_np = rng.normal(size=trans_np.shape).astype(np.float32) * batch["residue_mask"][..., None]
    t_np = np.array([7, 31], dtype=np.int32)

    def f(x, r, feats):
        z = flax_model.apply(variables, JRigid(jfrenet(x, feats["chain_index"], feats["residue_mask"]), x),
                             jnp.asarray(t_np), feats)["z"]
        return jnp.sum(z * r)

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(trans_np), jnp.asarray(r_np), jto_device(batch)))

    tf = to_device(batch, "cpu")
    x = torch.tensor(trans_np, requires_grad=True)
    z = port(Rigid(frenet_frames(x, tf["chain_index"], tf["residue_mask"]), x), torch.tensor(t_np), tf)["z"]
    (got,) = torch.autograd.grad((z * torch.tensor(r_np)).sum(), x)
    got = got.numpy()
    real = batch["residue_mask"].astype(bool)
    scale = np.abs(want[real]).max()
    assert scale > 1e-3 and np.isfinite(got).all()
    assert np.abs(got[real] - want[real]).max() <= 1e-4 * scale
