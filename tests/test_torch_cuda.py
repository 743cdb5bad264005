"""genie2_tpu_torch's kernels (TriMul, IPA attention, the triangle
contractions, triangle attention) against their plain versions on the card.

Marked `cuda`; each test skips where torch sees no CUDA device (decided
inside the test, so every worker collects the same tests). On a machine
with a card:  python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from genie2_tpu_torch.ops import ipa, transition, tri_att, triangle, trimul  # noqa: F401, their counters
from genie2_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# Relative to max |plain|: float32 sums in another order; bfloat16 values on
# a rounding boundary can land one bf16 ulp apart.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _weights(C, H, gen, device, D=None):
    """TriMul weights in torch layout; D is the output width (C unless given)."""
    D = C if D is None else D

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    w = {f"w_{k}": r(H, C, scale=C ** -0.5) for k in ("ap", "ag", "bp", "bg")}
    w.update({f"b_{k}": r(H, scale=0.1) for k in ("ap", "ag", "bp", "bg")})
    w.update(ln_in_scale=r(C, scale=0.1, offset=1.0), ln_in_bias=r(C, scale=0.1),
             ln_out_scale=r(H, scale=0.1, offset=1.0), ln_out_bias=r(H, scale=0.1),
             w_z=r(D, H, scale=H ** -0.5), b_z=r(D, scale=0.1), w_g=r(D, C, scale=C ** -0.5), b_g=r(D, scale=0.1))
    return w


def _launches():
    """{kernel: launches} since the last profiling.reset()."""
    return {k[len("launch."):]: v for k, v in profiling.counters().items() if k.startswith("launch.")}


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,weight_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                                (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,c,h,d", [
    (96, 32, 32, 32), (70, 48, 40, 48),
    # the tensor-core tiles' edges: N off the 128-wide contraction tile, the
    # 32-row epilogue tile and (70) 16 bytes; widths off the k step; D != C,
    # D above one 128-channel chunk (the epilogue restages its weights)
    (200, 128, 128, 128), (224, 256, 256, 256), (70, 40, 48, 24), (224, 48, 256, 200), (200, 256, 40, 72),
    # the projection's tiles: N of 1, 17 and 130 (off its 32- and 64-row
    # tiles), hidden chunks of 32-128 channels with H off them, C up to 256
    (1, 32, 32, 32), (17, 64, 256, 64), (130, 256, 32, 128), (130, 128, 200, 96),
])
@pytest.mark.parametrize("outgoing", [True, False])
def test_kernels_match_plain(device, dtype, weight_dtype, n, c, h, d, outgoing):
    """bf16 weights (the bf16 policy) make the wrappers convert every weight
    to a temporary, which must live until its kernel has read it."""
    gen = torch.Generator(device=device).manual_seed(n + c + d)
    w = {k: v.to(weight_dtype) for k, v in _weights(c, h, gen, device, d).items()}
    z = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype)
    res_mask = (torch.arange(n, device=device) < n - 5).float().expand(2, n).contiguous()
    profiling.reset()
    a, b = trimul.project_gated_cm(z, res_mask, w)
    a_p, b_p = trimul.project_gated_cm_plain(z, res_mask, w)
    _close(a, a_p, dtype)
    _close(b, b_p, dtype)
    _close(trimul.contract_cm(a_p, b_p, outgoing), trimul.contract_cm_plain(a_p, b_p, outgoing), dtype)
    x_p = trimul.contract_cm_plain(a_p, b_p, outgoing)
    _close(trimul.epilogue_cm(x_p, z, w), trimul.epilogue_cm_plain(x_p, z, w), dtype)
    torch.cuda.synchronize()
    assert _launches()["trimul_project"] == 1 and _launches()["trimul_epilogue"] == 1
    assert _launches()["trimul_contract_out" if outgoing else "trimul_contract_in"] == 1


def _at_offset(part: torch.Tensor, offset: int) -> torch.Tensor:
    """`part` as a contiguous view `offset` floats into a buffer of its own:
    at an odd offset no span of it is 16-byte aligned."""
    if not offset:
        return part
    buf = torch.empty(part.numel() + offset, dtype=part.dtype, device=part.device)
    buf[offset:].copy_(part)
    return buf[offset:]


@pytest.mark.parametrize("dtype,weight_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                                (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,c,h,d", [(256, 128, 128, 128), (255, 128, 128, 128), (70, 40, 48, 24),
                                     (224, 48, 256, 200), (17, 256, 40, 72), (1, 32, 32, 33),
                                     (224, 256, 256, 256), (130, 256, 128, 128), (40, 64, 64, 1000)])
@pytest.mark.parametrize("offset", [0, 1])
def test_split_epilogue_matches_plain(device, dtype, weight_dtype, n, c, h, d, offset):
    """The partial and finish modes against their plain versions, each
    rank's partial on half the hidden channels; their sum through the
    finish kernel against the one-launch epilogue kernel. The kernels move
    a tile's span of part by one bulk copy where it is 16-byte aligned and
    by 8- or 4-byte copies (the finish) or plain stores (the partial)
    where not: odd first positions (odd n), odd tails (n = 255), odd D
    (33), and the summed part at an odd float offset (every span of the
    finish's input unaligned). D off the even pair (33) stores element by
    element. Wide C, H and D leave no room for part's span tiles beside the
    resident weights (C = 256: the finish reads part in place in float32,
    or stages the spans beside 64-channel chunks; D = 1000: both kernels
    read or write part in place)."""
    gen = torch.Generator(device=device).manual_seed(n + h + d)
    w = {k: v.to(weight_dtype) for k, v in _weights(c, h, gen, device, d).items()}
    z = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype)
    x = torch.randn(2, h, n, n, generator=gen, device=device).to(dtype)
    profiling.reset()
    part = 0
    for sl in (slice(0, h // 2), slice(h // 2, h)):
        args = (x[:, sl].contiguous(), w["w_z"][:, sl], w["ln_out_scale"][sl], w["ln_out_bias"][sl])
        got = trimul.epilogue_partial(*args)
        _close(got, trimul.epilogue_partial_plain(*args), torch.float32)
        part = part + got
    part = _at_offset(part, offset)
    _close(trimul.epilogue_finish(part, z, w, h), trimul.epilogue_finish_plain(
        part, z, *(w[k] for k in trimul.FINISH_PARAMS), h), dtype)
    _close(trimul.epilogue_finish(part, z, w, h), trimul.epilogue_cm(x, z, w), dtype)
    torch.cuda.synchronize()
    assert _launches()["trimul_epilogue_partial"] == 2 and _launches()["trimul_epilogue_finish"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_epilogue_wrappers_launch_one_kernel(device, dtype):
    """Under bf16 weights (the bf16 policy) each epilogue wrapper call is
    one device kernel: the kernels read the parameters in their own dtype,
    so no conversion runs beside them (torch.profiler's device events)."""
    import chip_smoke

    gen = torch.Generator(device=device).manual_seed(5)
    n, c, h = 64, 32, 32
    w = {k: v.to(torch.bfloat16) for k, v in _weights(c, h, gen, device).items()}
    z = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype)
    x = torch.randn(2, h, n, n, generator=gen, device=device).to(dtype)
    half = slice(0, h // 2)
    rank = (x[:, half].contiguous(), w["w_z"][:, half].contiguous(), w["ln_out_scale"][half], w["ln_out_bias"][half])
    part = trimul.epilogue_partial(*rank)
    with torch.no_grad():
        for fn in (lambda: trimul.epilogue_cm(x, z, w), lambda: trimul.epilogue_partial(*rank),
                   lambda: trimul.epilogue_finish(part, z, w, h)):
            names = [e.name for e in chip_smoke.device_events(fn)]
            assert len(names) == 1 and "epilogue" in names[0], names


def test_wrapper_rejects_bad_input(device):
    w = _weights(16, 8, torch.Generator(device=device).manual_seed(0), device)
    z = torch.randn(1, 8, 8, 16, device=device)
    with pytest.raises(TypeError):
        trimul.project_gated_cm(z.half(), torch.ones(1, 8, device=device), w)
    with pytest.raises(ValueError):
        trimul.contract_cm(z[..., :8].permute(0, 3, 1, 2), z[..., :8].permute(0, 3, 1, 2))


def _ipa_inputs(device, dtype, B, N, H, C, PQ, PV, CZ, tail):
    gen = torch.Generator(device=device).manual_seed(N + H)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    q, k, v = r(B, N, H, C), r(B, N, H, C), r(B, N, H, C)
    pts = [r(B, N, H, PQ, 3) * 3, r(B, N, H, PQ, 3) * 3, r(B, N, H, PV, 3) * 3]
    bias, z = r(B, N, N, H), r(B, N, N, CZ)
    mask = (torch.arange(N, device=device) < N - tail).float().expand(B, N).contiguous()
    return (*(t.to(dtype) for t in (q, k, v, *pts, bias, z)), r(H).abs() + 0.5, mask)


def _strided(args):
    """The same inputs as nn/structure.py hands them over: k and v the
    halves of one projection, the k and v points the parts of one tensor,
    the mask as int32 (the kernel reads it in its own dtype)."""
    q, k, v, q_pts, k_pts, v_pts, bias, z, hw, mask = args
    kv = torch.cat([k, v], -1)
    kv_pts = torch.cat([k_pts, v_pts], -2)
    c, pq = k.shape[-1], k_pts.shape[-2]
    return (q, kv[..., :c], kv[..., c:], q_pts, kv_pts[..., :pq, :], kv_pts[..., pq:, :], bias, z, hw,
            mask.to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,tail", [(70, 6), (96, 0), (1, 0), (9, 2)])
@pytest.mark.parametrize("h,c,pq,pv,cz", [(5, 8, 3, 5, 24), (12, 16, 4, 8, 128), (16, 8, 2, 4, 300),
                                          (3, 5, 1, 1, 7)])
@pytest.mark.parametrize("strided", [False, True])
def test_ipa_attention_matches_plain(device, dtype, n, tail, h, c, pq, pv, cz, strided):
    """Ragged N (off the 8-key tiles, one key), odd widths (runs copied 16,
    8 or 4 bytes or element by element), every head bucket and row count
    per block, and strided inputs as nn/structure.py passes them; the
    plain version follows the kernel on padded rows too. One launch."""
    args = _ipa_inputs(device, dtype, 2, n, h, c, pq, pv, cz, tail)
    if strided:
        args = _strided(args)
        assert not args[1].is_contiguous() and not args[5].is_contiguous()
    profiling.reset()
    got = ipa.ipa_attention(*args)
    torch.cuda.synchronize()
    assert _launches()["ipa_attention"] == 1
    for g, w in zip(got, ipa.ipa_attention_plain(*args)):
        assert torch.isfinite(g.float()).all()
        _close(g, w, dtype)


def test_ipa_attention_rejects_bad_input(device):
    args = list(_ipa_inputs(device, torch.float32, 1, 16, 4, 8, 2, 2, 16, 0))
    with pytest.raises(ValueError, match="limits"):
        wide = _ipa_inputs(device, torch.float32, 1, 16, 4, 8, 2, 2, 1100, 0)
        ipa.ipa_attention(*wide)
    with pytest.raises(ValueError, match="limits"):
        ipa.ipa_attention(*_ipa_inputs(device, torch.float32, 1, 16, 17, 8, 2, 2, 16, 0))
    with pytest.raises(ValueError):
        ipa.ipa_attention(args[0][:, :8], *args[1:])
    with pytest.raises(TypeError):
        ipa.ipa_attention(*(a.half() if a.dim() > 2 else a for a in args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(70, 24), (96, 40),
                                 # the tiles' edges: N off 16 and off 128, one row; C off
                                 # the 16-byte channel group (4 float32, 8 bf16)
                                 (1, 8), (17, 5), (130, 12), (200, 36), (256, 128)])
def test_triangle_contractions_match_plain(device, dtype, n, c):
    gen = torch.Generator(device=device).manual_seed(n)
    a = (torch.randn(2, n, n, c, generator=gen, device=device) * 0.3).to(dtype)
    b = (torch.randn(2, n, n, c, generator=gen, device=device) * 0.3).to(dtype)
    profiling.reset()
    for outgoing in (True, False):
        want = triangle.triangle_multiply_reference(a, b, outgoing)
        for layout in triangle.LAYOUTS:
            got = triangle.triangle_multiply(a, b, outgoing, layout)
            assert got.is_contiguous()
            _close(got, want, dtype)
    a_cm, b_km = a.permute(0, 3, 1, 2).contiguous(), b.permute(0, 3, 1, 2).contiguous()
    _close(trimul.contract_cm_km(a_cm, b_km), trimul.contract_cm_km_plain(a_cm, b_km), dtype)
    torch.cuda.synchronize()
    counts = _launches()
    assert (counts["triangle_multiply_cm"], counts["triangle_multiply_nlayout"], counts["contract_cm_km"]) == (2, 2, 1)
    if n > 1:  # a transposed view (at N = 1 it is contiguous)
        with pytest.raises(ValueError):
            triangle.triangle_multiply(a.permute(0, 2, 1, 3), b)


def _tri_att_inputs(device, dtype, B, I, J, H, c, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed + J + c)
    r = lambda *s: torch.randn(*s, generator=gen, device=device)
    q, k, v, tb = r(B, I, J, H, c), r(B, I, J, H, c), r(B, I, J, H, c), r(B, H, J, J)
    mask = torch.ones(B, I, J, device=device)
    mask[:, :, J - 5:] = 0.0  # a padded tail of keys
    mask[-1, I - 3:, :] = 0.0  # rows whose keys are all padded, in the last sample
    return q.to(dtype), k.to(dtype), v.to(dtype), tb.to(dtype), mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("i,j", [(70, 70), (24, 150), (130, 33),
                                 # the tensor-core tiles' edges: J off the 16-row
                                 # fragments and the 64-key tiles, one key
                                 (5, 1), (17, 15), (9, 65), (33, 130)])
@pytest.mark.parametrize("h,c", [(4, 32), (3, 8), (2, 20), (1, 64)])
def test_tri_attention_matches_plain(device, dtype, i, j, h, c):
    """Ragged query and key tiles, I != J, every compiled head width and
    widths between them (c of 8, 20: padded with zeros, staged element by
    element), fully padded rows (uniform attention): all rows are
    compared."""
    args = _tri_att_inputs(device, dtype, 2, i, j, h, c)
    profiling.reset()
    got = tri_att.tri_attention(*args, row_chunk=7)
    torch.cuda.synchronize()
    assert _launches()["tri_attention"] == 1
    want = tri_att.tri_attention_plain(*args)
    assert got.shape == want.shape and got.dtype == dtype and torch.isfinite(got.float()).all()
    _close(got, want, dtype)
    # A row without a real key averages v over all keys.
    uniform = args[2][-1, -1].float().mean(0)
    assert (got[-1, -1].float() - uniform).abs().max() <= 2 * TOL[dtype] * uniform.abs().max().clamp_min(1.0)


def test_tri_attention_rejects_bad_input(device):
    q, k, v, tb, mask = _tri_att_inputs(device, torch.float32, 1, 16, 16, 2, 8)
    with pytest.raises(ValueError):
        tri_att.tri_attention(q, k[:, :8], v, tb, mask)
    with pytest.raises(ValueError):
        tri_att.tri_attention(q, k, v, tb[:, :, :8], mask)
    with pytest.raises(ValueError):
        tri_att.tri_attention(q.transpose(1, 2), k, v, tb, mask)
    with pytest.raises(TypeError):
        tri_att.tri_attention(q.half(), k.half(), v.half(), tb.half(), mask)
    with pytest.raises(ValueError, match="head width"):
        tri_att.tri_attention(*_tri_att_inputs(device, torch.float32, 1, 8, 8, 1, 72))


def test_kernels_refuse_inputs_that_require_grad(device):
    """A raw launch refuses an input that requires grad with grad mode on
    (the kernel would return a tensor without a graph); the wrappers record
    their launch through their autograd Functions instead, and under
    no_grad they launch without a graph."""
    q, k, v, tb, mask = _tri_att_inputs(device, torch.float32, 1, 16, 16, 2, 8)
    q.requires_grad_(True)
    out = tri_att.tri_attention(q, k, v, tb, mask)
    assert out.requires_grad and type(out.grad_fn).__name__ == "RecomputedBackward"
    with torch.no_grad():
        out = tri_att.tri_attention(q, k, v, tb, mask)
    assert not out.requires_grad
    a = torch.randn(1, 8, 16, 16, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        trimul.launch_triangle_contract(a, a.detach(), torch.empty_like(a), (1, 8, 16), a.stride(), a.stride(),
                                        a.stride(), variant=0)
    assert trimul.contract_cm(a, a.detach()).requires_grad
    w = _weights(16, 8, torch.Generator(device=device).manual_seed(0), device)
    w["w_ap"].requires_grad_(True)  # a weight, not an activation
    a_out, _ = trimul.project_gated_cm(torch.randn(1, 8, 8, 16, device=device), torch.ones(1, 8, device=device), w)
    assert a_out.requires_grad
    args = list(_ipa_inputs(device, torch.float32, 1, 16, 4, 8, 2, 2, 16, 0))
    args[7].requires_grad_(True)
    assert all(t.requires_grad for t in ipa.ipa_attention(*args))


# Gradients, relative to max |plain gradient|: float32 within 1e-4 (the
# contraction's backward is 3xTF32 products, the recomputed ones agree to
# rounding), bfloat16 within 3e-2.


def _grad_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g is not None and w is not None and torch.isfinite(g.float()).all()
        _close(g, w, dtype)


def _grads_of(fn, inputs, cotangents):
    out = fn()
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, inputs, cotangents)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [96, 70])
@pytest.mark.parametrize("outgoing", [True, False])
def test_trimul_gradients_match_plain(device, dtype, n, outgoing):
    """Project, contract and epilogue under autograd against the plain
    versions' gradients; the contraction's backward launches the
    contraction kernels only (trimul_contract and contract_cm_km)."""
    gen = torch.Generator(device=device).manual_seed(n)
    c, h = 32, 24
    w = {k: v.to(dtype).requires_grad_(True) for k, v in _weights(c, h, gen, device).items()}
    z = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype).requires_grad_(True)
    res_mask = (torch.arange(n, device=device) < n - 5).float().expand(2, n).contiguous()
    da, db = (torch.randn(2, h, n, n, generator=gen, device=device).to(dtype) for _ in range(2))
    inputs = [z, *(w[k] for k in trimul.PROJECT_PARAMS)]
    _grad_close(_grads_of(lambda: trimul.project_gated_cm(z, res_mask, w), inputs, (da, db)),
                _grads_of(lambda: trimul.project_gated_cm_plain(z, res_mask, w), inputs, (da, db)), dtype)

    a, b = (torch.randn(2, h, n, n, generator=gen, device=device).to(dtype).requires_grad_(True) for _ in range(2))
    dx = torch.randn(2, h, n, n, generator=gen, device=device).to(dtype)
    profiling.reset()
    got = _grads_of(lambda: trimul.contract_cm(a, b, outgoing), (a, b), dx)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _launches().items() if v}
    assert counts == ({"trimul_contract_out": 1, "trimul_contract_in": 1, "contract_cm_km": 1}), counts
    _grad_close(got, _grads_of(lambda: trimul.contract_cm_plain(a, b, outgoing), (a, b), dx), dtype)

    x = torch.randn(2, h, n, n, generator=gen, device=device).to(dtype).requires_grad_(True)
    dout = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype)
    inputs = [x, z, *(w[k] for k in trimul.EPILOGUE_PARAMS)]
    _grad_close(_grads_of(lambda: trimul.epilogue_cm(x, z, w), inputs, dout),
                _grads_of(lambda: trimul.epilogue_cm_plain(x, z, w), inputs, dout), dtype)


@pytest.mark.parametrize("b,n,i,c,h,masked", [
    (2, 256, 256, 128, 128, False),  # the training step's widths
    (2, 77, 77, 128, 128, True),     # an odd N, padded
    (2, 256, 128, 128, 128, True),   # a row block: the first 128 of 256 rows, its own column mask
    (2, 256, 256, 128, 64, True),    # H_r = 64 channels of a model rank
    (1, 70, 70, 40, 40, True),       # C and H off the tiles: 40 of two 32-channel chunks
    (1, 33, 33, 256, 32, True),      # C above 128 (tiles of 16 positions)
    (2, 9, 9, 30, 8, True),          # C off 16 bytes: z staged element by element
])
def test_project_backward_kernel_matches_plain(device, b, n, i, c, h, masked):
    """trimul_project_backward (float32) against the plain closed form and
    against the recomputed gradient it replaces (autograd of
    project_gated_cm_plain): dz and every parameter's gradient within 1e-4
    of max |plain gradient|, dz exactly 0.0 where a row or column is masked,
    the same bits from two calls, and dz alone (no weight gradients) the
    same as with them."""
    gen = torch.Generator(device=device).manual_seed(n + i + h)
    w = _weights(c, h, gen, device)
    z = 2.0 * torch.randn(b, i, n, c, generator=gen, device=device) + 0.5
    col_mask = torch.ones(b, n, device=device)
    if masked:
        col_mask[0, (3 * n) // 4:] = 0.0
        col_mask[-1, 1] = 0.0
    row_mask = col_mask[:, :i].clone()
    if masked:
        row_mask[0, min(2, i - 1)] = 0.0
    da, db = (torch.randn(b, h, i, n, generator=gen, device=device) for _ in range(2))
    with torch.no_grad():
        dz, grads = trimul.project_gated_cm_backward(z, row_mask, w, da, db, col_mask)
        dz2, grads2 = trimul.project_gated_cm_backward(z, row_mask, w, da, db, col_mask)
        dz_alone, none = trimul.project_gated_cm_backward(z, row_mask, w, da, db, col_mask, weight_grads=False)
        want_dz, want = trimul.project_gated_cm_backward_plain(z, row_mask, w, da, db, col_mask)
    torch.cuda.synchronize()
    assert none is None and torch.equal(dz, dz_alone) and torch.equal(dz, dz2)
    assert all(torch.equal(grads[k], grads2[k]) for k in trimul.PROJECT_PARAMS)
    got = [dz] + [grads[k] for k in trimul.PROJECT_PARAMS]
    _grad_close(got, [want_dz] + [want[k] for k in trimul.PROJECT_PARAMS], torch.float32)
    leaves = [z.clone().requires_grad_(True)] + [w[k].clone().requires_grad_(True) for k in trimul.PROJECT_PARAMS]
    recomputed = _grads_of(lambda: trimul.project_gated_cm_plain(
        leaves[0], row_mask, dict(zip(trimul.PROJECT_PARAMS, leaves[1:])), col_mask), leaves, (da, db))
    _grad_close(got, recomputed, torch.float32)
    off = (row_mask[:, :, None] * col_mask[:, None, :]) == 0
    assert off.any() == masked and (dz[off] == 0.0).all()


def test_project_backward_launches(device):
    """Under autograd a float32 projection's backward is one launch of its
    kernel (counter launch.trimul_project_backward, under the span
    genie2:backward.trimul_project) and, where a weight needs a gradient,
    one of the kernel that sums the weights' partial sums; with no weight
    needing one (TDS's twist) that second kernel does not run. bfloat16
    activations keep the recomputed plain gradient."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=device).manual_seed(7)
    w = _weights(64, 64, gen, device)
    z = torch.randn(2, 40, 40, 64, generator=gen, device=device).requires_grad_(True)
    mask = torch.ones(2, 40, device=device)
    cot = tuple(torch.randn(2, 64, 40, 40, generator=gen, device=device) for _ in range(2))
    for weights_need_grad in (True, False):
        for k in trimul.PROJECT_PARAMS:
            w[k].requires_grad_(weights_need_grad)
        leaves = [z] + ([w[k] for k in trimul.PROJECT_PARAMS] if weights_need_grad else [])
        out = trimul.project_gated_cm(z, mask, w)
        assert type(out[0].grad_fn).__name__ == "ProjectGatedCMBackward"
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, cot)
            torch.cuda.synchronize()
        counts = {k: v for k, v in _launches().items() if v}
        assert counts == {"trimul_project_backward": 1}, counts
        names = [e.name for e in prof.events()]
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert "genie2:backward.trimul_project" in names
        assert sum("project_backward_kernel" in k for k in kernels) == 1
        assert sum("project_backward_sum_kernel" in k for k in kernels) == int(weights_need_grad), kernels
    out = trimul.project_gated_cm(z.detach().bfloat16().requires_grad_(True), mask,
                                  {k: v.bfloat16() for k, v in w.items()})
    assert type(out[0].grad_fn).__name__ == "RecomputedBackward"


@pytest.mark.parametrize("b,n,i,h,c,d,lengths", [
    (4, 256, 256, 128, 128, 128, None),               # the training step's widths
    (4, 256, 256, 128, 128, 128, (20, 86, 153, 220)),  # the train cell's padding: x zero past each length
    (2, 256, 128, 128, 128, 128, None),               # a row block: 128 of 256 rows
    (2, 256, 256, 64, 128, 128, None),                # H = 64
    (4, 75, 75, 128, 128, 128, None),                 # the TDS shape, N off the tiles
    (1, 70, 70, 40, 40, 24, None),                    # H, C and D off the tiles: 40 of 48, one block of D
    (1, 33, 17, 256, 200, 200, None),                 # H, C above 128 (tiles of 16), 7 blocks of D
    (2, 9, 9, 30, 30, 30, None),                      # N and C off 16 bytes: tiles staged element by element
])
def test_epilogue_backward_kernel_matches_plain(device, b, n, i, h, c, d, lengths):
    """trimul_epilogue_backward (float32) against the plain closed form and
    against the recomputed gradient it replaces (autograd of
    epilogue_cm_plain): dx, dz and every parameter's gradient within 1e-4 of
    max |plain gradient| (3xTF32 products and float32 sums in another
    order), the same bits from two calls, and dx, dz alone (no weight
    gradients) the same as with them."""
    gen = torch.Generator(device=device).manual_seed(n + i + h + c)
    w = _weights(c, h, gen, device, d)
    x = 2.0 * torch.randn(b, h, i, n, generator=gen, device=device) + 0.5
    if lengths is not None:
        for row, length in enumerate(lengths):
            x[row, :, length:] = 0.0
            x[row, :, :, length:] = 0.0
    z = torch.randn(b, i, n, c, generator=gen, device=device)
    dout = torch.randn(b, i, n, d, generator=gen, device=device)
    with torch.no_grad():
        dx, dz, grads = trimul.epilogue_cm_backward(x, z, w, dout)
        dx2, dz2, grads2 = trimul.epilogue_cm_backward(x, z, w, dout)
        dx_alone, dz_alone, none = trimul.epilogue_cm_backward(x, z, w, dout, weight_grads=False)
        want_dx, want_dz, want = trimul.epilogue_cm_backward_plain(x, z, w, dout)
    torch.cuda.synchronize()
    assert none is None and torch.equal(dx, dx_alone) and torch.equal(dz, dz_alone)
    assert torch.equal(dx, dx2) and torch.equal(dz, dz2)
    assert all(torch.equal(grads[k], grads2[k]) for k in trimul.EPILOGUE_PARAMS)
    got = [dx, dz] + [grads[k] for k in trimul.EPILOGUE_PARAMS]
    _grad_close(got, [want_dx, want_dz] + [want[k] for k in trimul.EPILOGUE_PARAMS], torch.float32)
    leaves = [x.clone().requires_grad_(True), z.clone().requires_grad_(True)] + \
        [w[k].clone().requires_grad_(True) for k in trimul.EPILOGUE_PARAMS]
    recomputed = _grads_of(lambda: trimul.epilogue_cm_plain(
        leaves[0], leaves[1], dict(zip(trimul.EPILOGUE_PARAMS, leaves[2:]))), leaves, dout)
    _grad_close(got, recomputed, torch.float32)


def test_epilogue_backward_launches(device):
    """Under autograd a float32 epilogue's backward is one launch of its
    kernel (counter launch.trimul_epilogue_backward, under the span
    genie2:backward.trimul_epilogue) and, where a weight needs a gradient,
    one of the kernel that sums the weights' partial sums; with no weight
    needing one (TDS's twist) that second kernel does not run. bfloat16
    activations and the two stages of tensor parallelism keep the
    recomputed plain gradient."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=device).manual_seed(8)
    w = _weights(64, 64, gen, device)
    x = torch.randn(2, 64, 40, 40, generator=gen, device=device).requires_grad_(True)
    z = torch.randn(2, 40, 40, 64, generator=gen, device=device).requires_grad_(True)
    cot = torch.randn(2, 40, 40, 64, generator=gen, device=device)
    for weights_need_grad in (True, False):
        for k in trimul.EPILOGUE_PARAMS:
            w[k].requires_grad_(weights_need_grad)
        leaves = [x, z] + ([w[k] for k in trimul.EPILOGUE_PARAMS] if weights_need_grad else [])
        out = trimul.epilogue_cm(x, z, w)
        assert type(out.grad_fn).__name__ == "EpilogueCMBackward"
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, cot)
            torch.cuda.synchronize()
        counts = {k: v for k, v in _launches().items() if v}
        assert counts == {"trimul_epilogue_backward": 1}, counts
        names = [e.name for e in prof.events()]
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert "genie2:backward.trimul_epilogue" in names
        assert not any(n.startswith("genie2:recompute.") for n in names), names
        assert sum("epilogue_backward_kernel" in k for k in kernels) == 1
        assert sum("epilogue_backward_sum_kernel" in k for k in kernels) == int(weights_need_grad), kernels
    bf = {k: v.detach().bfloat16() for k, v in w.items()}
    out = trimul.epilogue_cm(x.detach().bfloat16().requires_grad_(True), z.detach().bfloat16(), bf)
    assert type(out.grad_fn).__name__ == "RecomputedBackward"
    part = trimul.epilogue_partial(x, w["w_z"], w["ln_out_scale"], w["ln_out_bias"])
    assert type(part.grad_fn).__name__ == "RecomputedBackward"
    assert type(trimul.epilogue_finish(part, z, w, 64).grad_fn).__name__ == "RecomputedBackward"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
def test_ipa_and_tri_attention_gradients_match_plain(device, dtype, strided):
    """The IPA core (on strided k / v / points as nn/structure.py passes
    them, or contiguous) and triangle attention under autograd against the
    plain versions' gradients, every floating input differentiated."""
    args = [t.requires_grad_(True) if t.is_floating_point() else t
            for t in _ipa_inputs(device, dtype, 2, 70, 12, 16, 4, 8, 128, 6)[:9]]
    mask = (torch.arange(70, device=device) < 64).float().expand(2, 70).contiguous()
    leaves = list(args)
    if strided:
        q, k, v, q_pts, k_pts, v_pts, bias, z, hw = (t.detach() for t in args)
        kv, kv_pts = torch.cat([k, v], -1).requires_grad_(True), torch.cat([k_pts, v_pts], -2).requires_grad_(True)
        q, q_pts, bias, z, hw = (t.requires_grad_(True) for t in (q, q_pts, bias, z, hw))
        c, pq = k.shape[-1], k_pts.shape[-2]
        args = [q, kv[..., :c], kv[..., c:], q_pts, kv_pts[..., :pq, :], kv_pts[..., pq:, :], bias, z, hw]
        leaves = [q, kv, q_pts, kv_pts, bias, z, hw]
    args.append(mask)
    gen = torch.Generator(device=device).manual_seed(3)
    cot = [torch.randn(o.shape, generator=gen, device=device).to(dtype) for o in ipa.ipa_attention_plain(*args)]
    _grad_close(_grads_of(lambda: ipa.ipa_attention(*args), leaves, cot),
                _grads_of(lambda: ipa.ipa_attention_plain(*args), leaves, cot), dtype)

    q, k, v, tb, mask = _tri_att_inputs(device, dtype, 2, 33, 70, 4, 32)
    for t in (q, k, v, tb):
        t.requires_grad_(True)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    _grad_close(_grads_of(lambda: tri_att.tri_attention(q, k, v, tb, mask), (q, k, v, tb), do),
                _grads_of(lambda: tri_att.tri_attention_plain(q, k, v, tb, mask), (q, k, v, tb), do), dtype)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,i", [(96, 48), (70, 35), (256, 128), (255, 128), (33, 17)])
def test_row_block_kernels_match_plain(device, dtype, n, i):
    """The row-block cases of sequence parallelism (the last i of n rows, as
    the last seq rank holds them) against the plain versions, forward and
    gradient: the projection with its row and column masks, the outgoing
    contraction of i rows against all of b, the incoming partial sums over
    i rows of k, the epilogue and its two stages on i rows, contract_cm_km
    at (i, n, n) and (n, n, i), the IPA core with i query rows, triangle
    attention with i queries against n keys."""
    gen = torch.Generator(device=device).manual_seed(n + i)
    c, h = 32, 24
    rows = slice(n - i, n)
    r = lambda *s: torch.randn(*s, generator=gen, device=device).to(dtype)  # noqa: E731
    w = {k: v.to(dtype).requires_grad_(True) for k, v in _weights(c, h, gen, device).items()}
    z = r(2, i, n, c).requires_grad_(True)
    res_mask = (torch.arange(n, device=device) < n - 5).float().expand(2, n).contiguous()
    row_mask = res_mask[:, rows].contiguous()
    inputs = [z, *(w[k] for k in trimul.PROJECT_PARAMS)]
    da, db = r(2, h, i, n), r(2, h, i, n)
    _grad_close(_grads_of(lambda: trimul.project_gated_cm(z, row_mask, w, res_mask), inputs, (da, db)),
                _grads_of(lambda: trimul.project_gated_cm_plain(z, row_mask, w, res_mask), inputs, (da, db)), dtype)
    with torch.no_grad():
        for got, want in zip(trimul.project_gated_cm(z, row_mask, w, res_mask),
                             trimul.project_gated_cm_plain(z, row_mask, w, res_mask)):
            _close(got, want, dtype)

    a, b_full, b_rows = (r(2, h, i, n).requires_grad_(True), r(2, h, n, n).requires_grad_(True),
                         r(2, h, i, n).requires_grad_(True))
    for x_args, outgoing, dx in (((a, b_full), True, r(2, h, i, n)), ((a, b_rows), False, r(2, h, n, n))):
        with torch.no_grad():
            _close(trimul.contract_cm(*x_args, outgoing), trimul.contract_cm_plain(*x_args, outgoing), dtype)
        _grad_close(_grads_of(lambda: trimul.contract_cm(*x_args, outgoing), x_args, dx),
                    _grads_of(lambda: trimul.contract_cm_plain(*x_args, outgoing), x_args, dx), dtype)
    with torch.no_grad():
        for lhs, rhs in ((r(2, h, i, n), r(2, h, n, n)), (r(2, h, n, i), r(2, h, i, n))):
            _close(trimul.contract_cm_km(lhs, rhs), trimul.contract_cm_km_plain(lhs, rhs), dtype)

    x = r(2, h, i, n).requires_grad_(True)
    dout = r(2, i, n, c)
    inputs = [x, z, *(w[k] for k in trimul.EPILOGUE_PARAMS)]
    _grad_close(_grads_of(lambda: trimul.epilogue_cm(x, z, w), inputs, dout),
                _grads_of(lambda: trimul.epilogue_cm_plain(x, z, w), inputs, dout), dtype)
    with torch.no_grad():
        _close(trimul.epilogue_cm(x, z, w), trimul.epilogue_cm_plain(x, z, w), dtype)
        # The two stages on the row block, with weights in the activation
        # dtype and in float32, the summed part also at an odd float offset.
        for wt in (w, {k: v.float() for k, v in w.items()}):
            halves = [(x[:, hs].contiguous(), wt["w_z"][:, hs], wt["ln_out_scale"][hs], wt["ln_out_bias"][hs])
                      for hs in (slice(0, h // 2), slice(h // 2, h))]
            part = sum(trimul.epilogue_partial(*hv) for hv in halves)
            _close(part, sum(trimul.epilogue_partial_plain(*hv) for hv in halves), dtype)
            for offset in (0, 1):
                _close(trimul.epilogue_finish(_at_offset(part, offset), z, wt, h), trimul.epilogue_cm_plain(x, z, wt),
                       dtype)

    q, k, v, q_pts, k_pts, v_pts, bias, zz, hw, mask = _ipa_inputs(device, dtype, 2, n, 12, 16, 4, 8, 128, 5)
    args = [q[:, rows], k, v, q_pts[:, rows], k_pts, v_pts, bias[:, rows], zz[:, rows], hw]
    args = [t.contiguous().requires_grad_(True) for t in args] + [mask]
    with torch.no_grad():
        for got, want in zip(ipa.ipa_attention(*args), ipa.ipa_attention_plain(*args)):
            _close(got, want, dtype)
    cot = [torch.randn(o.shape, generator=gen, device=device).to(dtype) for o in ipa.ipa_attention_plain(*args)]
    _grad_close(_grads_of(lambda: ipa.ipa_attention(*args), args[:9], cot),
                _grads_of(lambda: ipa.ipa_attention_plain(*args), args[:9], cot), dtype)

    q, k, v, tb, mask = _tri_att_inputs(device, dtype, 2, n, n, 4, 32)
    q, tb = q[:, :, rows].contiguous(), tb[:, :, rows].contiguous()
    for t in (q, k, v, tb):
        t.requires_grad_(True)
    do = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    with torch.no_grad():
        _close(tri_att.tri_attention(q, k, v, tb, mask), tri_att.tri_attention_plain(q, k, v, tb, mask), dtype)
    _grad_close(_grads_of(lambda: tri_att.tri_attention(q, k, v, tb, mask), (q, k, v, tb), do),
                _grads_of(lambda: tri_att.tri_attention_plain(q, k, v, tb, mask), (q, k, v, tb), do), dtype)


def test_training_step_kernels_match_plain(device):
    """One training step (train/state.py) at a small width, batch 2 of
    lengths 70 and 64 (padded to 70), dropout and remat on, with the
    kernels and then from the same state, t, noise and dropout seed with
    every plain version swapped in: the loss within 1e-5 relative, the
    whole gradient within 1e-3 of its max |entry|, grad_norm within 1e-4
    relative, and the median weight's gradient-norm gap within the train
    cell's grad_err limit (2.5e-4, portbench/limits); the step launches the
    TriMul kernels twice a pair layer (remat), the contraction's backward
    kernels, and the projection's and the epilogue's backward kernels once
    a projection and once an epilogue."""
    import copy

    import numpy as np

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.nn import structure
    from genie2_tpu_torch.train import create_train_state, make_train_step
    from genie2_tpu_torch.utils.model_io import init_model
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    config = Config(overrides={"singleFeatureDimension": 64, "pairFeatureDimension": 32,
                               "numPairTransformLayers": 2, "triangularMultiplicativeHiddenDimension": 32,
                               "numStructureLayers": 2, "maximumNumResidues": 70, "numTimesteps": 100})
    state = create_train_state(randomize_zero_init(init_model(config, 0, "cpu"), 0).to(device), 1e-4)
    plain_state = copy.deepcopy(state)
    rng = np.random.default_rng(0)
    feats = []
    for length in (70, 64):
        f = create_empty_features([length])
        f["atom_positions"] = np.cumsum(rng.normal(size=(length, 3)) * 2.0, axis=0)
        feats.append(f)
    batch = to_device(batchify(feats), device)
    gen = torch.Generator(device=device).manual_seed(0)
    inject = dict(t=torch.tensor([7, 60], device=device), noise=torch.randn(2, 70, 3, generator=gen, device=device),
                  dropout_seed=3)
    step = make_train_step(Schedule.create(100, device=device), 1.0)
    profiling.reset()
    m_k = step(state, batch, **inject)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _launches().items() if v}
    saved = (trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm, structure.ipa_attention)
    trimul.project_gated_cm, trimul.contract_cm = trimul.project_gated_cm_plain, trimul.contract_cm_plain
    trimul.epilogue_cm, structure.ipa_attention = trimul.epilogue_cm_plain, ipa.ipa_attention_plain
    try:
        m_p = step(plain_state, batch, **inject)
    finally:
        trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm, structure.ipa_attention = saved
    g_k = torch.cat([p.grad.flatten() for p in state.model.parameters()])
    g_p = torch.cat([p.grad.flatten() for p in plain_state.model.parameters()])
    assert torch.isfinite(g_k).all()
    loss_k, loss_p = m_k["weighted_loss"].item(), m_p["weighted_loss"].item()
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert (g_k - g_p).abs().max().item() <= 1e-3 * g_p.abs().max().item()
    assert abs(m_k["grad_norm"].item() - m_p["grad_norm"].item()) <= 1e-4 * m_p["grad_norm"].item()
    # portbench/generators/train.py's grad_err: a weight's gap between the
    # two gradients' norms over the larger of its norm and the median's.
    norms = {n: (p.grad.norm().item(), q.grad.norm().item())
             for (n, p), q in zip(state.model.named_parameters(), plain_state.model.parameters())}
    median = float(np.median([want for _, want in norms.values()]))
    gaps = [abs(got - want) / max(want, median) for got, want in norms.values()]
    assert float(np.median(gaps)) <= 2.5e-4, float(np.median(gaps))
    assert launches == {"trimul_project": 8, "trimul_contract_out": 6, "trimul_contract_in": 6, "trimul_epilogue": 8,
                        "ipa_attention": 2, "contract_cm_km": 4, "trimul_project_backward": 4,
                        "trimul_epilogue_backward": 4}, launches


def test_two_rank_training_step_matches_one_process(device):
    """Two ranks over gloo on the one card (NCCL refuses two ranks on one
    GPU), each with two rows of a batch of four, dropout and remat on, the
    kernels launched in each: two steps' loss and metrics within 1e-5
    relative and gradients within 1e-4 of their max |entry| against one
    process on the whole batch."""
    import numpy as np

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel.spawn import run_ranks
    from genie2_tpu_torch.train import synthetic_dataset

    import torch_ranks  # tests/ is on sys.path under pytest (the rank bodies, without JAX)

    overrides = {"singleFeatureDimension": 64, "pairFeatureDimension": 32, "numPairTransformLayers": 2,
                 "triangularMultiplicativeHiddenDimension": 32, "numStructureLayers": 2, "maximumNumResidues": 70,
                 "numTimesteps": 100}
    state_dict = torch_ranks.seeded_model(Config(overrides=overrides)).state_dict()
    batch = next(synthetic_dataset(4, max_n_res=70, min_n_res=50).epoch(4, np.random.default_rng(0)))
    args = (overrides, state_dict, batch, 2, 1e-4, None)
    ranks = run_ranks(torch_ranks.train_steps, 2, (*args, True, "cuda"), deadline=300.0)
    alone, _, _ = torch_ranks.train_steps(0, *args, distributed=False, device="cuda")
    for records, _, _ in ranks:
        for (metrics, grads), (want_metrics, want_grads) in zip(records, alone):
            for k, v in want_metrics.items():
                assert abs(metrics[k] - v) <= 1e-5 * max(abs(v), 1e-6), k
            g = torch.cat([x.flatten() for x in grads.values()])
            w = torch.cat([want_grads[n].flatten() for n in grads])
            assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()



# The pair transition (ops/transition.py): its products are 3xTF32 and its
# sums run in another order than cuBLAS's float32 ones, so float32 results
# agree to a few ulps of each sum (about 5e-6 of max |plain| measured), well
# inside TOL's 1e-4.


def _transition_inputs(device, gen, b, i, n_res, n):
    """z [b, i, n_res, 128], a ragged pair mask of the rows (lengths n_res,
    n_res - 7, ...) and the six weights in torch layout, hidden 128 n."""
    c, h = 128, 128 * n

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    z = r(b, i, n_res, c)
    res = torch.stack([(torch.arange(n_res, device=device) < max(1, n_res - 7 * k)).float() for k in range(b)])
    mask = res[:, :i, None] * res[:, None, :]
    return z, mask, [r(c, scale=0.1, offset=1.0), r(c, scale=0.1), r(h, c, scale=c ** -0.5), r(h, scale=0.1),
                     r(c, h, scale=h ** -0.5), r(c, scale=0.1)]


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("b,i,n_res", [
    (4, 256, 256), (16, 128, 128),  # the benchmark's cells: 262,144 rows, whole tiles of 128
    (4, 75, 75),  # TDS's particles: 22,500 rows, the last tile ragged
    (2, 48, 96),  # a row block of sequence parallelism
])
def test_pair_transition_matches_plain(device, b, i, n_res, n):
    from genie2_tpu_torch.ops import transition

    z, mask, w = _transition_inputs(device, torch.Generator(device=device).manual_seed(n_res + n), b, i, n_res, n)
    profiling.reset()
    with torch.no_grad():
        got = transition.pair_transition(z, mask, *w)
        torch.cuda.synchronize()
        want = transition.pair_transition_plain(z, mask, *w)
    assert _launches()["pair_transition"] == 1
    assert torch.isfinite(got).all()
    _close(got, want, torch.float32)
    assert not got[mask == 0].any()  # masked pairs are exactly zero


def test_pair_transition_gradients_and_refusals(device):
    """Under autograd the kernel's Function gives the plain version's
    gradients of z and every weight (the plain gradient, recomputed, under
    genie2:recompute.pair_transition); bf16 and widths off the kernel's get
    the plain version, with no launch; the wrapper refuses tensors of
    mismatched shapes."""
    from torch.profiler import ProfilerActivity, profile

    from genie2_tpu_torch.ops import transition

    z, mask, w = _transition_inputs(device, torch.Generator(device=device).manual_seed(5), 2, 40, 40, 4)
    leaves = [z.requires_grad_(True), *(t.requires_grad_(True) for t in w)]
    cot = torch.randn(z.shape, generator=torch.Generator(device=device).manual_seed(6), device=device)
    out = transition.pair_transition(z, mask, *w)
    assert type(out.grad_fn).__name__ == "RecomputedBackward"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = torch.autograd.grad(out, leaves, cot)
    assert "genie2:recompute.pair_transition" in [e.name for e in prof.events()]
    _grad_close(got, _grads_of(lambda: transition.pair_transition_plain(z, mask, *w), leaves, cot), torch.float32)
    z, w = z.detach(), [t.detach() for t in w]
    narrow = (z[..., :64].contiguous(), mask, w[0][:64], w[1][:64], w[2][:, :64].contiguous(), w[3],
              w[4][:64].contiguous(), w[5][:64])
    profiling.reset()
    for args in ((z.bfloat16(), mask, *(t.bfloat16() for t in w)), narrow):
        assert torch.equal(transition.pair_transition(*args), transition.pair_transition_plain(*args))
    assert _launches()["pair_transition"] == 0
    with pytest.raises(ValueError, match="mask"):
        transition.pair_transition(z, mask[:, :-1], *w)


def test_pair_transition_launches_per_denoiser_call(device):
    """A float32 denoiser at c_p 128 launches the transition once a pair
    layer and call (5); a bf16 transition launches none."""
    import numpy as np

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames
    from genie2_tpu_torch.nn import Denoiser

    config = Config(overrides={"singleFeatureDimension": 64, "numStructureLayers": 1, "maximumNumResidues": 32})
    model = Denoiser.from_config(config).to(device).eval()
    feats = to_device(batchify([create_empty_features([32]) for _ in range(2)]), device)
    trans = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 32, 3)).astype(np.float32) * 8.0, device=device)
    frames = Rigid(frenet_frames(trans, feats["chain_index"], feats["residue_mask"]), trans)
    t = torch.tensor([500, 20], dtype=torch.int32, device=device)
    assert config.model["n_pair_transform_layer"] == 5 and config.model["c_p"] == 128
    with torch.no_grad():
        for calls in (1, 2):
            profiling.reset()
            for _ in range(calls):
                model(frames, t, feats)
            assert _launches()["pair_transition"] == 5 * calls
        profiling.reset()
        layer = model.pair_transform_net.net[0].pair_transition
        p = torch.randn(2, 32, 32, 128, device=device)
        layer.bfloat16()(p.bfloat16(), torch.ones(2, 32, 32, device=device, dtype=torch.bfloat16))
    assert _launches()["pair_transition"] == 0
