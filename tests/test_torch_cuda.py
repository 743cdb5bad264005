"""genie2_tpu_torch's TriMul kernels against their plain versions on the card.

Marked `cuda`; each test skips where torch sees no CUDA device (decided
inside the test, so every worker collects the same tests). On a machine
with a card:  python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pytest
import torch

from genie2_tpu_torch.ops import trimul

pytestmark = pytest.mark.cuda

# Relative to max |plain|: float32 sums in another order; bfloat16 values on
# a rounding boundary can land one bf16 ulp apart.
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _weights(C, H, gen, device):
    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    w = {f"w_{k}": r(H, C, scale=C ** -0.5) for k in ("ap", "ag", "bp", "bg")}
    w.update({f"b_{k}": r(H, scale=0.1) for k in ("ap", "ag", "bp", "bg")})
    w.update(ln_in_scale=r(C, scale=0.1, offset=1.0), ln_in_bias=r(C, scale=0.1),
             ln_out_scale=r(H, scale=0.1, offset=1.0), ln_out_bias=r(H, scale=0.1),
             w_z=r(C, H, scale=H ** -0.5), b_z=r(C, scale=0.1), w_g=r(C, C, scale=C ** -0.5), b_g=r(C, scale=0.1))
    return w


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,weight_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                                                (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("n,c,h", [(96, 32, 32), (70, 48, 40)])
@pytest.mark.parametrize("outgoing", [True, False])
def test_kernels_match_plain(device, dtype, weight_dtype, n, c, h, outgoing):
    """bf16 weights (the bf16 policy) make the wrappers convert every weight
    to a float32 temporary, which must live until its kernel has read it."""
    gen = torch.Generator(device=device).manual_seed(n + c)
    w = {k: v.to(weight_dtype) for k, v in _weights(c, h, gen, device).items()}
    z = torch.randn(2, n, n, c, generator=gen, device=device).to(dtype)
    res_mask = (torch.arange(n, device=device) < n - 5).float().expand(2, n).contiguous()
    trimul.reset_launch_counts()
    a, b = trimul.project_gated_cm(z, res_mask, w)
    a_p, b_p = trimul.project_gated_cm_plain(z, res_mask, w)
    _close(a, a_p, dtype)
    _close(b, b_p, dtype)
    _close(trimul.contract_cm(a_p, b_p, outgoing), trimul.contract_cm_plain(a_p, b_p, outgoing), dtype)
    x_p = trimul.contract_cm_plain(a_p, b_p, outgoing)
    _close(trimul.epilogue_cm(x_p, z, w), trimul.epilogue_cm_plain(x_p, z, w), dtype)
    torch.cuda.synchronize()
    assert trimul.LAUNCHES["trimul_project"] == 1 and trimul.LAUNCHES["trimul_epilogue"] == 1
    assert trimul.LAUNCHES["trimul_contract_out" if outgoing else "trimul_contract_in"] == 1


def test_wrapper_rejects_bad_input(device):
    w = _weights(16, 8, torch.Generator(device=device).manual_seed(0), device)
    z = torch.randn(1, 8, 8, 16, device=device)
    with pytest.raises(TypeError):
        trimul.project_gated_cm(z.half(), torch.ones(1, 8, device=device), w)
    with pytest.raises(ValueError):
        trimul.contract_cm(z[..., :8].permute(0, 3, 1, 2), z[..., :8].permute(0, 3, 1, 2))
