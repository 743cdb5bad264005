"""genie2_tpu_torch's standalone triangle contractions against genie2_tpu.

`triangle_multiply` (both layouts, both directions; the plain version on
the CPU) against genie2_tpu.ops.triangle_multiply with its Pallas kernels
run through the interpreter and against `triangle_multiply_reference`;
`contract_cm_km` against `contract_cm_fullk_km`. fp32, within 5e-6 of
max |reference| (the sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.ops.triangle as jtri
from genie2_tpu.ops.trimul_fused import contract_cm_fullk_km
from genie2_tpu_torch.ops import triangle, trimul
from genie2_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

B, N, C = 2, 64, 16
RTOL = 5e-6


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, N, N, C)).astype(np.float32) * 0.3
    b = rng.normal(size=(B, N, N, C)).astype(np.float32) * 0.3
    return a, b


@pytest.mark.parametrize("layout", ["cm", "nlayout"])
@pytest.mark.parametrize("outgoing", [True, False])
def test_triangle_multiply_matches_pallas(layout, outgoing):
    a, b = _operands()
    want = np.asarray(jtri.triangle_multiply(
        jnp.asarray(a), jnp.asarray(b), outgoing=outgoing, use_pallas=True, interpret=True, layout=layout))
    ref = np.asarray(jtri.triangle_multiply_reference(jnp.asarray(a), jnp.asarray(b), outgoing))
    got = triangle.triangle_multiply(torch.tensor(a), torch.tensor(b), outgoing, layout)
    assert got.is_contiguous() and got.shape == (B, N, N, C)
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - want).max() <= RTOL * scale
    assert np.abs(got.numpy() - ref).max() <= RTOL * scale
    plain = triangle.triangle_multiply_reference(torch.tensor(a), torch.tensor(b), outgoing).numpy()
    assert np.abs(plain - ref).max() <= RTOL * scale


def test_contract_cm_km_matches_pallas():
    a, b = _operands(1)
    a_cm = np.ascontiguousarray(a.transpose(0, 3, 1, 2))  # [B, C, i, k]
    b_km = np.ascontiguousarray(b.transpose(0, 3, 1, 2))  # [B, C, k, j]
    want = np.asarray(contract_cm_fullk_km(jnp.asarray(a_cm), jnp.asarray(b_km), interpret=True))
    got = trimul.contract_cm_km(torch.tensor(a_cm), torch.tensor(b_km)).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    plain = trimul.contract_cm_km_plain(torch.tensor(a_cm), torch.tensor(b_km)).numpy()
    assert np.abs(plain - want).max() <= RTOL * np.abs(want).max()


def test_directions_and_km_agree_with_contract_cm():
    """The three contractions are one sum over k with other strides."""
    a, b = _operands(2)
    ta, tb = torch.tensor(a), torch.tensor(b)
    a_cm, b_cm = ta.permute(0, 3, 1, 2).contiguous(), tb.permute(0, 3, 1, 2).contiguous()
    for outgoing in (True, False):
        want = trimul.contract_cm_plain(a_cm, b_cm, outgoing).permute(0, 2, 3, 1)
        torch.testing.assert_close(triangle.triangle_multiply(ta, tb, outgoing), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        trimul.contract_cm_km(a_cm, b_cm.transpose(-1, -2).contiguous()),
        trimul.contract_cm_plain(a_cm, b_cm, True), rtol=1e-5, atol=1e-5,
    )


def test_wrappers_count_nothing_on_cpu_and_check_arguments():
    a, b = (torch.tensor(x) for x in _operands(3))
    reset_launch_counts()
    triangle.triangle_multiply(a, b, True, "nlayout")
    trimul.contract_cm_km(a.permute(0, 3, 1, 2).contiguous(), b.permute(0, 3, 1, 2).contiguous())
    assert all(v == 0 for v in LAUNCHES.values())
    with pytest.raises(ValueError, match="layout"):
        triangle.triangle_multiply(a, b, True, "rowmajor")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        triangle.triangle_multiply(a.to("meta"), b.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        trimul.contract_cm_km(a.to("meta"), b.to("meta"))
