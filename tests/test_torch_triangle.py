"""genie2_tpu_torch's standalone triangle contractions against genie2_tpu.

`triangle_multiply` (both layouts, both directions; the plain version on
the CPU) against genie2_tpu.ops.triangle_multiply with its Pallas kernels
run through the interpreter and against `triangle_multiply_reference`;
`contract_cm_km` against `contract_cm_fullk_km`. fp32, within 5e-6 of
max |reference| (the sums run in another order).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.ops.triangle as jtri
from genie2_tpu.ops.trimul_fused import contract_cm_fullk_km
from genie2_tpu_torch.ops import triangle, trimul
from genie2_tpu_torch.utils import profiling

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
        jnp.asarray(a), jnp.asarray(b), outgoing=outgoing, interpret=True, layout=layout))
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
    profiling.reset()
    triangle.triangle_multiply(a, b, True, "nlayout")
    trimul.contract_cm_km(a.permute(0, 3, 1, 2).contiguous(), b.permute(0, 3, 1, 2).contiguous())
    assert all(v == 0 for k, v in profiling.counters().items() if k.startswith("launch."))
    with pytest.raises(ValueError, match="layout"):
        triangle.triangle_multiply(a, b, True, "rowmajor")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        triangle.triangle_multiply(a.to("meta"), b.to("meta"))
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        trimul.contract_cm_km(a.to("meta"), b.to("meta"))


# --------------------------------------------------------------------- #
# csrc/triangle_contract.cu's index algebra, emulated on the CPU
# --------------------------------------------------------------------- #

_CSRC = os.path.join(os.path.dirname(triangle.__file__), "..", "csrc")


def _chan_constants(type_name):
    """VEC, BK, RS, MT, WARPS_M of `Chan<type_name>` in triangle_contract.cu."""
    with open(os.path.join(_CSRC, "triangle_contract.cu")) as fh:
        text = fh.read()
    body = re.search(r"struct Chan<%s> \{(.*?)\};" % re.escape(type_name), text, re.S).group(1)
    env = {}
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);", body):
        env[name] = eval(expr, {}, dict(env))
    return env


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes y:x."""
    both = (int(y) << 32) | int(x)
    return sum(((both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


@pytest.mark.parametrize("dtype", ["float", "__nv_bfloat16"])
def test_channel_variant_fragments_and_banks(dtype):
    """Variant 2 stages A and B as [row][k] 16-byte chunks of VEC channels,
    rows RS chunks apart. A lane's chunk loads at the kernel's indices,
    split by channel (float32: word c; bf16: the halves of word c / 2 packed
    by __byte_perm into (k even, k odd)), give each channel's mma.sync
    fragments of the PTX layouts; the eight lanes of every quarter-warp
    load hit distinct 16-byte bank groups."""
    k = _chan_constants(dtype)
    vec, bk, rs = k["VEC"], k["BK"], k["RS"]
    rows = 32
    # Element (row, kk, channel) holds a distinct value; the stage is a flat
    # array of chunks, chunk row * RS + kk.
    vals = np.arange(rows * bk * vec).reshape(rows, bk, vec)
    smem = np.full((rows * rs, vec), -1)
    for r in range(rows):
        smem[r * rs:r * rs + bk] = vals[r]
    phases = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        r0, r1 = g * rs, (g + 8) * rs  # the kernel's row pointers (wm + m * 16 = 0)
        if dtype == "float":
            # TF32 m16n8k8 a: (g, t) (g+8, t) (g, t+4) (g+8, t+4); b: (k t, n g) (k t+4, n g)
            loads = [smem[r0 + t], smem[r1 + t], smem[r0 + t + 4], smem[r1 + t + 4]]
            want = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]
            for c in range(vec):
                assert [q[c] for q in loads] == [vals[r, kk, c] for r, kk in want], (lane, c)
            b_loads, b_want = [smem[r0 + t], smem[r0 + t + 4]], [(g, t), (g, t + 4)]
            for c in range(vec):
                assert [q[c] for q in b_loads] == [vals[r, kk, c] for r, kk in b_want]
            offsets = [(r0, t), (r1, t), (r0, t + 4), (r1, t + 4)]
        else:
            # bf16 m16n8k16 a: (g, 2t..) (g+8, 2t..) (g, 2t+8..) (g+8, 2t+8..), k pairs
            offsets = [(r0, 2 * t + h) for h in (0, 1)] + [(r1, 2 * t + h) for h in (0, 1)]
            for e, (rp, kk) in enumerate([(r0, 2 * t), (r1, 2 * t), (r0, 2 * t + 8), (r1, 2 * t + 8)]):
                even, odd = smem[rp + kk], smem[rp + kk + 1]
                words = lambda q: [int(q[2 * w]) | (int(q[2 * w + 1]) << 16) for w in range(4)]
                w_even, w_odd = words(even), words(odd)
                row = (g if rp == r0 else g + 8)
                for c in range(vec):
                    packed = _byte_perm(w_even[c >> 1], w_odd[c >> 1], 0x7632 if c & 1 else 0x5410)
                    assert packed == int(vals[row, kk, c]) | (int(vals[row, kk + 1, c]) << 16), (lane, e, c)
        phases.append([r + kk for r, kk in offsets])
    # Each load instruction: lanes 0-7, 8-15, ... are one phase of 8 chunks.
    for i in range(len(phases[0])):
        for q in range(4):
            chunks = [phases[lane][i] for lane in range(8 * q, 8 * q + 8)]
            assert len({ch % 8 for ch in chunks}) == 8, (i, chunks)


def _tile_constants():
    with open(os.path.join(_CSRC, "contract_tile.cuh")) as fh:
        text = fh.read()
    return {n: int(v) for n, v in re.findall(r"\b(BM|BN|BK|STAGES) = (\d+)", text)}


def _emulate_triangle_contract(a, b, out, dims, sa, sb, so, variant):
    """The C entry's work, tile by tile, on CPU tensors: every operand read
    and the result written through the element strides the wrapper passes.
    Variants 0 and 1 stage A [row][k] and B [row][k] (0) or [k][row] (1) in
    BM x BK tiles, zero past N; variant 2 reads 16-byte groups of channels
    of TM x TN tiles."""
    B, C, N = dims
    if variant in (0, 1):
        assert sa[3] == 1 and (sb[3] if variant == 0 else sb[2]) == 1 or N == 1
        t = _tile_constants()
        tm, tn, tk = t["BM"], t["BN"], t["BK"]
        cg = 1
    else:
        k = _chan_constants("float" if a.dtype == torch.float32 else "__nv_bfloat16")
        tm, tn, tk = k["WARPS_M"] * k["MT"] * 16, (8 // k["WARPS_M"]) * 2 * 8, k["BK"]
        cg = k["VEC"]
    pad = lambda n, m: (n + m - 1) // m * m
    np_, kp_ = pad(N, max(tm, tn)), pad(N, tk)
    full = lambda t, s: torch.as_strided(t, (B, C, N, N), s).float()
    A = torch.zeros(B, C, np_, kp_)
    Bm = torch.zeros(B, C, np_, kp_)
    A[:, :, :N, :N] = full(a, sa)
    Bm[:, :, :N, :N] = full(b, sb)
    x = torch.zeros(B, C, np_, np_)
    for i0 in range(0, N, tm):
        for j0 in range(0, N, tn):
            for k0 in range(0, N, tk):  # one stage
                x[:, :, i0:i0 + tm, j0:j0 + tn] += A[:, :, i0:i0 + tm, k0:k0 + tk] @ Bm[:, :, j0:j0 + tn, k0:k0 + tk].transpose(-1, -2)
    for c0 in range(0, C, cg):  # the group's channels past C are not stored
        view = torch.as_strided(out, (B, min(cg, C - c0), N, N), so, out.storage_offset() + c0 * so[1])
        view.copy_(x[:, c0:c0 + cg, :N, :N].to(out.dtype))


@pytest.mark.parametrize("n,c", [(1, 5), (17, 24), (70, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_strides_drive_the_emulated_kernel(monkeypatch, n, c, dtype):
    """Both layouts, both directions and contract_cm_km through their card
    path, the kernel replaced by its emulation: the strides the wrappers
    pass (the model layout's for variant 2, the channel-major copies' for
    variant 0, k-major B for variant 1) give the plain results, at N of 1,
    off 16 and off 64, and C off the channel group."""
    calls = []

    def fake(a, b, out, dims, sa, sb, so, variant):
        calls.append(variant)
        _emulate_triangle_contract(a, b, out, dims, sa, sb, so, variant)

    monkeypatch.setattr(triangle, "on_cpu", lambda t: False)
    monkeypatch.setattr(triangle, "launch_triangle_contract", fake)
    monkeypatch.setattr(trimul, "_on_cpu", lambda t: False)
    monkeypatch.setattr(trimul, "launch_triangle_contract", fake)
    rng = np.random.default_rng(n + c)
    a, b = (torch.tensor(rng.normal(size=(2, n, n, c)).astype(np.float32) * 0.3).to(dtype) for _ in range(2))
    tol = 5e-6 if dtype == torch.float32 else 1e-2
    for outgoing in (True, False):
        want = triangle.triangle_multiply_reference(a, b, outgoing).float()
        for layout in triangle.LAYOUTS:
            got = triangle.triangle_multiply(a, b, outgoing, layout)
            assert got.shape == want.shape and got.is_contiguous()
            assert (got.float() - want).abs().max() <= tol * want.abs().max().clamp_min(1e-6)
    a_cm, b_km = a.permute(0, 3, 1, 2).contiguous(), b.permute(0, 3, 1, 2).contiguous()
    want = trimul.contract_cm_km_plain(a_cm, b_km).float()
    got = trimul.contract_cm_km(a_cm, b_km)
    assert (got.float() - want).abs().max() <= tol * want.abs().max().clamp_min(1e-6)
    assert calls == [0, 2, 0, 2, 1]
