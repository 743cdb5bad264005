"""The tensor-parallel TriMul epilogue's plain versions against genie2_tpu.

Under a model axis each rank runs `epilogue_partial` on its share of the
hidden channels, the ranks' partial sums are all-reduced, and
`epilogue_finish` completes the epilogue (nn/pair_stack.py). Here the plain
versions of the two stages, over 2 and 4 channel splits summed as the
all-reduce sums them, are held against genie2_tpu's Pallas epilogue
(`ops/trimul_fused.py:epilogue_cm`, interpret mode) and against the
one-stage plain version `epilogue_cm_plain`: float32 within 1e-5 of max,
bf16 activations and weights within 3e-2 of max (one bf16 ulp where a value
rounds the other way). N is a multiple of 16, as the Pallas kernel's row
block needs, and H = C, as its z block does. `split_part` of the summed
buffer gives the reduced weight sums and column sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.ops import trimul_fused as jfused
from genie2_tpu_torch.ops import trimul

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed: int, B: int, N: int, C: int, H: int):
    """x [B,H,N,N], z [B,N,N,C] and the epilogue's weights in torch's
    Linear layout, float32 numpy arrays made from `seed`."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0, offset=0.0):
        return (offset + scale * rng.normal(size=shape)).astype(np.float32)

    w = {"ln_in_scale": r(C, scale=0.1, offset=1.0), "ln_in_bias": r(C, scale=0.1),
         "ln_out_scale": r(H, scale=0.1, offset=1.0), "ln_out_bias": r(H, scale=0.1),
         "w_z": r(C, H, scale=H ** -0.5), "b_z": r(C, scale=0.1), "w_g": r(C, C, scale=C ** -0.5),
         "b_g": r(C, scale=0.1)}
    return r(B, H, N, N), r(B, N, N, C), w


def _summed_partials(x: torch.Tensor, w: dict, splits: int) -> torch.Tensor:
    """Each of `splits` ranks' partial sums over its slice of the hidden
    channels, summed in rank order."""
    h = x.shape[1] // splits
    return sum(trimul.epilogue_partial_plain(x[:, sl], w["w_z"][:, sl], w["ln_out_scale"][sl], w["ln_out_bias"][sl])
               for sl in (slice(r * h, (r + 1) * h) for r in range(splits)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("B,N,C,H", [(2, 32, 16, 16), (1, 48, 32, 32)])
def test_split_epilogue_matches_pallas_and_one_stage(dtype, splits, B, N, C, H):
    x, z, w = _inputs(B + N + splits, B, N, C, H)
    tx, tz = torch.tensor(x).to(dtype), torch.tensor(z).to(dtype)
    tw = {k: torch.tensor(v).to(dtype) for k, v in w.items()}
    part = _summed_partials(tx, tw, splits)
    assert part.dtype == torch.float32 and part.shape == (trimul.part_size(B, N, C),)
    got = trimul.epilogue_finish_plain(part, tz, *(tw[k] for k in trimul.FINISH_PARAMS), H).float().numpy()
    one_stage = trimul.epilogue_cm_plain(tx, tz, tw).float().numpy()
    # genie2_tpu's kernel takes flax's [in, out] layout; the same values
    # rounded to the activation dtype as torch rounds them.
    jdt = JAX_DTYPE[dtype]
    jw = {k: jnp.asarray(v.T if k in ("w_z", "w_g") else v).astype(jdt) for k, v in w.items()}
    pallas = np.asarray(jfused.epilogue_cm(jnp.asarray(x).astype(jdt), jnp.asarray(z).astype(jdt), jw,
                                           interpret=True).astype(jnp.float32))
    scale = np.abs(pallas).max()
    assert np.abs(got - pallas).max() <= TOL[dtype] * scale
    assert np.abs(got - one_stage).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("splits", [2, 4])
def test_summed_part_holds_the_reduced_sums(splits):
    """The summed buffer, split by `split_part`: per position the column sums
    of x and x^2 over all H channels, and the weight sums over all H that
    the finish stage reads as u and vb (`fold_ln_out`'s, less b_z), float32
    within 1e-5 of max."""
    B, N, C, H = 2, 32, 16, 16
    x, z, w = _inputs(splits, B, N, C, H)
    tx = torch.tensor(x)
    tw = {k: torch.tensor(v) for k, v in w.items()}
    per_pos, sums = trimul.split_part(_summed_partials(tx, tw, splits), B, N, C)
    _, u, vb = trimul.fold_ln_out(tw, torch.float32)
    for got, want in ((sums[0], u), (sums[1], vb - tw["b_z"]), (per_pos[..., C], tx.sum(1)),
                      (per_pos[..., C + 1], tx.square().sum(1))):
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ------------------------------------------------------------------ #
# The split kernels' index algebra (csrc/trimul_epilogue.cu), emulated
# ------------------------------------------------------------------ #


def _channel_of_row(r: int) -> int:
    """csrc/trimul_epilogue.cu:channel_of_row: bits 2 and 4 swapped."""
    return (r & ~0x14) | ((r >> 2 & 1) << 4) | ((r >> 4 & 1) << 2)


def _row_of_slot(m: int) -> int:
    """csrc/trimul_epilogue.cu:row_of_slot: each 16-row half transposed as 4 x 4."""
    return (m & ~15) | ((m & 3) << 2) | ((m >> 2) & 3)


@pytest.mark.parametrize("D", [128, 200, 33])
def test_partial_channel_order_gives_the_plain_tile(D):
    """The partial kernel computes ws . x with its weight rows in
    channel_of_row order and writes lane (g, t)'s accumulators of m16 tile
    mt to the output tile [32][D + 2] at row 8 n + 2 t + e, channel
    channel_of_row(16 mt + g + 8 h): emulated in torch for one tile of 32
    positions, that gives epilogue_partial_plain's span, every channel of
    every row once; rows past D are zero weights, never stored."""
    rng = np.random.default_rng(D)
    H, TJ = 24, 32
    DW = (D + 31) // 32 * 32
    x = torch.tensor(rng.normal(size=(1, H, 1, TJ)).astype(np.float32))
    w_z = torch.tensor(rng.normal(size=(D, H)).astype(np.float32))
    s, o = torch.ones(H), torch.zeros(H)
    want = trimul.split_part(trimul.epilogue_partial_plain(x, w_z, s, o), 1, TJ, D, 1)[0][0, 0]  # [TJ, D + 2]
    order = [_channel_of_row(r) for r in range(DW)]
    assert sorted(order) == list(range(DW)) and all(_channel_of_row(c) == r for r, c in enumerate(order))
    weight = torch.stack([w_z[c] if c < D else torch.zeros(H) for c in order])
    acc = weight @ x[0, :, 0, :]  # [weight rows, positions]
    tile = torch.full((TJ, D + 2), float("nan"))
    for mt in range(DW // 16):
        for g in range(8):
            for h in range(2):
                r = 16 * mt + g + 8 * h
                if order[r] < D:
                    assert torch.isnan(tile[:, order[r]]).all()  # each channel once
                    tile[:, order[r]] = acc[r]
    np.testing.assert_allclose(tile[:, :D].numpy(), want[:, :D].numpy(), rtol=1e-5, atol=1e-5)


def test_split_kernels_index_orders_avoid_bank_conflicts():
    """At the main path's D = 128 (a span row of 130 floats): each 4-byte
    store of the partial's output tile (one instruction per n, h, e for a
    warp of 8 g x 4 t lanes) hits 32 distinct banks, and each half-warp
    phase of the finish's 8-byte reads of the span (lanes g = 0..3 or 4..7,
    rows wm + row_of_slot(g + 8 h)) hits 16 distinct bank pairs; the plain
    row order (row g) would not. row_of_slot is its own inverse, so the
    producers stage row r into slot row_of_slot(r)."""
    LD = 130
    assert all(_row_of_slot(_row_of_slot(m)) == m for m in range(32))
    for mt in range(8):
        for n in range(4):
            for h in range(2):
                for e in range(2):
                    banks = {((8 * n + 2 * t + e) * LD + _channel_of_row(16 * mt + g + 8 * h)) % 32
                             for g in range(8) for t in range(4)}
                    assert len(banks) == 32

    def pairs(row_of):
        return {(row_of(g) * LD + 8 * n + 2 * t) // 2 % 16 for g in range(4) for t in range(4)}

    for wm in (0, 16):
        for n in range(4):
            for h in range(2):
                for half in (0, 4):
                    assert len(pairs(lambda g: wm + _row_of_slot(half + g + 8 * h))) == 16
    assert len(pairs(lambda g: g)) < 16
