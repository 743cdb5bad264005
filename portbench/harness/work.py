"""The yardstick of work: operations and bytes of a layer from its shapes,
and the peaks they are held against.

Operations are the layer's multiply-adds of its products, counted as two
each; elementwise work (norms, gates, softmax) is not counted. Bytes are the
layer's inputs read once and its outputs written once, weights included,
whatever its kernels read again or write in between. A layer's least time is
the larger of operations over the peak rate and bytes over the bandwidth,
so its share of that bound cannot pass 100% for a program that does the
layer's work.

The kernel counts these sum: a TriMul module's operations are those of
genie2_tpu_torch's three kernels (projection 2 N^2 C 4H, contraction
2 H N^3, epilogue 2 N^2 (HC + C^2) a sample); the triangle attention
kernel's 4 H N^3 c are the core of `tri_att`; the IPA kernel's
2 H N^2 (2c + 3Pq + 3Pv + Cz) the core of `ipa`.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Published dense rates of one NVIDIA H100 SXM (data sheet, at 700 W): the
# tensor-core format that each configuration dtype maps to (float32 to TF32,
# which no float32-accurate method can beat), and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def bound_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time of a layer on the card."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def trimul(B: int, N: int, C: int, H: int, esize: int) -> Tuple[float, float]:
    """A triangle multiplicative update on z [B, N, N, C] with hidden width
    H: LN_in, four projections C -> H, the contraction over k, LN_out, the
    output C <- H and the gate C -> C."""
    pair = B * N * N
    ops = 2 * pair * (4 * C * H + H * C + C * C) + 2 * B * H * N ** 3
    weights = 4 * (4 * H * C + 4 * H + 2 * C + 2 * H + H * C + C + C * C + C)
    return ops, 2 * pair * C * esize + 4 * B * N + weights


def tri_att(B: int, N: int, C: int, H: int, c: int, esize: int) -> Tuple[float, float]:
    """A triangle attention on x [B, N, N, C] with H heads of width c: the
    bias C -> H, q, k, v and the gate C -> Hc, q.k and p.v over each row's
    N keys for N^2 queries, the output Hc -> C; the pair mask read."""
    pair = B * N * N
    ops = 2 * pair * (C * H + 4 * C * H * c + H * c * C) + 4 * B * H * N ** 3 * c
    weights = 4 * (2 * C + C * H + 4 * C * H * c + H * c + H * c * C + C)
    return ops, 2 * pair * C * esize + 4 * pair + weights


def ipa(B: int, N: int, cs: int, cz: int, H: int, c: int, pq: int, pv: int, esize: int) -> Tuple[float, float]:
    """Invariant point attention of s [B, N, cs] over z [B, N, N, cz]: the
    projections of q, k, v and their points, the pair bias cz -> H, the core
    (q.k, the point distances, p.v, p.v_pts, p.z over N keys) and the output
    H (cz + c + 4 Pv) -> cs; frames and the mask read."""
    rows = B * N
    proj = cs * (3 * H * c + 3 * H * pq + 3 * H * (pq + pv))
    out_in = H * (cz + c + 4 * pv)
    ops = 2 * rows * (proj + out_in * cs) + 2 * B * N * N * cz * H + 2 * B * H * N * N * (2 * c + 3 * pq + 3 * pv + cz)
    weights = 4 * (proj + 3 * H * c + 3 * H * pq + 3 * H * (pq + pv) + cz * H + H + out_in * cs + cs + H)
    return ops, esize * (2 * rows * cs + B * N * N * cz) + 4 * rows * (12 + 1) + weights


def denoiser_ops(c: Dict, B: int, N: int, static: bool = True) -> float:
    """Operations of one denoiser forward at batch B and N residues, from
    the configuration's sizes (the reference's key names); `static` counts
    the step-invariant pair bias (relative positions and motif template),
    which the samplers compute once a batch."""
    cs, cp = c["singleFeatureDimension"], c["pairFeatureDimension"]
    rows, pair = B * N, B * N * N
    c_in = c["positionalEmbeddingDimension"] + c["chainEmbeddingDimension"] + c["timestepEmbeddingDimension"] + 23
    ops = 2 * rows * c_in * cs + 2 * 2 * rows * cs * cp + 2 * pair * (c["templateDistanceNumBins"] + 6) * cp
    if static:
        ops += 2 * pair * (2 * c["relativePositionK"] + 3 + c["templateDistanceNumBins"] + 2) * cp
    layer = 16 * pair * cp * cp * c["pairTransitionN"] / 4
    if c["includeTriangularMultiplicativeUpdate"]:
        layer += 2 * trimul(B, N, cp, c["triangularMultiplicativeHiddenDimension"], 4)[0]
    if c["includeTriangularAttention"]:
        layer += 2 * tri_att(B, N, cp, c["triangularAttentionNumHeads"], c["triangularAttentionHiddenDimension"], 4)[0]
    ops += c["numPairTransformLayers"] * layer
    structure = ipa(B, N, cs, cp, c["ipaNumHeads"], c["ipaHiddenDimension"], c["ipaNumQkPoints"],
                    c["ipaNumVPoints"], 4)[0]
    structure += c["numStructureTransitionLayers"] * 3 * 2 * rows * cs * cs + 2 * rows * cs * 6
    return ops + c["numStructureLayers"] * c["numStructureBlocks"] * structure
