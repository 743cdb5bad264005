"""The yardstick's counts of operations and bytes against hand-worked
formulas at small shapes, and the reduction of a trace to device seconds by
range."""

import pytest

from portbench.harness import tracing, work


def test_trimul_counts():
    # B=1, N=2, C=3, H=2: projections 4 x (4 positions x 3 x 2) = 96 MACs,
    # contraction 2 x 2^3 = 16, output 4 x 2 x 3 = 24, gate 4 x 3 x 3 = 36.
    ops, nbytes = work.trimul(1, 2, 3, 2, 4)
    assert ops == 2 * (96 + 16 + 24 + 36)
    weights = 4 * (4 * 6 + 4 * 2 + 2 * 3 + 2 * 2 + 6 + 3 + 9 + 3)
    assert nbytes == 4 * 4 * 3 * 2 + 4 * 2 + weights


def test_tri_att_counts():
    # B=1, N=2, C=4, H=1, c=2: bias 4 x 4 = 16, q k v g 4 x (4 x 4 x 2) = 128,
    # q.k and p.v 2 x (2 rows x 2 queries x 2 keys x 2) = 32, output 4 x 2 x 4 = 32.
    ops, nbytes = work.tri_att(1, 2, 4, 1, 2, 4)
    assert ops == 2 * (16 + 128 + 32 + 32)
    weights = 4 * (2 * 4 + 4 + 4 * 4 * 2 + 2 + 2 * 4 + 4)
    assert nbytes == 2 * 4 * 4 * 4 + 4 * 4 + weights


def test_ipa_counts():
    # B=1, N=2, cs=3, cz=2, H=1, c=2, Pq=1, Pv=1:
    # q, kv: 2 x 3 x (2 + 4) = 36; points: 2 x 3 x (3 + 6) = 54; pair bias
    # 4 pairs x 2 = 8; core 4 pairs x (2 + 2 + 3 + 3 + 2) = 48; output
    # 2 x (2 + 2 + 4) x 3 = 48.
    ops, nbytes = work.ipa(1, 2, 3, 2, 1, 2, 1, 1, 4)
    assert ops == 2 * (36 + 54 + 8 + 48 + 48)
    proj = 3 * (6 + 3 + 6)
    weights = 4 * (proj + 6 + 3 + 6 + 2 + 1 + 8 * 3 + 3 + 1)
    assert nbytes == 4 * (2 * 2 * 3 + 4 * 2) + 4 * 2 * 13 + weights


def test_denoiser_ops_adds_its_layers():
    from conftest import TINY
    from portbench.reference.genie2 import sizes

    c = sizes(TINY)
    B, N = 2, 8
    with_tri = dict(c, includeTriangularAttention=True)
    extra = 2 * c["numPairTransformLayers"] * work.tri_att(B, N, 16, 2, 4, 4)[0]
    assert work.denoiser_ops(with_tri, B, N) - work.denoiser_ops(c, B, N) == extra
    static = 2 * B * N * N * (2 * 4 + 3 + 37 + 2) * 16
    assert work.denoiser_ops(c, B, N) - work.denoiser_ops(c, B, N, static=False) == static


def test_bound_is_the_larger_of_compute_and_memory():
    assert work.bound_seconds(495e12, 0, "float32") == pytest.approx(1.0)
    assert work.bound_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def test_reduce_trace_attributes_by_launch():
    events = [
        ev("user_annotation", "pb:window", 0, 100),
        ev("user_annotation", "pb:step", 1, 60),
        ev("user_annotation", "pb:TriangleMultiplicativeUpdate", 2, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
        ev("cpu_op", "aten::mm", 12, 5),
        ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=2),
        # The backward on a thread of its own.
        ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 20, 10, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2, corr=3),
        ev("kernel", "trimul_contract", 10, 20, tid=7, corr=1),
        ev("kernel", "gemm", 30, 10, tid=7, corr=2),
        ev("kernel", "gemm_bwd", 50, 10, tid=7, corr=3),
        ev("kernel", "orphan", 70, 5, tid=7, corr=99),
    ]
    tr = tracing.reduce_trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(45e-6) and tr.device_s == pytest.approx(45e-6)
    assert tr.by_range["pb:TriangleMultiplicativeUpdate"] == pytest.approx(20e-6)
    assert tr.by_range["pb:step"] == pytest.approx(30e-6)
    assert tr.by_range["backward"] == pytest.approx(10e-6)
    assert tr.unattributed_s == pytest.approx(5e-6)
    assert tr.by_op["gemm"] == pytest.approx(10e-6)
    assert sum(tr.idle_by_host.values()) == pytest.approx(55e-6)
    assert tr.idle_by_host["pb:step"] == pytest.approx(10e-6)  # the gap 40-50 lies inside pb:step


def test_open_ranges_nested():
    ranges = [(0, 10, "a"), (1, 4, "b"), (2, 3, "c"), (5, 9, "d")]
    got = tracing.open_ranges(ranges, [2.5, 4.5, 6, 11])
    assert [[r[2] for r in rs] for rs in got] == [["a", "b", "c"], ["a"], ["a", "d"], []]
