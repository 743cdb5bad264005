"""The program's own spans and counters as the benchmark reads them
(harness/program_spans.py and the readers host_syncs.sample,
host_syncs.train and recompute_backward_share.train): the trace's reduction
keeps "genie2:" ranges beside its own and reads its own as before; each
reader returns its value on a synthetic run and None for the control."""

import sys
from types import ModuleType, SimpleNamespace

import pytest

from test_portbench_work import ev

from portbench.harness import program_spans, registry, tracing

EVENTS = [
    ev("user_annotation", "pb:window", 0, 100),
    ev("user_annotation", "pb:step", 1, 60),
    ev("user_annotation", "pb:TriangleMultiplicativeUpdate", 2, 10),
    ev("cuda_runtime", "cudaLaunchKernel", 3, 1, corr=1),
    ev("cpu_op", "aten::mm", 12, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=2),
    ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 20, 10, tid=2),
    ev("cuda_runtime", "cudaLaunchKernel", 21, 1, tid=2, corr=3),
    ev("kernel", "trimul_contract", 10, 20, tid=7, corr=1),
    ev("kernel", "gemm", 30, 10, tid=7, corr=2),
    ev("kernel", "gemm_bwd", 50, 10, tid=7, corr=3),
    ev("kernel", "orphan", 70, 5, tid=7, corr=99),
]
PROGRAM = [
    ev("user_annotation", "genie2:trimul", 2.5, 9),
    ev("user_annotation", "genie2:recompute.project_gated_cm", 20.5, 5, tid=2),
]


def test_reduce_trace_keeps_program_spans_beside_its_own():
    program_spans.keep_program_spans()
    program_spans.keep_program_spans()  # once is enough; twice changes nothing
    plain, both = tracing.reduce_trace(EVENTS), tracing.reduce_trace(EVENTS + PROGRAM)
    assert {k: v for k, v in both.by_range.items() if not k.startswith("genie2:")} == plain.by_range
    assert both.by_range["genie2:trimul"] == pytest.approx(20e-6)
    assert both.by_range["genie2:recompute.project_gated_cm"] == pytest.approx(10e-6)
    assert (both.device_s, both.busy_s, both.unattributed_s) == (plain.device_s, plain.busy_s, plain.unattributed_s)
    # The gap 0-10 now lies in the innermost range, the program's.
    assert both.idle_by_host["genie2:trimul"] == pytest.approx(plain.idle_by_host["pb:TriangleMultiplicativeUpdate"])


class FakeProgram(ModuleType):
    def __init__(self):
        super().__init__(program_spans.COUNTERS_MODULE)
        self.values = {"host_sync.eigh_status": 5, "launch.trimul_project": 2, "allreduce_bytes.tp.forward": 0}

    def counters(self):
        return dict(self.values)


def run_of(trace_steps=2, trace=None):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"trace_steps": trace_steps}), trace=trace)


@pytest.mark.parametrize("name", ["host_syncs.sample", "host_syncs.train"])
def test_host_syncs_a_traced_step(monkeypatch, name):
    program = FakeProgram()
    monkeypatch.setitem(sys.modules, program_spans.COUNTERS_MODULE, program)
    reader = registry.metric_reader(name)  # snapshots the counters, as before the traced window
    program.values["host_sync.eigh_status"] += 32
    program.values["launch.trimul_project"] += 20
    assert reader.read(run_of(2)) == 16.0
    # Kernels launched and no sync: a reading of 0, not None.
    reader = registry.metric_reader(name)
    program.values["launch.trimul_project"] += 20
    assert reader.read(run_of(2)) == 0.0


@pytest.mark.parametrize("name", ["host_syncs.sample", "host_syncs.train"])
def test_host_syncs_none_for_the_control_and_a_program_without_counters(monkeypatch, name):
    program = FakeProgram()
    monkeypatch.setitem(sys.modules, program_spans.COUNTERS_MODULE, program)
    assert registry.metric_reader(name).read(run_of()) is None  # nothing of the program ran
    monkeypatch.delitem(sys.modules, program_spans.COUNTERS_MODULE)
    assert registry.metric_reader(name).read(run_of()) is None


def test_recompute_backward_share():
    reader = registry.metric_reader("recompute_backward_share.train")
    trace = tracing.Trace(device_s=10.0, by_range={"genie2:recompute.project_gated_cm": 2.0,
                                                   "genie2:recompute.epilogue_cm": 1.0, "backward": 5.0,
                                                   "genie2:pair_layer": 4.0})
    assert reader.read(run_of(trace=trace)) == pytest.approx(30.0)
    assert reader.read(run_of(trace=tracing.Trace(device_s=10.0, by_range={"backward": 5.0}))) is None
    assert reader.read(run_of(trace=None)) is None


def test_new_readers_in_tiny_traced_runs(tiny):
    """On the CPU no kernel is launched and nothing recomputes: each new
    reader reads nothing, and the line carries the accepted metrics."""
    out = tiny.run("tiny.train", trace=True)
    assert "mfu.train" in out["metrics"] and "recompute_backward_share.train" not in out["metrics"]
    assert "host_syncs.train" not in out["metrics"]
    out = tiny.run("tiny.uncond", trace=True, program="control")
    assert "host_syncs.sample" not in out["metrics"]
