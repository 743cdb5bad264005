"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench.harness import registry, tracing
from portbench.harness.work import PEAK_FLOPS, bound_seconds

# Top-level module names that no run may hold once its window has closed
# (run.py checks before it prints a result).
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "genie2_tpu")


def banned_modules(modules=None) -> List[str]:
    """The banned top-level names among the loaded modules, compared whole
    (genie2_tpu_torch is not genie2_tpu)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(BANNED))


@dataclass
class Run:
    """What a per-layer metric's reader reads."""

    cell: registry.Cell
    sizes: Dict
    dtype: str
    batch: int
    length: int
    steps: int
    window_s: float
    step_seconds: List[float]
    model_calls: int
    trace: Optional[tracing.Trace] = None
    calls: Dict[str, list] = field(default_factory=dict)

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.dtype]

    def roofline(self, module: str) -> Optional[float]:
        """The share (%) of the least time of every traced call of `module`
        in the device time of the kernels under its spans; None where the
        trace holds none."""
        device_s = self.trace.by_range.get(f"pb:{module}", 0.0) if self.trace else 0.0
        calls = self.calls.get(module, [])
        if device_s <= 0 or not calls:
            return None
        return 100.0 * sum(bound_seconds(ops, nbytes, self.dtype) for ops, nbytes in calls) / device_s


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        program: str = "port") -> Dict:
    """The result of one run as a dict, in the order of the result line."""
    gen = registry.generator(cell.traffic["generator"], cell.bench_dir).Generator(cell, seed, device, program)
    t_gen = time.perf_counter()
    gen.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    print(f"# set-up: {t_gen - t_start:.3f} s before the generator (imports), "
          f"{setup_s - (t_gen - t_start):.3f} s in it (CUDA context, kernel libraries, weights, inputs, warm-up)",
          file=sys.stderr)

    steps, times, calls0 = 0, [], gen.model_calls
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a = time.perf_counter()
        gen.step()
        steps += 1
        b = time.perf_counter()
        times.append(b - a)
        if b >= deadline:
            break
    sync(device)
    t1 = time.perf_counter()
    times[-1] += t1 - b
    window_s = t1 - t0
    q = sorted(times)
    print(f"# window: {steps} steps in {window_s:.3f} s; step s min {q[0]:.4f} median {q[len(q) // 2]:.4f} "
          f"max {q[-1]:.4f}", file=sys.stderr)
    run_ = Run(cell, gen.sizes, gen.dtype, gen.B, gen.length(), steps, window_s, times, gen.model_calls - calls0)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}

    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    if not trace:
        values = dict(gen.end_to_end(steps, window_s), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        readers = {m["name"]: registry.metric_reader(m["name"], cell.bench_dir) for m in cell.per_layer}
        work = {r.MODULE: r.work for r in readers.values() if getattr(r, "MODULE", None)}
        spans = tracing.Spans(gen.model, work) if gen.model is not None else None

        def traced():
            for _ in range(int(cell.traffic["trace_steps"])):
                with torch.autograd.profiler.record_function("pb:step"):
                    gen.step()
            sync(device)

        run_.trace = tracing.profile(traced, device)
        if spans is not None:
            run_.calls = dict(spans.calls)
            spans.remove()
        for name, reader in readers.items():
            value = reader.read(run_)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        tr = run_.trace
        extra["busy_s"], extra["window_s"] = tr.busy_s, tr.window_s
        extra["breakdown"] = {"device_ops": tr.top(tr.by_op), "idle_gaps": tr.top(tr.idle_by_host)}
        print(f"# trace: {tr.n_device_ops} device operations, {tr.device_s:.6f} s, of which "
              f"{tr.unattributed_s:.6f} s have no launch in the trace; by range "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(tr.by_range.items())), file=sys.stderr)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gen.release()
    readings = gen.check()
    detail = getattr(gen, "detail", None)
    if detail:
        print(f"# check detail: {detail}", file=sys.stderr)
    limits = cell.limits
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    failed = [k for k, c in checks.items() if not c["value"] <= c["limit"]]

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = extra["busy_s"], extra["window_s"]
    out = {"correct": not failed, "attempted": steps, "failed": len(failed), "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = extra["breakdown"]
    if detail:
        out["detail"] = detail
    out["checks"] = checks
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
