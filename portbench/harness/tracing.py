"""Spans recorded from the benchmark's own files, a torch.profiler window,
and the reduction of its trace to device seconds by layer.

Spans: forward hooks on the program's modules of the classes that the cell's
metric readers name open a `record_function` range "pb:<class>" around each
call, and note the call's work (operations, bytes) from its shapes. They are
registered only for the traced window, so the untraced window runs the
program as it is.

Attribution: every device operation (kernel, copy, set) of the trace is
joined by its correlation id to the host call that launched it, and counted
under every range that encloses that call on its thread: "pb:<class>" for a
module, "pb:step" for a step, and "backward" for autograd's
`autograd::engine::evaluate_function` ranges (the backward pass, the
rematerialised forward inside it included). A device operation whose launch
the trace does not hold is counted under no range and reported as such.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
BACKWARD_PREFIX = "autograd::engine::evaluate_function"


class Spans:
    """Forward pre/post hooks on the modules of `model` whose class name is a
    key of `work`; work[class](module, args) -> (ops, bytes) of one call."""

    def __init__(self, model, work: Dict[str, Callable]):
        import torch

        self.calls: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._handles = []
        self._open = []
        self._record = torch.autograd.profiler.record_function
        for module in model.modules():
            cls = type(module).__name__
            if cls in work:
                self._handles.append(module.register_forward_pre_hook(self._pre(cls, work[cls])))
                self._handles.append(module.register_forward_hook(self._post))

    def _pre(self, cls, fn):
        def hook(module, args):
            self.calls[cls].append(fn(module, args))
            rf = self._record(f"pb:{cls}")
            rf.__enter__()
            self._open.append(rf)

        return hook

    def _post(self, module, args, output):
        self._open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


@dataclass
class Trace:
    """Device seconds of the traced window, by range and by operation."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_s: float = 0.0  # summed durations of every device operation in the window
    by_range: Dict[str, float] = field(default_factory=dict)
    by_op: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    unattributed_s: float = 0.0
    n_device_ops: int = 0

    def top(self, d: Dict[str, float], n: int = 10):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def profile(fn: Callable[[], None], device) -> Trace:
    """Run `fn` (which ends with the device synchronised) under
    torch.profiler inside a range "pb:window", and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with torch.profiler.profile(activities=activities) as prof:
        with torch.autograd.profiler.record_function("pb:window"):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    finally:
        os.remove(path)
    return reduce_trace(events["traceEvents"] if isinstance(events, dict) else events)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _label(name: str) -> Optional[str]:
    if name.startswith("pb:"):
        return name
    if name.startswith(BACKWARD_PREFIX):
        return "backward"
    return None


def open_ranges(ranges: List[Tuple[float, float, str]], times: List[float]) -> List[List[Tuple[float, float, str]]]:
    """For each of `times`, the ranges of one thread open at it, outermost
    first. Ranges of one thread nest, so one sweep with a stack finds them."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[List[Tuple[float, float, str]]] = [[] for _ in times]
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = [r for r in stack if r[1] >= t]
    return out


def reduce_trace(events: List[Dict]) -> Trace:
    """Chrome-trace events (microsecond times) -> Trace (seconds), over the
    range "pb:window"."""
    launches: Dict[int, Tuple[object, float]] = {}
    device, host = [], defaultdict(list)
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, args = e.get("cat", ""), e.get("name", ""), e.get("args") or {}
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in ("cpu_op", "user_annotation"):
            if name == "pb:window":
                window = (ts, ts + dur)
            host[e.get("tid")].append((ts, ts + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no range pb:window")
    device = [(max(a, window[0]), min(b, window[1]), name, corr) for a, b, name, corr in device]
    device = [d for d in device if d[1] > d[0]]
    tr = Trace(window_s=(window[1] - window[0]) * 1e-6, n_device_ops=len(device))
    by_range, by_op = defaultdict(float), defaultdict(float)
    per_thread = defaultdict(list)  # launch thread -> [(launch time, seconds)]
    for a, b, name, corr in device:
        sec = (b - a) * 1e-6
        tr.device_s += sec
        by_op[name] += sec
        launch = launches.get(corr)
        if launch is None:
            tr.unattributed_s += sec
        else:
            per_thread[launch[0]].append((launch[1], sec))
    for tid, items in per_thread.items():
        labelled = [r for r in host.get(tid, []) if _label(r[2])]
        for (_, sec), rs in zip(items, open_ranges(labelled, [t for t, _ in items])):
            for label in {_label(r[2]) for r in rs}:
                by_range[label] += sec
    merged = _merge([(a, b) for a, b, _, _ in device])
    tr.busy_s = sum(b - a for a, b in merged) * 1e-6
    # Idle gaps, each put down to the innermost host range of any thread
    # that was open at the gap's midpoint (the backward's host work runs on
    # autograd's thread, the step's on the window's).
    edges = [window[0]] + [x for ab in merged for x in ab] + [window[1]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = [(a + b) / 2 for a, b in gaps]
    open_at = [open_ranges(rs, mids) for rs in host.values()]
    idle = defaultdict(float)
    for i, (a, b) in enumerate(gaps):
        inner = [rs[i][-1] for rs in open_at if rs[i]]
        idle[min(inner, key=lambda r: r[1] - r[0])[2] if inner else "(no host range)"] += (b - a) * 1e-6
    tr.by_range, tr.by_op, tr.idle_by_host = dict(by_range), dict(by_op), dict(idle)
    return tr
