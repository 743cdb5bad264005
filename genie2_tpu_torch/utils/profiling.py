"""Spans and counters of genie2_tpu_torch.

Spans. `span(name)` marks a stretch of the program as the profiler range
"genie2:<name>" while a torch profiler records: the range then sits in the
same trace as the card's kernels, on the same clock, and each kernel joins
the range that launched it through the trace's correlation ids. While no
profiler records, `span` returns one shared null context and makes no
RecordFunction, so a span costs one check of the profiler's state.
`spanned(name)` is the same as a decorator, checked at each call. Open a
span on the thread that launches its work: for tensors on the card the
backward runs on autograd's own thread, so the backward's spans sit inside
the autograd Functions (ops/launch.py:Recomputed, ops/trimul.py:ContractCM)
and inside the rematerialised pair layers (nn/pair_stack.py), not around
`loss.backward()`.

Counters are always on, each an integer add in the one store `COUNTERS`:
`count(name, n)` and `host_sync(site, value, n)`, which counts
`host_sync.<site>` where the host waits on the card to read `value` (a
`.item()`, `.cpu()`, `float()` of a card tensor, or a library call that
reads a status back). The kernel wrappers of ops/ count their launches as
`launch.<kernel>`, and parallel/ the bytes all-reduced over the model and
seq groups as `allreduce_bytes.<tp|seq>.<forward|backward>`; each module
names its counters at 0 when it is imported (`count(name, 0)`), so that a
snapshot names them before their first count. `counters()` is one flat
snapshot of them all, `reset()` sets them to 0. Differences of two
snapshots count what ran between them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict

import torch

PREFIX = "genie2:"

_OFF = contextlib.nullcontext()

# The program's own counters; every host-sync site is listed, so that a
# snapshot names it before its first count.
COUNTERS: Dict[str, int] = dict.fromkeys([
    "host_sync.eigh_status",  # geometry/quat.py: torch reads each eigh call's status
    "host_sync.trajectory_snapshot",  # sampling/ddpm.py: x_t snapshots
    "host_sync.sample_output",  # sampling/base.py: a batch's coordinates
    "host_sync.tds_snapshots",  # sampling/smc.py: x0 and x_t snapshots
    "host_sync.tds_trace",  # sampling/smc.py: ESS, resampling and distance traces
    "host_sync.tds_score",  # sampling/smc.py: the last step's placement scores
    "host_sync.tds_output",  # sampling/smc.py: a problem's coordinates
    "host_sync.log_metrics",  # train/loop.py: a logged step's metrics
    "host_sync.validation_loss",  # train/loop.py: each validation batch's loss
    "host_sync.any_rank",  # parallel/mesh.py
    "host_sync.broadcast_int",  # parallel/mesh.py
], 0)


def recording() -> bool:
    """Whether a torch profiler records on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """The profiler range "genie2:<name>" while a profiler records, else
    the shared null context."""
    if recording():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


def spanned(name: str):
    """A decorator: each call of the function runs inside `span(name)`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1):
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def host_sync(site: str, value, n: int = 1):
    """Count `n` host syncs at `site` where `value` is a tensor on the
    card (a read of a CPU tensor or a Python number waits for nothing)."""
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        count("host_sync." + site, n)


def counters() -> Dict[str, int]:
    """One flat snapshot of every counter of the program."""
    return dict(COUNTERS)


def reset():
    """Every counter back to 0; each keeps its name."""
    for name in COUNTERS:
        COUNTERS[name] = 0
