"""What the program under test records of itself, read beside the
benchmark's own spans.

genie2_tpu_torch opens profiler ranges "genie2:<name>" at its layer
boundaries while a profiler records (its utils/profiling.py) and keeps
counters: host syncs by site, kernel launches, bytes all-reduced.

`keep_program_spans()` makes the trace's reduction (tracing.reduce_trace)
keep those ranges in `Trace.by_range` beside the "pb:" ranges and the
backward. Each device operation is counted once under each label of the
ranges open at its launch, so the other keys read as they did. A reader
calls it when the harness loads it, which is before the traced window.

`counters()` is the program's snapshot of its counters, or None where
the program keeps none (a checkout whose program has no such counters);
`host_syncs_a_step(start, run)` the host syncs a traced step from a
snapshot taken before the traced window.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional

from portbench.harness import tracing

PROGRAM_PREFIX = "genie2:"
COUNTERS_MODULE = "genie2_tpu_torch.utils.profiling"


def keep_program_spans():
    base = tracing._label
    if getattr(base, "keeps_program_spans", False):
        return

    def label(name: str) -> Optional[str]:
        return name if name.startswith(PROGRAM_PREFIX) else base(name)

    label.keeps_program_spans = True
    tracing._label = label


def counters() -> Optional[Dict[str, int]]:
    module = sys.modules.get(COUNTERS_MODULE)
    return None if module is None else module.counters()


def host_syncs_a_step(start: Optional[Dict[str, int]], run) -> Optional[float]:
    """The program's `host_sync.*` counts a step of the traced window,
    from the snapshot `start` (taken when the reader was loaded) to now;
    None where the program keeps no counters, or where none of them moved
    (the control runs no program code; the program launches kernels every
    step on the card)."""
    end = counters()
    if start is None or end is None:
        return None
    delta = {k: v - start.get(k, 0) for k, v in end.items()}
    if not any(delta.values()):
        return None
    syncs = sum(v for k, v in delta.items() if k.startswith("host_sync."))
    return syncs / int(run.cell.traffic["trace_steps"])
