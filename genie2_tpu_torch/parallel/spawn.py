"""Run a function on N local ranks, with a deadline.

`run_ranks(fn, world_size, args)` starts `world_size` processes by the
`spawn` method (a process that has initialised CUDA cannot fork one that
uses it), joins them into a gloo process group through a file store (no
port to pick, none to collide) and calls `fn(rank, *args)` in each. It returns the
ranks' return values in rank order. A rank that raises writes its
traceback and exits, which ends the others' collectives; a rank still
alive at the deadline is killed. Either way `run_ranks` raises, naming the
ranks and their errors. `fn` must be importable (a module-level function)
and its arguments and result picklable; tensors come back through
`torch.save`.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn: Callable, rank: int, world_size: int, store: str, out: str, timeout: float,
               args: Sequence[Any]):
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        result = {"ok": fn(rank, *args)}
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises it
        torch.save({"error": traceback.format_exc()}, out)
        raise SystemExit(1)
    torch.save(result, out)
    dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), deadline: float = 120.0) -> List[Any]:
    """fn(rank, *args) on `world_size` spawned ranks of one gloo process
    group (gloo runs on CPU and CUDA tensors alike, and several ranks may
    share a card); their return values in rank order. Raises RuntimeError
    where a rank failed or outlived `deadline` seconds (every rank is then
    killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as work:
        store = os.path.join(work, "store")
        outs = [os.path.join(work, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, store, outs[r], deadline, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        try:
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results, errors = [], []
        for r, path in enumerate(outs):
            blob = torch.load(path, weights_only=False) if os.path.isfile(path) else {}
            if "ok" in blob:
                results.append(blob["ok"])
            elif r in late:
                errors.append(f"rank {r}: still running after {deadline:.0f} s, killed")
            else:
                errors.append(f"rank {r} (exit {procs[r].exitcode}): {blob.get('error', 'no result')}")
        if errors:
            raise RuntimeError("run_ranks failed:\n" + "\n".join(errors))
        return results
