"""recompute_backward_share.train (%): the device time of the operations
launched inside the program's spans "genie2:recompute.<kernel>" (the
backward of a kernel that recomputes its plain version and takes that
version's gradient, ops/launch.py:Recomputed; the spans never nest) over
the device time of all operations of the traced steps. None where the
trace holds no such span (a program without them, or the control). Layer:
the training step's backward (train/state.py:make_train_step)."""

from portbench.harness.program_spans import PROGRAM_PREFIX, keep_program_spans

SPAN = PROGRAM_PREFIX + "recompute."

keep_program_spans()


def read(run):
    tr = run.trace
    spans = [v for k, v in tr.by_range.items() if k.startswith(SPAN)] if tr is not None else []
    if not spans or tr.device_s <= 0:
        return None
    return 100.0 * sum(spans) / tr.device_s
