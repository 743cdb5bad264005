"""host_syncs.sample (syncs/step): the times the host waited on the card to
read a value back during a reverse step, as the program counts them at
each such site (genie2_tpu_torch/utils/profiling.py, `host_sync.*`: eigh's
status read, once for each chunk of 16,384 orientation matrices, and the
deliberate reads of the samplers), over the traced window's steps. The
counters are read when the harness loads this reader (after the untraced
window, before the traced one) and again when it reads the metric. None
where the program keeps no counters, or where none moved (the control). Layer: the
sampler loop (sampling/ddpm.py:reverse_step)."""

from portbench.harness.program_spans import counters, host_syncs_a_step

START = counters()


def read(run):
    return host_syncs_a_step(START, run)
