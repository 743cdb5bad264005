"""step_ms_p95.sample (ms): the 95th percentile of a sampler step's time on
the host's clock, over the untraced window's steps. Every step of the
ancestral loop synchronises with the card (the eigh of the frames), so a
step's host time is its time. Layer: the sampler loop
(sampling/ddpm.py:reverse_step under BaseSampler's model function)."""

import statistics


def read(run):
    if len(run.step_seconds) < 20:
        return None
    return 1000.0 * statistics.quantiles(run.step_seconds, n=20)[-1]
