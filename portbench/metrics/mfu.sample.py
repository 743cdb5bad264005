"""mfu.sample (%): the denoiser's operations per call, counted from the
configuration's sizes at the served batch and padded length (the
step-invariant pair bias that the sampler computes once a batch left out),
times the calls of the untraced window, over the window and the peak of the
configuration's dtype. Layer: the denoiser step."""

from portbench.harness.work import denoiser_ops


def read(run):
    ops = denoiser_ops(run.sizes, run.batch, run.length, static=False) * run.model_calls
    return 100.0 * ops / run.window_s / run.peak_flops
