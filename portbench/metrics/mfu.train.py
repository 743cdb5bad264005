"""mfu.train (%): three times the denoiser's forward operations (the
forward and a backward of twice its work; the rematerialised forward not
counted), at the batch and padded length, times the untraced window's
steps, over the window and the peak of the configuration's dtype. Layer:
the training step (train/state.py:make_train_step)."""

from portbench.harness.work import denoiser_ops


def read(run):
    ops = 3 * denoiser_ops(run.sizes, run.batch, run.length, static=True) * run.steps
    return 100.0 * ops / run.window_s / run.peak_flops
