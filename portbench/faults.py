"""Faults planted in the program underneath a run, for the checks that the
comparison with the reference catches them (tests/test_portbench_faults.py
on the CPU, calibrate.py on the card).

Sampling: `unchanged` (a reverse step returns x_t), `half_batch` (the second
half of the batch takes the first half's prediction), `altered` (one
residue's predicted noise negated where the model function produces it).
Training: `unchanged` (the optimizer leaves the weights as they are),
`half_batch` (the loss and its gradient from the first half of the batch
alone), `altered` (the loss scaled by 1.01 where it is produced).
"""

from __future__ import annotations

import contextlib
from unittest import mock

SAMPLING = ("unchanged", "half_batch", "altered")
TRAINING = ("unchanged", "half_batch", "altered")


def _first_half(z):
    z = z.clone()
    h = z.shape[0] // 2
    z[h:2 * h] = z[:h]
    return z


def _negate_one(z):
    z = z.clone()
    z[0, 0] = -z[0, 0]
    return z


@contextlib.contextmanager
def planted(generator: str, fault: str):
    """Plant `fault` in the program for a run of the traffic generator `generator`."""
    if fault == "none":
        yield
        return
    if generator == "ancestral":
        from genie2_tpu_torch.sampling import base, ddpm

        if fault == "unchanged":
            def step(model_fn, schedule, features, trans, t, noise, scale, _orig=ddpm.reverse_step):
                _orig(model_fn, schedule, features, trans, t, noise, scale)
                return trans

            target, new = (ddpm, "reverse_step"), step
        else:
            change = _first_half if fault == "half_batch" else _negate_one

            def apply(*args, _orig=base.apply_denoiser, **kwargs):
                return change(_orig(*args, **kwargs))

            target, new = (base, "apply_denoiser"), apply
    elif generator == "train":
        import torch
        from genie2_tpu_torch.train import state

        if fault == "unchanged":
            target, new = (torch.optim.Adam, "step"), lambda self, closure=None: None
        elif fault == "half_batch":
            def loss(z_pred, z, features, weight, mesh=None, _orig=state.genie_loss):
                h = z.shape[0] // 2
                return _orig(z_pred[:h], z[:h], {k: v[:h] for k, v in features.items()}, weight, mesh)

            target, new = (state, "genie_loss"), loss
        else:
            def loss(*args, _orig=state.genie_loss, **kwargs):
                value, metrics = _orig(*args, **kwargs)
                metrics["weighted_loss"] = metrics["weighted_loss"] * 1.01
                return value * 1.01, metrics

            target, new = (state, "genie_loss"), loss
    else:
        raise ValueError(f"no faults for the traffic generator {generator!r}")
    with mock.patch.object(*target, new):
        yield
