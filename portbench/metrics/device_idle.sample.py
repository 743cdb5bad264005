"""device_idle.sample (%): the share of the traced window in which no
operation ran on the card (torch.profiler's device events, merged). Layer:
the device."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
