"""backward_share.train (%): the device time of the operations launched
inside autograd's backward ranges (`autograd::engine::evaluate_function`,
the rematerialised pair layers among them) over the device time of all
operations of the traced steps. Layer: the training step
(train/state.py:make_train_step)."""


def read(run):
    tr = run.trace
    if tr is None or tr.device_s <= 0 or "backward" not in tr.by_range:
        return None
    return 100.0 * tr.by_range["backward"] / tr.device_s
