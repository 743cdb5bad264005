"""trimul_roofline.sample (%): the least time of every
TriangleMultiplicativeUpdate call of the traced window
(harness/work.py:trimul, from the call's shapes) over the device time of the
operations launched inside the calls (the kernels trimul_project,
trimul_contract and trimul_epilogue, and whatever else the module runs).
Layer: the pair stack (nn/pair_stack.py)."""

from portbench.harness.work import trimul

MODULE = "TriangleMultiplicativeUpdate"


def work(module, args):
    z = args[0]
    B, _, N, C = z.shape
    return trimul(B, N, C, module.linear_a_p.weight.shape[0], z.element_size())


def read(run):
    return run.roofline(MODULE)
