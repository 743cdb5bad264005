"""tri_att_roofline.sample (%): the least time of every TriangleAttention
call of the traced window (harness/work.py:tri_att, from the call's shapes)
over the device time of the operations launched inside the calls (the
kernel tri_att_flash, the projections, the gate and the output). Layer: the
pair stack (nn/pair_stack.py)."""

from portbench.harness.work import tri_att

MODULE = "TriangleAttention"


def work(module, args):
    x = args[0]
    B, _, N, C = x.shape
    return tri_att(B, N, C, module.mha.no_heads, module.mha.c_hidden, x.element_size())


def read(run):
    return run.roofline(MODULE)
