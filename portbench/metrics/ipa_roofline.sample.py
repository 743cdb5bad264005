"""ipa_roofline.sample (%): the least time of every InvariantPointAttention
call of the traced window (harness/work.py:ipa, from the call's shapes)
over the device time of the operations launched inside the calls (the
kernel ipa_attention, the projections, the frame maps and the output).
Layer: the structure net (nn/structure.py)."""

from portbench.harness.work import ipa

MODULE = "InvariantPointAttention"


def work(module, args):
    s, z = args[0], args[1]
    B, N, cs = s.shape
    return ipa(B, N, cs, z.shape[-1], module.no_heads, module.c_hidden, module.no_qk_points, module.no_v_points,
               z.element_size())


def read(run):
    return run.roofline(MODULE)
