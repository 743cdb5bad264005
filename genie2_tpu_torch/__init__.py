"""genie2_tpu_torch — the PyTorch / CUDA port of genie2_tpu.

Module names mirror `genie2_tpu/` so each counterpart is easy to find. The
package imports torch, numpy and the standard library only; the triangle
multiplicative update runs through hand-written CUDA kernels on the card
(`ops/trimul.py`, sources in `csrc/`) and through their plain PyTorch
versions on the CPU.
"""

__version__ = "0.1.0"
