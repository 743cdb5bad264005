"""What the kernel wrappers of `ops/` share: the device rule, the
activation checks, the gradient rules and the ctypes launch itself.

A wrapper takes its plain version for a tensor on the CPU and launches its
kernel for a tensor on the card; anything else raises. It counts
`launch.<kernel>` (utils/profiling.py:count) where it launches, and nowhere
else; its module names that counter at 0 when it is imported. Where autograd
records (grad mode on and an input that requires grad), a wrapper on the
card goes through its `torch.autograd.Function`: the forward is the same
launch, the backward either kernels (the TriMul contraction; the TriMul
projection and epilogue for float32 activations, `trimul_project_backward`
and `trimul_epilogue_backward`) or the gradient of the plain version,
recomputed (`Recomputed`, inside the span "recompute.<kernel>": the plain
version's name without `_plain`). A raw
`launch` whose inputs would need a gradient raises (`check_no_grad`): the
kernels themselves return tensors without a graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from genie2_tpu_torch.ops import build
from genie2_tpu_torch.utils.profiling import span

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"the kernels run on cuda or cpu tensors, not {t.device}")
    return False


def records_grad(tensors: Sequence) -> bool:
    """Whether autograd would record an op on `tensors`: grad mode is on and
    one of them requires grad."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_no_grad(entry: str, tensors: Sequence[torch.Tensor]):
    """Raise where autograd would record through a raw launch: grad mode is
    on and one of `tensors` (an activation, a weight or a temporary made
    from one) requires grad. A kernel returns a tensor without a graph, so
    the gradient would be silently missing; the wrappers launch inside
    their Functions' forward, where grad mode is off."""
    if records_grad(tensors):
        raise RuntimeError(
            f"{entry}: a raw kernel launch is forward only, but an input requires grad with grad mode on; "
            "call the wrapper (ops/), which records the launch through its autograd Function"
        )


def recompute_backward(plain: Callable, inputs: Sequence, needs_input_grad: Sequence[bool],
                       grad_outputs: Sequence[Optional[torch.Tensor]]) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward of a kernel whose forward computes `plain(*inputs)`:
    the plain version is run again under grad mode on detached inputs, and
    `torch.autograd.grad` gives the gradients of the inputs whose
    `needs_input_grad` is set (None for the others, and for inputs that are
    not tensors), so a weight that needs no gradient costs nothing."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n)) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs_input_grad)]
        outputs = plain(*leaves)
    outputs = outputs if isinstance(outputs, tuple) else (outputs,)
    wanted = [t for t, n in zip(leaves, needs_input_grad) if n and isinstance(t, torch.Tensor)]
    pairs = [(o, g) for o, g in zip(outputs, grad_outputs) if g is not None and o.requires_grad]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True)
                 if wanted and pairs else [None] * len(wanted))
    return tuple(next(grads) if n and isinstance(t, torch.Tensor) else None
                 for t, n in zip(inputs, needs_input_grad))


class Recomputed(torch.autograd.Function):
    """A kernel under autograd: apply(kernel, plain, *inputs), where
    `kernel` and `plain` compute the same function of `inputs` (tensors or
    None). Forward: `kernel(*inputs)`, the same launch and count as without
    autograd; backward: the gradient of `plain(*inputs)`, recomputed
    (`recompute_backward`)."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain = plain
        return kernel(*inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grad_outputs):
        with span("recompute." + recomputed_name(ctx.plain)):
            grads = recompute_backward(ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], grad_outputs)
        return (None, None, *grads)


def recomputed_name(plain: Callable) -> str:
    """The kernel a plain version stands for: its function's name (under
    any functools.partial) without `_plain`."""
    while isinstance(plain, functools.partial):
        plain = plain.func
    return plain.__name__.removesuffix("_plain")


def check_activation(name: str, t: torch.Tensor, ndim: int, like: torch.Tensor = None):
    """A contiguous float32 / bfloat16 tensor of `ndim` axes, of `like`'s
    dtype and device where `like` is given."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 or bfloat16)")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d tensor, got {tuple(t.shape)}")
    if like is not None and (t.dtype != like.dtype or t.device != like.device):
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on {like.device}")


def launch(source: str, entry: str, argtypes: Sequence, device, *args, tensors: Sequence[torch.Tensor] = ()):
    """Call the C entry point `entry` of csrc/<source>.cu (built first if
    needed) for `device`, on its current stream, and raise on a launch
    error or where a tensor among `args` would need a gradient. `argtypes` are the ctypes of `args`; the stream is appended.
    Tensors go in as pointers; `args` and `tensors` (the tensors behind
    pointers packed into a ctypes array among `args`) keep every tensor
    (temporaries included) referenced until the launch is enqueued, after
    which the caching allocator only hands their memory to later work on
    the same stream."""
    check_no_grad(entry, [a for a in args if isinstance(a, torch.Tensor)] + list(tensors))
    fn = getattr(build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        code = fn(*c_args, stream)
    if code != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {code}")
