"""genie2_tpu_torch's pair transition wrapper (ops/transition.py) on the CPU.

The plain version is the module's own arithmetic (LayerNorm, linear_1,
ReLU, linear_2, times the pair mask), so on the CPU the module's output is
bit for bit what it was before the wrapper; under autograd the kernel's
Function (`Recomputed`, with the plain version standing in for the kernel)
gives the module's gradients. The wrapper routes: only float32 on the card
at the kernel's widths reaches the kernel; bf16 activations and widths the
kernel does not take get the plain version, and the tensor-parallel split
never reaches the wrapper. The kernel itself runs on the card only
(tests/test_torch_cuda.py).
"""

import functools

import pytest
import torch

from genie2_tpu_torch.nn import pair_stack
from genie2_tpu_torch.nn.pair_stack import PairTransition
from genie2_tpu_torch.nn.primitives import LN_EPS
from genie2_tpu_torch.ops import launch, transition
from genie2_tpu_torch.ops.launch import Recomputed, recomputed_name
from genie2_tpu_torch.ops.transition import pair_transition, pair_transition_plain
from genie2_tpu_torch.utils import profiling

PARAMS = ("layer_norm.weight", "layer_norm.bias", "linear_1.weight", "linear_1.bias", "linear_2.weight",
          "linear_2.bias")


def seeded_transition(c: int, n: int, seed: int = 0, dtype=torch.float32) -> PairTransition:
    """A PairTransition with every weight drawn from a seed (the "final"
    init of linear_2 is zero)."""
    gen = torch.Generator().manual_seed(seed)
    module = PairTransition(c, n)
    with torch.no_grad():
        for name, p in module.named_parameters():
            offset = 1.0 if name == "layer_norm.weight" else 0.0
            p.copy_(offset + 0.3 * torch.randn(p.shape, generator=gen))
    return module.to(dtype)


def inputs(b: int, i: int, n_res: int, c: int, seed: int = 1, dtype=torch.float32):
    """z [b, i, n_res, c] and a ragged pair mask of the rows [b, i, n_res]."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.randn(b, i, n_res, c, generator=gen).to(dtype)
    lengths = torch.tensor([n_res - 2 * k for k in range(b)])
    res = (torch.arange(n_res)[None] < lengths[:, None]).float()
    return z, (res[:, :i, None] * res[:, None, :]).to(dtype)


def module_math(module: PairTransition, z, mask):
    """AF2 Algorithm 15 written out with the module's own layers."""
    h = torch.relu(module.linear_1(module.layer_norm(z)))
    return module.linear_2(h) * mask[..., None].to(z.dtype)


def weights(module: PairTransition):
    return [dict(module.named_parameters())[k] for k in PARAMS]


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("i", [9, 4])  # the square pair representation, and a row block of it
def test_plain_version_is_the_modules_math(n, i):
    """At c_p 128 with transition factor 4 (the configurations) and 2 (the
    parity configuration), the plain version and the module (through the
    wrapper on the CPU) equal the module's layers bit for bit."""
    module = seeded_transition(128, n)
    z, mask = inputs(2, i, 9, 128)
    want = module_math(module, z, mask)
    got = pair_transition_plain(z, mask, *weights(module), eps=module.layer_norm.eps)
    assert module.layer_norm.eps == LN_EPS
    assert torch.equal(got, want)
    assert torch.equal(module(z, mask), want)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """The wrapper on CPU tensors returns the plain version's result and
    launches nothing, with grad mode on and off."""
    module = seeded_transition(128, 4)
    z, mask = inputs(2, 6, 6, 128)
    profiling.reset()
    with torch.no_grad():
        assert torch.equal(pair_transition(z, mask, *weights(module)), module_math(module, z, mask))
    out = pair_transition(z.requires_grad_(True), mask, *weights(module))
    assert out.grad_fn is not None and "Recomputed" not in type(out.grad_fn).__name__
    assert profiling.counters()["launch.pair_transition"] == 0


def test_recomputed_gives_the_modules_gradients():
    """The kernel's Function with the plain version standing in for the
    kernel: the gradients of z, the mask and all six weights equal autograd
    of the module's layers, and the recompute's span is named after the
    kernel."""
    module = seeded_transition(128, 2)
    z, mask = inputs(2, 5, 5, 128)
    leaves = [z.requires_grad_(True), mask.requires_grad_(True), *weights(module)]
    cot = torch.randn(z.shape, generator=torch.Generator().manual_seed(3))
    plain = functools.partial(pair_transition_plain, eps=module.layer_norm.eps)
    got = torch.autograd.grad(Recomputed.apply(plain, plain, *leaves), leaves, cot)
    want = torch.autograd.grad(module_math(module, z, mask), leaves, cot)
    assert len(got) == 8
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert recomputed_name(plain) == "pair_transition"


def _refuse(*args, **kwargs):
    raise AssertionError("reached the kernel")


def _case_module(monkeypatch, case):
    c, n, dtype = {"bf16": (128, 4, torch.bfloat16), "width": (64, 4, torch.float32),
                   "hidden": (128, 4, torch.float32), "tp": (128, 4, torch.float32),
                   "kernel": (128, 4, torch.float32)}[case]
    module = seeded_transition(c, n, dtype=dtype)
    if case == "hidden":  # 520 hidden channels, not a multiple of the 64-wide chunk
        module.linear_1 = torch.nn.Linear(c, 520).to(dtype)
        module.linear_2 = torch.nn.Linear(520, c).to(dtype)
    if case == "tp":  # one model rank holding every hidden channel: the split's arithmetic, no collective
        monkeypatch.setattr(pair_stack, "copy_to_model", lambda x, tp: x)
        monkeypatch.setattr(pair_stack, "reduce_from_model", lambda x, tp: x)
        module.shard_(object())
    return module, *inputs(2, 5, 5, c, dtype=dtype)


@pytest.mark.parametrize("case", ["bf16", "width", "hidden", "tp"])
def test_other_cases_keep_the_modules_products(monkeypatch, case):
    """bf16 activations, C other than 128 and a hidden width off the
    kernel's chunk get the plain version from the wrapper, as if their
    tensors were on the card, and the tensor-parallel split never reaches
    the wrapper: each gives the module's arithmetic, bit for bit, and is
    differentiated by autograd directly."""
    monkeypatch.setattr(transition, "on_cpu", lambda t: False)
    monkeypatch.setattr(transition, "_pair_transition_kernel", _refuse)
    monkeypatch.setattr(transition, "Recomputed", None)
    if case == "tp":
        monkeypatch.setattr(transition, "pair_transition", _refuse)
    module, z, mask = _case_module(monkeypatch, case)
    got, want = module(z.requires_grad_(True), mask), module_math(module, z, mask)
    if case == "tp":  # the split adds linear_2's bias after the reduction
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got, want)
    assert got.grad_fn is not None


@pytest.mark.parametrize("grad", [False, True])
def test_float32_at_the_kernels_widths_reaches_the_kernel(monkeypatch, grad):
    """float32 at C = 128 and a hidden width of 512, as if on the card: the
    module takes the wrapper, which launches the kernel, through the
    kernel's Function where autograd records."""
    seen = []
    monkeypatch.setattr(transition, "on_cpu", lambda t: False)
    monkeypatch.setattr(transition, "_pair_transition_kernel", lambda *args, eps: seen.append(eps) or args[0])
    module, z, mask = _case_module(monkeypatch, "kernel")
    with torch.set_grad_enabled(grad):
        out = module(z, mask)
    assert seen == [LN_EPS]
    if grad:
        assert type(out.grad_fn).__name__ == "RecomputedBackward"
    else:
        assert out is z


@pytest.mark.parametrize("c,hidden,takes", [(128, 512, True), (128, 256, True), (128, 64, True), (128, 0, False),
                                            (128, 520, False), (64, 256, False), (256, 512, False)])
def test_takes(c, hidden, takes):
    assert transition.takes(c, hidden) is takes


def test_launch_counter():
    """The snapshot names the kernel's counter, which profiling.reset() clears."""
    assert "launch.pair_transition" in profiling.counters()
    profiling.count("launch.pair_transition", 5)
    profiling.reset()
    assert profiling.counters()["launch.pair_transition"] == 0


def test_smoke_script_counts_the_transition():
    """chip_smoke.py's launch tables and bound: one launch a pair layer and
    denoiser call, ten a training step (the forward and remat's second),
    none under a model axis (its split runs torch's products); at B=4,
    N=256, H=512 its bound is its operations as 3xTF32, 0.416 ms."""
    import chip_smoke

    config = chip_smoke.example_config()
    assert chip_smoke.expected_launches(config, 3)["pair_transition"] == 15
    step = chip_smoke.train_launches(config, 1, eval_calls=0)
    assert step["pair_transition"] == 10
    assert chip_smoke.split_epilogue(step)["pair_transition"] == 0
    bytes_, ops = chip_smoke.kernel_bytes_ops("pair_transition", 4, 256, 128, 512, 4)
    assert ops == 2 * 2 * 4 * 256 * 256 * 128 * 512
    ops_ms, bytes_ms = ops / chip_smoke.PEAK_OPS_PER_S["float32"] * 1e3, bytes_ / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert ops_ms > bytes_ms and abs(ops_ms - 0.4165) < 1e-3 and abs(bytes_ms - 0.0816) < 1e-3
