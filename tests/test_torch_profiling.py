"""genie2_tpu_torch's spans and counters (utils/profiling.py).

On the CPU: with no profiler recording, `span` is one shared null context
and a reverse step and a training step make no RecordFunction; under a CPU
profiler both steps carry the spans the CPU path reaches, nested as the
layers nest; `counters()` is one flat snapshot of the program's counters;
the program opens profiler ranges through `span` alone.

Marked `cuda` (skipped without a card, decided inside each test): sync
debug mode counts as many synchronising calls in a reverse step and a
training step as the host-sync counters; the `recompute.*` spans and the
projection's and the epilogue's `backward.trimul_project` and
`backward.trimul_epilogue` open on autograd's thread and hold their
kernels; the TriMul, triangle
attention and IPA spans hold the same device time as the benchmark's
forward hooks on those modules. On a machine with a card:
    python -m pytest --noconftest tests/test_torch_profiling.py -m cuda -q
"""

import functools
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.nn.policy import apply_denoiser
from genie2_tpu_torch.ops import ipa, launch, transition, tri_att, triangle, trimul  # noqa: F401, their counters
from genie2_tpu_torch.parallel import sequence_parallel, tensor_parallel  # noqa: F401, their counters
from genie2_tpu_torch.sampling.ddpm import reverse_step
from genie2_tpu_torch.train import MotifAugmentConfig, create_train_state, make_train_step, synthetic_dataset
from genie2_tpu_torch.train.prefetch import prefetch
from genie2_tpu_torch.utils import profiling
from genie2_tpu_torch.utils.weights import randomize_zero_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every layer kind on: triangle attention, eigh frames, remat, dropout.
TINY = {
    "singleFeatureDimension": 16, "pairFeatureDimension": 8, "positionalEmbeddingDimension": 8,
    "chainEmbeddingDimension": 4, "timestepEmbeddingDimension": 8, "templateDistanceNumBins": 5,
    "numPairTransformLayers": 2, "triangularMultiplicativeHiddenDimension": 4, "numStructureLayers": 2,
    "ipaHiddenDimension": 4, "ipaNumHeads": 2, "ipaNumQkPoints": 2, "ipaNumVPoints": 2, "numTimesteps": 10,
    "maximumNumResidues": 24, "includeTriangularAttention": True, "triangularAttentionNumHeads": 2,
    "triangularAttentionHiddenDimension": 4, "rotToQuatMethod": "eigh", "remat": True,
}

SAMPLE_SPANS = {"sample_step", "frames", "posterior", "denoiser", "single_features", "pair_features",
                "orientations", "eigh", "pair_stack", "pair_layer", "trimul", "tri_att", "pair_transition",
                "structure_layer", "ipa", "structure_transition", "backbone_update"}
TRAIN_SPANS = (SAMPLE_SPANS - {"sample_step", "posterior"}) | {
    "train_step", "noise", "forward", "loss", "backward", "grad_norm", "optimizer", "ema", "prefetch_wait"}


def _model(device="cpu", **overrides):
    torch.manual_seed(0)
    return randomize_zero_init(Denoiser.from_config(Config(overrides={**TINY, **overrides})), 0).to(device)


def _sample_step(device="cpu", B=2, N=20, **overrides):
    """One reverse step of a tiny model, as a function of nothing."""
    model = _model(device, **overrides).eval()
    features = to_device(batchify([create_empty_features([N]) for _ in range(B)]), device)
    schedule = Schedule.create(10, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(B, N, 3, generator=gen, device=device) * 5
    noise = torch.randn(B, N, 3, generator=gen, device=device)
    with torch.no_grad():
        bias = model.static_bias(features)

    def model_fn(frames, t_vec):
        return apply_denoiser(model, frames, t_vec, features, bias)

    @torch.inference_mode()
    def step():
        return reverse_step(model_fn, schedule, features, x, 5, noise, 0.6)

    return step


def _train_step(device="cpu", B=2, N=24, ema_decay=0.999, **overrides):
    """One training step of a tiny model, its batch (already on the
    device) through `prefetch`, as a function of nothing."""
    model = _model(device, **overrides, maximumNumResidues=N)
    data = synthetic_dataset(4, N, np.random.default_rng(0), 20, MotifAugmentConfig(prob=0.5))
    features = to_device(next(data.epoch(B, np.random.default_rng(1))), device)
    state = create_train_state(model, 1e-4, ema_decay)
    step = make_train_step(Schedule.create(10, device=device), 1.0, ema_decay=ema_decay)
    gen = torch.Generator(device=device).manual_seed(2)
    t = torch.arange(B, device=device) % 9 + 1
    noise = torch.randn(B, N, 3, generator=gen, device=device)

    def run():
        return step(state, next(prefetch(iter([features]), depth=1)), t=t, noise=noise, dropout_seed=3)

    return run


# ------------------------------------------------------------------ #
# CPU
# ------------------------------------------------------------------ #


def test_span_is_one_shared_null_context_without_a_profiler():
    assert not profiling.recording()
    off = profiling.span("a")
    assert off is profiling.span("b") and off is profiling._OFF
    with off:
        pass


def test_steps_make_no_record_function_without_a_profiler(monkeypatch):
    """A reverse step and a training step run with
    torch.profiler.record_function made to raise: with no profiler
    recording, no span creates one. (torch's optimizer opens its own range
    through torch.autograd.profiler, which is left as it is.)"""
    def boom(*args, **kwargs):
        raise AssertionError("a RecordFunction was created with no profiler recording")

    sample, train = _sample_step(), _train_step()
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    sample()
    train()


def test_span_records_under_a_profiler():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("outer"):
            profiling.spanned("inner")(torch.ones)(3)
    names = [e.name for e in prof.events()]
    assert "genie2:outer" in names and "genie2:inner" in names
    assert not profiling.recording()


def _spans(fn):
    """The program's span events of one call of `fn` under a CPU profiler,
    each with the names of the spans that enclose it, innermost first."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            parents, p = [], e.cpu_parent
            while p is not None:
                if p.name.startswith(profiling.PREFIX):
                    parents.append(p.name[len(profiling.PREFIX):])
                p = p.cpu_parent
            out.append((e.name[len(profiling.PREFIX):], parents))
    return out


def test_reverse_step_spans_nest():
    spans = _spans(_sample_step())
    assert {name for name, _ in spans} == SAMPLE_SPANS
    chain = ["pair_layer", "pair_stack", "denoiser", "sample_step"]
    trimuls = [parents for name, parents in spans if name == "trimul"]
    assert len(trimuls) == 2 * TINY["numPairTransformLayers"]
    assert all(parents == chain for parents in trimuls)
    assert all(parents[-1] == "sample_step" for name, parents in spans if name != "sample_step")
    assert [p for n, p in spans if n == "eigh"] == [["orientations", "pair_features", "denoiser", "sample_step"]]
    assert [p for n, p in spans if n == "posterior"] == [["sample_step"]]


def test_training_step_spans_nest():
    """train_step holds forward, loss, backward and optimizer; remat
    recomputes each pair layer under the backward (on the CPU the backward
    runs on the calling thread)."""
    spans = _spans(_train_step())
    assert {name for name, _ in spans} == TRAIN_SPANS
    for name in ("noise", "forward", "loss", "backward", "grad_norm", "optimizer", "ema", "prefetch_wait"):
        found = [p for n, p in spans if n == name]
        assert found, name
        want = [] if name == "prefetch_wait" else ["train_step"]
        assert all(p == want for p in found), (name, found)
    layers = [p for n, p in spans if n == "pair_layer"]
    n = TINY["numPairTransformLayers"]
    assert sorted(layers) == sorted([["pair_stack", "denoiser", "forward", "train_step"]] * n
                                    + [["backward", "train_step"]] * n)


# Every kernel wrapper's launch counter, each named by its module (all
# imported above).
LAUNCH_COUNTERS = {
    "trimul_project", "trimul_project_backward", "trimul_contract_out", "trimul_contract_in", "trimul_epilogue",
    "trimul_epilogue_backward", "trimul_epilogue_partial", "trimul_epilogue_finish", "contract_cm_km",
    "ipa_attention", "triangle_multiply_cm", "triangle_multiply_nlayout", "tri_attention", "pair_transition",
}


def test_counters_snapshot_names_every_counter(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", dict(profiling.COUNTERS))
    snap = profiling.counters()
    assert {f"launch.{k}" for k in LAUNCH_COUNTERS} == {k for k in snap if k.startswith("launch.")}
    assert {f"allreduce_bytes.{a}.{d}" for a in ("tp", "seq") for d in ("forward", "backward")} <= set(snap)
    assert "host_sync.eigh_status" in snap and all(isinstance(v, int) for v in snap.values())
    profiling.count("launch.trimul_project", 7)
    profiling.count("allreduce_bytes.tp.backward", 12)
    profiling.count("allreduce_bytes.seq.forward", 5)
    profiling.count("host_sync.eigh_status", 3)
    now = profiling.counters()
    assert now["launch.trimul_project"] - snap["launch.trimul_project"] == 7
    assert now["allreduce_bytes.tp.backward"] - snap["allreduce_bytes.tp.backward"] == 12
    assert now["allreduce_bytes.seq.forward"] - snap["allreduce_bytes.seq.forward"] == 5
    assert now["host_sync.eigh_status"] - snap["host_sync.eigh_status"] == 3
    profiling.reset()
    assert profiling.counters() == dict.fromkeys(now, 0)


def test_counters_import_no_layer_above():
    """utils/profiling.py is the bottom layer: importing it and taking a
    snapshot in a fresh interpreter loads no module of ops/ or parallel/
    (they import it, to count)."""
    code = ("import sys\n"
            "from genie2_tpu_torch.utils import profiling\n"
            "snap = profiling.counters()\n"
            "assert 'host_sync.eigh_status' in snap, snap\n"
            "print(sorted(m for m in sys.modules if m.startswith(('genie2_tpu_torch.ops', "
            "'genie2_tpu_torch.parallel'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_host_sync_counts_card_tensors_only(monkeypatch):
    monkeypatch.setattr(profiling, "COUNTERS", dict(profiling.COUNTERS))
    before = profiling.counters()
    _sample_step()()  # eigh on the CPU reads no status from a card
    profiling.host_sync("eigh_status", torch.zeros(1))
    assert profiling.counters() == before
    profiling.host_sync("eigh_status", 1.5)
    assert profiling.counters() == before
    profiling.count("host_sync.eigh_status", 2)
    profiling.count("extra")
    snap = profiling.counters()
    assert snap["host_sync.eigh_status"] == before["host_sync.eigh_status"] + 2 and snap["extra"] == 1


def test_recompute_span_names():
    assert launch.recomputed_name(trimul._PROJECT_PLAIN) == "project_gated_cm"
    assert launch.recomputed_name(functools.partial(trimul._PROJECT_PLAIN, col_mask=None)) == "project_gated_cm"
    assert launch.recomputed_name(trimul._EPILOGUE_PLAIN) == "epilogue_cm"
    assert launch.recomputed_name(functools.partial(ipa.ipa_attention_plain, inf=1.0)) == "ipa_attention"
    assert launch.recomputed_name(functools.partial(tri_att.tri_attention_plain, inf=1.0)) == "tri_attention"
    assert launch.recomputed_name(trimul.epilogue_partial_plain) == "epilogue_partial"


def test_program_opens_profiler_ranges_through_span_only():
    """record_function appears in utils/profiling.py alone, so every range
    of the program (the parallel/ all-reduces among them) is gated."""
    found = []
    for root, _, names in os.walk(os.path.join(REPO, "genie2_tpu_torch")):
        for name in names:
            path = os.path.join(root, name)
            if name.endswith(".py") and "record_function" in open(path).read():
                found.append(os.path.relpath(path, REPO))
    assert found == [os.path.join("genie2_tpu_torch", "utils", "profiling.py")]


# ------------------------------------------------------------------ #
# The card
# ------------------------------------------------------------------ #


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _host_syncs():
    return sum(v for k, v in profiling.counters().items() if k.startswith("host_sync."))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sample", "train"])
def test_sync_debug_mode_counts_what_the_counters_count(device, kind):
    """B N^2 = 2 x 128^2 pairwise orientations: two eigh chunks a step."""
    fn = _sample_step(device, B=2, N=128) if kind == "sample" else _train_step(device, B=2, N=128)
    fn()
    torch.cuda.synchronize()
    before = _host_syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    delta = _host_syncs() - before
    assert delta == 2, profiling.counters()
    assert len(syncs) == delta, syncs


def _chrome_trace(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)
    return events["traceEvents"] if isinstance(events, dict) else events


@pytest.mark.cuda
def test_recompute_spans_run_on_autograd_thread_around_their_kernels(device, tmp_path):
    step = _train_step(device, B=2, N=64, ema_decay=0.0)
    step()
    torch.cuda.synchronize()
    seen = []
    recompute = launch.recompute_backward

    def watched(*args, **kwargs):
        seen.append((torch.autograd._profiler_enabled(), torch.autograd.profiler._is_profiler_enabled))
        return recompute(*args, **kwargs)

    launch.recompute_backward = watched
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        launch.recompute_backward = recompute
    assert seen and all(thread_local for thread_local, _ in seen), seen
    events = [e for e in _chrome_trace(prof, tmp_path) if e.get("ph") == "X"]
    # The host's ranges (the device timeline repeats them as gpu_user_annotation).
    host = [e for e in events if e.get("cat") == "user_annotation"]
    main = {e["tid"] for e in host if e["name"] == "genie2:train_step"}
    # The recomputed backwards, and the projection's and the epilogue's
    # backward kernels (float32).
    spans = [e for e in host if e["name"].startswith("genie2:recompute.")
             or e["name"] in ("genie2:backward.trimul_project", "genie2:backward.trimul_epilogue")]
    names = {e["name"] for e in spans}
    assert {"genie2:backward.trimul_project", "genie2:backward.trimul_epilogue",
            "genie2:recompute.ipa_attention"} <= names, names
    assert not {"genie2:recompute.project_gated_cm", "genie2:recompute.epilogue_cm"} & names, names
    assert all(e["tid"] not in main for e in spans)
    kernels = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel" and "correlation" in e["args"]}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("args", {}).get("correlation") in kernels]
    for s in spans:
        inside = [e for e in launches if e["tid"] == s["tid"] and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]]
        assert inside, s["name"]


@pytest.mark.cuda
def test_program_spans_hold_what_the_benchmark_hooks_hold(device):
    """One traced window of the triangle-attention cell's traffic: the
    device time under genie2:trimul, genie2:tri_att and genie2:ipa equals
    that under the hooks' pb:TriangleMultiplicativeUpdate,
    pb:TriangleAttention and pb:InvariantPointAttention within 1%."""
    from portbench.harness import program_spans, registry, tracing

    cell = registry.find_cell("genie2-triatt.uncond-l256-b4")
    gen = registry.generator(cell.traffic["generator"]).Generator(cell, 3100000007, device)
    gen.setup()
    pairs = {"TriangleMultiplicativeUpdate": "trimul", "TriangleAttention": "tri_att",
             "InvariantPointAttention": "ipa"}
    hooks = tracing.Spans(gen.model, {cls: (lambda module, args: (0.0, 0.0)) for cls in pairs})
    program_spans.keep_program_spans()

    def window():
        for _ in range(3):
            gen.step()
        torch.cuda.synchronize()

    try:
        tr = tracing.profile(window, device)
    finally:
        hooks.remove()
        gen.release()
    for cls, span in pairs.items():
        hooked, spanned = tr.by_range[f"pb:{cls}"], tr.by_range[f"genie2:{span}"]
        assert hooked > 0 and abs(spanned - hooked) <= 0.01 * hooked, (cls, hooked, spanned)
