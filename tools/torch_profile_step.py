#!/usr/bin/env python3
"""Where a reverse-diffusion step of genie2_tpu_torch spends its time on the card.

Runs the sampler's reverse step (Frenet frames, the full-width denoiser of
configs/example.configuration with seeded weights, the posterior mean) a
few times under torch.profiler and prints one JSON line: the wall time per
step, the device time per step grouped by kernel family (the three TriMul
kernels, the IPA attention kernel, the triangle attention kernel, eigh,
matrix products, the rest), the device's busy and idle shares, and the top
kernels by device time. `--tri_att` turns triangle attention on in the
configuration's pair layers.

`--tds` profiles the twisted step of TDS/SMC motif scaffolding instead
(sampling/smc.py; defaults to L=75 and 4 particles, with a motif of 10 and
8 residues and 1000 placements): the denoiser forward and its backward
with respect to x_t, the potential and the weights. Its families add the
backward's, read from the program's spans (utils/profiling.py): the
contraction's backward launches (`bwd_contract`, the span
`genie2:backward.trimul_contract`: the trimul_contract and contract_cm_km
kernels inside ContractCM.backward), the projection's and the epilogue's
backward kernels (`bwd_project`, `bwd_epilogue`, the spans
`genie2:backward.trimul_project` and `genie2:backward.trimul_epilogue`:
float32) and the recomputed plain versions (`bwd_recompute_project` and
`bwd_recompute_epilogue` for bf16, `_ipa`, `_tri_attention`: the spans
`genie2:recompute.<kernel>`), each the device time of the kernels that run
inside its span (part of the kernel families too, not added to them) and
the span's extent on the device (`..._span`, idle gaps included), 0 where
the step has no such span; and it times the same steps untwisted (forward
only) beside them.

`--train` profiles one training step instead (train/state.py; defaults to
L=256 and batch 4, the configuration's `batchSize`, with dropout and remat
as configured, the full-length structures of random walks and fixed t,
noise and dropout seed): the forward's pair layers (`pair_layer_forward`),
remat's second forward of them during the backward (`remat_forward`: the
spans `genie2:pair_layer` outside the span `genie2:forward`), the backward
families as `--tds` reports them, and the Adam update (its foreach kernels,
family `optimizer`); peak memory. `--no_remat` turns remat off. The step
runs as the one rank of a data-parallel NCCL group, so its gradient
all-reduce (`grad_allreduce`, the span `genie2:grad_allreduce` of
parallel/mesh.py) is a family of its own.

    python3 tools/torch_profile_step.py --length 256 --batch 2 --quat eigh [--tri_att]
    python3 tools/torch_profile_step.py --tds
    python3 tools/torch_profile_step.py --train [--dtype bf16] [--no_remat]

Needs a CUDA card; imports torch and genie2_tpu_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FAMILIES = (
    # torch's foreach kernels: the Adam update (and the EMA where it is on).
    ("optimizer", ("multi_tensor_apply",)),
    ("trimul_project", ("project_kernel",)),
    ("trimul_project_backward", ("project_backward",)),
    # Before trimul_epilogue: the backward's kernels are named epilogue_backward_*.
    ("trimul_epilogue_backward", ("epilogue_backward",)),
    # The standalone model-layout contraction; its channel-major variants
    # share the TriMul contraction's tile kernel and name.
    ("triangle_contract", ("chan_contract_kernel",)),
    ("trimul_contract", ("contract_kernel",)),
    ("trimul_epilogue", ("epilogue_kernel",)),
    ("ipa_attention", ("ipa_kernel",)),
    ("tri_attention", ("tri_att_kernel",)),
    # The pair transition's kernel and the one that splits its weights.
    ("pair_transition", ("transition_kernel", "prep_kernel")),
    ("eigh", ("syev", "cusolver", "jacobi", "eig")),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "dot")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
)


# The program's spans (utils/profiling.py) read by --tds and --train, under
# the keys this tool has always printed.
SPAN_PREFIX = "genie2:"
BACKWARD_SPANS = {
    "genie2:backward.trimul_contract": "bwd_contract",
    "genie2:backward.trimul_project": "bwd_project",
    "genie2:backward.trimul_epilogue": "bwd_epilogue",
    "genie2:recompute.project_gated_cm": "bwd_recompute_project",
    "genie2:recompute.epilogue_cm": "bwd_recompute_epilogue",
    "genie2:recompute.ipa_attention": "bwd_recompute_ipa",
    "genie2:recompute.tri_attention": "bwd_recompute_tri_attention",
    "genie2:recompute.pair_transition": "bwd_recompute_transition",
}
TRAIN_SPANS = dict(BACKWARD_SPANS, **{"genie2:grad_allreduce": "grad_allreduce"})


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise_and_other"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--length", type=int, default=None, help="default 256, or 75 with --tds")
    parser.add_argument("--batch", type=int, default=None, help="default 2, or 4 particles with --tds")
    parser.add_argument("--quat", choices=("closed", "eigh"), default=None,
                        help="default eigh (released weights' method); --train: the configuration's (closed)")
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    parser.add_argument("--tri_att", action="store_true", help="triangle attention in the pair layers")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tds", action="store_true", help="profile the twisted TDS step (forward + backward)")
    parser.add_argument("--train", action="store_true", help="profile the training step")
    parser.add_argument("--no_remat", action="store_true", help="--train without remat")
    args = parser.parse_args(argv)
    if args.quat is None and not args.train:
        args.quat = "eigh"
    if args.tds:
        return profile_tds(args)
    if args.train:
        return profile_train(args)
    args.length, args.batch = args.length or 256, args.batch or 2

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.nn.policy import apply_denoiser, compute_dtype
    from genie2_tpu_torch.sampling.base import bucket_length, pad_residues
    from genie2_tpu_torch.sampling.ddpm import reverse_step
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    config = Config(os.path.join(REPO, "configs", "example.configuration"),
                    overrides={"rotToQuatMethod": args.quat, "includeTriangularAttention": args.tri_att})
    torch.manual_seed(args.seed)
    dtype = compute_dtype(args.dtype)
    model = randomize_zero_init(Denoiser.from_config(config), args.seed).to(dev).eval().to(dtype)
    schedule = Schedule.create(config.diffusion["n_timestep"], device=dev)

    n = bucket_length(args.length)
    batch = batchify([create_empty_features([args.length]) for _ in range(args.batch)])
    features = to_device(pad_residues(batch, n), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    trans = torch.randn(args.batch, n, 3, generator=gen, device=dev) * features["residue_mask"][..., None]
    noise = torch.randn(args.batch, n, 3, generator=gen, device=dev)

    with torch.inference_mode():
        static_bias = model.pair_feature_net.static_bias(features, dtype)

        def model_fn(frames, t_vec):
            return apply_denoiser(model, frames, t_vec, features, static_bias, dtype)

        def step(t):
            return reverse_step(model_fn, schedule, features, trans, t, noise, 0.6)

        for t in (900, 899):  # warm up
            step(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.steps):
            step(800 - i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / args.steps * 1e3

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(args.steps):
                step(700 - i)
            torch.cuda.synchronize()

    by_family = defaultdict(float)
    by_kernel = defaultdict(float)
    for e in prof.events():
        # Kernels and copies on the card only: the program's spans show on
        # the device timeline too.
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) \
                or e.name.startswith(SPAN_PREFIX):
            continue
        us = e.time_range.elapsed_us()
        by_kernel[e.name] += us
        by_family[family(e.name)] += us
    device_ms = sum(by_family.values()) / 1e3 / args.steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "smi": smi, "length": args.length, "padded": n, "batch": args.batch, "quat": args.quat,
        "tri_att": args.tri_att, "dtype": args.dtype, "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "family_ms_per_step": {k: v / 1e3 / args.steps for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / args.steps] for k, v in top],
    }), flush=True)


def profile_tds(args):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.nn.policy import apply_denoiser, compute_dtype
    from genie2_tpu_torch.sampling import enumerate_motif_placements, placements_to_positions, tds_sample_injected
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    length, particles = args.length or 75, args.batch or 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    config = Config(os.path.join(REPO, "configs", "example.configuration"),
                    overrides={"rotToQuatMethod": args.quat, "includeTriangularAttention": args.tri_att})
    torch.manual_seed(args.seed)
    dtype = compute_dtype(args.dtype)
    model = randomize_zero_init(Denoiser.from_config(config), args.seed).to(dev).eval().to(dtype)
    model.requires_grad_(False)

    features = to_device(batchify([create_empty_features([length]) for _ in range(particles)]), dev)
    rng = np.random.default_rng(args.seed)
    placements = enumerate_motif_placements(length, [10, 8], 1000, rng=rng)
    positions = torch.as_tensor(placements_to_positions(placements), device=dev)
    target = torch.as_tensor(rng.normal(size=(18, 3)).astype(np.float32) * 5, device=dev)
    schedule = Schedule.create(config.diffusion["n_timestep"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    init = torch.randn(particles, length, 3, generator=gen, device=dev) * 10
    steps = args.steps
    noises = torch.randn(steps, particles, length, 3, generator=gen, device=dev)
    offsets = torch.rand(steps, generator=gen, device=dev) / particles
    with torch.no_grad():
        static_bias = model.pair_feature_net.static_bias(features, dtype)

    def model_fn(frames, t_vec):
        return apply_denoiser(model, frames, t_vec, features, static_bias, dtype)

    def run(twisted: bool):
        # steps t = steps .. 1; untwist_below 1 twists every one of them
        return tds_sample_injected(model_fn, schedule, features, positions, target, init, noises, offsets,
                                   untwist_below=1 if twisted else steps + 1)

    def wall_ms(twisted):
        run(twisted)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(twisted)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    out = {"smi": smi, "mode": "tds", "length": length, "particles": particles, "placements": len(placements),
           "quat": args.quat, "tri_att": args.tri_att, "dtype": args.dtype, "steps": steps}
    for twisted in (True, False):
        key = "twisted" if twisted else "untwisted"
        out[f"wall_ms_per_step_{key}"] = wall_ms(twisted)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(twisted)
            torch.cuda.synchronize()
        out[f"peak_memory_bytes_{key}"] = torch.cuda.max_memory_allocated()
        summary = summarize(prof, BACKWARD_SPANS, steps, out[f"wall_ms_per_step_{key}"])
        out.update({f"{k}_{key}": v for k, v in summary.items()})
    print(json.dumps(out), flush=True)
    return out


def summarize(prof, labels, steps, wall_ms, pair_layers=False):
    """Device ms a step by kernel family, the top kernels, the busy share,
    and for each of the program's spans named in `labels` (span name ->
    output key) its device ms (kernels that start inside it) and its
    extent. The spans appear on the device timeline from their first
    kernel's start to their last one's end (idle gaps included): they are
    not kernels, and neither is any other range the device timeline shows
    (`Optimizer.step#Adam.step` showed there in the training step run as an
    NCCL rank). With `pair_layers`, the pair layers' spans too: inside the
    training step's forward span (`pair_layer_forward`) or outside it, remat's
    recompute under the backward (`remat_forward`)."""
    from torch.autograd import DeviceType

    spans = defaultdict(list)
    by_family, by_kernel, count = defaultdict(float), defaultdict(float), defaultdict(int)
    kernels, forwards, layers = [], [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        extent = (e.time_range.start, e.time_range.end)
        if e.name in labels:
            spans[labels[e.name]].append(extent)
            continue
        if e.name == "genie2:forward":
            forwards.append(extent)
        elif e.name == "genie2:pair_layer" and pair_layers:
            layers.append(extent)
        if getattr(e, "is_user_annotation", False) or e.name.startswith(SPAN_PREFIX):
            continue
        us = e.time_range.elapsed_us()
        by_family[family(e.name)] += us
        by_kernel[e.name] += us
        count[e.name] += 1
        kernels.append((e.time_range.start, us))
    for lo, hi in layers:
        inside = any(a <= lo and hi <= b for a, b in forwards)
        spans["pair_layer_forward" if inside else "remat_forward"].append((lo, hi))
    device_ms = sum(by_family.values()) / 1e3 / steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    fams = {k: v / 1e3 / steps for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])}
    for label in sorted(set(labels.values()) | set(spans)):
        ranges = spans.get(label, [])
        inside = sum(us for start, us in kernels if any(lo <= start < hi for lo, hi in ranges))
        fams[label] = inside / 1e3 / steps
        fams[label + "_span"] = sum(hi - lo for lo, hi in ranges) / 1e3 / steps
    return {
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / steps, count[k] / steps] for k, v in top],
        "device_ms_per_step": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "family_ms_per_step": fams,
    }


def profile_train(args):
    """One training step at full width, profiled: see the module docstring."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.parallel import create_mesh
    from genie2_tpu_torch.train import create_train_state, make_train_step
    from genie2_tpu_torch.utils.model_io import init_model
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    length, batch = args.length or 256, args.batch or 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    overrides = {"includeTriangularAttention": args.tri_att, "remat": not args.no_remat,
                 "maximumNumResidues": max(length, 256)}
    if args.quat:
        overrides["rotToQuatMethod"] = args.quat
    config = Config(os.path.join(REPO, "configs", "example.configuration"), overrides=overrides)
    args.quat = config.tpu["rot_to_quat_method"]
    model = randomize_zero_init(init_model(config, args.seed, "cpu"), args.seed).to(dev)
    state = create_train_state(model, config.optimization["lr"])
    schedule = Schedule.create(config.diffusion["n_timestep"], device=dev)
    store = tempfile.mkdtemp(prefix="profile_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    step = make_train_step(schedule, config.training["condition_loss_weight"], args.dtype,
                           mesh=create_mesh(-1, dev))

    rng = np.random.default_rng(args.seed)
    feats = []
    for _ in range(batch):
        f = create_empty_features([length])
        walk = rng.normal(size=(length, 3))
        xyz = np.cumsum(3.8 * walk / np.linalg.norm(walk, axis=-1, keepdims=True), axis=0)
        f["atom_positions"] = xyz - xyz.mean(0)
        feats.append(f)
    features = to_device(batchify(feats), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    inject = dict(t=torch.randint(1, schedule.n_timestep + 1, (batch,), generator=gen, device=dev),
                  noise=torch.randn(batch, length, 3, generator=gen, device=dev), dropout_seed=args.seed)

    for _ in range(2):  # warm up
        step(state, features, **inject)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step(state, features, **inject)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.steps * 1e3
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, features, **inject)
        torch.cuda.synchronize()
    out = {"smi": smi, "mode": "train", "length": length, "batch": batch, "quat": args.quat,
           "tri_att": args.tri_att, "dtype": args.dtype, "remat": not args.no_remat, "steps": args.steps,
           "wall_ms_per_step": wall_ms, "residues_per_s": batch * length / wall_ms * 1e3,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    out.update(summarize(prof, TRAIN_SPANS, args.steps, wall_ms, pair_layers=True))
    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
