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

    python3 tools/torch_profile_step.py --length 256 --batch 2 --quat eigh [--tri_att]

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
    ("trimul_project", ("project_kernel",)),
    # The standalone model-layout contraction; its channel-major variants
    # share the TriMul contraction's tile kernel and name.
    ("triangle_contract", ("chan_contract_kernel",)),
    ("trimul_contract", ("contract_kernel",)),
    ("trimul_epilogue", ("epilogue_kernel",)),
    ("ipa_attention", ("ipa_kernel",)),
    ("tri_attention", ("tri_att_kernel",)),
    ("eigh", ("syev", "cusolver", "jacobi", "eig")),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "gemv", "dot")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise_and_other"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--length", type=int, default=256)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--quat", choices=("closed", "eigh"), default="eigh")
    parser.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32")
    parser.add_argument("--tri_att", action="store_true", help="triangle attention in the pair layers")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

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
        if e.device_type != DeviceType.CUDA:  # kernels and copies on the card only
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


if __name__ == "__main__":
    main()
