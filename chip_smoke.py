#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (genie2_tpu_torch) on one card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device    print the card's name and power limit, require CUDA, build
               the kernels from genie2_tpu_torch/csrc with nvcc;
  2. kernels   each TriMul kernel against its plain PyTorch version on the
               card, float32 and bfloat16, at N=256 and the ragged N=224;
               times of the kernel, the plain version and a library call;
  3. denoiser  one full-width denoiser call at L=256 with the kernels, then
               with the plain versions swapped in, compared on z;
  4. main      the unconditional sampling CLI from a seeded Lightning-style
               checkpoint: 1000 steps at L=256 and L=200, PDBs checked,
               kernel launches counted;
then one JSON line of the kernels and, last, the device line.

Imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor fp32; dense bf16
SEED = 0
# Tolerances, relative to max |plain|:
#   float32 1e-4: the kernels sum in another order than the plain version
#     (and cuBLAS), so results agree to a few float32 ulps per sum;
#   bfloat16 3e-2: both round to bfloat16 at the same points, but a value
#     on a rounding boundary can land one bf16 ulp (2^-8) apart.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Denoiser z, relative to max |z|: ten TriMul calls and eight IPA layers
# carry the kernels' float32 summation-order differences forward.
DENOISER_TOL = 1e-3
C_P = 128  # configs/example.configuration pairFeatureDimension
H_MUL = 128  # triangularMultiplicativeHiddenDimension (default)

KERNELS = [
    {
        "name": "trimul_project",
        "source": "genie2_tpu_torch/csrc/trimul_project.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:125",
    },
    {
        "name": "trimul_contract",
        "source": "genie2_tpu_torch/csrc/trimul_contract.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:185",
    },
    {
        "name": "trimul_epilogue",
        "source": "genie2_tpu_torch/csrc/trimul_epilogue.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:279",
    },
]


class PhaseFailed(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ #
# Phase 1
# ------------------------------------------------------------------ #


def phase_device(state):
    import torch

    line = nvidia_smi_line()
    print(line, flush=True)
    state["smi"] = line
    if not torch.cuda.is_available():
        raise PhaseFailed("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from genie2_tpu_torch.ops import build

    t0 = time.perf_counter()
    per_source = build.build_all(verbose=True)
    emit({
        "phase": "device", "device": torch.cuda.get_device_name(0), "smi": line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": time.perf_counter() - t0, "build_s_per_source": per_source,
    })


# ------------------------------------------------------------------ #
# Phase 2
# ------------------------------------------------------------------ #


def random_trimul_weights(C: int, H: int, gen, device):
    """Random non-zero weights in torch layout (see ops/trimul.py)."""
    import torch

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    return {
        "ln_in_scale": r(C, scale=0.1, offset=1.0), "ln_in_bias": r(C, scale=0.1),
        "w_ap": r(H, C, scale=C ** -0.5), "b_ap": r(H, scale=0.1),
        "w_ag": r(H, C, scale=C ** -0.5), "b_ag": r(H, scale=0.1),
        "w_bp": r(H, C, scale=C ** -0.5), "b_bp": r(H, scale=0.1),
        "w_bg": r(H, C, scale=C ** -0.5), "b_bg": r(H, scale=0.1),
        "ln_out_scale": r(H, scale=0.1, offset=1.0), "ln_out_bias": r(H, scale=0.1),
        "w_z": r(C, H, scale=H ** -0.5), "b_z": r(C, scale=0.1),
        "w_g": r(C, C, scale=C ** -0.5), "b_g": r(C, scale=0.1),
    }


def kernel_bytes_ops(name, B, N, C, H, esize):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the multiply-adds it does, counted as 2 operations each."""
    pair = B * N * N
    if name == "trimul_project":
        w = 4 * (4 * H * C + 4 * H + 2 * C)
        return pair * C * esize + B * N * 4 + w + 2 * pair * H * esize, 2 * pair * C * 4 * H
    if name == "trimul_contract":
        return 3 * B * H * N * N * esize, 2 * B * H * N ** 3
    w = 4 * (H * C + C * C + 5 * C)
    return pair * H * esize + pair * C * esize + w + pair * C * esize, 2 * pair * (H * C + C * C)


def phase_kernels(state):
    import torch

    from genie2_tpu_torch.ops import trimul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {k["name"]: {} for k in KERNELS}
    failed = []
    for N in (256, 224):
        B = 2
        w32 = random_trimul_weights(C_P, H_MUL, gen, dev)
        n_real = N - 24  # a padded tail, as the sampler's buckets have
        res_mask = (torch.arange(N, device=dev) < n_real).float().expand(B, N).contiguous()
        z32 = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            z = z32.to(dtype)
            # The bf16 policy casts the weights too (nn/policy.py).
            w = {k: v.to(dtype) for k, v in w32.items()}
            a_p, b_p = trimul.project_gated_cm_plain(z, res_mask, w)
            cases = [
                ("trimul_project", None, lambda: trimul.project_gated_cm(z, res_mask, w),
                 lambda: trimul.project_gated_cm_plain(z, res_mask, w), None),
            ]
            for outgoing in (True, False):
                cases.append((
                    "trimul_contract", outgoing,
                    lambda o=outgoing: trimul.contract_cm(a_p, b_p, o),
                    lambda o=outgoing: trimul.contract_cm_plain(a_p, b_p, o),
                    (lambda: torch.matmul(a_p, b_p.transpose(-1, -2))) if outgoing
                    else (lambda: torch.matmul(a_p.transpose(-1, -2), b_p)),
                ))
            x_p = trimul.contract_cm_plain(a_p, b_p, True)
            cases.append(("trimul_epilogue", None, lambda: trimul.epilogue_cm(x_p, z, w),
                          lambda: trimul.epilogue_cm_plain(x_p, z, w), None))
            for name, outgoing, kern, plain, library in cases:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max((g.float() - p.float()).abs().max().item() for g, p in zip(got, want))
                scale = max(p.float().abs().max().item() for p in want)
                rel = err / max(scale, 1e-30)
                finite = all(torch.isfinite(g.float()).all().item() for g in got)
                ok = finite and rel <= TOL[dname]
                bytes_, ops = kernel_bytes_ops(name, B, N, C_P, H_MUL, z.element_size())
                bound_bytes, bound_ops = bytes_ / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
                rec = {
                    "kernel": name, "N": N, "B": B, "dtype": dname, "outgoing": outgoing,
                    "max_abs_err": err, "max_abs_plain": scale, "rel_err": rel, "tol": TOL[dname],
                    "ok": ok, "ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
                    "library_ms": cuda_time_ms(library) if library else None,
                    "bound_ms": max(bound_bytes, bound_ops),
                    "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                }
                emit({"phase": "kernels", **rec})
                if not ok:
                    failed.append(f"{name} N={N} {dname} outgoing={outgoing}: rel {rel:.3g}")
                if N == 256 and dtype == torch.float32:
                    results[name][outgoing] = rec
    state["kernel_main"] = results
    if failed:
        raise PhaseFailed("kernel mismatch: " + "; ".join(failed))


# ------------------------------------------------------------------ #
# Phase 3
# ------------------------------------------------------------------ #


@contextlib.contextmanager
def plain_trimul():
    """Swap the plain versions in for the kernel wrappers (comparison only)."""
    from genie2_tpu_torch.ops import trimul

    saved = (trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm)
    trimul.project_gated_cm = trimul.project_gated_cm_plain
    trimul.contract_cm = trimul.contract_cm_plain
    trimul.epilogue_cm = trimul.epilogue_cm_plain
    try:
        yield
    finally:
        trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm = saved


def example_config():
    from genie2_tpu_torch.config import Config

    return Config(os.path.join(HERE, "configs", "example.configuration"))


def seeded_denoiser(config, device):
    """Full-width denoiser with seeded weights, the zero-initialised
    "final" / "gating" ones included (utils/weights.randomize_zero_init)."""
    import torch

    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    torch.manual_seed(SEED)
    model = randomize_zero_init(Denoiser.from_config(config), SEED)
    return model.to(device).eval()


def phase_denoiser(state):
    import numpy as np
    import torch

    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames
    from genie2_tpu_torch.ops import trimul

    dev = torch.device("cuda")
    config = example_config()
    model = seeded_denoiser(config, dev)
    state["model"] = model
    L = 256
    feats = to_device(batchify([create_empty_features([L]) for _ in range(2)]), dev)
    rng = np.random.default_rng(SEED)
    trans = torch.as_tensor(rng.normal(size=(2, L, 3)).astype(np.float32) * 8.0, device=dev)
    t = torch.tensor([500, 20], dtype=torch.int32, device=dev)
    rots = frenet_frames(trans, feats["chain_index"], feats["residue_mask"])

    def run():
        return model(Rigid(rots, trans), t, feats)["z"]

    with torch.inference_mode():
        trimul.reset_launch_counts()
        z_k = run()
        torch.cuda.synchronize()
        launches = dict(trimul.LAUNCHES)
        ms_k = cuda_time_ms(run, iters=5, warmup=1)
        with plain_trimul():
            z_p = run()
            ms_p = cuda_time_ms(run, iters=5, warmup=1)
    err = (z_k - z_p).abs().max().item()
    scale = z_p.abs().max().item()
    rec = {
        "phase": "denoiser", "L": L, "B": 2, "max_abs_err": err, "max_abs_z": scale,
        "rel_err": err / max(scale, 1e-30), "tol": DENOISER_TOL,
        "ms_kernels": ms_k, "ms_plain": ms_p, "launches_one_call": launches,
        "finite": bool(torch.isfinite(z_k).all().item()),
    }
    emit(rec)
    if not rec["finite"] or rec["rel_err"] > DENOISER_TOL:
        raise PhaseFailed(f"denoiser z disagrees: rel {rec['rel_err']:.3g}")
    expected = config.model["n_pair_transform_layer"]
    if launches["trimul_project"] != 2 * expected or launches["trimul_contract_out"] != expected:
        raise PhaseFailed(f"denoiser launches {launches}")


# ------------------------------------------------------------------ #
# Phase 4
# ------------------------------------------------------------------ #


def phase_main(state):
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_unconditional
    from genie2_tpu_torch.features import read_ca_coords
    from genie2_tpu_torch.ops import trimul

    model = state.get("model") or seeded_denoiser(example_config(), torch.device("cuda"))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        rootdir = os.path.join(work, "results")
        os.makedirs(os.path.join(rootdir, "smoke", "checkpoints"))
        shutil.copy(os.path.join(HERE, "configs", "example.configuration"),
                    os.path.join(rootdir, "smoke", "configuration"))
        torch.save(
            {"state_dict": {f"model.{k}": v.detach().cpu() for k, v in model.state_dict().items()}},
            os.path.join(rootdir, "smoke", "checkpoints", "epoch.1.ckpt"),
        )
        outdir = os.path.join(work, "out")
        lengths = (256, 200)
        argv = [
            "--name", "smoke", "--epoch", "1", "--rootdir", rootdir, "--outdir", outdir,
            "--scale", "0.6", "--num_samples", "2", "--batch_size", "2",
            "--min_length", str(min(lengths)), "--max_length", str(max(lengths)),
            "--length_step", str(max(lengths) - min(lengths)), "--seed", str(SEED),
            "--device", "cuda",
        ]
        trimul.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_length = sample_unconditional.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(trimul.LAUNCHES)

        coords_ok = True
        for L in lengths:
            for i in range(2):
                path = os.path.join(outdir, "pdbs", f"{L}_{i}.pdb")
                if not os.path.isfile(path):
                    raise PhaseFailed(f"missing {path}")
                xyz = read_ca_coords(path)
                coords_ok &= xyz.shape == (L, 3) and bool(np.isfinite(xyz).all())
        n_steps = 1000
        expected = len(lengths) * n_steps * 5  # per direction
        rec = {
            "phase": "main", "lengths": list(lengths), "samples": 2 * len(lengths),
            "seconds": seconds, "samples_per_min": 2 * len(lengths) / seconds * 60.0,
            "ms_per_denoiser_step": seconds / (len(lengths) * n_steps) * 1e3,
            "seconds_per_length": per_length,
            "samples_per_min_at_256": 2 / per_length[256] * 60.0,
            "ms_per_step_at_256": per_length[256] / n_steps * 1e3,
            "batch": 2, "launches": launches, "coords_ok": coords_ok, "smi": state["smi"],
        }
        emit(rec)
        state["launches"] = launches
        if not coords_ok:
            raise PhaseFailed("sampled coordinates are not finite or have the wrong shape")
        want = {
            "trimul_project": 2 * expected, "trimul_contract_out": expected,
            "trimul_contract_in": expected, "trimul_epilogue": 2 * expected,
        }
        if launches != want:
            raise PhaseFailed(f"launch counts {launches}, expected {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------------ #


def kernels_line(state):
    launches = state.get("launches", {})
    out = []
    for k in KERNELS:
        name = k["name"]
        recs = state.get("kernel_main", {}).get(name, {})
        if not recs:
            continue
        rs = list(recs.values())
        entry = {
            **k, "route": "cuda",
            "launches": (launches.get("trimul_contract_out", 0) + launches.get("trimul_contract_in", 0))
            if name == "trimul_contract" else launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs) / len(rs),
            "plain_ms": sum(r["plain_ms"] for r in rs) / len(rs),
            "bound_ms": rs[0]["bound_ms"], "bound_by": rs[0]["bound_by"],
            "library_ms": (sum(r["library_ms"] for r in rs) / len(rs)) if rs[0]["library_ms"] is not None else None,
            "shape": {"B": 2, "N": 256, "C": C_P, "H": H_MUL, "dtype": "float32"},
        }
        if name == "trimul_contract":
            entry["launches_out"] = launches.get("trimul_contract_out", 0)
            entry["launches_in"] = launches.get("trimul_contract_in", 0)
            entry["ms_out"], entry["ms_in"] = recs[True]["ms"], recs[False]["ms"]
        out.append(entry)
    return {"kernels": out}


PHASES = {"device": phase_device, "kernels": phase_kernels, "denoiser": phase_denoiser, "main": phase_main}


def main() -> int:
    import torch

    state = {}
    for name, phase in PHASES.items():
        t0 = time.perf_counter()
        try:
            phase(state)
        except PhaseFailed as e:
            emit({"phase": name, "failed": str(e)})
            return 1
        emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0})
    print(state["smi"], flush=True)
    emit(kernels_line(state))
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
