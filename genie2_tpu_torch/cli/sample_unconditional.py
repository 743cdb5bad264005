"""Unconditional sampling CLI.

Same flags and output layout as genie2_tpu's (`{outdir}/pdbs/{length}_{i}.pdb`),
plus `--device` (default cuda; `--device cpu` runs the plain versions on the
CPU). Lengths run max -> min, shuffled unless --sequential_order. Flags of
samplers that are not ported yet raise NotImplementedError when given.

    python -m genie2_tpu_torch.cli.sample_unconditional --name NAME --epoch E \
        --rootdir results --scale 0.6 --outdir out --num_samples 2 --batch_size 2
"""

from __future__ import annotations

import argparse
import random
import time

import torch

# flag -> the value that means "not given"
_NOT_PORTED = {
    "ddim_steps": None, "ddim_eta": None, "ddim_eta_switch_t": None, "dpm_steps": None,
    "fast_spacing": None, "dump_trajectory_every": None, "pack": False,
    "mesh_seq": None, "mesh_model": None,
}


def run_tasks(args):
    """Sample every length of the sweep; returns {length: seconds}."""
    from genie2_tpu_torch.sampling import UnconditionalSampler
    from genie2_tpu_torch.utils.model_io import load_pretrained_model

    given = [f"--{k}" for k, unset in _NOT_PORTED.items() if getattr(args, k) != unset]
    if args.num_devices not in (None, 1):
        given.append("--num_devices")
    if given:
        raise NotImplementedError(f"{', '.join(given)}: not ported to genie2_tpu_torch yet")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, config = load_pretrained_model(args.rootdir, args.name, args.epoch, ema=args.ema, device=args.device)
    sampler = UnconditionalSampler(model, config)

    lengths = list(range(args.max_length, args.min_length - 1, -args.length_step))
    if not args.sequential_order:
        random.seed(0)
        random.shuffle(lengths)

    seconds = {}
    for length in lengths:
        t0 = time.perf_counter()
        remaining, offset = args.num_samples, 0
        while remaining > 0:
            batch = min(args.batch_size, remaining)
            sampler.sample({
                "scale": args.scale, "outdir": args.outdir, "num_samples": batch,
                "prefix": str(length), "offset": offset, "length": length, "seed": args.seed,
            })
            offset += batch
            remaining -= batch
        seconds[length] = time.perf_counter() - t0
        print(f"length {length}: {args.num_samples} samples done in {seconds[length]:.2f} s", flush=True)
    return seconds


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", type=str, required=True, help="Model name")
    parser.add_argument("--epoch", type=int, required=True, help="Model epoch")
    parser.add_argument("--rootdir", type=str, default="results", help="Root directory")
    parser.add_argument("--scale", type=float, required=True, help="Sampling noise scale")
    parser.add_argument("--outdir", type=str, required=True, help="Output directory")
    parser.add_argument("--num_samples", type=int, default=5, help="Samples per length")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--min_length", type=int, default=50)
    parser.add_argument("--max_length", type=int, default=256)
    parser.add_argument("--length_step", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ema", action="store_true", help="Sample from epoch.{E}.ema.ckpt")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; no card without --device cpu is an error")
    parser.add_argument("--sequential_order", action="store_true", help="Run in decreasing order of length")
    parser.add_argument("--num_devices", type=int, default=None, help="Only 1 is supported")
    parser.add_argument("--pack", action="store_true", help="(not ported)")
    for flag, typ in (("ddim_steps", int), ("ddim_eta", float), ("ddim_eta_switch_t", int),
                      ("dpm_steps", int), ("fast_spacing", str), ("dump_trajectory_every", int),
                      ("mesh_seq", int), ("mesh_model", int)):
        parser.add_argument(f"--{flag}", type=typ, default=None, help="(not ported)")
    return run_tasks(parser.parse_args(argv))


if __name__ == "__main__":
    main()
