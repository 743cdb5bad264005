"""Unconditional sampling CLI.

Same flags and output layout as genie2_tpu's (`{outdir}/pdbs/{length}_{i}.pdb`),
plus `--device` (default cuda; `--device cpu` runs the plain versions on the
CPU). Lengths run max -> min, shuffled unless --sequential_order; `--pack`
fills every batch with samples of mixed lengths grouped by padding bucket.
Under torchrun, `--num_devices N` (or -1) shards every batch over the N
ranks, or with `--mesh_seq S` and `--mesh_model M` over N / (S M) data
indices of S seq ranks that split the pair representation's rows, each of
M model ranks that split the weights, and rank 0 writes the files
(cli/common.py).

    python -m genie2_tpu_torch.cli.sample_unconditional --name NAME --epoch E \
        --rootdir results --scale 0.6 --outdir out --num_samples 2 --batch_size 2
"""

from __future__ import annotations

import argparse
import random
import time

from genie2_tpu_torch.cli.common import add_model_arguments, add_solver_arguments, load_model, solver_params
from genie2_tpu_torch.parallel import is_main


def run_packed(args, model, config, mesh):
    """--pack: every batch full, lengths grouped by padding bucket.
    Returns {"packed": seconds}."""
    from genie2_tpu_torch.sampling import PackedUnconditionalSampler, bucket_length

    sampler = PackedUnconditionalSampler(model, config, mesh=mesh)
    tasks = [
        (length, i)
        for length in range(args.max_length, args.min_length - 1, -args.length_step)
        for i in range(args.num_samples)
    ]
    tasks.sort(key=lambda t: (bucket_length(t[0], sampler.bucket), t[0], t[1]))

    t0 = time.perf_counter()
    for start in range(0, len(tasks), args.batch_size):
        chunk = tasks[start : start + args.batch_size]
        sampler.sample({
            "scale": args.scale, "outdir": args.outdir, "num_samples": len(chunk), "prefix": "packed",
            "offset": start, "lengths": [length for length, _ in chunk],
            "names": [f"{length}_{i}" for length, i in chunk], "seed": args.seed, **solver_params(args),
        })
    seconds = time.perf_counter() - t0
    if is_main(mesh):
        print(f"packed sweep: {len(tasks)} samples done in {seconds:.2f} s", flush=True)
    return {"packed": seconds}


def run_tasks(args):
    """Sample every length of the sweep; returns {length: seconds}."""
    from genie2_tpu_torch.sampling import UnconditionalSampler

    model, config, mesh = load_model(args)
    if args.pack:
        return run_packed(args, model, config, mesh)
    sampler = UnconditionalSampler(model, config, mesh=mesh)

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
                "scale": args.scale, "outdir": args.outdir, "num_samples": batch, "prefix": str(length),
                "offset": offset, "length": length, "seed": args.seed, **solver_params(args),
            })
            offset += batch
            remaining -= batch
        seconds[length] = time.perf_counter() - t0
        if is_main(mesh):
            print(f"length {length}: {args.num_samples} samples done in {seconds[length]:.2f} s", flush=True)
    return seconds


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_arguments(parser)
    parser.add_argument("--num_samples", type=int, default=5, help="Samples per length")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--min_length", type=int, default=50)
    parser.add_argument("--max_length", type=int, default=256)
    parser.add_argument("--length_step", type=int, default=1)
    parser.add_argument("--sequential_order", action="store_true", help="Run in decreasing order of length")
    parser.add_argument("--pack", action="store_true", help="Pack mixed lengths into full bucket-grouped batches")
    add_solver_arguments(parser)
    return run_tasks(parser.parse_args(argv))


def cli():
    """The console script's entry point: `main` with its result dropped, so
    that the script exits with status 0."""
    main()


if __name__ == "__main__":
    main()
