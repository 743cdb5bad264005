"""Motif scaffolding CLI (fixed placement).

Same flags and output layout as genie2_tpu's: one task per motif problem PDB
in --datadir, outputs under `{outdir}/motif={name}/pdbs` and `motif_pdbs`.
`--strength` > 0 applies classifier-free guidance eps_u + (1 + s)(eps_c -
eps_u), with the motif masks zeroed for the unconditional branch (two model
calls per step); 0 is the plain conditional model. `--device` defaults to
cuda; `--device cpu` runs the plain versions on the CPU. Under torchrun,
`--num_devices N` (or -1) shards every batch over the N ranks, or with
`--mesh_seq S` and `--mesh_model M` over N / (S M) data indices of S seq
ranks that split the pair representation's rows, each of M model ranks
that split the weights, and rank 0 writes the files (cli/common.py).

    python -m genie2_tpu_torch.cli.sample_scaffold --name NAME --epoch E \
        --rootdir results --scale 0.4 --outdir out --datadir data/design25
"""

from __future__ import annotations

import argparse
import glob
import os
import time

from genie2_tpu_torch.cli.common import add_model_arguments, add_solver_arguments, load_model, solver_params
from genie2_tpu_torch.parallel import is_main


def run_tasks(args):
    """Sample every motif problem of --datadir; returns {motif name: seconds}."""
    from genie2_tpu_torch.sampling import ScaffoldSampler

    model, config, mesh = load_model(args)
    sampler = ScaffoldSampler(model, config, mesh=mesh)

    paths = sorted(glob.glob(os.path.join(args.datadir, "*.pdb")))
    if args.motif_name is not None:
        paths = [p for p in paths if os.path.basename(p)[:-4] == args.motif_name]
    if not paths:
        raise FileNotFoundError(f"no motif problems under {args.datadir}")

    seconds = {}
    for path in paths:
        motif_name = os.path.basename(path)[:-4]
        outdir = os.path.join(args.outdir, f"motif={motif_name}")
        t0 = time.perf_counter()
        remaining, offset = args.num_samples, 0
        while remaining > 0:
            batch = min(args.batch_size, remaining)
            sampler.sample({
                "scale": args.scale, "outdir": outdir, "num_samples": batch, "prefix": motif_name,
                "offset": offset, "filepath": path, "strength": args.strength, "seed": args.seed,
                **solver_params(args),
            })
            offset += batch
            remaining -= batch
        seconds[motif_name] = time.perf_counter() - t0
        if is_main(mesh):
            print(f"motif {motif_name}: {args.num_samples} samples done in {seconds[motif_name]:.2f} s", flush=True)
    return seconds


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_model_arguments(parser)
    parser.add_argument("--strength", type=float, default=0,
                        help="Classifier-free guidance strength (0 = plain conditional; "
                             ">0 doubles model calls per step)")
    parser.add_argument("--num_samples", type=int, default=100, help="Samples per problem")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--motif_name", type=str, default=None)
    parser.add_argument("--datadir", type=str, default="data/design25")
    add_solver_arguments(parser)
    return run_tasks(parser.parse_args(argv))


def cli():
    """The console script's entry point: `main` with its result dropped, so
    that the script exits with status 0."""
    main()


if __name__ == "__main__":
    main()
