"""TDS/SMC motif scaffolding CLI (unknown placement).

One SMC run per --motif_index from a MotifBench-style --motif_dir (files
named `{i}_{name}.pdb`, the target length on line 3 as `... : N`, motif
segments separated by TER records), 4 particles by default. Writes
`{outdir}/pdbs/{motif_index}_{i}.pdb`, `{outdir}/motif_location.txt`, the
benchmark manifests `scaffold_info.csv` and `motif_info.csv`, the per-step
trace `{outdir}/logs/metrics.jsonl` and, with --dump_trajectory_every,
`{outdir}/test/{x0,xt}_predicted_test_{step}.pdb`. Flags as genie2_tpu's
CLI, plus `--device` (default cuda; `--device cpu` runs the plain versions
on the CPU). Under torchrun, `--num_devices N` (or -1) shards the particles
over the N ranks (a count N does not divide raises), or with `--mesh_seq
S` and `--mesh_model M` over N / (S M) data indices of S seq ranks that
split the pair representation's rows, each of M model ranks that split the
weights, and rank 0 writes the files and the trace.

    python -m genie2_tpu_torch.cli.sample_motif_smc --name base --epoch 40 \
        --outdir out --motif_index 0 --motif_dir motifbench/pdbs
"""

from __future__ import annotations

import argparse
import time

from genie2_tpu_torch.cli.common import add_checkpoint_arguments, load_model
from genie2_tpu_torch.parallel import is_main


def run(args):
    """Sample one motif problem, write its files and the trace, print the
    summary line and return its numbers with the ESS trace."""
    from genie2_tpu_torch.sampling import SMCSampler

    model, config, mesh = load_model(args)
    sampler = SMCSampler(model, config, mesh=mesh)
    sampler.max_offsets = args.max_offsets
    if args.dump_trajectory_every:
        sampler.dump_trajectory_every = args.dump_trajectory_every
    t0 = time.perf_counter()
    sampler.sample({
        "scale": args.scale, "outdir": args.outdir, "num_samples": args.num_particles,
        "prefix": str(args.motif_index), "offset": args.offset, "motif_index": args.motif_index,
        "motif_dir": args.motif_dir, "seed": args.seed, "twist_rotations": args.twist_rotations,
        "rot_tausq": args.rot_tausq, "proposal": args.proposal, "score_grad_cap": args.score_grad_cap,
    })
    seconds = time.perf_counter() - t0
    ess = sampler.trace.ess
    resamples = int(sampler.trace.resampled.sum())
    if is_main(mesh):  # the trace streams from rank 0 only
        stream_tds_trace(sampler.trace, args.outdir, n_timestep=config.diffusion["n_timestep"],
                         wandb_project=args.wandb_project, run_name=f"motif_{args.motif_index}",
                         tensorboard=args.tensorboard, config=vars(args))
        print(
            f"motif {args.motif_index}: placement={sampler.final_placement} "
            f"ess(min/mean)={ess.min():.2f}/{ess.mean():.2f} resamples={resamples}",
            flush=True,
        )
    return {
        "placement": [list(seg) for seg in sampler.final_placement], "ess_min": float(ess.min()),
        "ess_mean": float(ess.mean()), "ess_trace": ess.tolist(), "resamples": resamples, "seconds": seconds,
        "n_placements": len(sampler.placements),
    }


def stream_tds_trace(trace, outdir: str, n_timestep: int, wandb_project=None, run_name=None,
                     tensorboard: bool = False, config=None):
    """Write a TDSTrace (numpy) to `{outdir}/logs/metrics.jsonl`, one record
    per reverse step, and to wandb / TensorBoard where asked and available."""
    from genie2_tpu_torch.utils.loggers import LoggerSet

    loggers = LoggerSet(f"{outdir}/logs", wandb_project=wandb_project, run_name=run_name,
                        tensorboard=tensorboard, config=config)
    for i in range(len(trace.ess)):
        loggers.log(i, {
            "t": n_timestep - i,  # the reverse loop runs t = T .. 1
            "ess": trace.ess[i], "resampled": trace.resampled[i], "motif_dist": trace.motif_dist[i],
            "best_placement": trace.best_placement[i],
        }, prefix="tds")
    loggers.finish()


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_checkpoint_arguments(parser)
    parser.add_argument("--scale", type=float, default=1.0, help="Sampling noise scale")
    parser.add_argument("--motif_index", type=int, required=True, help="Index into the MotifBench problem directory")
    parser.add_argument("--motif_dir", type=str, required=True, help="MotifBench-style motif_pdbs directory")
    parser.add_argument("--num_particles", type=int, default=4)
    parser.add_argument("--max_offsets", type=int, default=1000)
    parser.add_argument("--offset", type=int, default=0)
    parser.add_argument("--twist_rotations", action="store_true",
                        help="Add the SO(3) rotation term to the twisting potential (Frenet frames of x0-hat "
                             "against the motif's, tangent-normal approximation)")
    parser.add_argument("--proposal", choices=("posterior", "score"), default="posterior",
                        help="Where the twisting gradient enters the proposal mean: 'posterior' = norm-capped "
                             "gradient twists x-hat-0; 'score' = the gradient enters as a twisted score on the "
                             "reparameterized transition (full SMC weights kept)")
    parser.add_argument("--score_grad_cap", type=float, default=0.0,
                        help="Soft norm bound on the score proposal's gradient term (0 = off)")
    parser.add_argument("--rot_tausq", type=float, default=0.1,
                        help="tau^2 of the rotation term's x-start variance (with --twist_rotations)")
    parser.add_argument("--dump_trajectory_every", type=int, default=0,
                        help="Dump x0/xt PDB snapshots every K steps (0 = off)")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="Sequence parallelism: split the pair representation by residue rows over this many "
                             "ranks of the launch (the particles shard over the data axis only)")
    parser.add_argument("--wandb_project", type=str, default=None,
                        help="Also stream the per-step trace to this wandb project; JSONL is always written "
                             "to {outdir}/logs")
    parser.add_argument("--tensorboard", action="store_true", help="Also write the trace to {outdir}/logs/tb")
    return run(parser.parse_args(argv))


def cli():
    """The console script's entry point: `main` with its result dropped, so
    that the script exits with status 0."""
    main()


if __name__ == "__main__":
    main()
