"""Secondary-structure-guided generation CLI.

Runs the Feynman-Kac particle filter with the soft SSE potential
(sampling/sse_guided.py): P particles of one target length, tilted toward
the requested helix or strand content, systematic resampling triggered by
the effective sample size; the final particles are written as
`{outdir}/pdbs/{length}_{i}.pdb` and their soft and hard (P-SEA) fractions
reported. Flags as genie2_tpu's CLI, plus `--device` (default cuda;
`--device cpu` runs the plain versions on the CPU). Under torchrun,
`--num_devices N` (or -1) shards the particles over the N ranks (a count N
does not divide raises), or with `--mesh_seq S` and `--mesh_model M` over
N / (S M) data indices of S seq ranks that split the pair
representation's rows, each of M model ranks that split the weights, and
rank 0 writes the files (genie2_tpu's CLI has no `--mesh_seq`).

    python -m genie2_tpu_torch.cli.sample_sse --name base --epoch 40 \
        --outdir out --length 100 --num_particles 8 --target helix \
        --strength 20
"""

from __future__ import annotations

import argparse
import os
import time

from genie2_tpu_torch.cli.common import add_checkpoint_arguments, load_model


def run(args):
    """Sample, write the PDBs, print the summary line and return its
    numbers with the ESS trace."""
    import numpy as np
    import torch

    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, save_features_to_pdb, to_device
    from genie2_tpu_torch.features.secstruct import sec_struct_frac
    from genie2_tpu_torch.nn.policy import apply_denoiser, cast_model, compute_dtype
    from genie2_tpu_torch.parallel import is_main, shard_batch
    from genie2_tpu_torch.parallel.mesh import check_particles
    from genie2_tpu_torch.sampling import soft_sse_fraction, sse_guided_sample

    model, config, mesh = load_model(args)
    check_particles(args.num_particles, mesh)
    device = next(model.parameters()).device
    dtype = compute_dtype(config.tpu.get("compute_dtype", "fp32"))
    model = cast_model(model, dtype)
    schedule = Schedule.create(config.diffusion["n_timestep"], config.diffusion["schedule"], device=device)
    batch = batchify([create_empty_features([args.length]) for _ in range(args.num_particles)])
    feats = to_device(shard_batch(batch, mesh), device)

    t0 = time.perf_counter()
    with torch.inference_mode():
        # The step-invariant pair bias is computed once, as the samplers do.
        static_bias = model.static_bias(feats, dtype)

        def model_fn(frames, t_vec):
            return apply_denoiser(model, frames, t_vec, feats, static_bias, dtype)

        trans, result = sse_guided_sample(
            model_fn, schedule, feats, args.seed, args.num_particles, target=args.target,
            strength=args.strength, scale=args.scale, ess_threshold=args.ess_threshold, mesh=mesh,
        )
        soft = soft_sse_fraction(trans, to_device(batch, device)["residue_mask"], args.target).cpu().numpy()
    trans_np = trans.float().cpu().numpy()
    ess = result.ess_trace.cpu().numpy()
    resamples = int(result.resampled_trace.sum().item())
    seconds = time.perf_counter() - t0

    hard = [sec_struct_frac(trans_np[i])[0 if args.target == "helix" else 1] for i in range(args.num_particles)]
    if is_main(mesh):
        os.makedirs(os.path.join(args.outdir, "pdbs"), exist_ok=True)
        for i in range(args.num_particles):
            f = create_empty_features([args.length])
            f["atom_positions"] = trans_np[i]
            save_features_to_pdb(f, os.path.join(args.outdir, "pdbs", f"{args.length}_{i}.pdb"))
        print(
            f"{args.num_particles} particles, target={args.target} strength={args.strength}: "
            f"soft {args.target} mean={soft.mean():.3f} max={soft.max():.3f}; hard P-SEA mean={np.mean(hard):.3f}; "
            f"ess(min/mean)={ess.min():.2f}/{ess.mean():.2f} resamples={resamples}",
            flush=True,
        )
    return {
        "soft": soft.tolist(), "soft_mean": float(soft.mean()), "soft_max": float(soft.max()),
        "hard_mean": float(np.mean(hard)), "ess_min": float(ess.min()), "ess_mean": float(ess.mean()),
        "ess_trace": ess.tolist(), "resamples": resamples, "seconds": seconds,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_checkpoint_arguments(parser)
    parser.add_argument("--length", type=int, default=100)
    parser.add_argument("--num_particles", type=int, default=8)
    parser.add_argument("--target", choices=("helix", "strand"), default="helix")
    parser.add_argument("--strength", type=float, default=20.0, help="Tempering strength of the SSE potential")
    parser.add_argument("--scale", type=float, default=0.6, help="Reverse-kernel noise temperature (gamma)")
    parser.add_argument("--ess_threshold", type=float, default=0.5, help="Resample when ESS < threshold * P")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="Sequence parallelism: split the pair representation by residue rows over this many "
                             "ranks of the launch (the particles shard over the data axis only)")
    return run(parser.parse_args(argv))


def cli():
    """The console script's entry point: `main` with its result dropped, so
    that the script exits with status 0."""
    main()


if __name__ == "__main__":
    main()
