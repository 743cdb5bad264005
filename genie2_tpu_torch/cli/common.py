"""Flags and set-up that the sampling CLIs share.

Data, sequence and tensor parallel: `torchrun --nproc_per_node N -m
genie2_tpu_torch.cli.<cli> ... --num_devices N` (or -1) runs one process a
card (cuda:LOCAL_RANK); with `--mesh_seq S` and `--mesh_model M` (S M
dividing N) the N ranks are N / (S M) data indices of S seq ranks, which
split each sample's pair representation by residue rows
(parallel/sequence_parallel.py), each of M model ranks, which split the
weights (parallel/tensor_parallel.py). Each data index samples its rows of
every batch; rank 0 writes the files, which are those of one process
(parallel/mesh.py, sampling/base.py).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

SOLVER_FLAGS = ("ddim_steps", "ddim_eta", "ddim_eta_switch_t", "dpm_steps", "dump_trajectory_every", "fast_spacing")


def add_checkpoint_arguments(parser: argparse.ArgumentParser):
    """The flags every sampling CLI has: which checkpoint, where to write,
    the seed, the device and the parallelism flags."""
    parser.add_argument("--name", type=str, required=True, help="Model name")
    parser.add_argument("--epoch", type=int, required=True, help="Model epoch")
    parser.add_argument("--rootdir", type=str, default="results", help="Root directory")
    parser.add_argument("--outdir", type=str, required=True, help="Output directory")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ema", action="store_true", help="Sample from epoch.{E}.ema.ckpt")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; no card without --device cpu is an error")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="Tensor parallelism: split the weights over this many ranks of the launch (dividing "
                             "--num_devices); the batch shards over the rest")
    parser.add_argument("--num_devices", type=int, default=None,
                        help="Run on every rank of a torchrun launch, data x seq x model: its world size or -1 "
                             "(default: one process)")


def add_model_arguments(parser: argparse.ArgumentParser):
    add_checkpoint_arguments(parser)
    parser.add_argument("--scale", type=float, required=True, help="Sampling noise scale")
    parser.add_argument("--mesh_seq", type=int, default=1,
                        help="Sequence parallelism: split each sample's pair representation by residue rows over "
                             "this many ranks of the launch (with --mesh_model dividing --num_devices)")


def add_solver_arguments(parser: argparse.ArgumentParser):
    parser.add_argument("--ddim_steps", type=int, default=0,
                        help="Accelerated DDIM sampling with this many steps (0 = full ancestral DDPM)")
    parser.add_argument("--ddim_eta", type=float, default=0.0, help="DDIM stochasticity (0 = deterministic ODE)")
    parser.add_argument("--ddim_eta_switch_t", type=int, default=0,
                        help="Hybrid DDIM stochasticity: deterministic (eta=0) while t > this, "
                             "--ddim_eta (default 1) at or below (0 = off)")
    parser.add_argument("--dpm_steps", type=int, default=0,
                        help="Accelerated DPM-Solver++(2M) sampling with this many steps "
                             "(second-order, deterministic; mutually exclusive with --ddim_steps)")
    parser.add_argument("--dump_trajectory_every", type=int, default=0,
                        help="Write x_t snapshot PDBs every K steps to outdir/test/ (full-DDPM path only)")
    parser.add_argument("--fast_spacing", choices=("uniform", "sqrt"), default="uniform",
                        help="Step spacing for --ddim_steps/--dpm_steps: sqrt puts more steps at high noise")


def solver_params(args) -> Dict[str, Any]:
    return {k: getattr(args, k) for k in SOLVER_FLAGS}


def load_model(args):
    """Resolve the parallelism flags into a mesh (parallel/mesh.py:
    `mesh_from_arg`, which joins the launcher's process group), fix the
    matmul precision and load the release-layout checkpoint onto
    `args.device` (this rank's card under a launcher), placed on the
    mesh's seq and model axes. Returns (model, config, mesh); the mesh is None for
    one process."""
    from genie2_tpu_torch.parallel import mesh_from_arg
    from genie2_tpu_torch.utils.model_io import load_pretrained_model

    mesh = mesh_from_arg(args.num_devices, getattr(args, "mesh_seq", 1), args.mesh_model, args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, config = load_pretrained_model(args.rootdir, args.name, args.epoch, ema=args.ema, device=args.device,
                                          mesh=mesh)
    return model, config, mesh
