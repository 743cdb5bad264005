"""Training CLI: `python -m genie2_tpu_torch.cli.train -c CONFIG [-t] [--resume]
[--init_from CKPT] [--device cpu] [--distributed]`.

The configuration file's `dataDirectory` is split into train / validation
name lists under {rootDirectory}/{name}/ (kept across runs), parsed once
into a packed cache beside them, and trained by `train/loop.py:Trainer`:
on cuda unless `--device cpu`, and an error where there is no card. The
configuration is copied next to the run, where the loaders read it. `-t`
trains on a 16-file subset (with its own cache). TF32 is off, as in the
sampling CLIs.

Data, sequence and tensor parallel: under torchrun (`torchrun
--nproc_per_node N -m genie2_tpu_torch.cli.train -c CONFIG`) every process
joins the process group from the launcher's environment, as
`jax.distributed.initialize()` does (`--distributed`, implied where
WORLD_SIZE > 1; NCCL on the card, gloo on the CPU) and takes the card
LOCAL_RANK. The ranks form a grid of `meshData` x `meshSeq` x `meshModel`
(`meshSeq` x `meshModel` must divide N; `meshData` -1 or N over it): each
data index trains on its rows of each global batch, its seq ranks split
the pair representation's residue rows and the model ranks of one split
the weights.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch


def check_mesh(args, config):
    """Join the launcher's process group where asked or launched with more
    than one rank."""
    from genie2_tpu_torch.parallel.mesh import init_from_launcher

    if args.distributed or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_from_launcher(args.device)


def run(args):
    """Train as `args` (the parser's namespace) say; returns the Trainer."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel import barrier, data_axis_size, is_main
    from genie2_tpu_torch.parallel.mesh import mesh_from_config
    from genie2_tpu_torch.train.data import MotifAugmentConfig, StructureDataset, resolve_filepath, setup_split
    from genie2_tpu_torch.train.loop import Trainer
    from genie2_tpu_torch.utils.model_io import resolve_device

    config = Config(args.config)
    check_mesh(args, config)
    device = resolve_device(args.device)
    mesh = mesh_from_config(config.tpu.get("mesh_data", -1), device, config.tpu.get("mesh_model", 1),
                            config.tpu.get("mesh_seq", 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = config.io["name"] or "run"
    rootdir = config.io["rootdir"]

    # Rank 0 writes the split and the cache first; the others read them.
    if not is_main(mesh):
        barrier(mesh)
    train_names, val_names = setup_split(
        rootdir=rootdir, name=name, datadir=config.io["datadir"], min_n_res=config.io["min_n_res"],
        max_n_res=config.io["max_n_res"], max_n_chain=config.io["max_n_chain"],
        validation_split=config.io["validation_split"], seed=config.training["seed"],
    )
    limit = 16 if args.test else None

    def build_dataset(names, cache_base):
        filepaths = [p for p in (resolve_filepath(config.io["datadir"], n) for n in names) if p is not None]
        filepaths = filepaths[:limit] if limit else filepaths
        if not filepaths:
            return None
        cache = os.path.join(rootdir, name, f"{cache_base}_test" if limit else cache_base)
        return StructureDataset(filepaths, max_n_res=config.io["max_n_res"], max_n_chain=config.io["max_n_chain"],
                                motif=MotifAugmentConfig.from_config(config), cache_path=cache)

    dataset = build_dataset(train_names, "parsed_cache")
    if dataset is None:
        raise FileNotFoundError(f"no training structures found under {config.io['datadir']!r} "
                                f"(split listed {len(train_names)} names)")
    val_dataset = build_dataset(val_names or [], "parsed_cache_val")
    if is_main(mesh):
        barrier(mesh)
    trainer = Trainer(config, resume=args.resume, init_from=args.init_from, device=device)
    if is_main(mesh):
        grid = f"{data_axis_size(mesh)} x {mesh.n_model if mesh else 1} (data x model)"
        if mesh is not None and mesh.n_seq > 1:
            grid = f"{mesh.n_data} x {mesh.n_seq} x {mesh.n_model} (data x seq x model)"
        print(f"dataset: {len(dataset)} train / {len(val_dataset) if val_dataset else 0} val structures on "
              f"{grid} x {device}", flush=True)
        shutil.copyfile(args.config, os.path.join(rootdir, name, "configuration"))
    trainer.fit(dataset, resume=args.resume, val_dataset=val_dataset,
                save_state_every_n_step=config.training["save_state_every_n_step"])
    return trainer


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the denoiser (genie2_tpu_torch)")
    p.add_argument("-c", "--config", type=str, required=True, help="Path for configuration file")
    p.add_argument("-t", "--test", action="store_true", default=False, help="Test mode (16-structure subset)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="Continue from the latest version's resume_state (step-granular)")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="Join the process group of the launcher's environment (torchrun); implied where "
                        "WORLD_SIZE > 1")
    p.add_argument("--init_from", type=str, default=None,
                   help="Fine-tune: initialize the weights from a torch checkpoint file, fresh optimizer state")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; no card without --device cpu is an error")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


def cli():
    """The console script's entry point: `main` with its result dropped, so
    that the script exits with status 0."""
    main()


if __name__ == "__main__":
    main()
