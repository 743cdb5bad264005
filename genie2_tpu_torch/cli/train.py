"""Training CLI: `python -m genie2_tpu_torch.cli.train -c CONFIG [-t] [--resume]
[--init_from CKPT] [--device cpu]`.

The configuration file's `dataDirectory` is split into train / validation
name lists under {rootDirectory}/{name}/ (kept across runs), parsed once
into a packed cache beside them, and trained by `train/loop.py:Trainer` on
one device: cuda unless `--device cpu`, and an error where there is no
card. The configuration is copied next to the run, where the loaders read
it. `-t` trains on a 16-file subset (with its own cache). TF32 is off, as
in the sampling CLIs. `--distributed`, and `meshSeq` / `meshModel` other
than 1 or `meshData` other than -1 or 1 in the configuration, raise
NotImplementedError: parallelism is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch


def check_single_device(args, config):
    """Refuse what needs more than one device."""
    given = ["--distributed"] if args.distributed else []
    given += [f"{k} {config.tpu.get(key)}" for k, key in (("meshSeq", "mesh_seq"), ("meshModel", "mesh_model"))
              if config.tpu.get(key, 1) != 1]
    if config.tpu.get("mesh_data", -1) not in (-1, 1):
        given.append(f"meshData {config.tpu['mesh_data']}")
    if given:
        raise NotImplementedError(f"{', '.join(given)}: parallelism is not ported to genie2_tpu_torch yet")


def run(args):
    """Train as `args` (the parser's namespace) say; returns the Trainer."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.train.data import MotifAugmentConfig, StructureDataset, resolve_filepath, setup_split
    from genie2_tpu_torch.train.loop import Trainer
    from genie2_tpu_torch.utils.model_io import resolve_device

    config = Config(args.config)
    check_single_device(args, config)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = config.io["name"] or "run"
    rootdir = config.io["rootdir"]

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
    print(f"dataset: {len(dataset)} train / {len(val_dataset) if val_dataset else 0} val structures on {device}",
          flush=True)

    trainer = Trainer(config, resume=args.resume, init_from=args.init_from, device=device)
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
    p.add_argument("--distributed", action="store_true", default=False, help="Not supported (raises)")
    p.add_argument("--init_from", type=str, default=None,
                   help="Fine-tune: initialize the weights from a torch checkpoint file, fresh optimizer state")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu; no card without --device cpu is an error")
    return p


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
