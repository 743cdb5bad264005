"""Checkpoint conversion CLI: a reference Lightning .ckpt -> a weights-only
Lightning-style file that this package's loaders read.

    python -m genie2_tpu_torch.cli.convert_checkpoint SRC.ckpt DST.ckpt [--config CONFIGURATION]

The loaders read checkpoint files with `torch.load(weights_only=True)`
(utils/model_io.py), which refuses a pickle of anything but tensors and
builtins; the reference's Lightning checkpoints pickle their hyperparameters,
optimizer and loop states besides the weights. This CLI is the one place in
the package that reads a full pickle (`weights_only=False`), and only the
file the user names: run it once on a file you trust. It keeps the
Denoiser's state_dict (the `model.` entries of a Lightning state_dict,
prefix stripped; every entry of a bare one), checks the names and shapes
against `Denoiser.from_config` where `--config` names a configuration file,
and writes them through `utils/model_io.py:save_params` with a `.meta.json`
sidecar naming the `eigh` quaternion method the reference's weights were
trained with, as genie2_tpu's converter stamps. DST drops into either
checkpoint layout (`epoch.{E}.ckpt` in a release `checkpoints/` directory).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import torch


def denoiser_state(blob) -> Dict[str, torch.Tensor]:
    """The Denoiser's weights of a loaded checkpoint: the `model.` entries
    of a Lightning state_dict with the prefix stripped, or every entry of a
    bare state_dict."""
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    if not isinstance(state, dict) or not all(isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError("the checkpoint holds no state_dict of tensors")
    if any(k.startswith("model.") for k in state):
        return {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}
    return dict(state)


def check_against_config(state: Dict[str, torch.Tensor], config_path: str):
    """Raise where the names or shapes differ from `Denoiser.from_config`'s."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.nn import Denoiser

    want = {k: tuple(v.shape) for k, v in Denoiser.from_config(Config(config_path)).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    shapes = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or unexpected or shapes:
        raise ValueError(f"the weights do not fit {config_path}: missing {missing}, unexpected {unexpected}, "
                         f"other shapes {[(k, got[k], want[k]) for k in shapes]}")


def run(args):
    from genie2_tpu_torch.utils.model_io import save_params

    if not os.path.isfile(args.src):
        raise FileNotFoundError(args.src)
    state = denoiser_state(torch.load(args.src, map_location="cpu", weights_only=False))
    if args.config:
        check_against_config(state, args.config)
    state = {k: v.detach().cpu().contiguous() for k, v in state.items()}
    save_params(args.dst, state, "eigh",
                provenance={"source": "torch_lightning", "source_file": os.path.basename(args.src)})
    n_params = sum(v.numel() for v in state.values())
    print(f"converted {args.src} -> {args.dst}: {len(state)} arrays, {n_params:,} parameters "
          f"(metadata: {os.path.basename(args.dst)}.meta.json, rot_to_quat_method eigh)", flush=True)
    return state


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Convert a reference Lightning checkpoint for genie2_tpu_torch")
    p.add_argument("src", help="reference Lightning .ckpt (or a bare state_dict file)")
    p.add_argument("dst", help="output checkpoint file (a .meta.json sidecar is written beside it)")
    p.add_argument("--config", type=str, default=None,
                   help="configuration file whose Denoiser the weights must fit (names and shapes)")
    return p


def main(argv=None):
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
