"""Model / checkpoint I/O for the release layout

    {rootdir}/{name}/configuration
    {rootdir}/{name}/checkpoints/epoch.{E}.ckpt        (or epoch.{E}.ema.ckpt)

A checkpoint is a torch file: a Lightning checkpoint whose `state_dict`
keys carry a `model.` prefix, or a bare state_dict. Weights trained by the
reference use the eigh quaternion extraction, so a raw torch checkpoint
without a `{ckpt}.meta.json` sidecar selects `rot_to_quat = eigh`; a
sidecar's `rot_to_quat_method` wins. Orbax directories written by the JAX
package are not read here.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.nn import Denoiser


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; CUDA unless the caller asks for the CPU,
    and an error, never a silent CPU run, when no card is present."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU")
    return device


def load_config(rootdir: str, name: str) -> Config:
    return Config(os.path.join(rootdir, name, "configuration"))


def checkpoint_metadata(ckpt_path: str) -> Dict[str, Any]:
    meta_path = ckpt_path.rstrip("/") + ".meta.json"
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """The Denoiser state_dict of a torch checkpoint file, `model.` stripped."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the orbax -> torch converter "
            "is not ported yet (convert it to a torch .ckpt first)"
        )
    blob = torch.load(path, map_location="cpu", weights_only=True)
    state = blob.get("state_dict", blob)
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in state.items()}


def load_pretrained_model(
    rootdir: str, name: str, epoch: int, ema: bool = False, device=None
) -> Tuple[Denoiser, Config]:
    """Release-layout loader; returns (model in eval mode on `device`, config)."""
    device = resolve_device(device)
    config = load_config(rootdir, name)
    stem = f"epoch.{epoch}.ema.ckpt" if ema else f"epoch.{epoch}.ckpt"
    path = os.path.join(rootdir, name, "checkpoints", stem)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Missing checkpoint: {path}")
    method = checkpoint_metadata(path).get("rot_to_quat_method")
    if method is None and os.path.isfile(path):
        method = "eigh"  # torch-trained weights
    if method:
        config.tpu["rot_to_quat_method"] = method
    print(f"Loading checkpoint: {path} (rot_to_quat={config.tpu['rot_to_quat_method']})", flush=True)
    state = load_state_dict_file(path)
    model = Denoiser.from_config(config)
    model.load_state_dict(state)
    return model.to(device).eval(), config
