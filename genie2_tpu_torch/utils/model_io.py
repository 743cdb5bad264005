"""Model / checkpoint I/O for the two layouts

    release:   {rootdir}/{name}/configuration
               {rootdir}/{name}/checkpoints/epoch.{E}.ckpt         (or epoch.{E}.ema.ckpt)
    training:  {rootdir}/{name}/version_{v}/checkpoints/epoch={E}.ckpt  (or epoch={E}.ema.ckpt)

A checkpoint is a torch file: a Lightning checkpoint whose `state_dict`
keys carry a `model.` prefix, or a bare state_dict. Weights trained by the
reference use the eigh quaternion extraction, so a raw torch checkpoint
without a `{ckpt}.meta.json` sidecar selects `rot_to_quat = eigh`; a
sidecar's `rot_to_quat_method` wins, and the trainer writes one beside
each checkpoint it saves. Files are read weights-only: a reference
Lightning checkpoint that pickles other objects is converted once by
`cli/convert_checkpoint.py`. Orbax directories written by the JAX package
are not read here: `tools/orbax_to_torch.py` converts them where JAX is
installed.

Every file is written through a temporary file and `os.replace`, so a
reader never sees a partial one; `AsyncSaver` does the writing on a
background thread.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.nn import Denoiser


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; CUDA unless the caller asks for the CPU,
    and an error, never a silent CPU run, when no card is present. Under a
    launcher that sets LOCAL_RANK (torchrun), a bare "cuda" is this
    process's card, cuda:LOCAL_RANK."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
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
    """The Denoiser state_dict of a torch checkpoint file, `model.` stripped.
    The file is read weights-only: a pickle of anything but tensors and
    builtins is refused, with the converter that makes it loadable named."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory of genie2_tpu; convert it where JAX is installed "
            f"with `python tools/orbax_to_torch.py {path} OUT.ckpt` (it writes the .meta.json sidecar too)"
        )
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        raise ValueError(
            f"{path} pickles objects other than tensors and builtins (a Lightning checkpoint of the reference), "
            f"and the loader reads weights only; convert it once with `python -m "
            f"genie2_tpu_torch.cli.convert_checkpoint {path} OUT.ckpt` if you trust the file"
        ) from exc
    state = blob.get("state_dict", blob)
    return {k[len("model."):] if k.startswith("model.") else k: v for k, v in state.items()}


def _placed(model: Denoiser, device, mesh) -> Denoiser:
    """The full model on `device` in eval mode, sharded over the mesh's
    model group where it has one (parallel/tensor_parallel.py)."""
    from genie2_tpu_torch.parallel.tensor_parallel import shard_model

    return shard_model(model.to(device).eval(), mesh)


def load_pretrained_model(
    rootdir: str, name: str, epoch: int, ema: bool = False, device=None, mesh=None
) -> Tuple[Denoiser, Config]:
    """Release-layout loader; returns (model in eval mode on `device`, this
    rank's shards of it under a mesh with a model axis, config)."""
    device = resolve_device(device)
    config = load_config(rootdir, name)
    stem = f"epoch.{epoch}.ema.ckpt" if ema else f"epoch.{epoch}.ckpt"
    path = os.path.join(rootdir, name, "checkpoints", stem)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Missing checkpoint: {path}")
    _select_quat_method(config, path)
    print(f"Loading checkpoint: {path} (rot_to_quat={config.tpu['rot_to_quat_method']})", flush=True)
    state = load_state_dict_file(path)
    model = Denoiser.from_config(config)
    model.load_state_dict(state)
    return _placed(model, device, mesh), config


# ------------------------------------------------------------------ #
# Training layout
# ------------------------------------------------------------------ #


def _epoch_of(path: str) -> Optional[int]:
    m = re.search(r"epoch[=.](\d+)\.ckpt$", os.path.basename(path))
    return int(m.group(1)) if m else None


def get_versions(rootdir: str, name: str):
    return sorted(int(d.split("_")[-1]) for d in glob.glob(os.path.join(rootdir, name, "version_*"))
                  if d.split("_")[-1].isdigit())


def get_epochs(rootdir: str, name: str, version: int):
    pattern = os.path.join(rootdir, name, f"version_{version}", "checkpoints", "*.ckpt")
    return sorted(e for e in (_epoch_of(p) for p in glob.glob(pattern)) if e is not None)


def init_model(config: Config, seed: int = 0, device=None) -> Denoiser:
    """A fresh Denoiser whose initial weights are a function of `seed`
    alone (the global RNG is left as it was), on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Denoiser.from_config(config)
    return model.to(resolve_device(device))


def lightning_blob(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """{"state_dict": {"model.<name>": CPU tensor}}, the layout
    `load_state_dict_file` reads."""
    return {"state_dict": {f"model.{k}": v.detach().cpu().clone() for k, v in state_dict.items()}}


def save_file(path: str, obj: Any):
    """torch.save through a temporary file and os.replace."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_params(path: str, state_dict: Dict[str, torch.Tensor], rot_to_quat_method: str, write=save_file,
                provenance: Optional[Dict[str, Any]] = None):
    """A Lightning-style checkpoint file of `state_dict` and its
    `.meta.json` sidecar naming the quaternion method the weights were
    trained with (and the `provenance` entries, where given); `write(path,
    obj)` writes the file (`save_file`, or an `AsyncSaver`'s `save`)."""
    with open(path + ".meta.json", "w") as f:
        json.dump({**(provenance or {}), "rot_to_quat_method": rot_to_quat_method}, f)
    write(path, lightning_blob(state_dict))


def to_cpu(obj):
    """A copy of `obj` with every tensor (in dicts, lists, tuples) on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


class AsyncSaver:
    """Checkpoint writes on a background thread. `save` takes CPU copies of
    the tensors at once (the caller may go on updating its own) and
    returns; the thread writes them through a temporary file and
    `os.replace`, so a reader never sees a partial file and a crash
    mid-write loses only that save. A second `save` first waits for the one
    in flight (saves to one path must keep their order); `wait` drains
    them and raises a failed write's error."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, obj: Any):
        self.wait()
        snapshot = to_cpu(obj)

        def write():
            try:
                save_file(path, snapshot)
            except BaseException as exc:  # noqa: BLE001 — re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def _select_quat_method(config: Config, path: str):
    method = checkpoint_metadata(path).get("rot_to_quat_method")
    if method is None and os.path.isfile(path):
        method = "eigh"  # torch-trained weights
    if method:
        config.tpu["rot_to_quat_method"] = method


def load_model(rootdir: str, name: str, version: Optional[int] = None, epoch: Optional[int] = None,
               device=None, mesh=None) -> Tuple[Denoiser, Config]:
    """Training-layout loader: the latest version and epoch unless given,
    an untrained model (`init_model`, seed 0) where there is no
    checkpoint. Returns (model in eval mode on `device`, this rank's
    shards of it under a mesh with a model axis, config)."""
    device = resolve_device(device)
    config = load_config(rootdir, name)
    versions = get_versions(rootdir, name)
    if version is None:
        if not versions:
            print("No checkpoint available (version); using untrained model", flush=True)
            return _placed(init_model(config, 0, device), device, mesh), config
        version = max(versions)
    elif version not in versions:
        raise FileNotFoundError(f"Missing checkpoint version: {version}")
    epochs = get_epochs(rootdir, name, version)
    if epoch is None:
        if not epochs:
            print("No checkpoint available (epoch); using untrained model", flush=True)
            return _placed(init_model(config, 0, device), device, mesh), config
        epoch = max(epochs)
    elif epoch not in epochs:
        raise FileNotFoundError(f"Missing checkpoint epoch: {epoch}")
    path = os.path.join(rootdir, name, f"version_{version}", "checkpoints", f"epoch={epoch}.ckpt")
    _select_quat_method(config, path)
    print(f"Loading checkpoint: {path} (rot_to_quat={config.tpu['rot_to_quat_method']})", flush=True)
    model = Denoiser.from_config(config)
    model.load_state_dict(load_state_dict_file(path))
    return _placed(model, device, mesh), config
