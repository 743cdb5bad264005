"""Convert a genie2_tpu orbax checkpoint directory into a checkpoint file of
genie2_tpu_torch, with its `.meta.json` sidecar.

    python tools/orbax_to_torch.py SRC_ORBAX_DIR DST.ckpt [--rot_to_quat_method closed|eigh]

Reading orbax needs JAX, so this bridge lives outside both packages and
runs where JAX is installed (never on a machine that has only the port):
it reads with `genie2_tpu.utils.model_io.load_params` and writes with
`genie2_tpu_torch.utils.weights.params_from_flax` and
`genie2_tpu_torch.utils.model_io.save_params`. It is the one file outside
`tests/` that imports both packages.

It always writes the sidecar, because a torch checkpoint without one loads
with the eigh quaternions of the reference's weights. The method is the
orbax directory's own sidecar's (`SRC.meta.json`, as genie2_tpu's converter
stamps) where there is one, otherwise `--rot_to_quat_method`, whose
default is genie2_tpu's `closed`: weights that genie2_tpu trained with
`rotToQuatMethod eigh` need `--rot_to_quat_method eigh`. DST drops into
either layout of the port (`epoch.{E}.ckpt` in a release `checkpoints/`
directory, `epoch={E}.ckpt` in a training one).

The other direction needs no tool: genie2_tpu reads a torch checkpoint
file and honours its sidecar (`genie2_tpu/utils/model_io.py:load_params`).
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def convert(src: str, dst: str, rot_to_quat_method: str = "closed") -> str:
    """Write DST (and DST.meta.json) from the orbax directory SRC; returns
    the quaternion method written."""
    import jax
    import numpy as np

    from genie2_tpu.utils.model_io import checkpoint_metadata, load_params
    from genie2_tpu_torch.utils.model_io import save_params
    from genie2_tpu_torch.utils.weights import params_from_flax

    if not os.path.isdir(src):
        raise FileNotFoundError(f"{src} is not an orbax checkpoint directory")
    meta = checkpoint_metadata(src)
    method = meta.get("rot_to_quat_method", rot_to_quat_method)
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, load_params(src)))
    save_params(dst, state, method,
                provenance={"source": "genie2_tpu_orbax", "source_file": os.path.basename(src.rstrip("/"))})
    n_params = sum(v.numel() for v in state.values())
    origin = f"{src.rstrip('/')}.meta.json" if "rot_to_quat_method" in meta else "--rot_to_quat_method"
    print(f"converted {src} -> {dst}: {len(state)} arrays, {n_params:,} parameters, "
          f"rot_to_quat_method {method} (from {origin})", flush=True)
    return method


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("src", help="genie2_tpu orbax checkpoint directory")
    p.add_argument("dst", help="output torch checkpoint file for genie2_tpu_torch")
    p.add_argument("--rot_to_quat_method", choices=("closed", "eigh"), default="closed",
                   help="quaternion method of the weights where SRC has no .meta.json (genie2_tpu's default: closed)")
    args = p.parse_args(argv)
    convert(args.src, args.dst, args.rot_to_quat_method)


if __name__ == "__main__":
    main()
