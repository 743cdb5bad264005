"""Checkpoint conversion between the packages, both ways, on the CPU.

- A reference-layout Lightning checkpoint that pickles a non-tensor object
  is refused by the port's weights-only loader, with the converter named;
  after `genie2_tpu_torch/cli/convert_checkpoint.py` it loads bit for bit
  with the `eigh` sidecar, and holds what genie2_tpu's own converter reads.
- A genie2_tpu orbax checkpoint (`init_params` + `save_params`) goes through
  `tools/orbax_to_torch.py`; the port's z equals genie2_tpu's from the
  orbax directory within 1e-4 of max |z|, for `closed` and `eigh`.
- The port Trainer's `epoch={E}.ckpt` and its sidecar load in
  `genie2_tpu.utils.model_io.load_model`, with z equal within 1e-4 of max
  |z| and the sidecar's method honoured.

An eigh quaternion's sign is the solver's choice (torch's LAPACK and jax's
pick differently for some matrices), and the pair features see the sign.
So in the `eigh` cases both packages' pair featurizers take the eigh
quaternions with one sign convention, largest |component| positive, and
the calls are counted to show that the eigh path ran on both sides.
"""

import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.config import Config as JConfig
import genie2_tpu.nn.feature_nets as jfeature_nets
import genie2_tpu_torch.nn.feature_nets as feature_nets
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as JDenoiser
from genie2_tpu.utils import model_io as jmodel_io
from genie2_tpu.utils.torch_convert import load_torch_checkpoint
from genie2_tpu_torch.cli import convert_checkpoint
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import batchify, create_empty_features, to_device
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.train import synthetic_dataset
from genie2_tpu_torch.train.loop import Trainer
from genie2_tpu_torch.utils.model_io import load_pretrained_model
from genie2_tpu_torch.utils.weights import params_from_flax, randomize_zero_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_LINES = """name tiny
maximumNumResidues 24
numTimesteps 10
singleFeatureDimension 16
pairFeatureDimension 8
positionalEmbeddingDimension 8
chainEmbeddingDimension 4
timestepEmbeddingDimension 8
templateDistanceNumBins 5
numPairTransformLayers 1
triangularMultiplicativeHiddenDimension 4
numStructureLayers 1
ipaHiddenDimension 4
ipaNumHeads 2
ipaNumQkPoints 2
ipaNumVPoints 2
"""


def orbax_to_torch():
    spec = importlib.util.spec_from_file_location("orbax_to_torch", os.path.join(REPO, "tools", "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def release(root, extra=""):
    """{root}/tiny/configuration and the checkpoints directory; returns it."""
    os.makedirs(root / "tiny" / "checkpoints")
    (root / "tiny" / "configuration").write_text(CONFIG_LINES + extra)
    return root / "tiny" / "checkpoints"


def inputs():
    batch = batchify([create_empty_features([20]), create_empty_features([15])])
    rng = np.random.default_rng(5)
    trans = rng.normal(size=batch["atom_positions"].shape) * 3 * batch["residue_mask"][..., None]
    return batch, trans.astype(np.float32), np.array([3, 8], np.int32)


def z_of_both(jmodel, jvars, port):
    """(port's z, genie2_tpu's z) on the same batch, frames and timesteps,
    on real residues."""
    batch, trans, t = inputs()
    jf, tj = jto_device(batch), jnp.asarray(trans)
    z_j = jax.jit(jmodel.apply)(jvars, JRigid(jfrenet(tj, jf["chain_index"], jf["residue_mask"]), tj), jnp.asarray(t),
                                jf)["z"]
    tf, tt = to_device(batch, "cpu"), torch.tensor(trans)
    with torch.inference_mode():
        z_t = port(Rigid(frenet_frames(tt, tf["chain_index"], tf["residue_mask"]), tt), torch.tensor(t), tf)["z"]
    real = batch["residue_mask"].astype(bool)
    return z_t.numpy()[real], np.asarray(z_j)[real]


def assert_z_close(z_t, z_j):
    scale = np.abs(z_j).max()
    assert scale > 1e-3  # not vacuous
    assert np.abs(z_t - z_j).max() <= 1e-4 * scale, (np.abs(z_t - z_j).max(), scale)


@pytest.fixture
def one_sign(monkeypatch):
    """Both packages' pair featurizers with eigh quaternions of one sign
    (largest |component| positive); returns the counts of eigh calls."""
    calls = {"jax": 0, "torch": 0}
    jrot_to_quat, rot_to_quat = jfeature_nets.rot_to_quat, feature_nets.rot_to_quat

    def jax_side(r, method="closed"):
        q = jrot_to_quat(r, method=method)
        if method != "eigh":
            return q
        calls["jax"] += 1
        lead = jnp.take_along_axis(q, jnp.argmax(jnp.abs(q), axis=-1)[..., None], axis=-1)
        return q * jnp.sign(lead)

    def torch_side(r, method="closed"):
        q = rot_to_quat(r, method=method)
        if method != "eigh":
            return q
        calls["torch"] += 1
        return q * torch.sign(torch.gather(q, -1, q.abs().argmax(-1, keepdim=True)))

    monkeypatch.setattr(jfeature_nets, "rot_to_quat", jax_side)
    monkeypatch.setattr(feature_nets, "rot_to_quat", torch_side)
    return calls


def lightning_blob(state):
    """A reference-layout Lightning checkpoint: the weights under `model.`,
    and the objects Lightning pickles beside them (a Namespace of
    hyperparameters, optimizer and loop states)."""
    return {
        "epoch": 29, "global_step": 120000, "pytorch-lightning_version": "1.9.4",
        "state_dict": {f"model.{k}": v.clone() for k, v in state.items()},
        "hyper_parameters": argparse.Namespace(config="configuration", lr=1e-4),
        "optimizer_states": [{"state": {}, "param_groups": [{"lr": 1e-4, "params": [0, 1]}]}],
        "lr_schedulers": [], "callbacks": {"ModelCheckpoint": {"best_model_score": None}},
    }


@pytest.fixture(scope="module")
def port_state():
    config = Config(overrides=dict(line.split() for line in CONFIG_LINES.splitlines()))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = randomize_zero_init(Denoiser.from_config(config), seed=1)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_pickled_lightning_checkpoint_refused_then_converted(tmp_path, port_state, capsys):
    ckpts = release(tmp_path)
    src = ckpts / "epoch.29.ckpt"
    torch.save(lightning_blob(port_state), src)
    with pytest.raises(ValueError, match="genie2_tpu_torch.cli.convert_checkpoint"):
        load_pretrained_model(str(tmp_path), "tiny", 29, device="cpu")

    dst = ckpts / "epoch.30.ckpt"
    convert_checkpoint.main([str(src), str(dst), "--config", str(tmp_path / "tiny" / "configuration")])
    assert f"{len(port_state)} arrays, {sum(v.numel() for v in port_state.values()):,} parameters" \
        in capsys.readouterr().out
    meta = json.loads(open(str(dst) + ".meta.json").read())
    assert meta["rot_to_quat_method"] == "eigh" and meta["source_file"] == "epoch.29.ckpt"
    model, config = load_pretrained_model(str(tmp_path), "tiny", 30, device="cpu")
    assert config.tpu["rot_to_quat_method"] == "eigh"
    loaded = model.state_dict()
    assert set(loaded) == set(port_state)
    for k, v in port_state.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    # genie2_tpu's converter reads the same reference file to the same weights.
    theirs = params_from_flax(load_torch_checkpoint(str(src)))
    assert set(theirs) == set(port_state) and all(torch.equal(theirs[k], v) for k, v in port_state.items())


def test_convert_checks_the_configuration(tmp_path, port_state):
    ckpts = release(tmp_path, extra="numStructureLayers 2\n")
    torch.save(lightning_blob(port_state), ckpts / "src.ckpt")
    with pytest.raises(ValueError, match="missing .*structure_net.net.1"):
        convert_checkpoint.main([str(ckpts / "src.ckpt"), str(ckpts / "dst.ckpt"),
                                 "--config", str(tmp_path / "tiny" / "configuration")])
    assert not os.path.exists(ckpts / "dst.ckpt")


def randomized(variables):
    """Trained weights are nowhere zero: the zero-init leaves get small
    seeded values, so every layer reaches z."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    leaves = [0.2 * jax.random.normal(k, x.shape, x.dtype) if not np.any(np.asarray(x)) else x
              for k, x in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("method", ["closed", "eigh"])
def test_orbax_checkpoint_through_the_bridge(tmp_path, method, one_sign):
    """An orbax directory of genie2_tpu, with a sidecar naming eigh (as
    genie2_tpu's converter stamps) or none (closed, genie2_tpu's default)."""
    jckpts = release(tmp_path / "jax")
    jconfig = JConfig(str(tmp_path / "jax" / "tiny" / "configuration"))
    jmodel = JDenoiser.from_config(jconfig)
    src = str(jckpts / "epoch.1.ckpt")
    jmodel_io.save_params(src, randomized(jmodel_io.init_params(jmodel, jconfig, seed=0)))
    if method == "eigh":
        with open(src + ".meta.json", "w") as f:
            json.dump({"source": "torch_lightning", "rot_to_quat_method": "eigh"}, f)

    ckpts = release(tmp_path / "port")
    orbax_to_torch().main([src, str(ckpts / "epoch.1.ckpt")])
    assert json.loads(open(ckpts / "epoch.1.ckpt.meta.json").read())["rot_to_quat_method"] == method
    port, config = load_pretrained_model(str(tmp_path / "port"), "tiny", 1, device="cpu")
    jmodel, jvars, jconfig = jmodel_io.load_pretrained_model(str(tmp_path / "jax"), "tiny", 1)
    assert config.tpu["rot_to_quat_method"] == jconfig.tpu["rot_to_quat_method"] == method
    assert_z_close(*z_of_both(jmodel, jvars, port))
    assert all(n > 0 for n in one_sign.values()) == (method == "eigh")


def test_orbax_refusal_names_the_bridge(tmp_path):
    ckpts = release(tmp_path)
    os.makedirs(ckpts / "epoch.1.ckpt")
    with pytest.raises(NotImplementedError, match="tools/orbax_to_torch.py"):
        load_pretrained_model(str(tmp_path), "tiny", 1, device="cpu")


@pytest.mark.parametrize("method", ["closed", "eigh"])
def test_port_trainer_checkpoint_loads_in_genie2_tpu(tmp_path, method, one_sign):
    """Two steps of the port's Trainer (lr 1e-2, so the zero-init leaves
    move), its epoch=0.ckpt and sidecar read by genie2_tpu's training-layout
    loader."""
    lines = CONFIG_LINES + (f"rootDirectory {tmp_path}\nnumEpoches 1\nbatchSize 2\nlearningRate 1e-2\n"
                            f"checkpointEveryEpoches 1\nlogEverySteps 1\nrotToQuatMethod {method}\n")
    os.makedirs(tmp_path / "tiny")
    (tmp_path / "tiny" / "configuration").write_text(lines)
    trainer = Trainer(Config(str(tmp_path / "tiny" / "configuration")), device="cpu")
    trainer.fit(synthetic_dataset(4, max_n_res=24))
    assert os.path.isfile(os.path.join(trainer.ckpt_dir, "epoch=0.ckpt.meta.json"))
    jmodel, jvars, jconfig = jmodel_io.load_model(str(tmp_path), "tiny")
    assert jconfig.tpu["rot_to_quat_method"] == method
    assert_z_close(*z_of_both(jmodel, jvars, trainer.model.eval()))
    assert all(n > 0 for n in one_sign.values()) == (method == "eigh")
