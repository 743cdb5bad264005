"""genie2_tpu_torch's precision policy against genie2_tpu's.

- A sampler built with the bf16 policy leaves the caller's model as it was:
  float32 parameters, bit for bit, and an fp32 sampler built afterwards
  predicts what it predicts on a fresh model (genie2_tpu's samplers cast a
  copy of the parameter tree).
- The port's bf16 denoiser (`cast_model` + `apply_denoiser`) against
  `genie2_tpu.nn.policy.make_apply_fn(model, "bf16")`: the same weights
  (`params_from_flax`), features and frames, at the small width of
  tests/test_torch_denoiser.py, with and without triangle attention.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.nn.policy import make_apply_fn
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import to_device
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.nn.policy import apply_denoiser, cast_model
from genie2_tpu_torch.sampling import UnconditionalSampler
from genie2_tpu_torch.utils.weights import params_from_flax
from tests.test_torch_denoiser import CONFIG_LINES, DIMS, make_batch, randomized_variables

# bf16 z of the two frameworks. Both run every activation in bfloat16 from
# the same bf16-rounded weights, but they round at other points inside a
# layer: genie2_tpu's jnp TriMul rounds each projection, each sigmoid and
# each product to bfloat16, where the port rounds the gated product once, as
# genie2_tpu's fused Pallas TriMul does (ops/trimul_fused.py); its IPA core
# keeps the softmax in float32 and rounds p only before it multiplies z, as
# genie2_tpu's Pallas IPA kernel does. Each rounding is up to 2^-9 relative,
# so the two bf16 results differ by about as much as either differs from
# float32 (measured at this width: 7.1e-2 and 2.8e-2 of max |z| at most,
# root mean square 0.97x and 0.63x genie2_tpu's own bf16-vs-fp32
# deviation). A cast placed elsewhere, or a float32 sum one side leaves in
# bfloat16, adds its own error on top. Held: max |diff| <= 1e-1 of max |z|
# and rms |diff| <= 1.25x rms |bf16 - fp32| of genie2_tpu.
BF16_TOL = 1e-1
BF16_RMS_FACTOR = 1.25


def _frames(batch, trans_np):
    """The same Frenet frames on both sides, from the same coordinates."""
    jf = jto_device(batch)
    tj = jnp.asarray(trans_np)
    tf = to_device(batch, "cpu")
    tt = torch.tensor(trans_np)
    return (jf, JRigid(jfrenet(tj, jf["chain_index"], jf["residue_mask"]), tj),
            tf, Rigid(frenet_frames(tt, tf["chain_index"], tf["residue_mask"]), tt))


def _bridged(dims):
    flax_model = FlaxDenoiser(remat=False, **dims)
    variables = randomized_variables(flax_model, make_batch(False, False), dims)
    port = Denoiser(**dims)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval()


@pytest.mark.parametrize("tri_att", [False, True])
def test_bf16_z_matches_genie2_tpu_bf16_policy(tri_att):
    dims = dict(DIMS, include_tri_att=tri_att)
    flax_model, variables, port = _bridged(dims)
    batch = make_batch(True, True)
    rng = np.random.default_rng(11)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3).astype(np.float32)
    trans_np *= batch["residue_mask"][..., None]
    t_np = np.array([7, 31], dtype=np.int32)
    jf, jframes, tf, tframes = _frames(batch, trans_np)

    z_j = np.asarray(make_apply_fn(flax_model, "bf16")(variables, jframes, jnp.asarray(t_np), jf)["z"])
    z_j32 = np.asarray(make_apply_fn(flax_model, "fp32")(variables, jframes, jnp.asarray(t_np), jf)["z"])
    model16 = cast_model(port, torch.bfloat16)
    with torch.inference_mode():
        z_t = apply_denoiser(model16, tframes, torch.tensor(t_np), tf, dtype=torch.bfloat16)
    assert z_j.dtype == np.float32 and z_t.dtype == torch.float32
    real = batch["residue_mask"].astype(bool)
    z_j, z_j32, z_t = z_j[real], z_j32[real], z_t.numpy()[real]
    scale = np.abs(z_j).max()
    assert scale > 1e-2  # not vacuous
    err = np.abs(z_t - z_j).max()
    assert err <= BF16_TOL * scale, (err, scale)
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))
    assert rms(z_t - z_j) <= BF16_RMS_FACTOR * rms(z_j - z_j32), (rms(z_t - z_j), rms(z_j - z_j32))


def _write_config(tmp_path):
    path = tmp_path / "configuration"
    path.write_text(CONFIG_LINES.replace("numTimesteps 50", "numTimesteps 8"))
    return str(path)


def test_bf16_sampler_leaves_the_callers_model_as_it_was(tmp_path):
    """The sampler runs a bf16 copy; the caller's parameters stay float32
    and bit-identical, and an fp32 sampler built afterwards on the same
    model predicts what one built on a fresh copy predicts."""
    config = Config(_write_config(tmp_path))
    torch.manual_seed(0)
    model = Denoiser(**dict(DIMS, n_timestep=8)).eval()
    fresh = copy.deepcopy(model)

    bf16 = UnconditionalSampler(model, config, dtype="bf16")
    assert next(bf16.model.parameters()).dtype == torch.bfloat16
    for (name, p), (_, q) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert p.dtype == q.dtype, name
        assert torch.equal(p, q), name

    batch = make_batch(True, False)
    rng = np.random.default_rng(5)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3).astype(np.float32)
    _, _, tf, tframes = _frames(batch, trans_np)
    t = torch.tensor([3, 6])
    with torch.inference_mode():
        after = UnconditionalSampler(model, config).make_model_fn(tf)(tframes, t)
        want = UnconditionalSampler(fresh, config).make_model_fn(tf)(tframes, t)
    assert after.dtype == torch.float32
    assert torch.equal(after, want)


def test_cast_model_copies_only_when_the_dtype_changes():
    model = Denoiser(**DIMS)
    assert cast_model(model, torch.float32) is model
    half = cast_model(model, torch.bfloat16)
    assert half is not model
    assert all(p.dtype == torch.bfloat16 for p in half.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert cast_model(half, torch.bfloat16) is half
