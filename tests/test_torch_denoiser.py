"""The whole genie2_tpu_torch Denoiser against the genie2_tpu flax Denoiser.

Small dims (the ready config of the JAX package's torch-parity test), with
triangle attention off and, in a second model, on. Flax init -> zero-init leaves randomised -> the
weight bridge -> the same frames, timesteps and features; z must agree
within 1e-4 in fp32 on real residues.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu_torch.features import batchify, create_empty_features, to_device
from genie2_tpu_torch.geometry import Rigid, frenet_frames
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.nn.policy import apply_denoiser
from genie2_tpu_torch.utils.model_io import load_pretrained_model
from genie2_tpu_torch.utils.weights import params_from_flax

DIMS = dict(
    c_s=32, c_p=16, n_timestep=50, rescale=1.0, c_pos_emb=16, c_chain_emb=8, c_timestep_emb=16,
    max_n_res=32, max_n_chain=1, relpos_k=4, template_dist_min=2.0, template_dist_step=0.5,
    template_dist_n_bin=9, n_pair_transform_layer=2, include_mul_update=True, include_tri_att=False,
    c_hidden_mul=8, c_hidden_tri_att=4, n_head_tri=2, tri_dropout=0.25, pair_transition_n=2,
    n_structure_layer=2, n_structure_block=1, c_hidden_ipa=4, n_head_ipa=2, n_qk_point=2,
    n_v_point=3, ipa_dropout=0.1, n_structure_transition_layer=1, structure_transition_dropout=0.1,
)
CONFIG_LINES = """name tiny
maximumNumResidues 32
numTimesteps 50
singleFeatureDimension 32
pairFeatureDimension 16
positionalEmbeddingDimension 16
chainEmbeddingDimension 8
timestepEmbeddingDimension 16
relativePositionK 4
templateDistanceNumBins 9
numPairTransformLayers 2
triangularMultiplicativeHiddenDimension 8
pairTransitionN 2
numStructureLayers 2
ipaHiddenDimension 4
ipaNumHeads 2
ipaNumQkPoints 2
ipaNumVPoints 3
"""


def make_batch(padded: bool, with_motif: bool):
    rng = np.random.default_rng(0)
    feats = []
    for length in ((24, 19) if padded else (24, 24)):
        f = create_empty_features([length])
        if with_motif:
            seq = np.zeros(length, dtype=bool)
            seq[5:10] = True
            seq[14:17] = True
            f["fixed_sequence_mask"] = seq
            f["fixed_structure_mask"] = seq[:, None] & seq[None, :]
            f["fixed_group"] = seq.astype(int)
            f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
            f["atom_positions"][seq] = rng.normal(size=(seq.sum(), 3)) * 4
        feats.append(f)
    return batchify(feats)


def randomized_variables(model, batch, dims=DIMS, jit=False):
    """`jit` compiles the flax init as one program (seconds instead of the
    op-by-op minute at these widths)."""
    feats = jto_device(batch)
    trans = jnp.zeros(batch["atom_positions"].shape, jnp.float32)
    rots = jfrenet(trans, feats["chain_index"], feats["residue_mask"])
    init = jax.jit(model.init) if jit else model.init
    variables = init(jax.random.PRNGKey(0), JRigid(rots, trans), jnp.array([1, 1]), feats)
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    # Trained weights are nowhere zero: give the "final"/"gating" zero-init
    # leaves small random values so every layer reaches z.
    leaves = [
        0.2 * jax.random.normal(k, l.shape, l.dtype) if not np.any(np.asarray(l)) else l
        for k, l in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxDenoiser(remat=False, **DIMS)
    variables = randomized_variables(flax_model, make_batch(False, False))
    port = Denoiser(**DIMS)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval()


def run_both(models, batch, trans_np, t_np):
    flax_model, variables, port = models
    jf = jto_device(batch)
    tj = jnp.asarray(trans_np)
    out_j = flax_model.apply(
        variables, JRigid(jfrenet(tj, jf["chain_index"], jf["residue_mask"]), tj), jnp.asarray(t_np), jf
    )
    tf = to_device(batch, "cpu")
    tt = torch.tensor(trans_np)
    with torch.inference_mode():
        out_t = port(Rigid(frenet_frames(tt, tf["chain_index"], tf["residue_mask"]), tt), torch.tensor(t_np), tf)
    return out_j, out_t


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("with_motif", [False, True])
def test_denoiser_z_matches(models, padded, with_motif):
    batch = make_batch(padded, with_motif)
    rng = np.random.default_rng(42)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3).astype(np.float32)
    trans_np *= batch["residue_mask"][..., None]
    t_np = np.array([7, 31], dtype=np.int32)
    out_j, out_t = run_both(models, batch, trans_np, t_np)
    real = batch["residue_mask"].astype(bool)
    z_j, z_t = np.asarray(out_j["z"])[real], out_t["z"].numpy()[real]
    assert np.abs(z_j).max() > 1e-3  # not vacuous
    np.testing.assert_allclose(z_t, z_j, atol=1e-4)
    pair = real[:, :, None] & real[:, None, :]
    np.testing.assert_allclose(out_t["p"].numpy()[pair], np.asarray(out_j["p"])[pair], atol=2e-4)


TRI_ATT_DIMS = dict(DIMS, include_tri_att=True)


@pytest.fixture(scope="module")
def tri_att_models():
    """The small denoiser with triangle attention in both pair layers."""
    flax_model = FlaxDenoiser(remat=False, **TRI_ATT_DIMS)
    variables = randomized_variables(flax_model, make_batch(False, False))
    port = Denoiser(**TRI_ATT_DIMS)
    port.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return flax_model, variables, port.eval()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("tri_att_chunk", [0, 5])
def test_denoiser_with_triangle_attention_z_matches(tri_att_models, padded, tri_att_chunk):
    """Start and end triangle attention in every pair layer; the row chunk
    (5 does not divide 24) changes no number on either side."""
    flax_model, variables, port = tri_att_models
    flax_chunked = FlaxDenoiser(remat=False, tri_att_chunk=tri_att_chunk, **TRI_ATT_DIMS)
    port_chunked = Denoiser(**TRI_ATT_DIMS, tri_att_chunk=tri_att_chunk)
    port_chunked.load_state_dict(port.state_dict())
    assert port_chunked.pair_transform_net.net[1].tri_att_end.mha.row_chunk == tri_att_chunk
    batch = make_batch(padded, True)
    rng = np.random.default_rng(43)
    trans_np = (rng.normal(size=batch["atom_positions"].shape) * 3).astype(np.float32)
    trans_np *= batch["residue_mask"][..., None]
    out_j, out_t = run_both((flax_chunked, variables, port_chunked.eval()), batch, trans_np, np.array([7, 31], np.int32))
    real = batch["residue_mask"].astype(bool)
    z_j, z_t = np.asarray(out_j["z"])[real], out_t["z"].numpy()[real]
    assert np.abs(z_j).max() > 1e-3
    np.testing.assert_allclose(z_t, z_j, atol=1e-4)
    pair = real[:, :, None] & real[:, None, :]
    np.testing.assert_allclose(out_t["p"].numpy()[pair], np.asarray(out_j["p"])[pair], atol=2e-4)
    assert out_t["p"].is_contiguous()  # the IPA kernel reads the pair representation in place
    # Triangle attention moves z: the same weights without it predict something else.
    without = Denoiser(**DIMS)
    without.load_state_dict({k: v for k, v in port.state_dict().items() if "tri_att" not in k})
    tf = to_device(batch, "cpu")
    tt = torch.tensor(trans_np)
    with torch.inference_mode():
        z_off = without.eval()(Rigid(frenet_frames(tt, tf["chain_index"], tf["residue_mask"]), tt),
                               torch.tensor([7, 31]), tf)["z"].numpy()[real]
    assert np.abs(z_off - z_t).max() > 1e-3


def test_from_config_builds_triangle_attention(tmp_path):
    from genie2_tpu_torch.config import Config

    path = tmp_path / "configuration"
    lines = (CONFIG_LINES + "includeTriangularAttention True\ntriangularAttentionHiddenDimension 4\n"
             "triangularAttentionNumHeads 2\ntriangleAttentionChunk 6\n")
    path.write_text(lines)
    config = Config(str(path))
    # usePallas and scanSteps are genie2_tpu's keys: accepted, and not read.
    (tmp_path / "with_jax_keys").write_text(lines + "usePallas True\nscanSteps 4\n")
    assert Config(str(tmp_path / "with_jax_keys")).as_dict() == config.as_dict()
    model = Denoiser.from_config(config)
    state = model.state_dict()
    for name in ("layer_norm.weight", "linear.weight", "mha.linear_q.weight", "mha.linear_g.bias", "mha.linear_o.weight"):
        assert f"pair_transform_net.net.1.tri_att_end.{name}" in state
    assert "pair_transform_net.net.0.tri_att_start.linear.bias" not in state
    assert state["pair_transform_net.net.0.tri_att_start.mha.linear_q.weight"].shape == (8, 16)
    assert model.pair_transform_net.net[0].tri_att_start.mha.row_chunk == 6


def test_state_dict_roundtrip_and_release_layout(models, tmp_path):
    """Reference-keyed state_dict -> load_state_dict; a Lightning-style
    release checkpoint loads through model_io with the same weights, and the
    quaternion method follows the sidecar rule."""
    _, _, port = models
    state = port.state_dict()
    assert "pair_transform_net.net.0.tri_mul_out.linear_a_p.weight" in state
    assert "structure_net.net.1.transition.layers.0.linear_3.weight" in state
    assert "structure_net.net.0.ipa.head_weights" in state

    root = tmp_path / "results"
    (root / "tiny" / "checkpoints").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES)
    ckpt = root / "tiny" / "checkpoints" / "epoch.3.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}}, ckpt)
    # The sidecar stamps the closed-form quaternions of the flax reference;
    # a raw torch checkpoint without one selects eigh.
    (root / "tiny" / "checkpoints" / "epoch.3.ckpt.meta.json").write_text('{"rot_to_quat_method": "closed"}')
    loaded, config = load_pretrained_model(str(root), "tiny", 3, device="cpu")
    assert config.tpu["rot_to_quat_method"] == "closed"
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)

    os.remove(str(ckpt) + ".meta.json")
    _, config = load_pretrained_model(str(root), "tiny", 3, device="cpu")
    assert config.tpu["rot_to_quat_method"] == "eigh"
    with pytest.raises(FileNotFoundError):
        load_pretrained_model(str(root), "tiny", 3, ema=True, device="cpu")


def test_orbax_directory_is_refused(tmp_path):
    root = tmp_path / "results"
    (root / "tiny" / "checkpoints" / "epoch.1.ckpt").mkdir(parents=True)
    (root / "tiny" / "configuration").write_text(CONFIG_LINES)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_pretrained_model(str(root), "tiny", 1, device="cpu")


def test_bf16_policy_runs(models):
    _, _, port = models
    model = Denoiser(**DIMS)
    model.load_state_dict(port.state_dict())
    model = model.to(torch.bfloat16).eval()
    batch = make_batch(True, False)
    f = to_device(batch, "cpu")
    trans = torch.tensor(np.random.default_rng(1).normal(size=batch["atom_positions"].shape) * 3).float()
    rots = frenet_frames(trans, f["chain_index"], f["residue_mask"])
    with torch.inference_mode():
        z16 = apply_denoiser(model, Rigid(rots, trans), torch.tensor([3, 9]), f, dtype=torch.bfloat16)
        z32 = port(Rigid(rots, trans), torch.tensor([3, 9]), f)["z"]
    assert z16.dtype == torch.float32 and torch.isfinite(z16).all()
    # bf16 frames and activations drift from fp32; the prediction keeps its direction.
    cos = torch.nn.functional.cosine_similarity(z16.flatten(), z32.flatten(), dim=0)
    assert cos > 0.9, cos
