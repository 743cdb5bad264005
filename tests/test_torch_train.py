"""genie2_tpu_torch's training step against genie2_tpu's.

The tiny configuration of tests/test_train.py (dropout rates 0 here, so
that both steps are deterministic), the same weights through the weight
bridge, the same batch, and t and the noise derived from the JAX key
exactly as genie2_tpu's step derives them (`split(key, 3)`, `randint + 1`,
`normal`), injected into the port's step. Compared: the loss and its
metrics, `grad_norm`, every parameter's gradient, and the Adam moments and
parameters after 3 steps; the bf16 step; the EMA. Then the port alone:
dropout's rate, scale and broadcast axes, and remat on = remat off with
dropout on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.config import Config as JConfig
from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.diffusion import q_sample as jq_sample
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.train import MotifAugmentConfig as JMotifAugmentConfig
from genie2_tpu.train import create_train_state as jcreate_train_state
from genie2_tpu.train import genie_loss as jgenie_loss
from genie2_tpu.train import make_train_step as jmake_train_step
from genie2_tpu.train import synthetic_dataset as jsynthetic_dataset
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, create_empty_features, to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.nn.primitives import dropout, layer_generator
from genie2_tpu_torch.train import create_train_state, genie_loss, make_train_step
from genie2_tpu_torch.utils.weights import params_from_flax

TINY = {
    "singleFeatureDimension": 16, "pairFeatureDimension": 8, "positionalEmbeddingDimension": 8,
    "chainEmbeddingDimension": 4, "timestepEmbeddingDimension": 8, "templateDistanceNumBins": 5,
    "numPairTransformLayers": 1, "triangularMultiplicativeHiddenDimension": 4, "numStructureLayers": 1,
    "ipaHiddenDimension": 4, "ipaNumHeads": 2, "ipaNumQkPoints": 2, "ipaNumVPoints": 2, "numTimesteps": 10,
    "maximumNumResidues": 24, "remat": False,
}
NO_DROPOUT = {"triangularDropout": 0.0, "ipaDropout": 0.0, "structureTransitionDropout": 0.0}
LR = 1e-3
STEPS = 3


def _batch():
    """4 synthetic structures of 20-24 residues padded to 24, half of them
    with a motif (genie2_tpu's own pipeline)."""
    ds = jsynthetic_dataset(8, max_n_res=24, motif=JMotifAugmentConfig(prob=0.5))
    return next(ds.epoch(4, np.random.default_rng(0)))


def _randomized(variables):
    """The zero-initialised "final" / "gating" leaves given small random
    values, so that every parameter has a gradient."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    leaves = [0.2 * jax.random.normal(k, l.shape, l.dtype) if not np.any(np.asarray(l)) else l
              for k, l in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def setup():
    overrides = {**TINY, **NO_DROPOUT}
    jconfig, config = JConfig(overrides=overrides), Config(overrides=overrides)
    batch = _batch()
    feats = jto_device(batch)
    flax_model = FlaxDenoiser.from_config(jconfig)
    trans = feats["atom_positions"]
    rots = jfrenet(trans, feats["chain_index"], feats["residue_mask"])
    init = jax.jit(flax_model.init)
    variables = _randomized(init(jax.random.PRNGKey(0), JRigid(rots, trans), jnp.ones(4, jnp.int32), feats))
    return jconfig, config, batch, flax_model, variables


def _port_model(config, variables):
    model = Denoiser.from_config(config)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return model


def _injected(key, batch, n_timestep):
    """t and the unmasked noise of genie2_tpu's step for `key`."""
    t_key, noise_key, _ = jax.random.split(key, 3)
    t = jax.random.randint(t_key, (batch["atom_positions"].shape[0],), 0, n_timestep) + 1
    noise = jax.random.normal(noise_key, batch["atom_positions"].shape, dtype=jnp.float32)
    return torch.tensor(np.asarray(t)), torch.tensor(np.asarray(noise))


def _jax_grad_fn(flax_model, schedule, feats):
    """genie2_tpu's loss gradient as a function of (params, key), as its
    step takes it."""

    def loss_fn(p, key):
        t_key, noise_key, dropout_key = jax.random.split(key, 3)
        x0 = feats["atom_positions"]
        t = jax.random.randint(t_key, (x0.shape[0],), 0, schedule.n_timestep) + 1
        z = jax.random.normal(noise_key, x0.shape, dtype=x0.dtype) * feats["residue_mask"].astype(x0.dtype)[..., None]
        trans_t = jq_sample(schedule, x0, t, z)
        ts = JRigid(jfrenet(trans_t, feats["chain_index"], feats["residue_mask"]), trans_t)
        out = flax_model.apply(p, ts, t, feats, deterministic=False, rngs={"dropout": dropout_key})
        return jgenie_loss(out["z"], z, feats, 1.0)[0]

    return jax.jit(jax.grad(loss_fn))


def _as_torch(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _run_both(setup, steps=STEPS, lr=LR, ema_decay=0.0, compute_dtype="fp32", grads=False):
    """`steps` steps of genie2_tpu's make_train_step and of the port's on
    the same weights, batch, t and noise. Returns (jax state, port state,
    per-step (jax metrics, port metrics, jax grads or None, port grads),
    initial port parameters)."""
    jconfig, config, batch, flax_model, variables = setup
    jschedule = JSchedule.create(jconfig.diffusion["n_timestep"])
    jstate, tx = jcreate_train_state(variables, lr=lr, ema_decay=ema_decay)
    jstep = jmake_train_step(flax_model, jschedule, tx, 1.0, compute_dtype=compute_dtype, ema_decay=ema_decay)
    feats_j = jto_device(batch)
    grad_fn = _jax_grad_fn(flax_model, jschedule, feats_j) if grads else None

    model = _port_model(config, variables)
    state = create_train_state(model, lr, ema_decay=ema_decay)
    step = make_train_step(Schedule.create(config.diffusion["n_timestep"]), 1.0, compute_dtype, ema_decay)
    feats = to_device(batch, "cpu")
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    records = []
    key = jax.random.PRNGKey(11)
    for i in range(steps):
        key, sub = jax.random.split(key)
        want_grads = _as_torch(grad_fn(jstate.params, sub)) if grads else None
        jstate, jmetrics = jstep(jstate, feats_j, sub)
        t, noise = _injected(sub, batch, config.diffusion["n_timestep"])
        metrics = step(state, feats, t=t, noise=noise, dropout_seed=i)
        records.append((jmetrics, metrics, want_grads, {n: p.grad.clone() for n, p in model.named_parameters()}))
    return jstate, state, records, p0


@pytest.fixture(scope="module")
def fp32_run(setup):
    return _run_both(setup, grads=True)


def _leaf_close(got, want, tol, floor):
    """Each leaf within `tol` of its own max |want|, or of `floor` times
    the max over all leaves where that is larger: a leaf whose exact value
    is 0 (the IPA pair bias's bias: the softmax ignores a shift of a head's
    logits) holds float32 rounding noise only."""
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        g = got[name].detach().float()
        scale = max(w.abs().max().item(), floor * top)
        err = (g - w).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


def _params_close(got, want, p0, nu, lr, steps):
    """Parameters (or an EMA of them) after `steps` Adam steps. Adam's
    update is about lr g / (|g| + eps) on the first step, so an entry whose
    gradients are all near zero moves by up to lr a step on either side
    whatever their exact value: entries are compared at 1e-3 lr where the
    second moment's root, sqrt(nu / (1 - b2^t)), is at least 1e-5 (a
    thousand times eps; 90% or more of the entries that have a gradient),
    exactly where genie2_tpu's gradients were 0 at every step (the one-hot
    rows of residue types the batch lacks, for one: neither step moves
    them), and elsewhere held to Adam's bound of lr a step."""
    n_stable = n_moving = 0
    for name, w in want.items():
        moved, want_moved = got[name].detach() - p0[name], w - p0[name]
        err = (moved - want_moved).abs()
        assert err.max().item() <= steps * lr * 2, name
        still = nu[name] == 0
        assert not moved[still].any() and not want_moved[still].any(), name
        stable = torch.sqrt(nu[name] / (1 - 0.999 ** steps)) >= 1e-5
        n_stable, n_moving = n_stable + int(stable.sum()), n_moving + int((~still).sum())
        if stable.any():
            assert err[stable].max().item() <= 1e-3 * lr, (name, err[stable].max().item())
    assert n_stable >= 0.9 * n_moving


def test_train_step_metrics_and_gradients_match(fp32_run):
    """Each of three steps: the loss and its metrics within 1e-5 relative
    (grad_norm, the global norm of the gradients before the update,
    among them), and every parameter's gradient within 1e-4 of its leaf's
    max |grad| (or of 1e-3 of the largest leaf's, `_leaf_close`)."""
    _, _, records, _ = fp32_run
    for jmetrics, metrics, want_grads, got_grads in records:
        assert set(metrics) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
        _leaf_close(got_grads, want_grads, 1e-4, 1e-3)


def test_adam_state_and_parameters_after_three_steps_match(fp32_run):
    """After three steps: the Adam moments (mu within 1e-4, nu within 2e-4,
    as `_leaf_close`) and the parameters (`_params_close`)."""
    jstate, state, _, p0 = fp32_run
    model = state.model
    adam = jstate.opt_state[0]
    mu, nu = _as_torch(adam.mu), _as_torch(adam.nu)
    opt = {n: state.optimizer.state[p] for n, p in model.named_parameters()}
    _leaf_close({n: s["exp_avg"] for n, s in opt.items()}, mu, 1e-4, 1e-3)
    _leaf_close({n: s["exp_avg_sq"] for n, s in opt.items()}, nu, 2e-4, 1e-6)
    _params_close(dict(model.named_parameters()), _as_torch(jstate.params), p0, nu, LR, STEPS)
    assert int(jstate.step) == state.step == STEPS


def test_ema_matches_after_three_steps(setup):
    """emaDecay 0.5, lr 1e-2: the EMA d e + (1 - d) p after each update,
    held after three steps as the parameters are (`_params_close`)."""
    lr, decay = 1e-2, 0.5
    jstate, state, _, p0 = _run_both(setup, lr=lr, ema_decay=decay)
    nu = _as_torch(jstate.opt_state[0].nu)
    _params_close(state.ema, _as_torch(jstate.ema), p0, nu, lr, STEPS)
    diff = max((state.ema[n] - p.detach()).abs().max().item() for n, p in state.model.named_parameters())
    assert diff > 0  # the EMA lags the parameters


def test_bf16_step_matches_genie2_tpu_and_fp32(setup, fp32_run):
    """computeDtype bf16: float32 master weights, Adam state and gradients;
    the loss within 0.1 of genie2_tpu's bf16 step and of the port's own
    float32 step (tests/test_train.py's bound: the two bf16 policies round
    at other points, ROADMAP C), the gradients' direction within 0.98
    cosine of the float32 step's."""
    jstate, state, records, _ = _run_both(setup, steps=1, compute_dtype="bf16")
    jmetrics, metrics, _, grads = records[0]
    _, _, records32, _ = fp32_run
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in state.model.parameters())
    loss = float(metrics["weighted_loss"])
    assert np.isfinite(loss)
    assert abs(loss - float(jmetrics["weighted_loss"])) < 0.1
    assert abs(loss - float(records32[0][1]["weighted_loss"])) < 0.1
    g16 = torch.cat([g.flatten() for g in grads.values()])
    g32 = torch.cat([records32[0][3][n].flatten() for n in grads])
    assert torch.nn.functional.cosine_similarity(g16, g32, dim=0).item() > 0.98


@pytest.mark.parametrize("with_motif", [False, True])
def test_genie_loss_matches(with_motif):
    """genie_loss and its six metrics against genie2_tpu's, within 1e-6
    relative, without and with motif rows (a padded batch)."""
    rng = np.random.default_rng(5)
    feats = []
    for length in (24, 19, 24):
        f = create_empty_features([length])
        if with_motif and length == 24:
            seq = rng.random(length) < 0.3
            f["fixed_sequence_mask"] = seq
        feats.append(f)
    batch = batchify(feats)
    zp = rng.normal(size=(3, 24, 3)).astype(np.float32)
    z = rng.normal(size=(3, 24, 3)).astype(np.float32)
    for w in (1.0, 3.0):
        jloss, jm = jgenie_loss(jnp.asarray(zp), jnp.asarray(z), jto_device(batch), w)
        loss, m = genie_loss(torch.tensor(zp), torch.tensor(z), to_device(batch, "cpu"), w)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, atol=1e-7, err_msg=k)
        assert float(m["frac_conditioned"]) == pytest.approx(2 / 3 if with_motif else 0.0)


# ------------------------------------------------------------------ #
# Dropout and remat (the port alone)
# ------------------------------------------------------------------ #


def test_dropout_rate_scale_and_broadcast():
    """flax's nn.Dropout: kept entries scaled by 1 / (1 - rate), the
    dropped share within 0.01 of the rate over 2^17 draws, one mask along
    each broadcast axis, the identity without a generator or at rate 0."""
    x = torch.rand(4, 64, 64, 8) + 0.5
    gen = layer_generator((0, 0, 4, 4), "cpu")  # the whole batch of 4
    for rate, axes in ((0.25, ()), (0.25, (-3,)), (0.1, (-2,))):
        y = dropout(x, rate, gen, axes)
        kept = y != 0
        assert torch.allclose(y[kept], (x / (1 - rate))[kept], rtol=0, atol=0)
        assert abs(1 - kept.float().mean().item() - rate) < 0.01
        for ax in axes:
            assert (kept == kept.narrow(ax, 0, 1)).all()
    assert dropout(x, 0.25, None, (-3,)) is x and dropout(x, 0.0, gen) is x


def _dropout_model(remat):
    config = Config(overrides={**TINY, "remat": remat})
    torch.manual_seed(3)
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    return randomize_zero_init(Denoiser.from_config(config), 3)


def _loss_and_grads(model, batch, dropout_seed):
    step = make_train_step(Schedule.create(10), 1.0)
    state = create_train_state(model, 0.0)
    feats = to_device(batch, "cpu")
    t = torch.tensor([3, 7, 1, 9])
    noise = torch.randn(feats["atom_positions"].shape, generator=torch.Generator().manual_seed(1))
    metrics = step(state, feats, t=t, noise=noise, dropout_seed=dropout_seed)
    return metrics["weighted_loss"], {n: p.grad.clone() for n, p in model.named_parameters()}


def test_dropout_in_training_only():
    """train(): the masks change the loss and follow the seed; eval(): no
    dropout (the samplers' mode, a new Denoiser's mode) and no generator
    needed; train() without a generator raises."""
    model = _dropout_model(False)
    assert not model.training
    batch = _batch()
    a, _ = _loss_and_grads(model, batch, 0)
    b, _ = _loss_and_grads(model, batch, 0)
    c, _ = _loss_and_grads(model, batch, 1)
    assert a == b and a != c
    feats = to_device(batch, "cpu")
    from genie2_tpu_torch.train.state import noised_input

    t, _, frames = noised_input(Schedule.create(10), feats, t=torch.tensor([3, 7, 1, 9]), noise=torch.zeros(4, 24, 3))
    model.eval()
    with torch.no_grad():
        z1 = model(frames, t, feats)["z"]
        z2 = model(frames, t, feats, generator=torch.Generator().manual_seed(5))["z"]
    assert torch.equal(z1, z2)
    model.train()
    with pytest.raises(ValueError):
        model(frames, t, feats)


def test_remat_matches_no_remat_with_dropout():
    """Remat (each pair layer under torch.utils.checkpoint) with dropout at
    the configuration's rates: the same loss and gradients as without,
    within 1e-6 of each leaf's max (the recompute draws the same masks
    from the layer's seed)."""
    batch = _batch()
    loss_r, g_r = _loss_and_grads(_dropout_model(True), batch, 4)
    loss_p, g_p = _loss_and_grads(_dropout_model(False), batch, 4)
    assert loss_r.item() == loss_p.item()
    _leaf_close(g_r, g_p, 1e-6, 1e-3)
