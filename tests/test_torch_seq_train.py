"""Training steps under sequence parallelism (two seq ranks over gloo):

  * against genie2_tpu's seq-sharded step (its pair tensor over a seq axis
    of two virtual CPU devices) with its t and noise injected, dropout 0
    and remat on: the metrics within 1e-5 relative
    (tests/test_seq_sharding.py:185) and every gradient within 1e-4 of its
    leaf's max (or 1e-3 of the largest leaf's, as tests/test_torch_train.py
    holds one process), the parameters after the step;
  * against the port's one-process steps with dropout and remat on (the
    masks drawn for every residue and sliced to each rank's rows), at a
    batch length the seq axis divides and at one it does not (padded with
    masked residues): three steps' metrics within 1e-5, gradients within
    1e-5 of max, the two ranks' parameters bit for bit equal.
"""

import jax
import numpy as np
import pytest
import torch

from genie2_tpu.diffusion import Schedule as JSchedule
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.parallel import create_mesh as jcreate_mesh
from genie2_tpu.parallel import replicate as jreplicate
from genie2_tpu.parallel import shard_batch as jshard_batch
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.train import create_train_state as jcreate_train_state
from genie2_tpu.train import make_train_step as jmake_train_step
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.parallel.spawn import run_ranks
from tests import torch_ranks
from tests.test_torch_parallel_train import jax_setup  # noqa: F401 (fixture)
from tests.test_torch_train import (LR, NO_DROPOUT, STEPS, TINY, _as_torch, _batch, _injected, _jax_grad_fn,
                                    _leaf_close, _port_model)

REMAT = {**TINY, **NO_DROPOUT, "remat": True}
WITH_DROPOUT = {**TINY, "remat": True}


def _close(got, want, rtol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-7, err_msg=k)


def _uneven(batch):
    """The batch cut to 23 residues (the seq axis of two does not divide it)."""
    return {k: v if k.startswith("num") else v[:, :23, :23] if k == "fixed_structure_mask" else v[:, :23]
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(jax_setup):  # noqa: F811 (fixture)
    """genie2_tpu's seq-sharded step (and its gradient) on one injected key;
    the port's runs: the same step on two seq ranks, and three steps with
    dropout on, at 24 and at 23 residues, on two seq ranks and alone."""
    jconfig, config, batch, flax_model, variables = jax_setup
    mesh = jcreate_mesh(n_data=1, n_seq=2)
    model_seq = FlaxDenoiser.from_config(jconfig, mesh=mesh)
    jschedule = JSchedule.create(jconfig.diffusion["n_timestep"])
    state, tx = jcreate_train_state(variables, lr=LR)
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    feats = jshard_batch(batch, mesh)
    want_grads = _as_torch(_jax_grad_fn(model_seq, jschedule, feats)(jreplicate(variables, mesh), key))
    jstate, jmetrics = jmake_train_step(model_seq, jschedule, tx, 1.0)(jreplicate(state, mesh), feats, key)
    inject = [_injected(key, batch, config.diffusion["n_timestep"])]

    state_dict = _port_model(config, variables).state_dict()
    dropout_dict = torch_ranks.seeded_model(Config(overrides=WITH_DROPOUT)).state_dict()
    work = [((REMAT, state_dict, batch, 1, LR, inject), {"n_seq": 2})]
    for b in (_batch(), _uneven(_batch())):
        work.append(((WITH_DROPOUT, dropout_dict, b, STEPS, LR), {"n_seq": 2}))
    ranks = run_ranks(torch_ranks.train_runs, 2, (work,))
    alone = [torch_ranks.train_steps(0, *args, distributed=False) for args, _ in work[1:]]
    return {"jax": (jmetrics, want_grads, _as_torch(jstate.params)), "ranks": ranks, "alone": alone}


def test_seq_step_matches_genie2_tpu(runs):
    """One step on two seq ranks against genie2_tpu's seq-sharded step with
    the same t and noise (dropout 0, remat on): metrics within 1e-5
    relative, gradients within 1e-4 of each leaf's max, each rank the
    same parameters after the step, as genie2_tpu's within Adam's bound."""
    jmetrics, want_grads, want_params = runs["jax"]
    for rank_runs in runs["ranks"]:
        (records, params, _) = rank_runs[0]
        metrics, grads = records[0]
        _close(metrics, {k: float(v) for k, v in jmetrics.items()})
        _leaf_close(grads, want_grads, 1e-4, 1e-3)
        for name, p in params.items():
            assert (p - want_params[name]).abs().max().item() <= 2 * LR, name
    p0, p1 = runs["ranks"][0][0][1], runs["ranks"][1][0][1]
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


@pytest.mark.parametrize("case", [1, 2], ids=["even", "padded"])
def test_seq_steps_with_dropout_equal_one_process(runs, case):
    """Three steps with dropout and remat on, the masks of one process
    sliced to each rank's residue rows (and drawn for the real residues
    where the batch length is padded): metrics within 1e-5, gradients
    within 1e-5 of max, the ranks' parameters bit for bit equal."""
    want_records = runs["alone"][case - 1][0]
    ranks = [r[case] for r in runs["ranks"]]
    for records, _, _ in ranks:
        for (metrics, grads), (want_metrics, want_grads) in zip(records, want_records):
            _close(metrics, want_metrics)
            top = max(w.abs().max().item() for w in want_grads.values())
            err = max((grads[n] - w).abs().max().item() for n, w in want_grads.items())
            assert err <= 1e-5 * top, (err, top)
    assert all(torch.equal(ranks[0][1][n], ranks[1][1][n]) for n in ranks[0][1])
