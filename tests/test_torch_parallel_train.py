"""Data-parallel training on two gloo ranks against one process.

The tiny configuration of tests/test_torch_train.py. Two ranks, each with
two rows of a global batch of four, against one process on the whole
batch: one step and three steps with dropout on (the masks keyed by each
row's global index), and with injected t and noise and dropout 0 against
genie2_tpu's `make_train_step` on the global batch (the tolerances of
tests/test_torch_train.py: metrics within 1e-5 relative, gradients within
1e-4 of each leaf's max, parameters after three steps as Adam allows).
Then the Trainer on two ranks: a SIGTERM to one rank stops both at the
same step, and the resumed run equals the uninterrupted one bit for bit;
and cli/train.py on two ranks against one process.

Every multi-process case runs through `parallel/spawn.py:run_ranks`, which
has its own deadline.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from genie2_tpu.config import Config as JConfig
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu_torch.cli import train as train_cli
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.parallel import Mesh
from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.train import loop
from tests import torch_ranks
from tests.test_torch_train import (
    LR,
    NO_DROPOUT,
    STEPS,
    TINY,
    _as_torch,
    _batch,
    _injected,
    _leaf_close,
    _params_close,
    _port_model,
    _randomized,
    _run_both,
)
from tests.test_torch_train_loop import CONFIG, write_corpus

WITH_DROPOUT = {**TINY, "remat": True}


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def dropout_runs():
    """Three steps, dropout and remat on: (two ranks' results, one process's)."""
    config = Config(overrides=WITH_DROPOUT)
    state_dict = torch_ranks.seeded_model(config).state_dict()
    args = (WITH_DROPOUT, state_dict, _batch(), STEPS, LR)
    return run_ranks(torch_ranks.train_steps, 2, args), torch_ranks.train_steps(0, *args, distributed=False)


def test_two_ranks_one_step_equals_one_process(dropout_runs):
    """Step 1: the global batch's loss and metrics (grad_norm after the
    all-reduce among them) and every gradient, on both ranks."""
    ranks, (records, _, _) = dropout_runs
    want_metrics, want_grads = records[0]
    for rank_records, _, _ in ranks:
        metrics, grads = rank_records[0]
        _close(metrics, want_metrics)
        _leaf_close(grads, want_grads, 1e-4, 1e-3)


def test_two_ranks_three_steps_equal_one_process(dropout_runs):
    """Each of three steps as above, then the parameters, the same on both
    ranks and as one process's within Adam's bounds (`_params_close`)."""
    ranks, (records, params, nu) = dropout_runs
    p0 = torch_ranks.seeded_model(Config(overrides=WITH_DROPOUT)).state_dict()
    for rank_records, rank_params, _ in ranks:
        for (metrics, grads), (want_metrics, want_grads) in zip(rank_records, records):
            _close(metrics, want_metrics)
            _leaf_close(grads, want_grads, 1e-4, 1e-3)
        _params_close(rank_params, params, p0, nu, LR, STEPS)
    for name, p in ranks[0][1].items():
        assert torch.equal(p, ranks[1][1][name]), name


@pytest.fixture(scope="module")
def jax_setup():
    overrides = {**TINY, **NO_DROPOUT}
    jconfig = JConfig(overrides=overrides)
    batch = _batch()
    feats = jto_device(batch)
    flax_model = FlaxDenoiser.from_config(jconfig)
    trans = feats["atom_positions"]
    rots = jfrenet(trans, feats["chain_index"], feats["residue_mask"])
    variables = _randomized(jax.jit(flax_model.init)(jax.random.PRNGKey(0), JRigid(rots, trans),
                                                     jax.numpy.ones(4, jax.numpy.int32), feats))
    return jconfig, Config(overrides=overrides), batch, flax_model, variables


def test_two_ranks_match_genie2_tpu(jax_setup):
    """genie2_tpu's make_train_step on the global batch against two ranks
    with its t and noise injected (the global batch's) and dropout 0: each
    step's metrics and gradients, the parameters after three steps."""
    jconfig, config, batch, flax_model, variables = jax_setup
    jstate, _, records, p0 = _run_both(jax_setup, grads=True)
    key, inject = jax.random.PRNGKey(11), []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        inject.append(_injected(sub, batch, config.diffusion["n_timestep"]))
    state_dict = _port_model(config, variables).state_dict()
    ranks = run_ranks(torch_ranks.train_steps, 2, ({**TINY, **NO_DROPOUT}, state_dict, batch, STEPS, LR, inject))
    nu, want_params = _as_torch(jstate.opt_state[0].nu), _as_torch(jstate.params)
    for rank_records, rank_params, _ in ranks:
        for (metrics, grads), (jmetrics, _, want_grads, _) in zip(rank_records, records):
            _close(metrics, {k: float(v) for k, v in jmetrics.items()})
            _leaf_close(grads, want_grads, 1e-4, 1e-3)
        _params_close(rank_params, want_params, p0, nu, LR, STEPS)


TRAINER = {**TINY, "numEpoches": 2, "batchSize": 4, "logEverySteps": 1, "checkpointEveryEpoches": 1,
           "learningRate": 1e-3}


@pytest.fixture(scope="module")
def fit_outputs(tmp_path_factory):
    """12 structures, batch 4, 2 epochs: 6 steps, on two ranks and alone
    (`torch_ranks.fit_runs`): uninterrupted, SIGTERM after step 2 (to rank
    1), killed after step 2; each resumed to the end."""
    tmp_path = tmp_path_factory.mktemp("fit")
    ranks = run_ranks(torch_ranks.fit_runs, 2, (TRAINER, str(tmp_path / "ranks"), 1, 2))
    alone = torch_ranks.fit_runs(0, TRAINER, str(tmp_path / "alone"), 0, 2, distributed=False)
    return tmp_path, ranks, alone


def test_trainer_sigterm_on_one_rank_stops_both_and_resumes_exactly(fit_outputs):
    """Rank 1 is signalled after step 2; both ranks stop there, and the run
    resumed from its resume point ends with the uninterrupted run's
    parameters and losses exactly. The uninterrupted run's losses equal one
    process's within 1e-5."""
    tmp_path, ranks, alone = fit_outputs
    for res in ranks:
        full_steps, full_losses, full_params = res["full"]
        resumed_steps, resumed_losses, resumed_params = res["resumed"]
        assert full_steps == resumed_steps == 6 and res["cut_steps"] == 2
        assert resumed_losses == full_losses and sorted(full_losses) == list(range(1, 7))
        for name, p in full_params.items():
            assert torch.equal(p, resumed_params[name]), name
        np.testing.assert_allclose([full_losses[s] for s in range(1, 7)],
                                   [alone["full"][1][s] for s in range(1, 7)], rtol=1e-5)
    assert alone["cut_steps"] == 2 and alone["resumed"][1] == alone["full"][1]
    assert sorted(os.listdir(tmp_path / "ranks" / "full")) == ["version_0"]


def test_trainer_killed_on_both_ranks_resumes_exactly(fit_outputs):
    """Killed mid-epoch after step 2 with resume points every step: the
    resumed run continues in the same version and ends with the
    uninterrupted run's losses and parameters bit for bit, on both ranks."""
    tmp_path, ranks, _ = fit_outputs
    for res in ranks:
        full_steps, full_losses, full_params = res["full"]
        steps, losses, params = res["killed_resumed"]
        assert res["killed_steps"] == 2 and steps == full_steps == 6
        assert losses == full_losses  # steps 1-2 logged before the kill, 3-6 after the resume
        for name, p in full_params.items():
            assert torch.equal(p, params[name]), name
    assert sorted(os.listdir(tmp_path / "ranks" / "killed")) == ["version_0"]


def test_train_cli_two_ranks(tmp_path):
    """cli/train.py --distributed in two ranks: one version directory, one
    set of checkpoints, losses equal to one process's within 1e-5."""
    data = tmp_path / "data"
    write_corpus(data, 10)
    runs = {}
    for label in ("ranks", "alone"):
        root = tmp_path / label
        cfg = tmp_path / f"{label}.configuration"
        cfg.write_text(CONFIG.format(root=root, data=data, epochs=2, extra=""))
        argv = ["-c", str(cfg), "--device", "cpu"]
        if label == "ranks":
            ranks = run_ranks(torch_ranks.cli_runs, 2, ([("genie2_tpu_torch.cli.train", argv + ["--distributed"])],))
            assert [sizes for _, sizes in ranks] == [[1], [1]]  # batchSize 2: a row a rank
        else:
            train_cli.main(argv)
        versions = sorted(os.listdir(root / "tcli"))
        runs[label] = root / "tcli" / "version_0"
        assert [v for v in versions if v.startswith("version_")] == ["version_0"]
    ckpts = sorted(f for f in os.listdir(runs["ranks"] / "checkpoints") if f.endswith(".ckpt"))
    assert ckpts == sorted(f for f in os.listdir(runs["alone"] / "checkpoints") if f.endswith(".ckpt"))

    def losses(workdir):
        recs = [json.loads(ln) for ln in open(workdir / "metrics.jsonl")]
        return [(r["step"], r.get("weighted_loss", r.get("val_loss"))) for r in recs]

    got, want = losses(runs["ranks"]), losses(runs["alone"])
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5)


def test_uneven_training_batch_raises(tmp_path, monkeypatch):
    """A batchSize the ranks do not divide is refused before any step, with
    genie2_tpu's wording."""
    monkeypatch.setattr(loop, "mesh_from_config",
                        lambda n_data, device, n_model, n_seq: Mesh(0, 2, torch.device("cpu")))
    config = Config(overrides={**TRAINER, "batchSize": 3, "rootDirectory": str(tmp_path)})
    with pytest.raises(ValueError, match="pick a divisible batchSize or shrink meshData"):
        loop.Trainer(config, device="cpu")
