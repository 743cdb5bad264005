"""Sequence parallelism with the other axes and in twisted SMC:

  * one training step on a (1 data x 2 seq x 2 model) grid of four gloo
    ranks, dropout and remat on, against one process: the metrics within
    tests/test_mesh3d.py's 1e-5 (absolute and relative, :163-166), every
    gradient within 1e-4 of the largest, every rank the same parameters
    (gathered over its model group);
  * a whole TDS / SMC run (tests/test_torch_parallel_sampling.py's tiny
    release and target; 6 steps, 4 of them twisted, the gradient of x_t
    through the seq ranks' collectives) on two seq ranks against one
    process: placements, resampling decisions and each step's best
    placement identical, coordinates within 2e-5.
"""

import numpy as np
import pytest
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.parallel.spawn import run_ranks
from tests import torch_ranks
from tests.test_torch_parallel_sampling import release  # noqa: F401 (fixture)
from tests.test_torch_train import LR, TINY, _batch

GRID = {**TINY, "remat": True, "numPairTransformLayers": 2}


def test_grid_step_equals_one_process():
    """A (2 seq x 2 model) grid's step against one process's."""
    state_dict = torch_ranks.seeded_model(Config(overrides=GRID)).state_dict()
    batch = _batch()
    (records, _, _), = [torch_ranks.train_steps(0, GRID, state_dict, batch, 1, LR, distributed=False)]
    ranks = run_ranks(torch_ranks.train_runs, 4, ([((GRID, state_dict, batch, 1, LR), {"n_seq": 2, "n_model": 2})],),
                      deadline=180.0)
    (want_metrics, want_grads), = records
    top = max(w.abs().max().item() for w in want_grads.values())
    for (rank_records, params, _), in ranks:
        (metrics, grads), = rank_records
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], v, atol=1e-5, rtol=1e-5, err_msg=k)
        err = max((grads[n] - w).abs().max().item() for n, w in want_grads.items())
        assert err <= 1e-4 * top, (err, top)
        assert all(torch.equal(params[n], ranks[0][0][1][n]) for n in params)


def test_tds_run_over_two_seq_ranks(release, tmp_path):  # noqa: F811 (fixture)
    """4 particles, every one on both seq ranks (the pair rows split):
    placements, decisions and best placements identical, coordinates
    within 2e-5, ESS within 1e-2."""
    work, root, state_dict = release
    args = (str(root / "tiny" / "configuration"), state_dict, str(work / "tds"))
    ranks = run_ranks(torch_ranks.tds_run, 2, (*args, str(tmp_path / "ranks"), 4, True, 2))
    alone = torch_ranks.tds_run(0, *args, str(tmp_path / "alone"), 4, distributed=False)
    for res in ranks:
        assert res["placements"] == alone["placements"]
        np.testing.assert_array_equal(res["resampled"], alone["resampled"])
        np.testing.assert_array_equal(res["best"], alone["best"])
        np.testing.assert_allclose(res["x"], alone["x"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(res["ess"], alone["ess"], atol=1e-2, rtol=0)
