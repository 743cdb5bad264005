"""genie2_tpu_torch/parallel: the mesh's resolution and its errors,
`shard_batch`, the collectives over two and three gloo ranks, the rank
runner's deadline, and dropout masks that do not depend on how a batch is
split over ranks.

Every multi-process case goes through `parallel/spawn.py:run_ranks`
(spawned ranks, a file store, its own deadline), so a rank that hangs
fails the test instead of the run.
"""

import numpy as np
import pytest
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import to_device
from genie2_tpu_torch.parallel import Mesh, create_mesh, data_axis_size, is_main, mesh_from_arg, shard_batch
from genie2_tpu_torch.parallel.mesh import local_rows, mesh_from_config, pad_to_ranks, repeat_first_rows
from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.train import synthetic_dataset
from genie2_tpu_torch.train.state import noised_input
from tests import torch_ranks

CPU = torch.device("cpu")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("num_devices,n_seq,n_model,world,error,match", [
    (None, 1, 1, None, None, None),
    (1, 1, 1, None, None, None),
    (2, 1, 1, None, ValueError, "torchrun"),
    (-1, 1, 1, None, ValueError, "torchrun"),
    (None, 1, 1, "2", ValueError, "--num_devices 2"),
    (3, 1, 1, "2", ValueError, "has 2 ranks"),
    (1, 2, 1, None, ValueError, "torchrun --nproc_per_node 2"),
    (-1, 1, 2, "2", None, None),
    (-1, 1, 2, "4", None, None),
    (-1, 2, 1, "4", None, None),
    (-1, 2, 2, "4", None, None),
    (-1, 2, 2, "6", ValueError, "not divisible by --mesh_seq 2 x --mesh_model 2"),
    (None, 1, 2, None, ValueError, "torchrun --nproc_per_node 2"),
    (-1, 1, 3, "2", ValueError, "needs at least 3 devices"),
    (-1, 1, 2, "3", ValueError, "not divisible by --mesh_seq 1 x --mesh_model 2"),
])
def test_mesh_from_arg(no_launcher, monkeypatch, num_devices, n_seq, n_model, world, error, match):
    """None or 1 is one process; a count other than 1 needs a launch of
    that many ranks (or -1 for all of them), --mesh_seq x --mesh_model a
    launch it divides, and then the ranks form a grid of data x seq x
    model, model innermost and seq next, with its groups: the model group
    of a (data, seq) index, the data group of a (seq, model) index, the seq
    group of a (data, model) index and the replica group (data x seq) of a
    model index."""
    if error is None and world is not None:
        grids = run_ranks(torch_ranks.mesh_grid, int(world), (num_devices, n_seq, n_model))
        n, inner = int(world), n_seq * n_model
        for r, grid in enumerate(grids):
            d, s, m = r // inner, (r // n_model) % n_seq, r % n_model
            assert grid == {"rank": r, "world": n, "n_model": n_model, "model_rank": m, "data_rank": d,
                            "n_data": n // inner, "n_seq": n_seq, "seq_rank": s,
                            "model_group_sum": sum(range(r - m, r - m + n_model)) if n_model > 1 else None,
                            "data_group_sum": sum(range(s * n_model + m, n, inner)),
                            "seq_group_sum": sum(range(d * inner + m, (d + 1) * inner, n_model)) if n_seq > 1 else None,
                            "replica_group_sum": sum(range(m, n, n_model))}
        return
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
    if error is None:
        assert mesh_from_arg(num_devices, n_seq, n_model, "cpu") is None
    else:
        with pytest.raises(error, match=match):
            mesh_from_arg(num_devices, n_seq, n_model, "cpu")


def test_mesh_from_config_and_create_mesh_alone(no_launcher):
    """meshData -1 or 1 trains in one process; any other count, or a mesh
    without a process group, is an error that names the launcher."""
    assert mesh_from_config(-1, "cpu") is None and mesh_from_config(1, "cpu") is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        mesh_from_config(4, "cpu")
    with pytest.raises(ValueError, match="process group"):
        create_mesh(-1, "cpu")


def test_shard_batch_rows_and_divisibility():
    """Rank r of w takes rows [r n / w, (r + 1) n / w) of every leaf; a
    batch axis w does not divide is genie2_tpu's error."""
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6), "n": 3}
    for rank, world in ((0, 3), (2, 3), (1, 2)):
        mesh = Mesh(rank, world, CPU)
        out = shard_batch(batch, mesh)
        rows = local_rows(6, mesh)
        assert np.array_equal(out["a"], batch["a"][rows]) and torch.equal(out["b"], batch["b"][rows])
        assert out["n"] == 3 and data_axis_size(mesh) == world and is_main(mesh) == (rank == 0)
    assert shard_batch(batch, None) is batch and data_axis_size(None) == 1 and is_main(None)
    with pytest.raises(ValueError, match="pick a divisible batchSize or shrink meshData"):
        shard_batch(batch, Mesh(0, 4, CPU))


def test_padding_to_the_ranks():
    """The sample axis grows to a multiple of the world size by repeats of
    row 0."""
    batch = {"x": np.arange(6).reshape(3, 2)}
    assert pad_to_ranks(3, Mesh(0, 2, CPU)) == 4 and pad_to_ranks(3, None) == 3 and pad_to_ranks(4, Mesh(1, 4, CPU)) == 4
    grown = repeat_first_rows(batch, 5)["x"]
    assert grown.shape == (5, 2) and np.array_equal(grown[3:], [[0, 1], [0, 1]])
    assert repeat_first_rows(batch, 3) is batch


@pytest.mark.parametrize("world", [2, 3])
def test_collectives(world):
    """Over `world` gloo ranks: rows gathered in rank order (integers kept
    exactly), a sum, an agreed flag, rank 0's value and weights broadcast,
    gradients averaged in buckets."""
    results = run_ranks(torch_ranks.collectives, world)
    want_rows = torch.cat([torch.full((2, 3), float(r)) + torch.arange(3.0) for r in range(world)])
    want_ids = torch.tensor([v for r in range(world) for v in (10 * r, 10 * r + 1)])
    mean = sum(range(world)) / world
    for res in results:
        assert torch.equal(res["rows"], want_rows) and torch.equal(res["ids"], want_ids)
        assert res["ids_dtype"] == "torch.int64" and res["world"] == world
        assert res["sum"] == sum(r + 1.0 for r in range(world))
        assert res["any_last"] is True and res["any_none"] is False and res["broadcast"] == 100
        assert torch.equal(res["weight"], torch.zeros(2, 3))
        torch.testing.assert_close(res["grads"][0], torch.full((5,), mean))
        torch.testing.assert_close(res["grads"][1], torch.full((2, 2), 2 * mean))


@pytest.mark.parametrize("mode,match,deadline", [("raise", "rank 1 fails on purpose", 60.0),
                                                 ("hang", "still running", 15.0)])
def test_run_ranks_ends_every_rank(mode, match, deadline):
    """A rank that raises ends the others' collectives (well before the
    deadline, which only covers a slow start); a rank that hangs is killed
    at the deadline. Either way run_ranks raises, in time."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        run_ranks(torch_ranks.hang_or_raise, 2, (mode,), deadline=deadline)
    assert time.monotonic() - t0 < deadline + 15.0


def test_dropout_masks_do_not_depend_on_the_split():
    """Dropout masks are drawn for the global batch and sliced: rows 2-3 of
    a batch of 4, run alone as rows (2, 4) of 4, give the same z as in the
    whole batch; as rows (0, 2) of 4 they give another."""
    config = Config(overrides={"singleFeatureDimension": 16, "pairFeatureDimension": 8,
                               "positionalEmbeddingDimension": 8, "chainEmbeddingDimension": 4,
                               "timestepEmbeddingDimension": 8, "templateDistanceNumBins": 5,
                               "numPairTransformLayers": 1, "triangularMultiplicativeHiddenDimension": 4,
                               "numStructureLayers": 1, "ipaHiddenDimension": 4, "ipaNumHeads": 2,
                               "ipaNumQkPoints": 2, "ipaNumVPoints": 2, "numTimesteps": 10,
                               "maximumNumResidues": 24, "remat": False})
    model = torch_ranks.seeded_model(config).train()
    batch = next(synthetic_dataset(4, max_n_res=24).epoch(4, np.random.default_rng(0)))
    feats = to_device(batch, "cpu")
    t, _, frames = noised_input(Schedule.create(10), feats, t=torch.tensor([3, 7, 1, 9]), noise=torch.zeros(4, 24, 3))

    def z(rows, sel):
        part = {k: v[sel] for k, v in feats.items()}
        sub = type(frames)(frames.rots[sel], frames.trans[sel])
        with torch.no_grad():
            return model(sub, t[sel], part, generator=torch.Generator().manual_seed(5), rows=rows)["z"]

    whole = z((0, 4, 4), slice(0, 4))
    torch.testing.assert_close(z((2, 4, 4), slice(2, 4)), whole[2:], rtol=0, atol=1e-5)
    assert not torch.allclose(z((0, 2, 4), slice(2, 4)), whole[2:], atol=1e-3)


def _adam_run(p0, grads, lr):
    p = torch.nn.Parameter(p0.clone())
    opt = torch.optim.Adam([p], lr=lr)
    for g in grads:
        p.grad = g.clone()
        opt.step()
    return p.detach().clone()


def test_smoke_parameter_rule_passes_reordered_gradients_and_catches_another_lr():
    """chip_smoke.py's parallel phase holds the parameters after three Adam
    steps from each run's gradients (`_params_against_adam`): two runs
    whose gradients differ by float32-sized noise (and, from step 2, by
    their parameters' difference) pass it, and a run with a learning rate
    1% off does not."""
    import chip_smoke

    n, lr = 200_000, 1e-4
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(n, generator=gen)
    scale = torch.logspace(-9, -1, n)
    base = [torch.randn(n, generator=gen) * scale for _ in range(3)]

    def run(seed):
        noise = torch.Generator().manual_seed(seed)
        p = torch.nn.Parameter(p0.clone())
        opt, grads = torch.optim.Adam([p], lr=lr), []
        for b in base:
            g = b + 10 * (p.detach() - p0) + 1e-7 * torch.randn(n, generator=noise) * torch.rand(n, generator=noise)
            g[:100] = 0
            p.grad = g.clone()
            grads.append(g)
            opt.step()
        return p.detach().clone(), grads

    want, want_grads = run(1)
    got, got_grads = run(2)
    ok = chip_smoke._params_against_adam(got, want, got_grads, want_grads, lr)
    assert ok["held_share"] > 0.2 and ok["held_max_err_over_tol"] <= 1
    assert ok["max_err"] <= ok["bound"] and ok["still_share"] > 0 and ok["still_max_err"] == 0
    off = chip_smoke._params_against_adam(_adam_run(p0, got_grads, 1.01 * lr), want, got_grads, want_grads, lr)
    assert off["held_max_err_over_tol"] > 1
