"""Rank bodies of the parallel tests (tests/test_torch_parallel*.py,
tests/test_torch_tp.py, tests/test_torch_seq*.py).

`genie2_tpu_torch.parallel.spawn.run_ranks` runs each of them in spawned
processes joined into one gloo group; the tests call the same functions
with `distributed=False` for the one-process reference. This module imports
torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

import importlib
import os
import signal

import numpy as np
import torch

from genie2_tpu_torch.utils import profiling


def _volume(axis: str) -> dict:
    """The bytes all-reduced over the `axis` ("tp" or "seq") group since
    the last `profiling.reset()`, by direction."""
    snap = profiling.counters()
    return {d: snap[f"allreduce_bytes.{axis}.{d}"] for d in ("forward", "backward")}


def _mesh(distributed: bool, device="cpu", n_model: int = 1, n_seq: int = 1):
    from genie2_tpu_torch.parallel import create_mesh

    return create_mesh(-1, device, n_model, n_seq) if distributed else None


def seeded_model(config, seed: int = 3):
    """A tiny Denoiser with seeded weights, its zero-initialised leaves
    given random values (every parameter then has a gradient)."""
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return randomize_zero_init(Denoiser.from_config(config), seed)


def collectives(rank: int):
    """Every collective of parallel/mesh.py on this rank's values."""
    import torch.distributed as dist

    from genie2_tpu_torch.parallel import (
        all_reduce_sum,
        any_rank,
        barrier,
        broadcast_int,
        gather_rows,
        replicate,
    )
    from genie2_tpu_torch.parallel.mesh import average_gradients

    mesh = _mesh(True)
    world = mesh.world_size
    rows, ids = gather_rows(mesh, torch.full((2, 3), float(rank)) + torch.arange(3.0),
                            torch.tensor([10 * rank, 10 * rank + 1]))
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(rank)
    replicate(module, mesh)
    grads = [torch.full((5,), float(rank)), torch.full((2, 2), 2.0 * rank)]
    average_gradients(grads, mesh)
    barrier(mesh)
    return {
        "rows": rows, "ids": ids, "ids_dtype": str(ids.dtype),
        "sum": all_reduce_sum(torch.tensor([rank + 1.0]), mesh).item(),
        "any_last": any_rank(rank == world - 1, mesh), "any_none": any_rank(False, mesh),
        "broadcast": broadcast_int(100 + rank, mesh), "weight": module.weight.detach().clone(),
        "grads": grads, "world": dist.get_world_size(),
    }


def mesh_grid(rank: int, num_devices, n_seq: int, n_model: int):
    """This rank's place in the grid of `mesh_from_arg`, and the sums of
    the ranks in its model and data groups."""
    import torch.distributed as dist

    from genie2_tpu_torch.parallel import mesh_from_arg

    mesh = mesh_from_arg(num_devices, n_seq, n_model, "cpu")
    sums = {}
    for name, group in (("model_group_sum", mesh.model_group), ("data_group_sum", mesh.data_group),
                        ("seq_group_sum", mesh.seq_group), ("replica_group_sum", mesh.replica_group)):
        if group is None and name in ("model_group_sum", "seq_group_sum"):  # no such axis, no group
            sums[name] = None
            continue
        x = torch.tensor([float(rank)])
        dist.all_reduce(x, group=group)
        sums[name] = int(x.item())
    return {"rank": mesh.rank, "world": mesh.world_size, "n_model": mesh.n_model, "model_rank": mesh.model_rank,
            "data_rank": mesh.data_rank, "n_data": mesh.n_data, "n_seq": mesh.n_seq, "seq_rank": mesh.seq_rank,
            **sums}


def hang_or_raise(rank: int, mode: str):
    """Rank 1 raises or sleeps; the others wait in a collective for it."""
    import time

    from genie2_tpu_torch.parallel import barrier

    if rank == 1:
        if mode == "raise":
            raise RuntimeError("rank 1 fails on purpose")
        time.sleep(600)
    barrier(_mesh(True))
    return rank


def train_steps(rank: int, config_overrides, state_dict, batch, steps: int, lr: float, inject=None,
                distributed: bool = True, device: str = "cpu", n_model: int = 1, n_seq: int = 1):
    """`steps` training steps on `device`, on this rank's rows of `batch`
    (the whole of it without `distributed`), the model split over
    `n_model` model ranks: t and the noise injected (`inject`, the global
    batch's, one pair a step, dropout seed the step's index) or drawn from
    `step_randomness(0, 0, step)`. Returns per-step (metrics, gradients),
    the parameters and Adam's second moments after the last, on the CPU,
    each full (gathered over the model ranks); the pair rows split over
    `n_seq` seq ranks."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.parallel import shard_batch
    from genie2_tpu_torch.parallel.tensor_parallel import gather_state_dict, shard_model, tp_plan
    from genie2_tpu_torch.train import create_train_state, make_train_step, step_randomness

    mesh = _mesh(distributed, device, n_model, n_seq)
    config = Config(overrides=config_overrides)
    model = Denoiser.from_config(config)
    model.load_state_dict(state_dict)
    shard_model(model.to(device), mesh)
    plan = tp_plan(model)
    state = create_train_state(model, lr)
    step = make_train_step(Schedule.create(config.diffusion["n_timestep"], device=device), 1.0, mesh=mesh)
    feats = to_device(shard_batch(batch, mesh), device)
    records = []
    for i in range(steps):
        if inject is not None:
            t, noise = inject[i]
            metrics = step(state, feats, t=t, noise=noise, dropout_seed=i)
        else:
            rng, dropout_seed = step_randomness(0, 0, i, device)
            metrics = step(state, feats, rng=rng, dropout_seed=dropout_seed)
        grads = gather_state_dict({n: p.grad for n, p in model.named_parameters()}, plan)
        records.append(({k: float(v) for k, v in metrics.items()}, {n: g.cpu() for n, g in grads.items()}))
    params = gather_state_dict({n: p.detach() for n, p in model.named_parameters()}, plan)
    nu = gather_state_dict({n: state.optimizer.state[p]["exp_avg_sq"] for n, p in model.named_parameters()}, plan)
    return records, {n: p.cpu() for n, p in params.items()}, {n: v.cpu() for n, v in nu.items()}


def _signal_after(trainer, step: int):
    """Wrap the trainer's step so that this process signals itself
    SIGTERM after its `step`-th step."""
    inner = trainer._step_fn

    def step_fn(state, *args, **kwargs):
        out = inner(state, *args, **kwargs)
        if state.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer._step_fn = step_fn


def _kill_at(trainer, step: int):
    """Wrap the trainer's step so that its `step`-th call raises
    KeyboardInterrupt before it runs: the process dies mid-epoch."""
    inner, calls = trainer._step_fn, {"n": 0}

    def step_fn(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == step:
            raise KeyboardInterrupt
        return inner(*args, **kwargs)

    trainer._step_fn = step_fn


def fit_runs(rank: int, overrides, workdir: str, sigterm_rank: int, sigterm_step: int, distributed: bool = True):
    """The Trainer (configuration `overrides`, rootDirectory `workdir`) on a
    synthetic corpus: an uninterrupted run, then a run that rank
    `sigterm_rank` signals after step `sigterm_step`, resumed to the end,
    and a run killed on every rank after step `sigterm_step`, resumed to
    the end. Returns the steps each run reached, the complete runs' train
    losses by step and their final parameters."""
    import json

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.train import synthetic_dataset
    from genie2_tpu_torch.train.loop import Trainer

    def fit(name, resume=False, signal_step=None, kill_step=None):
        trainer = Trainer(Config(overrides={**overrides, "name": name, "rootDirectory": workdir}), device="cpu",
                          resume=resume)
        if signal_step is not None and (not distributed or rank == sigterm_rank):
            _signal_after(trainer, signal_step)
        dataset = synthetic_dataset(12, max_n_res=24, rng=np.random.default_rng(1))
        if kill_step is not None:
            # Every rank dies at the same step (resume points every step).
            _kill_at(trainer, kill_step)
            try:
                trainer.fit(dataset, save_state_every_n_step=1)
            except KeyboardInterrupt:
                return trainer.state.step, None, None
            raise AssertionError("the run was not killed")
        state = trainer.fit(dataset, resume=resume)
        with open(os.path.join(trainer.workdir, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        losses = {r["step"]: r["weighted_loss"] for r in records if r.get("prefix") == "train"}
        return state.step, losses, {n: p.detach().clone() for n, p in state.model.named_parameters()}

    full = fit("full")
    cut = fit("cut", signal_step=sigterm_step)
    resumed = fit("cut", resume=True)
    killed = fit("killed", kill_step=sigterm_step + 1)
    killed_resumed = fit("killed", resume=True)
    return {"full": full, "cut_steps": cut[0], "resumed": resumed, "killed_steps": killed[0],
            "killed_resumed": killed_resumed}


def _seed_placements(seed: int):
    """Make ScaffoldSampler draw its placements from `seed` (in this
    process); returns the function that undoes it."""
    from genie2_tpu_torch.sampling import scaffold

    init = scaffold.ScaffoldSampler.__init__

    def seeded(self, *args, **kwargs):
        kwargs["placement_seed"] = seed
        init(self, *args, **kwargs)

    scaffold.ScaffoldSampler.__init__ = seeded
    return lambda: setattr(scaffold.ScaffoldSampler, "__init__", init)


def cli_runs(rank: int, runs, patch_placement_seed=None):
    """Each (module name, argv) of `runs` through its `main`; with
    `patch_placement_seed`, ScaffoldSampler draws its placements from that
    seed. Returns the CLIs' results (cli/train.py's: the step it reached)
    and the batch sizes the denoiser was called with."""
    from genie2_tpu_torch.nn import Denoiser

    if patch_placement_seed is not None:
        _seed_placements(patch_placement_seed)
    sizes = set()
    forward = Denoiser.forward

    def counted(self, ts, timesteps, *args, **kwargs):
        sizes.add(int(timesteps.shape[0]))
        return forward(self, ts, timesteps, *args, **kwargs)

    Denoiser.forward = counted
    try:
        results = [importlib.import_module(name).main(list(argv)) for name, argv in runs]
    finally:
        Denoiser.forward = forward
    return [r.state.step if hasattr(r, "state") else r for r in results], sorted(sizes)


def _model(config_path: str, state_dict):
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.nn import Denoiser

    config = Config(config_path)
    model = Denoiser.from_config(config)
    model.load_state_dict(state_dict)
    return model.eval(), config


def tds_run(rank: int, config_path: str, state_dict, motif_dir: str, outdir: str, n_particles: int,
            distributed: bool = True, n_seq: int = 1):
    """SMCSampler on the motif problem of `motif_dir` with `n_particles`
    over the ranks' data axis (each rank's pair rows over `n_seq` seq
    ranks). Returns coordinates, placements and the trace."""
    from genie2_tpu_torch.parallel.tensor_parallel import shard_model
    from genie2_tpu_torch.sampling import SMCSampler

    mesh = _mesh(distributed, "cpu", 1, n_seq)
    model, config = _model(config_path, state_dict)
    sampler = SMCSampler(shard_model(model, mesh), config, mesh=mesh)
    sampler.untwist_below = 2
    out = sampler.sample({"scale": 1.0, "outdir": outdir, "num_samples": n_particles, "prefix": "24", "offset": 0,
                          "motif_index": 0, "motif_dir": motif_dir, "seed": 3})
    return {"x": np.stack([f["atom_positions"] for f in out]), "placements": sampler.final_placements,
            "ess": np.asarray(sampler.trace.ess), "resampled": np.asarray(sampler.trace.resampled),
            "best": np.asarray(sampler.trace.best_placement), "dist": np.asarray(sampler.trace.motif_dist)}


def sse_run(rank: int, config_path: str, state_dict, n_particles: int, length: int, strength: float,
            distributed: bool = True):
    """sse_guided_sample with `n_particles` over the ranks; returns the
    final coordinates and the filter's traces."""
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.nn.policy import apply_denoiser
    from genie2_tpu_torch.parallel import shard_batch
    from genie2_tpu_torch.sampling import sse_guided_sample

    mesh = _mesh(distributed)
    model, config = _model(config_path, state_dict)
    schedule = Schedule.create(config.diffusion["n_timestep"], config.diffusion["schedule"])
    batch = batchify([create_empty_features([length]) for _ in range(n_particles)])
    feats = to_device(shard_batch(batch, mesh), "cpu")
    with torch.inference_mode():
        def model_fn(frames, t):
            return apply_denoiser(model, frames, t, feats)

        trans, result = sse_guided_sample(model_fn, schedule, feats, 5, n_particles, target="helix",
                                          strength=strength, mesh=mesh)
    return {"x": trans.numpy(), "ess": result.ess_trace.numpy(), "resampled": result.resampled_trace.numpy(),
            "log_w": result.log_weights.numpy()}


def train_runs(rank: int, runs):
    """`train_steps` of each (args, kwargs) of `runs` in turn."""
    return [train_steps(rank, *args, **kwargs) for args, kwargs in runs]


def tp_forward(rank: int, cases, n_model: int, distributed: bool = True):
    """Each case (configuration overrides, state_dict, (translations, t,
    host batch), compute dtype name) through a denoiser split over
    `n_model` model ranks (every rank a model rank of one data index where
    the world is `n_model`), in bf16 through its cast copy (nn/policy.py):
    z, the names of the split parameters, the state dict gathered back from
    the shards, the bytes all-reduced over the model group in the forward
    and whether the cast copy holds the same shards in its dtype while the
    model keeps its own."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.nn.policy import apply_denoiser, cast_model, compute_dtype
    from genie2_tpu_torch.parallel import local_rows, shard_batch
    from genie2_tpu_torch.parallel import tensor_parallel as tp

    mesh = _mesh(distributed, "cpu", n_model)
    out = []
    for overrides, state_dict, (trans, t, batch), dtype_name in cases:
        model = Denoiser.from_config(Config(overrides=overrides))
        model.load_state_dict(state_dict)
        tp.shard_model(model, mesh)
        plan = tp.tp_plan(model)
        dtype = compute_dtype(dtype_name)
        run = cast_model(model, dtype)
        feats = to_device(shard_batch(batch, mesh), "cpu")
        rows = local_rows(len(trans), mesh)
        x = torch.as_tensor(trans)[rows]
        profiling.reset()
        with torch.no_grad():
            z = apply_denoiser(run, Rigid(frenet_frames(x, feats["chain_index"], feats["residue_mask"]), x),
                               torch.as_tensor(t)[rows], feats, dtype=dtype)
        copy_keeps = all(q.dtype == dtype and q.shape == p.shape for p, q in zip(model.parameters(), run.parameters()))
        out.append({"z": z, "split": sorted(plan.params) if plan else [], "volume": _volume("tp"),
                    "gathered": tp.gather_state_dict(model.state_dict(), plan),
                    "copy_keeps_shards": copy_keeps and tp.tp_plan(run) == plan
                    and all(p.dtype == torch.float32 for p in model.parameters())})
    return out


def tp_fit(rank: int, overrides, workdir: str, n_model: int, distributed: bool = True):
    """The Trainer (`overrides`, meshModel `n_model`) on a synthetic corpus:
    2 epochs, then a run to 3 epochs resumed from the first run's
    resume_state. Returns each run's steps, train losses by step and full
    parameters (gathered)."""
    import json

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel.tensor_parallel import gather_state_dict, tp_plan
    from genie2_tpu_torch.train import synthetic_dataset
    from genie2_tpu_torch.train.loop import Trainer

    runs = {}
    for label, epochs, resume in (("two", 2, False), ("three", 3, True)):
        config = Config(overrides={**overrides, "rootDirectory": workdir, "numEpoches": epochs,
                                   "meshModel": n_model if distributed else 1})
        trainer = Trainer(config, device="cpu", resume=resume)
        dataset = synthetic_dataset(8, max_n_res=24, rng=np.random.default_rng(1))
        state = trainer.fit(dataset, resume=resume)
        with open(os.path.join(trainer.workdir, "metrics.jsonl")) as fh:
            records = [json.loads(line) for line in fh]
        model = state.model
        params = gather_state_dict({n: p.detach() for n, p in model.named_parameters()}, tp_plan(model))
        runs[label] = {"step": state.step, "version": trainer.version, "workdir": trainer.workdir,
                       "losses": {r["step"]: r["weighted_loss"] for r in records if r.get("prefix") == "train"},
                       "params": {n: p.clone() for n, p in params.items()},
                       "local": {n: p.detach().clone() for n, p in model.named_parameters()}}
    return runs


def tp_cli_runs(rank: int, runs, placement_seed: int = 7):
    """Each (module name, argv) of `runs` through its `main`, the scaffold
    placements drawn from `placement_seed`; returns the coordinates each
    run sampled (every sample of every sampler batch, or the SSE
    particles), flattened, as this rank holds them."""
    from genie2_tpu_torch import sampling
    from genie2_tpu_torch.sampling import base

    unseed = _seed_placements(placement_seed)
    coords = []
    sample, sse = base.BaseSampler.sample, sampling.sse_guided_sample

    def capture(self, params):
        result = sample(self, params)
        coords[-1].extend(f["atom_positions"].reshape(-1) for f in result)
        return result

    def capture_sse(*args, **kwargs):
        trans, result = sse(*args, **kwargs)
        coords[-1].append(trans.numpy().reshape(-1).copy())
        return trans, result

    base.BaseSampler.sample, sampling.sse_guided_sample = capture, capture_sse
    try:
        for name, argv in runs:
            coords.append([])
            importlib.import_module(name).main(list(argv))
    finally:
        base.BaseSampler.sample, sampling.sse_guided_sample = sample, sse
        unseed()
    return [np.concatenate(c) for c in coords]


def seq_forward(rank: int, cases, n_seq: int, n_model: int = 1, distributed: bool = True):
    """Each case (configuration overrides, state_dict, (translations, t,
    host batch)) through a denoiser whose pair rows are split over `n_seq`
    seq ranks (and its weights over `n_model` model ranks): z, this rank's
    rows of p, the rows' slice, the bytes all-reduced over the seq group,
    and z again with the samplers' static bias (Denoiser.static_bias)."""
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames
    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.parallel import sequence_parallel as sp
    from genie2_tpu_torch.parallel import tensor_parallel as tp

    mesh = _mesh(distributed, "cpu", n_model, n_seq)
    out = []
    for overrides, state_dict, (trans, t, batch) in cases:
        model = Denoiser.from_config(Config(overrides=overrides))
        model.load_state_dict(state_dict)
        tp.shard_model(model, mesh)
        feats = to_device(batch, "cpu")
        x = torch.as_tensor(trans)
        frames = Rigid(frenet_frames(x, feats["chain_index"], feats["residue_mask"]), x)
        profiling.reset()
        with torch.no_grad():
            res = model(frames, torch.as_tensor(t), feats)
            volume = _volume("seq")
            z_static = model(frames, torch.as_tensor(t), feats, static_pair_bias=model.static_bias(feats))["z"]
        rows = sp.row_slice(res["p"].shape[2], model.seq) if model.seq else slice(0, res["p"].shape[1])
        out.append({"z": res["z"], "p": res["p"], "rows": (rows.start, rows.stop), "volume": volume,
                    "z_static": z_static, "s": res["s"]})
    return out


def seq_collectives(rank: int, distributed: bool = True):
    """gather_seq_rows, reduce_seq_rows and mean_grad_over_seq under
    autograd: with a seq group of two ranks (each holding three of six rows
    of x), or in one process (every row, and the identity for each
    collective). Returns the gathered and reduced tensors and the
    gradients of three losses."""
    from genie2_tpu_torch.parallel import sequence_parallel as sp

    mesh = _mesh(distributed, "cpu", 1, 2) if distributed else None
    seq = sp.SeqGroup(mesh.seq_rank, mesh.n_seq, mesh.seq_group) if mesh else None
    full = torch.arange(24, dtype=torch.float32).reshape(2, 6, 2) / 7.0
    rows = slice(3 * rank, 3 * rank + 3) if seq else slice(None)
    profiling.reset()
    x = full[:, rows].clone().requires_grad_(True)
    gathered = sp.gather_seq_rows(seq, 1, x)[0] if seq else x
    (gathered.sin() * full).sum().backward()  # every rank the same loss of the whole tensor
    partial = (full * (rank + 1.0) if seq else full * 3.0).clone().requires_grad_(True)
    reduced = sp.reduce_seq_rows(partial, seq, 1) if seq else partial
    (reduced.cos() * 2.0).sum().backward()  # each rank its rows' loss
    y = full.clone().requires_grad_(True)
    (ym,) = sp.mean_grad_over_seq(seq, y) if seq else (y,)
    part = ym[:, rows]
    (part.square().sum() * (2.0 if seq else 1.0)).backward()  # each rank its rows, counted n_seq times
    return {"gathered": gathered.detach(), "reduced": reduced.detach(), "grad_gather": x.grad,
            "grad_reduce": partial.grad, "grad_mean": y.grad, "volume": _volume("seq")}
