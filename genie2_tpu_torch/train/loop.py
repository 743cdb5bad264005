"""Training orchestration: the epoch loop over the training step.

  * checkpoints in the reference's training layout,
    {rootdir}/{name}/version_{v}/checkpoints/epoch={E}.ckpt (and
    .ema.ckpt), as Lightning-style torch files with a `.meta.json`
    sidecar naming the quaternion method (utils/model_io.py);
  * a resume point, `resume_state`, with the weights, the Adam state, the
    EMA and the position in the data order, so a run resumes at step
    granularity; at every instant one complete resume point is on disk;
  * metrics as JSONL and stdout (utils/loggers.py);
  * all randomness a function of position: the data order is numpy's
    (seed, epoch), the step's t, noise and dropout come from
    (seed, epoch, batch index) through `np.random.SeedSequence`
    (train/state.py:step_randomness), so a run killed anywhere and resumed
    reproduces the uninterrupted run exactly.

`scanSteps` (genie2_tpu's optimizer steps a dispatch) is accepted and not
read: the loop runs single steps, whose numerics are those of genie2_tpu's
K steps whatever K is, and preemption and mid-epoch saves act at every
step.

Data, sequence and tensor parallel: in a process group (torchrun,
`cli/train.py --distributed`), the ranks form a grid of `meshData` x
`meshSeq` x `meshModel` (parallel/mesh.py; `meshData` -1 takes the world
size over the other two): every rank builds the same global batch and
trains on its data index's rows (train/state.py), the seq ranks of one
data index split the pair representation's residue rows
(parallel/sequence_parallel.py; the weights and the batch rows are theirs
alike) and the model ranks split the weights
(parallel/tensor_parallel.py). Rank 0 picks the version directory
and writes the logs, checkpoints and resume points, all of them full (every
rank gathers the shards first, so a file written under one grid loads
under any other, or in one process); the others wait for it at a barrier
before anything reads them. SIGTERM on any rank stops every rank at the
same step boundary.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import to_device
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.nn.policy import apply_denoiser
from genie2_tpu_torch.parallel.mesh import (
    any_rank,
    barrier,
    broadcast_int,
    data_axis_size,
    is_main,
    mesh_from_config,
    replicate,
    shard_batch,
)
from genie2_tpu_torch.parallel.tensor_parallel import gather_state_dict, shard_model, tp_plan
from genie2_tpu_torch.train.data import StructureDataset
from genie2_tpu_torch.train.loss import genie_loss
from genie2_tpu_torch.train.prefetch import prefetch
from genie2_tpu_torch.train.state import create_train_state, make_train_step, noised_input, step_randomness
from genie2_tpu_torch.utils.model_io import (
    AsyncSaver,
    init_model,
    load_state_dict_file,
    resolve_device,
    save_file,
    save_params,
    to_cpu,
)
from genie2_tpu_torch.utils.profiling import host_sync

# The batch index of an epoch's validation randomness (past any real batch).
VAL_BATCH = 2**30


class MetricsLogger:
    """stdout + LoggerSet (JSONL always; wandb via GENIE2_WANDB_PROJECT,
    TensorBoard via GENIE2_TENSORBOARD=1). The step cadence thins the
    train stream only; validation records land whatever their step."""

    def __init__(self, logdir: str, log_every: int = 1):
        from genie2_tpu_torch.utils.loggers import LoggerSet

        os.makedirs(logdir, exist_ok=True)
        self.log_every = log_every
        self._set = LoggerSet(logdir, wandb_project=os.environ.get("GENIE2_WANDB_PROJECT"),
                              tensorboard=os.environ.get("GENIE2_TENSORBOARD") == "1")

    def log(self, step: int, metrics: Dict, prefix: str = "train"):
        if prefix == "train" and step % self.log_every != 0:
            return
        for v in metrics.values():
            host_sync("log_metrics", v)
        floats = {k: float(v) for k, v in metrics.items()}
        self._set.log(step, floats, prefix)
        printable = " ".join(f"{k}={v:.4f}" for k, v in floats.items())
        print(f"[{prefix} step {step}] {printable}", flush=True)

    def finish(self):
        self._set.finish()


def _versions(basedir: str):
    if not os.path.isdir(basedir):
        return []
    return [int(d.split("_")[-1]) for d in os.listdir(basedir)
            if d.startswith("version_") and d.split("_")[-1].isdigit()]


def next_version(basedir: str) -> int:
    versions = _versions(basedir)
    return max(versions) + 1 if versions else 0


def latest_version(basedir: str) -> Optional[int]:
    versions = _versions(basedir)
    return max(versions) if versions else None


class Trainer:
    """Epoch loop and checkpointing over the training step, on one device
    (`device`: cuda unless the caller names the CPU), or on each rank of an
    initialised process group, data, sequence and tensor parallel
    (`meshData`, `meshSeq`, `meshModel`)."""

    def __init__(self, config: Config, model: Optional[Denoiser] = None, version: Optional[int] = None,
                 resume: bool = False, init_from: Optional[str] = None, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.mesh = mesh_from_config(config.tpu.get("mesh_data", -1), self.device, config.tpu.get("mesh_model", 1),
                                     config.tpu.get("mesh_seq", 1))
        cfg = config.training
        n_data = data_axis_size(self.mesh)
        if cfg["batch_size"] % n_data:
            raise ValueError(f"batchSize {cfg['batch_size']} not divisible by the mesh 'data' axis ({n_data}); "
                             "pick a divisible batchSize or shrink meshData")
        main = is_main(self.mesh)
        self.model = (model or init_model(config, cfg["seed"], self.device)).to(self.device)
        self.schedule = Schedule.create(config.diffusion["n_timestep"], config.diffusion["schedule"],
                                        device=self.device)

        name = config.io["name"] or "run"
        basedir = os.path.join(config.io["rootdir"], name)
        if version is None and main:
            # Resuming continues the latest version; a fresh run opens the next one.
            version = latest_version(basedir) if resume else None
            if version is None:
                version = next_version(basedir)
        # Rank 0 picks: a rank that looked itself could see rank 0's new
        # directory and open the next one.
        self.version = broadcast_int(version if main else 0, self.mesh)
        self.workdir = os.path.join(basedir, f"version_{self.version}")
        self.ckpt_dir = os.path.join(self.workdir, "checkpoints")
        self.log_every = cfg["log_every_n_step"]
        self.logger = self._saver = None
        if main:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            self.logger = MetricsLogger(self.workdir, log_every=self.log_every)
            self._saver = AsyncSaver() if cfg.get("async_checkpoint", False) else None

        if init_from:
            # Fine-tune: start from existing weights with a fresh optimizer.
            if main:
                print(f"[finetune] initializing weights from {init_from}", flush=True)
            self.model.load_state_dict(load_state_dict_file(init_from))
        replicate(self.model, self.mesh)
        shard_model(self.model, self.mesh)
        self.state = create_train_state(self.model, config.optimization["lr"], ema_decay=cfg.get("ema_decay", 0.0))
        self._step_fn = make_train_step(self.schedule, cfg["condition_loss_weight"],
                                        config.tpu.get("compute_dtype", "fp32"), cfg.get("ema_decay", 0.0),
                                        self.mesh)

    # -------------------------------------------------------------- #
    # Checkpoints
    # -------------------------------------------------------------- #

    def _save(self, path, obj):
        if self._saver is not None:
            self._saver.save(path, obj)
        else:
            save_file(path, to_cpu(obj))

    def _ckpt_wait(self):
        if self._saver is not None:
            self._saver.wait()

    def save_checkpoint(self, epoch: int) -> str:
        """epoch={E}.ckpt (and .ema.ckpt), each with its .meta.json sidecar,
        full (gathered over the model group by every rank), written by rank 0."""
        method = self.config.tpu.get("rot_to_quat_method", "closed")
        path = os.path.join(self.ckpt_dir, f"epoch={epoch}.ckpt")
        plan = tp_plan(self.model)
        params = gather_state_dict(self.model.state_dict(), plan)
        ema = gather_state_dict(self.state.ema, plan) if self.state.ema is not None else None
        if not is_main(self.mesh):
            return path
        save_params(path, params, method, self._save)
        if ema is not None:
            save_params(os.path.join(self.ckpt_dir, f"epoch={epoch}.ema.ckpt"), ema, method, self._save)
        return path

    def _promote_resume(self):
        """Move a complete resume_state.new over resume_state. save_state
        writes to the .new name and promotes the previous save first, so
        the older resume point is replaced only once a newer one is
        complete on disk."""
        base = os.path.join(self.ckpt_dir, "resume_state")
        if os.path.isfile(base + ".new"):
            os.replace(base + ".new", base)

    def save_state(self, epoch: int, step_in_epoch: int = 0) -> str:
        """resume_state, full (every rank gathers it: the model ranks hold
        its shards, the data indices the same state), written by rank 0."""
        path = os.path.join(self.ckpt_dir, "resume_state")
        state = self.state.state_dict()
        if not is_main(self.mesh):
            return path
        blob = {**state, "epoch": epoch, "step_in_epoch": step_in_epoch}
        self._ckpt_wait()
        self._promote_resume()
        self._save(path + ".new", blob)
        return path

    def restore_state(self):
        """Restore resume_state if present: (start_epoch, start_step_in_epoch),
        or None; every rank reads it once rank 0 has settled it, and keeps
        its shards of it."""
        if is_main(self.mesh):
            self._ckpt_wait()  # an async save in flight lands first
            self._promote_resume()
        barrier(self.mesh)
        path = os.path.join(self.ckpt_dir, "resume_state")
        if not os.path.isfile(path):
            return None
        blob = torch.load(path, map_location=self.device, weights_only=True)
        self.state.load_state_dict(blob)
        return int(blob["epoch"]), int(blob.get("step_in_epoch", 0))

    # -------------------------------------------------------------- #
    # Validation and the loop
    # -------------------------------------------------------------- #

    def evaluate(self, dataset, batch_size: int, epoch: int, max_batches: int = 16) -> float:
        """Mean weighted loss over up to `max_batches` validation batches,
        float32, no dropout; each batch's t and noise from
        (seed, epoch, VAL_BATCH + batch index). With a mesh each rank runs
        its rows of a global batch (a multiple of the world size) and the
        batch's loss is the global one."""
        n_data = data_axis_size(self.mesh)
        batch_size = min(batch_size, len(dataset)) // n_data * n_data
        w = self.config.training["condition_loss_weight"]
        model = self.model.eval()
        losses = []
        with torch.no_grad():
            batches = dataset.epoch(batch_size, np.random.default_rng(0), drop_last=True) if batch_size else []
            for i, batch in enumerate(batches):
                if i >= max_batches:
                    break
                feats = to_device(shard_batch(batch, self.mesh), self.device)
                rng, _ = step_randomness(self.config.training["seed"], epoch, VAL_BATCH + i, self.device)
                t, z, frames = noised_input(self.schedule, feats, rng, mesh=self.mesh)
                _, metrics = genie_loss(apply_denoiser(model, frames, t, feats), z, feats, w, self.mesh)
                host_sync("validation_loss", metrics["weighted_loss"])
                losses.append(float(metrics["weighted_loss"]))
        return float(np.mean(losses)) if losses else float("nan")

    def fit(self, dataset: StructureDataset, n_epoch: Optional[int] = None, resume: bool = False,
            val_dataset: Optional[StructureDataset] = None, save_state_every_n_step: int = 0):
        """The epoch loop. Resumes from resume_state where `resume`; traps
        SIGTERM and, at the next step boundary, saves resume_state and
        returns (restart with resume to continue); restores the previous
        SIGTERM handler on the way out. `save_state_every_n_step` > 0 adds
        mid-epoch resume points."""
        cfg = self.config.training
        n_epoch = n_epoch if n_epoch is not None else cfg["n_epoch"]
        batch_size = cfg["batch_size"]
        main = is_main(self.mesh)
        start_epoch, start_batch = 0, 0
        if resume:
            restored = self.restore_state()
            if restored is not None:
                start_epoch, start_batch = restored
                if main:
                    print(f"[resume] epoch {start_epoch}, batch {start_batch}, step {self.state.step}", flush=True)

        def place(batch):
            # On the prefetch thread: the global batch's residue count, and
            # this rank's rows copied to the device.
            return int(batch["residue_mask"].sum()), to_device(shard_batch(batch, self.mesh), self.device)

        preempt = {"signum": None}

        def _on_sigterm(signum, frame):
            # Only the flag: the loop saves at the next step boundary.
            preempt["signum"] = signum

        no_trap = object()
        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not the main thread: run without the trap
            prev_handler = no_trap

        depth = cfg.get("prefetch_depth", 2)
        residues_done = 0
        # The residues_per_s window runs between consecutive logged steps.
        win_res, win_t = 0, time.perf_counter()

        def log_window(step_i, metrics_i):
            nonlocal win_res, win_t
            now = time.perf_counter()
            metrics_i["residues_per_s"] = (residues_done - win_res) / (now - win_t)
            win_res, win_t = residues_done, now
            self.logger.log(step_i, metrics_i)

        def run_epochs():
            nonlocal residues_done
            for epoch in range(start_epoch, n_epoch):
                data_rng = np.random.default_rng([cfg["seed"], epoch])
                skip = start_batch if epoch == start_epoch else 0
                batches = prefetch(dataset.epoch(batch_size, data_rng, start_batch=skip), place, depth)
                try:
                    for b, (n_res, batch) in enumerate(batches, start=skip):
                        rng, dropout_seed = step_randomness(cfg["seed"], epoch, b, self.device)
                        metrics = self._step_fn(self.state, batch, rng=rng, dropout_seed=dropout_seed)
                        residues_done += n_res
                        if main and self.state.step % self.log_every == 0:
                            log_window(self.state.step, dict(metrics))
                        if save_state_every_n_step and (b + 1) % save_state_every_n_step == 0:
                            self.save_state(epoch, b + 1)
                        # Every rank takes the same branch: a signal to any rank stops all at this step.
                        if any_rank(preempt["signum"] is not None, self.mesh):
                            path = self.save_state(epoch, b + 1)
                            if main:
                                print(f"[preempt] signal {preempt['signum']}: saved {path} (epoch {epoch}, batch "
                                      f"{b + 1}, step {self.state.step}); exiting cleanly — restart with --resume",
                                      flush=True)
                            return
                finally:
                    if hasattr(batches, "close"):
                        batches.close()
                if val_dataset is not None:
                    val_loss = self.evaluate(val_dataset, batch_size, epoch)
                    if main:
                        self.logger.log(self.state.step, {"val_loss": val_loss}, prefix="val")
                if (epoch + 1) % cfg["checkpoint_every_n_epoch"] == 0 or epoch == n_epoch - 1:
                    path = self.save_checkpoint(epoch)
                    self.save_state(epoch + 1, 0)
                    if main:
                        print(f"[checkpoint] epoch {epoch} -> {path}", flush=True)

        try:
            run_epochs()
        finally:
            if prev_handler is not no_trap:
                signal.signal(signal.SIGTERM, prev_handler if prev_handler is not None else signal.SIG_DFL)
            # Every checkpoint reported is on disk when fit() returns or raises.
            if main:
                self._ckpt_wait()
                self._promote_resume()
        # Only where no rank raised (a rank that raises leaves the group, and
        # the others' next collective fails): the ranks return once rank 0's
        # files are on disk.
        barrier(self.mesh)
        return self.state
