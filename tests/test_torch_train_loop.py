"""genie2_tpu_torch's trainer and training CLI on the CPU, at the tiny size
of tests/test_train.py: the loss falls, kill-and-resume and SIGTERM-and-
resume reproduce the uninterrupted run exactly, an async save equals a
synchronous one and never leaves the run without a resume point, scanSteps
K equals K single steps, validation records bypass the log cadence, and
cli/train.py runs end to end on a directory of PDB files."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from genie2_tpu_torch.config import Config
from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import create_empty_features, save_features_to_pdb, to_device
from genie2_tpu_torch.train import create_train_state, make_train_step, synthetic_dataset
from genie2_tpu_torch.train.loop import MetricsLogger, Trainer
from genie2_tpu_torch.utils.model_io import init_model, load_model

TINY = {
    "singleFeatureDimension": 16, "pairFeatureDimension": 8, "positionalEmbeddingDimension": 8,
    "chainEmbeddingDimension": 4, "timestepEmbeddingDimension": 8, "templateDistanceNumBins": 5,
    "numPairTransformLayers": 1, "triangularMultiplicativeHiddenDimension": 4, "numStructureLayers": 1,
    "ipaHiddenDimension": 4, "ipaNumHeads": 2, "ipaNumQkPoints": 2, "ipaNumVPoints": 2, "numTimesteps": 10,
    "maximumNumResidues": 24,
}


def make_config(rootdir, **overrides):
    """The tiny configuration with dropout and remat at their defaults,
    2 epochs of batch 4, logging every step."""
    return Config(overrides={**TINY, "name": "run", "rootDirectory": str(rootdir), "numEpoches": 2,
                             "batchSize": 4, "logEverySteps": 1, "checkpointEveryEpoches": 10,
                             "learningRate": 1e-3, **overrides})


def dataset():
    return synthetic_dataset(8, max_n_res=24)  # 2 batches an epoch -> 4 steps


def losses_of(workdir):
    out = {}
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("prefix", "train") == "train":
                out[rec["step"]] = rec["weighted_loss"]
    return out


def same_params(a, b):
    for (na, x), (nb, y) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(x, y), na


def test_loss_decreases_on_one_batch():
    """Eight steps on one small batch, lr 1e-3: the last three losses' mean
    below the first three's."""
    config = Config(overrides={**TINY, "remat": False})
    batch = next(dataset().epoch(4, np.random.default_rng(0)))
    state = create_train_state(init_model(config, 0, "cpu"), 1e-3)
    step = make_train_step(Schedule.create(10), 1.0)
    feats = to_device(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(state, feats, rng=gen, dropout_seed=i)["weighted_loss"]) for i in range(8)]
    assert np.isfinite(losses).all() and state.step == 8
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    trainer = Trainer(make_config(tmp_path_factory.mktemp("a")), device="cpu")
    trainer.fit(dataset())
    return trainer


def test_kill_and_resume_reproduces_uninterrupted_run(tmp_path, uninterrupted):
    """Killed after 3 steps (resume points every step), resumed into the
    same version: the same losses at every step and the same parameters,
    bit for bit."""
    config = make_config(tmp_path)
    t_b = Trainer(config, device="cpu")
    real_step, calls = t_b._step_fn, {"n": 0}

    def killing_step(*args, **kwargs):
        if calls["n"] == 3:
            raise KeyboardInterrupt
        calls["n"] += 1
        return real_step(*args, **kwargs)

    t_b._step_fn = killing_step
    with pytest.raises(KeyboardInterrupt):
        t_b.fit(dataset(), save_state_every_n_step=1)
    assert t_b.state.step == 3
    t_c = Trainer(config, device="cpu", resume=True)
    assert t_c.version == t_b.version
    assert t_c.fit(dataset(), resume=True).step == 4
    losses = {**losses_of(t_b.workdir), **losses_of(t_c.workdir)}
    assert losses == losses_of(uninterrupted.workdir)
    same_params(t_c.model, uninterrupted.model)


def test_sigterm_saves_and_resumes(tmp_path, uninterrupted):
    """SIGTERM after the third step: fit() saves resume_state at the step
    boundary and returns, the previous handler is back, and --resume
    finishes with the uninterrupted run's parameters."""
    prev = signal.getsignal(signal.SIGTERM)
    config = make_config(tmp_path)
    t_b = Trainer(config, device="cpu")
    real_step, calls = t_b._step_fn, {"n": 0}

    def step_then_preempt(*args, **kwargs):
        out = real_step(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    t_b._step_fn = step_then_preempt
    assert t_b.fit(dataset()).step == 3
    assert os.path.isfile(os.path.join(t_b.ckpt_dir, "resume_state"))
    assert signal.getsignal(signal.SIGTERM) == prev
    t_c = Trainer(config, device="cpu", resume=True)
    assert t_c.fit(dataset(), resume=True).step == 4
    same_params(t_c.model, uninterrupted.model)


def test_async_checkpoint_identical_and_never_a_gap(tmp_path, uninterrupted):
    """asyncCheckpoint: the same parameters and epoch checkpoints as the
    synchronous run; resume_state.new is promoted only over an older
    complete resume point, and a restore picks the newest."""
    config = make_config(tmp_path / "async", asyncCheckpoint=True, checkpointEveryEpoches=1)
    t_a = Trainer(config, device="cpu")
    assert t_a._saver is not None
    t_a.fit(dataset())
    same_params(t_a.model, uninterrupted.model)
    t_s = Trainer(make_config(tmp_path / "sync", checkpointEveryEpoches=1), device="cpu")
    t_s.fit(dataset())
    for epoch in (0, 1):
        a = torch.load(os.path.join(t_a.ckpt_dir, f"epoch={epoch}.ckpt"), weights_only=True)["state_dict"]
        s = torch.load(os.path.join(t_s.ckpt_dir, f"epoch={epoch}.ckpt"), weights_only=True)["state_dict"]
        assert a.keys() == s.keys() and all(torch.equal(a[k], s[k]) for k in a)

    base = os.path.join(t_a.ckpt_dir, "resume_state")
    t_a.save_state(0, 1)
    assert os.path.isfile(base)  # the older point stays while the newer one is written
    t_a._ckpt_wait()
    assert os.path.isfile(base) and os.path.isfile(base + ".new")
    t_a.save_state(0, 2)
    t_a._ckpt_wait()
    assert os.path.isfile(base) and os.path.isfile(base + ".new")
    t_r = Trainer(config, device="cpu", resume=True)
    assert t_r.restore_state() == (0, 2)
    assert os.path.isfile(base) and not os.path.isfile(base + ".new")


def test_init_from_fine_tunes_with_a_fresh_optimizer(tmp_path, uninterrupted):
    """init_from: the weights of a checkpoint file, a new version, step 0
    and no Adam state; then training moves them."""
    uninterrupted.save_checkpoint(1)
    path = os.path.join(uninterrupted.ckpt_dir, "epoch=1.ckpt")
    trainer = Trainer(make_config(tmp_path), init_from=path, device="cpu")
    same_params(trainer.model, uninterrupted.model)
    assert trainer.state.step == 0 and not trainer.state.optimizer.state
    trainer.fit(dataset(), n_epoch=1)
    assert trainer.state.step == 2
    assert any(not torch.equal(p, q) for p, q in zip(trainer.model.parameters(), uninterrupted.model.parameters()))


def test_scanSteps_key_trains_single_steps(tmp_path):
    """scanSteps 4 (genie2_tpu's steps a dispatch; the port reads no such
    key and runs single steps) on 9 structures of batch 1 over two epochs
    with the EMA on: the same losses and parameters as scanSteps 1."""
    runs = {}
    for k in (1, 4):
        config = make_config(tmp_path / f"s{k}", batchSize=1, logEverySteps=3, emaDecay=0.999, scanSteps=k)
        trainer = Trainer(config, device="cpu")
        trainer.fit(synthetic_dataset(9, max_n_res=24))
        assert trainer.state.step == 18
        runs[k] = trainer
    assert losses_of(runs[1].workdir) == losses_of(runs[4].workdir)
    assert set(losses_of(runs[1].workdir)) == {3, 6, 9, 12, 15, 18}
    same_params(runs[1].model, runs[4].model)
    assert all(torch.equal(runs[1].state.ema[n], runs[4].state.ema[n]) for n in runs[1].state.ema)


def test_val_records_bypass_log_cadence(tmp_path):
    lg = MetricsLogger(str(tmp_path), log_every=50)
    lg.log(7, {"weighted_loss": torch.tensor(1.0)})  # off the cadence: thinned
    lg.log(7, {"val_loss": 2.0}, prefix="val")  # lands regardless
    lg.log(50, {"weighted_loss": torch.tensor(0.5)})
    lg.finish()
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["prefix"] for r in recs] == ["val", "train"] and recs[0]["val_loss"] == 2.0


CONFIG = """name tcli
rootDirectory {root}
dataDirectory {data}
minimumNumResidues 10
maximumNumResidues 24
numTimesteps 8
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
seed 100
numEpoches {epochs}
batchSize 2
logEverySteps 1
checkpointEveryEpoches 1
validationSplit 0.25
emaDecay 0.99
{extra}
"""


def write_corpus(path, n=10):
    rng = np.random.default_rng(0)
    os.makedirs(path)
    for i in range(n):
        length = int(rng.integers(12, 24))
        f = create_empty_features([length])
        steps = rng.normal(size=(length, 3))
        f["atom_positions"] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True), axis=0)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
        save_features_to_pdb(f, os.path.join(path, f"walk_{i}.pdb"))
    return path


def test_cli_end_to_end(tmp_path, capsys):
    """cli/train.py on 10 PDB files (8 train, 2 validation), remat and
    dropout on: finite losses, a validation record an epoch, epoch=0/1
    checkpoints and their EMA that load_model reads back, the
    configuration copied beside the run; then --resume with 3 epochs
    continues from step 8 to 12; without --device cpu and no card it
    raises, and so do the parallelism settings."""
    from genie2_tpu_torch.cli import train

    data = write_corpus(str(tmp_path / "data"))
    root = tmp_path / "runs"
    cfg = tmp_path / "configuration"
    cfg.write_text(CONFIG.format(root=root, data=data, epochs=2, extra=""))
    trainer = train.main(["-c", str(cfg), "--device", "cpu"])
    assert trainer.state.step == 8
    out = capsys.readouterr().out
    assert "[val step 4]" in out and "[val step 8]" in out and "[checkpoint] epoch 1" in out
    assert (root / "tcli" / "configuration").read_text() == cfg.read_text()
    assert (root / "tcli" / "train.txt").exists() and (root / "tcli" / "parsed_cache" / "meta.json").exists()
    losses = losses_of(trainer.workdir)
    assert len(losses) == 8 and np.isfinite(list(losses.values())).all()
    for epoch in (0, 1):
        model, config = load_model(str(root), "tcli", epoch=epoch, device="cpu")
        assert config.tpu["rot_to_quat_method"] == "closed" and not model.training
        ckpt = torch.load(os.path.join(trainer.ckpt_dir, f"epoch={epoch}.ema.ckpt"), weights_only=True)
        assert set(ckpt["state_dict"]) == {f"model.{k}" for k in model.state_dict()}
    model, _ = load_model(str(root), "tcli", device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(model.state_dict().values(), trainer.model.state_dict().values()))

    cfg.write_text(CONFIG.format(root=root, data=data, epochs=3, extra=""))
    resumed = train.main(["-c", str(cfg), "--device", "cpu", "--resume"])
    assert resumed.version == trainer.version and resumed.state.step == 12
    assert "[resume] epoch 2, batch 0, step 8" in capsys.readouterr().out

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["-c", str(cfg)])
    for extra in ("meshSeq 2", "meshModel 2", "meshData 4"):
        cfg.write_text(CONFIG.format(root=root, data=data, epochs=3, extra=extra))
        with pytest.raises(ValueError, match="torchrun"):
            train.main(["-c", str(cfg), "--device", "cpu"])
    with pytest.raises(ValueError, match="torchrun"):
        train.main(["-c", str(cfg), "--device", "cpu", "--distributed"])
