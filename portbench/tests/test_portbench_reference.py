"""The frozen reference (portbench/reference/) against the program's plain
CPU path at a tiny width: the denoiser's z, one training step's loss and
gradients, and the inputs it derives again (noise streams, motif
placements, the training corpus and its epochs)."""

import numpy as np
import pytest
import torch

from conftest import TINY_TRAFFIC, tiny_config
from portbench.harness import port
from portbench.harness.weights import make_weights
from portbench.reference import genie2 as ref
from portbench.reference import inputs as ref_inputs

SEED = 2**31 + 99


def weights(config, seed=SEED):
    return make_weights(ref.parameter_spec(config["configuration"]), seed, torch.device("cpu"))


def motif_batch(n_pad=24):
    """Two structures of 20 and 17 residues, padded to n_pad, with motif masks."""
    rng = np.random.default_rng(3)
    items = []
    for n in (20, 17):
        f = ref_inputs.empty_features(n)
        f["atom_positions"] = np.cumsum(rng.normal(size=(n, 3)) * 2 + [3.8, 0, 0], 0)
        seq = rng.random(n) < 0.3
        f["fixed_sequence_mask"], f["fixed_structure_mask"] = seq, seq[:, None] & seq[None, :]
        f["aatype"] = np.eye(20)[rng.integers(0, 20, n)]
        items.append(f)
    return ref_inputs.stack(items, n_pad, "cpu")


def port_features(f):
    out = {k: v.to(torch.bool if v.dtype == torch.bool else torch.float32 if k == "atom_positions" else torch.int32)
           for k, v in f.items()}
    out["num_residues"] = f["residue_mask"].sum(-1).int()
    return out


@pytest.mark.parametrize("tri_att", [False, True])
def test_denoiser_matches_port(tri_att):
    from genie2_tpu_torch.geometry import Rigid

    cfg = tiny_config(tri_att)
    w = weights(cfg)
    _, model = port.build(cfg, w)
    model.eval()
    f = motif_batch()
    x = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 24, 3)) * 6, dtype=torch.float32)
    x = x * f["residue_mask"][..., None]
    t = torch.tensor([700, 3])
    rots = ref.frenet_frames(x, f["chain_index"], f["residue_mask"])
    with torch.no_grad():
        z_ref = ref.denoise(w, cfg["configuration"], rots, x, t, f)
        z_port = model(Rigid(rots, x), t, port_features(f))["z"]
    mask = f["residue_mask"][..., None].float()
    err = ((z_port - z_ref) * mask).abs().max() / (z_ref * mask).abs().max()
    assert err < 1e-5, err


def test_training_step_matches_port():
    """Loss and every gradient of one step with dropout, from the same
    weights, t, noise and dropout seed."""
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.train.state import create_train_state, make_train_step

    cfg = tiny_config()
    conf = cfg["configuration"]
    _, model = port.build(cfg, weights(cfg))
    state = create_train_state(model, 1e-4)
    step = make_train_step(Schedule.create(conf["numTimesteps"]), 1.0)
    f = motif_batch(conf["maximumNumResidues"])
    t = torch.tensor([11, 4])
    noise = torch.randn((2, conf["maximumNumResidues"], 3), generator=torch.Generator().manual_seed(1))
    metrics = step(state, port_features(f), t=t, noise=noise, dropout_seed=77)
    g_port = {k: state.optimizer.state[p]["exp_avg"] / 0.1 for k, p in model.named_parameters()}

    params = {k: v.clone().requires_grad_(True) for k, v in weights(cfg).items()}
    sched = ref.cosine_schedule(conf["numTimesteps"], "cpu")
    z, x_t = ref.noised(sched, f["atom_positions"], t, noise, f["residue_mask"])
    z_pred = ref.denoise(params, conf, ref.frenet_frames(x_t, f["chain_index"], f["residue_mask"]), x_t, t, f, 77)
    loss = ref.loss(z_pred, z, f, 1.0)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert abs(metrics["weighted_loss"].item() - loss.item()) <= 1e-6 * loss.item()
    med = float(np.median([g.norm().item() for g in grads.values()]))
    worst = max((g_port[k] - g).norm().item() / max(g.norm().item(), med) for k, g in grads.items())
    assert worst < 1e-4, worst


def test_noise_streams_match_port():
    from genie2_tpu_torch.sampling.ddpm import step_noise

    ids = [0, 5, -1]
    assert torch.equal(ref_inputs.stream_noise(SEED, ids, 17, 9), step_noise(SEED, ids, 17, 9))


def test_motif_placements_match_port(tmp_path):
    """The problem file the harness writes, read and placed by the program
    (features/motif.py) and by the reference, sample after sample."""
    from genie2_tpu_torch.features import features_from_motif_pdb

    from portbench.harness import registry

    path = str(tmp_path / "motif.pdb")
    registry.generator("ancestral").write_motif_problem(path, TINY_TRAFFIC["scaffold"]["problem"], SEED)
    problem = ref_inputs.read_motif_problem(path)
    rng_p, rng_r = np.random.default_rng(8), np.random.default_rng(8)
    for _ in range(6):
        want, got = features_from_motif_pdb(path, rng_p), ref_inputs.motif_features(problem, rng_r)
        for k in ("aatype", "atom_positions", "fixed_sequence_mask", "fixed_structure_mask", "residue_index"):
            assert np.array_equal(np.asarray(want[k], float), np.asarray(got[k], float)), k


def test_corpus_and_epochs_match_port():
    """The reference's corpus, epoch order and motif augmentation give the
    program's batches (train/data.py), padded alike."""
    from genie2_tpu_torch.train.data import MotifAugmentConfig, synthetic_dataset

    tr = TINY_TRAFFIC["train"]
    data = synthetic_dataset(tr["corpus"], 40, np.random.default_rng(tr["corpus_seed"]), tr["min_length"],
                             MotifAugmentConfig(prob=0.8))
    order_p, order_r = np.random.default_rng(4), np.random.default_rng(4)
    ours = ref_inputs.epochs(ref_inputs.corpus(tr["corpus"], tr["min_length"], 40, tr["corpus_seed"]), 2, order_r, 0.8)
    theirs = (b for _ in range(3) for b in data.epoch(2, order_p))
    for _ in range(7):
        want, got = next(theirs), ref_inputs.stack(next(ours), 40, "cpu")
        for k in ("atom_positions", "residue_mask", "fixed_sequence_mask", "fixed_structure_mask", "aatype"):
            assert np.allclose(want[k], got[k].numpy()), k
