"""Tensor parallelism (genie2_tpu_torch/parallel/tensor_parallel.py) on gloo
ranks, against one process and against genie2_tpu's own plan.

  * the plan: the split parameters are those genie2_tpu's `tp_spec`
    shards at the example width (flax paths mapped through
    utils/weights.py), most of the model's bytes; a module whose heads do
    not divide the model axis stays replicated, and correct;
  * the split TriMul epilogue's plain versions: two ranks' partial sums,
    summed, then the finish stage, against the one-stage plain version
    and genie2_tpu's Pallas epilogue in interpret mode;
  * the denoiser on two model ranks against genie2_tpu's forward under its
    TP plan on the virtual CPU mesh (z within 2e-5, as
    tests/test_tensor_parallel.py holds genie2_tpu), with and without
    triangle attention and with row-chunked triangle attention; the state
    dict gathered from the shards; the bytes all-reduced a forward;
  * training steps on two model ranks and on a (2 data x 2 model) grid
    against one process (metrics within 1e-5, gradients within 1e-5 of
    max, parameters and Adam's moments after three steps), dropout and
    remat on, and remat off;
  * the Trainer under meshModel 2: full checkpoints that one process
    loads, and a resumed run equal to an uninterrupted one;
  * the four sampling CLIs with --mesh_model 2 on two ranks against one
    process (coordinates within 1e-4 A), the model ranks bit for bit
    equal.

Every multi-process case runs through `parallel/spawn.py:run_ranks`, which
has its own deadline.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from genie2_tpu.config import Config as JConfig
from genie2_tpu.features import to_device as jto_device
from genie2_tpu.geometry import Rigid as JRigid
from genie2_tpu.geometry import frenet_frames as jfrenet
from genie2_tpu.nn import Denoiser as FlaxDenoiser
from genie2_tpu.ops import trimul_fused as jfused
from genie2_tpu.parallel import create_tp_mesh as jcreate_tp_mesh
from genie2_tpu.parallel import place_params as jplace_params
from genie2_tpu.parallel import tp_spec as jtp_spec
from genie2_tpu_torch.config import Config
from genie2_tpu_torch.features import batchify, create_empty_features
from genie2_tpu_torch.nn import Denoiser
from genie2_tpu_torch.ops import trimul
from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.parallel.tensor_parallel import split_parameters, tp_spec, tp_stats
from genie2_tpu_torch.utils.model_io import load_model, load_state_dict_file
from genie2_tpu_torch.utils.weights import _torch_key, params_from_flax
from tests import torch_ranks
from tests.test_torch_parallel_sampling import UNCOND, _argv, release  # noqa: F401 (fixture)
from tests.test_torch_train import LR, STEPS, TINY, _batch, _leaf_close

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "example.configuration")


# ------------------------------------------------------------------ #
# The plan
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module", params=[False, True], ids=["example", "example_tri_att"])
def example_models(request):
    """The example configuration (and with triangle attention): the port's
    full model and the shapes of genie2_tpu's parameter tree."""
    overrides = {"includeTriangularAttention": str(request.param)}
    with torch.random.fork_rng(devices=[]):
        port = Denoiser.from_config(Config(EXAMPLE, overrides=overrides))
    flax_model = FlaxDenoiser.from_config(JConfig(EXAMPLE, overrides=overrides))
    feats = jto_device(batchify([create_empty_features([8])]))
    trans = jnp.zeros((1, 8, 3))
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            JRigid(jfrenet(trans, feats["chain_index"], feats["residue_mask"]), trans),
                            jnp.ones(1, jnp.int32), feats)
    return port, shapes


@pytest.mark.parametrize("n_model", [2, 3, 4])
def test_plan_matches_genie2_tpu(example_models, n_model):
    """At the example width the port splits exactly the parameters
    genie2_tpu's tp_spec shards (3 divides the IPA's 12 heads but not the
    TriMul's 128 channels or the pair transition's 512: both replicate
    those); the split is most of the model's bytes at 2 and 4."""
    port, shapes = example_models
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        names = tuple(str(p.key) for p in path)
        if jtp_spec("params/" + "/".join(names), leaf.shape, n_model) != P():
            want.add(_torch_key(names)[0])
    got = split_parameters(port, n_model)
    assert want and set(got) == want
    # Column-split weights by their output features, row-split ones by their input.
    for name in ("pair_transform_net.net.0.pair_transition.linear_1.weight",
                 "structure_net.net.0.ipa.linear_out.weight", "structure_net.net.0.ipa_layer_norm.weight"):
        assert tp_spec(port, name, n_model) == got.get(name)
    assert tp_spec(port, "structure_net.net.0.ipa.linear_out.weight", n_model) == 1
    if n_model != 3:
        assert tp_stats(port, n_model)["sharded_frac"] > 0.75


# ------------------------------------------------------------------ #
# The split epilogue's plain versions
# ------------------------------------------------------------------ #


def test_split_epilogue_plain_matches_one_stage_and_pallas():
    """Partial sums of two halves of the hidden channels, summed, through
    the finish stage: against `epilogue_cm_plain` and genie2_tpu's
    `epilogue_cm` (interpret mode), within 1e-5 of max, fp32."""
    rng = np.random.default_rng(3)
    # N: a multiple of the Pallas kernel's 16-row block; its z block takes H = C.
    B, N, C, H = 2, 32, 16, 16
    r = lambda *s, sc=1.0, off=0.0: (off + sc * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    w = {"ln_in_scale": r(C, sc=0.1, off=1.0), "ln_in_bias": r(C, sc=0.1), "ln_out_scale": r(H, sc=0.1, off=1.0),
         "ln_out_bias": r(H, sc=0.1), "w_z": r(C, H, sc=H ** -0.5), "b_z": r(C, sc=0.1), "w_g": r(C, C, sc=C ** -0.5),
         "b_g": r(C, sc=0.1)}
    x, z = r(B, H, N, N), r(B, N, N, C)
    tw = {k: torch.tensor(v) for k, v in w.items()}
    tx, tz = torch.tensor(x), torch.tensor(z)
    part = sum(trimul.epilogue_partial_plain(tx[:, h], tw["w_z"][:, h], tw["ln_out_scale"][h], tw["ln_out_bias"][h])
               for h in (slice(0, H // 2), slice(H // 2, H)))
    assert part.dtype == torch.float32 and part.shape == (trimul.part_size(B, N, C),)
    got = trimul.epilogue_finish(part, tz, tw, H)
    one_stage = trimul.epilogue_cm_plain(tx, tz, tw)
    # genie2_tpu's kernel takes flax's [in, out] layout.
    jw = {k: jnp.asarray(v.T if k in ("w_z", "w_g") else v) for k, v in w.items()}
    pallas = np.asarray(jfused.epilogue_cm(jnp.asarray(x), jnp.asarray(z), jw, interpret=True))
    scale = np.abs(pallas).max()
    assert np.abs(got.numpy() - one_stage.numpy()).max() <= 1e-5 * scale
    assert np.abs(got.numpy() - pallas).max() <= 1e-5 * scale


# ------------------------------------------------------------------ #
# The denoiser's forward
# ------------------------------------------------------------------ #

TP_TINY = {**TINY, "pairTransitionN": 2, "triangularAttentionHiddenDimension": 4,
           "triangularAttentionNumHeads": 2, "numStructureLayers": 2}
TRI_ATT = {"includeTriangularAttention": "True"}
CASES = {
    "plain": {},
    "tri_att": TRI_ATT,
    "tri_att_chunked": {**TRI_ATT, "triangleAttentionChunk": 8},
}
# Three heads in the IPA and in triangle attention: two model ranks split
# neither module, only the TriMul and the transitions.
INDIVISIBLE = {**TP_TINY, **TRI_ATT, "ipaNumHeads": 3, "triangularAttentionNumHeads": 3}


def _inputs(n_res=20, batch=2):
    batch_np = batchify([create_empty_features([n_res])] * batch)
    trans = (np.random.default_rng(0).normal(size=(batch, n_res, 3)) * 3).astype(np.float32)
    return trans, np.array([3, 7], dtype=np.int32), batch_np


def _genie2_tpu_tp(overrides, inputs):
    """genie2_tpu's forward under its TP plan on two of the virtual CPU
    devices, and its (zero leaves randomised) parameters as a state dict."""
    from tests.test_torch_train import _randomized

    trans, t, batch = inputs
    model = FlaxDenoiser.from_config(JConfig(overrides=overrides))
    feats = jto_device(batch)
    x = jnp.asarray(trans)
    frames = JRigid(jfrenet(x, feats["chain_index"], feats["residue_mask"]), x)
    variables = _randomized(jax.jit(model.init)(jax.random.PRNGKey(1), frames, jnp.asarray(t), feats))
    mesh = jcreate_tp_mesh(n_data=1, n_model=2)
    z = jax.jit(model.apply)(jplace_params(variables, mesh), frames, jnp.asarray(t), feats)["z"]
    return np.asarray(z), params_from_flax(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def forward_runs():
    """Each case of CASES through genie2_tpu's TP forward and the port on two
    model ranks, then INDIVISIBLE on the ranks and in one process."""
    inputs = _inputs()
    cases, want = [], {}
    for name, extra in CASES.items():
        overrides = {**TP_TINY, **extra}
        want[name], state_dict = _genie2_tpu_tp(overrides, inputs)
        cases.append((overrides, state_dict, inputs, "fp32"))
    seeded = torch_ranks.seeded_model(Config(overrides=INDIVISIBLE))
    cases.append((INDIVISIBLE, seeded.state_dict(), inputs, "fp32"))
    cases.append((*cases[0][:3], "bf16"))
    ranks = run_ranks(torch_ranks.tp_forward, 2, (cases, 2))
    alone = torch_ranks.tp_forward(0, [cases[0], *cases[-2:]], 1, distributed=False)
    return dict(zip([*CASES, "indivisible", "bf16"], zip(*ranks))), want, cases, dict(
        zip(("plain", "indivisible", "bf16"), alone))


@pytest.mark.parametrize("name", list(CASES))
def test_two_model_ranks_match_genie2_tpu(forward_runs, name):
    """z within 2e-5 of genie2_tpu's under its own plan; the two model
    ranks' z bit for bit equal."""
    runs, want, _, _ = forward_runs
    r0, r1 = runs[name]
    assert np.abs(want[name]).max() > 1e-3
    np.testing.assert_allclose(r0["z"].numpy(), want[name], atol=2e-5, rtol=2e-5)
    assert torch.equal(r0["z"], r1["z"])
    assert r0["split"] and r0["split"] == r1["split"]


def test_indivisible_heads_stay_replicated_and_correct(forward_runs):
    """Three IPA and triangle attention heads on two model ranks: neither
    module splits (the TriMul and the transitions do), and z equals one
    process's."""
    runs, _, _, alone = forward_runs
    r0, r1 = runs["indivisible"]
    assert r0["split"] and not [n for n in r0["split"] if ".ipa." in n or "tri_att" in n]
    assert any("tri_mul_out" in n for n in r0["split"]) and any("transition.layers.0" in n for n in r0["split"])
    np.testing.assert_allclose(r0["z"].numpy(), alone["indivisible"]["z"].numpy(), atol=2e-5, rtol=2e-5)
    assert torch.equal(r0["z"], r1["z"])


def test_bf16_copy_keeps_the_shards(forward_runs):
    """The bf16 policy's cast copy of a split model holds the same shards in
    bf16 (the caller's model stays float32) and its z is one process's bf16
    z within tests/test_torch_policy.py's bounds: 1e-1 of max |z|, and an
    rms difference within 1.25x one process's own bf16-vs-fp32 rms (the
    model ranks sum their partial sums in float32 and round once)."""
    from tests.test_torch_policy import BF16_RMS_FACTOR, BF16_TOL

    runs, _, _, alone = forward_runs
    r0, r1 = runs["bf16"]
    assert r0["copy_keeps_shards"] and r1["copy_keeps_shards"] and torch.equal(r0["z"], r1["z"])
    got, want, fp32 = r0["z"].numpy(), alone["bf16"]["z"].numpy(), alone["plain"]["z"].numpy()
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))  # noqa: E731
    assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    assert rms(got - want) <= BF16_RMS_FACTOR * rms(want - fp32), (rms(got - want), rms(want - fp32))


@pytest.mark.parametrize("name", [*CASES, "indivisible"])
def test_shards_gather_to_the_state_dict(forward_runs, name):
    """gather_state_dict of the shards is the full state dict, exactly, on
    every rank."""
    runs, _, cases, _ = forward_runs
    state_dict = cases[[*CASES, "indivisible"].index(name)][1]
    for res in runs[name]:
        assert res["gathered"].keys() == state_dict.keys()
        for k, v in state_dict.items():
            assert torch.equal(res["gathered"][k], v), k


def test_forward_volume_is_its_formula(forward_runs):
    """The bytes all-reduced over the model group in one forward: each
    TriMul's partial sums B N^2 (D + 2) + 2 D, each pair transition's and
    triangle attention's B N^2 C_p, each IPA's and each transition's
    B N c_s, in float32."""
    runs, _, cases, _ = forward_runs
    trans, _, _ = cases[0][2]
    B, N = trans.shape[:2]
    c_s, c_p = TP_TINY["singleFeatureDimension"], TP_TINY["pairFeatureDimension"]
    pair_layers, structure_layers = TP_TINY["numPairTransformLayers"], TP_TINY["numStructureLayers"]
    for name, tri_att in (("plain", 0), ("tri_att", 2)):
        want = 4 * (pair_layers * (2 * (B * N * N * (c_p + 2) + 2 * c_p) + (1 + tri_att) * B * N * N * c_p)
                    + structure_layers * 2 * B * N * c_s)
        for res in runs[name]:
            assert res["volume"] == {"forward": want, "backward": 0}


# ------------------------------------------------------------------ #
# Training
# ------------------------------------------------------------------ #

WITH_DROPOUT = {**TP_TINY, "remat": True}
NO_REMAT = {**TP_TINY, "remat": False}


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def _grads_close(got, want):
    """Every gradient within 1e-5 of the largest one."""
    top = max(w.abs().max().item() for w in want.values())
    err = max((got[n] - w).abs().max().item() for n, w in want.items())
    assert err <= 1e-5 * top, (err, top)


@pytest.fixture(scope="module")
def train_runs():
    """Three steps (dropout on) of one batch of 4: in one process, on two
    model ranks with remat and without, on a (2 data x 2 model) grid."""
    state_dict = torch_ranks.seeded_model(Config(overrides=WITH_DROPOUT)).state_dict()
    batch = _batch()
    alone = torch_ranks.train_steps(0, WITH_DROPOUT, state_dict, batch, STEPS, LR, distributed=False)

    def runs(*configs):
        return [((overrides, state_dict, batch, STEPS, LR), {"n_model": 2}) for overrides in configs]

    ranks = {"model2": run_ranks(torch_ranks.train_runs, 2, (runs(WITH_DROPOUT, NO_REMAT),)),
             "grid": run_ranks(torch_ranks.train_runs, 4, (runs(WITH_DROPOUT),))}
    return alone, ranks, state_dict


def _each_run(runs):
    for label, ranks in runs.items():
        for rank, results in enumerate(ranks):
            for remat, result in zip((True, False), results):
                yield f"{label} rank {rank} remat {remat}", result


def test_tp_steps_equal_one_process(train_runs):
    """Each of three steps: the global batch's metrics (grad_norm, the full
    model's, among them) within 1e-5 and every gradient within 1e-5 of the
    largest, on every rank of two model ranks and of the 2 x 2 grid, with
    remat and without (dropout on: equal masks on every model rank)."""
    (records, _, _), runs, _ = train_runs
    for label, (rank_records, _, _) in _each_run(runs):
        for (metrics, grads), (want_metrics, want_grads) in zip(rank_records, records):
            _close(metrics, want_metrics)
            _grads_close(grads, want_grads)
    # Every model rank computes the loss from the same reduced activations
    # under the same dropout masks: equal metrics, bit for bit.
    for label, ranks in runs.items():
        for results in zip(*ranks):
            metrics = [[m for m, _ in records] for records, _, _ in results]
            assert all(m == metrics[0] for m in metrics), label


def test_tp_parameters_and_moments_after_three_steps(train_runs):
    """The gathered parameters after three Adam steps against one
    process's by PR 9's rule for runs whose gradients differ by float32
    rounding (chip_smoke.py:_params_against_adam: every entry within
    Adam's bound, entries without gradient unmoved, entries whose second
    moment dwarfs their gradient difference within 1e-3 lr), Adam's second
    moments within 2e-4 of each leaf's max, and the same on every rank."""
    import chip_smoke

    (records, params, nu), runs, _ = train_runs
    names = sorted(params)

    def flat(tensors):
        return torch.cat([tensors[n].flatten() for n in names])

    for label, (rank_records, rank_params, rank_nu) in _each_run(runs):
        rule = chip_smoke._params_against_adam(flat(rank_params), flat(params), [flat(g) for _, g in rank_records],
                                               [flat(g) for _, g in records], LR)
        assert rule["max_err"] <= rule["bound"] and rule["held_max_err_over_tol"] <= 1, (label, rule)
        assert rule["still_max_err"] == 0 and rule["held_share"] > 0.5, (label, rule)
        _leaf_close(rank_nu, nu, 2e-4, 1e-6)
    for label, ranks in runs.items():
        for name, p in ranks[0][0][1].items():
            assert all(torch.equal(p, r[0][1][name]) for r in ranks), (label, name)


# ------------------------------------------------------------------ #
# The Trainer and the CLIs
# ------------------------------------------------------------------ #

TRAINER = {**TP_TINY, "name": "tp", "batchSize": 2, "logEverySteps": 1, "checkpointEveryEpoches": 1,
           "emaDecay": 0.9}


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_trainer")
    ranks = run_ranks(torch_ranks.tp_fit, 2, (TRAINER, str(root / "ranks"), 2), deadline=240.0)
    alone = torch_ranks.tp_fit(0, TRAINER, str(root / "alone"), 1, distributed=False)
    return ranks, alone, root


def test_trainer_under_model_axis_equals_one_process(trainer_runs):
    """meshModel 2: the losses of every step within 1e-5 of one process's,
    the resumed run continues from the resume_state at step 8 to 12."""
    ranks, alone, _ = trainer_runs
    for runs in ranks:
        assert runs["two"]["step"] == 8 and runs["three"]["step"] == 12
        assert runs["three"]["version"] == runs["two"]["version"]
        for label in ("two", "three"):
            got, want = runs[label]["losses"], alone[label]["losses"]
            assert sorted(got) == sorted(want)
            np.testing.assert_allclose([got[s] for s in sorted(got)], [want[s] for s in sorted(want)], rtol=1e-5)


def test_trainer_checkpoints_are_full(trainer_runs):
    """The epoch checkpoints (and their EMA) written under meshModel 2 load
    in one process, full, with the parameters the ranks gathered."""
    ranks, _, _ = trainer_runs
    run = ranks[0]["three"]
    model = Denoiser.from_config(Config(overrides=TRAINER))
    for stem in ("epoch=2.ckpt", "epoch=2.ema.ckpt"):
        model.load_state_dict(load_state_dict_file(os.path.join(run["workdir"], "checkpoints", stem)))
    model.load_state_dict(load_state_dict_file(os.path.join(run["workdir"], "checkpoints", "epoch=2.ckpt")))
    for name, p in model.named_parameters():
        assert torch.equal(p, run["params"][name]), name
    assert any(p.shape != run["params"][n].shape for n, p in run["local"].items())


def test_train_cli_under_model_axis(tmp_path):
    """cli/train.py with `meshModel 2` on two ranks (each the whole batch of
    2, half of every split layer) against one process: one version, the
    same losses within 1e-5, epoch checkpoints that one process loads
    full."""
    import json

    from tests.test_torch_train_loop import CONFIG, write_corpus

    data = write_corpus(str(tmp_path / "data"))
    losses = {}
    for label, extra, n in (("ranks", "meshModel 2\n", 2), ("alone", "", 1)):
        cfg = tmp_path / f"{label}.configuration"
        cfg.write_text(CONFIG.format(root=tmp_path / label, data=data, epochs=2, extra=extra))
        runs = [("genie2_tpu_torch.cli.train", ["-c", str(cfg), "--device", "cpu"])]
        sizes = (run_ranks(torch_ranks.cli_runs, 2, (runs,)) if n == 2 else [torch_ranks.cli_runs(0, runs)])
        assert all(batch_sizes == [2] for _, batch_sizes in sizes)
        workdir = tmp_path / label / "tcli" / "version_0"
        assert sorted(v for v in os.listdir(tmp_path / label / "tcli") if v.startswith("version_")) == ["version_0"]
        recs = [json.loads(ln) for ln in open(workdir / "metrics.jsonl")]
        losses[label] = [(r["step"], r.get("weighted_loss", r.get("val_loss"))) for r in recs]
    assert [s for s, _ in losses["ranks"]] == [s for s, _ in losses["alone"]]
    np.testing.assert_allclose([v for _, v in losses["ranks"]], [v for _, v in losses["alone"]], rtol=1e-5)
    full, _ = load_model(str(tmp_path / "ranks"), "tcli", epoch=1, device="cpu")
    alone, _ = load_model(str(tmp_path / "alone"), "tcli", epoch=1, device="cpu")
    for (name, p), q in zip(full.named_parameters(), alone.parameters()):
        assert p.shape == q.shape, name


TDS_FLAGS = ["--scale", "1.0", "--motif_index", "0", "--num_particles", "4"]


def _tp_cli_runs(work, root, label):
    return [
        (UNCOND, _argv(root, work / label / "uncond", "--scale", "0.6", "--num_samples", "2", "--batch_size", "2",
                       "--min_length", "20", "--max_length", "20")),
        ("genie2_tpu_torch.cli.sample_scaffold", _argv(root, work / label / "scaffold", "--scale", "0.4",
                                                       "--num_samples", "2", "--batch_size", "2", "--strength",
                                                       "1.5", "--ddim_steps", "4", "--datadir",
                                                       str(work / "scaffold"))),
        ("genie2_tpu_torch.cli.sample_motif_smc", _argv(root, work / label / "tds", *TDS_FLAGS, "--motif_dir",
                                                        str(work / "tds"))),
        ("genie2_tpu_torch.cli.sample_sse", _argv(root, work / label / "sse", "--length", "18", "--num_particles",
                                                  "4", "--strength", "30")),
    ]


def test_sampling_clis_under_model_axis(release):  # noqa: F811 (fixture)
    """The unconditional, scaffold (DDIM with guidance), TDS and SSE CLIs
    with --num_devices 2 --mesh_model 2 on two ranks: the coordinates each
    sampled within 1e-4 A of one process's, the two model ranks' equal bit
    for bit."""
    work, root, _ = release
    flags = ["--num_devices", "2", "--mesh_model", "2"]
    ranks = run_ranks(torch_ranks.tp_cli_runs, 2,
                      ([(cli, argv + flags) for cli, argv in _tp_cli_runs(work, root, "tp_ranks")],), deadline=240.0)
    alone = torch_ranks.tp_cli_runs(0, _tp_cli_runs(work, root, "tp_alone"))
    for a, b, want in zip(*ranks, alone):
        assert np.array_equal(a, b)
        np.testing.assert_allclose(a, want, atol=1e-4, rtol=0)
    assert sorted(os.listdir(work / "tp_ranks" / "uncond" / "pdbs")) == ["20_0.pdb", "20_1.pdb"]


def test_smoke_script_counts_the_tp_phase():
    """chip_smoke.py's tp phase: the bytes a denoiser forward all-reduces at
    B=2, N=256 of the example configuration (10 TriMuls' partial sums of
    C_p + 2 channels and 2 C_p weight sums, 5 pair transitions, 8 IPA
    layers and 8 structure transitions), the launches that move to the
    epilogue's two stages (and the epilogue's backward kernel, which a
    training step under a model axis does not launch), and the partial
    stage's and the finish stage's bytes and operations."""
    import chip_smoke

    config = chip_smoke.example_config()
    B, N = 2, 256
    trimuls, transitions, structure = (10 * 4 * (B * N * N * 130 + 256), 5 * 4 * B * N * N * 128,
                                       8 * 2 * 4 * B * N * 384)
    assert (trimuls, transitions, structure) == (681_584_640, 335_544_320, 12_582_912)
    assert chip_smoke.tp_volume(config, B, N) == trimuls + transitions + structure
    with_tri_att = chip_smoke.tp_volume(chip_smoke.example_config(tri_att=True), B, N)
    assert with_tri_att == trimuls + 3 * transitions + structure
    split = chip_smoke.split_epilogue(chip_smoke.expected_launches(config, 1))
    assert (split["trimul_epilogue"], split["trimul_epilogue_partial"], split["trimul_epilogue_finish"]) == (0, 10, 10)
    # A training step: the epilogue's backward kernel once an epilogue, none
    # under a model axis (its two stages recompute their plain versions).
    step = chip_smoke.train_launches(config, 1, eval_calls=0)
    assert (step["trimul_epilogue"], step["trimul_epilogue_backward"]) == (20, 10)
    assert chip_smoke.split_epilogue(step)["trimul_epilogue_backward"] == 0
    bytes_, ops = chip_smoke.kernel_bytes_ops("trimul_epilogue_partial", B, N, 128, 64, 4)
    assert ops == 2 * B * N * N * 64 * 129
    assert bytes_ == B * N * N * 64 * 4 + 4 * (128 * 64 + 128) + 4 * (B * N * N * 130 + 256)
    bytes_, ops = chip_smoke.kernel_bytes_ops("trimul_epilogue_finish", B, N, 128, 128, 4)
    assert ops == 2 * B * N * N * 128 * 128 and bytes_ > 4 * B * N * N * (130 + 2 * 128)
