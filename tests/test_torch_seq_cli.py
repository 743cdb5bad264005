"""The entry points under sequence parallelism, on two gloo ranks against
one process (tests/test_torch_parallel_sampling.py's tiny release):

  * the unconditional, TDS and SSE sampling CLIs with --num_devices 2
    --mesh_seq 2: every sample's coordinates within 2e-3 A of one
    process's (tests/test_mesh3d.py:276), the two ranks' bit for bit
    equal, rank 0 writing the files of one process;
  * cli/train.py with `meshSeq 2`: one version, the losses of one process
    within 1e-5, epoch checkpoints that one process loads full.
"""

import json
import os

import numpy as np

from genie2_tpu_torch.parallel.spawn import run_ranks
from genie2_tpu_torch.utils.model_io import load_model
from tests import torch_ranks
from tests.test_torch_parallel_sampling import UNCOND, _argv, release  # noqa: F401 (fixture)


def _runs(work, root, label):
    return [
        (UNCOND, _argv(root, work / label / "uncond", "--scale", "0.6", "--num_samples", "2", "--batch_size", "2",
                       "--min_length", "19", "--max_length", "20")),
        ("genie2_tpu_torch.cli.sample_motif_smc", _argv(root, work / label / "tds", "--scale", "1.0",
                                                        "--motif_index", "0", "--num_particles", "2",
                                                        "--motif_dir", str(work / "tds"))),
        ("genie2_tpu_torch.cli.sample_sse", _argv(root, work / label / "sse", "--length", "17", "--num_particles",
                                                  "2", "--strength", "30")),
    ]


def test_sampling_clis_under_seq_axis(release):  # noqa: F811 (fixture)
    """Lengths 20 and 19 (padded to 20 on the seq axis), a TDS run of 24
    residues and an SSE run of 17 (padded to 18): coordinates within 2e-3
    A of one process's, the ranks bit for bit equal, the files once."""
    work, root, _ = release
    flags = ["--num_devices", "2", "--mesh_seq", "2"]
    ranks = run_ranks(torch_ranks.tp_cli_runs, 2, ([(cli, argv + flags) for cli, argv in _runs(work, root, "ranks")],),
                      deadline=240.0)
    alone = torch_ranks.tp_cli_runs(0, _runs(work, root, "alone"))
    for a, b, want in zip(*ranks, alone):
        assert np.array_equal(a, b)
        np.testing.assert_allclose(a, want, atol=2e-3, rtol=0)
    assert sorted(os.listdir(work / "ranks" / "uncond" / "pdbs")) == ["19_0.pdb", "19_1.pdb", "20_0.pdb", "20_1.pdb"]


def test_train_cli_under_seq_axis(tmp_path):
    """cli/train.py with `meshSeq 2` on two ranks (each the whole batch,
    half of each pair representation's rows) against one process: one
    version, the same losses within 1e-5, epoch checkpoints that one
    process loads full."""
    from tests.test_torch_train_loop import CONFIG, write_corpus

    data = write_corpus(str(tmp_path / "data"))
    losses = {}
    for label, extra, n in (("ranks", "meshSeq 2\n", 2), ("alone", "", 1)):
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
