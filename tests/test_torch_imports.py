"""The PyTorch port imports no JAX and nothing of genie2_tpu.

An AST scan of every module of genie2_tpu_torch, of chip_smoke.py and of
the port's tools (a sys.modules check cannot work: the test process has
JAX loaded already). Outside tests/, tools/orbax_to_torch.py is the one
bridge that imports both packages.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "orbax", "genie2_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tools", "torch_profile_step.py"),
             os.path.join(REPO, "tools", "torch_kernel_variants.py"),
             os.path.join(REPO, "tools", "torch_multinode_dryrun.py")]
    for root, _, names in os.walk(os.path.join(REPO, "genie2_tpu_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_has_modules():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for expected in ("genie2_tpu_torch/ops/trimul.py", "genie2_tpu_torch/nn/denoiser.py",
                     "genie2_tpu_torch/cli/sample_unconditional.py", "chip_smoke.py",
                     "genie2_tpu_torch/ops/launch.py", "genie2_tpu_torch/ops/ipa.py",
                     "genie2_tpu_torch/ops/triangle.py", "genie2_tpu_torch/features/motif.py",
                     "genie2_tpu_torch/sampling/dpm_solver.py", "genie2_tpu_torch/sampling/scaffold.py",
                     "genie2_tpu_torch/cli/common.py", "genie2_tpu_torch/cli/sample_scaffold.py",
                     "genie2_tpu_torch/ops/tri_att.py", "genie2_tpu_torch/sampling/resampling.py",
                     "genie2_tpu_torch/sampling/feynman_kac.py", "genie2_tpu_torch/sampling/sse_guided.py",
                     "genie2_tpu_torch/features/secstruct.py", "genie2_tpu_torch/cli/sample_sse.py",
                     "genie2_tpu_torch/sampling/twisting.py", "genie2_tpu_torch/sampling/smc.py",
                     "genie2_tpu_torch/sampling/motif_target.py", "genie2_tpu_torch/sampling/manifest.py",
                     "genie2_tpu_torch/utils/loggers.py", "genie2_tpu_torch/cli/sample_motif_smc.py",
                     "genie2_tpu_torch/train/loss.py", "genie2_tpu_torch/train/state.py",
                     "genie2_tpu_torch/train/data.py", "genie2_tpu_torch/train/cache.py",
                     "genie2_tpu_torch/train/prefetch.py", "genie2_tpu_torch/train/loop.py",
                     "genie2_tpu_torch/cli/train.py", "genie2_tpu_torch/parallel/mesh.py",
                     "genie2_tpu_torch/parallel/spawn.py", "genie2_tpu_torch/cli/convert_checkpoint.py",
                     "genie2_tpu_torch/cli/fetch_afdb.py",
                     "tools/torch_multinode_dryrun.py"):
        assert expected in rel


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_catches_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import torch\nfrom genie2_tpu.config import Config\nimport jax.numpy as jnp\n")
    found = [m for m in _imported_modules(str(p)) if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert found == ["genie2_tpu.config", "jax.numpy"]


def test_orbax_bridge_is_the_only_tool_importing_both():
    both = []
    for name in sorted(os.listdir(os.path.join(REPO, "tools"))):
        if name.endswith(".py"):
            roots = {m.split(".")[0] for m in _imported_modules(os.path.join(REPO, "tools", name))}
            if {"genie2_tpu", "genie2_tpu_torch"} <= roots:
                both.append(name)
    assert both == ["orbax_to_torch.py"]
