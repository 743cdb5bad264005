"""genie2_tpu_torch's training data pipeline against genie2_tpu's: the
epochs are byte-identical (same arrays, same dtypes), for synthetic data
and for a directory of PDB files through the packed cache, with motif
augmentation and a mid-epoch `start_batch`."""

import os

import numpy as np
import pytest

from genie2_tpu.train import MotifAugmentConfig as JMotif
from genie2_tpu.train import StructureDataset as JDataset
from genie2_tpu.train import setup_split as jsetup_split
from genie2_tpu.train import synthetic_dataset as jsynthetic
from genie2_tpu_torch.features import create_empty_features, features_from_pdb, save_features_to_pdb
from genie2_tpu_torch.train import MotifAugmentConfig, StructureDataset, setup_split, synthetic_dataset
from genie2_tpu_torch.train.prefetch import prefetch

MOTIF = dict(prob=0.8, min_pct_res=0.05, max_pct_res=0.5, min_n_seg=1, max_n_seg=4)


def _same_epochs(ds_port, ds_jax, batch_size, seeds=(0, 1), start_batch=0):
    n = 0
    for seed in seeds:
        got = list(ds_port.epoch(batch_size, np.random.default_rng([100, seed]), start_batch=start_batch))
        want = list(ds_jax.epoch(batch_size, np.random.default_rng([100, seed]), start_batch=start_batch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                assert g[k].tobytes() == w[k].tobytes(), k
            n += 1
    return n


@pytest.mark.parametrize("start_batch", [0, 2])
def test_synthetic_epochs_byte_identical(start_batch):
    ds = synthetic_dataset(13, max_n_res=24, rng=np.random.default_rng(4), motif=MotifAugmentConfig(**MOTIF))
    jds = jsynthetic(13, max_n_res=24, rng=np.random.default_rng(4), motif=JMotif(**MOTIF))
    assert _same_epochs(ds, jds, 3, start_batch=start_batch) == 2 * (4 - start_batch)


def _write_pdbs(path, n=10):
    rng = np.random.default_rng(0)
    os.makedirs(path)
    for i in range(n):
        length = int(rng.integers(14, 30))
        f = create_empty_features([length])
        steps = rng.normal(size=(length, 3))
        f["atom_positions"] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True), axis=0)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
        save_features_to_pdb(f, os.path.join(path, f"walk_{i}.pdb"))
    return path


def test_pdb_directory_through_packed_cache_byte_identical(tmp_path):
    """setup_split's name lists, features_from_pdb (genie2_tpu's default
    reader, its C++ parser, against the port's one reader: coordinates
    rounded to float32), the packed cache (built by each package, read back
    by the other) and the epochs with motif augmentation, whole and from
    batch 1."""
    from genie2_tpu.features import features_from_pdb as jfeatures_from_pdb

    data = _write_pdbs(str(tmp_path / "data"))
    names = setup_split(str(tmp_path / "a"), "run", data, 10, 24, 1, validation_split=0.2, seed=100)
    assert names == jsetup_split(str(tmp_path / "b"), "run", data, 10, 24, 1, validation_split=0.2, seed=100)
    paths = [os.path.join(data, f"{n}.pdb") for n in names[0]]
    for p in paths:
        got, want = features_from_pdb(p), jfeatures_from_pdb(p)
        assert all(got[k].tobytes() == want[k].tobytes() and got[k].dtype == want[k].dtype for k in want)
    ds = StructureDataset(paths, 24, 1, motif=MotifAugmentConfig(**MOTIF), cache_path=str(tmp_path / "cache_port"))
    jds = JDataset(paths, 24, 1, motif=JMotif(**MOTIF), cache_path=str(tmp_path / "cache_jax"))
    assert len(ds) == len(jds) == len(paths)
    _same_epochs(ds, jds, 2)
    _same_epochs(ds, jds, 2, start_batch=1)
    # Each package reads the cache the other built.
    cross = StructureDataset(paths, 24, 1, motif=MotifAugmentConfig(**MOTIF), cache_path=str(tmp_path / "cache_jax"))
    assert cross._packed is not None and cross._packed.cache_dir.endswith("cache_jax")
    _same_epochs(cross, jds, 2)


def test_prefetch_keeps_order_and_forwards_errors():
    assert list(prefetch(range(20), lambda x: x * 2, depth=3)) == [2 * i for i in range(20)]
    assert list(prefetch(range(5), None, depth=0)) == list(range(5))

    def bad(x):
        if x == 3:
            raise KeyError(x)
        return x

    it = prefetch(range(10), bad, depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError):
        next(it)
