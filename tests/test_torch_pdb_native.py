"""genie2_tpu_torch's C++ CA parser (features/pdb_native.py) against
genie2_tpu's `parse_pdb_fast`: the same sequences and the same float32-rounded
coordinates, exactly, on plain, gzip, multichain and chain-id-returning
files; an unknown residue goes to the numpy parser's error in both; a file
longer than genie2_tpu's buffer is read whole; a failed build raises."""

import gzip
import os

import numpy as np
import pytest

import genie2_tpu_torch.features.pdb_native as pdb_native
from genie2_tpu.features.pdb_native import parse_pdb_fast as jparse_pdb_fast
from genie2_tpu_torch.features import create_empty_features, features_from_pdb, parse_pdb, save_features_to_pdb


def _write(tmp_path, name, lengths, seed, gz=False):
    rng = np.random.default_rng(seed)
    n = sum(lengths)
    f = create_empty_features(list(lengths))
    f["atom_positions"] = rng.normal(size=(n, 3)) * 20
    f["aatype"] = np.eye(20)[rng.integers(0, 20, n)].astype(int)
    path = str(tmp_path / f"{name}.pdb")
    save_features_to_pdb(f, path)
    if gz:
        with open(path, "rb") as fin, gzip.open(path + ".gz", "wb") as fout:
            fout.write(fin.read())
        return path + ".gz"
    return path


def _chain_returns(tmp_path):
    """Chains A, B, then A again: three chains (a new one wherever the id changes)."""
    path = _write(tmp_path, "aba", [9, 5, 7], 3)
    lines = open(path).read().splitlines()
    ids = "A" * 9 + "B" * 5 + "A" * 7
    out = [ln[:21] + ids[i] + ln[22:] for i, ln in enumerate(lines) if ln.startswith("ATOM")]
    out.insert(4, "HETATM    5  O   HOH A 100      1.000   2.000   3.000  1.00  0.00           O")
    out.insert(12, "ATOM     13  CB  ALA A   9       1.000   2.000   3.000  1.00  0.00           C")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\nEND\n")
    return path


CASES = {
    "plain": lambda tmp: _write(tmp, "plain", [80], 1),
    "gzip": lambda tmp: _write(tmp, "gz", [33], 2, gz=True),
    "multichain": lambda tmp: _write(tmp, "mc", [10, 7], 4),
    "chain_id_returns": _chain_returns,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_parser_equals_genie2_tpu(tmp_path, case):
    path = CASES[case](tmp_path)
    seqs, coords = pdb_native.parse_pdb_fast(path)
    want_seqs, want_coords = jparse_pdb_fast(path)
    assert seqs == want_seqs and coords == want_coords
    assert all(isinstance(x, float) for x in coords[0][0])
    # The same residues as the numpy parser, coordinates within float32 rounding.
    np_seqs, np_coords = parse_pdb(path)
    assert seqs == np_seqs
    np.testing.assert_allclose(np.concatenate(coords), np.concatenate(np_coords), rtol=2 ** -23, atol=0)
    if case == "chain_id_returns":
        assert [len(s) for s in seqs] == [9, 5, 7]
    # The features of the native path are genie2_tpu's, byte for byte.
    from genie2_tpu.features import features_from_pdb as jfeatures_from_pdb

    got, want = features_from_pdb(path), jfeatures_from_pdb(path)
    assert all(got[k].tobytes() == want[k].tobytes() and got[k].dtype == want[k].dtype for k in want)


def test_unknown_residue_goes_to_the_numpy_parser(tmp_path):
    path = str(tmp_path / "bad.pdb")
    with open(path, "w") as fh:
        fh.write("ATOM      1  CA  XXX A   1       1.000   2.000   3.000\n")
    for parse in (pdb_native.parse_pdb_fast, jparse_pdb_fast):
        with pytest.raises(KeyError):
            parse(path)


def test_no_truncation_past_genie2_tpu_buffer(tmp_path):
    """More CA records than genie2_tpu's 65536-atom buffer: the port reads
    all of them (genie2_tpu truncates at its buffer without a word; a kept
    difference)."""
    n = 65536 + 100
    line = "ATOM      1  CA  GLY A   1       1.500  -2.250   3.125  1.00  0.00           C\n"
    path = str(tmp_path / "long.pdb")
    with open(path, "w") as fh:
        fh.write(line * n)
    seqs, coords = pdb_native.parse_pdb_fast(path)
    assert [len(s) for s in seqs] == [n] and coords[0][-1] == [1.5, -2.25, 3.125]
    assert [len(s) for s in jparse_pdb_fast(path)[0]] == [65536]


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The parser built afresh into an empty directory on its next call."""
    monkeypatch.setattr(pdb_native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(pdb_native, "_lib", None)
    return tmp_path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(pdb_native, "CXX", str(fresh_build / "no" / "g++"))
    path = _write(fresh_build, "s", [12], 5)
    with pytest.raises(RuntimeError, match=r"needs a C\+\+ compiler"):
        features_from_pdb(path)
    assert not os.listdir(fresh_build / "build")
    # The numpy path needs no compiler.
    assert features_from_pdb(path, use_native=False)["atom_positions"].shape == (12, 3)


def test_failed_build_raises_with_compiler_output(fresh_build, monkeypatch):
    broken = fresh_build / "broken.cpp"
    broken.write_text("extern \"C\" int64_t parse_pdb_ca( {\n")
    monkeypatch.setattr(pdb_native, "SOURCE", str(broken))
    with pytest.raises(RuntimeError, match="error"):
        pdb_native.load_library()
    assert pdb_native._lib is None and not any(f.endswith(".so") for f in os.listdir(fresh_build / "build"))
