"""genie2_tpu_torch's PDB reader (features/pdb.py) against genie2_tpu's
default reader: `features_from_pdb` gives genie2_tpu's features byte for
byte (coordinates rounded to float32, as genie2_tpu's C++ parser reads
them) on plain, gzip, multichain and chain-id-returning files, and
`parse_pdb` its sequences; the float32 rounding of a numpy-parsed 8-column
field is C's `strtof`'s; an unknown residue raises; a file longer than
genie2_tpu's buffer is read whole; reading needs no C++ compiler."""

import ctypes
import gzip

import numpy as np
import pytest

from genie2_tpu.features import features_from_pdb as jfeatures_from_pdb
from genie2_tpu.features import parse_pdb as jparse_pdb
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
def test_reader_equals_genie2_tpu(tmp_path, case):
    path = CASES[case](tmp_path)
    seqs, coords = parse_pdb(path)
    assert seqs == jparse_pdb(path)[0]
    assert all(isinstance(x, float) for x in coords[0][0])
    if case == "chain_id_returns":
        assert [len(s) for s in seqs] == [9, 5, 7]
    # The features are those of genie2_tpu's default reader, byte for byte:
    # their coordinates were float32 before they were centred.
    got, want = features_from_pdb(path), jfeatures_from_pdb(path)
    assert set(got) == set(want)
    assert all(got[k].tobytes() == want[k].tobytes() and got[k].dtype == want[k].dtype for k in want)
    centred = np.concatenate(coords) - np.concatenate(coords).mean(axis=0)
    assert not np.array_equal(got["atom_positions"], centred)
    np.testing.assert_allclose(got["atom_positions"], centred, rtol=0, atol=1e-3)


def _strtof():
    libc = ctypes.CDLL(None)
    libc.strtof.restype = ctypes.c_float
    libc.strtof.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    return lambda field: libc.strtof(field.encode(), None)


def _fields(case, rng):
    """Coordinate fields as save_features_to_pdb writes them: thousandths,
    right-aligned in 8 columns."""
    if case == "signed_zeros":
        return ["   0.000", "  -0.000", "       0", "      -0", "   0.0", "  -0.0", "-0.00000", "0.000000"]
    bound = {"within_1e3": 999_999, "within_1e4": 9_999_999, "small": 999}[case]
    k = rng.integers(-bound, bound + 1, 4000)
    if case == "within_1e4":  # past 2^12 and 2^13, where a float32 step is 2^-11 and 2^-10
        k[:8] = [4_096_000, -4_096_001, 8_191_999, 8_192_000, -8_192_001, 9_999_999, -9_999_999, 1]
    return [f"{v / 1000:8.3f}" for v in k]


@pytest.mark.parametrize("case", ["within_1e3", "within_1e4", "small", "signed_zeros"])
def test_float32_rounding_is_strtof(case):
    """numpy reads a field to float64 and then rounds it to float32, as
    features_from_pdb does; libc's strtof rounds it to float32 at once. The
    two agree bit for bit, the sign of a zero too."""
    fields = _fields(case, np.random.default_rng(len(case)))
    strtof = _strtof()
    got = np.array(fields, dtype=np.float64).astype(np.float32)
    want = np.array([strtof(f) for f in fields], dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), [
        (f, g, w) for f, g, w in zip(fields, got, want) if g.view(np.uint32) != w.view(np.uint32)][:5]


def test_reads_without_a_compiler(tmp_path, monkeypatch):
    """CXX and PATH name no compiler: the reader needs none."""
    path = _write(tmp_path, "s", [12], 5)
    want = features_from_pdb(path)
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("CXX", str(tmp_path / "no" / "g++"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    got = features_from_pdb(path)
    assert got["atom_positions"].shape == (12, 3)
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)


def test_unknown_residue_raises(tmp_path):
    path = str(tmp_path / "bad.pdb")
    with open(path, "w") as fh:
        fh.write("ATOM      1  CA  XXX A   1       1.000   2.000   3.000\n")
    for read in (parse_pdb, features_from_pdb, jfeatures_from_pdb):
        with pytest.raises(KeyError):
            read(path)


def test_no_truncation_past_genie2_tpu_buffer(tmp_path):
    """More CA records than the 65536-atom buffer of genie2_tpu's C++
    parser: the port reads all of them (genie2_tpu truncates at its buffer
    without a word; a kept difference)."""
    n = 65536 + 100
    line = "ATOM      1  CA  GLY A   1       1.500  -2.250   3.125  1.00  0.00           C\n"
    path = str(tmp_path / "long.pdb")
    with open(path, "w") as fh:
        fh.write(line * n)
    seqs, coords = parse_pdb(path)
    assert [len(s) for s in seqs] == [n] and coords[0][-1] == [1.5, -2.25, 3.125]
