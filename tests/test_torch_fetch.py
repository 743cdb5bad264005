"""genie2_tpu_torch/cli/fetch_afdb.py (console entry
`genie2-torch-fetch-afdb`) against a local HTTP server, the three cases of
tests/test_fetch.py: concurrent fetch, resume-by-skip, atomic writes (no
.part debris), permanent-404 handling with a re-runnable failure manifest,
and the CLI's exit codes. No network: the server is on 127.0.0.1.
"""

import http.server
import os
import threading

import pytest

from genie2_tpu_torch.cli.fetch_afdb import fetch_corpus, main, read_index

PDB_BODY = b"ATOM      1  CA  ALA A   1       0.000   0.000   0.000  1.00  0.00           C\nEND\n"


@pytest.fixture()
def server(tmp_path):
    docroot = tmp_path / "docroot"
    docroot.mkdir()
    for i in range(5):
        (docroot / f"AF-{i}-F1-model_v4.pdb").write_bytes(PDB_BODY)

    handler = lambda *a, **kw: http.server.SimpleHTTPRequestHandler(
        *a, directory=str(docroot), **kw
    )
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def _index(tmp_path, names, filename="index.txt"):
    path = tmp_path / filename
    path.write_text("\n".join(names) + "\n")
    return str(path)


def test_read_index_strips_extension_and_blanks(tmp_path):
    path = _index(tmp_path, ["AF-1-F1.pdb", "", "# comment", "AF-2-F1"])
    assert read_index(path) == ["AF-1-F1", "AF-2-F1"]
    assert read_index(path, limit=1) == ["AF-1-F1"]


def test_fetch_resume_and_failures(server, tmp_path):
    names = [f"AF-{i}-F1-model_v4" for i in range(5)] + ["AF-missing-F1"]
    index = _index(tmp_path, names)
    outdir = str(tmp_path / "pdbs")

    n_ok, n_skip, failures = fetch_corpus(
        index, outdir, base_url=server, workers=4, progress_every=0, retries=2
    )
    assert (n_ok, n_skip) == (5, 0)
    assert list(failures) == ["AF-missing-F1"] and "404" in failures["AF-missing-F1"]
    # Atomic: content correct, no .part debris; manifest is re-runnable.
    for i in range(5):
        assert (tmp_path / "pdbs" / f"AF-{i}-F1-model_v4.pdb").read_bytes() == PDB_BODY
    assert not [f for f in os.listdir(outdir) if ".part" in f]
    manifest = os.path.join(outdir, ".fetch_failures.txt")
    assert open(manifest).read().split("\t")[0] == "AF-missing-F1"

    # Resume: everything present is skipped, nothing re-downloaded.
    n_ok2, n_skip2, failures2 = fetch_corpus(
        index, outdir, base_url=server, workers=4, progress_every=0, retries=1
    )
    assert (n_ok2, n_skip2) == (0, 5)
    assert list(failures2) == ["AF-missing-F1"]


def test_cli_exit_codes(server, tmp_path):
    index = _index(tmp_path, ["AF-0-F1-model_v4"])
    outdir = str(tmp_path / "pdbs")
    assert main(["--index", index, "--outdir", outdir, "--base_url", server]) == 0
    bad = _index(tmp_path, ["AF-0-F1-model_v4", "AF-nope"], "bad_index.txt")
    assert main(
        ["--index", bad, "--outdir", outdir, "--base_url", server, "--retries", "1"]
    ) == 1
    # The failure manifest clears once the corpus completes.
    assert os.path.exists(os.path.join(outdir, ".fetch_failures.txt"))
    assert main(["--index", index, "--outdir", outdir, "--base_url", server]) == 0
    assert not os.path.exists(os.path.join(outdir, ".fetch_failures.txt"))
