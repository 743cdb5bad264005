"""Dataset setup: download the AFDB training corpus from an index file.

The training corpus is listed by an index of AFDB file names (the
FoldSeek-representative set of `data/afdbreps_l-256_plddt_80/index.txt`,
588,571 names), each to be downloaded as
https://alphafold.ebi.ac.uk/files/[FILENAME].pdb. This tool does it:
concurrent, resumable (existing non-empty files are skipped), atomic
(tmp-file + rename, so a killed run never leaves truncated PDBs), with
per-file retries and a failure manifest for re-runs. Standard library
only; a copy of genie2_tpu's `cli/fetch_afdb.py`.

Usage:
  genie2-torch-fetch-afdb --index data/afdbreps_l-256_plddt_80/index.txt \
      --outdir data/afdbreps_l-256_plddt_80/pdbs [--workers 16] [--limit N] \
      [--base_url https://alphafold.ebi.ac.uk/files]

Re-running after interruption or partial failure resumes where it left
off. Failures are listed in {outdir}/.fetch_failures.txt (one name per
line) and the exit code is non-zero if any remain.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor, as_completed

DEFAULT_BASE_URL = "https://alphafold.ebi.ac.uk/files"


def read_index(path: str, limit: int = 0):
    """Read an index, order-preserving and DEDUPED — duplicate entries
    would race two same-process workers on one tmp path."""
    names, seen = [], set()
    with open(path) as f:
        for line in f:
            name = line.strip()
            if not name or name.startswith("#"):
                continue
            name = name[:-4] if name.endswith(".pdb") else name
            if name not in seen:
                seen.add(name)
                names.append(name)
    return names[:limit] if limit else names


def fetch_one(
    name: str, outdir: str, base_url: str, retries: int = 3, timeout: float = 30.0
) -> str:
    """Download one structure; returns 'ok' | 'skipped' | an error string.
    Atomic: writes to a per-pid tmp file, renames into place on success."""
    import threading

    dest = os.path.join(outdir, f"{name}.pdb")
    if os.path.exists(dest) and os.path.getsize(dest) > 0:
        return "skipped"
    url = f"{base_url}/{name}.pdb"
    # pid AND thread id: workers are same-pid threads.
    tmp = f"{dest}.part.{os.getpid()}.{threading.get_ident()}"
    last_err = "unknown"
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=timeout) as r, open(
                tmp, "wb"
            ) as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            if os.path.getsize(tmp) == 0:
                raise OSError("empty response body")
            os.replace(tmp, dest)
            return "ok"
        except urllib.error.HTTPError as e:
            last_err = f"HTTP {e.code}"
            if 400 <= e.code < 500:
                break  # permanent: retrying a 404 will not help
        except Exception as e:  # URLError, timeout, OSError
            last_err = str(e)
        if attempt < retries - 1:  # no useless sleep after the last try
            time.sleep(min(2.0**attempt, 8.0))
    if os.path.exists(tmp):
        os.remove(tmp)
    return last_err


def fetch_corpus(
    index_path: str,
    outdir: str,
    base_url: str = DEFAULT_BASE_URL,
    workers: int = 16,
    limit: int = 0,
    progress_every: int = 1000,
    retries: int = 3,
):
    """Returns (n_ok, n_skipped, failures: {name: reason})."""
    names = read_index(index_path, limit)
    os.makedirs(outdir, exist_ok=True)
    # Sweep .part debris from killed runs (their pids/threads are gone;
    # completed files were renamed away from these names atomically).
    import glob as _glob

    for stale in _glob.glob(os.path.join(outdir, "*.part.*")):
        try:
            os.remove(stale)
        except OSError:
            pass
    n_ok = n_skip = 0
    failures = {}
    done = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futs = {
            pool.submit(fetch_one, n, outdir, base_url, retries): n for n in names
        }
        for fut in as_completed(futs):
            name, result = futs[fut], fut.result()
            if result == "ok":
                n_ok += 1
            elif result == "skipped":
                n_skip += 1
            else:
                failures[name] = result
            done += 1
            if progress_every and done % progress_every == 0:
                rate = done / (time.perf_counter() - t0)
                print(
                    f"[fetch] {done}/{len(names)} ({rate:.0f}/s) "
                    f"ok={n_ok} skipped={n_skip} failed={len(failures)}",
                    flush=True,
                )
    manifest = os.path.join(outdir, ".fetch_failures.txt")
    if failures:
        with open(manifest, "w") as f:
            for name, reason in sorted(failures.items()):
                f.write(f"{name}\t{reason}\n")
    elif os.path.exists(manifest):
        os.remove(manifest)
    return n_ok, n_skip, failures


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--index", required=True, help="index.txt of AFDB filenames")
    p.add_argument("--outdir", required=True, help="destination pdbs/ directory")
    p.add_argument("--base_url", default=DEFAULT_BASE_URL)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--limit", type=int, default=0, help="fetch only the first N")
    p.add_argument("--retries", type=int, default=3)
    args = p.parse_args(argv)

    n_ok, n_skip, failures = fetch_corpus(
        args.index, args.outdir, args.base_url, args.workers, args.limit,
        retries=args.retries,
    )
    print(
        f"[fetch] done: ok={n_ok} skipped={n_skip} failed={len(failures)}"
        + (f" (see {args.outdir}/.fetch_failures.txt; re-run to retry)"
           if failures else ""),
        flush=True,
    )
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
