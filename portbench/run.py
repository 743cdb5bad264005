"""Run one cell of the benchmark of genie2_tpu_torch on the NVIDIA GPU of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the result
(JSON): the cell's end-to-end metrics with --trace 0, its per-layer metrics
with --trace 1, `correct` from the comparison with the plain reference, and
each number compared beside its limit under "checks"; the same numbers are
the last lines of standard error. A run on a machine without a CUDA card, or
with fewer cards than the cell asks for, prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line(torch) -> str:
    """The card's name and power limit, and the number of cards."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        out = f"{torch.cuda.get_device_name(0)}, power limit unread ({exc})"
    return f"# card: {out}; {torch.cuda.device_count()} device(s) visible"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "genie2_tpu_torch")):
        print(f"no genie2_tpu_torch beside {os.path.join(ROOT, 'portbench')}: nothing to measure", file=sys.stderr)
        return 4
    # Every build and kernel cache of the program at a fixed path inside the
    # checkout (its CUDA kernels already build into build/kernels there).
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    sys.path.insert(0, ROOT)

    import torch

    # One host thread for the CPU side of torch: idle intra-op workers
    # spinning beside the launching threads made step times swing.
    torch.set_num_threads(1)
    from portbench.harness import registry, runner

    cell = registry.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line = card_line(torch)
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = runner.banned_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures genie2_tpu_torch alone", file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
