"""Readings for the limits of a cell's comparison: the program's numbers over
many seeds, the control's (the reference in the program's place, in TF32),
and each planted fault's, in one process so that set-up is paid once.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 [--seconds 3]

runs the program on each of --seeds, then on each of --control-seeds the
control (the reference in the program's place, in TF32) and, unless
--no-faults, the program with each fault of portbench/faults.py planted, and prints one JSON line a
run with the numbers compared and the run's `correct` (against the cell's
limits file). The benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-faults", action="store_true", help="the control alone on --control-seeds")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    import torch

    # One host thread for the CPU side of torch: idle intra-op workers
    # spinning beside the launching threads made step times swing.
    torch.set_num_threads(1)
    from portbench import faults
    from portbench.harness import registry, runner

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = registry.find_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    kinds = faults.TRAINING if cell.traffic["generator"] == "train" else faults.SAMPLING
    runs = [("port", "none", s) for s in seeds] + [("control", "none", s) for s in control] + \
        [("port", f, s) for f in ([] if args.no_faults else kinds) for s in control]
    for program, fault, seed in runs:
        t = time.perf_counter()
        with faults.planted(cell.traffic["generator"], fault):
            out = runner.run(cell, seed, args.seconds, False, device, t, program=program)
        print(json.dumps({"cell": cell.name, "program": program, "fault": fault, "seed": seed,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "readings": {k: c["value"] for k, c in out["checks"].items()},
                          "detail": out.get("detail"),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
