#!/usr/bin/env python3
"""A/B of two checkouts of the repository on one card, in turns A B B A.

For each turn, in a process of its own whose genie2_tpu_torch is the
checkout's (its kernels built into that checkout's build/): the square
kernels at B=2, N=256, fp32 (the TriMul projection, both contraction
directions, the epilogue, its partial stage on H_r=64 of the hidden
channels and its finish stage on two such ranks' sums, contract_cm_km, the
IPA core, triangle attention; ms a call between CUDA events, chip_smoke.py's
inputs), the device-only ms a call of the epilogue and its two stages
(torch.profiler's device events: CUDA events around a loop of Python calls
can time the host's issue rate instead) and chip_smoke.py's row-block cases
(`row_block_cases`, forward and backward),
then the checkout's own tools/torch_profile_step.py for a reverse step
(L=256, B=2) and a training step (`--train`: L=256, batch 4), their wall
and device ms. Prints one JSON line a turn and, last, the medians of each
checkout and the spread of its two turns.

    python3 tools/torch_ab.py PARENT_DIR CHANGE_DIR

Needs a CUDA card; imports torch and genie2_tpu_torch only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

OWN_CHIP_SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


def kernel_times(tree: str) -> dict:
    """ms a call of each square kernel of the checkout `tree`."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from genie2_tpu_torch.ops import build, ipa, tri_att, trimul

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N = 2, 256
    w = cs.random_trimul_weights(cs.C_P, cs.H_MUL, gen, dev)
    res_mask = (torch.arange(N, device=dev) < N - 24).float().expand(B, N).contiguous()
    z = torch.randn(B, N, N, cs.C_P, generator=gen, device=dev)
    a, b = trimul.project_gated_cm_plain(z, res_mask, w)
    x = trimul.contract_cm_plain(a, b, True)
    ipa_args = cs.random_ipa_inputs(B, N, z, res_mask, gen)
    ta_args = cs.random_tri_att_inputs(B, N, torch.float32, gen, dev)
    # The epilogue's two stages as two model ranks run them: rank 0's
    # partial sums over half the hidden channels, the finish on both ranks'.
    halves = [(x[:, hs].contiguous(), w["w_z"][:, hs].contiguous(), w["ln_out_scale"][hs], w["ln_out_bias"][hs])
              for hs in (slice(0, cs.H_MUL // 2), slice(cs.H_MUL // 2, cs.H_MUL))]
    part = sum(trimul.epilogue_partial_plain(*h) for h in halves)
    cases = {
        "trimul_project": lambda: trimul.project_gated_cm(z, res_mask, w),
        "trimul_contract_out": lambda: trimul.contract_cm(a, b, True),
        "trimul_contract_in": lambda: trimul.contract_cm(a, b, False),
        "trimul_epilogue": lambda: trimul.epilogue_cm(x, z, w),
        "trimul_epilogue_partial": lambda: trimul.epilogue_partial(*halves[0]),
        "trimul_epilogue_finish": lambda: trimul.epilogue_finish(part, z, w, cs.H_MUL),
        "contract_cm_km": lambda: trimul.contract_cm_km(a, b),
        "ipa_attention": lambda: ipa.ipa_attention(*ipa_args),
        "tri_attention": lambda: tri_att.tri_attention(*ta_args),
    }
    with torch.no_grad():
        out = {name: cs.cuda_time_ms(fn, iters=50, warmup=5) for name, fn in cases.items()}
        for name in ("trimul_epilogue", "trimul_epilogue_partial", "trimul_epilogue_finish"):
            out[f"device_{name}"] = device_ms(cases[name])
    # The row-block cases of chip_smoke.py's kernels phase, forward and
    # backward, with its iteration counts, so that their spread across
    # turns reads on the numbers that the phase reports.
    for case in cs.row_block_cases(z, res_mask, w, ipa_args, ta_args, gen):
        name, rows, kern, _, inputs, cots = case[:6]
        with torch.no_grad():
            out[f"rows_{name}_{rows}"] = cs.cuda_time_ms(kern)
        if inputs:
            out_k = kern()
            out_k = out_k if isinstance(out_k, tuple) else (out_k,)
            out[f"rows_{name}_{rows}_backward"] = cs.cuda_time_ms(
                lambda: torch.autograd.grad(out_k, inputs, cots, retain_graph=True), iters=10, warmup=2)
    return out


def device_ms(fn, iters: int = 50) -> float:
    """Device ms a call of `fn`: the summed time of the device events
    (kernels and copies) of `iters` calls under torch.profiler, over
    `iters`. The events come from this tool's own checkout's chip_smoke.py,
    so that both trees are measured alike."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", OWN_CHIP_SMOKE)
    own = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(own)
    return sum(e.time_range.elapsed_us() for e in own.device_events(fn, iters=iters, warmup=5)) / iters / 1e3


def step_times(tree: str) -> dict:
    """Wall and device ms of a reverse step and of a training step, from the
    checkout's own profile tool."""
    out = {}
    for label, flags in (("reverse", ["--length", "256", "--batch", "2", "--quat", "eigh"]), ("train", ["--train"])):
        proc = subprocess.run([sys.executable, os.path.join(tree, "tools", "torch_profile_step.py"), *flags],
                              cwd=tree, capture_output=True, text=True, check=True, timeout=900)
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        out[label] = {k: rec[k] for k in ("wall_ms_per_step", "device_ms_per_step")}
    return out


def turn(tree: str) -> dict:
    return {"tree": tree, "kernels_ms": kernel_times(tree), "steps": step_times(tree)}


def main(argv) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(turn(os.path.abspath(argv[1]))), flush=True)
        return 0
    parent, change = (os.path.abspath(p) for p in argv[:2])
    runs = []
    for label, tree in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", tree], cwd=tree,
                              capture_output=True, text=True, check=True, timeout=1800)
        rec = {"label": label, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for label in ("parent", "change"):
        mine = [r for r in runs if r["label"] == label]
        flat = [{**{f"kernel_{k}": v for k, v in r["kernels_ms"].items()},
                 **{f"{s}_{k}": v for s, d in r["steps"].items() for k, v in d.items()}} for r in mine]
        summary[label] = {k: sorted(f[k] for f in flat) for k in flat[0]}
    print(json.dumps({"ab": summary, "order": [r["label"] for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
