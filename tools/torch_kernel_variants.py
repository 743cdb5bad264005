#!/usr/bin/env python3
"""Time variants of genie2_tpu_torch's tensor-core kernels on the card.

Each variant is a copy of genie2_tpu_torch/csrc with text substitutions,
built with the port's own nvcc flags into build/variants/<name>/ and
swapped in for the wrapper's library. For float32 and bf16 at the main
path's shapes (B=2, N=256, C=H=128; the TriMul epilogue's partial stage
on H_r=64 of the hidden channels, its finish stage on two such ranks'
sums; triangle attention H=4, c=32; the IPA core H=12, C=16, Pq=4, Pv=8,
Cz=128) it prints one JSON line per variant:
the error against the plain version relative to max |plain|, the kernel's
device time per launch (torch.profiler) and the wrapper's time between CUDA
events, the HMMA count of the library and, for a variant marked "phases"
(whose substitutions make block 0 write clock64() phase totals to the
first values of its (first) output), those cycle counts. A variant that
changes what the kernel computes is a measurement, not a candidate: its
error says so.

    python3 tools/torch_kernel_variants.py tools/torch_kernel_variants.json [--only NAME,NAME,...]

Needs a CUDA card and nvcc; imports torch and genie2_tpu_torch only.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# The kernel function of each source, as the profiler names it.
KERNEL_NAME = {"trimul_project": "project_kernel", "trimul_contract": "contract_kernel",
               "trimul_epilogue": "epilogue_", "tri_att_flash": "tri_att_kernel",
               "ipa_attention": "ipa_kernel", "triangle_contract": "contract_kernel"}


def build_variants(variants, build):
    """{name: library path} of the variants that compiled."""
    nvcc = build.find_nvcc()
    procs = {}
    for name, v in variants.items():
        d = os.path.join(REPO, "build", "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, d)
        for fname, old, new in v.get("subs", []):
            path = os.path.join(d, fname)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace occurs {text.count(old)} times in {fname}: {old!r}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new))
        lib = os.path.join(d, v["source"] + ".so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", lib, os.path.join(d, v["source"] + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": out[-2000:]}), flush=True)
        else:
            built[name] = lib
    return built


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if len(argv) == 3 and argv[1] == "--only":
        only = set(argv[2].split(","))
        argv = argv[:1]
    if len(argv) != 1:
        raise SystemExit(__doc__)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from genie2_tpu_torch.ops import build, ipa, tri_att, triangle, trimul

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(argv[0]) as fh:
        variants = {k: v for k, v in json.load(fh).items() if not k.startswith("_") and (only is None or k in only)}
    if only is not None and set(variants) != only:
        raise SystemExit(f"no such variants: {sorted(only - set(variants))}")
    libs = build_variants(variants, build)
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")

    def device_ms(fn, key, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA and key in e.name]
        return sum(us) / iters / 1e3

    def event_ms(fn, iters=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, N, C, H = 2, 256, 128, 128

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=dev)

    w = {f"w_{k}": r(H, C, scale=C ** -0.5) for k in ("ap", "ag", "bp", "bg")}
    w.update({f"b_{k}": r(H, scale=0.1) for k in ("ap", "ag", "bp", "bg")})
    w.update(ln_in_scale=r(C, scale=0.1, offset=1.0), ln_in_bias=r(C, scale=0.1),
             ln_out_scale=r(H, scale=0.1, offset=1.0), ln_out_bias=r(H, scale=0.1),
             w_z=r(C, H, scale=H ** -0.5), b_z=r(C, scale=0.1), w_g=r(C, C, scale=C ** -0.5), b_g=r(C, scale=0.1))
    mask = (torch.arange(N, device=dev) < N - 24).float().expand(B, N).contiguous()
    z32 = r(B, N, N, C)
    data = {}
    for dtype in (torch.float32, torch.bfloat16):
        z = z32.to(dtype)
        a, b = trimul.project_gated_cm_plain(z, mask, w)
        # Triangle attention: a padded tail of keys, as the sampler's buckets have.
        qkv = [r(B, N, N, 4, 32).to(dtype) for _ in range(3)]
        att = (*qkv, r(B, 4, N, N).to(dtype), mask[:, :, None] * mask[:, None, :])
        # The IPA core at full width (H=12, C=16, Pq=4, Pv=8, Cz=128), k and
        # v as strided halves of one projection and the points as views, as
        # nn/structure.py passes them.
        kv = r(B, N, 12, 32).to(dtype)
        kv_pts = (3 * r(B, N, 12, 12, 3)).to(dtype)
        ipa_args = (r(B, N, 12, 16).to(dtype), kv[..., :16], kv[..., 16:], (3 * r(B, N, 12, 4, 3)).to(dtype),
                    kv_pts[..., :4, :], kv_pts[..., 4:, :], r(B, N, N, 12).to(dtype), z,
                    r(12).abs() + 0.5, mask)
        data[dtype] = (z, a, b, trimul.contract_cm_plain(a, b, True), att, ipa_args)

    def cases(source, dname, z, a, b, x, att, ipa_args):
        """{case: (kernel, plain)} of one source and dtype."""
        if source == "trimul_project":
            return {dname: (lambda: trimul.project_gated_cm(z, mask, w), lambda: trimul.project_gated_cm_plain(z, mask, w))}
        if source == "trimul_contract":
            return {f"{dname}_{'out' if o else 'in'}": (lambda o=o: trimul.contract_cm(a, b, o),
                                                         lambda o=o: trimul.contract_cm_plain(a, b, o))
                    for o in (True, False)}
        if source == "trimul_epilogue":
            # The split modes as two model ranks run them: rank 0's partial
            # sums over half the hidden channels, the finish on both ranks'.
            halves = [(x[:, hs].contiguous(), w["w_z"][:, hs], w["ln_out_scale"][hs], w["ln_out_bias"][hs])
                      for hs in (slice(0, H // 2), slice(H // 2, H))]
            part = sum(trimul.epilogue_partial_plain(*hv) for hv in halves)
            finish_w = [w[k] for k in trimul.FINISH_PARAMS]
            return {dname: (lambda: trimul.epilogue_cm(x, z, w), lambda: trimul.epilogue_cm_plain(x, z, w)),
                    f"{dname}_partial": (lambda: trimul.epilogue_partial(*halves[0]),
                                         lambda: trimul.epilogue_partial_plain(*halves[0])),
                    f"{dname}_finish": (lambda: trimul.epilogue_finish(part, z, w, H),
                                        lambda: trimul.epilogue_finish_plain(part, z, *finish_w, H))}
        if source == "ipa_attention":
            return {dname: (lambda: ipa.ipa_attention(*ipa_args), lambda: ipa.ipa_attention_plain(*ipa_args))}
        if source == "triangle_contract":
            ta, tb = 0.3 * z, (0.3 * z).flip(1).contiguous()
            out = {f"{dname}_{lay}_{'out' if o else 'in'}": (
                lambda o=o, lay=lay: triangle.triangle_multiply(ta, tb, o, lay),
                lambda o=o: triangle.triangle_multiply_reference(ta, tb, o))
                for lay in triangle.LAYOUTS for o in (True, False)}
            out[f"{dname}_km"] = (lambda: trimul.contract_cm_km(a, b), lambda: trimul.contract_cm_km_plain(a, b))
            return out
        return {dname: (lambda: tri_att.tri_attention(*att), lambda: tri_att.tri_attention_plain(*att))}

    for name, lib in libs.items():
        v = variants[name]
        source = v["source"]
        build.override(source, lib)
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
        rec = {"variant": name, "HMMA": sass.count("HMMA")}
        for dtype, inputs in data.items():
            dname = str(dtype).split(".")[-1]
            for key, (kern, plain) in cases(source, dname, *inputs).items():
                try:
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
                    rel = max(((g.float() - p.float()).abs().max() / p.float().abs().max()).item()
                              for g, p in zip(got, want))
                    rec[key] = {"rel_err": rel, "device_ms": device_ms(kern, KERNEL_NAME[source]),
                                "wrapper_ms": event_ms(kern)}
                    if v.get("phases"):
                        rec[key]["phase_cycles"] = got[0].flatten()[:9].float().tolist()
                except RuntimeError as exc:
                    rec[key] = {"failed": str(exc)}
        build.override(source, None)
        print(json.dumps(rec), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)


if __name__ == "__main__":
    main()
