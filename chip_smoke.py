#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (genie2_tpu_torch) on one card.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device    print the card's name and power limit, require CUDA, build
               the kernels from genie2_tpu_torch/csrc with nvcc, count the
               tensor-core instructions (HMMA, HGMMA) in each built library
               (cuobjdump -sass) and require them in every product kernel
               (TENSOR_CORE);
  2. kernels   each kernel (three TriMul stages and the epilogue's partial
               and finish modes on half the hidden channels, two ranks'
               partial sums through the finish against the one-launch
               epilogue, the IPA attention core on
               strided inputs as nn/structure.py passes them, the three
               standalone triangle contractions, the triangle attention
               core, the pair transition in float32) against its plain
               PyTorch version on the card, float32
               and bfloat16, at N=256 and the ragged N=224 with B=2 and at
               the tds phase's N=75 with B=4, and the epilogue's two
               stages at their edges (SPLIT_EDGES, float32 and bf16
               weights) and as device kernels a wrapper call under bf16
               weights (one each, as the one-launch epilogue); times of the
               kernel, the plain version and a library call; at N=256 the
               row-block cases of sequence parallelism (I=128 rows of
               N=256, the incoming partial sums over K=128, the IPA's and
               the ending node's I queries against N keys), forward and
               gradient against the plain versions, timed beside a library
               call where one computes the same function, with each case's
               bound (row_block_bytes_ops); then each
               autograd Function's gradients (every input, one seeded
               cotangent) against autograd of the plain version, and the
               time of each backward beside its forward; the projection's
               and the epilogue's backward kernels a call at B=2 and 4
               (with and without the weights' gradients, and padded)
               beside their bounds, the plain backward and the recomputed
               one, the epilogue's held against its closed form
               (epilogue_cm_backward_plain); the pair transition a call at
               B=2 and 4 beside its bound, its plain version and torch's
               two addmm calls;
  3. denoiser  one full-width denoiser call at L=256 with the kernels, then
               with the plain versions swapped in, compared on z; then the
               gradient of sum(z . r) with respect to the translations
               (Frenet frames, eigh quaternions), kernels against plain;
               once for configs/example.configuration and once for the same
               configuration with triangle attention in its pair layers;
               and how often eigh's own backward meets a tied eigenvalue;
  4. main      the unconditional sampling CLI from a seeded Lightning-style
               checkpoint: 1000 steps at L=256 and L=200, PDBs checked,
               kernel launches counted; then the same weights as a
               reference Lightning checkpoint that pickles other objects:
               refused by the weights-only loader (the converter named),
               converted by cli/convert_checkpoint.py, and sampled from
               (DDIM-10 at L=256, launches counted), z and coordinates bit
               for bit against the tensors-only checkpoint;
  5. scaffold  the motif scaffolding CLI on a motif problem written here
               (two motif segments, total length 100-128): the 1000-step
               ancestral sampler, DDIM-50 with classifier-free guidance and
               DPM-Solver++-25; then the unconditional CLI with --pack and
               with --dump_trajectory_every at L=64; files, coordinates and
               kernel launches checked;
  6. triatt    the configuration with triangle attention as a second
               release directory: the unconditional CLI, 1000 steps at
               L=256, and the SSE-guided particle CLI, 8 particles of
               length 128, 1000 steps; PDBs, the ESS trace, the printed
               fractions and kernel launches checked;
  7. tds       TDS/SMC motif scaffolding with unknown placement through
               cli/sample_motif_smc on a MotifBench-style target written
               here (segments of 10 and 8 residues of an ideal helix,
               length 75): 4 particles, 1000 steps, up to 1000 placements,
               the gradient through the denoiser's kernels at every
               twisted step, the score proposal with its soft cap (see
               phase_tds), after single twisted steps of both proposals
               (the posterior one at step T, where its gain is largest)
               held kernels against plain; then with the rotation term and trajectory
               dumps on a 200-step copy of the release; PDBs, placement,
               manifests, the per-step trace and kernel launches (backward
               ones included) checked;
  8. train     training through cli/train.py at the full width of
               configs/example.configuration (batch 4, fp32, remat and
               dropout on) on a corpus of 32 seeded random-walk PDB files
               of length 192-256 written here: 2 epochs (epoch checkpoints
               loaded back, resume_state, finite losses, exact launch
               counts of the forward, remat's second forward and the
               backward), then --resume to a third epoch; one training
               step with the kernels against the same step with every
               plain version (loss, the whole gradient, grad_norm); one
               bf16 step; wall and device ms a step, the busy share and
               peak memory with remat on and off;
  9. parallel  data parallelism (genie2_tpu_torch/parallel), each run held
               against one process in this phase: two ranks over gloo
               sharing the card (NCCL refuses two ranks on one GPU), spawned
               after the kernels are built, take PARALLEL_TRAIN_STEPS
               training steps at the train phase's width on two rows each
               of one batch of 4 (loss and metrics, the first step's reduced
               gradient, the parameters after the last); one twisted TDS
               step from t = T on the tds phase's problem, 4 particles
               (placements, resampling decisions, coordinates; two steps,
               and one process moved by 1e-6 at x_T, reported beside it:
               with random weights a trajectory moves by angstroms from a
               change at rounding's scale); the unconditional CLI (L=256, 4
               samples, DDIM-50) against one process running the ranks'
               rows as its batches (files, coordinates; a batch of 4
               reported beside it); the TDS CLI (100 steps; trace,
               placement); launches summed over the ranks; then
               cli/train.py under torchrun as one NCCL rank for 2 epochs
               and --resume to a third, checkpoints loaded back;
 10. tp        tensor parallelism (parallel/tensor_parallel.py): two
               gloo ranks sharing the card as the model axis, held against
               the one-process runs of the denoiser and parallel phases:
               the denoiser forward at L=256, B=2, with and without
               triangle attention (z, the ranks bit for bit, the bytes
               all-reduced against `tp_volume`, the launches: the epilogue
               as its two stages), three training steps of the parallel
               phase's batch (metrics, gathered gradients, parameters),
               one twisted TDS step from t = T, the unconditional CLI with
               --mesh_model 2 (L=256, DDIM-10) against one process, and
               cli/train.py with meshModel 2 on 10 of the corpus's files
               for one epoch, its full checkpoint loaded in one process
               against the sharded model's z; then one training step on a
               (2 data x 2 model) grid of four ranks;
 11. seq       sequence parallelism (parallel/sequence_parallel.py): two
               gloo ranks sharing the card as the seq axis, each holding
               half the pair representation's rows, held against one
               process: the denoiser forward at L=256, B=2, with and without
               triangle attention (z, each rank's rows of p, the bytes
               all-reduced against `seq_volume`, the launches), at L=255
               (padded to 256) and at L=1024, B=1 (maximumNumResidues 1024;
               peak memory of each rank beside one process's), three
               training steps of the parallel phase's batch, one twisted
               TDS step from t = T (length 75, padded to 76), the
               unconditional CLI with --mesh_seq 2 (L=256, DDIM-10) and
               cli/train.py with meshSeq 2 (its checkpoint's z in one
               process); then one training step on a (2 seq x 2 model)
               grid of four ranks;
then one JSON line of the kernels and, last, the device line.

Imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# The tensor cores' dense rates: float32 as three TF32 products (495 / 3
# TFLOP/s, the kernels' 3xTF32), bf16 989 TFLOP/s.
PEAK_OPS_PER_S = {"float32": 495e12 / 3, "bfloat16": 989e12}
SEED = 0
# Tolerances, relative to max |plain|:
#   float32 1e-4: the kernels sum in another order than the plain version
#     (and cuBLAS), so results agree to a few float32 ulps per sum;
#   bfloat16 3e-2: both round to bfloat16 at the same points, but a value
#     on a rounding boundary can land one bf16 ulp (2^-8) apart.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Denoiser z, relative to max |z|: ten TriMul calls, ten triangle attention
# calls where the configuration has them and eight IPA layers carry the
# kernels' float32 summation-order differences forward.
DENOISER_TOL = 1e-3
TDS_LENGTH, TDS_PARTICLES, TDS_SEGMENTS = 75, 4, (10, 8)  # the tds phase's problem
C_P = 128  # configs/example.configuration pairFeatureDimension
H_MUL = 128  # triangularMultiplicativeHiddenDimension (default)
# IPA widths of configs/example.configuration: heads, hidden, qk and v points.
IPA = {"H": 12, "C": 16, "PQ": 4, "PV": 8}
# Triangle attention widths (the configuration's defaults): heads, head width.
TRI_ATT = {"H": 4, "c": 32}
TRANSITION_N = 4  # pairTransitionN (default): the transition's hidden width is 4 C_P
# The second configuration: the example file with triangle attention on.
TRI_ATT_LINE = "includeTriangularAttention True\n"

KERNELS = [
    {
        "name": "trimul_project",
        "source": "genie2_tpu_torch/csrc/trimul_project.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:125",
    },
    {
        "name": "trimul_contract",
        "source": "genie2_tpu_torch/csrc/trimul_contract.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:185",
    },
    {
        "name": "trimul_epilogue",
        "source": "genie2_tpu_torch/csrc/trimul_epilogue.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:279",
    },
    # The epilogue's two stages around the all-reduce of tensor parallelism
    # (the same source, other modes of its kernel).
    {
        "name": "trimul_epilogue_partial",
        "source": "genie2_tpu_torch/csrc/trimul_epilogue.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:279",
    },
    {
        "name": "trimul_epilogue_finish",
        "source": "genie2_tpu_torch/csrc/trimul_epilogue.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:279",
    },
    {
        "name": "ipa_attention",
        "source": "genie2_tpu_torch/csrc/ipa_attention.cu",
        "replaces": "genie2_tpu/ops/ipa_fused.py:232",
    },
    # The three standalone contractions: no module calls them (as in
    # genie2_tpu), so their launches are those of the kernels phase.
    {
        "name": "triangle_multiply_cm",
        "source": "genie2_tpu_torch/csrc/triangle_contract.cu",
        "replaces": "genie2_tpu/ops/triangle.py:75",
    },
    {
        "name": "triangle_multiply_nlayout",
        "source": "genie2_tpu_torch/csrc/triangle_contract.cu",
        "replaces": "genie2_tpu/ops/triangle.py:144",
    },
    {
        "name": "contract_cm_km",
        "source": "genie2_tpu_torch/csrc/triangle_contract.cu",
        "replaces": "genie2_tpu/ops/trimul_fused.py:213",
    },
    # No TPU kernel: genie2_tpu leaves the transition to XLA. float32 at
    # C = 128 (the configurations); bf16 runs torch's products.
    {
        "name": "pair_transition",
        "source": "genie2_tpu_torch/csrc/pair_transition.cu",
        "replaces": "none (genie2_tpu/nn/pair_stack.py PairTransition, on XLA)",
    },
    # On the path of the configuration with triangle attention only.
    {
        "name": "tri_attention",
        "source": "genie2_tpu_torch/csrc/tri_att_flash.cu",
        "replaces": "genie2_tpu/ops/tri_att_flash.py:162",
    },
]
OFF_PATH = ("triangle_multiply_cm", "triangle_multiply_nlayout")
# The epilogue's stages around the all-reduce: on the path of a model axis only.
SPLIT_EPILOGUE = ("trimul_epilogue_partial", "trimul_epilogue_finish")
# Kernels whose work is a per-channel contraction of [B, C, N, N] operands.
CONTRACTIONS = (*OFF_PATH, "contract_cm_km")
# How each kernel wrapper's autograd Function takes its backward (ops/).
BACKWARD_ROUTE = {
    "trimul_project": "CUDA: trimul_project_backward for float32 (bfloat16: gradient of the plain version, recomputed)",
    "trimul_contract": "CUDA: contract_cm_km and trimul_contract (four contractions)",
    "trimul_epilogue": "CUDA: trimul_epilogue_backward for float32 (bfloat16: gradient of the plain version, recomputed)",
    "trimul_epilogue_partial": "gradient of the plain version, recomputed",
    "trimul_epilogue_finish": "gradient of the plain version, recomputed",
    "ipa_attention": "gradient of the plain version, recomputed",
    "tri_attention": "gradient of the plain version, recomputed",
    "pair_transition": "gradient of the plain version, recomputed",
}
# Kernels whose products must run on the tensor cores: all eleven (the IPA
# core's o_pair product among them; the epilogue's modes share its library).
TENSOR_CORE = tuple(k["name"] for k in KERNELS)


class PhaseFailed(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts():
    """Every counter of the program back to 0 (utils/profiling.py)."""
    from genie2_tpu_torch.utils import profiling

    profiling.reset()


def launch_counts() -> dict:
    """{kernel: launches} since the last reset_counts(): the program's
    `launch.<kernel>` counters, every kernel wrapper's module imported."""
    from genie2_tpu_torch.ops import ipa, transition, tri_att, triangle, trimul  # noqa: F401, their counters
    from genie2_tpu_torch.utils.profiling import counters

    return {k[len("launch."):]: v for k, v in counters().items() if k.startswith("launch.")}


def allreduce_bytes(axis: str) -> dict:
    """{direction: bytes} all-reduced over the `axis` ("tp" or "seq")
    group since the last reset_counts()."""
    from genie2_tpu_torch.parallel import sequence_parallel, tensor_parallel  # noqa: F401, their counters
    from genie2_tpu_torch.utils.profiling import counters

    snap = counters()
    return {d: snap[f"allreduce_bytes.{axis}.{d}"] for d in ("forward", "backward")}


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int = 1, warmup: int = 1) -> list:
    """torch.profiler's device events (kernels and copies) of `iters` calls
    of `fn` on the card, after `warmup` calls (the build and the launch
    attributes). The program's spans (genie2:*), which the device timeline
    shows too, are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.name.startswith("genie2:")]


# ------------------------------------------------------------------ #
# Phase 1
# ------------------------------------------------------------------ #


def phase_device(state):
    import torch

    line = nvidia_smi_line()
    print(line, flush=True)
    state["smi"] = line
    if not torch.cuda.is_available():
        raise PhaseFailed("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from genie2_tpu_torch.ops import build

    t0 = time.perf_counter()
    per_source = build.build_all(verbose=True)
    emit({
        "phase": "device", "device": torch.cuda.get_device_name(0), "smi": line,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": time.perf_counter() - t0, "build_s_per_source": per_source,
    })
    counts = tensor_core_instructions(build)
    state["sass"] = counts
    emit({"phase": "device", "tensor_core_instructions": counts})
    missing = [name for name in TENSOR_CORE if not sum(counts[name].values())]
    if missing:
        raise PhaseFailed(f"no HMMA / HGMMA instruction in {missing}")


def tensor_core_instructions(build):
    """{kernel: {"HMMA": n, "HGMMA": m}}: the tensor-core instructions in
    the built library of each kernel's source (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    source_of = {k["name"]: os.path.splitext(os.path.basename(k["source"]))[0] for k in KERNELS}
    # One cuobjdump a library (several kernels share one), all at once.
    procs = {src: subprocess.Popen([cuobjdump, "-sass", build.library_path(src)], stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True) for src in sorted(set(source_of.values()))}
    sass = {}
    try:
        for src, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise subprocess.CalledProcessError(proc.returncode, proc.args, out, err)
            sass[src] = out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: {op: len(re.findall(rf"\b{op}\b", sass[src])) for op in ("HMMA", "HGMMA")}
            for name, src in source_of.items()}


# ------------------------------------------------------------------ #
# Phase 2
# ------------------------------------------------------------------ #


def random_trimul_weights(C: int, H: int, gen, device):
    """Random non-zero weights in torch layout (see ops/trimul.py)."""
    import torch

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    return {
        "ln_in_scale": r(C, scale=0.1, offset=1.0), "ln_in_bias": r(C, scale=0.1),
        "w_ap": r(H, C, scale=C ** -0.5), "b_ap": r(H, scale=0.1),
        "w_ag": r(H, C, scale=C ** -0.5), "b_ag": r(H, scale=0.1),
        "w_bp": r(H, C, scale=C ** -0.5), "b_bp": r(H, scale=0.1),
        "w_bg": r(H, C, scale=C ** -0.5), "b_bg": r(H, scale=0.1),
        "ln_out_scale": r(H, scale=0.1, offset=1.0), "ln_out_bias": r(H, scale=0.1),
        "w_z": r(C, H, scale=H ** -0.5), "b_z": r(C, scale=0.1),
        "w_g": r(C, C, scale=C ** -0.5), "b_g": r(C, scale=0.1),
    }


def random_transition_weights(C: int, H: int, gen, device):
    """The pair transition's ln_w, ln_b, w1, b1, w2, b2 (ops/transition.py)."""
    import torch

    def r(*shape, scale=1.0, offset=0.0):
        return offset + scale * torch.randn(*shape, generator=gen, device=device)

    return [r(C, scale=0.1, offset=1.0), r(C, scale=0.1), r(H, C, scale=C ** -0.5), r(H, scale=0.1),
            r(C, H, scale=H ** -0.5), r(C, scale=0.1)]


def transition_addmm(z, tw):
    """A yardstick only: torch's two addmm calls of the transition's products
    (no LayerNorm, ReLU or mask), on z's rows."""
    import torch

    x = z.reshape(-1, z.shape[-1])
    return lambda: torch.addmm(tw[5], torch.addmm(tw[3], x, tw[2].t()), tw[4].t())


def random_ipa_inputs(B, N, z, res_mask, gen):
    """The IPA core's arguments at full width (ops/ipa.py), in z's dtype, as
    nn/structure.py hands them over: k and v the halves of one projection,
    the k and v points the parts of one tensor."""
    import torch

    h, c, pq, pv = IPA["H"], IPA["C"], IPA["PQ"], IPA["PV"]
    dev, dt = z.device, z.dtype

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(dt)

    head_weights = torch.randn(h, generator=gen, device=dev).abs() + 0.5
    kv, kv_pts = r(B, N, h, 2 * c), r(B, N, h, pq + pv, 3, scale=3.0)
    return (r(B, N, h, c), kv[..., :c], kv[..., c:], r(B, N, h, pq, 3, scale=3.0), kv_pts[..., :pq, :],
            kv_pts[..., pq:, :], r(B, N, N, h), z, head_weights, res_mask)


def random_tri_att_inputs(B, N, dtype, gen, device):
    """The triangle attention core's arguments at full width (ops/tri_att.py):
    a padded tail of keys in every row and, in the last sample, rows whose
    keys are all padded."""
    import torch

    h, c = TRI_ATT["H"], TRI_ATT["c"]
    q, k, v = ((torch.randn(B, N, N, h, c, generator=gen, device=device)).to(dtype) for _ in range(3))
    tb = torch.randn(B, h, N, N, generator=gen, device=device).to(dtype)
    res = (torch.arange(N, device=device) < N - 24).float().expand(B, N).clone()
    res[-1, N - 40:] = 0.0
    return q, k, v, tb, res[:, :, None] * res[:, None, :]


def sdpa_tri_attention(q, k, v, tb, mask, inf=1e9):
    """The same function as one library call, timed only: rows become batch
    entries and both biases one materialised attn_mask [B*I, H, J, J]."""
    import torch

    B, I, J, H, c = q.shape  # J queries; the keys are k's own (all N in a row-block case)
    heads = lambda t: t.permute(0, 1, 3, 2, 4).reshape(B * I, H, -1, c)
    bias = (tb[:, None].float() + inf * (mask.float()[:, :, None, None, :] - 1.0)).to(q.dtype).reshape(B * I, H, J, -1)
    qh, kh, vh = heads(q), heads(k), heads(v)
    return lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)


def kernel_bytes_ops(name, B, N, C, H, esize, pairs=None):
    """Bytes each kernel must move (inputs read once, outputs written once)
    and the multiply-adds it does, counted as 2 operations each; `pairs`
    the (row, column) pairs of an elementwise-in-pairs kernel where they
    are not B N^2 (a row block)."""
    pair = B * N * N if pairs is None else pairs
    if name == "trimul_project":
        w = 4 * (4 * H * C + 4 * H + 2 * C)
        return pair * C * esize + B * N * 4 + w + 2 * pair * H * esize, 2 * pair * C * 4 * H
    if name == "trimul_contract":
        return 3 * B * H * N * N * esize, 2 * B * H * N ** 3
    if name in CONTRACTIONS:  # a, b read, out written: [B, C, N, N] each
        return 3 * B * C * N * N * esize, 2 * B * C * N ** 3
    if name == "ipa_attention":
        h, c, pq, pv = IPA["H"], IPA["C"], IPA["PQ"], IPA["PV"]
        rows = B * N * h * (3 * c + 6 * pq + 3 * pv)  # q, k, v, q_pts, k_pts, v_pts
        outs = B * N * h * (c + 3 * pv + C)
        bytes_ = esize * (pair * C + pair * h + rows + outs) + 4 * B * N + 4 * h
        # Every key is computed, masked or not: q.k, the point distances, p.v, p.v_pts, p.z.
        return bytes_, 2 * B * h * N * N * (2 * c + 3 * pq + 3 * pv + C)
    if name == "trimul_epilogue_partial":  # H: this rank's channels; D = C
        part = 4 * (pair * (C + 2) + 2 * C)
        return pair * H * esize + 4 * (C * H + 2 * H) + part, 2 * pair * H * (C + 1)
    if name == "trimul_epilogue_finish":  # the reduced partial sums, z -> out
        part = 4 * (pair * (C + 2) + 2 * C)
        return part + 2 * pair * C * esize + 4 * (C * C + 5 * C), 2 * pair * C * C
    if name == "pair_transition":  # H: the hidden width; z and the pair mask in, out out, the weights
        w = 4 * (2 * C * H + H + 3 * C)
        return 2 * pair * C * esize + 4 * pair + w, 2 * 2 * pair * C * H
    if name == "tri_attention":
        h, c = TRI_ATT["H"], TRI_ATT["c"]
        # q, k, v read and o written, the triangle bias, the float32 mask;
        # every key is computed, masked or not: q.k and p.v per (row, query, key).
        return esize * (4 * pair * h * c + B * h * N * N) + 4 * pair, 2 * B * h * N ** 3 * 2 * c
    w = 4 * (H * C + C * C + 5 * C)
    return pair * H * esize + pair * C * esize + w + pair * C * esize, 2 * pair * (H * C + C * C)


def row_block_bytes_ops(name, case, B, N, I, C, H, esize):
    """`kernel_bytes_ops` for a row-block case (`row_block_cases`): I of
    the N rows, or I query positions, against all N keys or columns; the
    incoming partial sums contract over I rows of k into the whole N x N;
    contract_cm_km at (I, J, K) = (I, N, N). H is the case's hidden width."""
    rows = B * I * N
    if name == "trimul_project":  # I rows of z and of the row mask, the whole column mask
        w = 4 * (4 * H * C + 4 * H + 2 * C)
        return rows * C * esize + 4 * B * (I + N) + w + 2 * rows * H * esize, 2 * rows * C * 4 * H
    if name in ("trimul_contract", "contract_cm_km"):
        # outgoing: I rows of a, all of b, I rows out; incoming: I rows of k
        # of a and b, N x N out; contract_cm_km: dx [I, K], b [J, K], [I, J] out.
        return esize * B * H * (2 * I * N + N * N), 2 * B * H * I * N * N
    if name == "ipa_attention":  # I query rows against N keys
        h, c, pq, pv = IPA["H"], IPA["C"], IPA["PQ"], IPA["PV"]
        queries, keys = B * I * h * (c + 3 * pq), B * N * h * (2 * c + 3 * pq + 3 * pv)
        outs = B * I * h * (c + 3 * pv + C)
        bytes_ = esize * (rows * C + rows * h + queries + keys + outs) + 4 * B * N + 4 * h
        return bytes_, 2 * B * h * I * N * (2 * c + 3 * pq + 3 * pv + C)
    if name == "tri_attention":  # the ending node: every row, I queries against N keys
        h, c = TRI_ATT["H"], TRI_ATT["c"]
        bytes_ = esize * (2 * B * N * I * h * c + 2 * B * N * N * h * c + B * h * I * N) + 4 * B * N * N
        return bytes_, 2 * B * N * h * I * N * 2 * c
    return kernel_bytes_ops(name, B, N, C, H, esize, pairs=rows)  # the epilogue and its stages on I rows


# (N, B) of the kernels phase: the unconditional path's bucket, a ragged one,
# and the TDS phase's length and particles (partial tiles in every kernel).
KERNEL_SHAPES = ((256, 2), (224, 2), (TDS_LENGTH, TDS_PARTICLES))


def phase_kernels(state):
    import torch

    from genie2_tpu_torch.ops import ipa, transition, tri_att, triangle, trimul

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {k["name"]: {} for k in KERNELS}
    failed, split_records = [], []
    reset_counts()
    for N, B in KERNEL_SHAPES:
        w32 = random_trimul_weights(C_P, H_MUL, gen, dev)
        # A padded tail, as the sampler's buckets have; TDS particles are
        # real rows of the problem's length.
        n_real = N if N == TDS_LENGTH else N - 24
        res_mask = (torch.arange(N, device=dev) < n_real).float().expand(B, N).contiguous()
        z32 = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            z = z32.to(dtype)
            # The bf16 policy casts the weights too (nn/policy.py).
            w = {k: v.to(dtype) for k, v in w32.items()}
            a_p, b_p = trimul.project_gated_cm_plain(z, res_mask, w)
            # A yardstick only: the projection's bare product [B N N, C] x [C, 4H].
            w4 = torch.cat([w[k] for k in ("w_ap", "w_ag", "w_bp", "w_bg")]).t().contiguous()
            bare_matmul = lambda: torch.matmul(z.reshape(-1, C_P), w4)  # noqa: E731
            cases = [
                ("trimul_project", None, lambda: trimul.project_gated_cm(z, res_mask, w),
                 lambda: trimul.project_gated_cm_plain(z, res_mask, w), None),
            ]
            for outgoing in (True, False):
                cases.append((
                    "trimul_contract", outgoing,
                    lambda o=outgoing: trimul.contract_cm(a_p, b_p, o),
                    lambda o=outgoing: trimul.contract_cm_plain(a_p, b_p, o),
                    (lambda: torch.matmul(a_p, b_p.transpose(-1, -2))) if outgoing
                    else (lambda: torch.matmul(a_p.transpose(-1, -2), b_p)),
                ))
            x_p = trimul.contract_cm_plain(a_p, b_p, True)
            cases.append(("trimul_epilogue", None, lambda: trimul.epilogue_cm(x_p, z, w),
                          lambda: trimul.epilogue_cm_plain(x_p, z, w), None))
            # The split epilogue, the hidden width over two model ranks:
            # rank 0's partial sums, and the finish stage on two ranks'
            # sums (each output held to its own scale).
            halves = split_epilogue_inputs(x_p, w)
            part_p = sum(trimul.epilogue_partial_plain(*h) for h in halves)
            finish_w = [w[k] for k in trimul.FINISH_PARAMS]
            cases.append(("trimul_epilogue_partial", None,
                          lambda: partial_parts(trimul.epilogue_partial(*halves[0]), B, N),
                          lambda: partial_parts(trimul.epilogue_partial_plain(*halves[0]), B, N), None))
            cases.append(("trimul_epilogue_finish", None, lambda: trimul.epilogue_finish(part_p, z, w, H_MUL),
                          lambda: trimul.epilogue_finish_plain(part_p, z, *finish_w, H_MUL), None))
            split_records.append(split_against_one_launch(x_p, z, w, halves, dname, N, B))
            # The IPA core at full width, the padded tail masked on the key
            # side; the plain version follows the kernel on padded rows too.
            ipa_args = random_ipa_inputs(B, N, z, res_mask, gen)
            cases.append(("ipa_attention", None, lambda: ipa.ipa_attention(*ipa_args),
                          lambda: ipa.ipa_attention_plain(*ipa_args), None))
            # The standalone contractions in the model layout [B, N, N, C].
            ta, tb = (0.3 * torch.randn(B, N, N, C_P, generator=gen, device=dev)).to(dtype), (0.3 * z32).to(dtype)
            for outgoing in (True, False):
                eq = "bikc,bjkc->bijc" if outgoing else "bkic,bkjc->bijc"
                for layout in triangle.LAYOUTS:
                    cases.append((
                        f"triangle_multiply_{layout}", outgoing,
                        lambda o=outgoing, l=layout: triangle.triangle_multiply(ta, tb, o, l),
                        lambda o=outgoing: triangle.triangle_multiply_reference(ta, tb, o),
                        lambda e=eq: torch.einsum(e, ta, tb),
                    ))
            cases.append(("contract_cm_km", None, lambda: trimul.contract_cm_km(a_p, b_p),
                          lambda: trimul.contract_cm_km_plain(a_p, b_p), lambda: torch.matmul(a_p, b_p)))
            # Triangle attention at full width; all rows are compared, the
            # fully padded ones (uniform attention) too.
            ta_args = random_tri_att_inputs(B, N, dtype, gen, dev)
            cases.append(("tri_attention", None, lambda: tri_att.tri_attention(*ta_args),
                          lambda: tri_att.tri_attention_plain(*ta_args), sdpa_tri_attention(*ta_args)))
            # The pair transition (float32 only) on the pair mask of the padded tail.
            tr_args = None
            if dtype == torch.float32:
                tw = random_transition_weights(C_P, TRANSITION_N * C_P, gen, dev)
                tr_args = (z, res_mask[:, :, None] * res_mask[:, None, :], *tw)
                cases.append(("pair_transition", None, lambda: transition.pair_transition(*tr_args),
                              lambda: transition.pair_transition_plain(*tr_args), transition_addmm(z, tw)))
            for name, outgoing, kern, plain, library in cases:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                # Each output is held to its own scale: the largest error
                # relative to max |plain| of that output.
                errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
                scales = [p.float().abs().max().item() for p in want]
                err, scale = max(errs), max(scales)
                rel = max(e / max(sc, 1e-30) for e, sc in zip(errs, scales))
                finite = all(torch.isfinite(g.float()).all().item() for g in got)
                ok = finite and rel <= TOL[dname]
                # The partial stage holds one rank's half of the hidden channels.
                H = H_MUL // 2 if name == "trimul_epilogue_partial" else \
                    TRANSITION_N * C_P if name == "pair_transition" else H_MUL
                bytes_, ops = kernel_bytes_ops(name, B, N, C_P, H, z.element_size())
                bound_bytes, bound_ops = bytes_ / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
                rec = {
                    "kernel": name, "N": N, "B": B, "H": H, "dtype": dname, "outgoing": outgoing,
                    "max_abs_err": err, "max_abs_plain": scale, "rel_err": rel, "tol": TOL[dname],
                    "ok": ok, "ms": cuda_time_ms(kern), "plain_ms": cuda_time_ms(plain),
                    "library_ms": cuda_time_ms(library) if library else None,
                    "bound_ms": max(bound_bytes, bound_ops),
                    "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
                }
                if name == "trimul_project":
                    rec["bare_matmul_ms"] = cuda_time_ms(bare_matmul)
                emit({"phase": "kernels", **rec})
                if not ok:
                    failed.append(f"{name} N={N} {dname} outgoing={outgoing}: rel {rel:.3g}")
                if N == 256 and dtype == torch.float32:
                    results[name][outgoing] = rec
            if N == ROW_BLOCK_N:
                row_failed, row_results = check_row_blocks(z, res_mask, w, ipa_args, ta_args, dname, gen)
                failed += row_failed
                if dtype == torch.float32:
                    state["kernel_rows"] = row_results
            grad_cases = gradient_cases(z, res_mask, w, a_p, b_p, x_p, ipa_args, ta_args, gen, halves, part_p,
                                        tr_args)
            for rec in check_gradients(grad_cases, dname, N, B):
                emit({"phase": "kernels", "gradient": True, **rec})
                if not rec["ok"]:
                    failed.append(f"{rec['kernel']} gradient N={N} {dname} outgoing={rec['outgoing']}: "
                                  f"rel {rec['rel_err']:.3g}")
                if N == 256 and dtype == torch.float32:
                    results[rec["kernel"]][rec["outgoing"]]["backward"] = rec
    edge_failed, state["kernels_per_call"] = check_split_edges(gen, dev)
    failed += edge_failed
    state["project_backward"] = time_project_backward(gen, dev)
    for rec in state["project_backward"]:
        emit({"phase": "kernels", "project_backward": True, **rec})
    state["transition"] = time_pair_transition(gen, dev)
    for rec in state["transition"]:
        emit({"phase": "kernels", "transition": True, **rec})
        if not rec["ok"]:
            failed.append(f"pair_transition B={rec['B']}: rel {rec['rel_err']:.3g}")
    state["epilogue_backward"] = time_epilogue_backward(gen, dev)
    for rec in state["epilogue_backward"]:
        emit({"phase": "kernels", "epilogue_backward": True, **rec})
        if not rec["ok"]:
            failed.append(f"trimul_epilogue_backward B={rec['B']} against its closed form: rel {rec['rel_err']:.3g}")
    state["kernel_main"] = results
    state["kernel_phase_launches"] = launch_counts()
    for rec in split_records:
        emit({"phase": "kernels", **rec})
        if not rec["ok"]:
            failed.append(f"split epilogue N={rec['N']} {rec['dtype']}: rel {rec['rel_err']:.3g}")
    if failed:
        raise PhaseFailed("kernel mismatch: " + "; ".join(failed))


def time_pair_transition(gen, dev) -> list:
    """The pair transition a call at N=256, C=128, H=512, float32, B=2 and 4
    (the sampling cells' batch; B=16 at N=128 is the same rows): against
    the plain version within TOL, its bound (two products, 3xTF32, against
    z and the mask in and out out), the plain version and torch's two addmm
    calls (a yardstick: the port never calls them)."""
    import torch

    from genie2_tpu_torch.ops import transition

    N, H = 256, TRANSITION_N * C_P
    recs = []
    for B in (2, 4):
        tw = random_transition_weights(C_P, H, gen, dev)
        z = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        mask = torch.ones(B, N, N, device=dev)
        with torch.no_grad():
            got, want = transition.pair_transition(z, mask, *tw), transition.pair_transition_plain(z, mask, *tw)
            rel = (got - want).abs().max().item() / want.abs().max().item()
            ms = cuda_time_ms(lambda: transition.pair_transition(z, mask, *tw))
            plain_ms = cuda_time_ms(lambda: transition.pair_transition_plain(z, mask, *tw))
            addmm_ms = cuda_time_ms(transition_addmm(z, tw))
        bytes_, ops = kernel_bytes_ops("pair_transition", B, N, C_P, H, 4)
        bound_ops, bound_bytes = ops / PEAK_OPS_PER_S["float32"] * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
        recs.append({"B": B, "N": N, "C": C_P, "H": H, "dtype": "float32", "ms": ms,
                     "bound_ms": max(bound_ops, bound_bytes),
                     "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
                     "plain_ms": plain_ms, "addmm_ms": addmm_ms, "rel_err": rel, "tol": TOL["float32"],
                     "ok": bool(torch.isfinite(got).all().item()) and rel <= TOL["float32"]})
        del z, mask, got, want
        torch.cuda.empty_cache()
    return recs


def time_project_backward(gen, dev) -> list:
    """The projection's backward kernel a call at N=256, C=H=128, float32,
    B=2 and 4 (the training step's batch): with the weights' gradients (a
    training step), dz alone (TDS's twist) and with the train cell's padding
    (lengths 20-220 padded to 256); its bound (three products, 3xTF32); the
    plain version's own backward (autograd of project_gated_cm_plain, no
    forward) and the gradient of the plain version recomputed, the
    kernel's predecessor (both with the weights' gradients)."""
    import functools

    import torch

    from genie2_tpu_torch.ops import trimul
    from genie2_tpu_torch.ops.launch import Recomputed

    N = 256
    recs = []
    for B in (2, 4):
        w = random_trimul_weights(C_P, H_MUL, gen, dev)
        z = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        mask = torch.ones(B, N, device=dev)
        lengths = [20 + (200 * k) // (B - 1) for k in range(B)]
        padded = torch.stack([(torch.arange(N, device=dev) < n).float() for n in lengths])
        da, db = (torch.randn(B, H_MUL, N, N, generator=gen, device=dev) for _ in range(2))
        with torch.no_grad():
            ms = cuda_time_ms(lambda: trimul.project_gated_cm_backward(z, mask, w, da, db), iters=10)
            dz_ms = cuda_time_ms(lambda: trimul.project_gated_cm_backward(z, mask, w, da, db, weight_grads=False),
                                 iters=10)
            padded_ms = cuda_time_ms(lambda: trimul.project_gated_cm_backward(z, padded, w, da, db), iters=10)
        leaves = [z.requires_grad_(True)] + [w[k].requires_grad_(True) for k in trimul.PROJECT_PARAMS]
        out = trimul.project_gated_cm_plain(z, mask, w)
        plain_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, (da, db), retain_graph=True), 5, 1)
        out = Recomputed.apply(functools.partial(trimul._PROJECT_KERNEL, col_mask=mask),
                               functools.partial(trimul._PROJECT_PLAIN, col_mask=mask), z, mask, *leaves[1:])
        recomputed_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, (da, db), retain_graph=True), 5, 1)
        del out
        z.requires_grad_(False)
        ops = 3 * 2 * B * N * N * C_P * 4 * H_MUL  # P recomputed, dzn, dW
        recs.append({"B": B, "N": N, "C": C_P, "H": H_MUL, "dtype": "float32", "ms": ms, "dz_only_ms": dz_ms,
                     "padded_ms": padded_ms, "padded_lengths": lengths,
                     "bound_ms": ops / PEAK_OPS_PER_S["float32"] * 1e3, "bound_by": "operations",
                     "plain_backward_ms": plain_ms, "recomputed_ms": recomputed_ms})
        torch.cuda.empty_cache()
    return recs


def time_epilogue_backward(gen, dev) -> list:
    """The epilogue's backward kernel a call at N=256, C=H=D=128, float32,
    B=2 and 4 (the training step's batch): with the weights' gradients (a
    training step), dx and dz alone (TDS's twist) and with the train cell's
    padding (x zero past lengths 20-220 of 256), each call's gradients
    against the closed form (epilogue_cm_backward_plain) within TOL
    relative to max |plain| of each; its bound (six products, 3xTF32,
    against reading x, z, dout and writing dx, dz); the plain version's own
    backward (autograd of epilogue_cm_plain, no forward) and the gradient of
    the plain version recomputed, the kernel's predecessor (both with the
    weights' gradients)."""
    import torch

    from genie2_tpu_torch.ops import trimul
    from genie2_tpu_torch.ops.launch import Recomputed

    N = 256
    recs = []
    for B in (2, 4):
        w = random_trimul_weights(C_P, H_MUL, gen, dev)
        x = torch.randn(B, H_MUL, N, N, generator=gen, device=dev)
        z = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        dout = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        lengths = [20 + (200 * k) // (B - 1) for k in range(B)]
        x_padded = x.clone()
        for row, n in enumerate(lengths):
            x_padded[row, :, n:] = 0.0
            x_padded[row, :, :, n:] = 0.0
        rel = 0.0
        with torch.no_grad():
            for xx in (x, x_padded):
                dx, dz, grads = trimul.epilogue_cm_backward(xx, z, w, dout)
                want_dx, want_dz, want = trimul.epilogue_cm_backward_plain(xx, z, w, dout)
                for got_t, want_t in [(dx, want_dx), (dz, want_dz)] + [(grads[k], want[k])
                                                                         for k in trimul.EPILOGUE_PARAMS]:
                    err = (got_t - want_t).abs().max().item() / max(want_t.abs().max().item(), 1e-30)
                    rel = max(rel, err if torch.isfinite(got_t).all().item() else float("inf"))
                del dx, dz, grads, want_dx, want_dz, want
            ms = cuda_time_ms(lambda: trimul.epilogue_cm_backward(x, z, w, dout), iters=10)
            alone_ms = cuda_time_ms(lambda: trimul.epilogue_cm_backward(x, z, w, dout, weight_grads=False), iters=10)
            padded_ms = cuda_time_ms(lambda: trimul.epilogue_cm_backward(x_padded, z, w, dout), iters=10)
        del x_padded
        leaves = [x.requires_grad_(True), z.requires_grad_(True)] + \
            [w[k].requires_grad_(True) for k in trimul.EPILOGUE_PARAMS]
        out = trimul.epilogue_cm_plain(x, z, w)
        plain_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 5, 1)
        out = Recomputed.apply(trimul._EPILOGUE_KERNEL, trimul._EPILOGUE_PLAIN, *leaves)
        recomputed_ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 5, 1)
        del out
        x.requires_grad_(False)
        z.requires_grad_(False)
        ops = 6 * 2 * B * N * N * C_P * H_MUL  # x.ws, zn.W_g, dx^, dzn, d ws, d W_g
        bytes_ = 5 * B * N * N * C_P * 4  # x, z, dout read; dx, dz written
        bound_ops, bound_bytes = ops / PEAK_OPS_PER_S["float32"] * 1e3, bytes_ / PEAK_BYTES_PER_S * 1e3
        recs.append({"B": B, "N": N, "C": C_P, "H": H_MUL, "D": C_P, "dtype": "float32", "ms": ms,
                     "dx_dz_only_ms": alone_ms, "padded_ms": padded_ms, "padded_lengths": lengths,
                     "bound_ms": max(bound_ops, bound_bytes),
                     "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
                     "plain_backward_ms": plain_ms, "recomputed_ms": recomputed_ms, "rel_err": rel,
                     "tol": TOL["float32"], "ok": rel <= TOL["float32"]})
        torch.cuda.empty_cache()
    return recs


def at_float_offset(t, offset: int):
    """`t` as a contiguous view `offset` elements into a buffer of its own:
    at an odd offset no span of a float32 part is 16-byte aligned."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    buf[offset:].copy_(t)
    return buf[offset:]


# The epilogue stages' edges: (N, float offset of the summed part). At N =
# 255 tiles start at odd positions and end in an odd tail (the finish copies
# those spans by 8-byte cp.async, the partial stores them by plain stores);
# at an odd offset every span of the finish's input goes by 4-byte copies.
SPLIT_EDGES = ((255, 0), (256, 1))


def check_split_edges(gen, dev):
    """Rows 3a and 3b at SPLIT_EDGES, B=2, C=H=128 on two model ranks,
    float32 and bf16 activations with float32 and bf16 weights, each
    against its plain version (the partial per rank, the finish on the
    summed part, each relative to max |plain|); then the device kernels of
    one wrapper call of rows 3, 3a and 3b under bf16 weights (the bf16
    policy), which must be one kernel each. Returns (failures, {kernel:
    kernels a call}). Forward only: the gradients of the same Functions are
    held at the kernels phase's shapes."""
    import torch

    from genie2_tpu_torch.ops import trimul

    failed = []
    B = 2
    for N, offset in SPLIT_EDGES:
        w32 = random_trimul_weights(C_P, H_MUL, gen, dev)
        z32 = torch.randn(B, N, N, C_P, generator=gen, device=dev)
        x32 = torch.randn(B, H_MUL, N, N, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            z, x = z32.to(dtype), x32.to(dtype)
            for wdt in (torch.float32, torch.bfloat16):
                w = {k: v.to(wdt) for k, v in w32.items()}
                halves = split_epilogue_inputs(x, w)
                with torch.no_grad():
                    parts = [(trimul.epilogue_partial(*h), trimul.epilogue_partial_plain(*h)) for h in halves]
                    part = at_float_offset(sum(p for p, _ in parts), offset)
                    finish = (trimul.epilogue_finish(part, z, w, H_MUL),
                              trimul.epilogue_finish_plain(part, z, *(w[k] for k in trimul.FINISH_PARAMS), H_MUL))
                torch.cuda.synchronize()
                for name, (got, want) in [("trimul_epilogue_partial", pw) for pw in parts] + [
                        ("trimul_epilogue_finish", finish)]:
                    err, scale = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
                    rel = err / max(scale, 1e-30)
                    ok = bool(torch.isfinite(got.float()).all().item()) and rel <= TOL[dname]
                    emit({"phase": "kernels", "split_edge": True, "kernel": name, "N": N, "B": B, "offset": offset,
                          "dtype": dname, "weights": str(wdt).split(".")[-1], "max_abs_err": err, "rel_err": rel,
                          "tol": TOL[dname], "ok": ok})
                    if not ok:
                        failed.append(f"{name} edge N={N} offset={offset} {dname} weights {wdt}: rel {rel:.3g}")
    # One wrapper call under bf16 weights and activations at N=256.
    w = {k: v.to(torch.bfloat16) for k, v in random_trimul_weights(C_P, H_MUL, gen, dev).items()}
    z = torch.randn(B, 256, 256, C_P, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn(B, H_MUL, 256, 256, generator=gen, device=dev).to(torch.bfloat16)
    halves = split_epilogue_inputs(x, w)
    with torch.no_grad():
        part = trimul.epilogue_partial(*halves[0])
        calls = {"trimul_epilogue": lambda: trimul.epilogue_cm(x, z, w),
                 "trimul_epilogue_partial": lambda: trimul.epilogue_partial(*halves[0]),
                 "trimul_epilogue_finish": lambda: trimul.epilogue_finish(part, z, w, H_MUL)}
        per_call = {name: [e.name for e in device_events(fn)] for name, fn in calls.items()}
    emit({"phase": "kernels", "kernels_per_call_bf16_weights": per_call})
    failed += [f"{name}: {len(names)} device kernels a call under bf16 weights, not 1: {names}"
               for name, names in per_call.items() if len(names) != 1]
    return failed, {name: len(names) for name, names in per_call.items()}


def split_epilogue_inputs(x, w):
    """Each of two model ranks' epilogue_partial arguments: its half of
    x's hidden channels, W_z's columns and the LN_out scale and bias, each
    contiguous as a rank holds its shard."""
    h = x.shape[1] // 2
    return [(x[:, sl].contiguous(), w["w_z"][:, sl].contiguous(), w["ln_out_scale"][sl], w["ln_out_bias"][sl])
            for sl in (slice(0, h), slice(h, 2 * h))]


def partial_parts(part, B, N, D=C_P):
    """epilogue_partial's flat output as (x.ws, sum x, sum x^2, weight sums)."""
    from genie2_tpu_torch.ops import trimul

    per_pos, sums = trimul.split_part(part, B, N, D)
    return per_pos[..., :D], per_pos[..., D], per_pos[..., D + 1], sums


def split_against_one_launch(x, z, w, halves, dname, N, B):
    """Two ranks' partial sums (kernels, summed here) through the finish
    kernel against the one-launch epilogue kernel on all channels."""
    import torch

    from genie2_tpu_torch.ops import trimul

    got = trimul.epilogue_finish(sum(trimul.epilogue_partial(*h) for h in halves), z, w, x.shape[1])
    want = trimul.epilogue_cm(x, z, w)
    torch.cuda.synchronize()
    err, scale = (got.float() - want.float()).abs().max().item(), want.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    return {"kernel": "trimul_epilogue partial + finish vs one launch", "N": N, "B": B, "dtype": dname,
            "max_abs_err": err, "max_abs_one_launch": scale, "rel_err": rel, "tol": TOL[dname],
            "ok": bool(torch.isfinite(got.float()).all().item()) and rel <= TOL[dname]}


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def gradient_cases(z, res_mask, w, a_p, b_p, x_p, ipa_args, ta_args, gen, halves, part_p, tr_args=None):
    """Each autograd Function of ops/ at the kernels phase's shapes (the pair
    transition's where `tr_args` are given, float32), as
    (kernel, outgoing, kernel forward, plain forward, inputs, activations,
    cotangents): both forwards are functions of `inputs`, leaves that
    require grad (every floating input); `activations` are those that
    depend on x_t in the TDS gradient, on which the backward is timed."""
    import torch

    from genie2_tpu_torch.ops import ipa, transition, tri_att, trimul

    def cot(t):
        return torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)

    zg, wg = _leaf(z), {k: _leaf(v) for k, v in w.items()}
    ag, bg, xg = _leaf(a_p), _leaf(b_p), _leaf(x_p)
    project_w, epilogue_w = [wg[k] for k in trimul.PROJECT_PARAMS], [wg[k] for k in trimul.EPILOGUE_PARAMS]
    cases = [("trimul_project", None, lambda: trimul.project_gated_cm(zg, res_mask, wg),
              lambda: trimul.project_gated_cm_plain(zg, res_mask, wg), [zg, *project_w], [zg], (cot(a_p), cot(b_p)))]
    for outgoing in (True, False):
        cases.append(("trimul_contract", outgoing, lambda o=outgoing: trimul.contract_cm(ag, bg, o),
                      lambda o=outgoing: trimul.contract_cm_plain(ag, bg, o), [ag, bg], [ag, bg], (cot(a_p),)))
    cases.append(("trimul_epilogue", None, lambda: trimul.epilogue_cm(xg, zg, wg),
                  lambda: trimul.epilogue_cm_plain(xg, zg, wg), [xg, zg, *epilogue_w], [xg, zg], (cot(z),)))
    hg = [_leaf(t) for t in halves[0]]
    cases.append(("trimul_epilogue_partial", None, lambda: trimul.epilogue_partial(*hg),
                  lambda: trimul.epilogue_partial_plain(*hg), hg, hg[:1], (cot(part_p),)))
    pg = _leaf(part_p)
    finish_w = [wg[k] for k in trimul.FINISH_PARAMS]
    cases.append(("trimul_epilogue_finish", None, lambda: trimul.epilogue_finish(pg, zg, wg, H_MUL),
                  lambda: trimul.epilogue_finish_plain(pg, zg, *finish_w, H_MUL), [pg, zg, *finish_w], [pg, zg],
                  (cot(z),)))
    # The IPA core on k / v and points strided as nn/structure.py passes them.
    q, k, v, q_pts, k_pts, v_pts, bias, zz, hw, mask = ipa_args
    kv, kv_pts = _leaf(torch.cat([k, v], -1)), _leaf(torch.cat([k_pts, v_pts], -2))
    qg, qpg, biasg, zzg, hwg = (_leaf(t) for t in (q, q_pts, bias, zz, hw))
    c, pq = k.shape[-1], k_pts.shape[-2]
    args = (qg, kv[..., :c], kv[..., c:], qpg, kv_pts[..., :pq, :], kv_pts[..., pq:, :], biasg, zzg, hwg, mask)
    cases.append(("ipa_attention", None, lambda: ipa.ipa_attention(*args), lambda: ipa.ipa_attention_plain(*args),
                  [qg, kv, qpg, kv_pts, biasg, zzg, hwg], [qg, kv, qpg, kv_pts, biasg, zzg],
                  tuple(cot(o) for o in ipa.ipa_attention_plain(*args))))
    tq, tk, tv, ttb, tmask = ta_args
    tq, tk, tv, ttb = (_leaf(t) for t in (tq, tk, tv, ttb))
    cases.append(("tri_attention", None, lambda: tri_att.tri_attention(tq, tk, tv, ttb, tmask),
                  lambda: tri_att.tri_attention_plain(tq, tk, tv, ttb, tmask), [tq, tk, tv, ttb],
                  [tq, tk, tv, ttb], (cot(tq),)))
    if tr_args is not None:
        pair_mask, trw = tr_args[1], [_leaf(t) for t in tr_args[2:]]
        cases.append(("pair_transition", None, lambda: transition.pair_transition(zg, pair_mask, *trw),
                      lambda: transition.pair_transition_plain(zg, pair_mask, *trw), [zg, *trw], [zg], (cot(z),)))
    return cases


# The row-block cases of sequence parallelism: at N = 256, B = 2, the rows
# of the second of two seq ranks, I = 128 (the incoming partial sums: K =
# 128 rows of k).
ROW_BLOCK_N, ROW_BLOCK_I = 256, 128


def row_block_cases(z, res_mask, w, ipa_args, ta_args, gen):
    """Each kernel's row-block case (nn/pair_stack.py, nn/structure.py under
    a seq axis of 2, this rank the second) as (kernel, case, kernel forward,
    plain forward, inputs that require grad, cotangents, one library call of
    the same function or None): the projection of
    I rows of z with their own row mask; the outgoing contraction of I rows
    of a against all of b; the incoming partial sums over K rows; the
    epilogue and its two stages on I rows (the finish also on a part at an
    odd float offset); contract_cm_km at (I, J, K) =
    (128, 256, 256), the outgoing block's backward; the IPA core with I
    query rows against N keys; the ending node's triangle attention with I
    queries against N keys."""
    import torch

    from genie2_tpu_torch.ops import ipa, tri_att, trimul

    N, I = ROW_BLOCK_N, ROW_BLOCK_I
    rows = slice(N - I, N)

    def cot(t):
        return torch.randn(t.shape, generator=gen, device=t.device).to(t.dtype)

    zr = _leaf(z[:, rows])
    row_mask = res_mask[:, rows].contiguous()
    wg = {k: _leaf(v) for k, v in w.items()}
    project_w = [wg[k] for k in trimul.PROJECT_PARAMS]
    a_p, b_p = trimul.project_gated_cm_plain(z, res_mask, w)
    ar, b_full, bk = _leaf(a_p[:, :, rows]), _leaf(b_p), _leaf(b_p[:, :, rows])
    x_r = _leaf(trimul.contract_cm_plain(a_p[:, :, rows], b_p, True))
    halves = split_epilogue_inputs(x_r.detach(), w)
    part_p = sum(trimul.epilogue_partial_plain(*h) for h in halves)
    hg, pg = [_leaf(t) for t in halves[0]], _leaf(part_p)
    p_odd = at_float_offset(part_p, 1)
    epilogue_w, finish_w = [wg[k] for k in trimul.EPILOGUE_PARAMS], [wg[k] for k in trimul.FINISH_PARAMS]
    dx = _leaf(cot(x_r))
    cases = [
        ("trimul_project", "rows", lambda: trimul.project_gated_cm(zr, row_mask, wg, res_mask),
         lambda: trimul.project_gated_cm_plain(zr, row_mask, wg, res_mask), [zr, *project_w], (cot(ar), cot(ar)),
         None),
        ("trimul_contract", "outgoing_rows", lambda: trimul.contract_cm(ar, b_full, True),
         lambda: trimul.contract_cm_plain(ar, b_full, True), [ar, b_full], (cot(x_r),),
         lambda: torch.matmul(ar, b_full.transpose(-1, -2))),
        ("trimul_contract", "incoming_partial", lambda: trimul.contract_cm(ar, bk, False),
         lambda: trimul.contract_cm_plain(ar, bk, False), [ar, bk], (cot(b_full),),
         lambda: torch.matmul(ar.transpose(-1, -2), bk)),
        ("trimul_epilogue", "rows", lambda: trimul.epilogue_cm(x_r, zr, wg),
         lambda: trimul.epilogue_cm_plain(x_r, zr, wg), [x_r, zr, *epilogue_w], (cot(zr),), None),
        ("trimul_epilogue_partial", "rows", lambda: trimul.epilogue_partial(*hg),
         lambda: trimul.epilogue_partial_plain(*hg), hg, (cot(part_p),), None),
        ("trimul_epilogue_finish", "rows", lambda: trimul.epilogue_finish(pg, zr, wg, H_MUL),
         lambda: trimul.epilogue_finish_plain(pg, zr, *finish_w, H_MUL), [pg, zr, *finish_w], (cot(zr),), None),
        # The same at an odd float offset of the summed part: every span by
        # 4-byte copies (forward only).
        ("trimul_epilogue_finish", "rows_unaligned", lambda: trimul.epilogue_finish(p_odd, zr, wg, H_MUL),
         lambda: trimul.epilogue_finish_plain(p_odd, zr, *finish_w, H_MUL), [], (), None),
        ("contract_cm_km", "rows", lambda: trimul.contract_cm_km(dx, b_full),
         lambda: trimul.contract_cm_km_plain(dx, b_full), [], (), lambda: torch.matmul(dx, b_full)),
    ]
    # The IPA core: this rank's query rows (q, q points, bias, z) against
    # every key, k / v and points strided as nn/structure.py passes them.
    q, k, v, q_pts, k_pts, v_pts, bias, zz, hw, mask = ipa_args
    kv, kv_pts = _leaf(torch.cat([k, v], -1)), _leaf(torch.cat([k_pts, v_pts], -2))
    qg, qpg, biasg, zzg = (_leaf(t[:, rows]) for t in (q, q_pts, bias, zz))
    hwg = _leaf(hw)
    c, pq = k.shape[-1], k_pts.shape[-2]
    args = (qg, kv[..., :c], kv[..., c:], qpg, kv_pts[..., :pq, :], kv_pts[..., pq:, :], biasg, zzg, hwg, mask)
    cases.append(("ipa_attention", "rows", lambda: ipa.ipa_attention(*args), lambda: ipa.ipa_attention_plain(*args),
                  [qg, kv, qpg, kv_pts, biasg, zzg, hwg], tuple(cot(o) for o in ipa.ipa_attention_plain(*args)),
                  None))
    # The ending node: every row of the swapped pair representation, this
    # rank's I query positions against all N keys, the bias of its queries.
    tq, tk, tv, ttb, tmask = ta_args
    tq, ttb = _leaf(tq[:, :, rows]), _leaf(ttb[:, :, rows])
    tk, tv = _leaf(tk), _leaf(tv)
    cases.append(("tri_attention", "ending_queries", lambda: tri_att.tri_attention(tq, tk, tv, ttb, tmask),
                  lambda: tri_att.tri_attention_plain(tq, tk, tv, ttb, tmask), [tq, tk, tv, ttb], (cot(tq),),
                  sdpa_tri_attention(*(t.detach() for t in (tq, tk, tv, ttb)), tmask)))
    return cases


def check_row_blocks(z, res_mask, w, ipa_args, ta_args, dname, gen):
    """Every row-block case's forward and (through its autograd Function)
    gradient against its plain version on the card, each output and each
    input's gradient relative to max |plain| of it, with the times of the
    kernel, the plain version, the library call and the backward, and the
    case's bound (`row_block_bytes_ops`). Returns (failures, {kernel:
    {case: record}})."""
    import torch

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    def rel_err(got, want):
        errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
        scales = [p.float().abs().max().item() for p in want]
        finite = all(torch.isfinite(g.float()).all().item() for g in got)
        return max(errs), max(e / max(sc, 1e-30) for e, sc in zip(errs, scales)), finite

    failed, results = [], {}
    for name, case, kern, plain, inputs, cots, library in row_block_cases(z, res_mask, w, ipa_args, ta_args, gen):
        with torch.no_grad():
            got, want = as_tuple(kern()), as_tuple(plain())
            torch.cuda.synchronize()
            err, rel, finite = rel_err(got, want)
            ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
            library_ms = cuda_time_ms(library) if library else None
        H = H_MUL // 2 if name == "trimul_epilogue_partial" else H_MUL
        bytes_, ops = row_block_bytes_ops(name, case, z.shape[0], ROW_BLOCK_N, ROW_BLOCK_I, C_P, H, z.element_size())
        bound_bytes, bound_ops = bytes_ / PEAK_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3
        rec = {"kernel": name, "case": case, "N": ROW_BLOCK_N, "I": ROW_BLOCK_I, "dtype": dname, "shapes":
               [tuple(t.shape) for t in got], "max_abs_err": err, "rel_err": rel, "tol": TOL[dname],
               "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": max(bound_bytes, bound_ops),
               "bound_by": "bytes" if bound_bytes >= bound_ops else "operations"}
        ok = finite and rel <= TOL[dname]
        if inputs:
            g_got = torch.autograd.grad(as_tuple(kern()), inputs, cots)
            g_want = torch.autograd.grad(as_tuple(plain()), inputs, cots)
            torch.cuda.synchronize()
            g_err, g_rel, g_finite = rel_err(g_got, g_want)
            out_k = as_tuple(kern())
            rec.update(grad_max_abs_err=g_err, grad_rel_err=g_rel, backward_ms=cuda_time_ms(
                lambda: torch.autograd.grad(out_k, inputs, cots, retain_graph=True), iters=10, warmup=2))
            ok = ok and g_finite and g_rel <= TOL[dname]
        rec["ok"] = ok
        emit({"phase": "kernels", "row_block": True, **rec})
        if not ok:
            failed.append(f"{name} row block {case} {dname}: rel {rel:.3g}, gradient {rec.get('grad_rel_err')}")
        results.setdefault(name, {})[case] = rec
    return failed, results


def check_gradients(cases, dname, N, B):
    """Gradients of every input through the kernel wrapper (its autograd
    Function) against autograd of the plain version, each relative to max
    |plain gradient| of that input; then, with the weights no longer
    requiring grad (as in the TDS gradient), the forward under autograd and
    the backward timed for both."""
    import torch

    def as_tuple(out):
        return out if isinstance(out, tuple) else (out,)

    recs = []
    for name, outgoing, kern, plain, inputs, acts, cots in cases:
        for t in inputs:  # cases share leaves (z and the weights)
            t.requires_grad_(True)
        got = torch.autograd.grad(as_tuple(kern()), inputs, cots)
        want = torch.autograd.grad(as_tuple(plain()), inputs, cots)
        torch.cuda.synchronize()
        errs = [(g.float() - p.float()).abs().max().item() for g, p in zip(got, want)]
        scales = [p.float().abs().max().item() for p in want]
        rel = max(e / max(sc, 1e-30) for e, sc in zip(errs, scales))
        finite = all(torch.isfinite(g.float()).all().item() for g in got)
        for t in inputs:
            if not any(t is a for a in acts):
                t.requires_grad_(False)
        out_k, out_p = as_tuple(kern()), as_tuple(plain())
        recs.append({
            "kernel": name, "N": N, "B": B, "dtype": dname, "outgoing": outgoing, "max_abs_err": max(errs),
            "rel_err": rel, "tol": TOL[dname], "ok": finite and rel <= TOL[dname], "finite": finite,
            "backward_route": BACKWARD_ROUTE[name],
            "forward_ms": cuda_time_ms(kern, iters=10, warmup=2),
            "backward_ms": cuda_time_ms(lambda: torch.autograd.grad(out_k, acts, cots, retain_graph=True),
                                        iters=10, warmup=2),
            "plain_forward_ms": cuda_time_ms(plain, iters=10, warmup=2),
            "plain_backward_ms": cuda_time_ms(lambda: torch.autograd.grad(out_p, acts, cots, retain_graph=True),
                                              iters=10, warmup=2),
        })
    return recs


# ------------------------------------------------------------------ #
# Phase 3
# ------------------------------------------------------------------ #


@contextlib.contextmanager
def plain_kernels():
    """Swap the plain versions in for the kernel wrappers that the denoiser
    calls, TriMul, IPA, triangle attention and the pair transition
    (comparison only)."""
    from genie2_tpu_torch.nn import primitives, structure
    from genie2_tpu_torch.ops import ipa, transition, tri_att, trimul

    saved = (trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm, structure.ipa_attention,
             primitives.tri_attention, transition.pair_transition)
    trimul.project_gated_cm = trimul.project_gated_cm_plain
    trimul.contract_cm = trimul.contract_cm_plain
    trimul.epilogue_cm = trimul.epilogue_cm_plain
    structure.ipa_attention = ipa.ipa_attention_plain
    primitives.tri_attention = tri_att.tri_attention_plain
    transition.pair_transition = transition.pair_transition_plain
    try:
        yield
    finally:
        (trimul.project_gated_cm, trimul.contract_cm, trimul.epilogue_cm, structure.ipa_attention,
         primitives.tri_attention, transition.pair_transition) = saved


def example_config(tri_att: bool = False, max_n_res: int = None):
    """configs/example.configuration with eigh quaternions, as its seeded
    checkpoints load (utils/model_io.py); with `tri_att`, the same file with
    triangle attention on (4 heads of 32, the configuration's defaults);
    with `max_n_res`, that maximumNumResidues."""
    from genie2_tpu_torch.config import Config

    overrides = {"rotToQuatMethod": "eigh", "includeTriangularAttention": tri_att}
    if max_n_res is not None:
        overrides["maximumNumResidues"] = max_n_res
    return Config(os.path.join(HERE, "configs", "example.configuration"), overrides=overrides)


def seeded_denoiser(config, device):
    """Full-width denoiser with seeded weights, the zero-initialised
    "final" / "gating" ones included (utils/weights.randomize_zero_init)."""
    import torch

    from genie2_tpu_torch.nn import Denoiser
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    torch.manual_seed(SEED)
    model = randomize_zero_init(Denoiser.from_config(config), SEED)
    # No weight gradients: the denoiser phase differentiates with respect
    # to the translations only, as TDS does.
    return model.to(device).eval().requires_grad_(False)


def expected_launches(config, denoiser_calls: int):
    """Launch counts after `denoiser_calls` calls of the denoiser: each pair
    layer runs an outgoing and an incoming TriMul (project, contract,
    epilogue each) and, where the configuration has triangle attention, a
    starting and an ending one, and one pair transition where the kernel
    takes its widths (float32 runs); each structure layer of each block one
    IPA core; the standalone contractions are on no path."""
    from genie2_tpu_torch.ops import transition

    m = config.model
    pair = m["n_pair_transform_layer"] * denoiser_calls
    structure = m["n_structure_layer"] * m["n_structure_block"] * denoiser_calls
    want = dict.fromkeys(launch_counts(), 0)
    want.update(trimul_project=2 * pair, trimul_contract_out=pair, trimul_contract_in=pair,
                trimul_epilogue=2 * pair, ipa_attention=structure,
                tri_attention=2 * pair if m["include_tri_att"] else 0,
                pair_transition=pair if transition.takes(m["c_p"], m["pair_transition_n"] * m["c_p"]) else 0)
    return want


def backward_launches(config, twisted_calls: int):
    """The launches one float32 backward pass of the denoiser adds, times
    `twisted_calls`: each pair layer's outgoing contraction takes
    contract_cm_km and an incoming contraction, its incoming one an
    outgoing contraction and contract_cm_km, each of its two projections
    the projection's backward kernel and each of its two epilogues the
    epilogue's (ops/trimul.py); the other Functions recompute their plain
    versions and launch nothing."""
    pair = config.model["n_pair_transform_layer"] * twisted_calls
    return {"contract_cm_km": 2 * pair, "trimul_contract_out": pair, "trimul_contract_in": pair,
            "trimul_project_backward": 2 * pair, "trimul_epilogue_backward": 2 * pair}


def with_backward(config, calls: int, twisted_calls: int):
    want = expected_launches(config, calls)
    for k, v in backward_launches(config, twisted_calls).items():
        want[k] += v
    return want


def phase_denoiser(state):
    import torch

    dev = torch.device("cuda")
    for tri_att in (False, True):
        config = example_config(tri_att)
        model = seeded_denoiser(config, dev)
        state["model_triatt" if tri_att else "model"] = model
        compare_denoiser(config, model, tri_att)
        compare_denoiser_gradient(config, model, tri_att)
    for L, B in ((256, 2), (75, 4)):
        eigh_tie_probe(L, B)


def seeded_walk(B, L, device):
    """[B, L, 3] seeded random-walk translations (8 A steps, as a noisy x_t)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.normal(size=(B, L, 3)).astype(np.float32) * 8.0, device=device)


def compare_denoiser_gradient(config, model, tri_att):
    """d/dx sum(z . r) at L=256, batch 2, through the Frenet frames, the
    eigh quaternions and the denoiser: the kernels' Functions against every
    plain version swapped in; launches of one forward and backward counted,
    both timed, peak memory read."""
    import numpy as np
    import torch

    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames

    dev = torch.device("cuda")
    L, B = 256, 2
    feats = to_device(batchify([create_empty_features([L]) for _ in range(B)]), dev)
    trans = seeded_walk(B, L, dev)
    r = torch.as_tensor(np.random.default_rng(SEED + 1).normal(size=(B, L, 3)).astype(np.float32), device=dev)
    t = torch.tensor([500, 20], dtype=torch.int32, device=dev)

    def grad():
        x = trans.clone().requires_grad_(True)
        z = model(Rigid(frenet_frames(x, feats["chain_index"], feats["residue_mask"]), x), t, feats)["z"]
        return torch.autograd.grad((z * r).sum(), x)[0]

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    g_k = grad()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    ms_k = cuda_time_ms(grad, iters=3, warmup=1)
    with plain_kernels():
        g_p = grad()
        ms_p = cuda_time_ms(grad, iters=3, warmup=1)
    err, scale = (g_k - g_p).abs().max().item(), g_p.abs().max().item()
    rec = {
        "phase": "denoiser", "gradient": "d sum(z.r) / d translations", "triangle_attention": tri_att, "L": L,
        "B": B, "quat": config.tpu.get("rot_to_quat_method", "closed"), "max_abs_err": err, "max_abs_grad": scale,
        "rel_err": err / max(scale, 1e-30), "tol": DENOISER_TOL, "finite": bool(torch.isfinite(g_k).all().item()),
        "plain_finite": bool(torch.isfinite(g_p).all().item()), "ms_forward_backward_kernels": ms_k,
        "ms_forward_backward_plain": ms_p, "peak_memory_bytes": peak, "launches_forward_backward": launches,
    }
    emit(rec)
    if not rec["finite"] or rec["rel_err"] > DENOISER_TOL:
        raise PhaseFailed(f"denoiser gradient disagrees or is not finite: rel {rec['rel_err']:.3g}")
    want = with_backward(config, 1, 1)
    if launches != want:
        raise PhaseFailed(f"denoiser gradient launches {launches}, expected {want}")


def eigh_tie_probe(L, B):
    """How often float32 eigh on the card returns two of the K-matrix's
    triple eigenvalue exactly equal, for the pair rotations of seeded
    Frenet frames, and what that does to the gradient with respect to the
    translations: through eigh's own backward and through the port's
    `TopEigenvector` (geometry/quat.py), which must stay finite."""
    import torch

    from genie2_tpu_torch.geometry import frenet_frames
    from genie2_tpu_torch.geometry.quat import _EIGH_BATCH, TopEigenvector, _k_matrix

    dev = torch.device("cuda")
    x = seeded_walk(B, L, dev).requires_grad_(True)
    mask = torch.ones(B, L, device=dev)
    rots = frenet_frames(x, torch.zeros(B, L, dtype=torch.long, device=dev), mask)
    k = _k_matrix(torch.matmul(rots[:, None], rots[:, :, None])).reshape(-1, 4, 4)
    w = torch.cat([torch.linalg.eigvalsh(c) for c in k.detach().split(_EIGH_BATCH)])
    ties = int(((w[:, 1:3] - w[:, 0:2]) == 0).any(-1).sum().item())
    cot = torch.randn(k.shape[0], 4, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    own = torch.cat([torch.linalg.eigh(c)[1][..., -1] for c in k.split(_EIGH_BATCH)])
    (g_own,) = torch.autograd.grad((own * cot).sum(), x, retain_graph=True)
    (g_top,) = torch.autograd.grad((TopEigenvector.apply(k) * cot).sum(), x)
    rec = {"phase": "denoiser", "eigh_ties": True, "L": L, "B": B, "pair_matrices": k.shape[0],
           "matrices_with_a_tie": ties, "eigh_backward_nan_entries": int(torch.isnan(g_own).sum().item()),
           "top_eigenvector_backward_nan_entries": int(torch.isnan(g_top).sum().item()), "entries": g_top.numel()}
    emit(rec)
    if rec["top_eigenvector_backward_nan_entries"]:
        raise PhaseFailed(f"TopEigenvector's gradient is not finite at L={L}, B={B}")


def denoiser_inputs(L=256, B=2):
    """The denoiser phase's inputs: seeded translations (8 A steps), their
    Frenet frames, timesteps 500 and 20, B chains of L residues."""
    import numpy as np
    import torch

    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.geometry import Rigid, frenet_frames

    dev = torch.device("cuda")
    feats = to_device(batchify([create_empty_features([L]) for _ in range(B)]), dev)
    rng = np.random.default_rng(SEED)
    trans = torch.as_tensor(rng.normal(size=(B, L, 3)).astype(np.float32) * 8.0, device=dev)
    t = torch.tensor([500, 20][:B], dtype=torch.int32, device=dev)
    return Rigid(frenet_frames(trans, feats["chain_index"], feats["residue_mask"]), trans), t, feats


def compare_denoiser(config, model, tri_att):
    """One denoiser call at L=256, batch 2, with the kernels and with every
    plain version swapped in: z compared, launches counted, both timed."""
    import torch


    L = 256
    frames, t, feats = denoiser_inputs(L)

    def run():
        return model(frames, t, feats)["z"]

    with torch.inference_mode():
        reset_counts()
        z_k = run()
        torch.cuda.synchronize()
        launches = launch_counts()
        ms_k = cuda_time_ms(run, iters=5, warmup=1)
        with plain_kernels():
            z_p = run()
            ms_p = cuda_time_ms(run, iters=5, warmup=1)
    err = (z_k - z_p).abs().max().item()
    scale = z_p.abs().max().item()
    rec = {
        "phase": "denoiser", "triangle_attention": tri_att, "L": L, "B": 2, "max_abs_err": err, "max_abs_z": scale,
        "rel_err": err / max(scale, 1e-30), "tol": DENOISER_TOL,
        "ms_kernels": ms_k, "ms_plain": ms_p, "launches_one_call": launches,
        "finite": bool(torch.isfinite(z_k).all().item()),
    }
    emit(rec)
    if not rec["finite"] or rec["rel_err"] > DENOISER_TOL:
        raise PhaseFailed(f"denoiser z disagrees: rel {rec['rel_err']:.3g}")
    if launches != expected_launches(config, 1):
        raise PhaseFailed(f"denoiser launches {launches}, expected {expected_launches(config, 1)}")


# ------------------------------------------------------------------ #
# Phase 4
# ------------------------------------------------------------------ #


def release_dir(state, tri_att: bool = False):
    """The seeded full-width model as a release-layout checkpoint under a
    temporary directory (removed by main): {work}/results/smoke/..., or
    .../smoke_triatt/... for the configuration with triangle attention.
    Returns (work, rootdir, name)."""
    import torch

    if "work" not in state:
        state["work"] = tempfile.mkdtemp(prefix="chip_smoke_")
    name, key = ("smoke_triatt", "model_triatt") if tri_att else ("smoke", "model")
    rootdir = os.path.join(state["work"], "results")
    if not os.path.isdir(os.path.join(rootdir, name)):
        model = state.get(key) or seeded_denoiser(example_config(tri_att), torch.device("cuda"))
        os.makedirs(os.path.join(rootdir, name, "checkpoints"))
        with open(os.path.join(HERE, "configs", "example.configuration")) as src, \
                open(os.path.join(rootdir, name, "configuration"), "w") as dst:
            dst.write(src.read().rstrip("\n") + "\n" + (TRI_ATT_LINE if tri_att else ""))
        torch.save(
            {"state_dict": {f"model.{k}": v.detach().cpu() for k, v in model.state_dict().items()}},
            os.path.join(rootdir, name, "checkpoints", "epoch.1.ckpt"),
        )
    return state["work"], rootdir, name


def drive(cli_main, argv):
    """One CLI run with the launch counts set to 0 just before it and read
    just after. Returns (the CLI's result, wall seconds, launch counts)."""
    import torch


    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = cli_main(argv)
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, launch_counts()


def check_ca_file(path, length=None):
    """Finite CA coordinates of the expected length; returns the length."""
    import numpy as np

    from genie2_tpu_torch.features import read_ca_coords

    if not os.path.isfile(path):
        raise PhaseFailed(f"missing {path}")
    xyz = read_ca_coords(path)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or not np.isfinite(xyz).all() or not len(xyz) \
            or (length is not None and len(xyz) != length):
        raise PhaseFailed(f"{path}: coordinates {xyz.shape} are not finite or have the wrong shape")
    return len(xyz)


def common_argv(rootdir, outdir, scale, name="smoke", epoch=1):
    return ["--name", name, "--epoch", str(epoch), "--rootdir", rootdir, "--outdir", outdir, "--scale", scale,
            "--seed", str(SEED), "--device", "cuda"]


def phase_main(state):
    from genie2_tpu_torch.cli import sample_unconditional

    config = example_config()
    work, rootdir, _ = release_dir(state)
    outdir = os.path.join(work, "out")
    lengths = (256, 200)
    argv = common_argv(rootdir, outdir, "0.6") + [
        "--num_samples", "2", "--batch_size", "2", "--min_length", str(min(lengths)),
        "--max_length", str(max(lengths)), "--length_step", str(max(lengths) - min(lengths)),
    ]
    per_length, seconds, launches = drive(sample_unconditional.main, argv)

    for L in lengths:
        for i in range(2):
            check_ca_file(os.path.join(outdir, "pdbs", f"{L}_{i}.pdb"), L)
    n_steps = config.diffusion["n_timestep"]
    rec = {
        "phase": "main", "lengths": list(lengths), "samples": 2 * len(lengths),
        "seconds": seconds, "samples_per_min": 2 * len(lengths) / seconds * 60.0,
        "ms_per_denoiser_step": seconds / (len(lengths) * n_steps) * 1e3,
        "seconds_per_length": per_length,
        "samples_per_min_at_256": 2 / per_length[256] * 60.0,
        "ms_per_step_at_256": per_length[256] / n_steps * 1e3,
        "batch": 2, "launches": launches, "coords_ok": True, "smi": state["smi"],
    }
    emit(rec)
    state["launches"] = launches
    want = expected_launches(config, len(lengths) * n_steps)
    if launches != want:
        raise PhaseFailed(f"launch counts {launches}, expected {want}")
    check_converted_release(state)


# DDIM steps of the unconditional CLI from a converted reference checkpoint.
CONVERT_DDIM = 10


def lightning_reference_blob(state_dict):
    """A reference-style Lightning checkpoint of `state_dict`: the weights
    under `model.`, and beside them objects that only a full pickle holds
    (the hyperparameters as a Namespace, optimizer and loop states)."""
    import argparse

    return {
        "epoch": 1, "global_step": 1000, "pytorch-lightning_version": "1.9.4",
        "state_dict": {f"model.{k}": v for k, v in state_dict.items()},
        "hyper_parameters": argparse.Namespace(config="configuration", lr=1e-4),
        "optimizer_states": [{"state": {}, "param_groups": [{"lr": 1e-4, "params": list(range(len(state_dict)))}]}],
        "lr_schedulers": [], "callbacks": {"ModelCheckpoint": {"best_model_score": None}},
    }


def check_converted_release(state):
    """The release's weights as a reference Lightning checkpoint: refused by
    the weights-only loader with the converter named, converted by
    cli/convert_checkpoint.py, then sampled from by the unconditional CLI
    (DDIM-CONVERT_DDIM at L=256, launches counted) and held bit for bit
    against the tensors-only release of the same state_dict: the denoiser's
    z on the denoiser phase's inputs, and the sampled coordinates."""
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import convert_checkpoint, sample_unconditional
    from genie2_tpu_torch.sampling import base
    from genie2_tpu_torch.utils.model_io import load_pretrained_model

    work, rootdir, name = release_dir(state)
    ref_name = "smoke_reference"
    ckpts = os.path.join(rootdir, ref_name, "checkpoints")
    os.makedirs(ckpts)
    shutil.copy(os.path.join(rootdir, name, "configuration"), os.path.join(rootdir, ref_name, "configuration"))
    direct = torch.load(os.path.join(rootdir, name, "checkpoints", "epoch.1.ckpt"), weights_only=True)["state_dict"]
    src, dst = os.path.join(ckpts, "epoch.1.ckpt"), os.path.join(ckpts, "epoch.2.ckpt")
    torch.save(lightning_reference_blob({k[len("model."):]: v for k, v in direct.items()}), src)
    refusal = None
    try:
        load_pretrained_model(rootdir, ref_name, 1, device="cuda")
    except ValueError as exc:
        refusal = str(exc)
    if refusal is None or "genie2_tpu_torch.cli.convert_checkpoint" not in refusal:
        raise PhaseFailed(f"the weights-only loader did not refuse {src} naming the converter: {refusal}")
    t0 = time.perf_counter()
    convert_checkpoint.main([src, dst, "--config", os.path.join(rootdir, ref_name, "configuration")])
    convert_s = time.perf_counter() - t0
    with open(dst + ".meta.json") as fh:
        meta = json.load(fh)

    inputs = denoiser_inputs()
    z, methods = {}, {}
    for label, (rname, epoch) in {"converted": (ref_name, 2), "direct": (name, 1)}.items():
        model, config = load_pretrained_model(rootdir, rname, epoch, device="cuda")
        with torch.inference_mode():
            z[label] = model(*inputs)["z"]
        methods[label] = config.tpu["rot_to_quat_method"]
        del model
    captured = []
    sample = base.BaseSampler.sample

    def capture(self, params):
        result = sample(self, params)
        captured.append(np.stack([f["atom_positions"] for f in result]))
        return result

    outdir = os.path.join(work, "converted")
    runs, coords = {}, {}
    base.BaseSampler.sample = capture
    try:
        for label, (rname, epoch) in {"converted": (ref_name, 2), "direct": (name, 1)}.items():
            argv = common_argv(rootdir, os.path.join(outdir, label), "0.6", name=rname, epoch=epoch) + [
                "--num_samples", "2", "--batch_size", "2", "--min_length", "256", "--max_length", "256",
                "--ddim_steps", str(CONVERT_DDIM), "--ddim_eta", "0.5"]
            _, seconds, launches = drive(sample_unconditional.main, argv)
            runs[label] = {"seconds": seconds, "launches": launches}
            coords[label], captured[:] = list(captured), []
    finally:
        base.BaseSampler.sample = sample
    for i in range(2):
        check_ca_file(os.path.join(outdir, "converted", "pdbs", f"256_{i}.pdb"), 256)
    want = expected_launches(example_config(), CONVERT_DDIM)
    rec = {"phase": "main", "run": "converted_reference_checkpoint", "refused": refusal.split(";")[0],
           "sidecar": meta, "convert_seconds": convert_s, "rot_to_quat": methods,
           "z_bitwise_equal": torch.equal(z["converted"], z["direct"]),
           "z_max_abs_diff": (z["converted"] - z["direct"]).abs().max().item(),
           "coords_bitwise_equal": len(coords["converted"]) == len(coords["direct"]) > 0
           and all(np.array_equal(a, b) for a, b in zip(coords["converted"], coords["direct"])),
           "ddim_steps": CONVERT_DDIM, "L": 256, "runs": runs, "expected_launches": want, "smi": state["smi"]}
    emit(rec)
    if not (rec["z_bitwise_equal"] and rec["coords_bitwise_equal"]) or meta.get("rot_to_quat_method") != "eigh" \
            or methods != {"converted": "eigh", "direct": "eigh"} or runs["converted"]["launches"] != want:
        raise PhaseFailed(f"converted checkpoint: {rec}")


# ------------------------------------------------------------------ #
# Phase 5
# ------------------------------------------------------------------ #

MOTIF_SEGMENTS = (("A", 10, 21, "A"), ("B", 40, 48, "B"))  # chain, first, last residue, group
SCAFFOLD_RANGE = (20, 45)
TOTAL_RANGE = (100, 128)
N_MOTIF = sum(last - first + 1 for _, first, last, _ in MOTIF_SEGMENTS)


def write_motif_problem(path):
    """A motif problem in the REMARK 999 grammar (features/motif.py): three
    scaffold segments around two motif segments in groups A and B, whose CA
    atoms follow a seeded random walk with 3.8 A steps."""
    import numpy as np

    from genie2_tpu_torch.features.residues import RESTYPE_1_TO_3, RESTYPES

    rng = np.random.default_rng(SEED)
    scaffold = f"REMARK 999 INPUT   {SCAFFOLD_RANGE[0]:4d}{SCAFFOLD_RANGE[1]:4d}\n"
    lines = ["REMARK 999 NAME   smoke_motif\n",
             f"REMARK 999 MINIMUM TOTAL LENGTH      {TOTAL_RANGE[0]}\n",
             f"REMARK 999 MAXIMUM TOTAL LENGTH      {TOTAL_RANGE[1]}\n", scaffold]
    for chain, first, last, group in MOTIF_SEGMENTS:
        lines += [f"REMARK 999 INPUT  {chain}{first:4d}{last:4d} {group}\n", scaffold]
    serial, pos = 1, np.zeros(3)
    for chain, first, last, _ in MOTIF_SEGMENTS:
        pos = pos + rng.normal(size=3) * 10.0
        for resseq in range(first, last + 1):
            step = rng.normal(size=3)
            pos = pos + 3.8 * step / np.linalg.norm(step)
            name = RESTYPE_1_TO_3[RESTYPES[serial % len(RESTYPES)]]
            lines.append(
                f"ATOM  {serial:5d}  CA  {name} {chain}{resseq:4d}    "
                f"{pos[0]:8.3f}{pos[1]:8.3f}{pos[2]:8.3f}  1.00  0.00           C  \n"
            )
            serial += 1
    with open(path, "w") as fh:
        fh.writelines(lines)


def phase_scaffold(state):
    from genie2_tpu_torch.cli import sample_scaffold, sample_unconditional

    config = example_config()
    n_steps = config.diffusion["n_timestep"]
    work, rootdir, _ = release_dir(state)
    datadir = os.path.join(work, "problems")
    os.makedirs(datadir)
    write_motif_problem(os.path.join(datadir, "smoke_motif.pdb"))

    # name -> (flags, denoiser calls): guidance calls the model twice a step.
    runs = {
        "ancestral": (["--strength", "0"], n_steps),
        "ddim50_cfg": (["--ddim_steps", "50", "--ddim_eta", "0.5", "--strength", "1.5"], 2 * 50),
        "dpm25": (["--dpm_steps", "25"], 25),
    }
    state["launches_scaffold"] = {}
    for name, (flags, calls) in runs.items():
        outdir = os.path.join(work, f"scaffold_{name}")
        argv = common_argv(rootdir, outdir, "0.4") + [
            "--datadir", datadir, "--num_samples", "2", "--batch_size", "2", *flags]
        per_motif, seconds, launches = drive(sample_scaffold.main, argv)
        lengths = []
        for i in range(2):
            design = os.path.join(outdir, "motif=smoke_motif", "pdbs", f"smoke_motif_{i}.pdb")
            lengths.append(check_ca_file(design))
            if not TOTAL_RANGE[0] <= lengths[-1] <= TOTAL_RANGE[1]:
                raise PhaseFailed(f"{design}: length {lengths[-1]} outside {TOTAL_RANGE}")
            motif = os.path.join(outdir, "motif=smoke_motif", "motif_pdbs", f"smoke_motif_{i}.pdb")
            if check_ca_file(motif) != N_MOTIF:
                raise PhaseFailed(f"{motif}: not {N_MOTIF} motif residues")
            with open(design) as fh:
                marked = sum(1 for ln in fh if ln.startswith("ATOM") and ln[72] != " ")
            if marked != N_MOTIF:
                raise PhaseFailed(f"{design}: {marked} residues carry a motif group, expected {N_MOTIF}")
        emit({"phase": "scaffold", "run": name, "flags": flags, "lengths": lengths, "denoiser_calls": calls,
              "seconds": seconds, "seconds_per_motif_problem": per_motif["smoke_motif"], "samples": 2,
              "launches": launches, "smi": state["smi"]})
        state["launches_scaffold"][name] = launches
        want = expected_launches(config, calls)
        if launches != want:
            raise PhaseFailed(f"scaffold {name}: launch counts {launches}, expected {want}")

    # The unconditional CLI's packed sweep and trajectory dumps, at a short length.
    outdir = os.path.join(work, "out_pack")
    argv = common_argv(rootdir, outdir, "0.6") + [
        "--pack", "--num_samples", "1", "--batch_size", "2", "--min_length", "56", "--max_length", "64", "--length_step", "8"]
    _, seconds, launches = drive(sample_unconditional.main, argv)
    for L in (56, 64):
        check_ca_file(os.path.join(outdir, "pdbs", f"{L}_0.pdb"), L)
    emit({"phase": "scaffold", "run": "pack", "lengths": [56, 64], "seconds": seconds, "launches": launches})
    if launches != expected_launches(config, n_steps):
        raise PhaseFailed(f"pack: launch counts {launches}")

    outdir = os.path.join(work, "out_dump")
    every = 250
    argv = common_argv(rootdir, outdir, "0.6") + [
        "--dump_trajectory_every", str(every), "--num_samples", "2", "--batch_size", "2",
        "--min_length", "64", "--max_length", "64"]
    _, seconds, launches = drive(sample_unconditional.main, argv)
    steps = list(range(every, n_steps + 1, every))
    for step in steps:
        check_ca_file(os.path.join(outdir, "test", "64_0", f"xt_predicted_test_{step}.pdb"), 64)
    for i in range(2):
        check_ca_file(os.path.join(outdir, "pdbs", f"64_{i}.pdb"), 64)
    emit({"phase": "scaffold", "run": "dump_trajectory", "snapshot_steps": steps, "seconds": seconds, "launches": launches})
    if launches != expected_launches(config, n_steps):
        raise PhaseFailed(f"dump_trajectory: launch counts {launches}")


# ------------------------------------------------------------------ #
# Phase 6
# ------------------------------------------------------------------ #

SSE_LENGTH, SSE_PARTICLES = 128, 8


def phase_triatt(state):
    """The configuration with triangle attention through two entry points."""
    from genie2_tpu_torch.cli import sample_sse, sample_unconditional

    config = example_config(tri_att=True)
    n_steps = config.diffusion["n_timestep"]
    work, rootdir, name = release_dir(state, tri_att=True)

    L = 256
    outdir = os.path.join(work, "triatt_out")
    argv = common_argv(rootdir, outdir, "0.6", name) + [
        "--num_samples", "2", "--batch_size", "2", "--min_length", str(L), "--max_length", str(L)]
    per_length, seconds, launches = drive(sample_unconditional.main, argv)
    for i in range(2):
        check_ca_file(os.path.join(outdir, "pdbs", f"{L}_{i}.pdb"), L)
    emit({
        "phase": "triatt", "run": "unconditional", "configuration": "example + " + TRI_ATT_LINE.strip(),
        "length": L, "samples": 2, "batch": 2, "seconds": seconds,
        "samples_per_min_at_256": 2 / per_length[L] * 60.0, "ms_per_step_at_256": per_length[L] / n_steps * 1e3,
        "launches": launches, "coords_ok": True, "smi": state["smi"],
    })
    state["launches_triatt"] = launches
    want = expected_launches(config, n_steps)
    if launches != want:
        raise PhaseFailed(f"triatt unconditional: launch counts {launches}, expected {want}")

    outdir = os.path.join(work, "triatt_sse")
    argv = ["--name", name, "--epoch", "1", "--rootdir", rootdir, "--outdir", outdir, "--seed", str(SEED),
            "--device", "cuda", "--length", str(SSE_LENGTH), "--num_particles", str(SSE_PARTICLES),
            "--target", "helix", "--strength", "20"]
    result, seconds, launches = drive(sample_sse.main, argv)
    for i in range(SSE_PARTICLES):
        check_ca_file(os.path.join(outdir, "pdbs", f"{SSE_LENGTH}_{i}.pdb"), SSE_LENGTH)
    ess = result["ess_trace"]
    ess_ok = len(ess) == n_steps and all(1.0 - 1e-4 <= e <= SSE_PARTICLES + 1e-4 for e in ess)  # NaN fails too
    emit({
        "phase": "triatt", "run": "sse", "length": SSE_LENGTH, "particles": SSE_PARTICLES, "target": "helix",
        "strength": 20, "seconds": seconds, "ms_per_step": seconds / n_steps * 1e3,
        "soft_helix_mean": result["soft_mean"], "soft_helix_max": result["soft_max"],
        "hard_helix_mean": result["hard_mean"], "ess_min": result["ess_min"], "ess_mean": result["ess_mean"],
        "resamples": result["resamples"], "launches": launches, "smi": state["smi"],
        "note": "seeded random weights: the fractions say nothing about quality and are held to [0, 1] only",
    })
    state["launches_sse"] = launches
    if not ess_ok:
        raise PhaseFailed(f"sse: ESS trace of {len(ess)} steps outside [1, {SSE_PARTICLES}] or not finite")
    for key in ("soft_mean", "soft_max", "hard_mean"):
        if not 0.0 <= result[key] <= 1.0:
            raise PhaseFailed(f"sse: {key} = {result[key]} outside [0, 1]")
    if not 0 <= result["resamples"] <= n_steps:
        raise PhaseFailed(f"sse: {result['resamples']} resampling steps")
    want = expected_launches(config, n_steps)
    if launches != want:
        raise PhaseFailed(f"sse: launch counts {launches}, expected {want}")


# ------------------------------------------------------------------ #
# Phase 7
# ------------------------------------------------------------------ #

UNTWIST_BELOW = 50  # sampling/smc.py SMCSampler: no twisting (and no backward) below this step


def write_tds_target(path):
    """A MotifBench-style target: segments of 10 and 8 residues of one
    ideal helix (radius 2.3 A, rise 1.5 A, 100 degrees a residue), centred,
    separated by TER records, the scaffold length on line 3."""
    import numpy as np

    turn = np.radians(100.0) * np.arange(30)
    helix = np.stack([2.3 * np.cos(turn), 2.3 * np.sin(turn), 1.5 * np.arange(30)], axis=-1)
    segments = [(2, helix[2:2 + TDS_SEGMENTS[0]]), (18, helix[18:18 + TDS_SEGMENTS[1]])]
    centre = np.concatenate([seg for _, seg in segments]).mean(0)
    lines = ["HEADER    smoke motif\n", "TITLE     helix segments\n", f"REMARK    smoke : {TDS_LENGTH}\n"]
    serial = 1
    for first, seg in segments:
        for i, xyz in enumerate(seg - centre):
            lines.append(f"ATOM  {serial:5d}  CA  ALA A{first + i + 1:4d}    "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00           C  \n")
            serial += 1
        lines.append("TER\n")
    with open(path, "w") as fh:
        fh.writelines(lines)


def release_copy(state, steps: int):
    """The seeded release directory as a second one whose configuration
    has `steps` diffusion steps. Returns its name."""
    work, rootdir, name = release_dir(state)
    copy = f"{name}_t{steps}"
    if not os.path.isdir(os.path.join(rootdir, copy)):
        shutil.copytree(os.path.join(rootdir, name), os.path.join(rootdir, copy))
        path = os.path.join(rootdir, copy, "configuration")
        with open(path) as fh:
            text = re.sub(r"(?m)^numTimesteps .*$", f"numTimesteps {steps}", fh.read())
        with open(path, "w") as fh:
            fh.write(text)
    return copy


def posterior_gain(config, grad_alpha: float = 0.012, tausq: float = 0.012) -> float:
    """coef1 a / (var abar) at t = T: how many times |x_t| the posterior
    proposal's twist adds when x0 = (x_t - sqrt(1 - abar) eps) / sqrt(abar)
    is dominated by x_t (a noise prediction that does not follow x_t) and
    the gradient of the log-likelihood by (x0 - y) / (var sqrt(abar))."""
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.sampling import xstart_variance

    s = Schedule.create(config.diffusion["n_timestep"])
    t = s.n_timestep
    coef1 = s.sqrt_alphas_cumprod_prev[t] * s.betas[t] / s.one_minus_alphas_cumprod[t]
    return float(coef1 * grad_alpha / (xstart_variance(s.alphas_cumprod[t], tausq) * s.alphas_cumprod[t]))


# (proposal, score_grad_cap, twist_rotations, step; None: the first, T)
TDS_STEP_CASES = (
    ("posterior", 0.0, False, None),
    ("posterior", 0.0, True, UNTWIST_BELOW),
    ("score", 10.0, False, None),
    ("score", 10.0, True, UNTWIST_BELOW),
)


def compare_tds_steps(config, model, motif_dir):
    """One twisted step of sampling/smc.py:tds_sample_injected at L=75, 4
    particles, full width, eigh quaternions, on the tds phase's target with
    its 1000 placements, for each of TDS_STEP_CASES: the step with the
    kernels' Functions (forward and backward), then with every plain version
    swapped in. No resampling (ess_frac 0), so the step's result is the
    proposal; its twist, the twisted step's result less the untwisted one's
    on the same noise, is the shift of the mean that the gradient with
    respect to x_t makes (a multiple of it), held kernels against plain at
    DENOISER_TOL of its max, finite. The posterior proposal runs here at
    step T, where its gain is largest. Launches of the kernels' twisted step
    are counted: one forward and one backward."""
    import numpy as np
    import torch

    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.nn.policy import apply_denoiser
    from genie2_tpu_torch.sampling import (
        enumerate_motif_placements,
        load_motif_target,
        motif_frame_rotations,
        placements_to_positions,
        tds_sample_injected,
    )

    dev = torch.device("cuda")
    L, P = TDS_LENGTH, TDS_PARTICLES
    segments, length = load_motif_target(0, motif_dir)
    placements = enumerate_motif_placements(length, [len(x) for x in segments], max_offsets=1000,
                                            rng=np.random.default_rng(0))
    positions = torch.as_tensor(placements_to_positions(placements), device=dev)
    target = torch.as_tensor(np.concatenate(segments), device=dev)
    rots, rot_mask = (torch.as_tensor(a, device=dev) for a in motif_frame_rotations(segments))
    features = to_device(batchify([create_empty_features([L]) for _ in range(P)]), dev)
    schedule = Schedule.create(config.diffusion["n_timestep"], device=dev)
    with torch.no_grad():
        static_bias = model.pair_feature_net.static_bias(features, torch.float32)

    def model_fn(frames, t_vec):
        return apply_denoiser(model, frames, t_vec, features, static_bias)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    noise = torch.randn(1, P, L, 3, generator=gen, device=dev)
    x_first = torch.randn(P, L, 3, generator=gen, device=dev)
    for proposal, cap, rotations, step in TDS_STEP_CASES:
        t = step or schedule.n_timestep
        x = x_first if step is None else seeded_walk(P, L, dev)
        kw = dict(first_step=t, ess_frac=0.0, proposal=proposal, score_grad_cap=cap,
                  motif_rots=rots if rotations else None, rot_mask=rot_mask if rotations else None)

        def run(twisted):
            trans, _, trace, _ = tds_sample_injected(model_fn, schedule, features, positions, target, x, noise,
                                                     torch.zeros(1, device=dev), untwist_below=t if twisted else t + 1,
                                                     **kw)
            return trans, trace

        reset_counts()
        twisted_k, trace_k = run(True)
        torch.cuda.synchronize()
        launches = launch_counts()
        twist_k = twisted_k - run(False)[0]
        ms_k = cuda_time_ms(lambda: run(True), iters=3, warmup=1)
        with plain_kernels():
            twisted_p, trace_p = run(True)
            twist_p = twisted_p - run(False)[0]
            ms_p = cuda_time_ms(lambda: run(True), iters=3, warmup=1)
        err, scale = (twist_k - twist_p).abs().max().item(), twist_p.abs().max().item()
        rec = {
            "phase": "tds", "step_check": proposal, "score_grad_cap": cap, "twist_rotations": rotations, "t": t,
            "length": L, "particles": P, "placements": len(placements), "max_abs_err": err, "max_abs_twist": scale,
            "max_abs_x": x.abs().max().item(), "rel_err": err / max(scale, 1e-30), "tol": DENOISER_TOL,
            "finite": bool(torch.isfinite(twisted_k).all().item()),
            "ess_kernels": trace_k.ess.item(), "ess_plain": trace_p.ess.item(),
            "best_placement_kernels": trace_k.best_placement.item(),
            "best_placement_plain": trace_p.best_placement.item(),
            "ms_twisted_step_kernels": ms_k, "ms_twisted_step_plain": ms_p, "launches": launches,
        }
        emit(rec)
        if not rec["finite"] or rec["rel_err"] > DENOISER_TOL:
            raise PhaseFailed(f"tds step {proposal} t={t} rotations={rotations}: the twist disagrees or is not "
                              f"finite: rel {rec['rel_err']:.3g}")
        if launches != with_backward(config, 1, 1):
            raise PhaseFailed(f"tds step launches {launches}, expected {with_backward(config, 1, 1)}")


def phase_tds(state):
    """TDS/SMC motif scaffolding through its CLI at full width."""
    import json as json_

    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_motif_smc

    config = example_config()
    work, rootdir, name = release_dir(state)
    motif_dir = os.path.join(work, "tds_motifs")
    os.makedirs(motif_dir)
    write_tds_target(os.path.join(motif_dir, "0_smoke.pdb"))
    compare_tds_steps(config, state["model"], motif_dir)
    dump_every = 50
    # The production ("posterior") proposal twists the mean by
    # coef1 g a|g|/(a + |g|), about coef1 a g for a large gradient, which
    # no norm bounds: with seeded random weights, whose noise prediction
    # does not follow x_t, its first twisted step multiplies x_t by about
    # the gain below and the trajectory overflows. So the card takes the
    # score proposal with its soft cap, the same step up to that formula;
    # the posterior's arithmetic is held against genie2_tpu on the CPU.
    emit({"phase": "tds", "posterior_gain_at_T": posterior_gain(config)})
    runs = {
        # name -> (release, steps, flags)
        "score_capped": (name, config.diffusion["n_timestep"], ["--proposal", "score", "--score_grad_cap", "10"]),
        "score_rotations": (release_copy(state, 200), 200, [
            "--twist_rotations", "--proposal", "score", "--score_grad_cap", "10",
            "--dump_trajectory_every", str(dump_every)]),
    }
    for run, (release, steps, flags) in runs.items():
        outdir = os.path.join(work, f"tds_{run}")
        argv = ["--name", release, "--epoch", "1", "--rootdir", rootdir, "--outdir", outdir, "--seed", str(SEED),
                "--device", "cuda", "--motif_index", "0", "--motif_dir", motif_dir,
                "--num_particles", str(TDS_PARTICLES), "--scale", "1.0", "--max_offsets", "1000", *flags]
        torch.cuda.reset_peak_memory_stats()
        result, seconds, launches = drive(sample_motif_smc.main, argv)
        peak = torch.cuda.max_memory_allocated()
        for i in range(TDS_PARTICLES):
            check_ca_file(os.path.join(outdir, "pdbs", f"0_{i}.pdb"), TDS_LENGTH)
        with open(os.path.join(outdir, "motif_location.txt")) as fh:
            placed = [tuple(int(v) for v in ln.split("\t")) for ln in fh.read().split("\n") if ln]
        if [e - s + 1 for s, e in placed] != list(TDS_SEGMENTS) or not (
                0 <= placed[0][0] and placed[0][1] < placed[1][0] and placed[1][1] < TDS_LENGTH):
            raise PhaseFailed(f"tds {run}: motif_location.txt {placed}")
        for manifest in ("scaffold_info.csv", "motif_info.csv"):
            with open(os.path.join(outdir, manifest)) as fh:
                if len(fh.read().strip().split("\n")) != 1 + TDS_PARTICLES:
                    raise PhaseFailed(f"tds {run}: {manifest} has not one line a particle")
        with open(os.path.join(outdir, "logs", "metrics.jsonl")) as fh:
            records = [json_.loads(ln) for ln in fh]
        # A gradient that is not finite at a twisted step makes that step's
        # proposal, and every later x0 and motif distance, NaN.
        trace_ok = (len(records) == steps and [r["t"] for r in records] == list(range(steps, 0, -1))
                    and all(1.0 - 1e-4 <= r["ess"] <= TDS_PARTICLES + 1e-4 for r in records)
                    and all(np.isfinite(r["motif_dist"]) for r in records))
        snapshots = list(range(steps, 0, -1))[::dump_every] if "--dump_trajectory_every" in flags else []
        for step in snapshots:
            for tag in ("x0", "xt"):
                check_ca_file(os.path.join(outdir, "test", f"{tag}_predicted_test_{step}.pdb"), TDS_LENGTH)
        twisted = steps - UNTWIST_BELOW + 1
        want = with_backward(config, steps, twisted)
        rec = {
            "phase": "tds", "run": run, "flags": flags, "length": TDS_LENGTH, "particles": TDS_PARTICLES,
            "steps": steps, "twisted_steps": twisted, "placements": result["n_placements"],
            "placement": result["placement"], "seconds": result["seconds"], "seconds_with_load": seconds,
            "ms_per_step": result["seconds"] / steps * 1e3, "peak_memory_bytes": peak,
            "ess_min": result["ess_min"], "ess_mean": result["ess_mean"], "resamples": result["resamples"],
            "trace_ok": trace_ok, "snapshot_steps": snapshots, "launches": launches, "smi": state["smi"],
            "note": "seeded random weights: the placement and the ESS say nothing about quality",
        }
        emit(rec)
        state.setdefault("launches_tds", {})[run] = launches
        if not trace_ok:
            raise PhaseFailed(f"tds {run}: the trace has not {steps} finite records with ESS in [1, {TDS_PARTICLES}]")
        if result["n_placements"] != 1000:
            raise PhaseFailed(f"tds {run}: {result['n_placements']} placements, expected 1000")
        if launches != want:
            raise PhaseFailed(f"tds {run}: launch counts {launches}, expected {want}")


# ------------------------------------------------------------------ #
# Phase 8
# ------------------------------------------------------------------ #

TRAIN_STRUCTURES, TRAIN_LENGTHS, TRAIN_VAL = 32, (192, 256), 4  # corpus, lengths, validation structures
# The training step, kernels against plain: the loss and grad_norm
# relative, the gradient vector against its max |entry| (DENOISER_TOL).
TRAIN_LOSS_TOL, TRAIN_GRAD_NORM_TOL = 1e-5, 1e-4


def write_train_corpus(path):
    """TRAIN_STRUCTURES single-chain CA traces, seeded random walks of 3.8 A
    steps with random residue types, as PDB files."""
    import numpy as np

    from genie2_tpu_torch.features import create_empty_features, save_features_to_pdb

    rng = np.random.default_rng(SEED)
    os.makedirs(path)
    for i in range(TRAIN_STRUCTURES):
        length = int(rng.integers(TRAIN_LENGTHS[0], TRAIN_LENGTHS[1] + 1))
        f = create_empty_features([length])
        steps = rng.normal(size=(length, 3))
        f["atom_positions"] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True), axis=0)
        f["aatype"] = np.eye(20)[rng.integers(0, 20, length)].astype(int)
        save_features_to_pdb(f, os.path.join(path, f"walk_{i:03d}.pdb"))


def write_train_config(path, datadir, rootdir, epochs, val_split=TRAIN_VAL / TRAIN_STRUCTURES, extra=""):
    """configs/example.configuration pointed at the corpus, with a
    validation split of `val_split` (TRAIN_VAL structures of the corpus),
    `epochs` epochs, a checkpoint every epoch, a log record every step and
    the lines `extra`."""
    with open(os.path.join(HERE, "configs", "example.configuration")) as fh:
        text = fh.read()
    text = re.sub(r"(?m)^dataDirectory .*$", f"dataDirectory {datadir}", text)
    text = re.sub(r"(?m)^rootDirectory .*$", f"rootDirectory {rootdir}", text)
    text = re.sub(r"(?m)^numEpoches .*$", f"numEpoches {epochs}", text)
    text = re.sub(r"(?m)^checkpointEveryEpoches .*$", "checkpointEveryEpoches 1", text)
    text = re.sub(r"(?m)^logEverySteps .*$", "logEverySteps 1", text)
    text += f"validationSplit {val_split}\n{extra}"
    with open(path, "w") as fh:
        fh.write(text)


def remat_launches(config, steps: int):
    """The launches remat's second forward of the pair layers adds to
    `steps` training steps: every pair layer's TriMul kernels again (the
    structure layers are not rematerialised)."""
    return {k: v for k, v in expected_launches(config, steps).items() if k != "ipa_attention"}


def train_launches(config, steps: int, eval_calls: int, remat: bool = True):
    """Launch counts of `steps` training steps (forward, remat's second
    forward where `remat`, backward) and `eval_calls` validation forwards."""
    want = expected_launches(config, steps + eval_calls)
    extra = [backward_launches(config, steps)] + ([remat_launches(config, steps)] if remat else [])
    for table in extra:
        for k, v in table.items():
            want[k] += v
    return want


def train_metrics(workdir):
    """The train records of a run's metrics.jsonl, by step, and its val records."""
    train, val = {}, []
    with open(os.path.join(workdir, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("prefix") == "val":
                val.append(rec)
            else:
                train[rec["step"]] = rec
    return train, val


def phase_train(state):
    """Training at full width through cli/train.py, then one step held
    kernels against plain, a bf16 step, and the step's times and memory."""
    import math

    import torch

    from genie2_tpu_torch.cli import train
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.utils.model_io import load_model

    if "work" not in state:
        state["work"] = tempfile.mkdtemp(prefix="chip_smoke_")
    work = state["work"]
    datadir, rootdir, cfg = (os.path.join(work, d) for d in ("train_data", "train_runs", "train_configuration"))
    write_train_corpus(datadir)
    write_train_config(cfg, datadir, rootdir, epochs=2)
    config = Config(cfg)
    n_train = TRAIN_STRUCTURES - TRAIN_VAL
    per_epoch = n_train // config.training["batch_size"]

    torch.cuda.reset_peak_memory_stats()
    trainer, seconds, launches = drive(train.main, ["-c", cfg, "--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    records, val = train_metrics(trainer.workdir)
    steps = trainer.state.step
    losses = [records[s]["weighted_loss"] for s in sorted(records)]
    rates = [records[s]["residues_per_s"] for s in sorted(records)][1:]
    want = train_launches(config, steps, eval_calls=len(val))
    for epoch in (0, 1):
        model, _ = load_model(rootdir, config.io["name"], epoch=epoch, device="cuda")
        if sum(p.numel() for p in model.parameters()) != sum(p.numel() for p in trainer.model.parameters()):
            raise PhaseFailed(f"epoch={epoch}.ckpt does not load back")
    resume_ok = os.path.isfile(os.path.join(trainer.ckpt_dir, "resume_state"))
    rec = {
        "phase": "train", "run": "cli", "structures": n_train, "validation": TRAIN_VAL,
        "lengths": list(TRAIN_LENGTHS), "batch": config.training["batch_size"], "steps": steps, "seconds": seconds,
        "losses": losses, "val_losses": [v["val_loss"] for v in val],
        "residues_per_s_median": sorted(rates)[len(rates) // 2] if rates else None,
        "peak_memory_bytes": peak, "launches": launches, "expected_launches": want,
        "launches_per_step": {k: v / steps for k, v in launches.items()}, "resume_state": resume_ok,
        "smi": state["smi"],
    }
    emit(rec)
    state["launches_train"] = launches
    if steps != 2 * per_epoch or len(val) != 2:
        raise PhaseFailed(f"train: {steps} steps and {len(val)} validation records, expected {2 * per_epoch} and 2")
    if not all(math.isfinite(x) for x in losses + rec["val_losses"]):
        raise PhaseFailed("train: a loss is not finite")
    if not resume_ok:
        raise PhaseFailed("train: no resume_state")
    if launches != want:
        raise PhaseFailed(f"train: launch counts {launches}, expected {want}")

    write_train_config(cfg, datadir, rootdir, epochs=3)
    resumed, seconds, launches = drive(train.main, ["-c", cfg, "--device", "cuda", "--resume"])
    records, val = train_metrics(resumed.workdir)
    new = [s for s in sorted(records) if s > steps]
    emit({"phase": "train", "run": "resume", "version": resumed.version, "first_step": new[0] if new else None,
          "steps": resumed.state.step, "seconds": seconds, "launches": launches})
    if resumed.version != trainer.version or new != list(range(steps + 1, steps + per_epoch + 1)):
        raise PhaseFailed(f"train resume: version {resumed.version}, new steps {new}")
    if launches != train_launches(config, per_epoch, eval_calls=1):
        raise PhaseFailed(f"train resume: launch counts {launches}")

    compare_train_step(state, config, trainer)


def _train_setup(config, batch_source, remat=True):
    """A seeded full-width model (zero-initialised leaves randomised, as
    seeded_denoiser), its train state, one batch of the corpus on the card,
    and fixed t, noise and dropout seed."""
    import copy

    import numpy as np
    import torch

    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.train import create_train_state
    from genie2_tpu_torch.utils.model_io import init_model
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    dev = torch.device("cuda")
    config = copy.deepcopy(config)
    config.tpu["remat"] = remat
    model = randomize_zero_init(init_model(config, SEED, "cpu"), SEED).to(dev)
    batch = next(batch_source.epoch(config.training["batch_size"], np.random.default_rng(SEED)))
    feats = to_device(batch, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = torch.randint(1, config.diffusion["n_timestep"] + 1, (feats["atom_positions"].shape[0],), generator=gen,
                      device=dev)
    noise = torch.randn(feats["atom_positions"].shape, generator=gen, device=dev)
    return create_train_state(model, config.optimization["lr"]), feats, dict(t=t, noise=noise, dropout_seed=SEED)


def step_times(step, state, feats, inject, n=4):
    """Wall ms of n steps (synchronised), the median after the first."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, feats, **inject)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rest = sorted(times[1:])
    return rest[len(rest) // 2], times


def device_ms(step, state, feats, inject, n=2):
    """Device ms a step (CUDA kernels and copies under torch.profiler)."""
    events = device_events(lambda: step(state, feats, **inject), iters=n, warmup=0)
    us = sum(e.time_range.elapsed_us() for e in events)
    return us / 1e3 / n if us > 0 else None


def compare_train_step(state, config, trainer):
    """One training step at full width (batch 4 of the corpus, L <= 256,
    fp32, remat and dropout on) with the kernels, then from the same state,
    batch, t, noise and dropout seed with every plain version swapped in:
    loss, gradient vector and grad_norm compared, launches counted. Then
    times, device time, peak memory with remat on and off, and one bf16
    step from the same state."""
    import copy
    import math

    import torch

    from genie2_tpu_torch.train import make_train_step

    train_state, feats, inject = _train_setup(config, trainer_dataset(trainer, config))
    plain_state = copy.deepcopy(train_state)
    bf16_state = copy.deepcopy(train_state)
    step = make_train_step(trainer.schedule, config.training["condition_loss_weight"])

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    m_k = step(train_state, feats, **inject)
    torch.cuda.synchronize()
    peak_remat = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    g_k = torch.cat([p.grad.flatten() for p in train_state.model.parameters()])
    with plain_kernels():
        m_p = step(plain_state, feats, **inject)
        g_p = torch.cat([p.grad.flatten() for p in plain_state.model.parameters()])
        plain_ms, _ = step_times(step, plain_state, feats, inject, n=3)
    loss_k, loss_p = float(m_k["weighted_loss"]), float(m_p["weighted_loss"])
    gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    err, scale = (g_k - g_p).abs().max().item(), g_p.abs().max().item()
    rec = {
        "phase": "train", "step_check": "kernels vs plain", "B": feats["atom_positions"].shape[0],
        "L": feats["atom_positions"].shape[1], "loss_kernels": loss_k, "loss_plain": loss_p,
        "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p), "loss_tol": TRAIN_LOSS_TOL,
        "grad_max_abs_err": err, "grad_max_abs": scale, "grad_rel_err": err / max(scale, 1e-30),
        "grad_tol": DENOISER_TOL, "grad_norm_kernels": gn_k, "grad_norm_plain": gn_p,
        "grad_norm_rel_err": abs(gn_k - gn_p) / gn_p, "grad_norm_tol": TRAIN_GRAD_NORM_TOL,
        "finite": bool(torch.isfinite(g_k).all().item()), "launches_one_step": launches,
    }
    ms, times = step_times(step, train_state, feats, inject)
    dev_ms = device_ms(step, train_state, feats, inject)
    n_res = int(feats["residue_mask"].sum().item())
    rec.update({
        "ms_per_step": ms, "ms_steps": times, "plain_ms_per_step": plain_ms, "residues": n_res,
        "residues_per_s": n_res / ms * 1e3, "device_ms_per_step": dev_ms,
        "busy_share": dev_ms / ms if dev_ms else None, "peak_memory_bytes_remat": peak_remat,
    })

    # remat off: the same step on a model without checkpointing.
    no_remat, feats_nr, inject_nr = _train_setup(config, trainer_dataset(trainer, config), remat=False)
    torch.cuda.reset_peak_memory_stats()
    step(no_remat, feats_nr, **inject_nr)
    torch.cuda.synchronize()
    rec["peak_memory_bytes_no_remat"] = torch.cuda.max_memory_allocated()
    rec["ms_per_step_no_remat"], _ = step_times(step, no_remat, feats_nr, inject_nr, n=3)
    del no_remat

    step16 = make_train_step(trainer.schedule, config.training["condition_loss_weight"], "bf16")
    m16 = step16(bf16_state, feats, **inject)
    rec.update({"loss_bf16": float(m16["weighted_loss"]), "grad_norm_bf16": float(m16["grad_norm"])})
    rec["ms_per_step_bf16"], _ = step_times(step16, bf16_state, feats, inject, n=3)
    rec["device_ms_per_step_bf16"] = device_ms(step16, bf16_state, feats, inject)
    rec["smi"] = state["smi"]
    emit(rec)
    state["train_step"] = rec
    if not rec["finite"] or rec["loss_rel_err"] > TRAIN_LOSS_TOL or rec["grad_rel_err"] > DENOISER_TOL \
            or rec["grad_norm_rel_err"] > TRAIN_GRAD_NORM_TOL:
        raise PhaseFailed(f"train step: kernels against plain: loss {rec['loss_rel_err']:.3g}, gradient "
                          f"{rec['grad_rel_err']:.3g}, grad_norm {rec['grad_norm_rel_err']:.3g}")
    if launches != train_launches(config, 1, eval_calls=0):
        raise PhaseFailed(f"train step launches {launches}, expected {train_launches(config, 1, 0)}")
    # tests/test_torch_train.py's bound between the bf16 and float32 losses.
    if not math.isfinite(rec["loss_bf16"]) or abs(rec["loss_bf16"] - loss_k) > 0.1:
        raise PhaseFailed(f"train step bf16: loss {rec['loss_bf16']} against {loss_k}")


def trainer_dataset(trainer, config):
    """The training corpus as the CLI split it (its packed cache)."""
    from genie2_tpu_torch.train import MotifAugmentConfig, StructureDataset

    cache = os.path.join(config.io["rootdir"], config.io["name"], "parsed_cache")
    return StructureDataset([], config.io["max_n_res"], config.io["max_n_chain"],
                            motif=MotifAugmentConfig.from_config(config), cache_path=cache)


# ------------------------------------------------------------------ #
# Phase 9
# ------------------------------------------------------------------ #

PARALLEL_RANKS = 2  # gloo ranks sharing the one card (NCCL refuses two ranks on one GPU)
PARALLEL_TRAIN_STEPS = 3
PARALLEL_SAMPLES, PARALLEL_DDIM = 4, 50  # the sample run: L=256, DDIM-50
# The tds run's steps: SMCSampler twists where t >= UNTWIST_BELOW, so 100
# steps twist 51 times (50 would twist once).
PARALLEL_TDS_STEPS = 100
# Sharded against one process: coordinates of the sample run (Angstrom),
# of one twisted TDS step (tests/test_smc.py's bound for genie2_tpu's mesh).
PARALLEL_SAMPLE_TOL, PARALLEL_TDS_TOL = 1e-4, 2e-5
# The size of the perturbation of x_T that shows how far one process's own
# TDS trajectory moves from a change at float32 rounding's scale.
TDS_PERTURBATION = 1e-6


def tds_segment(mesh, plan, steps, perturb=0.0):
    """`steps` steps of the tds phase's problem from t = T of the 1000-step
    release (tds_sample_injected with first_step=T: x_T and the noise from
    the (seed, particle, step) streams, the score proposal with cap 10, this
    rank's particles, the model split over the mesh's model axis), x_T
    moved by `perturb` times a seeded normal draw.
    Returns every particle's coordinates, each particle's best placement,
    the ESS and the resampling decisions."""
    import numpy as np
    import torch

    from genie2_tpu_torch.features import batchify, create_empty_features, to_device
    from genie2_tpu_torch.parallel import local_rows, shard_batch
    from genie2_tpu_torch.sampling import SMCSampler
    from genie2_tpu_torch.sampling.ddpm import init_translations, step_noise
    from genie2_tpu_torch.sampling.motif_target import load_motif_target
    from genie2_tpu_torch.sampling.resampling import resampling_draws, resampling_generator
    from genie2_tpu_torch.sampling.smc import tds_sample_injected
    from genie2_tpu_torch.sampling.twisting import enumerate_motif_placements, placements_to_positions
    from genie2_tpu_torch.utils.model_io import load_pretrained_model

    dev = torch.device("cuda")
    model, config = load_pretrained_model(plan["rootdir"], plan["release"], 1, device=dev, mesh=mesh)
    sampler = SMCSampler(model, config, mesh=mesh)
    segments, length = load_motif_target(0, plan["motif_dir"])
    placements = enumerate_motif_placements(length, [len(seg) for seg in segments], max_offsets=1000,
                                            rng=np.random.default_rng(0))
    feats = to_device(shard_batch(batchify([create_empty_features([length])] * TDS_PARTICLES), mesh), dev)
    with torch.no_grad():
        model_fn = sampler.make_model_fn(feats)
    rows = local_rows(TDS_PARTICLES, mesh)
    ids = list(range(rows.start, rows.stop))
    T = config.diffusion["n_timestep"]
    init = init_translations(feats, SEED, ids)
    if perturb:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        init = init + perturb * torch.randn(init.shape, generator=gen, device=dev)
    offsets = resampling_draws("systematic", TDS_PARTICLES, resampling_generator(SEED), steps=T)[:steps]
    trans, score, trace, _ = tds_sample_injected(
        model_fn, sampler.schedule, feats, torch.from_numpy(placements_to_positions(placements)),
        torch.from_numpy(np.concatenate(segments)), init,
        torch.stack([step_noise(SEED, ids, t, length) for t in range(T, T - steps, -1)]), offsets,
        1.0, untwist_below=UNTWIST_BELOW, proposal="score", score_grad_cap=10.0, first_step=T, mesh=mesh)
    return {"x": trans.cpu().numpy(), "best": score.argmax(1).tolist(), "ess": trace.ess.tolist(),
            "resampled": trace.resampled.tolist()}


def parallel_rank(rank, plan):
    """The parallel phase's work in one process: PARALLEL_TRAIN_STEPS
    training steps on this rank's rows of the batch, the TDS segments of
    `plan`, then the CLIs of `plan` (the unconditional CLI with DDIM, the
    TDS CLI), with `--num_devices` where `plan` says `distributed`. Launch
    counts, times and results of each run; the heavy tensors (each step's
    gradient, the parameters after the last) from rank 0 only, a checksum
    of the parameters from every rank."""
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_motif_smc, sample_unconditional
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.parallel import create_mesh, shard_batch
    from genie2_tpu_torch.parallel.mesh import average_gradients
    from genie2_tpu_torch.sampling import base
    from genie2_tpu_torch.train import create_train_state, make_train_step, step_randomness
    from genie2_tpu_torch.utils.model_io import init_model
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    distributed = plan["distributed"]
    mesh = create_mesh(-1, dev) if distributed else None
    out = {}

    # Training steps.
    config = Config(plan["train_config"])
    model = randomize_zero_init(init_model(config, SEED, "cpu"), SEED).to(dev)
    state = create_train_state(model, config.optimization["lr"])
    step = make_train_step(Schedule.create(config.diffusion["n_timestep"], device=dev),
                           config.training["condition_loss_weight"], mesh=mesh)
    feats = to_device(shard_batch(plan["batch"], mesh), dev)
    reset_counts()
    metrics, times, grads = [], [], []
    for i in range(PARALLEL_TRAIN_STEPS):
        rng, dropout_seed = step_randomness(SEED, 0, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, feats, rng=rng, dropout_seed=dropout_seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if rank == 0:
            grads.append(torch.cat([p.grad.flatten() for p in model.parameters()]).cpu())
    launches = launch_counts()
    params = torch.cat([p.detach().flatten() for p in model.parameters()]).double()
    # The step's gradient all-reduce (the span genie2:grad_allreduce) again, timed
    # alone on the last step's gradients (the same on every rank, so their
    # mean leaves them as they are).
    allreduce_ms = []
    if mesh is not None:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            average_gradients([p.grad for p in model.parameters()], mesh)
            torch.cuda.synchronize()
            allreduce_ms.append((time.perf_counter() - t0) * 1e3)
    out["train"] = {
        "metrics": metrics, "ms_steps": times, "grad_allreduce_ms": allreduce_ms, "launches": launches,
        "rows": int(feats["residue_mask"].shape[0]),
        "param_checksum": [params.sum().item(), params.abs().sum().item()],
    }
    if rank == 0:
        out["train"]["grads"] = grads
        out["train"]["params"] = params.float().cpu()
    del model, state, feats

    out["segments"] = {label: tds_segment(mesh, plan, steps, perturb)
                       for label, (steps, perturb) in plan["segments"].items()}

    # The sampling CLIs: the samples each returns, on every rank.
    samples = []
    sample = base.BaseSampler.sample

    def capture(self, params):
        result = sample(self, params)
        samples.append(np.stack([f["atom_positions"] for f in result]))
        return result

    base.BaseSampler.sample = capture
    flags = ["--num_devices", str(PARALLEL_RANKS)] if distributed else []
    mains = {"sample": sample_unconditional.main, "tds": sample_motif_smc.main}
    try:
        for run, argv in plan["clis"].items():
            samples.clear()
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = mains[run.split("_")[0]](argv + flags)
            torch.cuda.synchronize()
            out[run] = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
                        "coords": np.concatenate(samples)}
            if run == "tds":
                out[run].update(placement=result["placement"], ess_trace=result["ess_trace"],
                                resamples=result["resamples"], tds_seconds=result["seconds"])
    finally:
        base.BaseSampler.sample = sample
    return out


def _params_against_adam(got, want, grads_got, grads_want, lr):
    """Parameters after len(grads_want) Adam steps (flattened) against one
    process's, from each run's gradients at every step. To first order a
    gradient difference D moves Adam's update m / sqrt(v) by at most
    2 D / sqrt(v), so over `steps` steps an entry whose sqrt(v) (bias
    corrected, at every step) is at least 2 x steps x 1e3 times its largest
    gradient difference so far moves by at most 1e-3 lr. Held: those
    entries, with sqrt(v) at least 1e-5 (the floor of
    tests/test_torch_train.py:_params_close), within that test's 1e-3 lr
    plus the float32 rounding of each step's stored parameter, a unit in
    the last place a step (at lr 1e-4, 1e-3 lr is below the spacing of
    float32 numbers above 0.84); every entry within Adam's bound of lr a
    step either way; an entry whose gradient was 0 at every step in both
    runs not moved at all. Reported: that test's own set (sqrt(v) >= 1e-5
    alone), which at full width holds entries whose gradient's relative
    rounding difference exceeds 1e-3, beyond what any float32 reduction
    order keeps within 1e-3 lr."""
    import torch

    steps = len(grads_want)
    err = (got.double() - want.double()).abs()
    v = torch.zeros_like(err)
    diff = torch.zeros_like(err)
    ratio = torch.full_like(err, float("inf"))
    root = torch.full_like(err, float("inf"))
    still = torch.ones_like(err, dtype=torch.bool)
    for t, (g, w) in enumerate(zip(grads_got, grads_want), 1):
        g, w = g.double(), w.double()
        v = 0.999 * v + 0.001 * w * w
        diff = torch.maximum(diff, (g - w).abs())
        r = torch.sqrt(v / (1 - 0.999 ** t))
        root = torch.minimum(root, r)
        ratio = torch.minimum(ratio, r / diff)
        still &= (g == 0) & (w == 0)
    held = (root >= 1e-5) & (ratio >= 2 * steps * 1e3)
    w32 = want.float().abs()
    tol = 1e-3 * lr + steps * (torch.nextafter(w32, torch.tensor(float("inf"))) - w32).double()
    cpu_rule = root >= 1e-5
    return {"max_err": err.max().item(), "bound": 2 * steps * lr, "tol": 1e-3 * lr,
            "held_share": held.double().mean().item(),
            "held_max_err": err[held].max().item() if held.any() else 0.0,
            "held_max_err_over_tol": (err / tol)[held].max().item() if held.any() else 0.0,
            "cpu_rule_share": cpu_rule.double().mean().item(),
            "cpu_rule_max_err": err[cpu_rule].max().item() if cpu_rule.any() else 0.0,
            "still_share": still.double().mean().item(),
            "still_max_err": err[still].max().item() if still.any() else 0.0}


def run_process_group(cmd, timeout):
    """Run `cmd` in its own session, killed with everything it started at
    `timeout` seconds. Returns (exit code, stdout, stderr)."""
    import signal as signal_

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal_.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err
    return proc.returncode, out, err


def torchrun_train(argv):
    """Entry of the parallel phase's torchrun process (one NCCL rank):
    cli/train.py on the configuration argv[1] (`--distributed`), then again
    on argv[2] with `--resume`; each run's launch counts, steps, version and
    the process group's shape written as JSON to argv[0]."""
    import torch
    import torch.distributed as dist

    from genie2_tpu_torch.cli import train

    runs = []
    for cfg, extra in ((argv[1], []), (argv[2], ["--resume"])):
        reset_counts()
        trainer = train.main(["-c", cfg, "--device", "cuda", "--distributed", *extra])
        torch.cuda.synchronize()
        runs.append({"flags": extra, "launches": launch_counts(), "steps": trainer.state.step,
                     "version": trainer.version, "world": dist.get_world_size(), "backend": str(dist.get_backend()),
                     "device": str(trainer.device), "mesh": trainer.mesh is not None})
    with open(argv[0], "w") as fh:
        json.dump(runs, fh)
    dist.destroy_process_group()
    return 0


def phase_parallel(state):
    """Data parallelism: two gloo ranks on the card against one process
    (training steps, the DDIM sample run, the TDS run), then cli/train.py
    under torchrun as one NCCL rank, with --resume."""
    import numpy as np
    import torch

    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel.spawn import run_ranks
    from genie2_tpu_torch.train import MotifAugmentConfig, StructureDataset
    from genie2_tpu_torch.utils.model_io import load_model

    work, rootdir, name = release_dir(state)
    config = example_config()
    train_cfg = os.path.join(work, "train_configuration")
    tconfig = Config(train_cfg)
    cache = os.path.join(tconfig.io["rootdir"], tconfig.io["name"], "parsed_cache")
    dataset = StructureDataset([], tconfig.io["max_n_res"], tconfig.io["max_n_chain"],
                               motif=MotifAugmentConfig.from_config(tconfig), cache_path=cache)
    batch = next(dataset.epoch(tconfig.training["batch_size"], np.random.default_rng(SEED)))
    tds_release = release_copy(state, PARALLEL_TDS_STEPS)
    motif_dir = os.path.join(work, "tds_motifs")

    def plan(label, distributed):
        outdir = os.path.join(work, f"parallel_{label}")

        def sample(name, batch_size):
            return common_argv(rootdir, os.path.join(outdir, name), "0.6") + [
                "--num_samples", str(PARALLEL_SAMPLES), "--batch_size", str(batch_size), "--min_length", "256",
                "--max_length", "256", "--ddim_steps", str(PARALLEL_DDIM), "--ddim_eta", "0.5"]

        tds = ["--name", tds_release, "--epoch", "1", "--rootdir", rootdir, "--outdir", os.path.join(outdir, "tds"),
               "--seed", str(SEED), "--device", "cuda", "--motif_index", "0", "--motif_dir", motif_dir,
               "--num_particles", str(TDS_PARTICLES), "--scale", "1.0", "--max_offsets", "1000", "--proposal",
               "score", "--score_grad_cap", "10"]
        # Two ranks run a batch of 4 as two calls of 2 rows; one process runs
        # those rows as its batches of 2 (the same calls), and a batch of 4
        # beside them.
        clis = {"sample": sample("sample", PARALLEL_SAMPLES), "tds": tds}
        segments = {"one_step": (1, 0.0), "two_steps": (2, 0.0)}
        if not distributed:
            clis.update(sample=sample("sample", PARALLEL_SAMPLES // PARALLEL_RANKS),
                        sample_batch4=sample("sample_batch4", PARALLEL_SAMPLES))
            segments.update(one_step_perturbed=(1, TDS_PERTURBATION), two_steps_perturbed=(2, TDS_PERTURBATION))
        return {"distributed": distributed, "train_config": train_cfg, "batch": batch, "clis": clis,
                "segments": segments, "rootdir": rootdir, "release": name, "motif_dir": motif_dir}, outdir

    alone_plan, alone_dir = plan("alone", False)
    ranks_plan, ranks_dir = plan("ranks", True)
    t0 = time.perf_counter()
    alone = parallel_rank(0, alone_plan)
    alone_s = time.perf_counter() - t0
    # The tp phase holds its model ranks against the same one-process runs.
    state["parallel_alone"], state["parallel_plan"] = alone, alone_plan
    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PARALLEL_RANKS, (ranks_plan,), deadline=480.0)
    ranks_s = time.perf_counter() - t0
    failures = []
    summed = {run: {k: sum(r[run]["launches"][k] for r in ranks) for k in ranks[0][run]["launches"]}
              for run in ("train", "sample", "tds")}
    twisted = PARALLEL_TDS_STEPS - UNTWIST_BELOW + 1
    # One process's launches; the ranks' summed are those of each rank's
    # calls: PARALLEL_RANKS x the training steps and the TDS run (each rank
    # calls the denoiser once a step), the sample run's calls (each rank one
    # call a step on its rows, one process one call a step a batch of 2).
    want = {"train": train_launches(config, PARALLEL_TRAIN_STEPS, eval_calls=0),
            "sample": expected_launches(config, PARALLEL_RANKS * PARALLEL_DDIM),
            "tds": with_backward(config, PARALLEL_TDS_STEPS, twisted)}
    want_ranks = {run: table if run == "sample" else {k: PARALLEL_RANKS * v for k, v in table.items()}
                  for run, table in want.items()}
    note = "two gloo ranks share one card: these numbers show correctness and overhead, not scaling"

    # train: each step's metrics and reduced gradient, the parameters.
    a_train, r_train = alone["train"], ranks[0]["train"]
    metric_err = max(abs(r["train"]["metrics"][i][k] - v) / max(abs(v), 1e-12)
                     for r in ranks for i, m in enumerate(a_train["metrics"]) for k, v in m.items())
    grad_diffs = [(g - w).abs().max().item() for g, w in zip(r_train["grads"], a_train["grads"])]
    grad_errs = [d / w.abs().max().item() for d, w in zip(grad_diffs, a_train["grads"])]
    grad_err = max(grad_errs)
    lr = tconfig.optimization["lr"]
    adam = _params_against_adam(r_train["params"], a_train["params"], r_train["grads"], a_train["grads"], lr)
    same_params = all(r["train"]["param_checksum"] == r_train["param_checksum"] for r in ranks)
    rec = {
        "phase": "parallel", "run": "train", "ranks": PARALLEL_RANKS, "backend": "gloo", "batch": len(batch["aatype"]),
        "rows_per_rank": [r["train"]["rows"] for r in ranks], "L": int(batch["aatype"].shape[1]),
        "steps": PARALLEL_TRAIN_STEPS, "metric_rel_err": metric_err, "metric_tol": TRAIN_LOSS_TOL,
        "grad_rel_err": grad_err, "grad_rel_err_per_step": grad_errs, "grad_tol": 1e-4, "params": adam,
        "ranks_same_params": same_params,
        "ms_per_step_one_process": sorted(a_train["ms_steps"][1:])[0],
        "ms_per_step_two_ranks": max(sorted(r["train"]["ms_steps"][1:])[0] for r in ranks),
        "ms_steps": {"one_process": a_train["ms_steps"], "ranks": [r["train"]["ms_steps"] for r in ranks]},
        "grad_allreduce_ms": [r["train"]["grad_allreduce_ms"] for r in ranks],
        "launches_summed": summed["train"], "expected_launches": want_ranks["train"],
        "launches_one_process": a_train["launches"], "note": note, "smi": state["smi"],
    }
    emit(rec)
    if metric_err > TRAIN_LOSS_TOL or grad_err > 1e-4 or not same_params or adam["max_err"] > adam["bound"] \
            or adam["held_max_err_over_tol"] > 1 or adam["still_max_err"] > 0 or adam["held_share"] == 0:
        failures.append(f"train: metrics {metric_err:.3g}, gradient {grad_err:.3g}, parameters {adam}, "
                        f"same on every rank {same_params}")
    for run in ("train", "sample", "tds"):
        if summed[run] != want_ranks[run] or alone[run]["launches"] != want[run]:
            failures.append(f"{run}: launches {summed[run]} over the ranks, {alone[run]['launches']} alone, "
                            f"expected {want_ranks[run]} / {want[run]}")

    # sample: the files and the coordinates behind them, against one
    # process running the ranks' rows as its batches.
    differ, files = 0, sorted(os.listdir(os.path.join(alone_dir, "sample", "pdbs")))
    for f in files:
        with open(os.path.join(alone_dir, "sample", "pdbs", f), "rb") as a, \
                open(os.path.join(ranks_dir, "sample", "pdbs", f), "rb") as b:
            differ += a.read() != b.read()
    coord_err = max(float(np.abs(r["sample"]["coords"] - alone["sample"]["coords"]).max()) for r in ranks)
    batch4_err = float(np.abs(alone["sample_batch4"]["coords"] - alone["sample"]["coords"]).max())
    rec = {"phase": "parallel", "run": "sample", "ranks": PARALLEL_RANKS, "samples": PARALLEL_SAMPLES, "L": 256,
           "ddim_steps": PARALLEL_DDIM, "files": len(files), "files_differing": differ, "coord_max_abs_err": coord_err,
           "coord_tol": PARALLEL_SAMPLE_TOL, "one_process_batch4_vs_batch2_coord_max_abs_err": batch4_err,
           "seconds_one_process_batch4": alone["sample_batch4"]["seconds"],
           "seconds_two_ranks": max(r["sample"]["seconds"] for r in ranks),
           "launches_summed": summed["sample"], "note": note, "smi": state["smi"]}
    emit(rec)
    if len(files) != PARALLEL_SAMPLES or coord_err > PARALLEL_SAMPLE_TOL:
        failures.append(f"sample: {len(files)} files, {differ} differ, coordinates {coord_err:.3g}")
    for f in files:
        check_ca_file(os.path.join(ranks_dir, "sample", "pdbs", f), 256)

    # tds: one twisted step from t = T held (placements, decisions,
    # coordinates); what two steps, and one process's own trajectory moved
    # by TDS_PERTURBATION at x_T, show of the problem's sensitivity.
    seg = alone["segments"]
    step_rec = {}
    for label in ("one_step", "two_steps"):
        a = seg[label]
        step_rec[label] = {
            "coord_max_abs_err": max(float(np.abs(r["segments"][label]["x"] - a["x"]).max()) for r in ranks),
            "best_same": all(r["segments"][label]["best"] == a["best"] for r in ranks),
            "decisions_same": all(r["segments"][label]["resampled"] == a["resampled"] for r in ranks),
            "ess_max_abs_err": max(float(np.abs(np.subtract(r["segments"][label]["ess"], a["ess"])).max()) for r in ranks),
            "perturbed_coord_max_abs_err": float(np.abs(seg[label + "_perturbed"]["x"] - a["x"]).max()),
            "perturbed_best_same": seg[label + "_perturbed"]["best"] == a["best"],
            "max_abs_x": float(np.abs(a["x"]).max()), "ess": a["ess"], "resampled": a["resampled"],
        }
    one = step_rec["one_step"]

    def trace(outdir):
        with open(os.path.join(outdir, "tds", "logs", "metrics.jsonl")) as fh:
            return [json.loads(line) for line in fh]

    a_tr, r_tr = trace(alone_dir), trace(ranks_dir)
    diverged = next((i for i, (a, b) in enumerate(zip(a_tr, r_tr)) if a["resampled"] != b["resampled"]), None)
    with open(os.path.join(ranks_dir, "tds", "motif_location.txt")) as fh:
        placed = [tuple(int(v) for v in ln.split("\t")) for ln in fh.read().split("\n") if ln]
    trace_ok = (len(r_tr) == PARALLEL_TDS_STEPS and all(1.0 - 1e-4 <= r["ess"] <= TDS_PARTICLES + 1e-4 for r in r_tr)
                and all(np.isfinite(r["motif_dist"]) for r in r_tr)
                and [e - s_ + 1 for s_, e in placed] == list(TDS_SEGMENTS))
    rec = {"phase": "parallel", "run": "tds", "ranks": PARALLEL_RANKS, "particles": TDS_PARTICLES,
           "length": TDS_LENGTH, "one_twisted_step_at_T": one, "two_steps_from_T": step_rec["two_steps"],
           "perturbation": TDS_PERTURBATION, "coord_tol": PARALLEL_TDS_TOL,
           "cli": {"steps": PARALLEL_TDS_STEPS, "twisted_steps": PARALLEL_TDS_STEPS - UNTWIST_BELOW + 1,
                   "placement_two_ranks": ranks[0]["tds"]["placement"], "placement_one_process": alone["tds"]["placement"],
                   "first_step_whose_decision_differs": diverged, "trace_ok": trace_ok,
                   "coord_max_abs_err": max(float(np.abs(r["tds"]["coords"] - alone["tds"]["coords"]).max())
                                            for r in ranks),
                   "resamples_one_process": alone["tds"]["resamples"], "resamples_two_ranks": ranks[0]["tds"]["resamples"]},
           "ms_per_step_one_process": alone["tds"]["tds_seconds"] / PARALLEL_TDS_STEPS * 1e3,
           "ms_per_step_two_ranks": max(r["tds"]["tds_seconds"] for r in ranks) / PARALLEL_TDS_STEPS * 1e3,
           "launches_summed": summed["tds"], "note": note, "smi": state["smi"]}
    emit(rec)
    if not (one["best_same"] and one["decisions_same"]) or one["coord_max_abs_err"] > PARALLEL_TDS_TOL \
            or one["ess_max_abs_err"] > 1e-2 or not trace_ok:
        failures.append(f"tds: one step from T {one}, the CLI's trace and placement {trace_ok}")

    # cli/train.py under torchrun: one NCCL rank, 2 epochs, then --resume to 3.
    nccl_root = os.path.join(work, "train_runs_nccl")
    per_epoch = (TRAIN_STRUCTURES - TRAIN_VAL) // tconfig.training["batch_size"]
    cfgs = [os.path.join(work, f"train_configuration_nccl_{epochs}") for epochs in (2, 3)]
    for cfg, epochs in zip(cfgs, (2, 3)):
        write_train_config(cfg, tconfig.io["datadir"], nccl_root, epochs=epochs)
    out_json = os.path.join(work, "torchrun.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           os.path.join(HERE, "chip_smoke.py"), "--torchrun-train", out_json, *cfgs]
    t0 = time.perf_counter()
    code, stdout, stderr = run_process_group(cmd, timeout=300)
    seconds = time.perf_counter() - t0
    if code != 0 or not os.path.isfile(out_json):
        raise PhaseFailed(f"torchrun cli/train.py: exit {code}\n{stdout[-2000:]}\n{stderr[-3000:]}")
    with open(out_json) as fh:
        runs = json.load(fh)
    for res, steps, evals in zip(runs, (2 * per_epoch, per_epoch), (2, 1)):
        expect = train_launches(config, steps, eval_calls=evals)
        emit({"phase": "parallel", "run": "torchrun_train", **res, "expected_launches": expect, "smi": state["smi"]})
        if res["world"] != 1 or res["backend"] != "nccl" or not res["mesh"] or res["launches"] != expect:
            failures.append(f"torchrun {res['flags']}: {res}, expected launches {expect}")
    emit({"phase": "parallel", "run": "torchrun_train", "seconds_with_start": seconds})
    if runs[1]["version"] != runs[0]["version"] or runs[1]["steps"] != 3 * per_epoch:
        failures.append(f"torchrun --resume: {runs}")
    for epoch in (0, 1, 2):
        model, _ = load_model(nccl_root, tconfig.io["name"], epoch=epoch, device="cuda")
        if not all(torch.isfinite(p).all() for p in model.parameters()):
            failures.append(f"torchrun: epoch={epoch}.ckpt is not finite")
    state["launches_parallel"] = {"train": summed["train"], "sample": summed["sample"], "tds": summed["tds"],
                                  "torchrun_train": runs[0]["launches"]}
    emit({"phase": "parallel", "seconds_one_process": alone_s, "seconds_two_ranks_with_start": ranks_s})
    if failures:
        raise PhaseFailed("; ".join(failures))


# ------------------------------------------------------------------ #
# Phase 10
# ------------------------------------------------------------------ #

TP_RANKS = 2  # model ranks over gloo sharing the one card
TP_TRAIN_STEPS = 3
TP_SAMPLES, TP_DDIM = 2, 10  # the CLI run: L=256, DDIM-10
# cli/train.py under meshModel 2: the first files of the train corpus, 8
# train and 2 validation structures (2 steps), one epoch.
TP_TRAIN_FILES, TP_TRAIN_VAL = 10, 0.2
# z of the model ranks against one process, relative to max |z| (the
# kernels' 3xTF32 float32 sums in another order, and the partial sums).
TP_Z_TOL = 1e-4


def tp_volume(config, B, N):
    """Bytes reduce_from_model all-reduces in one denoiser forward, float32:
    each TriMul's partial sums, B N^2 (C_p + 2) + 2 C_p; each pair
    transition's, and each triangle attention's, B N^2 C_p; each IPA's and
    each structure transition's B N c_s."""
    m = config.model
    c_p, c_s = m["c_p"], m["c_s"]
    pair = 2 * (B * N * N * (c_p + 2) + 2 * c_p) + (1 + 2 * m["include_tri_att"]) * B * N * N * c_p
    structure = 2 * B * N * c_s
    return 4 * (m["n_pair_transform_layer"] * pair + m["n_structure_layer"] * m["n_structure_block"] * structure)


def split_epilogue(table):
    """A launch table with the TriMul epilogue's launches moved to its two
    stages, as a model split over a model axis launches them; their
    backward is the plain versions' gradient, recomputed, which launches
    no backward kernel. The pair transition splits its hidden channels
    there and runs torch's products: no launch."""
    out = dict(table)
    out["trimul_epilogue_partial"] = out["trimul_epilogue_finish"] = out["trimul_epilogue"]
    out["trimul_epilogue"] = out["trimul_epilogue_backward"] = out["pair_transition"] = 0
    return out


def tp_forward(model, inputs, n=3, keep_p=False):
    """One denoiser call (launches, bytes all-reduced over the model and the
    seq group and the peak memory counted; with `keep_p` this process's rows
    of p kept), then the wall ms of each of `n` more, synchronised."""
    import torch


    with torch.inference_mode():
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = model(*inputs)
        torch.cuda.synchronize()
        rec = {"z": out["z"].cpu(), "launches": launch_counts(), "volume": allreduce_bytes("tp"),
               "seq_volume": allreduce_bytes("seq"), "peak_bytes": torch.cuda.max_memory_allocated(),
               "peak_bytes_over_start": torch.cuda.max_memory_allocated() - base, "ms": []}
        if keep_p:
            rec["p"] = out["p"].cpu()
        del out
        for _ in range(n):
            t0 = time.perf_counter()
            model(*inputs)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
    return rec


def tp_rank(rank, plan):
    """The tp (and seq) phase's work in one rank of a grid of
    plan["n_seq"] (default 1) x plan["n_model"] ranks: the denoiser forward
    with and without triangle attention (and those of plan["forwards"]),
    the training steps of `plan["train_steps"]` on this data index's rows
    of the batch, then (where `plan` has them) one twisted TDS step from
    t = T, the unconditional CLI and cli/train.py on the grid and the
    trained model's z. The heavy tensors (gradients and parameters,
    gathered) from rank 0 only; under a seq axis each rank's rows of p."""
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_unconditional, train
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.parallel import create_mesh, shard_batch
    from genie2_tpu_torch.parallel import tensor_parallel as tp
    from genie2_tpu_torch.sampling import base
    from genie2_tpu_torch.train import create_train_state, make_train_step, step_randomness
    from genie2_tpu_torch.utils.model_io import init_model
    from genie2_tpu_torch.utils.weights import randomize_zero_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n_seq = plan.get("n_seq", 1)
    mesh = create_mesh(-1, dev, plan["n_model"], n_seq)
    out = {"mesh": [mesh.data_rank, mesh.model_rank, mesh.n_data, mesh.n_model]}
    if plan.get("forward"):
        inputs = denoiser_inputs()
        for tri_att in (False, True):
            model = tp.shard_model(seeded_denoiser(example_config(tri_att), dev), mesh)
            out[f"forward_{tri_att}"] = tp_forward(model, inputs, keep_p=n_seq > 1)
            del model
    for label, (L, B, overrides) in plan.get("forwards", {}).items():
        model = tp.shard_model(seeded_denoiser(example_config(**overrides), dev), mesh)
        out[f"forward_{label}"] = tp_forward(model, denoiser_inputs(L, B), n=1)
        del model
        torch.cuda.empty_cache()

    # Training steps.
    config = Config(plan["train_config"])
    model = tp.shard_model(randomize_zero_init(init_model(config, SEED, "cpu"), SEED).to(dev), mesh)
    names, model_plan = [n for n, _ in model.named_parameters()], tp.tp_plan(model)
    state = create_train_state(model, config.optimization["lr"])
    step = make_train_step(Schedule.create(config.diffusion["n_timestep"], device=dev),
                           config.training["condition_loss_weight"], mesh=mesh)
    feats = to_device(shard_batch(plan["batch"], mesh), dev)
    reset_counts()
    metrics, times, grads, before = [], [], [], []
    for i in range(plan["train_steps"]):
        full = tp.gather_state_dict({n: p.detach() for n, p in model.named_parameters()}, model_plan)
        if rank == 0:
            before.append(torch.cat([full[n].flatten() for n in names]).cpu())
        rng, dropout_seed = step_randomness(SEED, 0, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, feats, rng=rng, dropout_seed=dropout_seed)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        full = tp.gather_state_dict({n: p.grad for n, p in model.named_parameters()}, model_plan)
        if rank == 0:
            grads.append(torch.cat([full[n].flatten() for n in names]).cpu())
    launches, volume, seq_volume = launch_counts(), allreduce_bytes("tp"), allreduce_bytes("seq")
    full = tp.gather_state_dict({n: p.detach() for n, p in model.named_parameters()}, model_plan)
    params = torch.cat([full[n].flatten() for n in names]).double()
    local = torch.cat([p.detach().flatten() for p in model.parameters()]).double()
    out["train"] = {"metrics": metrics, "ms_steps": times, "launches": launches, "volume": volume,
                    "seq_volume": seq_volume,
                    "rows": int(feats["residue_mask"].shape[0]), "param_checksum": [params.sum().item()],
                    "local_checksum": [local.sum().item()]}
    if rank == 0:
        out["train"].update(grads=grads, params=params.float().cpu(), params_before=before)
    del model, state, feats

    if "tds_plan" in plan:
        t0 = time.perf_counter()
        reset_counts()
        out["tds"] = tds_segment(mesh, plan["tds_plan"], 1)
        out["tds"].update(seconds=time.perf_counter() - t0, launches=launch_counts())

    if "sample_argv" in plan:
        samples = []
        sample = base.BaseSampler.sample

        def capture(self, params):
            result = sample(self, params)
            samples.append(np.stack([f["atom_positions"] for f in result]))
            return result

        base.BaseSampler.sample = capture
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample_unconditional.main(plan["sample_argv"] + ["--num_devices", str(mesh.world_size), "--mesh_model",
                                                             str(mesh.n_model), "--mesh_seq", str(n_seq)])
            torch.cuda.synchronize()
            out["sample"] = {"seconds": time.perf_counter() - t0, "launches": launch_counts(),
                             "volume": allreduce_bytes("tp"), "seq_volume": allreduce_bytes("seq"),
                             "coords": np.concatenate(samples)}
        finally:
            base.BaseSampler.sample = sample

    if "train_cli_config" in plan:
        reset_counts()
        t0 = time.perf_counter()
        trainer = train.main(["-c", plan["train_cli_config"], "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        rec = tp_forward(trainer.model.eval(), denoiser_inputs(), n=0)
        out["train_cli"] = {"seconds": seconds, "steps": trainer.state.step, "version": trainer.version,
                            "launches": launches, "z": rec["z"],
                            "mesh": [trainer.mesh.n_data, trainer.mesh.n_model] + ([n_seq] if n_seq > 1 else [])}
    return out


def steps_from(config, batch, params_before):
    """One process's training step from each of `params_before` (the full
    parameters before each step of another run), with that step's t,
    noise and dropout seed: (metrics, gradient vector) of each."""
    import torch

    from genie2_tpu_torch.diffusion import Schedule
    from genie2_tpu_torch.features import to_device
    from genie2_tpu_torch.train import create_train_state, make_train_step, step_randomness
    from genie2_tpu_torch.utils.model_io import init_model

    dev = torch.device("cuda")
    model = init_model(config, SEED, dev)
    step = make_train_step(Schedule.create(config.diffusion["n_timestep"], device=dev),
                           config.training["condition_loss_weight"])
    feats = to_device(batch, dev)
    out = []
    for i, flat in enumerate(params_before):
        torch.nn.utils.vector_to_parameters(flat.to(dev), model.parameters())
        rng, dropout_seed = step_randomness(SEED, 0, i, dev)
        m = step(create_train_state(model, config.optimization["lr"]), feats, rng=rng, dropout_seed=dropout_seed)
        out.append(({k: float(v) for k, v in m.items()}, torch.cat([p.grad.flatten() for p in model.parameters()]).cpu()))
    return out


def phase_tp(state):
    """Tensor parallelism: two model ranks over gloo sharing the card (NCCL
    refuses two ranks on one GPU) against one process: the denoiser
    forward, three training steps, one twisted TDS step, the unconditional
    CLI and cli/train.py under --mesh_model 2 / meshModel 2; then one
    training step on a (2 data x 2 model) grid of four ranks."""
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_unconditional
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel.spawn import run_ranks
    from genie2_tpu_torch.sampling import base
    from genie2_tpu_torch.utils.model_io import load_model

    work, rootdir, _ = release_dir(state)
    pplan, alone = state["parallel_plan"], state["parallel_alone"]
    config, tconfig = example_config(), Config(pplan["train_config"])
    failures = []
    note = "gloo ranks share one card: these numbers show correctness and the collectives' volume, not scaling"

    # One process: the denoiser phase's models on the same inputs.
    inputs = denoiser_inputs()
    one = {tri_att: tp_forward(state["model_triatt" if tri_att else "model"], inputs) for tri_att in (False, True)}

    # The CLI runs' inputs: DDIM-10 at L=256, and cli/train.py on a cut corpus.
    outdir = os.path.join(work, "tp")

    def sample_argv(label):
        return common_argv(rootdir, os.path.join(outdir, label), "0.6") + [
            "--num_samples", str(TP_SAMPLES), "--batch_size", str(TP_SAMPLES), "--min_length", "256",
            "--max_length", "256", "--ddim_steps", str(TP_DDIM), "--ddim_eta", "0.5"]

    datadir, tp_root = os.path.join(work, "tp_train_data"), os.path.join(work, "tp_train_runs")
    os.makedirs(datadir)
    for f in sorted(os.listdir(tconfig.io["datadir"]))[:TP_TRAIN_FILES]:
        shutil.copy(os.path.join(tconfig.io["datadir"], f), datadir)
    train_cli_config = os.path.join(work, "tp_train_configuration")
    write_train_config(train_cli_config, datadir, tp_root, epochs=1, val_split=TP_TRAIN_VAL,
                       extra=f"meshModel {TP_RANKS}\n")
    plan = {"n_model": TP_RANKS, "forward": True, "train_config": pplan["train_config"], "batch": pplan["batch"],
            "train_steps": TP_TRAIN_STEPS, "tds_plan": pplan, "sample_argv": sample_argv("sample"),
            "train_cli_config": train_cli_config}
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, TP_RANKS, (plan,), deadline=600.0)
    ranks_s = time.perf_counter() - t0

    # Forward: z against one process, the ranks bit for bit, the volume.
    for tri_att in (False, True):
        want, got = one[tri_att], [r[f"forward_{tri_att}"] for r in ranks]
        cfg = example_config(tri_att)
        scale = want["z"].abs().max().item()
        err = max((g["z"] - want["z"]).abs().max().item() for g in got)
        volume = tp_volume(cfg, 2, 256)
        launches = split_epilogue(expected_launches(cfg, 1))
        rec = {"phase": "tp", "run": "forward", "ranks": TP_RANKS, "triangle_attention": tri_att, "L": 256, "B": 2,
               "max_abs_err": err, "max_abs_z": scale, "rel_err": err / scale, "tol": TP_Z_TOL,
               "ranks_bitwise_equal": all(torch.equal(g["z"], got[0]["z"]) for g in got),
               "volume_bytes": [g["volume"] for g in got], "volume_formula_bytes": volume,
               "ms_one_process": sorted(want["ms"])[len(want["ms"]) // 2],
               "ms_ranks": max(sorted(g["ms"])[len(g["ms"]) // 2] for g in got), "ms_all": [g["ms"] for g in got],
               "launches": [g["launches"] for g in got], "expected_launches": launches, "note": note,
               "smi": state["smi"]}
        emit(rec)
        if rec["rel_err"] > TP_Z_TOL or not rec["ranks_bitwise_equal"] or \
                any(g["volume"] != {"forward": volume, "backward": 0} for g in got) or \
                any(g["launches"] != launches for g in got):
            failures.append(f"forward (triangle attention {tri_att}): {rec}")

    # Training: each step's metrics and gradient against one process's step
    # from the ranks' own parameters before it (a rounding difference of one
    # step moves the next one's parameters through Adam's first update,
    # about lr sign(g)); the free-running runs' parameters after three
    # steps against the parallel phase's one process, and their metrics
    # and gradients reported.
    a_train, r_train = alone["train"], ranks[0]["train"]
    forced = steps_from(tconfig, pplan["batch"], r_train["params_before"])
    metric_err = max(abs(r["train"]["metrics"][i][k] - v) / max(abs(v), 1e-12)
                     for r in ranks for i, (m, _) in enumerate(forced) for k, v in m.items())
    grad_errs = [(g - w).abs().max().item() / w.abs().max().item() for g, (_, w) in zip(r_train["grads"], forced)]
    free_metric_err = [max(abs(r["train"]["metrics"][i][k] - v) / max(abs(v), 1e-12) for r in ranks
                           for k, v in m.items()) for i, m in enumerate(a_train["metrics"])]
    free_grad_errs = [(g - w).abs().max().item() / w.abs().max().item()
                      for g, w in zip(r_train["grads"], a_train["grads"])]
    adam = _params_against_adam(r_train["params"], a_train["params"], r_train["grads"], a_train["grads"],
                                tconfig.optimization["lr"])
    launches = split_epilogue(train_launches(config, TP_TRAIN_STEPS, eval_calls=0))
    rec = {"phase": "tp", "run": "train", "ranks": TP_RANKS, "batch": len(pplan["batch"]["aatype"]),
           "rows_per_rank": [r["train"]["rows"] for r in ranks], "steps": TP_TRAIN_STEPS,
           "metric_rel_err": metric_err, "metric_tol": TRAIN_LOSS_TOL, "grad_rel_err_per_step": grad_errs,
           "grad_tol": 1e-4, "free_running_metric_rel_err_per_step": free_metric_err,
           "free_running_grad_rel_err_per_step": free_grad_errs, "params": adam,
           "ranks_same_params": all(r["train"]["param_checksum"] == r_train["param_checksum"] for r in ranks),
           "ms_per_step_one_process": sorted(a_train["ms_steps"][1:])[0],
           "ms_per_step_two_ranks": max(sorted(r["train"]["ms_steps"][1:])[0] for r in ranks),
           "ms_steps": [r["train"]["ms_steps"] for r in ranks],
           "volume_bytes_per_step": {k: v / TP_TRAIN_STEPS for k, v in r_train["volume"].items()},
           "launches": [r["train"]["launches"] for r in ranks], "expected_launches": launches, "note": note,
           "smi": state["smi"]}
    emit(rec)
    if metric_err > TRAIN_LOSS_TOL or max(grad_errs) > 1e-4 or not rec["ranks_same_params"] \
            or adam["max_err"] > adam["bound"] or adam["held_max_err_over_tol"] > 1 or adam["still_max_err"] > 0 \
            or adam["held_share"] == 0 or any(r["train"]["launches"] != launches for r in ranks):
        failures.append(f"train: metrics {metric_err:.3g}, gradients {grad_errs}, parameters {adam}, "
                        f"same on every rank {rec['ranks_same_params']}")

    # TDS: one twisted step from t = T against the parallel phase's one process.
    a, got = alone["segments"]["one_step"], [r["tds"] for r in ranks]
    rec = {"phase": "tp", "run": "tds", "ranks": TP_RANKS, "particles": TDS_PARTICLES, "length": TDS_LENGTH,
           "coord_max_abs_err": max(float(np.abs(g["x"] - a["x"]).max()) for g in got), "coord_tol": PARALLEL_TDS_TOL,
           "best_same": all(g["best"] == a["best"] for g in got),
           "decisions_same": all(g["resampled"] == a["resampled"] for g in got),
           "ranks_bitwise_equal": all(np.array_equal(g["x"], got[0]["x"]) for g in got),
           "seconds_with_load": [g["seconds"] for g in got], "launches": [g["launches"] for g in got],
           "smi": state["smi"]}
    emit(rec)
    if not (rec["best_same"] and rec["decisions_same"] and rec["ranks_bitwise_equal"]) \
            or rec["coord_max_abs_err"] > PARALLEL_TDS_TOL:
        failures.append(f"tds: {rec}")

    # The unconditional CLI: complete finite files, the ranks' coordinates
    # bit for bit, and one process's run of the same flags beside them.
    files = sorted(os.listdir(os.path.join(outdir, "sample", "pdbs")))
    for f in files:
        check_ca_file(os.path.join(outdir, "sample", "pdbs", f), 256)
    captured = []
    sample = base.BaseSampler.sample

    def capture(self, params):
        result = sample(self, params)
        captured.append(np.stack([f["atom_positions"] for f in result]))
        return result

    base.BaseSampler.sample = capture
    try:
        t0 = time.perf_counter()
        sample_unconditional.main(sample_argv("sample_alone"))
        alone_sample_s = time.perf_counter() - t0
    finally:
        base.BaseSampler.sample = sample
    got = [r["sample"] for r in ranks]
    launches = split_epilogue(expected_launches(config, TP_DDIM))
    rec = {"phase": "tp", "run": "sample", "ranks": TP_RANKS, "samples": TP_SAMPLES, "L": 256, "ddim_steps": TP_DDIM,
           "files": files, "ranks_bitwise_equal": all(np.array_equal(g["coords"], got[0]["coords"]) for g in got),
           "coord_max_abs_err_one_process": float(np.abs(got[0]["coords"] - captured[0]).max()),
           "seconds_ranks": [g["seconds"] for g in got], "seconds_one_process": alone_sample_s,
           "volume_bytes": got[0]["volume"], "volume_formula_bytes": TP_DDIM * tp_volume(config, 2, 256),
           "launches": [g["launches"] for g in got], "expected_launches": launches, "note": note,
           "smi": state["smi"]}
    emit(rec)
    state["launches_tp"] = got[0]["launches"]
    if files != [f"256_{i}.pdb" for i in range(TP_SAMPLES)] or not rec["ranks_bitwise_equal"] \
            or any(g["launches"] != launches for g in got) or got[0]["volume"]["forward"] != rec["volume_formula_bytes"]:
        failures.append(f"sample: {rec}")

    # cli/train.py under meshModel 2: its full checkpoint in one process
    # against the sharded model's z.
    got = [r["train_cli"] for r in ranks]
    model, _ = load_model(tp_root, Config(train_cli_config).io["name"], epoch=0, device="cuda")
    z_one = tp_forward(model, inputs, n=0)["z"]
    scale = z_one.abs().max().item()
    rec = {"phase": "tp", "run": "train_cli", "ranks": TP_RANKS, "mesh_data_model": got[0]["mesh"],
           "steps": [g["steps"] for g in got], "seconds": [g["seconds"] for g in got],
           "checkpoint_z_rel_err": max((g["z"] - z_one).abs().max().item() for g in got) / scale,
           "tol": TP_Z_TOL, "launches": got[0]["launches"], "smi": state["smi"]}
    emit(rec)
    if rec["checkpoint_z_rel_err"] > TP_Z_TOL or got[0]["mesh"] != [1, TP_RANKS]:
        failures.append(f"train_cli: {rec}")

    # One training step on a (2 data x 2 model) grid of four ranks.
    grid_plan = {"n_model": TP_RANKS, "train_config": pplan["train_config"], "batch": pplan["batch"],
                 "train_steps": 1}
    t0 = time.perf_counter()
    grid = run_ranks(tp_rank, 2 * TP_RANKS, (grid_plan,), deadline=300.0)
    grid_s = time.perf_counter() - t0
    g_train = grid[0]["train"]
    metric_err = max(abs(r["train"]["metrics"][0][k] - v) / max(abs(v), 1e-12)
                     for r in grid for k, v in a_train["metrics"][0].items())
    grad_err = (g_train["grads"][0] - a_train["grads"][0]).abs().max().item() / a_train["grads"][0].abs().max().item()
    rec = {"phase": "tp", "run": "grid_train", "ranks": 2 * TP_RANKS, "grid": [r["mesh"] for r in grid],
           "rows_per_rank": [r["train"]["rows"] for r in grid], "metric_rel_err": metric_err,
           "grad_rel_err": grad_err, "ms_step": [r["train"]["ms_steps"][0] for r in grid],
           "ranks_same_params": all(r["train"]["param_checksum"] == g_train["param_checksum"] for r in grid),
           "seconds_with_start": grid_s, "note": note, "smi": state["smi"]}
    emit(rec)
    if metric_err > TRAIN_LOSS_TOL or grad_err > 1e-4 or not rec["ranks_same_params"]:
        failures.append(f"grid_train: {rec}")
    emit({"phase": "tp", "seconds_two_ranks_with_start": ranks_s})
    if failures:
        raise PhaseFailed("; ".join(failures))


# ------------------------------------------------------------------ #
# Phase 11
# ------------------------------------------------------------------ #

SEQ_RANKS = 2  # seq ranks over gloo sharing the one card
SEQ_TRAIN_STEPS = 3
SEQ_SAMPLES, SEQ_DDIM = 2, 10  # the CLI run: L=256, DDIM-10
SEQ_PAD_L = 255  # a length the seq axis does not divide
SEQ_LONG_L = 1024  # the memory story: B=1, maximumNumResidues 1024
# z and p of the seq ranks against one process, relative to max |z| or |p|
# (the kernels' 3xTF32 float32 sums in another order, the incoming
# TriMul's partial sums over each rank's k).
SEQ_TOL = 1e-4


def seq_volume(config, B, N):
    """Bytes the seq group all-reduces in one denoiser forward, float32, N
    the residues padded to the seq axis: each pair layer's outgoing TriMul
    gathers b and its incoming one reduces its partial sums, B H N^2 each
    (H the TriMul's hidden channels); with triangle attention the starting
    node gathers its bias, B H_tri N^2, and the ending node the layer-normed
    rows, B N^2 c_p; each structure layer gathers s and the frames, B N
    (c_s + 9 + 3)."""
    m = config.model
    pair = 2 * B * m["c_hidden_mul"] * N * N
    if m["include_tri_att"]:
        pair += B * m["n_head_tri"] * N * N + B * N * N * m["c_p"]
    structure = B * N * (m["c_s"] + 12)
    return 4 * (m["n_pair_transform_layer"] * pair + m["n_structure_layer"] * m["n_structure_block"] * structure)


def phase_seq(state):
    """Sequence parallelism: two seq ranks over gloo sharing the card (NCCL
    refuses two ranks on one GPU) against one process: the denoiser forward
    at L=256, B=2, with and without triangle attention, at L=255 (padded)
    and at L=1024, B=1 (peak memory); three training steps; one twisted TDS
    step; the unconditional CLI with --mesh_seq 2 and cli/train.py with
    meshSeq 2; then one training step on a (2 seq x 2 model) grid of four
    ranks."""
    import numpy as np
    import torch

    from genie2_tpu_torch.cli import sample_unconditional
    from genie2_tpu_torch.config import Config
    from genie2_tpu_torch.parallel.spawn import run_ranks
    from genie2_tpu_torch.sampling import base
    from genie2_tpu_torch.utils.model_io import load_model

    work, rootdir, _ = release_dir(state)
    pplan, alone = state["parallel_plan"], state["parallel_alone"]
    config, tconfig = example_config(), Config(pplan["train_config"])
    failures = []
    note = "gloo ranks share one card: these numbers show correctness, the collectives' volume and memory, not scaling"
    dev = torch.device("cuda")

    # One process: the same inputs through the denoiser phase's models, and
    # the padded and long forwards.
    inputs = denoiser_inputs()
    one = {tri_att: tp_forward(state["model_triatt" if tri_att else "model"], inputs, keep_p=True)
           for tri_att in (False, True)}
    forwards = {"pad": (SEQ_PAD_L, 2, {}), "long": (SEQ_LONG_L, 1, {"max_n_res": SEQ_LONG_L})}
    for label, (L, B, overrides) in forwards.items():
        model = seeded_denoiser(example_config(**overrides), dev)
        one[label] = tp_forward(model, denoiser_inputs(L, B), n=1)
        del model
        torch.cuda.empty_cache()

    outdir = os.path.join(work, "seq")

    def sample_argv(label):
        return common_argv(rootdir, os.path.join(outdir, label), "0.6") + [
            "--num_samples", str(SEQ_SAMPLES), "--batch_size", str(SEQ_SAMPLES), "--min_length", "256",
            "--max_length", "256", "--ddim_steps", str(SEQ_DDIM), "--ddim_eta", "0.5"]

    datadir, seq_root = os.path.join(work, "seq_train_data"), os.path.join(work, "seq_train_runs")
    os.makedirs(datadir)
    for f in sorted(os.listdir(tconfig.io["datadir"]))[:TP_TRAIN_FILES]:
        shutil.copy(os.path.join(tconfig.io["datadir"], f), datadir)
    train_cli_config = os.path.join(work, "seq_train_configuration")
    write_train_config(train_cli_config, datadir, seq_root, epochs=1, val_split=TP_TRAIN_VAL,
                       extra=f"meshSeq {SEQ_RANKS}\n")
    plan = {"n_model": 1, "n_seq": SEQ_RANKS, "forward": True, "forwards": forwards,
            "train_config": pplan["train_config"], "batch": pplan["batch"], "train_steps": SEQ_TRAIN_STEPS,
            "tds_plan": pplan, "sample_argv": sample_argv("sample"), "train_cli_config": train_cli_config}
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, SEQ_RANKS, (plan,), deadline=600.0)
    ranks_s = time.perf_counter() - t0

    # Forward: z against one process, each rank's rows of p against one
    # process's rows, the bytes against seq_volume, the launches.
    for label in (False, True, "pad", "long"):
        want, got = one[label], [r[f"forward_{label}"] for r in ranks]
        L, B, overrides = (256, 2, {"tri_att": label}) if isinstance(label, bool) else forwards[label]
        cfg = example_config(**overrides)
        n_pad = -(-L // SEQ_RANKS) * SEQ_RANKS
        scale = want["z"].abs().max().item()
        err = max((g["z"] - want["z"]).abs().max().item() for g in got)
        rec = {"phase": "seq", "run": "forward", "ranks": SEQ_RANKS, "label": str(label), "L": L, "B": B,
               "padded_L": n_pad, "triangle_attention": cfg.model["include_tri_att"],
               "max_abs_err": err, "max_abs_z": scale, "rel_err": err / scale, "tol": SEQ_TOL,
               "volume_bytes": [g["seq_volume"] for g in got], "volume_formula_bytes": seq_volume(cfg, B, n_pad),
               "ms_one_process": sorted(want["ms"])[len(want["ms"]) // 2],
               "ms_ranks": max(sorted(g["ms"])[len(g["ms"]) // 2] for g in got), "ms_all": [g["ms"] for g in got],
               "peak_bytes_one_process": want["peak_bytes"], "peak_bytes_ranks": [g["peak_bytes"] for g in got],
               "launches": [g["launches"] for g in got], "expected_launches": expected_launches(cfg, 1),
               "note": note, "smi": state["smi"]}
        ok = rec["rel_err"] <= SEQ_TOL and all(g["seq_volume"] == {"forward": rec["volume_formula_bytes"],
                                                                   "backward": 0} for g in got) \
            and all(g["launches"] == rec["expected_launches"] for g in got)
        if isinstance(label, bool):  # each rank's rows of p, each held to max |p|
            p_scale = want["p"].abs().max().item()
            per = 256 // SEQ_RANKS
            rec["p_rel_err"] = max((g["p"] - want["p"][:, r * per:(r + 1) * per]).abs().max().item()
                                   for r, g in enumerate(got)) / p_scale
            rec["p_shapes"] = [list(g["p"].shape) for g in got]
            ok = ok and rec["p_rel_err"] <= SEQ_TOL and all(list(g["p"].shape) == [2, per, 256, cfg.model["c_p"]]
                                                            for g in got)
        emit(rec)
        if not ok:
            failures.append(f"forward {label}: {rec}")

    # Training: as the tp phase, each step against one process's step from
    # the ranks' parameters before it, and the free-running parameters
    # after three steps against the parallel phase's one process.
    a_train, r_train = alone["train"], ranks[0]["train"]
    forced = steps_from(tconfig, pplan["batch"], r_train["params_before"])
    metric_err = max(abs(r["train"]["metrics"][i][k] - v) / max(abs(v), 1e-12)
                     for r in ranks for i, (m, _) in enumerate(forced) for k, v in m.items())
    grad_errs = [(g - w).abs().max().item() / w.abs().max().item() for g, (_, w) in zip(r_train["grads"], forced)]
    adam = _params_against_adam(r_train["params"], a_train["params"], r_train["grads"], a_train["grads"],
                                tconfig.optimization["lr"])
    launches = train_launches(config, SEQ_TRAIN_STEPS, eval_calls=0)
    rec = {"phase": "seq", "run": "train", "ranks": SEQ_RANKS, "batch": len(pplan["batch"]["aatype"]),
           "steps": SEQ_TRAIN_STEPS, "metric_rel_err": metric_err, "metric_tol": TRAIN_LOSS_TOL,
           "grad_rel_err_per_step": grad_errs, "grad_tol": 1e-4, "params": adam,
           "ranks_same_params": all(r["train"]["param_checksum"] == r_train["param_checksum"] for r in ranks),
           "ms_per_step_one_process": sorted(a_train["ms_steps"][1:])[0],
           "ms_per_step_two_ranks": max(sorted(r["train"]["ms_steps"][1:])[0] for r in ranks),
           "ms_steps": [r["train"]["ms_steps"] for r in ranks],
           "volume_bytes_per_step": {k: v / SEQ_TRAIN_STEPS for k, v in r_train["seq_volume"].items()},
           "launches": [r["train"]["launches"] for r in ranks], "expected_launches": launches, "note": note,
           "smi": state["smi"]}
    emit(rec)
    if metric_err > TRAIN_LOSS_TOL or max(grad_errs) > 1e-4 or not rec["ranks_same_params"] \
            or adam["max_err"] > adam["bound"] or adam["held_max_err_over_tol"] > 1 or adam["still_max_err"] > 0 \
            or adam["held_share"] == 0 or any(r["train"]["launches"] != launches for r in ranks):
        failures.append(f"train: metrics {metric_err:.3g}, gradients {grad_errs}, parameters {adam}, "
                        f"same on every rank {rec['ranks_same_params']}")

    # TDS: one twisted step from t = T against the parallel phase's one process.
    a, got = alone["segments"]["one_step"], [r["tds"] for r in ranks]
    rec = {"phase": "seq", "run": "tds", "ranks": SEQ_RANKS, "particles": TDS_PARTICLES, "length": TDS_LENGTH,
           "coord_max_abs_err": max(float(np.abs(g["x"] - a["x"]).max()) for g in got),
           "coord_tol": PARALLEL_TDS_TOL, "best_same": all(g["best"] == a["best"] for g in got),
           "decisions_same": all(g["resampled"] == a["resampled"] for g in got),
           "ranks_bitwise_equal": all(np.array_equal(g["x"], got[0]["x"]) for g in got),
           "seconds_with_load": [g["seconds"] for g in got], "launches": [g["launches"] for g in got],
           "smi": state["smi"]}
    emit(rec)
    if not (rec["best_same"] and rec["decisions_same"] and rec["ranks_bitwise_equal"]) \
            or rec["coord_max_abs_err"] > PARALLEL_TDS_TOL:
        failures.append(f"tds: {rec}")

    # The unconditional CLI against one process's run of the same flags.
    files = sorted(os.listdir(os.path.join(outdir, "sample", "pdbs")))
    for f in files:
        check_ca_file(os.path.join(outdir, "sample", "pdbs", f), 256)
    captured = []
    sample = base.BaseSampler.sample

    def capture(self, params):
        result = sample(self, params)
        captured.append(np.stack([f["atom_positions"] for f in result]))
        return result

    base.BaseSampler.sample = capture
    try:
        t0 = time.perf_counter()
        sample_unconditional.main(sample_argv("sample_alone"))
        alone_sample_s = time.perf_counter() - t0
    finally:
        base.BaseSampler.sample = sample
    got = [r["sample"] for r in ranks]
    launches = expected_launches(config, SEQ_DDIM)
    rec = {"phase": "seq", "run": "sample", "ranks": SEQ_RANKS, "samples": SEQ_SAMPLES, "L": 256,
           "ddim_steps": SEQ_DDIM, "files": files,
           "ranks_bitwise_equal": all(np.array_equal(g["coords"], got[0]["coords"]) for g in got),
           "coord_max_abs_err_one_process": float(np.abs(got[0]["coords"] - captured[0]).max()),
           "seconds_ranks": [g["seconds"] for g in got], "seconds_one_process": alone_sample_s,
           "volume_bytes": got[0]["seq_volume"], "volume_formula_bytes": SEQ_DDIM * seq_volume(config, 2, 256),
           "launches": [g["launches"] for g in got], "expected_launches": launches, "note": note,
           "smi": state["smi"]}
    emit(rec)
    state["launches_seq"] = got[0]["launches"]
    if files != [f"256_{i}.pdb" for i in range(SEQ_SAMPLES)] or not rec["ranks_bitwise_equal"] \
            or any(g["launches"] != launches for g in got) or got[0]["seq_volume"]["forward"] != rec["volume_formula_bytes"]:
        failures.append(f"sample: {rec}")

    # cli/train.py under meshSeq 2: its full checkpoint in one process
    # against the seq-sharded model's z.
    got = [r["train_cli"] for r in ranks]
    model, _ = load_model(seq_root, Config(train_cli_config).io["name"], epoch=0, device="cuda")
    z_one = tp_forward(model, inputs, n=0)["z"]
    scale = z_one.abs().max().item()
    rec = {"phase": "seq", "run": "train_cli", "ranks": SEQ_RANKS, "mesh_data_model_seq": got[0]["mesh"],
           "steps": [g["steps"] for g in got], "seconds": [g["seconds"] for g in got],
           "checkpoint_z_rel_err": max((g["z"] - z_one).abs().max().item() for g in got) / scale,
           "tol": SEQ_TOL, "launches": got[0]["launches"], "smi": state["smi"]}
    emit(rec)
    if rec["checkpoint_z_rel_err"] > SEQ_TOL or got[0]["mesh"] != [1, 1, SEQ_RANKS]:
        failures.append(f"train_cli: {rec}")

    # One training step on a (2 seq x 2 model) grid of four ranks.
    grid_plan = {"n_model": TP_RANKS, "n_seq": SEQ_RANKS, "train_config": pplan["train_config"],
                 "batch": pplan["batch"], "train_steps": 1}
    t0 = time.perf_counter()
    grid = run_ranks(tp_rank, SEQ_RANKS * TP_RANKS, (grid_plan,), deadline=300.0)
    grid_s = time.perf_counter() - t0
    g_train = grid[0]["train"]
    metric_err = max(abs(r["train"]["metrics"][0][k] - v) / max(abs(v), 1e-12)
                     for r in grid for k, v in a_train["metrics"][0].items())
    grad_err = (g_train["grads"][0] - a_train["grads"][0]).abs().max().item() / a_train["grads"][0].abs().max().item()
    rec = {"phase": "seq", "run": "grid_train", "ranks": SEQ_RANKS * TP_RANKS, "grid": [r["mesh"] for r in grid],
           "metric_rel_err": metric_err, "grad_rel_err": grad_err, "ms_step": [r["train"]["ms_steps"][0] for r in grid],
           "ranks_same_params": all(r["train"]["param_checksum"] == g_train["param_checksum"] for r in grid),
           "launches": [r["train"]["launches"] for r in grid],
           "expected_launches": split_epilogue(train_launches(config, 1, eval_calls=0)),
           "seconds_with_start": grid_s, "note": note, "smi": state["smi"]}
    emit(rec)
    if metric_err > TRAIN_LOSS_TOL or grad_err > 1e-4 or not rec["ranks_same_params"] \
            or any(r["train"]["launches"] != rec["expected_launches"] for r in grid):
        failures.append(f"grid_train: {rec}")
    # Every kernel launch under the seq axis is a row-block case (I = N / 2
    # rows, queries or rows of k); at n_seq 1 none is. Rank 0's counts a run.
    emit({"phase": "seq", "run": "row_block_launches", "rank": 0, "n_seq": SEQ_RANKS, "launches_at_n_seq_1": 0,
          "launches": {"forward_L256_B2": ranks[0]["forward_False"]["launches"],
                       "forward_L256_B2_triangle_attention": ranks[0]["forward_True"]["launches"],
                       f"train_{SEQ_TRAIN_STEPS}_steps": ranks[0]["train"]["launches"],
                       f"cli_ddim_{SEQ_DDIM}": ranks[0]["sample"]["launches"],
                       "grid_train_1_step_2_seq_x_2_model": grid[0]["train"]["launches"]},
          "note": "tri_attention counts the starting node (I rows, N queries) and the ending node "
                  "(I queries against N keys) alike, half each"})
    emit({"phase": "seq", "seconds_two_ranks_with_start": ranks_s})
    if failures:
        raise PhaseFailed("; ".join(failures))


# ------------------------------------------------------------------ #


def kernels_line(state):
    launches = state.get("launches", {})
    triatt = state.get("launches_triatt", {})
    scaffold = state.get("launches_scaffold", {})
    kernel_phase = state.get("kernel_phase_launches", {})
    tds = state.get("launches_tds", {})
    tp_launches = state.get("launches_tp", {})
    out = []
    for k in KERNELS:
        name = k["name"]
        recs = state.get("kernel_main", {}).get(name, {})
        if not recs:
            continue
        rs = list(recs.values())
        counters = ("trimul_contract_out", "trimul_contract_in") if name == "trimul_contract" else (name,)
        count = lambda table: sum(table.get(c, 0) for c in counters)
        # On the main path: the unconditional sweep's count. On the path of
        # the triangle attention configuration only: that configuration's
        # 1000-step run. In the TDS gradient only (contract_cm_km): the
        # 1000-step TDS run. Under a model axis only (the epilogue's two
        # stages): the tp phase's unconditional CLI, rank 0. Off every
        # path: the launches of the kernels phase (comparisons and timings).
        source, table = ("kernels phase", kernel_phase) if name in OFF_PATH else \
            ("triatt phase, unconditional", triatt) if name == "tri_attention" else \
            ("tds phase, score_capped", tds.get("score_capped", {})) if name == "contract_cm_km" else \
            ("tp phase, unconditional CLI --mesh_model 2, rank 0", tp_launches) if name in SPLIT_EPILOGUE else \
            ("main phase", launches)
        entry = {
            **k, "route": "cuda", "launches": count(table), "launches_from": source,
            "launches_scaffold": {run: count(table) for run, table in scaffold.items()},
            "launches_triatt": {"unconditional": count(triatt), "sse": count(state.get("launches_sse", {}))},
            "launches_tds": {run: count(table) for run, table in tds.items()},
            "launches_train": count(state.get("launches_train", {})),
            "launches_parallel": {run: count(table) for run, table in state.get("launches_parallel", {}).items()},
            "launches_tp": count(tp_launches),
            "launches_seq": count(state.get("launches_seq", {})),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs) / len(rs),
            "plain_ms": sum(r["plain_ms"] for r in rs) / len(rs),
            "bound_ms": rs[0]["bound_ms"], "bound_by": rs[0]["bound_by"],
            "library_ms": (sum(r["library_ms"] for r in rs) / len(rs)) if rs[0]["library_ms"] is not None else None,
            "tensor_core_instructions": state.get("sass", {}).get(name),
            "shape": {"B": 2, "N": 256, "C": C_P, "H": rs[0]["H"], "dtype": "float32",
                      **(IPA if name == "ipa_attention" else TRI_ATT if name == "tri_attention" else {})},
        }
        if name == "trimul_project":
            entry["bare_matmul_ms"] = rs[0]["bare_matmul_ms"]
            entry["backward_kernel"] = state.get("project_backward")
        if name == "trimul_epilogue":
            entry["backward_kernel"] = state.get("epilogue_backward")
        if name == "pair_transition":
            entry["per_call"] = state.get("transition")
        if name in state.get("kernels_per_call", {}):  # the epilogue and its stages
            entry["kernels_per_call_bf16_weights"] = state["kernels_per_call"][name]
        rows = state.get("kernel_rows", {}).get(name)
        if rows:  # the row-block cases of sequence parallelism, float32, beside the square one
            entry["row_blocks"] = {case: {k: r.get(k) for k in ("I", "shapes", "ms", "plain_ms", "max_abs_err",
                                                                "rel_err", "grad_rel_err", "backward_ms")}
                                   for case, r in rows.items()}
        if name == "trimul_contract":
            entry["launches_out"] = launches.get("trimul_contract_out", 0)
            entry["launches_in"] = launches.get("trimul_contract_in", 0)
        if len(recs) == 2:
            entry["ms_out"], entry["ms_in"] = recs[True]["ms"], recs[False]["ms"]
        backward = [r["backward"] for r in rs if "backward" in r]
        if backward:
            entry["backward"] = {
                "route": backward[0]["backward_route"],
                "ms": sum(b["backward_ms"] for b in backward) / len(backward),
                "plain_ms": sum(b["plain_backward_ms"] for b in backward) / len(backward),
                "forward_under_autograd_ms": sum(b["forward_ms"] for b in backward) / len(backward),
                "max_abs_err": max(b["max_abs_err"] for b in backward),
                "rel_err": max(b["rel_err"] for b in backward),
            }
        out.append(entry)
    return {"kernels": out}


PHASES = {"device": phase_device, "kernels": phase_kernels, "denoiser": phase_denoiser, "main": phase_main,
          "scaffold": phase_scaffold, "triatt": phase_triatt, "tds": phase_tds, "train": phase_train,
          "parallel": phase_parallel, "tp": phase_tp, "seq": phase_seq}


def main() -> int:
    import torch

    state = {}
    try:
        for name, phase in PHASES.items():
            t0 = time.perf_counter()
            try:
                phase(state)
            except PhaseFailed as e:
                emit({"phase": name, "failed": str(e)})
                return 1
            emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0})
    finally:
        if "work" in state:
            shutil.rmtree(state["work"], ignore_errors=True)
    print(state["smi"], flush=True)
    emit(kernels_line(state))
    emit({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    })
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-train"]:
        sys.exit(torchrun_train(sys.argv[2:]))
    sys.exit(main())
