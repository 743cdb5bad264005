"""Traffic "ancestral": ancestral DDPM sampling through the program's sampler, trajectories back to back.

Parameters (the traffic file): `batch` samples a trajectory, noise `scale`,
`problem` ({"kind": "unconditional", "length": L} or {"kind": "motif",
"segments": [[chain, first, last, group], ...], "scaffold": [lo, hi],
"total": [lo, hi]}), `warmup_steps`, `trace_steps` and `checked_steps`.

Each trajectory is a batch of new sample ids (0, 1, ... in order) whose
features come from the program's sampler (`UnconditionalSampler`, or
`ScaffoldSampler` with its placement generator seeded from the run's seed
and a motif problem written from it), padded to the sampler's bucket. It
runs from t = T down to 1 by the program's `reverse_step` under the model
function of `BaseSampler.make_model_fn`, with the noise of its streams;
when one ends, the next starts. A step is one reverse step of one batch.

Correctness: for `checked_steps` steps of the window, drawn from the seed
(the last always among them), the reference recomputes z and x_{t-1} from
the step's input x_t (the program's state) with its own features, weights
and noise; every trajectory's x_T is recomputed from its noise stream.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import port, registry
from portbench.harness.weights import make_weights
from portbench.reference import genie2 as ref
from portbench.reference import inputs as ref_inputs

TAG_WEIGHTS, TAG_MOTIF, TAG_PLACEMENT, TAG_CHECK = 1, 2, 3, 4


def write_motif_problem(path: str, problem: Dict, seed: int):
    """A motif problem in the REMARK 999 grammar: scaffold segments of
    `problem["scaffold"]` lengths around each motif segment, whose CA atoms
    follow a random walk of 3.8 A steps drawn from `seed`."""
    rng = np.random.default_rng(seed)
    lo, hi = problem["scaffold"]
    scaffold = f"REMARK 999 INPUT   {lo:4d}{hi:4d}\n"
    lines = ["REMARK 999 NAME   portbench_motif\n",
             f"REMARK 999 MINIMUM TOTAL LENGTH      {problem['total'][0]}\n",
             f"REMARK 999 MAXIMUM TOTAL LENGTH      {problem['total'][1]}\n", scaffold]
    for chain, first, last, group in problem["segments"]:
        lines += [f"REMARK 999 INPUT  {chain}{first:4d}{last:4d} {group}\n", scaffold]
    serial, pos = 1, np.zeros(3)
    for chain, first, last, _ in problem["segments"]:
        pos = pos + rng.normal(size=3) * 10.0
        for resseq in range(first, last + 1):
            step = rng.normal(size=3)
            pos = pos + 3.8 * step / np.linalg.norm(step)
            name = ref_inputs.RESTYPES_3[int(rng.integers(20))]
            lines.append(f"ATOM  {serial:5d}  CA  {name} {chain}{resseq:4d}    "
                         f"{pos[0]:8.3f}{pos[1]:8.3f}{pos[2]:8.3f}  1.00  0.00           C  \n")
            serial += 1
    with open(path, "w") as fh:
        fh.writelines(lines)


def finite(x: torch.Tensor) -> float:
    """A reading as a float, NaN as infinity (a NaN fails every limit)."""
    v = float(x)
    return float("inf") if v != v else v


def bucket(n: int, multiple: int = 32) -> int:
    return max(multiple, -(-n // multiple) * multiple)


class Generator:
    """program "port": the program's sampler; "control": the reference in
    its place, in TF32."""

    def __init__(self, cell, seed: int, device, program: str = "port"):
        self.cell, self.seed, self.device, self.program = cell, int(seed), device, program
        tr = cell.traffic
        self.B, self.scale, self.problem = int(tr["batch"]), float(tr["scale"]), tr["problem"]
        self.sizes = ref.sizes(cell.config["configuration"])
        self.T = int(self.sizes["numTimesteps"])
        self.dtype = cell.config["dtype"]
        self.records: List[tuple] = []  # (trajectory, t, x_t, z, x_{t-1}) of every step
        self.starts: List[tuple] = []  # (trajectory, x_T)
        self.model = None
        self.model_calls = 0
        self.window_from = 0
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench_")

    # ---------------------------------------------------------------- #

    def setup(self):
        if self.problem["kind"] == "motif":
            self.problem_path = os.path.join(self._tmp.name, "motif.pdb")
            write_motif_problem(self.problem_path, self.problem, registry.subseed(self.seed, TAG_MOTIF))
        self.weights = make_weights(ref.parameter_spec(self.cell.config["configuration"]),
                                    registry.subseed(self.seed, TAG_WEIGHTS), self.device)
        if self.program == "port":
            from genie2_tpu_torch.sampling import ddpm
            from genie2_tpu_torch.sampling.scaffold import ScaffoldSampler
            from genie2_tpu_torch.sampling.unconditional import UnconditionalSampler

            self._ddpm = ddpm
            cfg, model = port.build(self.cell.config, self.weights)
            model.eval().requires_grad_(False)
            if self.problem["kind"] == "motif":
                self.sampler = ScaffoldSampler(model, cfg, placement_seed=registry.subseed(self.seed, TAG_PLACEMENT))
            else:
                self.sampler = UnconditionalSampler(model, cfg)
            self.model = self.sampler.model
            self.schedule = self.sampler.schedule
        else:
            self.sched = ref.cosine_schedule(self.T, self.device)
            self._placements = np.random.default_rng(registry.subseed(self.seed, TAG_PLACEMENT))
        self.traj = -1
        self._start()
        for _ in range(int(self.cell.traffic["warmup_steps"])):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_from = len(self.records)

    def ids(self, traj: int) -> List[int]:
        return list(range(traj * self.B, (traj + 1) * self.B))

    def _start(self):
        """The next trajectory: new sample ids, features, x_T and noise."""
        self.traj += 1
        ids = self.ids(self.traj)
        if self.program == "port":
            from genie2_tpu_torch.features import batchify, to_device
            from genie2_tpu_torch.sampling.base import bucket_length, pad_residues

            params = {"num_samples": self.B}
            if self.problem["kind"] == "motif":
                params["filepath"] = self.problem_path
            else:
                params["length"] = int(self.problem["length"])
            batch = batchify(self.sampler.create_np_features_batch(params))
            padded = pad_residues(batch, bucket_length(batch["residue_mask"].shape[1], self.sampler.bucket))
            self.features = to_device(padded, self.device)
            self.model_fn = self.sampler.make_model_fn(self.features)
            self.x = self._ddpm.init_translations(self.features, self.seed, ids)
            self.noises = self._ddpm.trajectory_noise(self.seed, ids, self.T, self.x.shape[1]).to(self.device)
        else:
            self.features = self.reference_features(self.traj, self._placements)
            n = self.features["residue_mask"].shape[1]
            mask = self.features["residue_mask"][..., None]
            self.x = ref_inputs.stream_noise(self.seed, ids, 0, n).to(self.device) * mask
            self.noises = torch.stack([ref_inputs.stream_noise(self.seed, ids, t, n)
                                       for t in range(self.T, 0, -1)]).to(self.device)
        self.starts.append((self.traj, self.x))
        self.t = self.T

    @torch.inference_mode()
    def step(self):
        if self.t == 0:
            self._start()
        x, t, noise = self.x, self.t, self.noises[self.T - self.t]
        if self.program == "port":
            zs = []

            def model_fn(frames, t_vec):
                zs.append(self.model_fn(frames, t_vec))
                return zs[-1]

            x_out = self._ddpm.reverse_step(model_fn, self.schedule, self.features, x, t, noise, self.scale)
            z = zs[0]
            self.model_calls += len(zs)
        else:
            f = self.features
            with ref.precision(tf32=True):
                rots = ref.frenet_frames(x, f["chain_index"], f["residue_mask"])
                z = ref.denoise(self.weights, self.cell.config["configuration"], rots, x,
                                torch.full((self.B,), t, device=self.device), f)
                x_out = ref.reverse_step(self.sched, z, x, t, noise, self.scale, f["residue_mask"])
            self.model_calls += 1
        self.records.append((self.traj, t, x, z, x_out))
        self.x, self.t = x_out, t - 1

    # ---------------------------------------------------------------- #

    def length(self) -> int:
        return int(self.features["residue_mask"].shape[1])

    def end_to_end(self, steps: int, window_s: float) -> Dict[str, float]:
        return {"samples_per_min": steps * self.B / self.T / window_s * 60.0}

    def release(self):
        """Drop the program's state; the records stay."""
        self.model = self.sampler = self.model_fn = self.noises = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_features(self, traj: int, placements=None) -> Dict[str, torch.Tensor]:
        """The reference's features of trajectory `traj`; for a motif
        problem, `placements` is the placement generator as trajectory
        `traj` finds it (each trajectory draws `batch` placements)."""
        if self.problem["kind"] == "motif":
            problem = ref_inputs.read_motif_problem(self.problem_path)
            items = [ref_inputs.motif_features(problem, placements) for _ in range(self.B)]
        else:
            items = [ref_inputs.empty_features(int(self.problem["length"])) for _ in range(self.B)]
        return ref_inputs.stack(items, bucket(max(int(f["num_residues"]) for f in items)), self.device)

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        """The numbers compared: start_err (x_T against its noise streams,
        exact), z_err (|z - z_ref| over max |z_ref|, real residues) and
        x_err (|x_{t-1} - ref| over max |ref|), each the worst of the steps
        checked."""
        window = self.records[self.window_from:]
        rng = np.random.default_rng(registry.subseed(self.seed, TAG_CHECK))
        k = int(self.cell.traffic["checked_steps"])
        picked = sorted(set(rng.choice(len(window) - 1, min(k - 1, len(window) - 1), replace=False).tolist())
                        | {len(window) - 1}) if len(window) > 1 else [0]
        placements = np.random.default_rng(registry.subseed(self.seed, TAG_PLACEMENT))
        last = max(max(r[0] for r in (window[i] for i in picked)), max(s[0] for s in self.starts))
        feats = [self.reference_features(j, placements) for j in range(last + 1)]
        weights = make_weights(ref.parameter_spec(self.cell.config["configuration"]),
                               registry.subseed(self.seed, TAG_WEIGHTS), self.device)
        sched = ref.cosine_schedule(self.T, self.device)
        out = {"start_err": 0.0, "z_err": 0.0, "x_err": 0.0}
        with ref.precision(tf32=False):
            for traj, x_T in self.starts:
                f = feats[traj]
                want = ref_inputs.stream_noise(self.seed, self.ids(traj), 0, x_T.shape[1]).to(self.device)
                want = want * f["residue_mask"][..., None]
                out["start_err"] = max(out["start_err"], finite((x_T - want).abs().max()))
            for i in picked:
                traj, t, x, z, x_out = window[i]
                f = feats[traj]
                mask = f["residue_mask"].float()[..., None]
                rots = ref.frenet_frames(x, f["chain_index"], f["residue_mask"])
                z_ref = ref.denoise(weights, self.cell.config["configuration"], rots, x,
                                    torch.full((self.B,), t, device=self.device), f)
                noise = ref_inputs.stream_noise(self.seed, self.ids(traj), t, x.shape[1]).to(self.device)
                x_ref = ref.reverse_step(sched, z_ref, x, t, noise, self.scale, f["residue_mask"])
                z_gap = ((z - z_ref) * mask).abs().max() / (z_ref * mask).abs().max()
                x_gap = (x_out - x_ref).abs().max() / x_ref.abs().max()
                out["z_err"] = max(out["z_err"], finite(z_gap))
                out["x_err"] = max(out["x_err"], finite(x_gap))
        return out
