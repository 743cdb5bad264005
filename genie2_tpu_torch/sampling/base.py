"""Sampler orchestration: the reference's template-method surface (setup /
on_sample_start / create_np_features / on_sample_end, required-parameter
validation) around the reverse loops of sampling/ddpm.py and
sampling/dpm_solver.py, with classifier-free guidance and trajectory dumps.

Optional sampling parameters (all default to off): `strength`, `ddim_steps`,
`ddim_eta`, `ddim_eta_switch_t`, `dpm_steps`, `fast_spacing`,
`dump_trajectory_every`, `seed`.

Data parallel (`mesh`, parallel/mesh.py): every rank builds the same global
batch, padded to the global batch's bucket length and, by repeats of row 0
with throwaway negative sample ids, to a multiple of the world size; each
rank runs its rows and the coordinates are gathered on every rank. Noise
streams keyed by (seed, sample id, step) make the split irrelevant, so the
files are those of one process. Rank 0 writes them.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, List

import numpy as np
import torch

from genie2_tpu_torch.diffusion import Schedule
from genie2_tpu_torch.features import batchify, debatchify, save_coords_to_pdb, to_device, to_host
from genie2_tpu_torch.nn.policy import apply_denoiser, cast_model, compute_dtype
from genie2_tpu_torch.parallel.mesh import gather_rows, is_main, pad_to_ranks, repeat_first_rows, shard_batch
from genie2_tpu_torch.sampling.ddpm import (
    ModelFn,
    ancestral_sample,
    ancestral_sample_with_trajectory,
    ddim_sample,
    eta_schedule_below,
)
from genie2_tpu_torch.sampling.dpm_solver import dpm_solver_sample
from genie2_tpu_torch.utils.profiling import host_sync


def bucket_length(n: int, multiple: int = 32) -> int:
    """Round a sequence length up to a bucket multiple (padded residues are
    masked and do not affect real ones)."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def pad_residues(batch: Dict[str, np.ndarray], n_padded: int) -> Dict[str, np.ndarray]:
    """Zero-pad a host batch's residue axis (both axes of
    fixed_structure_mask) to n_padded."""
    pad = n_padded - batch["residue_mask"].shape[1]
    out = dict(batch)
    for k, v in batch.items():
        if k == "fixed_structure_mask":
            out[k] = np.pad(v, [(0, 0), (0, pad), (0, pad)])
        elif not k.startswith("num"):
            out[k] = np.pad(v, [(0, 0), (0, pad)] + [(0, 0)] * (v.ndim - 2))
    return out


class BaseSampler(ABC):
    """Template-method sampler over the reverse loops. The model must
    already sit on its device in eval mode (the loader puts it on the card
    unless the caller names the CPU); the sampler runs where the model is.
    With a `mesh`, each rank runs its share of every batch."""

    def __init__(self, model, config, bucket: int = 32, dtype: str = None, mesh=None):
        self.config = config
        self.mesh = mesh
        self.device = next(model.parameters()).device
        self.dtype = compute_dtype(dtype or config.tpu.get("compute_dtype", "fp32"))
        self.model = cast_model(model, self.dtype)  # the caller's model stays as it is
        self.schedule = Schedule.create(
            config.diffusion["n_timestep"], config.diffusion["schedule"], device=self.device
        )
        self.bucket = bucket
        self.required = ["scale", "outdir", "num_samples", "prefix", "offset"]
        self.setup()

    @abstractmethod
    def setup(self):
        ...

    @abstractmethod
    def on_sample_start(self, params: Dict[str, Any]):
        ...

    @abstractmethod
    def create_np_features(self, params: Dict[str, Any]):
        ...

    @abstractmethod
    def on_sample_end(self, params: Dict[str, Any], list_np_features: List[Dict]):
        ...

    def create_np_features_batch(self, params: Dict[str, Any]) -> List[Dict]:
        return [self.create_np_features(params) for _ in range(params["num_samples"])]

    def add_required_parameter(self, name: str):
        self.required.append(name)

    def validate_parameters(self, params: Dict[str, Any]) -> bool:
        return all(name in params for name in self.required)

    def sample(self, params: Dict[str, Any]):
        if not self.validate_parameters(params):
            missing = [n for n in self.required if n not in params]
            raise ValueError(f"missing required sampling parameters: {missing}")
        if is_main(self.mesh):
            self.on_sample_start(params)
        list_np_features = self._sample(params)
        if is_main(self.mesh):
            self.on_sample_end(params, list_np_features)
        return list_np_features

    def sample_ids(self, params: Dict[str, Any], n: int) -> List[int]:
        """Per-sample noise-stream ids: offset + position in the batch."""
        return [int(params["offset"]) + i for i in range(n)]

    def _write_trajectory(self, params: Dict[str, Any], snapshots, snap_steps, n_res: int):
        """x_t snapshots of sample 0 of the batch as
        `{outdir}/test/{prefix}_{offset}/xt_predicted_test_{step}.pdb`,
        trimmed to the real residue count. Each sample() call has its own
        directory, so batches and lengths of a sweep do not overwrite each
        other."""
        dump_dir = os.path.join(params["outdir"], "test", f"{params['prefix']}_{params['offset']}")
        os.makedirs(dump_dir, exist_ok=True)
        for step, snap in zip(snap_steps, snapshots):
            save_coords_to_pdb(np.asarray(snap[0][:n_res]), os.path.join(dump_dir, f"xt_predicted_test_{step}.pdb"))

    def make_model_fn(self, features: Dict[str, torch.Tensor], strength: float = 0.0) -> ModelFn:
        """The noise prediction as a function of (frames, timesteps) for a
        device batch, with the step-invariant pair bias (relpos + motif
        template) computed once. strength > 0 applies classifier-free
        guidance, eps_u + (1 + strength) (eps_c - eps_u): the unconditional
        branch is the same batch with both fixed (motif) masks zeroed and
        its own static bias, so each step calls the model twice. strength
        0 is the plain conditional model, one call."""
        static_bias = self.model.static_bias(features, self.dtype)

        def conditional(frames, t_vec):
            return apply_denoiser(self.model, frames, t_vec, features, static_bias, self.dtype)

        if strength <= 0:
            return conditional

        uncond = dict(features)
        uncond["fixed_sequence_mask"] = torch.zeros_like(features["fixed_sequence_mask"])
        uncond["fixed_structure_mask"] = torch.zeros_like(features["fixed_structure_mask"])
        uncond_bias = self.model.static_bias(uncond, self.dtype)
        w = 1.0 + float(strength)

        def combined(frames, t_vec):
            z_c = conditional(frames, t_vec)
            z_u = apply_denoiser(self.model, frames, t_vec, uncond, uncond_bias, self.dtype)
            return z_u + w * (z_c - z_u)

        return combined

    @torch.inference_mode()
    def _sample(self, params: Dict[str, Any]):
        ddim_steps = int(params.get("ddim_steps") or 0)
        dpm_steps = int(params.get("dpm_steps") or 0)
        dump_every = int(params.get("dump_trajectory_every") or 0)
        switch_t = int(params.get("ddim_eta_switch_t") or 0)
        if ddim_steps and dpm_steps:
            raise ValueError("ddim_steps and dpm_steps are mutually exclusive")
        if dump_every and (ddim_steps or dpm_steps):
            # A K-step solver has no full trajectory to take snapshots of.
            raise ValueError(
                "dump_trajectory_every requires the full ancestral sampler; "
                "it cannot be combined with ddim_steps/dpm_steps"
            )
        if switch_t and not ddim_steps:
            # DPM-Solver++ is deterministic and the ancestral sampler is
            # stochastic at every step: the eta schedule exists for DDIM only.
            raise ValueError(
                "ddim_eta_switch_t requires ddim_steps; it has no effect "
                "on the ancestral or dpm_steps samplers"
            )
        spacing = str(params.get("fast_spacing") or "uniform")
        seed, scale = int(params.get("seed", 0)), float(params["scale"])

        batch = batchify([dict(f) for f in self.create_np_features_batch(params)])
        n_real = batch["aatype"].shape[0]
        n_total = pad_to_ranks(n_real, self.mesh)
        # Rows past n_real repeat row 0 under throwaway negative ids.
        all_ids = self.sample_ids(params, n_real) + list(range(-1, n_real - n_total - 1, -1))
        padded = repeat_first_rows(pad_residues(batch, bucket_length(batch["residue_mask"].shape[1], self.bucket)),
                                   n_total)
        features = to_device(shard_batch(padded, self.mesh), self.device)
        ids = shard_batch({"ids": np.asarray(all_ids)}, self.mesh)["ids"].tolist()
        model_fn = self.make_model_fn(features, float(params.get("strength") or 0.0))

        if dpm_steps:
            trans = dpm_solver_sample(model_fn, self.schedule, features, seed, ids, dpm_steps, spacing)
        elif ddim_steps:
            # ddim_eta_switch_t > 0: deterministic (eta = 0) while t is above
            # it, ddim_eta (default 1) at or below.
            eta = float(params.get("ddim_eta") or 0.0)
            if switch_t:
                eta = eta_schedule_below(
                    self.schedule.n_timestep, ddim_steps, switch_t, eta_low=eta or 1.0, spacing=spacing
                )
            trans = ddim_sample(model_fn, self.schedule, features, seed, ids, ddim_steps, eta, scale, spacing)
        elif dump_every:
            trans, snapshots, snap_steps = ancestral_sample_with_trajectory(
                model_fn, self.schedule, features, seed, ids, scale, record_every=dump_every
            )
            if is_main(self.mesh):  # rank 0 holds sample 0
                self._write_trajectory(params, snapshots, snap_steps, int(np.asarray(batch["num_residues"][0])))
        else:
            trans = ancestral_sample(model_fn, self.schedule, features, seed, ids, scale)
        out = to_device(padded, "cpu")
        out["atom_positions"] = gather_rows(self.mesh, trans)[0]
        host_sync("sample_output", out["atom_positions"])
        return debatchify(to_host(out))[:n_real]
