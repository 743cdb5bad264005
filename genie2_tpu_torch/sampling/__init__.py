from genie2_tpu_torch.sampling.base import BaseSampler, bucket_length, pad_residues
from genie2_tpu_torch.sampling.ddpm import (
    ancestral_sample,
    ancestral_sample_injected,
    ancestral_sample_with_trajectory,
    ddim_sample,
    ddim_sample_injected,
    ddim_schedule,
    eta_schedule_below,
    init_translations,
    reverse_step,
    step_noise,
)
from genie2_tpu_torch.sampling.dpm_solver import dpm_solver_sample, dpm_solver_sample_injected
from genie2_tpu_torch.sampling.scaffold import ScaffoldSampler
from genie2_tpu_torch.sampling.unconditional import PackedUnconditionalSampler, UnconditionalSampler

__all__ = [
    "BaseSampler",
    "bucket_length",
    "pad_residues",
    "ancestral_sample",
    "ancestral_sample_injected",
    "ancestral_sample_with_trajectory",
    "ddim_sample",
    "ddim_sample_injected",
    "ddim_schedule",
    "eta_schedule_below",
    "init_translations",
    "reverse_step",
    "step_noise",
    "dpm_solver_sample",
    "dpm_solver_sample_injected",
    "ScaffoldSampler",
    "PackedUnconditionalSampler",
    "UnconditionalSampler",
]
