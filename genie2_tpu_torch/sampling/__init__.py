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
from genie2_tpu_torch.sampling.feynman_kac import FKResult, smc_feynman_kac, smc_feynman_kac_injected
from genie2_tpu_torch.sampling.resampling import (
    RESAMPLERS,
    ess_from_log_weights,
    multinomial_resample_indices,
    normalize_log_weights,
    resampling_draws,
    resampling_generator,
    stratified_resample_indices,
    systematic_resample_indices,
)
from genie2_tpu_torch.sampling.manifest import write_benchmark_manifests
from genie2_tpu_torch.sampling.motif_target import load_motif_target, load_motif_target_info, parse_motif_target_pdb
from genie2_tpu_torch.sampling.scaffold import ScaffoldSampler
from genie2_tpu_torch.sampling.smc import SMCSampler, TDSTrace, tds_sample, tds_sample_injected
from genie2_tpu_torch.sampling.sse_guided import soft_sse_fraction, sse_guided_sample, sse_guided_sample_injected
from genie2_tpu_torch.sampling.twisting import (
    enumerate_motif_placements,
    motif_distance,
    motif_frame_rotations,
    placements_to_positions,
    twisting_log_prob,
    twisting_log_prob_frames,
    xstart_variance,
)
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
    "FKResult",
    "smc_feynman_kac",
    "smc_feynman_kac_injected",
    "soft_sse_fraction",
    "sse_guided_sample",
    "sse_guided_sample_injected",
    "RESAMPLERS",
    "ess_from_log_weights",
    "multinomial_resample_indices",
    "normalize_log_weights",
    "resampling_draws",
    "resampling_generator",
    "stratified_resample_indices",
    "systematic_resample_indices",
    "write_benchmark_manifests",
    "load_motif_target",
    "load_motif_target_info",
    "parse_motif_target_pdb",
    "SMCSampler",
    "TDSTrace",
    "tds_sample",
    "tds_sample_injected",
    "enumerate_motif_placements",
    "motif_distance",
    "motif_frame_rotations",
    "placements_to_positions",
    "twisting_log_prob",
    "twisting_log_prob_frames",
    "xstart_variance",
]
