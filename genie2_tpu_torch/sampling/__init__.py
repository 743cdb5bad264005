from genie2_tpu_torch.sampling.base import BaseSampler, bucket_length, pad_residues
from genie2_tpu_torch.sampling.ddpm import (
    ancestral_sample,
    ancestral_sample_injected,
    init_translations,
    reverse_step,
    step_noise,
)
from genie2_tpu_torch.sampling.unconditional import UnconditionalSampler

__all__ = [
    "BaseSampler",
    "bucket_length",
    "pad_residues",
    "ancestral_sample",
    "ancestral_sample_injected",
    "init_translations",
    "reverse_step",
    "step_noise",
    "UnconditionalSampler",
]
