from genie2_tpu_torch.diffusion.schedule import (
    Schedule,
    cosine_beta_schedule,
    get_betas,
    posterior_mean_from_eps,
    q_sample,
)

__all__ = ["Schedule", "cosine_beta_schedule", "get_betas", "posterior_mean_from_eps", "q_sample"]
