from genie2_tpu_torch.diffusion.schedule import (
    Schedule,
    cosine_beta_schedule,
    ddim_step_from_eps,
    get_betas,
    posterior_mean_from_eps,
    posterior_mean_from_x0,
    q_sample,
    x0_from_eps,
)

__all__ = [
    "Schedule",
    "cosine_beta_schedule",
    "ddim_step_from_eps",
    "get_betas",
    "posterior_mean_from_eps",
    "posterior_mean_from_x0",
    "q_sample",
    "x0_from_eps",
]
