"""genie2_tpu_torch schedule tables and posterior mean against genie2_tpu."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie2_tpu.diffusion import schedule as jsched
from genie2_tpu_torch.diffusion import schedule as tsched


@pytest.mark.parametrize("n_timestep", [8, 1000])
def test_tables_equal(n_timestep):
    j = jsched.Schedule.create(n_timestep)
    t = tsched.Schedule.create(n_timestep)
    for field in dataclasses.fields(t):
        np.testing.assert_array_equal(
            getattr(t, field.name).numpy(), np.asarray(getattr(j, field.name)), err_msg=field.name
        )
    assert t.n_timestep == n_timestep
    np.testing.assert_array_equal(tsched.get_betas(n_timestep, "cosine"), jsched.get_betas(n_timestep, "cosine"))


def test_posterior_mean_and_q_sample():
    rng = np.random.default_rng(0)
    j, t = jsched.Schedule.create(1000), tsched.Schedule.create(1000)
    xt, eps = (rng.normal(size=(3, 11, 3)).astype(np.float32) for _ in range(2))
    steps = np.array([1, 500, 1000], np.int32)
    np.testing.assert_allclose(
        tsched.posterior_mean_from_eps(t, torch.tensor(xt), torch.tensor(steps).long(), torch.tensor(eps)).numpy(),
        np.asarray(jsched.posterior_mean_from_eps(j, jnp.asarray(xt), jnp.asarray(steps), jnp.asarray(eps))),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tsched.q_sample(t, torch.tensor(xt), torch.tensor(steps).long(), torch.tensor(eps)).numpy(),
        np.asarray(jsched.q_sample(j, jnp.asarray(xt), jnp.asarray(steps), jnp.asarray(eps))),
        rtol=1e-6, atol=1e-6,
    )
