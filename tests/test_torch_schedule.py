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


def test_step_functions_equal_jax():
    """x0_from_eps, ddim_step_from_eps (eta 0, 0.5, 1, and the jump to
    t_prev = 0) and posterior_mean_from_x0 against genie2_tpu, fp32."""
    rng = np.random.default_rng(1)
    j, t = jsched.Schedule.create(1000), tsched.Schedule.create(1000)
    xt, eps, noise, x0 = (rng.normal(size=(3, 11, 3)).astype(np.float32) for _ in range(4))
    steps = np.array([1, 500, 1000], np.int32)
    prev = np.array([0, 480, 980], np.int32)
    tt = lambda a: torch.tensor(a).long() if a.dtype == np.int32 else torch.tensor(a)
    np.testing.assert_allclose(
        tsched.x0_from_eps(t, tt(xt), tt(steps), tt(eps)).numpy(),
        np.asarray(jsched.x0_from_eps(j, jnp.asarray(xt), jnp.asarray(steps), jnp.asarray(eps))),
        rtol=1e-6, atol=1e-5,
    )
    for eta in (0.0, 0.5, 1.0):
        np.testing.assert_allclose(
            tsched.ddim_step_from_eps(t, tt(xt), tt(steps), tt(prev), tt(eps), tt(noise), eta).numpy(),
            np.asarray(jsched.ddim_step_from_eps(
                j, jnp.asarray(xt), jnp.asarray(steps), jnp.asarray(prev), jnp.asarray(eps), jnp.asarray(noise), eta)),
            rtol=1e-5, atol=1e-5, err_msg=f"eta={eta}",
        )
    np.testing.assert_allclose(
        tsched.posterior_mean_from_x0(t, tt(xt), tt(steps), tt(x0)).numpy(),
        np.asarray(jsched.posterior_mean_from_x0(j, jnp.asarray(xt), jnp.asarray(steps), jnp.asarray(x0))),
        rtol=1e-6, atol=1e-6,
    )
