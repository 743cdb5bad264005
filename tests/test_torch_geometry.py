"""genie2_tpu_torch geometry and encodings against genie2_tpu (fp32, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genie2_tpu.geometry as jgeo
import genie2_tpu_torch.geometry as tgeo
from genie2_tpu_torch.geometry import Rigid


def _trace(rng, lengths, n_pad=0):
    """A random-walk CA trace for chains of `lengths`, zero-padded."""
    n = sum(lengths)
    coords = np.cumsum(rng.normal(size=(n, 3)) * 2.0 + 1.0, axis=0).astype(np.float32)
    chain = np.concatenate([[i] * l for i, l in enumerate(lengths)]).astype(np.int32)
    mask = np.ones(n, np.int32)
    if n_pad:
        coords = np.concatenate([coords, np.zeros((n_pad, 3), np.float32)])
        chain = np.concatenate([chain, np.zeros(n_pad, np.int32)])
        mask = np.concatenate([mask, np.zeros(n_pad, np.int32)])
    return coords, chain, mask


@pytest.mark.parametrize("case", ["monomer", "padded", "two_chain"])
def test_frenet_frames(case):
    rng = np.random.default_rng(0)
    lengths, pad = {"monomer": ([20], 0), "padded": ([17], 7), "two_chain": ([9, 11], 4)}[case]
    batch = [_trace(rng, lengths, pad) for _ in range(2)]
    coords, chain, mask = (np.stack(x) for x in zip(*batch))
    want = np.asarray(jgeo.frenet_frames(jnp.asarray(coords), jnp.asarray(chain), jnp.asarray(mask)))
    got = tgeo.frenet_frames(torch.tensor(coords), torch.tensor(chain), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, np.asarray(jgeo.quat_to_rot(jnp.asarray(q)))


def test_quat_to_rot():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)  # unnormalised: the quadratic form
    want = np.asarray(jgeo.quat_to_rot(jnp.asarray(q)))
    np.testing.assert_allclose(tgeo.quat_to_rot(torch.tensor(q)).numpy(), want, atol=1e-5)


def test_rot_to_quat_closed():
    rng = np.random.default_rng(2)
    _, rots = _rotations(rng, 256)
    rots = np.concatenate([rots, np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3))])
    want = np.asarray(jgeo.rot_to_quat(jnp.asarray(rots), method="closed"))
    got = tgeo.rot_to_quat(torch.tensor(rots), method="closed").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rot_to_quat_eigh_up_to_sign():
    """Eigenvector signs are the solver's choice, so compare up to a sign
    per quaternion."""
    rng = np.random.default_rng(3)
    q_true, rots = _rotations(rng, 256)
    want = np.asarray(jgeo.rot_to_quat(jnp.asarray(rots), method="eigh"))
    got = tgeo.rot_to_quat(torch.tensor(rots), method="eigh").numpy()
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=1e-4)
    # and both are the rotation's quaternion up to sign
    np.testing.assert_allclose(np.abs(np.sum(got * q_true, -1)), 1.0, atol=1e-4)


def test_distogram_and_encoding():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(2, 13, 3)).astype(np.float32) * 5
    b = rng.normal(size=(2, 7, 3)).astype(np.float32) * 5
    np.testing.assert_allclose(
        tgeo.distogram(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jgeo.distogram(jnp.asarray(a), jnp.asarray(b))), atol=1e-5,
    )
    v = rng.integers(0, 1000, size=(3, 17)).astype(np.int32)
    for n, d in ((1000, 64), (256, 32), (1, 8)):
        np.testing.assert_allclose(
            tgeo.sinusoidal_encoding(torch.tensor(v), n, d).numpy(),
            np.asarray(jgeo.sinusoidal_encoding(jnp.asarray(v), n, d)), atol=2e-5,
        )


def test_rigid_matches():
    rng = np.random.default_rng(5)
    _, r1 = _rotations(rng, 6)
    _, r2 = _rotations(rng, 6)
    t1, t2, pts = (rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3))
    ja, jb = jgeo.Rigid(jnp.asarray(r1), jnp.asarray(t1)), jgeo.Rigid(jnp.asarray(r2), jnp.asarray(t2))
    ta, tb = Rigid(torch.tensor(r1), torch.tensor(t1)), Rigid(torch.tensor(r2), torch.tensor(t2))
    jc, tc = ja.compose(jb), ta.compose(tb)
    np.testing.assert_allclose(tc.rots.numpy(), np.asarray(jc.rots), atol=1e-5)
    np.testing.assert_allclose(tc.trans.numpy(), np.asarray(jc.trans), atol=1e-5)
    np.testing.assert_allclose(tc.apply(torch.tensor(pts)).numpy(), np.asarray(jc.apply(jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose(
        tc.invert_apply(torch.tensor(pts)).numpy(), np.asarray(jc.invert_apply(jnp.asarray(pts))), atol=1e-5
    )
    u = ta.unsqueeze(-1)
    assert tuple(u.rots.shape) == (6, 1, 3, 3) and tuple(u.trans.shape) == (6, 1, 3)
    np.testing.assert_allclose(ta.scale_translation(2.5).trans.numpy(), t1 * 2.5, atol=1e-6)
