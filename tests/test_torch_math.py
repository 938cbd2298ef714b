"""The port's math core (quaternions, SH, covariance/EWA, cameras) against
the JAX reference on the same numpy inputs, at atol 1e-6 / rtol 1e-5."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu import cameras as jcams
from frosting_tpu.ops import cov as jcov
from frosting_tpu.ops import quat as jquat
from frosting_tpu.ops import sh as jsh
from frosting_tpu_torch import cameras as tcams
from frosting_tpu_torch.ops import cov as tcov
from frosting_tpu_torch.ops import quat as tquat
from frosting_tpu_torch.ops import sh as tsh

TOL = dict(atol=1e-6, rtol=1e-5)


def close(port, ref, **tol):
    np.testing.assert_allclose(
        port.detach().numpy(), np.asarray(ref), **(tol or TOL)
    )


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q[0] = 0.0  # the clamped-norm case
    return q


def test_quat_normalize_and_matrix():
    q = _quats(64, 1)
    close(tquat.normalize(torch.from_numpy(q)), jquat.normalize(jnp.asarray(q)))
    u = q[1:] / np.linalg.norm(q[1:], axis=1, keepdims=True)
    close(tquat.to_matrix(torch.from_numpy(u)), jquat.to_matrix(jnp.asarray(u)))


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_eval(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(96, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sh = rng.normal(size=(96, 25, 3)).astype(np.float32)
    close(
        tsh.eval_sh_bases(degree, torch.from_numpy(d)),
        jsh.eval_sh_bases(degree, jnp.asarray(d)),
    )
    close(
        tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(d)),
        jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)),
    )
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    close(tsh.sh_to_rgb(torch.from_numpy(rgb)), jsh.sh_to_rgb(jnp.asarray(rgb)))
    with pytest.raises(ValueError):
        tsh.eval_sh_bases(5, torch.from_numpy(d))


def test_cov_ewa_conic_extents():
    rng = np.random.default_rng(7)
    n = 128
    means = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.2), (n, 3))).astype(np.float32)
    q = _quats(n, 8)[1:]
    q = np.concatenate([q, q[:1]])
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    jcam = jcams.look_at_camera(eye=[0.3, -0.2, -2.5], target=[0, 0, 0])
    tcam = tcams.look_at_camera(eye=[0.3, -0.2, -2.5], target=[0, 0, 0], device="cpu")

    hom = np.concatenate([means, np.ones((n, 1), np.float32)], 1)
    close(
        tcov.matvec_rows(torch.from_numpy(hom), tcam.full_proj),
        jcov.matvec_rows(jnp.asarray(hom), jcam.full_proj),
    )
    c6_t = tcov.cov3d_from_scale_quat(torch.from_numpy(scales), torch.from_numpy(q))
    c6_j = jcov.cov3d_from_scale_quat(jnp.asarray(scales), jnp.asarray(q))
    close(c6_t, c6_j)

    fx_t, fy_t = tcam.focals(96, 80)
    fx_j, fy_j = jcam.focals(96, 80)
    cov2_t = tcov.ewa_project(
        torch.from_numpy(means), c6_t, tcam.world_view, fx_t, fy_t,
        tcam.tan_fov_x, tcam.tan_fov_y,
    )
    cov2_j = jcov.ewa_project(
        jnp.asarray(means), c6_j, jcam.world_view, fx_j, fy_j,
        jcam.tan_fov_x, jcam.tan_fov_y,
    )
    close(cov2_t, cov2_j)
    conic_t, rad_t, det_t = tcov.conic_and_radius(cov2_t)
    conic_j, rad_j, det_j = jcov.conic_and_radius(cov2_j)
    close(conic_t, conic_j)
    close(rad_t, rad_j)
    close(det_t, det_j, atol=1e-6, rtol=1e-4)  # difference of close products
    for a, b in zip(tcov.axis_extents(cov2_t), jcov.axis_extents(cov2_j)):
        close(a, b)


def _fields(cam):
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


@pytest.mark.parametrize("pp", [(0.5, 0.5), (0.43, 0.61)], ids=["centred", "offset"])
def test_cameras(pp):
    R = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))[0]
    t = np.asarray([0.1, -0.2, 3.0])
    kw = dict(znear=0.05, zfar=50.0, pp_x=pp[0], pp_y=pp[1])
    jcam = jcams.make_camera(R, t, math.radians(55), math.radians(40), **kw)
    tcam = tcams.make_camera(
        R, t, math.radians(55), math.radians(40), device="cpu", **kw
    )
    for name, ref in _fields(jcam).items():
        close(getattr(tcam, name), ref)

    jl = jcams.look_at_camera(eye=[1.0, 2.0, -3.0], target=[0, 0.1, 0], up=(0, 0, 1))
    tl = tcams.look_at_camera(
        eye=[1.0, 2.0, -3.0], target=[0, 0.1, 0], up=(0, 0, 1), device="cpu"
    )
    carried = tcams.camera_from_numpy(_fields(jl), device="cpu")
    for name, ref in _fields(jl).items():
        close(getattr(tl, name), ref)
        np.testing.assert_array_equal(getattr(carried, name).numpy(), ref)
    for a, b in zip(tl.focals(96, 80), jl.focals(96, 80)):
        close(a, b)

    v = np.linspace(-1.2, 1.2, 17).astype(np.float32)
    close(tcams.ndc_to_pix(torch.from_numpy(v), 96), jcams.ndc_to_pix(jnp.asarray(v), 96))
