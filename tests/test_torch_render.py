"""The port's render (frosting_tpu_torch.raster.render) against the JAX
reference's render and against the port's per-pixel oracle, on the CPU.

Also holds the helpers the other port parity tests share: a numpy scene fed
identically to both packages, and the JAX camera carried across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.cameras import look_at_camera as jax_look_at
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.raster import render as jax_render
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster.preprocess import preprocess
from frosting_tpu_torch.raster.reference import render_naive

# The suite runs in several worker processes on a few cores: torch's default
# of one intra-op thread per core oversubscribes them (spinning OpenMP
# threads slowed a 0.1 s test to 18 s under 6 workers). Every worker imports
# this module while collecting, so this holds for all of them.
torch.set_num_threads(1)

BG = np.asarray([0.1, 0.2, 0.3], np.float32)
EYE = [0.2, -0.3, -2.8]
# Stop-threshold flips: JAX sums colour per chunk with a matmul and the
# transmittance with a lane scan, the port sequentially or with cumprod, so
# a pixel whose T * (1 - alpha) sits on the 1e-4 stop threshold may stop one
# Gaussian earlier on one side. That changes one contribution alpha * T,
# where T * (1 - alpha) ~ 1e-4 and alpha <= 0.99 give alpha * T <= ~1e-2.
# At most 0.1% of pixels may differ that way; all others hold atol/rtol 1e-5
# (the Pallas-vs-JAX tolerance of tests/test_pallas_blend.py).
FLIP_SHARE = 1e-3
FLIP_BOUND = 1e-2


def make_scene(n=300, seed=0, opaque_wall=False):
    """Activated Gaussians as float32 numpy arrays (tests/test_raster.py's
    scene)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.8, 0.8, size=(n, 3))
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.12), size=(n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 0.995, size=(n,))
    if opaque_wall:
        opac[: n // 3] = 0.99
    sh = rng.normal(size=(n, 16, 3)) * 0.3
    sh[:, 0, :] += 1.0
    return tuple(
        np.asarray(a, np.float32) for a in (means, scales, quats, opac, sh)
    )


def cameras(eye=EYE, **kw):
    """(JAX camera, the same camera in the port on the CPU)."""
    jcam = jax_look_at(eye=eye, target=[0.0, 0.0, 0.0], **kw)
    d = {f.name: np.asarray(getattr(jcam, f.name)) for f in dataclasses.fields(jcam)}
    return jcam, camera_from_numpy(d, device="cpu")


def configs(width, height, chunk=32, max_instances=8192):
    """(JAX config on the pure-JAX backend, the port's config)."""
    kw = dict(width=width, height=height, tile_w=32, tile_h=16, chunk=chunk,
              max_instances=max_instances)
    return JaxConfig(backend="jax", **kw), RasterConfig(**kw)


def torch_arrays(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def assert_blend_close(actual, desired, what):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, what
    err = np.abs(actual - desired)
    off = err > 1e-5 + 1e-5 * np.abs(desired)
    assert off.mean() <= FLIP_SHARE, f"{what}: {off.sum()} pixels off"
    assert err.max() <= FLIP_BOUND, f"{what}: max err {err.max()}"


def _jax_render(arrays, jcam, jcfg, bg):
    fn = jax.jit(lambda g, b: jax_render(*g, jcam, jcfg, bg=b))
    out = fn(tuple(jnp.asarray(a) for a in arrays), jnp.asarray(bg))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize(
    "width,height,opaque_wall",
    [(64, 64, False), (96, 80, True)],
    ids=["64x64", "96x80-opaque"],
)
def test_render_matches_jax_and_naive(width, height, opaque_wall):
    arrays = make_scene(n=300, seed=width, opaque_wall=opaque_wall)
    jcam, tcam = cameras()
    jcfg, tcfg = configs(width, height)
    ref = _jax_render(arrays, jcam, jcfg, BG)
    out = render(*torch_arrays(arrays), tcam, tcfg, bg=torch.from_numpy(BG))

    assert out.image.shape == (3, height, width)
    assert not bool(out.overflow) and not bool(ref.overflow)
    assert int(out.num_instances) == int(ref.num_instances) > 0
    np.testing.assert_array_equal(out.radii.numpy(), ref.radii)
    assert_blend_close(out.image.numpy(), ref.image, "image vs JAX")
    assert_blend_close(out.t_final.numpy(), ref.t_final, "t_final vs JAX")

    proj = preprocess(*torch_arrays(arrays), tcam, tcfg)
    img_n, t_n = render_naive(proj, torch.from_numpy(BG), tcfg)
    assert_blend_close(out.image.numpy(), img_n.numpy(), "image vs naive")
    assert_blend_close(out.t_final.numpy(), t_n.numpy(), "t_final vs naive")


def test_background_and_all_behind_camera():
    arrays = make_scene(n=120, seed=5)
    _, tcam = cameras()
    _, tcfg = configs(96, 80)
    bg = torch.tensor([0.7, 0.1, 0.4])
    out = render(*torch_arrays(arrays), tcam, tcfg, bg=bg)
    black = render(*torch_arrays(arrays), tcam, tcfg)
    # background enters as t_final * bg on top of the black-background image
    torch.testing.assert_close(
        out.image, black.image + out.t_final[None] * bg[:, None, None],
        atol=1e-6, rtol=0,
    )

    # move every Gaussian behind the camera: pure background, radii 0
    means = arrays[0].copy()
    means[:, 2] = -4.0
    behind = render(
        *torch_arrays((means,) + arrays[1:]), tcam, tcfg, bg=bg
    )
    assert int(behind.num_instances) == 0 and not bool(behind.overflow)
    assert int(behind.radii.abs().sum()) == 0
    torch.testing.assert_close(behind.t_final, torch.ones(80, 96))
    torch.testing.assert_close(
        behind.image, bg[:, None, None].expand(3, 80, 96), atol=0, rtol=0
    )


def test_means2d_probe_shifts_the_splats():
    arrays = make_scene(n=60, seed=9)
    _, tcam = cameras()
    _, tcfg = configs(64, 64)
    base = render(*torch_arrays(arrays), tcam, tcfg)
    zero = render(
        *torch_arrays(arrays), tcam, tcfg, means2d_probe=torch.zeros(60, 2)
    )
    torch.testing.assert_close(zero.image, base.image, atol=0, rtol=0)
    moved = render(
        *torch_arrays(arrays), tcam, tcfg,
        means2d_probe=torch.full((60, 2), 3.0),
    )
    assert float((moved.image - base.image).abs().max()) > 1e-2
