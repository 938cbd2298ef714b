"""The strip pieces of the sharded path (one process, no ranks) against the
JAX package: rect_for_grid, shift_projected with a tile-aligned offset and
with another, render with pixel_offset, and render_projected on a shifted
strip, which must equal the full render's rows.

The projections are drawn in numpy (no JAX preprocess compile); the one JAX
compile is the render with pixel_offset.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.raster import preprocess as jax_pre
from frosting_tpu.raster import render as jax_render  # the function
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.parallel.sharded_train import strip_config
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster import preprocess as pre
from frosting_tpu_torch.raster.render import render_projected

torch.set_num_threads(1)
FULL = dict(width=96, height=64, tile_w=32, tile_h=16, chunk=32, max_instances=8192)


def _projection(seed=0, n=400):
    """A Projected of random means, radii and rects on the full 96 x 64
    image, as numpy (rects from the isotropic radius, some invalid)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-20, 116, (n, 2)).astype(np.float32)
    radii = rng.integers(0, 30, n).astype(np.int32)
    rect, valid = jax_pre.rect_for_grid(jnp.asarray(means), jnp.asarray(radii),
                                        JaxConfig(**FULL))
    return {
        "means2d": means,
        "conics": rng.uniform(0.01, 0.2, (n, 3)).astype(np.float32),
        "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
        "opacities": rng.uniform(0.1, 0.9, n).astype(np.float32),
        "depths": rng.uniform(1, 5, n).astype(np.float32),
        "radii": radii,
        "rect": np.asarray(rect),
        "valid": np.asarray(valid) & (rng.uniform(size=n) > 0.1),
    }


def _port(d):
    return pre.Projected(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def _jax(d):
    return jax_pre.Projected(**{k: jnp.asarray(v) for k, v in d.items()})


def test_rect_for_grid_matches_jax():
    rng = np.random.default_rng(1)
    means = rng.uniform(-40, 140, (2000, 2)).astype(np.float32)
    radii = rng.integers(0, 50, 2000).astype(np.int32)
    for cfg in (dict(FULL), dict(FULL, height=16, proj_height=64)):
        rect, valid = pre.rect_for_grid(torch.from_numpy(means), torch.from_numpy(radii),
                                        RasterConfig(**cfg))
        jrect, jvalid = jax_pre.rect_for_grid(jnp.asarray(means), jnp.asarray(radii),
                                              JaxConfig(**cfg))
        np.testing.assert_array_equal(rect.numpy(), np.asarray(jrect))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("offset,aligned", [((0, 32), True), ((0, 16), None), ((5, 21), None),
                                            ((0, 24), False)],
                         ids=["aligned", "aligned-found", "not-aligned", "rederived"])
def test_shift_projected_matches_jax(offset, aligned):
    d = _projection()
    s_cfg = dict(FULL, height=16, proj_width=96, proj_height=64)
    got = pre.shift_projected(_port(d), offset, RasterConfig(**s_cfg), tile_aligned=aligned)
    want = jax_pre.shift_projected(_jax(d), offset, JaxConfig(**s_cfg), tile_aligned=aligned)
    for k in ("means2d", "rect", "valid", "radii", "conics"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)


@pytest.fixture(scope="module")
def scene():
    gt = jax_synthetic.gaussian_blob_scene(n=600, seed=3)
    jcam = jax_synthetic.camera_ring(n_cams=1, radius=3.0)[0]
    cam = camera_from_numpy({f.name: np.asarray(getattr(jcam, f.name))
                             for f in dataclasses.fields(jcam)}, device="cpu")
    return gt, jcam, tuple(torch.from_numpy(np.array(a)) for a in gt), cam


def test_render_with_pixel_offset_matches_jax(scene):
    """A 64 x 32 window at (32, 16) of the full 96 x 64 projection."""
    gt, jcam, model, cam = scene
    sub = dict(FULL, width=64, height=32, proj_width=96, proj_height=64)
    jcfg = JaxConfig(backend="jax", bwd_sort_bf16=False, **sub)
    want = jax.jit(lambda *g: jax_render(*g, jcam, jcfg, pixel_offset=(32, 16)).image)(
        *gt)
    got = render(*model, cam, RasterConfig(**sub), pixel_offset=(32, 16)).image
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_render_projected_on_a_shifted_strip_equals_the_full_rows(scene):
    """Each strip of 4, from the full image's projection shifted by
    shift_projected (tile-aligned): the full render's rows, and the same
    instances per tile row."""
    _gt, _jcam, model, cam = scene
    full_cfg = RasterConfig(**FULL)
    proj = pre.preprocess(*model, cam, full_cfg)
    full = render_projected(proj, full_cfg)
    s_cfg = strip_config(full_cfg, 4)
    total = 0
    for t in range(4):
        out = render_projected(pre.shift_projected(proj, (0, t * s_cfg.height), s_cfg), s_cfg)
        rows = slice(t * s_cfg.height, (t + 1) * s_cfg.height)
        np.testing.assert_array_equal(out.image.numpy(), full.image[:, rows].numpy())
        np.testing.assert_array_equal(out.t_final.numpy(), full.t_final[rows].numpy())
        total += int(out.num_instances)
    assert total == int(full.num_instances)


def test_strip_config_raises_as_jax():
    for h, n_tile in ((64, 3), (48, 2)):
        cfg = dict(FULL, height=h)
        with pytest.raises(ValueError) as port_err:
            strip_config(RasterConfig(**cfg), n_tile)
        from frosting_tpu.parallel.sharded_train import strip_config as jax_strip_config

        with pytest.raises(ValueError) as jax_err:
            jax_strip_config(JaxConfig(**cfg), n_tile)
        assert str(port_err.value) == str(jax_err.value)
    s = strip_config(RasterConfig(**FULL), 4)
    assert (s.height, s.projection_height, s.projection_width, s.max_instances) == (
        16, 64, 96, 2048)
