"""The port's preprocess against the JAX reference's, field by field.

Float fields agree to atol/rtol 1e-5. rect, radii and valid must be equal,
with one exception the test checks rather than assumes: a Gaussian whose
float extent (mean +- r on either axis, or its 3-sigma radius) lies within
1e-3 px of an integer, where ceil/floor may round the other way under a
last-bit difference.
"""

import jax
import numpy as np
import pytest
import torch

from frosting_tpu.raster.preprocess import preprocess as jax_preprocess
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from tests.test_torch_render import cameras, configs, make_scene, torch_arrays

BOUNDARY_PX = 1e-3


def _near_integer(v):
    return np.abs(v - np.round(v)) < BOUNDARY_PX


def _on_boundary(ref, opac, near):
    """Per Gaussian: does any float extent of the JAX projection lie within
    BOUNDARY_PX of an integer (or its depth on the near plane)? Extents are
    rebuilt in float64 from the conic."""
    a, b, c = (ref.conics[:, i].astype(np.float64) for i in range(3))
    det_conic = a * c - b * b
    with np.errstate(divide="ignore", invalid="ignore"):
        cxx, cyy, cxy = c / det_conic, a / det_conic, -b / det_conic
        t_cut = np.sqrt(
            np.clip(2.0 * np.log(255.0 * np.maximum(opac, 1e-12)) + 1e-2, 0, 9)
        ) / 3.0
        rx = 3.0 * np.sqrt(np.maximum(cxx, 1e-12)) * t_cut
        ry = 3.0 * np.sqrt(np.maximum(cyy, 1e-12)) * t_cut
        mid = 0.5 * (cxx + cyy)
        lam = mid + np.sqrt(np.maximum(0.1, mid * mid - (cxx * cyy - cxy * cxy)))
        r3 = 3.0 * np.sqrt(np.maximum(lam, 1e-12))
    mx, my = ref.means2d[:, 0], ref.means2d[:, 1]
    hit = _near_integer(r3) | (np.abs(ref.depths - near) < 1e-5)
    for v in (mx - rx, mx + rx, my - ry, my + ry):
        hit |= _near_integer(v)
    return hit


def _compare(arrays, jcam, tcam, jcfg, tcfg, **kw):
    ref = jax.jit(lambda g: jax_preprocess(*g, jcam, jcfg, **kw))(arrays)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    out = preprocess(*torch_arrays(arrays), tcam, tcfg, **kw)
    for name in ("means2d", "conics", "colors", "opacities", "depths"):
        np.testing.assert_allclose(
            getattr(out, name).numpy(), getattr(ref, name),
            atol=1e-5, rtol=1e-5, err_msg=name,
        )
    assert out.radii.dtype == torch.int32 and out.rect.dtype == torch.int32
    differs = (
        (out.rect.numpy() != ref.rect).any(axis=1)
        | (out.radii.numpy() != ref.radii)
        | (out.valid.numpy() != ref.valid)
    )
    boundary = _on_boundary(ref, arrays[3], tcfg.near)
    assert not (differs & ~boundary).any(), np.nonzero(differs & ~boundary)
    return out, ref, differs


@pytest.mark.parametrize(
    "width,height,pp,kw",
    [
        (96, 80, (0.5, 0.5), {}),
        (100, 60, (0.45, 0.58), dict(scale_modifier=0.8, active_sh_degree=1)),
    ],
    ids=["96x80", "100x60-offset-pp"],
)
def test_projected_fields_match_jax(width, height, pp, kw):
    arrays = list(make_scene(n=400, seed=width))
    arrays[3][:20] = 0.002  # below the 1/255 cutoff: culled
    arrays[3][20:40] = 0.02  # opacity-aware rect shrink
    arrays = tuple(arrays)
    jcam, tcam = cameras(pp_x=pp[0], pp_y=pp[1])
    jcfg, tcfg = configs(width, height)
    out, ref, differs = _compare(arrays, jcam, tcam, jcfg, tcfg, **kw)
    assert differs.sum() <= 2
    assert ref.valid.sum() > 100 and not out.valid.numpy()[:20].any()

    fields = pack_fields(out)
    assert fields.shape == (401, 9) and fields.is_contiguous()
    np.testing.assert_array_equal(fields[-1].numpy(), np.zeros(9, np.float32))
    opac = np.where(out.valid.numpy(), out.opacities.numpy(), 0.0)
    np.testing.assert_array_equal(fields[:-1, 5].numpy(), opac)
    np.testing.assert_array_equal(fields[:-1, 6:9].numpy(), out.colors.numpy())


def test_all_behind_camera_is_culled():
    arrays = list(make_scene(n=50, seed=4))
    arrays[0] = arrays[0].copy()
    arrays[0][:, 2] = -5.0
    jcam, tcam = cameras()
    jcfg, tcfg = configs(64, 64)
    out, ref, _ = _compare(tuple(arrays), jcam, tcam, jcfg, tcfg)
    assert not out.valid.any() and not ref.valid.any()
    assert int(out.radii.abs().sum()) == 0
