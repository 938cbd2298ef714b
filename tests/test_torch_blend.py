"""The port's plain PyTorch forward blend (blend_forward_torch) against the
JAX reference's pure-JAX blend and its Pallas kernel in interpret mode, on
the same projected Gaussians.

Both JAX backends are driven through render_projected with a black
background, so image = colour and t_final is the final transmittance.
Tolerance: atol/rtol 1e-5 (that of tests/test_pallas_blend.py), with at most
0.1% of pixels allowed a stop-threshold flip (see assert_blend_close).
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from frosting_tpu.raster.preprocess import preprocess as jax_preprocess
from frosting_tpu.raster.render import render_projected as jax_render_projected
from frosting_tpu_torch import _build
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import blend_forward_torch, blend_work_torch
from frosting_tpu_torch.raster.preprocess import Projected, pack_fields
from tests.test_torch_render import assert_blend_close, cameras, configs, make_scene


def _projected(arrays, width, height):
    """JAX preprocess outputs (numpy) and the same in the port's Projected."""
    jcam, _ = cameras()
    jcfg, tcfg = configs(width, height)
    jproj = jax.jit(lambda g: jax_preprocess(*g, jcam, jcfg))(arrays)
    tproj = Projected(*(torch.from_numpy(np.array(a)) for a in jproj))
    return jproj, tproj, jcfg, tcfg


def _jax_blend(jproj, jcfg):
    out = jax.jit(lambda p: jax_render_projected(p, jcfg))(jproj)
    return np.concatenate([np.asarray(out.image), np.asarray(out.t_final)[None]])


def _port_blend(tproj, tcfg):
    binned = bin_gaussians(tproj.rect, tproj.depths, tproj.valid, tcfg)
    return blend_forward_torch(pack_fields(tproj), binned, tcfg).numpy()


@pytest.mark.parametrize(
    "width,height,chunk", [(64, 64, 32), (96, 80, 16)], ids=["64x64", "96x80"]
)
def test_blend_matches_jax(width, height, chunk):
    arrays = make_scene(n=300, seed=11, opaque_wall=True)
    jproj, tproj, jcfg, tcfg = _projected(arrays, width, height)
    tcfg = dataclasses.replace(tcfg, chunk=chunk)  # the walk's step size
    ref = _jax_blend(jproj, jcfg)
    out = _port_blend(tproj, tcfg)
    assert out.shape == (4, height, width)
    assert (ref[3] < 0.5).mean() > 0.2  # the opaque wall stops many pixels
    assert_blend_close(out[:3], ref[:3], "colour")
    assert_blend_close(out[3], ref[3], "t_final")


def test_blend_matches_pallas_interpret():
    # 32x32: 2x2 tiles (interpret mode unrolls the kernel's grid, so its
    # trace and compile grow with the tiles)
    arrays = make_scene(n=250, seed=11, opaque_wall=True)
    jproj, tproj, jcfg, tcfg = _projected(arrays, 32, 32)
    pcfg = dataclasses.replace(jcfg, backend="pallas", pallas_interpret=True)
    ref = _jax_blend(jproj, pcfg)
    out = _port_blend(tproj, tcfg)
    assert_blend_close(out[:3], ref[:3], "colour")
    assert_blend_close(out[3], ref[3], "t_final")


def test_wrapper_on_cpu_is_the_plain_version_and_uncounted():
    arrays = make_scene(n=80, seed=2)
    _, tproj, _, tcfg = _projected(arrays, 96, 80)
    binned = bin_gaussians(tproj.rect, tproj.depths, tproj.valid, tcfg)
    fields = pack_fields(tproj)
    before = blend_cuda.blend_forward.launches
    out = blend_cuda.blend_forward(fields, binned, tcfg)
    assert blend_cuda.blend_forward.launches == before
    torch.testing.assert_close(
        out, blend_forward_torch(fields, binned, tcfg), atol=0, rtol=0
    )


@pytest.mark.parametrize("opaque_wall", [False, True], ids=["sparse", "opaque"])
def test_work_count_matches_a_sequential_walk(opaque_wall):
    """blend_work_torch (the data-dependent work behind chip_smoke's bound)
    equals a per-pixel sequential walk that stops at the stop Gaussian."""
    arrays = make_scene(n=200, seed=3, opaque_wall=opaque_wall)
    _, tproj, _, tcfg = _projected(arrays, 96, 80)
    binned = bin_gaussians(tproj.rect, tproj.depths, tproj.valid, tcfg)
    fields = pack_fields(tproj)
    want = 0
    for t, (s, e) in enumerate(binned.tile_ranges.tolist()):
        x0 = t % tcfg.tiles_x * tcfg.tile_w
        y0 = t // tcfg.tiles_x * tcfg.tile_h
        ys, xs = torch.meshgrid(
            torch.arange(y0, min(y0 + tcfg.tile_h, tcfg.height)).float(),
            torch.arange(x0, min(x0 + tcfg.tile_w, tcfg.width)).float(),
            indexing="ij",
        )
        T = torch.ones_like(xs)
        done = torch.zeros_like(xs, dtype=torch.bool)
        for g in binned.inst_gauss[s:e].tolist():
            mx, my, ca, cb, cc, op = fields[g, :6].tolist()
            want += int((~done).sum())
            dx, dy = mx - xs, my - ys
            power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
            raw = op * torch.exp(power)
            alpha = torch.where((power > 0) | (raw < 1 / 255), 0.0, raw.clamp(max=0.99))
            stop = ~done & (T * (1 - alpha) < 1e-4)
            T = torch.where(done | stop, T, T * (1 - alpha))
            done |= stop
    assert int(blend_work_torch(fields, binned, tcfg)) == want


def test_empty_scene_blends_to_transparent():
    _, tcfg = configs(96, 80)
    proj = Projected(
        torch.zeros(0, 2), torch.zeros(0, 3), torch.zeros(0, 3), torch.zeros(0),
        torch.zeros(0), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, 4, dtype=torch.int32), torch.zeros(0, dtype=torch.bool),
    )
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, tcfg)
    out = blend_forward_torch(pack_fields(proj), binned, tcfg)
    torch.testing.assert_close(out[:3], torch.zeros(3, 80, 96))
    torch.testing.assert_close(out[3], torch.ones(80, 96))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The library name follows the source's content; without nvcc the
    build raises instead of falling back."""
    for name in blend_cuda.KERNELS:
        lib = _build.library_path(name)
        assert lib.parent == _build.BUILD_DIR
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    if shutil.which("nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(blend_cuda.KERNELS)
