"""Gradients of the port's render (the autograd Function over binning and
the blend, then autograd through preprocess) against the JAX reference's
``jax.grad`` of its render, on the CPU, where the port's blend runs its
plain PyTorch versions.

The JAX side runs on the pure-JAX backend with ``bwd_sort_bf16=False`` (the
default quantises per-instance gradient rows to bf16), and once on the
Pallas kernels in interpret mode. Tolerance: gradients normalised by the
reference's largest magnitude agree to atol 5e-4, the render-vs-oracle
gradient tolerance of tests/test_raster.py (sums over pixels and instances
in another order, and stop-threshold flips, move a few normalised 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.raster import render as jax_render
from frosting_tpu.raster.preprocess import preprocess as jax_preprocess
from frosting_tpu.raster.render import _blend as jax_blend
from frosting_tpu.raster.render import pack_fields as jax_pack_fields
from frosting_tpu_torch.raster import render
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_cuda import blend_backward, blend_forward
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
)
from frosting_tpu_torch.raster.preprocess import Projected, pack_fields, preprocess
from frosting_tpu_torch.raster.render import BlendFunction
from tests.test_torch_render import BG, cameras, configs, make_scene

NAMES = ("means", "scales", "quats", "opacities", "sh")
ATOL = 5e-4


def _target(height, width, seed=13):
    return np.random.default_rng(seed).uniform(size=(3, height, width)).astype(np.float32)


def _jax_grads(arrays, jcam, jcfg, target):
    def loss(g, probe):
        out = jax_render(*g, jcam, jcfg, bg=jnp.asarray(BG), means2d_probe=probe)
        return jnp.mean((out.image - target) ** 2) + 0.1 * jnp.mean(out.t_final)

    g = tuple(jnp.asarray(a) for a in arrays)
    probe = jnp.zeros((arrays[0].shape[0], 2), jnp.float32)
    grads, g_probe = jax.jit(jax.grad(loss, argnums=(0, 1)))(g, probe)
    return [np.asarray(a) for a in grads], np.asarray(g_probe)


def _port_grads(arrays, tcam, tcfg, target):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    probe = torch.zeros((arrays[0].shape[0], 2), requires_grad=True)
    out = render(*ts, tcam, tcfg, bg=torch.from_numpy(BG), means2d_probe=probe)
    loss = torch.mean((out.image - torch.from_numpy(target)) ** 2) + 0.1 * torch.mean(
        out.t_final
    )
    loss.backward()
    return [t.grad.numpy() for t in ts], probe.grad.numpy()


def _assert_normalised_close(actual, desired, what, atol=ATOL):
    scale = np.abs(desired).max() + 1e-8
    np.testing.assert_allclose(actual / scale, desired / scale, atol=atol,
                               err_msg=f"gradient mismatch: {what}")


@pytest.mark.parametrize(
    "width,height,opaque_wall",
    [(64, 64, False), (96, 80, True)],
    ids=["64x64", "96x80-opaque"],
)
def test_render_gradients_match_jax(width, height, opaque_wall):
    arrays = make_scene(n=300, seed=width + 1, opaque_wall=opaque_wall)
    jcam, tcam = cameras()
    jcfg, tcfg = configs(width, height)
    jcfg = dataclasses.replace(jcfg, bwd_sort_bf16=False)
    target = _target(height, width)
    ref, ref_probe = _jax_grads(arrays, jcam, jcfg, target)
    got, got_probe = _port_grads(arrays, tcam, tcfg, target)
    for name, a, b in zip(NAMES, got, ref):
        assert np.abs(b).max() > 0, name
        _assert_normalised_close(a, b, name)
    # the screen-space gradient densification reads
    assert np.abs(ref_probe).max() > 0
    _assert_normalised_close(got_probe, ref_probe, "means2d_probe")


def test_render_gradients_match_pallas_interpret():
    # 32x32: 2x2 tiles, edges inside the image on both axes (interpret
    # mode unrolls the kernels' grid, so its trace and compile grow with
    # the tiles: 17 s at 64x32, 10 s here)
    arrays = make_scene(n=100, seed=12)
    jcam, tcam = cameras()
    jcfg, tcfg = configs(32, 32)
    pcfg = dataclasses.replace(
        jcfg, backend="pallas", pallas_interpret=True, bwd_sort_bf16=False
    )
    target = _target(32, 32, seed=14)
    ref, _ = _jax_grads(arrays, jcam, pcfg, target)
    got, _ = _port_grads(arrays, tcam, tcfg, target)
    for name, a, b in zip(NAMES, got, ref):
        _assert_normalised_close(a, b, name)


def _tiled_cotangent(g, jcfg):
    """[4, H, W] -> JAX's blend layout [n_tiles + 1, 4, P], zero past the
    image edge and in the trailing dummy tile."""
    ph, pw = jcfg.tiles_y * jcfg.tile_h, jcfg.tiles_x * jcfg.tile_w
    pad = np.zeros((4, ph, pw), np.float32)
    pad[:, : g.shape[1], : g.shape[2]] = g
    t = pad.reshape(4, jcfg.tiles_y, jcfg.tile_h, jcfg.tiles_x, jcfg.tile_w)
    t = t.transpose(1, 3, 0, 2, 4).reshape(jcfg.n_tiles, 4, jcfg.tile_pixels)
    return np.concatenate([t, np.zeros((1, 4, jcfg.tile_pixels), np.float32)])


def test_blend_function_matches_jax_vjp():
    """Per-Gaussian dfields of the port's Function against jax.vjp of the
    JAX custom-VJP boundary _blend, on the same projected Gaussians."""
    arrays = make_scene(n=300, seed=21, opaque_wall=True)
    jcam, _ = cameras()
    jcfg, tcfg = configs(96, 80)
    jcfg = dataclasses.replace(jcfg, bwd_sort_bf16=False)
    jproj = jax.jit(lambda g: jax_preprocess(*g, jcam, jcfg))(arrays)
    g = np.random.default_rng(5).normal(size=(4, 80, 96)).astype(np.float32)

    def blend_out(fields_ext):
        return jax_blend(jcfg, fields_ext, jproj.rect, jproj.depths, jproj.valid)[0]

    def dfields(fields_ext, cotangent):
        return jax.vjp(blend_out, fields_ext)[1](cotangent)[0]

    ref = jax.jit(dfields)(jax_pack_fields(jproj), jnp.asarray(_tiled_cotangent(g, jcfg)))
    ref = np.asarray(ref).T  # [N + 1, 9]

    tproj = Projected(*(torch.from_numpy(np.array(a)) for a in jproj))
    fields = pack_fields(tproj).requires_grad_(True)
    out, _, _ = BlendFunction.apply(
        fields, tproj.rect, tproj.depths, tproj.valid, tcfg,
        blend_forward, blend_backward,
    )
    out.backward(torch.from_numpy(g))
    got = fields.grad.numpy()
    assert np.all(got[-1] == 0)  # the sentinel row
    for c in range(9):
        _assert_normalised_close(got[:, c], ref[:, c], f"dfields[:, {c}]")


def test_backward_matches_autograd_of_the_plain_forward():
    """blend_backward_torch, summed per Gaussian, against autograd through
    blend_forward_torch. Both walk the same mask, so no stop flips: the
    sums differ only in order (normalised atol 1e-5)."""
    arrays = make_scene(n=300, seed=4, opaque_wall=True)
    _, tcam = cameras()
    _, tcfg = configs(96, 80)
    with torch.no_grad():
        proj = preprocess(*(torch.from_numpy(a) for a in arrays), tcam, tcfg)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, tcfg)
    fields = pack_fields(proj).requires_grad_(True)
    out = blend_forward_torch(fields, binned, tcfg)
    g = torch.from_numpy(
        np.random.default_rng(0).normal(size=tuple(out.shape)).astype(np.float32)
    )
    (out * g).sum().backward()
    rows = blend_backward_torch(fields.detach(), binned, tcfg, out.detach(), g)
    assert rows.shape == (binned.inst_gauss.shape[0], 9)
    got = torch.zeros_like(fields).index_add_(0, binned.inst_gauss.long(), rows)
    for c in range(9):
        _assert_normalised_close(
            got[:, c].numpy(), fields.grad[:, c].numpy(), f"column {c}", atol=1e-5
        )
