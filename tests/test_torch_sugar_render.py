"""The port's depth and normal renders (frosting_tpu_torch.models.sugar.
render_depth_normal_maps) and their VJP through the plain blend, against
jax.vjp of the JAX function on its pure-JAX blend, on the CPU (the scene of
tests/test_torch_sugar.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from frosting_tpu.models import sugar as jax_sugar
from frosting_tpu_torch.models import sugar
from tests.test_torch_render import cameras, configs
from tests.test_torch_sugar import scene  # noqa: F401 (fixture)


def test_depth_normal_renders_and_vjp_match_jax(scene):
    """render_depth_normal_maps through the plain blend, and its VJP for
    cotangents on the depth, normal and acc maps (acc = 1 - t_final puts a
    cotangent on the blend's transmittance), against jax.vjp of the JAX
    function on its pure-JAX blend; with normals=False, the same depth and
    acc maps."""
    arrays = [scene[k] for k in ("means", "scales", "quats", "opac")]
    jcam, tcam = cameras(eye=[0.3, -0.4, -2.6])
    jcfg, tcfg = configs(48, 32, max_instances=1 << 14)
    jcfg = dataclasses.replace(jcfg, bwd_sort_bf16=False)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = sugar.render_depth_normal_maps(*leaves, tcam, tcfg)
    # depth / acc magnifies rounding where acc is ~0: no cotangent there
    covered = got[2].detach().numpy() > 0.05
    rng = np.random.default_rng(4)
    cot = [(rng.normal(size=s) * covered).astype(np.float32)
           for s in ((32, 48), (3, 32, 48), (32, 48))]
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(c) for c in cot])

    @jax.jit
    def jfn(a, c):
        out, vjp = jax.vjp(lambda *x: jax_sugar.render_depth_normal_maps(*x, jcam, jcfg), *a)
        return out, vjp(c)

    want, jgrads = jfn(tuple(jnp.asarray(a) for a in arrays), tuple(jnp.asarray(c) for c in cot))
    assert covered.mean() > 0.3
    for g, w, what in zip(got, want, ("depth", "normal", "acc")):
        g, w = g.detach().numpy(), np.asarray(w)
        mask = covered if g.ndim == 2 else covered[None].repeat(3, 0)
        np.testing.assert_allclose(g[mask], w[mask], rtol=1e-4, atol=1e-5, err_msg=what)
    for g, jg, what in zip(grads, jgrads, ("means", "scales", "quats", "opac")):
        scale = float(np.abs(jg).max())
        assert scale > 0, what
        err = np.abs(g.numpy() - np.asarray(jg)) / scale
        assert err.max() <= 5e-4, (what, err.max())
    # without the normal render (the sdf method's call): the same depth and acc
    depth, normal, acc = sugar.render_depth_normal_maps(*leaves, tcam, tcfg, normals=False)
    assert normal is None
    assert torch.equal(depth, got[0]) and torch.equal(acc, got[2])
