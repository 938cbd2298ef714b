"""The port's densification (frosting_tpu_torch.train.densify) and point
cloud initialisation against the JAX reference's, on the CPU.

The JAX state is carried across with gs_trainer.state_from_numpy, and the
split children's normal draws are JAX's own (jax.random.split, then
jax.random.normal, as densify.py:133-139 draws them), handed to the port's
_densify_and_prune. Everything is compared exactly, or at 1e-6 where a
float32 expression is evaluated by the two libraries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.scene import gaussians as jax_gaussians
from frosting_tpu.train import densify as jax_densify
from frosting_tpu.train import optimizer as jax_opt
from frosting_tpu_torch.scene import gaussians as port_gaussians
from frosting_tpu_torch.train import densify as port_densify
from frosting_tpu_torch.train import gs_trainer
from frosting_tpu_torch.train import optimizer as port_opt
from tests.test_torch_optimizer import adam_parts, numpy_fields

EXTENT = 2.0


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(size=(n, 3)).astype(np.float32))


def port_state(jparams, jopt_state, jdstate, max_radii):
    """The JAX trainer's state (params, optax state, DensifyState,
    max_radii) in the port, on the CPU."""
    mu, nu, count = adam_parts(jopt_state)
    return gs_trainer.state_from_numpy(
        numpy_fields(jparams), mu, nu, count,
        {"grad_accum": np.asarray(jdstate.grad_accum),
         "denom": np.asarray(jdstate.denom)},
        np.asarray(max_radii), device="cpu",
    )


def test_create_from_pcd_matches_jax_exactly():
    pts, cols = _cloud(200, 0)
    want = jax_gaussians.create_from_pcd(pts, cols, 256)
    got = port_gaussians.create_from_pcd(pts, cols, 256, device="cpu")
    for f, a in numpy_fields(want).items():
        np.testing.assert_array_equal(getattr(got, f).numpy(), a, err_msg=f)
    with pytest.raises(ValueError):
        port_gaussians.create_from_pcd(pts, cols, 100, device="cpu")


def test_update_stats_matches_jax():
    rng = np.random.default_rng(1)
    c = 64
    grad = rng.normal(scale=1e-4, size=(c, 2)).astype(np.float32)
    radii = rng.integers(0, 3, c).astype(np.int32)
    mask = (rng.uniform(size=c) < 0.8).astype(np.float32)
    acc = rng.uniform(size=c).astype(np.float32)
    den = rng.integers(0, 5, c).astype(np.float32)
    want = jax_densify.update_stats(
        jax_densify.DensifyState(jnp.asarray(acc), jnp.asarray(den)),
        jnp.asarray(grad), jnp.asarray(radii), jnp.asarray(mask), image_size=(96, 80),
    )
    got = port_densify.update_stats(
        port_densify.DensifyState(torch.tensor(acc), torch.tensor(den)),
        torch.tensor(grad), torch.tensor(radii), torch.tensor(mask), image_size=(96, 80),
    )
    np.testing.assert_allclose(got.grad_accum.numpy(), np.asarray(want.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(got.denom.numpy(), np.asarray(want.denom))


def _mid_training_state(seed=2, n=40, capacity=48):
    """A JAX state with varied scales, opacities and rotations, nonzero Adam
    moments and gradient statistics that make some Gaussians clone, some
    split and some be pruned, and more requests than free slots."""
    rng = np.random.default_rng(seed)
    pts, cols = _cloud(n, seed)
    p = jax_gaussians.create_from_pcd(pts, cols, capacity)
    live = np.arange(capacity) < n
    scales_log = np.where(live[:, None], rng.uniform(np.log(0.005), np.log(0.08),
                                                    (capacity, 3)), -10.0)
    opac = np.where(live, rng.uniform(-7.0, 3.0, capacity), -15.0)
    quats = rng.normal(size=(capacity, 4))
    p = dataclasses.replace(
        p,
        scales_log=jnp.asarray(scales_log, jnp.float32),
        opacities_raw=jnp.asarray(opac, jnp.float32),
        quats_raw=jnp.asarray(quats, jnp.float32),
    )
    tx = jax_opt.make_gs_optimizer(EXTENT)
    opt_state = tx.init(p)
    grads = {f: rng.normal(size=a.shape).astype(np.float32)
             for f, a in numpy_fields(p).items()}
    _, opt_state = tx.update(type(p)(**grads), opt_state, p)
    dstate = jax_densify.DensifyState(
        grad_accum=jnp.asarray(rng.uniform(0, 8e-4, capacity), jnp.float32),
        denom=jnp.asarray(rng.integers(1, 4, capacity), jnp.float32),
    )
    max_radii = jnp.asarray(rng.uniform(0, 30, capacity), jnp.float32)
    return p, opt_state, dstate, max_radii


@pytest.mark.parametrize("max_screen_size", [0.0, 20.0], ids=["no-size-prune", "size-prune"])
def test_densify_and_prune_matches_jax(max_screen_size):
    jp, jopt, jd, max_radii = _mid_training_state()
    key = jax.random.key(7)
    dcfg = jax_densify.DensifyConfig()
    want_p, want_opt, want_d, want_info = jax_densify.densify_and_prune(
        jp, jopt, jd, key, EXTENT, dcfg, max_screen_size=max_screen_size,
        max_radii=max_radii,
    )
    info = {k: int(v) for k, v in want_info._asdict().items()}
    assert min(info["n_cloned"], info["n_split"], info["n_pruned"]) > 0, info
    # without the size prune fewer slots free up than are requested
    assert info["n_dropped"] > 0 or max_screen_size > 0, info

    state = port_state(jp, jopt, jd, max_radii)
    k1, k2 = jax.random.split(key)
    eps = [torch.tensor(np.asarray(jax.random.normal(k, (jp.capacity, 3))))
           for k in (k1, k2)]
    got_p, got_d, got_info = port_densify._densify_and_prune(
        state.params, state.opt_state, state.dstate, *eps, EXTENT,
        port_densify.DensifyConfig(), max_screen_size, state.max_radii,
    )
    assert {k: int(v) for k, v in got_info._asdict().items()} == info
    for f, a in numpy_fields(want_p).items():
        np.testing.assert_allclose(getattr(got_p, f).numpy(), a, rtol=1e-6, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(got_p.mask.numpy(), np.asarray(want_p.mask))
    mu, nu, _ = adam_parts(want_opt)
    for g in port_opt.GROUPS:
        np.testing.assert_array_equal(state.opt_state.mu[g].numpy(), mu[g], err_msg=g)
        np.testing.assert_array_equal(state.opt_state.nu[g].numpy(), nu[g], err_msg=g)
    assert float(got_d.grad_accum.abs().sum()) == 0 == float(got_d.denom.abs().sum())


def test_densify_and_prune_draws_from_the_generator():
    jp, jopt, jd, max_radii = _mid_training_state(seed=3)
    runs = []
    for _ in range(2):
        state = port_state(jp, jopt, jd, max_radii)
        gen = torch.Generator().manual_seed(11)
        p, _, info = port_densify.densify_and_prune(
            state.params, state.opt_state, state.dstate, gen, EXTENT
        )
        runs.append(p.means3d)
    assert int(info.n_split) > 0
    assert torch.equal(runs[0], runs[1])  # same seed, same children


def test_reset_opacity_matches_jax():
    jp, jopt, jd, max_radii = _mid_training_state(seed=4)
    want_p, want_opt = jax_densify.reset_opacity(jp, jopt)
    state = port_state(jp, jopt, jd, max_radii)
    got = port_densify.reset_opacity(state.params, state.opt_state)
    np.testing.assert_array_equal(got.opacities_raw.numpy(), np.asarray(want_p.opacities_raw))
    mu, nu, _ = adam_parts(want_opt)
    for g in port_opt.GROUPS:
        np.testing.assert_array_equal(state.opt_state.mu[g].numpy(), mu[g], err_msg=g)
        np.testing.assert_array_equal(state.opt_state.nu[g].numpy(), nu[g], err_msg=g)
