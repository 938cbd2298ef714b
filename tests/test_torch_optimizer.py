"""The port's per-group Adam (frosting_tpu_torch.train.optimizer) against
the JAX reference's optax multi_transform, on the CPU.

Tolerance: float32 round-off only (rtol 1e-5, and atol 1e-7 on parameters
and first moments, 1e-9 on second moments, for elements near zero where
gradients of mixed magnitudes cancel); the two evaluate the same
expressions, but XLA fuses them, and the schedule's exp/log and the bias
corrections' powers round differently in the two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from frosting_tpu.scene.gaussians import create_from_pcd as jax_create_from_pcd
from frosting_tpu.train import optimizer as jax_opt
from frosting_tpu_torch.scene.gaussians import params_from_numpy
from frosting_tpu_torch.train import optimizer as port_opt

EXTENT = 2.5


def adam_parts(opt_state):
    """Per-group (mu, nu, count) of the JAX optimizer state as numpy."""
    mu, nu, count = {}, {}, {}
    for g in port_opt.GROUPS:
        adam = opt_state.inner_states[g].inner_state[0]
        mu[g] = np.asarray(getattr(adam.mu, g))
        nu[g] = np.asarray(getattr(adam.nu, g))
        count[g] = int(adam.count)
    return mu, nu, count


def numpy_fields(p):
    return {f: np.asarray(getattr(p, f)) for f in p.__dataclass_fields__}


def _jax_params(seed=0, n=40, capacity=48):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return jax_create_from_pcd(pts, cols, capacity)


def test_expon_lr_matches_jax():
    steps = np.array([0, 1, 7, 100, 2999, 15000, 30000, 45000], np.int32)
    for kw in (dict(), dict(lr_delay_steps=500, lr_delay_mult=0.01)):
        want = jax_opt.expon_lr(1.6e-4 * EXTENT, 1.6e-6 * EXTENT,
                                max_steps=30_000, **kw)(jnp.asarray(steps))
        got = port_opt.expon_lr(1.6e-4 * EXTENT, 1.6e-6 * EXTENT,
                                max_steps=30_000, **kw)(torch.from_numpy(steps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    zero = port_opt.expon_lr(0.0, 0.0)(torch.tensor(5))
    assert float(zero) == 0.0


def test_adam_steps_match_optax():
    jp = _jax_params()
    tx = jax_opt.make_gs_optimizer(EXTENT)
    jstate = tx.init(jp)
    pp = params_from_numpy(numpy_fields(jp), device="cpu")
    opt = port_opt.make_gs_optimizer(EXTENT)
    pstate = opt.init(pp)
    rng = np.random.default_rng(1)
    update = jax.jit(tx.update)
    for step in range(5):
        grads = {f: rng.normal(scale=10.0 ** -(step % 3), size=a.shape).astype(np.float32)
                 for f, a in numpy_fields(jp).items()}
        updates, jstate = update(type(jp)(**grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step(pp, {g: torch.from_numpy(grads[g]) for g in port_opt.GROUPS}, pstate)
        for f, want in numpy_fields(jp).items():
            np.testing.assert_allclose(getattr(pp, f).numpy(), want, rtol=1e-5,
                                       atol=1e-7, err_msg=f"{f}, step {step}")
    mu, nu, count = adam_parts(jstate)
    for g in port_opt.GROUPS:
        assert int(pstate.count[g]) == count[g] == 5
        np.testing.assert_allclose(pstate.mu[g].numpy(), mu[g], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(pstate.nu[g].numpy(), nu[g], rtol=1e-5, atol=1e-9)


def test_bad_step_leaves_everything_unchanged():
    pp = params_from_numpy(numpy_fields(_jax_params()), device="cpu")
    opt = port_opt.make_gs_optimizer(EXTENT)
    state = opt.init(pp)
    grads = {g: torch.ones_like(getattr(pp, g)) for g in port_opt.GROUPS}
    opt.step(pp, grads, state)
    before = {g: getattr(pp, g).clone() for g in port_opt.GROUPS}
    mu = {g: t.clone() for g, t in state.mu.items()}
    grads = {g: torch.full_like(getattr(pp, g), float("nan")) for g in port_opt.GROUPS}
    opt.step(pp, grads, state, good=torch.tensor(False))
    for g in port_opt.GROUPS:
        assert torch.equal(getattr(pp, g), before[g])
        assert torch.equal(state.mu[g], mu[g])
        assert int(state.count[g]) == 1


def test_reset_adam_rows_matches_jax():
    jp = _jax_params(seed=3)
    tx = jax_opt.make_gs_optimizer(EXTENT)
    jstate = tx.init(jp)
    rng = np.random.default_rng(4)
    grads = {f: rng.normal(size=a.shape).astype(np.float32)
             for f, a in numpy_fields(jp).items()}
    _, jstate = tx.update(type(jp)(**grads), jstate, jp)
    rows = (rng.uniform(size=jp.capacity) < 0.3).astype(np.float32)
    masks = {"opacities_raw": rows, "sh_rest": rows}
    jreset = jax_opt.reset_adam_rows(jstate, {k: jnp.asarray(v) for k, v in masks.items()})

    mu, nu, count = adam_parts(jstate)
    state = port_opt.AdamState(
        mu={g: torch.tensor(a) for g, a in mu.items()},
        nu={g: torch.tensor(a) for g, a in nu.items()},
        count={g: torch.tensor(c, dtype=torch.int32) for g, c in count.items()},
    )
    port_opt.reset_adam_rows(state, {k: torch.from_numpy(v) for k, v in masks.items()})
    mu_r, nu_r, _ = adam_parts(jreset)
    for g in port_opt.GROUPS:
        np.testing.assert_array_equal(state.mu[g].numpy(), mu_r[g])
        np.testing.assert_array_equal(state.nu[g].numpy(), nu_r[g])
    assert np.all(state.mu["sh_rest"].numpy()[rows > 0] == 0)
