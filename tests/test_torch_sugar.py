"""Stage 2 of the port (frosting_tpu_torch.models.fields, models.sugar and
train.sugar_trainer) against the JAX package on the CPU: the field
values, the sampling given JAX's own draws, every loss of models/sugar.py
with its gradient against jax.grad, the hard prune and the phase schedule.
The depth / normal renders' VJP and one whole SuGaR step are in
tests/test_torch_sugar_render.py and test_torch_sugar_step.py.

Tolerance, unless a test says otherwise: rtol 1e-5, atol 1e-6 (float32
sums in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.models import fields as jax_fields_lib
from frosting_tpu.models import sugar as jax_sugar
from frosting_tpu.scene.gaussians import GaussianParams as JaxParams
from frosting_tpu.train import sugar_trainer as jax_trainer
from frosting_tpu_torch.models import fields, sugar
from frosting_tpu_torch.ops import knn
from frosting_tpu_torch.scene.gaussians import params_from_numpy
from frosting_tpu_torch.train import sugar_trainer
from tests.test_torch_render import cameras, configs, make_scene

RTOL, ATOL = 1e-5, 1e-6
N, S, K = 256, 512, 8


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def scene():
    """Activated Gaussians, samples around them and their KNN sets."""
    means, scales, quats, opac, sh = make_scene(n=N, seed=11)
    rng = np.random.default_rng(12)
    gidx = rng.integers(0, N, S)
    samples = (means[gidx] + rng.normal(size=(S, 3)) * scales[gidx] * 1.5).astype(np.float32)
    nn, _ = knn.knn(torch.from_numpy(means), K)
    knn_idx = nn.numpy()[gidx]
    return dict(means=means, scales=scales, quats=quats, opac=opac, sh=sh,
                samples=samples, gidx=gidx, knn_idx=knn_idx)


BETA_MODES = ("average", "weighted_average", "learnable")
FIELD_KW = dict(density_threshold=0.5, density_factor=0.7)
LOG_BETA = np.float32(-3.0)


def _field_weights():
    return np.random.default_rng(1).normal(size=S).astype(np.float32)


@pytest.fixture(scope="module")
def jax_fields(scene):
    """JAX's field values and their gradients for every beta mode, from one
    compile: {mode: (FieldValues, grads in centers, strengths, scales,
    quats, log_beta)}."""
    x, ki = jnp.asarray(scene["samples"]), jnp.asarray(scene["knn_idx"])
    w = _field_weights()

    def one(mode, *args):
        return jax_fields_lib.field_values(x, ki, *args[:4], log_beta=args[4],
                                           beta_mode=mode, **FIELD_KW)

    def loss(mode, *args):
        fv = one(mode, *args)
        return jnp.sum(fv.sdf * w) + jnp.sum(fv.density_norm * w[::-1])

    @jax.jit
    def every_mode(*args):
        return {mode: (one(mode, *args), jax.grad(loss, argnums=(1, 2, 3, 4, 5))(mode, *args))
                for mode in BETA_MODES}

    arrays = [scene[k] for k in ("means", "opac", "scales", "quats")]
    return every_mode(*[jnp.asarray(a) for a in arrays], jnp.asarray(LOG_BETA))


@pytest.mark.parametrize("beta_mode", BETA_MODES)
def test_field_values_and_gradients_match_jax(scene, jax_fields, beta_mode):
    x, ki = scene["samples"], scene["knn_idx"]
    arrays = [scene[k] for k in ("means", "opac", "scales", "quats")]
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    lb = torch.tensor(LOG_BETA, requires_grad=True)
    got = fields.field_values(torch.from_numpy(x), torch.from_numpy(ki), *leaves,
                              log_beta=lb, beta_mode=beta_mode, **FIELD_KW)
    want, jgrads = jax_fields[beta_mode]
    for name in got._fields:
        _close(getattr(got, name), getattr(want, name), what=name)

    w = _field_weights()
    loss = torch.sum(got.sdf * torch.from_numpy(w)) + torch.sum(
        got.density_norm * torch.from_numpy(w[::-1].copy()))
    grads = torch.autograd.grad(loss, leaves + [lb], allow_unused=True)
    for name, g, jg in zip(("centers", "strengths", "scales", "quats", "log_beta"),
                           grads, jgrads):
        if g is None:
            assert not np.any(np.asarray(jg)), name
        else:
            _close(g, jg, rtol=1e-4, atol=1e-5 * float(np.abs(jg).max()), what=name)


def test_sampling_given_jax_draws_matches_jax(scene):
    """The JAX package's own draws, passed in. Indices are compared away
    from the CDF's edges: torch.cumsum and jnp.cumsum may differ in the
    last bit, and a draw within that of an edge may take the neighbour."""
    means, scales, quats = (scene[k] for k in ("means", "scales", "quats"))
    weights = (np.random.default_rng(2).uniform(size=N) > 0.3).astype(np.float32)
    key = jax.random.key(7)
    sample = jax.jit(jax_fields_lib.sample_points_in_gaussians, static_argnums=1,
                     static_argnames="scale_factor")
    want_pts, want_idx = sample(
        key, 4096, *(jnp.asarray(a) for a in (means, scales, quats, weights)),
        scale_factor=1.5)
    k1, k2 = jax.random.split(key)
    u = np.array(jax.random.uniform(k1, (4096,)))
    eps = np.array(jax.random.normal(k2, (4096, 3)))
    got_pts, got_idx = fields.sample_points_in_gaussians(
        4096, *(torch.from_numpy(a) for a in (means, scales, quats, weights)),
        scale_factor=1.5, u=torch.from_numpy(u), eps=torch.from_numpy(eps))
    cdf = np.cumsum(weights / weights.sum(), dtype=np.float64)
    far = np.min(np.abs(u[:, None] * cdf[-1] - cdf[None]), axis=1) > 1e-5
    assert far.mean() > 0.95
    np.testing.assert_array_equal(got_idx.numpy()[far], np.asarray(want_idx)[far])
    _close(got_pts[far], np.asarray(want_pts)[far])
    assert weights[got_idx.numpy()].all()


def _sdf_inputs(scene):
    inp = (scene["samples"], scene["gidx"], scene["knn_idx"])
    return (sugar.SdfLossInputs(*(torch.from_numpy(a) for a in inp)),
            jax_sugar.SdfLossInputs(*(jnp.asarray(a) for a in inp)))


def _maps(seed):
    rng = np.random.default_rng(seed)
    depth = (3.0 + 0.3 * rng.normal(size=(24, 32))).astype(np.float32)
    normal = rng.normal(size=(3, 24, 32)).astype(np.float32)
    acc = rng.uniform(0.2, 1.0, (24, 32)).astype(np.float32)
    return depth, normal, acc


LOSSES = {
    "smallest_axis": lambda m, inp, c, r, a: m.smallest_axis(a[1], a[2]).sum(-1) @ a[1][:, 0],
    "entropy": lambda m, inp, c, r, a: m.entropy_loss(a[3], a[3] > 0.3),
    "entropy_from_logits": lambda m, inp, c, r, a: m.entropy_loss_from_logits(
        (a[3] - 0.5) * 40.0, a[3] > 0.2),
    "sdf_density": lambda m, inp, c, r, a: m.sdf_estimation_density_loss(inp, *a),
    "better_normal": lambda m, inp, c, r, a: m.better_normal_loss(inp, *a),
}


def _modules(scene):
    (tin, jin) = _sdf_inputs(scene)
    tcam_pair = cameras()
    jcfg, tcfg = configs(32, 24)
    return (sugar, tin, tcam_pair[1], tcfg), (jax_sugar, jin, tcam_pair[0], jcfg)


@pytest.fixture(scope="module")
def jax_losses(scene):
    """JAX's value and gradient of every loss of LOSSES, from one compile."""
    _port, jx = _modules(scene)

    @jax.jit
    def every_loss(*a):
        return {name: jax.value_and_grad(lambda *b, f=f: f(*jx[:4], b), argnums=(0, 1, 2, 3))(*a)
                for name, f in LOSSES.items()}

    return every_loss(*[jnp.asarray(scene[k]) for k in ("means", "scales", "quats", "opac")])


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_and_gradients_match_jax(scene, jax_losses, name):
    """Each loss of models/sugar.py of the Gaussians, and its gradient in
    means, scales, quats and opacities, against jax.value_and_grad."""
    arrays = [scene[k] for k in ("means", "scales", "quats", "opac")]
    port, _jx = _modules(scene)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    value = LOSSES[name](*port[:4], leaves)
    grads = torch.autograd.grad(value, leaves, allow_unused=True)
    jvalue, jgrads = jax_losses[name]
    _close(value, jvalue, what="value")
    for g, jg, what in zip(grads, jgrads, ("means", "scales", "quats", "opac")):
        if g is None:
            assert not np.any(np.asarray(jg)), what
        else:
            _close(g, jg, rtol=1e-4, atol=1e-5 * max(float(np.abs(jg).max()), 1e-3), what=what)


MAP_LOSSES = {
    "normal_from_depth": lambda m, inp, c, r, d, n, a, arr: m.normal_from_depth(d, c, r).sum(),
    "dn_consistency": lambda m, inp, c, r, d, n, a, arr: m.dn_consistency_loss(d, n, a, c, r),
    "sample_depth": lambda m, inp, c, r, d, n, a, arr: m.sample_depth_at_points(
        d, arr[0] * 4.0 + 3.0, c, r).sum(),
    "sdf_mode": lambda m, inp, c, r, d, n, a, arr: m.sdf_estimation_sdf_mode_loss(
        inp, *arr, d, c, r, spatial_extent=2.5),
}


@pytest.fixture(scope="module")
def jax_map_losses(scene):
    """JAX's value and gradient (in the depth and normal maps and the
    means) of every loss of MAP_LOSSES, from one compile."""
    depth, normal, acc = _maps(3)
    arrays = [scene[k] for k in ("means", "scales", "quats", "opac")]
    _port, jx = _modules(scene)

    @jax.jit
    def every_loss(d, n, m):
        out = {}
        for name, f in MAP_LOSSES.items():
            def jf(d, n, m, f=f):
                return f(*jx, d, n, jnp.asarray(acc), [m] + [jnp.asarray(a) for a in arrays[1:]])
            out[name] = jax.value_and_grad(jf, argnums=(0, 1, 2))(d, n, m)
        return out

    return every_loss(jnp.asarray(depth), jnp.asarray(normal), jnp.asarray(arrays[0]))


@pytest.mark.parametrize("name", list(MAP_LOSSES))
def test_depth_map_losses_and_gradients_match_jax(scene, jax_map_losses, name):
    """The losses of depth and normal maps, and their gradients in the maps
    (and the Gaussians' means where they enter), against jax.grad."""
    depth, normal, acc = _maps(3)
    arrays = [scene[k] for k in ("means", "scales", "quats", "opac")]
    port, _jx = _modules(scene)
    t_maps = [torch.from_numpy(a).requires_grad_(True) for a in (depth, normal)]
    t_arr = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    value = MAP_LOSSES[name](*port, *t_maps, torch.from_numpy(acc), t_arr)
    grads = torch.autograd.grad(value, t_maps + t_arr[:1], allow_unused=True)
    jvalue, jgrads = jax_map_losses[name]
    _close(value, jvalue, rtol=1e-5, what="value")
    for g, jg, what in zip(grads, jgrads, ("depth", "normal", "means")):
        if g is None:
            assert not np.any(np.asarray(jg)), what
        else:
            _close(g, jg, rtol=1e-4, atol=1e-5 * max(float(np.abs(jg).max()), 1e-3), what=what)


def _raw(scene, capacity):
    means, scales, quats, opac, sh = (scene[k] for k in ("means", "scales", "quats", "opac", "sh"))
    n = len(means)

    def park(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    mask = np.zeros(capacity, np.float32)
    mask[:n] = 1.0
    quats_p = park(quats)
    quats_p[n:, 0] = 1.0
    return {
        "means3d": park(means, 1e6), "sh_dc": park(sh[:, :1]), "sh_rest": park(sh[:, 1:]),
        "scales_log": park(np.log(scales), -10.0), "quats_raw": quats_p,
        "opacities_raw": park(np.log(opac / (1 - opac)), -15.0), "mask": mask,
    }


def test_hard_prune_matches_jax(scene):
    raw = _raw(scene, 320)
    got = sugar_trainer.hard_prune(params_from_numpy(raw, device="cpu"), 0.5)
    want = jax_trainer.hard_prune(JaxParams(**{k: jnp.asarray(v) for k, v in raw.items()}), 0.5)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)))
    kept = int(got.mask.sum())
    assert 0 < kept < N and kept == int((scene["opac"] >= 0.5).sum())


def test_phase_schedule():
    """The JAX loop's phases: "entropy" for entropy_from < it <
    entropy_until, "sdf" for it > sdf_from, "photo" otherwise."""
    cfg = sugar_trainer.SugarTrainConfig()
    assert [sugar_trainer.phase_of(it, cfg) for it in (7000, 7001, 8999, 9000, 9001)] == [
        "photo", "entropy", "entropy", "photo", "sdf"]
    cfg = sugar_trainer.SugarTrainConfig(entropy_from=10, entropy_until=20, sdf_from=15)
    assert [sugar_trainer.phase_of(it, cfg) for it in (10, 11, 16, 19, 20, 21)] == [
        "photo", "entropy", "entropy", "entropy", "sdf", "sdf"]
