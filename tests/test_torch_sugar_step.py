"""One whole SuGaR step of the port (frosting_tpu_torch.train.
sugar_trainer.train_step) against the JAX package's sugar_train_step on
the CPU, from the same parameters, KNN sets and draws (the scene and the
helpers of tests/test_torch_sugar.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from frosting_tpu.scene.gaussians import GaussianParams as JaxParams
from frosting_tpu.train import optimizer as jax_opt
from frosting_tpu.train import sugar_trainer as jax_trainer
from frosting_tpu_torch.scene.gaussians import params_from_numpy
from frosting_tpu_torch.train import optimizer as port_opt
from frosting_tpu_torch.train import sugar_trainer
from tests.test_torch_render import cameras, configs
from tests.test_torch_sugar import K, S, _raw, scene  # noqa: F401 (fixture)


def test_one_sugar_step_matches_jax(scene):
    """A dn_consistency step in the sdf phase (colour render, depth and
    normal renders, sampling, density and better-normal losses, Adam) from
    the same parameters, KNN sets and draws: the same loss, and the same
    updated parameters under the tolerance of tests/test_torch_gs_trainer.py
    (a first Adam step is lr * sign(g), so an element whose gradient is
    round-off may move +-lr apart: all but 1% of each field agree to 1e-5 +
    1e-4 relative, none by more than two learning rates)."""
    raw = _raw(scene, 320)
    jcam, tcam = cameras(eye=[0.3, -0.4, -2.6])
    jcfg, tcfg = configs(64, 48, max_instances=1 << 14)
    jcfg = dataclasses.replace(jcfg, bwd_sort_bf16=False)
    gt = np.random.default_rng(5).uniform(size=(3, 48, 64)).astype(np.float32)
    kw = dict(method="dn_consistency", n_sdf_samples=S, spatial_extent=2.5)
    extent = 2.5
    params = params_from_numpy(raw, device="cpu")
    knn_idx = sugar_trainer.compute_knn(params, K)
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    draws = (torch.from_numpy(np.array(jax.random.uniform(k1, (S,)))),
             torch.from_numpy(np.array(jax.random.normal(k2, (S, 3)))))

    jparams = JaxParams(**{k: jnp.asarray(v) for k, v in raw.items()})
    tx = jax_opt.make_gs_optimizer(extent)
    jparams, _, aux = jax_trainer.sugar_train_step(
        jparams, tx.init(jparams), jcam, jnp.asarray(gt), jnp.asarray(knn_idx.numpy(), jnp.int32),
        key, tx, jcfg, jax_trainer.SugarTrainConfig(**kw), 3, "sdf")

    opt = port_opt.make_gs_optimizer(extent)
    state = opt.init(params)
    m = sugar_trainer.train_step(
        params, state, tcam, torch.from_numpy(gt), knn_idx, opt, tcfg,
        sugar_trainer.SugarTrainConfig(**kw), 3, "sdf", draws=draws)
    np.testing.assert_allclose(float(m["loss"]), float(aux["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["psnr"]), float(aux["psnr"]), rtol=1e-5)
    lrs = {"means3d": 1.6e-4 * extent, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20,
           "opacities_raw": 0.05, "scales_log": 5e-3, "quats_raw": 1e-3}
    for g in port_opt.GROUPS:
        got, want = getattr(params, g).numpy(), np.asarray(getattr(jparams, g))
        err = np.abs(got - want)
        off = err > 1e-5 + 1e-4 * np.abs(want)
        assert off.mean() <= 0.01, (g, off.sum())
        assert err.max() <= 2 * lrs[g] + 1e-6, (g, err.max())
    assert np.array_equal(params.mask.numpy(), np.asarray(jparams.mask))
