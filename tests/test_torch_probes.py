"""The plain versions of the probes P1-P4 (frosting_tpu_torch/bench/
perf_vpu_dtype.py and perf_scan_variants.py) against the same functions in
JAX on the CPU, where the wrappers run those plain versions.

- P1 / P2: the TPU script's chains (scripts/perf_vpu_dtype.py) written in
  jnp, jitted, with lax.fori_loop over the steps, at [64, 512] in float32
  and bf16. The FMA chain rounds once per step on both sides (0.25 y is
  exact): rtol 1e-6 in float32, 1 ulp in bf16; the exp chain uses two exp
  implementations: rtol 1e-5 in float32, 1e-2 in bf16.
- P3 / P4: the plain scan and product against
  frosting_tpu/raster/chunk_math.py's cumprod_incl and tree_prod, on the
  TPU script's inputs and on an input in [0.9995, 1.0) whose products do not
  underflow: rtol 2e-5, values under 1e-30 held by atol 1e-30 alone. Both
  multiply in the same order, so they agree bitwise.

The kernels themselves are held against these plain versions on the card
in tests/test_torch_cuda.py (marked gpu), which imports no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.raster.chunk_math import cumprod_incl, tree_prod
from frosting_tpu_torch.bench import perf_scan_variants as ps
from frosting_tpu_torch.bench import perf_vpu_dtype as pv

SHAPE = (64, 512)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _jax_chain(kind, dtype):
    if kind == "chain_fma":
        def step(_, y, x):
            return y * jnp.asarray(0.25, dtype) + x
        reps = pv.FMA_REPS
    else:
        def step(_, y, x):
            return jnp.exp(y * jnp.asarray(0.25, dtype))
        reps = pv.EXP_REPS
    return jax.jit(lambda x: jax.lax.fori_loop(0, reps, lambda i, y: step(i, y, x), x))


def _bf16_ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["chain_fma", "chain_exp"])
def test_plain_chains_match_jax(kind, dtype):
    x = pv.probe_input(pv.DTYPES[dtype], "cpu", shape=SHAPE)
    got = getattr(pv, kind)(x).float().numpy()
    xj = jnp.asarray(x.float().numpy()).astype(JNP[dtype])
    ref = np.asarray(_jax_chain(kind, JNP[dtype])(xj).astype(jnp.float32))
    if kind == "chain_fma":
        tol = 1e-6 * np.abs(ref) if dtype == "f32" else _bf16_ulp(ref)
    else:
        tol = (1e-5 if dtype == "f32" else 1e-2) * np.abs(ref)
    assert np.all(np.abs(got - ref) <= tol)
    if kind == "chain_exp":
        # the chain converges to the fixed point of y = exp(y / 4)
        np.testing.assert_allclose(got, 1.4296118, rtol=1e-2)


def test_chain_wrappers_take_the_plain_versions_on_the_cpu():
    x = pv.probe_input(torch.float32, "cpu", shape=(4, 6))
    before = (pv.chain_fma.launches, pv.chain_exp.launches)
    assert torch.equal(pv.chain_fma(x), pv.chain_fma_torch(x))
    assert torch.equal(pv.chain_exp(x), pv.chain_exp_torch(x))
    assert (pv.chain_fma.launches, pv.chain_exp.launches) == before


def test_operation_counts():
    """What one call at the TPU script's shape needs: the FMA chain 4.19e8
    operations (an FMA is 2), the exp chain 2.10e7 exps, not the TPU
    script's 4.19e8 (it counted 400 steps of 2 for both chains)."""
    n = pv.SHAPE[0] * pv.SHAPE[1]
    assert pv.fma_flops(n) == 419_430_400
    assert pv.exp_count(n) == 20_971_520
    # Hillis-Steele over 128: sum over s of (128 - s) products
    assert ps.SCAN_PRODUCTS == 769
    assert ps.once_flops(ps.P) == ps.P * (769 + 127)
    assert ps.reps_flops(ps.P) == ps.P * ps.REPS * (769 + 127 + 256 + 1)


def _close(actual, desired):
    np.testing.assert_allclose(actual, desired, rtol=2e-5, atol=1e-30)
    np.testing.assert_array_equal(actual, desired)


@pytest.mark.parametrize("seed,lo", [(0, 0.9), (1, 0.9), (1, ps.NONZERO_LO)],
                         ids=["tpu-timing", "tpu-check", "nonzero"])
def test_plain_scan_and_product_match_chunk_math(seed, lo):
    x = ps.probe_input(seed, lo=lo, device="cpu")
    incl, prod = ps.scan_once(x)
    ref_incl = np.asarray(jax.jit(cumprod_incl)(jnp.asarray(x.numpy())))
    ref_prod = np.asarray(jax.jit(tree_prod)(jnp.asarray(ref_incl)))
    _close(incl.numpy(), ref_incl)
    _close(prod.numpy(), ref_prod)
    assert prod.shape == (ps.P, 1)


def _jax_scan_reps(x):
    def body(_, carry):
        acc, y = carry
        acc = acc + tree_prod(cumprod_incl(y))
        return acc, y * jnp.float32(0.999) + jnp.float32(1e-4)

    acc0 = jnp.zeros((x.shape[0], 1), jnp.float32)
    return jax.jit(lambda x: jax.lax.fori_loop(0, ps.REPS, body, (acc0, x))[0])(x)


@pytest.mark.parametrize("lo", [0.9, ps.NONZERO_LO], ids=["tpu-input", "nonzero"])
def test_plain_scan_rounds_match_chunk_math(lo):
    x = ps.probe_input(0, lo=lo, device="cpu")
    got = ps.scan_reps(x).numpy()
    ref = np.asarray(_jax_scan_reps(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-30)


def test_the_tpu_input_underflows_and_the_nonzero_input_does_not():
    """tree_prod(cumprod(x)) of 128 values in [0.9, 1.0) is about
    0.95^8256: 0 in float32, so the TPU script's cross-check compared zeros.
    In [0.9995, 1.0) the products stay near 0.1."""
    for seed in (0, 1):
        assert not ps.scan_once(ps.probe_input(seed, device="cpu"))[1].any()
        assert not ps.scan_reps(ps.probe_input(seed, device="cpu")).any()
        prod = ps.scan_once(ps.probe_input(seed, lo=ps.NONZERO_LO, device="cpu"))[1]
        assert float(prod.min()) > 1e-2
        assert float(ps.scan_reps(ps.probe_input(seed, lo=ps.NONZERO_LO, device="cpu")).min()) > 1e-2


def test_plain_scan_against_torch_cumprod():
    """The order of the products moves the result: torch.cumprod and
    torch.prod (the library call chip_smoke.py times beside the kernels)
    agree with the Hillis-Steele / halving-tree order to rtol 1e-4 on the
    product of 128 scanned values (each rounding of the scan enters it with
    a weight of up to 128; 3.1e-5 on this input) and 2e-5 on the scan."""
    x = ps.probe_input(1, lo=ps.NONZERO_LO, device="cpu")
    incl, prod = ps.scan_once(x)
    lib_incl = torch.cumprod(x, 1)
    np.testing.assert_allclose(incl.numpy(), lib_incl.numpy(), rtol=2e-5)
    np.testing.assert_allclose(
        prod.numpy(), torch.prod(lib_incl, 1, keepdim=True).numpy(), rtol=1e-4)


def test_scan_wrappers_take_every_variant_on_the_cpu():
    x = ps.probe_input(3, lo=ps.NONZERO_LO, device="cpu")[:8]
    before = (ps.scan_reps.launches, ps.scan_once.launches)
    for v in ps.VARIANTS:
        assert torch.equal(ps.scan_reps(x, v), ps.scan_reps_torch(x))
        assert all(torch.equal(a, b) for a, b in zip(ps.scan_once(x, v), ps.scan_once_torch(x)))
    assert (ps.scan_reps.launches, ps.scan_once.launches) == before
    with pytest.raises(ValueError):
        ps.scan_reps(x, "scan_shift+prod_tree")
