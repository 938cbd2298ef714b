"""The port's binning against JAX bin_gaussians: for every tile the same
ordered Gaussian list, and the same num_instances and overflow.

The JAX run of a tile is padded_gauss[tile_block0 * K : (tile_block0 +
tile_nchunks) * K] with the sentinel id N dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from frosting_tpu.raster.binning import bin_gaussians as jax_bin
from frosting_tpu.raster.preprocess import preprocess as jax_preprocess
from frosting_tpu_torch.raster.binning import bin_gaussians
from tests.test_torch_render import cameras, configs, make_scene


def _jax_binned(rect, depths, valid, jcfg):
    fn = jax.jit(lambda r, d, v: jax_bin(r, d, v, jcfg))
    out = fn(jnp.asarray(rect), jnp.asarray(depths), jnp.asarray(valid))
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_runs(b, n, jcfg):
    k = jcfg.chunk
    runs = []
    for t in range(jcfg.n_tiles):
        s = b.padded_gauss[b.tile_block0[t] * k: (b.tile_block0[t] + b.tile_nchunks[t]) * k]
        runs.append(s[s != n].tolist())
    return runs


def _port_runs(b):
    g = b.inst_gauss.numpy()
    return [g[s:e].tolist() for s, e in b.tile_ranges.numpy()]


def make_rects(n, tiles_x, tiles_y, seed, p_invalid=0.2):
    rng = np.random.default_rng(seed)
    tx0 = rng.integers(0, tiles_x, n)
    ty0 = rng.integers(0, tiles_y, n)
    tx1 = np.minimum(tx0 + rng.integers(0, 4, n), tiles_x)  # some empty
    ty1 = np.minimum(ty0 + rng.integers(1, 4, n), tiles_y)
    rect = np.stack([tx0, ty0, tx1, ty1], 1).astype(np.int32)
    valid = (rng.uniform(size=n) > p_invalid) & (tx1 > tx0)
    # a coarse depth grid makes many ties, which must keep index order
    depths = np.round(rng.uniform(0.5, 10.0, n), 1).astype(np.float32)
    return rect, depths, valid


def _port(rect, depths, valid, tcfg):
    return bin_gaussians(
        torch.from_numpy(rect), torch.from_numpy(depths),
        torch.from_numpy(valid), tcfg,
    )


def test_tile_runs_match_jax():
    jcfg, tcfg = configs(128, 64, max_instances=4096)
    for seed, n in ((3, 300), (4, 1)):
        rect, depths, valid = make_rects(n, tcfg.tiles_x, tcfg.tiles_y, seed)
        ref = _jax_binned(rect, depths, valid, jcfg)
        out = _port(rect, depths, valid, tcfg)
        assert int(out.num_instances) == int(ref.num_instances)
        assert bool(out.overflow) == bool(ref.overflow) is False
        assert out.inst_gauss.dtype == torch.int32
        assert out.tile_ranges.shape == (tcfg.n_tiles, 2)
        assert _port_runs(out) == _jax_runs(ref, n, jcfg)


def test_projected_scene_runs_match_jax():
    """Rects and depths from a real projection (JAX preprocess), in front of
    and all behind the camera."""
    jcam, _ = cameras()
    jcfg, tcfg = configs(96, 80)
    arrays = make_scene(n=300, seed=21)
    behind = (arrays[0] * np.float32([1, 1, 0]) - np.float32([0, 0, 5]),) + arrays[1:]
    for scene in (arrays, behind):
        proj = jax.jit(lambda g: jax_preprocess(*g, jcam, jcfg))(scene)
        rect, depths, valid = (np.array(a) for a in (proj.rect, proj.depths, proj.valid))
        ref = _jax_binned(rect, depths, valid, jcfg)
        out = _port(rect, depths, valid, tcfg)
        assert int(out.num_instances) == int(ref.num_instances)
        assert not bool(out.overflow) and not bool(ref.overflow)
        assert _port_runs(out) == _jax_runs(ref, 300, jcfg)
    assert int(out.num_instances) == 0  # all behind the camera


def test_overflow_truncates_the_farthest():
    jcfg, tcfg = configs(128, 64, max_instances=64)
    rect, depths, valid = make_rects(300, tcfg.tiles_x, tcfg.tiles_y, seed=5)
    ref = _jax_binned(rect, depths, valid, jcfg)
    out = _port(rect, depths, valid, tcfg)
    assert bool(out.overflow) and bool(ref.overflow)
    assert int(out.num_instances) == int(ref.num_instances) > 64
    # the kept instances are the first 64 of the depth-major expansion
    order = np.argsort(np.where(valid, depths, np.inf), kind="stable")
    stream = []
    for g in order:
        if valid[g]:
            x0, y0, x1, y1 = rect[g]
            stream += [(ty * tcfg.tiles_x + tx, g)
                       for ty in range(y0, y1) for tx in range(x0, x1)]
    kept = stream[:64]
    want = [[g for t, g in kept if t == tile] for tile in range(tcfg.n_tiles)]
    assert _port_runs(out) == want


def test_empty_and_all_invalid():
    jcfg, tcfg = configs(96, 80)
    none = (np.zeros((0, 4), np.int32), np.zeros(0, np.float32), np.zeros(0, bool))
    ref = _jax_binned(*none, jcfg)
    empty = _port(*none, tcfg)
    assert int(empty.num_instances) == int(ref.num_instances) == 0
    assert not bool(empty.overflow) and not bool(ref.overflow)
    assert empty.inst_gauss.numel() == 0
    assert (empty.tile_ranges == 0).all()
    assert _port_runs(empty) == _jax_runs(ref, 0, jcfg)

    rect, depths, _ = make_rects(40, tcfg.tiles_x, tcfg.tiles_y, seed=6)
    invalid = np.zeros(40, bool)  # everything culled, e.g. behind the camera
    ref = _jax_binned(rect, depths, invalid, jcfg)
    out = _port(rect, depths, invalid, tcfg)
    assert int(out.num_instances) == int(ref.num_instances) == 0
    assert not bool(out.overflow) and not bool(ref.overflow)
    assert _port_runs(out) == _jax_runs(ref, 40, jcfg)
