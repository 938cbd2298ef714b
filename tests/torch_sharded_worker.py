"""One gloo rank of tests/test_torch_sharded.py, on the CPU.

    python tests/torch_sharded_worker.py RANK WORLD PORT DIR

Every rank builds the 2 x 2 and the 1 x 4 mesh of four ranks, waits for
DIR/inputs.npz (the test writes it: numpy arrays only, so that this process
imports neither JAX nor the test module), runs every scenario on it and
writes its results to DIR/rank<RANK>.npz. The sdf phase's draws (JAX's
per-device draws) come in DIR/draws.npz, which the test writes later.
"""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch.distributed as dist  # noqa: E402

from frosting_tpu_torch.cameras import camera_from_numpy  # noqa: E402
from frosting_tpu_torch.models import frosting as frosting_lib  # noqa: E402
from frosting_tpu_torch.ops.ssim import ssim_strips  # noqa: E402
from frosting_tpu_torch.parallel import collectives  # noqa: E402
from frosting_tpu_torch.parallel import sharded_frosting as sf  # noqa: E402
from frosting_tpu_torch.parallel import sharded_sugar as ssg  # noqa: E402
from frosting_tpu_torch.parallel import sharded_train as st  # noqa: E402
from frosting_tpu_torch.raster import RasterConfig  # noqa: E402
from frosting_tpu_torch.scene import gaussians as gauss_lib  # noqa: E402
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer  # noqa: E402
from frosting_tpu_torch.train import optimizer as opt_lib  # noqa: E402

EXTENT = 3.3
RASTER = dict(width=64, height=64, tile_w=32, tile_h=16, chunk=32, max_instances=4096)
SDF_SAMPLES = 4096


def wait_for(path, timeout=120.0):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.02)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def sub(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def state_arrays(state, prefix, out):
    for g in opt_lib.GROUPS + ("mask",):
        out[f"{prefix}params_{g}"] = getattr(state.params, g).numpy().copy()
    for g in opt_lib.GROUPS:
        out[f"{prefix}mu_{g}"] = state.opt_state.mu[g].numpy().copy()
        out[f"{prefix}nu_{g}"] = state.opt_state.nu[g].numpy().copy()
    out[f"{prefix}grad_accum"] = state.dstate.grad_accum.numpy().copy()
    out[f"{prefix}denom"] = state.dstate.denom.numpy().copy()
    out[f"{prefix}max_radii"] = state.max_radii.numpy().copy()


def fresh_state(inp):
    zeros = {g: np.zeros_like(inp[f"params_{g}"]) for g in opt_lib.GROUPS}
    cap = inp["params_means3d"].shape[0]
    return gs_trainer.state_from_numpy(
        sub(inp, "params_"), zeros, zeros, {g: 0 for g in opt_lib.GROUPS},
        {"grad_accum": np.zeros(cap), "denom": np.zeros(cap)}, np.zeros(cap), device="cpu")


def main():
    rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    collectives.init_process_group("gloo", rank, world, f"tcp://127.0.0.1:{port}",
                                   timeout_s=120.0, device="cpu")
    mesh = st.make_mesh(2, 2, device="cpu")
    row = st.make_mesh(1, 4, device="cpu")
    inp = wait_for(os.path.join(tmp, "inputs.npz"))
    out = {}
    rcfg = RasterConfig(**RASTER)
    cams = [camera_from_numpy(sub(inp, f"cam{i}_"), device="cpu") for i in range(2)]
    gts = inp["gt"]

    # strip SSIM on 1 x 4
    a = torch.from_numpy(inp["ssim_a"])
    b = torch.from_numpy(inp["ssim_b"])
    h = a.shape[1] // 4
    t = row.tile_index
    out["ssim_strip"] = np.float32(ssim_strips(a[:, t * h:(t + 1) * h],
                                               b[:, t * h:(t + 1) * h], row))

    # 3DGS: replicated 2 x 2, twice
    cfg = gs_trainer.GSTrainConfig(capacity=inp["params_means3d"].shape[0])
    opt = opt_lib.make_gs_optimizer(EXTENT)
    camera, gt_strip = st.shard_batch(mesh, st.stack_cameras(cams), gts)
    step = st.make_sharded_train_step(opt, rcfg, cfg, mesh)
    for i in range(2):
        state = fresh_state(inp)
        _, m = step(state, camera, gt_strip)
        out[f"gs_loss_{i}"] = np.float32(m["loss"])
        out[f"gs_overflow_{i}"] = np.float32(m["overflow"])
        state_arrays(state, f"gs{i}_", out)

    # shard_params, then three steps at a low threshold and a sharded densify
    step_sh = st.make_sharded_train_step(opt, rcfg, cfg, mesh, shard_params=True)
    sharded = st.shard_train_state(mesh, fresh_state(inp))
    _, m = step_sh(sharded, camera, gt_strip)
    out["shard_loss"] = np.float32(m["loss"])
    state_arrays(sharded, "shard_", out)
    cfg_lo = dataclasses.replace(cfg, densify_grad_threshold=1e-6)
    step_lo = st.make_sharded_train_step(opt, rcfg, cfg_lo, mesh, shard_params=True)
    for _ in range(3):
        step_lo(sharded, camera, gt_strip)
    state_arrays(sharded, "pre_", out)
    gen = torch.Generator().manual_seed(st.shard_seed(7, mesh))
    draws = (torch.randn((sharded.params.capacity, 3), generator=gen),
             torch.randn((sharded.params.capacity, 3), generator=gen))
    out["densify_eps1"], out["densify_eps2"] = draws[0].numpy(), draws[1].numpy()
    dstep = st.make_sharded_densify_step(mesh, EXTENT, cfg_lo)
    _, info = dstep(sharded, 7)
    out["densify_info"] = np.asarray([int(v) for v in info], np.int64)
    state_arrays(sharded, "post_", out)
    _, m = step_lo(sharded, camera, gt_strip)
    out["post_densify_loss"] = np.float32(m["loss"])

    # the exchange against the all-gather, on 1 x 4 (camera 0)
    cam0, gt0 = st.shard_batch(row, [cams[0]], gts[:1])
    for name, kw in (("gather", {}), ("exchange", {"primitive_exchange": True,
                                                   "exchange_cap": 512})):
        s = fresh_state(inp)
        _, m = st.make_sharded_train_step(opt, rcfg, cfg, row, **kw)(s, cam0, gt0)
        out[f"x_{name}_loss"] = np.float32(m["loss"])
        out[f"x_{name}_means"] = s.params.means3d.numpy().copy()
        if name == "exchange":
            out["x_overflow"] = np.float32(m["exchange_overflow"])

    # the sdf mode's depth strips on 1 x 4
    model = tuple(torch.from_numpy(inp[f"scene_{k}"]) for k in
                  ("means", "scales", "quats", "opac", "sh"))
    out["depth"] = ssg.render_depth_strips(model, cam0, rcfg, row).numpy()

    # Frosting with background Gaussians, replicated and shard_params
    fparams0 = frosting_lib.params_from_numpy(dict(sub(inp, "f_"), bg=sub(inp, "fbg_")),
                                              device="cpu")
    meta = frosting_lib.make_meta(inp["meta_faces"], inp["meta_cell_idx"],
                                  inp["meta_cell_bounds"],
                                  n_verts=fparams0.shell_verts.shape[0], device="cpu")
    tcfg = frosting_trainer.FrostingTrainConfig(iterations=1, lr_max_steps=10)
    fopt = frosting_trainer.make_frosting_optimizer(tcfg, 3.5, background=True)
    for name, shard in (("replicated", False), ("shard", True)):
        p = frosting_lib.params_from_numpy(dict(sub(inp, "f_"), bg=sub(inp, "fbg_")),
                                           device="cpu")
        if shard:
            p = sf.shard_frosting_params(mesh, p)
        ostate = fopt.init(frosting_trainer.param_groups(p))
        fstep = sf.make_sharded_frosting_step(fopt, rcfg, tcfg, mesh, meta, shard_params=shard)
        m = fstep(p, ostate, camera, gt_strip)
        out[f"f_{name}_loss"] = np.float32(m["loss"])
        for g, v in frosting_trainer.param_groups(p).items():
            out[f"f_{name}_{g}"] = v.numpy().copy()
        if shard:
            out["f_shard_mu_rows"] = np.int64(ostate.mu["bary_logits"].shape[0])
    del fparams0

    # coarse SuGaR on 2 x 2: photo, entropy, then sdf with JAX's draws
    scfg = sugar_trainer.SugarTrainConfig(method="density", n_sdf_samples=SDF_SAMPLES, knn_k=8,
                                          spatial_extent=EXTENT)
    knn_idx = torch.from_numpy(inp["knn_idx"]).long()
    sopt = opt_lib.make_gs_optimizer(EXTENT)
    for phase in ssg.PHASES:
        draws = None
        if phase == "sdf":
            dz = wait_for(os.path.join(tmp, "draws.npz"))
            i = mesh.data_index * 2 + mesh.tile_index
            draws = (torch.from_numpy(dz[f"u{i}"]), torch.from_numpy(dz[f"eps{i}"]))
        params = gauss_lib.params_from_numpy(sub(inp, "params_"), device="cpu")
        ostate = sopt.init(params)
        m = ssg.make_sharded_sugar_step(sopt, rcfg, scfg, mesh, phase)(
            params, ostate, camera, gt_strip, knn_idx, draws=draws)
        out[f"sugar_{phase}_loss"] = np.float32(m["loss"])
        for g in opt_lib.GROUPS:
            out[f"sugar_{phase}_{g}"] = getattr(params, g).numpy().copy()

    out["flat_index"] = np.int64(mesh.flat_index)
    out["row_index"] = np.int64(row.tile_index)
    np.savez(os.path.join(tmp, f"rank{rank}.tmp.npz"), **out)
    os.replace(os.path.join(tmp, f"rank{rank}.tmp.npz"), os.path.join(tmp, f"rank{rank}.npz"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
