"""One gloo rank of tests/test_torch_sharded.py, on the CPU.

    python tests/torch_sharded_worker.py RANK WORLD PORT DIR

Every rank builds the 2 x 2 and the 1 x 4 mesh of four ranks, waits for
DIR/inputs.npz (the test writes it: numpy arrays only, so that this process
imports neither JAX nor the test module), runs every scenario on it and
writes its results to DIR/rank<RANK>.npz. The sdf phase's draws (JAX's
per-device draws) come in DIR/draws.npz, which the test writes later.
"""

import dataclasses
import json
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
from frosting_tpu_torch.parallel import pipeline  # noqa: E402
from frosting_tpu_torch.parallel import sharded_train as st  # noqa: E402
from frosting_tpu_torch.raster import RasterConfig  # noqa: E402
from frosting_tpu_torch.scene import gaussians as gauss_lib  # noqa: E402
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer  # noqa: E402
from frosting_tpu_torch.train import optimizer as opt_lib  # noqa: E402

EXTENT = 3.3
RASTER = dict(width=64, height=64, tile_w=32, tile_h=16, chunk=32, max_instances=4096)
SDF_SAMPLES = 4096
# the pipeline's stages (frosting_tpu_torch.parallel.pipeline) at this size:
# 3 iterations a trained stage, stage 2's entropy phase for the first of
# them and its KNN recomputed at iterations 0 and 2; the shell at Poisson
# 32^3 with a 400-vertex target; 1024 Frosting Gaussians
PIPE_CAMS, PIPE_ITERS, PIPE_KNN_EVERY, PIPE_ENTROPY_FRACTION = 4, 3, 2, 0.4
# stage 2 runs from two inputs: the init with the scene's anisotropic
# scales (p2) and the isotropic init with its three equal log-scales set
# PIPE_TIE_BREAK apart (p2i). Both packages agree there at 1e-2; at 1e-4,
# 1e-6 or 0 the first sdf step's loss already differs (ROADMAP section C)
PIPE_STAGE2_RUNS = ("p2", "p2i")
PIPE_TIE_BREAK = 1e-2
PIPE_ARGS = ["--device", "cpu", "--mesh", "2x2", "--width", "64", "--height", "64",
             "--max-instances", "4096", "--scene-gaussians", "300", "--capacity", "512",
             "--gs-iters", "3", "--sugar-iters", "3", "--refine-iters", "3",
             "--poisson-resolution", "32", "--target-vertices", "400",
             "--frosting-gaussians", "1024"]


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

    pipeline_scenarios(inp, tmp, mesh, rcfg, out)

    out["flat_index"] = np.int64(mesh.flat_index)
    out["row_index"] = np.int64(row.tile_index)
    np.savez(os.path.join(tmp, f"rank{rank}.tmp.npz"), **out)
    os.replace(os.path.join(tmp, f"rank{rank}.tmp.npz"), os.path.join(tmp, f"rank{rank}.npz"))
    dist.destroy_process_group()


def stage2(inp, tmp, mesh, rcfg, cams, gts, draws, run, out):
    """Stage 2 from the parameters ``run``_params_; returns its result."""
    params = gauss_lib.params_from_numpy(sub(inp, f"{run}_params_"), device="cpu")
    knn = {}

    def knn_fn(p, it):
        # the KNN of each refresh, handed to the JAX reference (whose own
        # search is approximate): rank 0 writes it as soon as it is made
        knn[it] = sugar_trainer.compute_knn(p, 8)
        if dist.get_rank() == 0:
            np.savez(os.path.join(tmp, f"{run}_knn.tmp.npz"),
                     **{f"it{i}": v.numpy().astype(np.int32) for i, v in knn.items()})
            os.replace(os.path.join(tmp, f"{run}_knn.tmp.npz"),
                       os.path.join(tmp, f"{run}_knn{it}.npz"))
        return knn[it]

    params, losses, phases, _ = pipeline.run_stage2(
        mesh, params, cams, gts, rcfg, inp["pipe_b2"], EXTENT, SDF_SAMPLES, 8,
        PIPE_ENTROPY_FRACTION, PIPE_KNN_EVERY, draws=draws, knn_fn=knn_fn)
    out[f"{run}_loss"] = np.asarray(losses, np.float32)
    out[f"{run}_phases"] = np.asarray(phases)
    for f in dataclasses.fields(params):
        out[f"{run}_{f.name}"] = getattr(params, f.name).numpy()
    return params


def pipeline_scenarios(inp, tmp, mesh, rcfg, out):
    """The pipeline's stages on 2 x 2: stages 1, 2 and 5 each from an input
    the test hands JAX too (stage 2's sdf draws JAX's own; stage 2 from
    each of PIPE_STAGE2_RUNS), stages 3 and 4 on stage 2's result from p2,
    then the whole run as the entry point makes it."""
    cams = [camera_from_numpy(sub(inp, f"pcam{j}_"), device="cpu") for j in range(PIPE_CAMS)]
    gts = inp["pipe_gt"]
    state = fresh_state(sub(inp, "p1_"))
    state, losses, _ = pipeline.run_stage1(mesh, None, None, cams, gts, rcfg, inp["pipe_b1"],
                                           extent=EXTENT, state=state)
    out["p1_loss"] = np.asarray(losses, np.float32)
    for g in opt_lib.GROUPS:
        out[f"p1_{g}"] = getattr(state.params, g).numpy()

    dz = wait_for(os.path.join(tmp, "draws.npz"))
    i = mesh.data_index * 2 + mesh.tile_index
    draws = {it: (torch.from_numpy(dz[f"pipe_u{it}_{i}"]),
                  torch.from_numpy(dz[f"pipe_eps{it}_{i}"]))
             for it in range(PIPE_ITERS) if f"pipe_u{it}_{i}" in dz}
    params = {run: stage2(inp, tmp, mesh, rcfg, cams, gts, draws, run, out)
              for run in PIPE_STAGE2_RUNS}["p2"]

    shell_cfg = pipeline.ShellConfig(poisson_resolution=32, target_vertices=400, knn_k=8)
    live, model, verts, faces, _ = pipeline.run_stage3(mesh, params, cams, rcfg, shell_cfg)
    for name, x in zip(("means", "scales", "quats", "opac"), model):
        out[f"p3_{name}"] = x.numpy()
    out["p3_verts"], out["p3_faces"] = verts.numpy(), faces.numpy()
    fparams, meta, _ = pipeline.run_stage4(mesh, verts, faces, model, live, 1024, 8, EXTENT)
    for g, v in frosting_trainer.param_groups(fparams).items():
        out[f"p4_{g}"] = v.numpy()
    for k in ("faces", "cell_idx", "cell_bounds"):
        out[f"p4_meta_{k}"] = getattr(meta, k).numpy()

    fparams = frosting_lib.params_from_numpy(sub(inp, "f_"), device="cpu")
    meta = frosting_lib.make_meta(inp["meta_faces"], inp["meta_cell_idx"],
                                  inp["meta_cell_bounds"],
                                  n_verts=fparams.shell_verts.shape[0], device="cpu")
    share, losses, rep = pipeline.run_stage5(mesh, fparams, meta, cams, gts, rcfg,
                                             inp["pipe_b5"], EXTENT)
    out["p5_loss"] = np.asarray(losses, np.float32)
    out["p5_rows"] = np.asarray([rep["rows"][k] for k in ("params", "adam_mu", "adam_nu")])
    for g, v in frosting_trainer.param_groups(share).items():
        out[f"p5_{g}"] = v.numpy()
    eval_cams = [camera_from_numpy(sub(inp, f"pcam{j}_"), device="cpu") for j in (0, 1)]
    whole, psnrs, _ = pipeline.run_eval(mesh, share, meta, eval_cams, gts[:2], rcfg)
    out["p5_psnr"] = np.asarray(psnrs if psnrs is not None else [], np.float64)

    args = pipeline.parse_args(PIPE_ARGS)
    result, reports, failed = pipeline.run_checked(args, mesh)
    out["pmc_result"] = np.asarray(json.dumps(result))
    out["pmc_reports"] = np.asarray(json.dumps(reports))
    out["pmc_failed"] = np.asarray(json.dumps(failed))


if __name__ == "__main__":
    main()
