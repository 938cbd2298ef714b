"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. device: require CUDA, print `nvidia-smi` name and power limit;
  2. build: compile the blend kernels (B1, B2) and the probes (P1-P4) from
     csrc/ with nvcc, one process per source, all at once;
  3. kernels vs plain: hold the CUDA forward blend (B1) and backward blend
     (B2) against their plain PyTorch versions on the same inputs (bench.py's
     512x512 @ 100k scene, an odd 1000x600 @ 20k size with partial edge
     tiles, an adversarial scene of footprints past the tile, degenerate
     conics, needles whose float32 det cancels, opacities at the cutoff and
     a run of 12k instances), the port's render on a small scene against
     the per-pixel oracle, and the render's gradients through B1 + B2 +
     the fixed-order reduction against the same loss's gradients through
     the plain versions; two calls of those gradients must be bitwise
     equal. Every B2 check launches it twice and requires bitwise-equal
     rows;
  4. serving path at full width: scripts/bench_1080p.py's scene (1M
     Gaussians, SH degree 3, seed 0) written as gs.ply, loaded back onto the
     card and served by the port's viewer at 1920x1080: three GET /render
     and one GET /state. B1 and B2 are also held against their plain
     versions at this shape;
  5. training path at full width: that scene, rendered from 4 orbit views,
     is the ground truth; gs_trainer.train runs 40 iterations at 1920x1080
     from its jittered means (create_from_pcd, capacity 2^21), with two
     densify steps, and evaluate's PSNR must rise; the four views, re-binned
     with the final state, must not overflow;
  6. timing: B1, B2 and their plain versions at 1080p @ 1M with CUDA events,
     their bounds from this run's data, a train step broken into its parts,
     B1 and B2 held against their plain versions and timed on the step's
     own blend inputs, the per-Gaussian reduction against index_add_ (time,
     and how many values two calls of each disagree in), render gradients
     of the trained state on the step's view twice (bitwise equal), and one
     densify step;
  7. bench path: the probes P1-P4 against their plain versions (the TPU
     scripts' shapes, and for the scans also an input whose products do
     not underflow), then the port's measurement entry points at full size,
     in process: perf_vpu_dtype and perf_scan_variants (graph-replay times
     and rates, the empty-launch floor, P4's variants cross-checked),
     bench's 512x512 @ 100k and bench_1080p's 1920x1080 @ 1M (their JSON
     lines); then the probes' plain and library times and bounds (for the
     scans also each variant's time above the empty-launch floor and the
     bound of its shuffles and shared-memory accesses), and the device's
     busy share over the bench loops (torch.profiler).
  8. stages path at full width: a COLMAP scene on disk (8 PNG views at
     1920x1080 of the 1M scene, rendered with B1; PINHOLE poses; the 1M
     means as points3D.bin) goes through the port's command line in
     process: stages_cli train-gs (30 iterations), render (one PNG decoded
     back and held equal to the render it came from) and train-sugar for
     each of density, sdf and dn_consistency from the 1M model's gs.ply,
     iterations 8990-9010 (entropy, photo with the hard prune at 9000,
     sdf); finite losses, PSNR held within a margin, 55-80% of the
     Gaussians left by the prune, sugar.ply loads back. Then the decode of
     a 1080p PNG, the scene load, compute_knn at 1M and a SuGaR step per
     phase and method part by part are timed, and B1 and B2 are held
     against their plain versions on a dn_consistency depth render's
     inputs, with the transmittance cotangent that depth / acc gives.
     These stage 1-2 commands and timings run in a thread beside the first
     stage-3 run's host QEM (below), once the ablation runs have ended,
     after paths 3-7, in a directory of their own; their launches are the
     counts' rise over their run, in which nothing else launches B1 or B2.
     Next in that thread, the formats path (phase_formats): the scene's 8
     views re-encoded without PIL (utils/image_encode.py) as TIFF (Deflate
     with the predictor; LZW tiles), BMP (24-bit; 32-bit bitfields,
     top-down) and JPEG (YCCK; 4:1:1; arithmetic-coded progressive;
     lossless), a second COLMAP scene with the same cameras and points;
     each view decoded and timed (host clock), the lossless views and
     their ground truths as the loader gives them bitwise the PNG scene's,
     the lossy ones above 30 dB PSNR, the arithmetic-coded one bitwise its
     Huffman-coded twin; stages_cli train-gs on it at 1920x1080 (10
     iterations, B1 and B2 launched 10 times each), and B1 and B2 held
     against their plain versions on its model's first view.
     The same thread then writes the coloured sphere's scene (below) and
     runs the pipeline paths on it (phase_pipelines), each path's launches
     the counts' rise over it (nothing in that thread resets the counts, the
     peak memory statistics, the thread count or the environment, which the
     QEM's run reads or shares): cli.main --tiny --eval
     --export-obj (all six stages fresh, stage 3 included, on the scene with
     its point cloud cut to the preset's capacity of 2048; every output read
     back, 4096 Frosting Gaussians, finite held-out metrics (LPIPS with
     the weights below), B1 and B2 as
     many times as the stages' steps, views and test views predict); the
     config cli builds for --eval --export-obj (1920x1080, 7 train views,
     capacity 2^19 with 400k points, 2M Frosting Gaussians; 3DGS 30, SuGaR
     9001-9021, refinement 100 iterations; the stages path's instance
     capacity) through run_pipeline with a cache whose shell.npz holds a
     998,286-vertex UV sphere (stage 3 resumed), then the cli's writer
     (PLYs, frosting.npz, the textured mesh, metrics.json with LPIPS from
     seeded VGG16-shaped weights): launches per stage as predicted, no step
     overflowing, held-out PSNR above the initialised model's, every file
     read back, seconds by stage and export; a second run_pipeline from
     that cache (the three resume lines, no launch before stage 5, refined
     params bitwise equal to the first run's); LPIPS on the held-out view on
     the card against the CPU (a process of its own; rtol 2e-4), timed;
     stages_cli convert without colmap (a process of its own whose PATH is
     an empty directory; the JAX package's message); a 1080p baseline JPEG of
     the held-out view (a numpy encoder with the Annex K tables) decoded,
     timed and held to its source above 30 dB PSNR.
     Stage 3 on the same scene (phase_extract): 1M Gaussians on the unit
     sphere as sugar.ply, stages_cli extract-shell at the defaults (B1 once
     per view; the mesh within its 1M vertex budget, finite, median radius
     in a band; the parts' times and peak device memory logged), a second
     run with --both-poly (its own process, started first, waited for
     before train-refined-sugar) whose shell.ply equals the first's byte
     for byte and whose shell_lowpoly.ply lies within the 200k budget and
     the band, and --method centers (Poisson 256^3) / marching within their
     bands (in a process of their own, started when the first run enters
     its host QEM).
     Stages 4-5 (phase_frosting): the sphere, coloured by position, rendered
     by B1 from the 8 stage views as a second COLMAP scene (written beside
     the QEM, above); stages_cli
     train-frosting at its defaults (2M Gaussians) on the surface method's
     1M-vertex shell.ply, 100 iterations: B1 and B2 launched exactly once
     per iteration, no step overflowing, frosting.npz loading back to the
     refined model bitwise and frosting.ply loading, every value finite,
     the centres' median radius between the sheets', outer offsets > 0 >
     inner on average, the mean PSNR over the 8 views above the
     initialised model's by a margin; the corner blend's backward bitwise
     over two calls and against the plain gather; a second, culled run
     with --learn-shell --regularize-shell (20 iterations; B1 = B2 =
     iterations, its derived culled capacity below the full one and
     logged, each view's visible share in (0, 0.5], the offsets moved, its
     init bitwise equal to the first run's); render of frosting.npz (a PNG
     equal to the in-process render); init's and a refinement step's parts
     timed, full and culled (at the derived capacity), and B1 and B2 held
     against their plain versions on both views' blend inputs, B2 with the
     loss's cotangent; two learned-shell steps from one state bitwise
     equal (and, in the stages timings, two sdf draws with one seed);
     stages_cli metrics on the refined frosting.npz (B1 once per view,
     finite LPIPS, metrics.json read back). FROSTING_TPU_LPIPS_WEIGHTS
     names seeded VGG16-shaped weights for all of path 8.
     Stage 6 and editing (phase_texture, phase_refined_sugar,
     phase_blender), on the frosting phase's scene and artifacts:
     stages_cli extract-texture at 1024^2 (B1 once per view; a second run's
     mesh.png byte for byte the first's; the OBJ read back; a known-answer
     bake of the sphere's position colours), train-refined-sugar on stage
     3's 200k-vertex mesh at 6 Gaussians per face, 100 iterations (B1 = B2
     = iterations; the npz and PLY read back; PSNR up by a margin; a step
     part by part, B1 and B2 held on its inputs, B2 against float64), and
     blender_cli on a 1M-vertex, two-bone package over 4 frames, complex
     adaptation with occlusion culling and simple adaptation (B1 once per
     frame; frame 0 against the in-process render; adaptation, SVD and
     render timed per frame). train-refined-sugar runs once the second
     stage-3 run has written its 200k-vertex mesh.
  9. sharded path (phase_parallel), last, after train-refined-sugar: it
     takes the pipeline paths' full-width frosting_init.npz, and the second
     stage-3 run has ended (its device work after its QEM and the ranks'
     ~40 GiB do not fit on the card together): B1 and B2 held against
     their plain versions on a
     middle strip's blend inputs (strip 1 of 4 of the 1M scene at
     1920x1088), then the entry point python -m frosting_tpu_torch.parallel
     in processes of its own, at 1920x1088 (whole 16-row tiles), two runs at
     once: a world of one NCCL rank (the replicated 3DGS step at 1M twice,
     bitwise, against gs_trainer.train_step), and four gloo ranks on the one
     card under torchrun (a 2 x 2 mesh: the 3DGS step at 1M against the single-process
     batch-mean step, shard_params against replicated with capacity / 4
     rows a rank, three more steps and a sharded densify that grows the
     cloud, the 1 x 4 exchange against the all-gather; SuGaR's photo,
     entropy and sdf (density) steps and the depth strips against the full
     depth render; the Frosting step at 2M with 65,536 background Gaussians
     replicated and with shard_params against the single-process batch-mean
     step); every rank's launches as predicted (PAR_LAUNCHES), its steps'
     parts, collective bytes and peak memory logged. Four ranks on one card
     over gloo measure correctness and cost, not scaling.
 10. the multi-device pipeline (phase_pipeline_multichip), in the thread
     beside the first stage-3 run's QEM, after the pipeline paths: B1 and B2
     held against their plain versions on a strip of the script's shape
     (128x32 of 128x128, 32x16 tiles), then python -m frosting_tpu_torch.parallel.pipeline (stages
     1-5, the sharded 3DGS, SuGaR and Frosting steps chained, stages 3-4 on
     rank 0 and broadcast, the eval on rank 0) in processes of its own, two
     runs at once: a world of one NCCL rank at full width (the 1M bench
     scene over 8 views at 1920x1088, capacity 2^20, 20 / 20 / 20
     iterations, Poisson 256^3 with a 200k target, 2M Frosting Gaussians)
     and eight gloo ranks on the card on the JAX script's 2 x 4 mesh at its
     shapes and 150 / 100 / 150 iterations, held to PIPELINE_MC.json's
     known answers (copied here: stage 1's first loss within 1e-4 of
     0.1036, eval PSNR >= 34 dB, 1024 rows a rank); both with every rank's
     launches per stage as predicted (pmc_launches), the replicated and
     broadcast tensors' digests equal on every rank, stage 1's first step
     held against the single-process step, finite losses whose last-10 mean
     lies below the first (stage 2 per phase; at full width not its sdf
     phase).
Paths 3-7 do not wait for the stages path: they run first in the thread
beside stage 3's host QEM (phase_preamble), where the card is otherwise
idle, then the stage 1-2 commands and the pipeline paths of path 8. Each
of these paths' launches is the counts' rise over its run (nothing in the
thread resets the counts), and the first extract-shell run's are the
counts at the start of its QEM (it launches B1 only before it), checked
against the counts at its end less the thread's launches. Each later
train-frosting, extract-texture, train-refined-sugar, blender_cli and
metrics run resets the counts just before it and reads them just after.
The line before the last is the JSON kernels record; the last line is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.bench import __main__ as bench_main
from frosting_tpu_torch.bench import bench_1080p, perf_scan_variants, perf_vpu_dtype
from frosting_tpu_torch.bench import common as bench_common
from frosting_tpu_torch.bench.common import (
    BF16X2_FLOP_S,
    FP32_FLOP_S,
    HBM_BYTES_S,
    PIPE_OPS_S,
    SFU_OPS_S,
    autotuned_config,
    bench_scene,
    cuda_ms,
    graph_ms,
    smi,
    timed,
)
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.extract import meshclean
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
    blend_work_torch,
)
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.reference import render_naive
from frosting_tpu_torch.raster.render import (
    BlendFunction,
    autotune_max_instances,
    count_instances,
    sum_rows_by_gaussian,
)
from frosting_tpu_torch import blender_cli, cli, stages_cli
from frosting_tpu_torch import metrics as metrics_lib
from frosting_tpu_torch import pipeline as pipeline_lib
from frosting_tpu_torch.models import editing as editing_lib
from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.models import mesh_bound as mesh_bound_lib
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from frosting_tpu_torch.scene import dataset as dataset_lib
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.synthetic import adversarial_blend_inputs
from frosting_tpu_torch.train import (
    checkpoint,
    frosting_trainer,
    gs_trainer,
    refined_sugar,
    sugar_trainer,
)
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.utils import image as image_io
from frosting_tpu_torch.utils import image_encode
from frosting_tpu_torch.utils import ply as ply_io
from frosting_tpu_torch.utils import viewer
from frosting_tpu_torch.utils.profiling import PartTimes

# The card's peak rates are in frosting_tpu_torch/bench/common.py.
# Per evaluated (instance, pixel) pair the forward blend needs at least dx,
# dy, the quadratic form (9 flops) and op * exp: 12 FP32 flops and one exp.
# The backward adds about 30 flops (T, u, dalpha, the nine terms) and one
# reciprocal 1 / (1 - alpha) on the SFU.
FLOPS_PER_PAIR, SFU_PER_PAIR = 12, 1
FLOPS_PER_PAIR_BWD, SFU_PER_PAIR_BWD = 42, 2
# Kernel vs plain tolerance: atol/rtol 1e-5; at most 0.1% of values may
# differ by a stop-threshold flip (T * (1 - alpha) on the 1e-4 stop, where
# the two sum in another order). A forward flip moves a pixel by at most
# alpha * T <= 1e-2. A backward value is a sum over the tile's pixels, so it
# is compared normalised by its column's largest magnitude; a flip there
# moves one pixel's term of one or two instances (18 values), which has no
# small bound, so far fewer may be off: 1e-5 of the values, or 18 where
# that is more (the runs show at most 3.3e-7).
ATOL = RTOL = 1e-5
FLIP_SHARE, FLIP_BOUND = 1e-3, 1e-2
BWD_OFF_SHARE, BWD_OFF_MIN = 1e-5, 18
DEPTH_ERR_FACTOR = 2  # see compare_backward_float64
# On the depth render's inputs the kernel and the plain float32 walk may
# differ past the tolerance above in at most this share of the values, by
# at most this normalised error: twice the largest of three readings on
# the H100 (6,964 of 3.3e7 values, 1.36e-4; PERF.md).
DEPTH_VS_PLAIN_OFF_SHARE, DEPTH_VS_PLAIN_MAX_NORM = 4.2e-4, 2.8e-4
# Render gradients, kernels vs plain, normalised by the largest magnitude:
# the render-vs-oracle gradient tolerance of tests/test_raster.py.
GRAD_ATOL = 5e-4
GRAD_NAMES = ("means3d", "scales", "quats", "opacities", "sh")
MAIN_W, MAIN_H, MAIN_N = 1920, 1080, 1_000_000
ORBITS = ((0.0, 0.3), (2.1, 0.2), (4.2, 0.45))  # (azimuth, elevation)
ORBIT_R = 3.5
# Training: 4 views on the same orbit, 40 iterations (SH degree up every 10,
# densify at 20 and 30, size prune at 30, opacity reset past the run).
TRAIN_ORBITS = ((0.5, 0.25), (2.0, 0.4), (3.6, 0.15), (5.1, 0.35))
TRAIN_ITERS = 40
TRAIN_CAPACITY = 1 << 21
TRAIN_JITTER = 0.003  # world units; the scene's scales are 0.003-0.015
# 3DGS sets it to 1.1 x the cameras' largest distance from their centre
TRAIN_EXTENT = 1.1 * ORBIT_R
# Stages path: 8 views around the orbit at r 3.5, every command with a
# max_instances far above a view's ~3.7-4.2M instances (binning sizes its
# buffers to the real count), so that no render overflows.
STAGE_ORBITS = tuple((2 * math.pi * i / 8, 0.15 + 0.15 * (i % 3)) for i in range(8))
STAGE_MAX_INSTANCES = 1 << 24
STAGE_GS_ITERS = 30
SUGAR_FROM, SUGAR_TO = 8990, 9010  # entropy to 8999, photo + prune at 9000, sdf
SUGAR_METHODS = ("density", "sdf", "dn_consistency")
# PSNR of a log step's own view: the first log step (9000) comes right
# after the prune and the last (9010) after ten sdf steps, on another view
SUGAR_PSNR_MARGIN = 3.0  # dB
PRUNE_KEEP = (0.55, 0.80)  # opacities U(0.3, 0.95): ~69% are >= 0.5
# Stage 3: a known answer, MAIN_N Gaussians of scale 0.01 and opacity 0.9
# whose means lie on the unit sphere, as sugar.ply; extract-shell at its
# defaults (surface method, level 0.3, 21 samples, k 16, auto Poisson
# resolution up to 1024, targets 1M and 200k, visibility culling 0.001).
# The level-0.3 crossings lie ~2.7 scales (0.027) outside the sphere of
# means and are then snapped onto those points, so both meshes' median
# vertex radius lies in SHELL_RADIUS. QEM stops at its target, and after it
# only the vertices of faces it collapsed or of culled components go, so a
# mesh keeps at least SHELL_KEEP of its target.
SHELL_SCALE, SHELL_OPACITY = 0.01, 0.9
SHELL_TARGETS = (1_000_000, 200_000)
SHELL_RADIUS = (0.97, 1.05)
SHELL_KEEP = 0.9
# The ablation methods on the same model. centers: Poisson on the means
# themselves (radius 1), the mesh then snapped onto them, at 256^3 (at the
# auto 1024^3 the host QEM of its ~8M-vertex mesh takes ~4.5 min on the
# card's machine, at 512^3 ~1 min: cut to leave the script's time to
# stages 4-5); marching at 256^3 over the cameras' box (+/- 3.85,
# cells of 0.030) takes the density's level set 2.7 scales outside the
# sphere: radius ~1.027 (1.0276 measured before culling).
CENTERS_POISSON = 256
CENTERS_RADIUS = (0.97, 1.05)
MARCHING_RADIUS = (0.99, 1.06)
ABLATIONS = (("centers", CENTERS_RADIUS, ["--poisson-resolution", str(CENTERS_POISSON)]),
             ("marching", MARCHING_RADIUS, ["--marching-resolution", "256"]))
# extract-shell runs in a process of their own (the second stage-3 run and
# the ablation runs): argv[1] is a JSON list of (label, arguments); one
# "EXTRACT {...}" line per run, its result with the label.
_EXTRACT_CODE = """
import json, sys, time
import torch
from frosting_tpu_torch import stages_cli
cuda = torch.cuda.is_available()
for label, argv in json.loads(sys.argv[1]):
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = stages_cli.main(["extract-shell", *argv])
    if cuda:
        torch.cuda.synchronize()
    res.update(label=label, command_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0)
    print("EXTRACT " + json.dumps(res), flush=True)
"""
# LPIPS on the CPU in a process of its own: argv[1:4] are the weights' npz
# and the two images' .npy files; prints the value.
_LPIPS_CPU_CODE = """
import sys
import numpy as np, torch
torch.set_num_threads(4)
from frosting_tpu_torch import metrics
w, a, b = sys.argv[1:4]
print(float(metrics.LPIPS(w, device="cpu")(torch.from_numpy(np.load(a)),
                                           torch.from_numpy(np.load(b)))))
"""
# Stages 4-5 on that known answer: the sphere's Gaussians coloured by
# position (SH DC (mean + 1.5) / 3, as tests/test_frosting.py colours them)
# rendered by B1 from the 8 stage views as the scene's ground truth, the
# surface method's 1M-vertex shell.ply, train-frosting at its defaults (2M
# Gaussians); cut: iterations. A second, culled run with a learned and
# regularised shell. The refined model must beat the initialised one's mean
# PSNR over the 8 views by FROSTING_PSNR_GAIN; a view of a sphere from
# outside shows at most half its cells ((1 - r / d) / 2 ~ 0.35 at d 3.5).
FROSTING_N = 2_000_000  # train-frosting's default --gaussians
FROSTING_ITERS, FROSTING_CULLED_ITERS = 100, 20
FROSTING_PSNR_GAIN = 1.0  # dB; 3.4 measured on a UV-sphere shell
FROSTING_STEP_REPS = 5
# Stage 6 and editing (phase_texture, phase_refined_sugar, phase_blender),
# on the frosting phase's scene and artifacts.
TEXTURE_SIZE = 1024  # extract-texture's default
# mean |seen texel - the position colours of its pixels' surface points,
# averaged as the bake averages them but computed without extract/texture.py|
# (texture_known_answer): 0.0039 measured against a bake of those colours
# through extract/texture.py (NVIDIA H100 80GB HBM3); the bound leaves 5x that and
# lies under a texture of one colour (~0.047) or shuffled (~0.063), which
# the phase computes and requires past it. The independent texel counts
# must equal the command's on all but the texels a float32 UV moves across
# a texel edge (~6 pixels a texel, ~1e-4 of a texel's width each).
TEXTURE_MAE = 0.02
TEXTURE_COUNTS_EQUAL = 0.99
RS_ITERS, RS_PER_TRIANGLE = 100, 6  # SuGaR's low-poly setting: 6 per face
RS_PSNR_GAIN = 0.5  # dB over the initialised mesh-bound model, 8 views
BLENDER_FRAMES = 4
BLENDER_MAX_DEG = 30.0  # bone "bend" turns the upper hemisphere up to this
BLENDER_BAND = 0.2  # its weight ramps over |z| < BLENDER_BAND
BLENDER_EYE = (0.9, -3.2, 1.1)  # the static camera, looking at the origin
# The pipeline paths (cli, run_pipeline), on the coloured sphere's scene with
# its point cloud cut to the capacities: the --tiny preset's 2048 and, under
# the default 2^19, CLI_POINTS for the full-width run
CLI_TINY_POINTS = 2048
CLI_POINTS = 400_000
# The full-width run's iterations (cut as the stages path cuts them); SuGaR
# runs its sdf phase past the hard prune at 9000, which would empty a
# 30-iteration 3DGS model (opacities ~0.1 against the prune's 0.5): the
# entropy phase and the prune run in the --tiny run
PIPE_GS_ITERS = 30
PIPE_SUGAR = (9001, 9021)
PIPE_REFINE_ITERS = 100
# stage 3 resumed from a shell.npz: a unit UV sphere of 998,286 vertices
UV_LAT, UV_LON = 707, 1414
LPIPS_RTOL = 2e-4  # the card against the CPU (the JAX package's test tolerance)
JPEG_PSNR = 30.0  # dB, a 1080p view through the Annex K tables and back
# The formats path (phase_formats): the stages scene's 8 views re-encoded
# without PIL (utils/image_encode.py), one format each, as a second COLMAP
# scene with the same cameras and points, and train-gs on it (B1 and B2
# once an iteration)
FORMATS_GS_ITERS = 10
FORMATS = (  # (file name, format, lossless)
    ("img_000.tif", "TIFF, Deflate + horizontal predictor, strips of 64 rows", True),
    ("img_001.tif", "TIFF, LZW, 256 x 256 tiles", True),
    ("img_002.bmp", "BMP, 24-bit, bottom-up", True),
    ("img_003.bmp", "BMP, 32-bit BI_BITFIELDS, V5 header, top-down", True),
    ("img_004.jpg", "JPEG, YCCK (Adobe transform 2), K = 255", False),
    ("img_005.jpg", "JPEG, YCbCr 4:1:1", False),
    ("img_006.jpg", "JPEG, arithmetic-coded, progressive (SOF10)", False),
    ("img_007.jpg", "JPEG, lossless (SOF3), predictor 7, RGB", True),
)
# stages_cli convert without colmap: the JAX package's message
CONVERT_MESSAGE = ("convert requires the `colmap` binary on PATH (feature extraction + "
                   "mapper), which this environment does not ship. Provide a scene with "
                   "sparse/0 instead.")
DEV = "cuda"
T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def stamp(label):
    """One line of the script's timeline: seconds since the script began."""
    log(f"[{time.perf_counter() - T_START:7.1f} s] {label}")


def raw_params(arrays):
    """bench_scene's arrays as the raw (pre-activation) parameters of
    scene/gaussians.py, numpy arrays by group."""
    means, scales, quats, opac, sh = arrays
    return {
        "means3d": means,
        "sh_dc": sh[:, :1],
        "sh_rest": sh[:, 1:],
        "scales_log": np.log(scales),
        "quats_raw": quats,
        "opacities_raw": np.log(opac / (1.0 - opac)),
        "mask": np.ones(len(means), np.float32),
    }


def serving_views(model):
    """The serving orbit's cameras and a 1920x1080 config whose
    max_instances fits their largest instance count."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in ORBITS]
    probe = RasterConfig(width=MAIN_W, height=MAIN_H, max_instances=1 << 24)
    counts = [count_instances(*model, c, probe) for c in cams]
    cap = autotune_max_instances(max(counts), 128, safety=1.25)
    log(f"instances per view {counts}, max_instances {cap}")
    return cams, RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128, max_instances=cap)


def on_card(arrays):
    return tuple(torch.from_numpy(a).to(DEV) for a in arrays)


def blend_inputs(gs, cam, cfg):
    proj = preprocess(*gs, cam, cfg)
    return pack_fields(proj), bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)


def compare(label, fields, binned, cfg):
    """Kernel vs plain version on the same inputs; returns max abs error."""
    before = blend_cuda.blend_forward.launches
    out = blend_cuda.blend_forward(fields, binned, cfg)
    torch.cuda.synchronize()
    if blend_cuda.blend_forward.launches != before + 1:
        raise AssertionError(f"{label}: the kernel's launch count did not rise")
    ref = blend_forward_torch(fields, binned, cfg)
    err = (out - ref).abs()
    off = (err > ATOL + RTOL * ref.abs()).float().mean().item()
    max_err = err.max().item()
    log(f"{label}: instances {int(binned.num_instances)} max_abs_err {max_err:.3e} "
        f"share_off_tol {off:.2e}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output not finite")
    if off > FLIP_SHARE or max_err > FLIP_BOUND:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_err


def backward_twice(label, fields, binned, cfg, out, g):
    """B2's rows on the inputs; two launches must be bitwise equal."""
    before = blend_cuda.blend_backward.launches
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    again = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    torch.cuda.synchronize()
    if blend_cuda.blend_backward.launches != before + 2:
        raise AssertionError(f"{label}: the backward kernel's count did not rise")
    if not torch.equal(rows, again):
        raise AssertionError(f"{label}: two backward launches differ")
    if not torch.isfinite(rows).all():
        raise AssertionError(f"{label}: backward kernel output not finite")
    return rows


def backward_off(rows, ref):
    """(values off the tolerance, max normalised error, max abs error) of
    gradient rows against ref, each column normalised by ref's largest
    magnitude in it."""
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    err = (rows.to(ref.dtype) - ref).abs()
    off = int((err / scale > ATOL + RTOL * ref.abs() / scale).sum())
    return off, (err / scale).max().item(), err.max().item()


def compare_backward(label, fields, binned, cfg, plain_chunk=None, g=None):
    """B2 vs its plain version on the same inputs (B1's output and the
    cotangent g, by default a seeded one with colour and T parts); two
    launches must give bitwise-equal rows. Returns max abs error."""
    out = blend_cuda.blend_forward(fields, binned, cfg)
    if g is None:
        gen = torch.Generator(device=DEV).manual_seed(0)
        g = torch.randn(out.shape, generator=gen, device=DEV)
    rows = backward_twice(label, fields, binned, cfg, out, g)
    plain_cfg = dataclasses.replace(cfg, chunk=plain_chunk or cfg.chunk)
    ref = blend_backward_torch(fields, binned, plain_cfg, out, g)
    off, max_norm, max_err = backward_off(rows, ref)
    log(f"{label} backward: rows {rows.shape[0]} max_abs_err {max_err:.3e} "
        f"max_normalised_err {max_norm:.3e} "
        f"off_tol {off} of {rows.numel()}; two launches bitwise equal")
    if off > max(BWD_OFF_SHARE * rows.numel(), BWD_OFF_MIN):
        raise AssertionError(f"{label}: backward kernel disagrees with the plain version")
    return max_err


def compare_backward_float64(label, fields, binned, cfg, g, plain_chunk=64,
                             vs_plain=(DEPTH_VS_PLAIN_OFF_SHARE, DEPTH_VS_PLAIN_MAX_NORM)):
    """B2 on inputs whose colours leave [0, 1] (a depth render's: ~2.5-4.5),
    held with the plain float32 version against the plain version in
    float64. The suffix trick's dalpha = u T - gS / (1 - alpha) subtracts
    colour-sized sums, so the rounding of any float32 walk grows with |c|
    while the gradients, which follow colour differences, do not: neither
    float32 version holds the tolerance above against the other here. The
    kernel's values off that tolerance against float64 may be at most
    DEPTH_ERR_FACTOR times the plain float32 version's (or the count
    allowed above), and so may its largest normalised error; against the
    plain float32 version, DEPTH_VS_PLAIN_OFF_SHARE of the values may be
    off, by at most DEPTH_VS_PLAIN_MAX_NORM (vs_plain: that pair; None on
    inputs whose conics are near singular, flat mesh-bound Gaussians seen
    edge-on, where both float32 walks round apart and only their accuracy
    against float64 is held). Returns the kernel's max abs error against
    float64 and the counts."""
    out = blend_cuda.blend_forward(fields, binned, cfg)
    rows = backward_twice(label, fields, binned, cfg, out, g)
    plain_cfg = dataclasses.replace(cfg, chunk=plain_chunk)
    plain = blend_backward_torch(fields, binned, plain_cfg, out, g)
    f64 = fields.double()
    ref = blend_backward_torch(f64, binned, plain_cfg,
                               blend_forward_torch(f64, binned, plain_cfg), g.double())
    k_off, k_norm, k_err = backward_off(rows, ref)
    p_off, p_norm, _ = backward_off(plain, ref)
    o_off, o_norm, _ = backward_off(rows, plain)
    log(f"{label} backward against float64: rows {rows.shape[0]}; kernel off_tol "
        f"{k_off}, max_normalised_err {k_norm:.3e}, max_abs_err {k_err:.3e}; plain float32 "
        f"off_tol {p_off}, max_normalised_err {p_norm:.3e}; kernel vs plain float32 "
        f"off_tol {o_off}, max_normalised_err {o_norm:.3e}; of {rows.numel()} values; "
        "two launches bitwise equal")
    allowed = max(DEPTH_ERR_FACTOR * p_off, BWD_OFF_SHARE * rows.numel(), BWD_OFF_MIN)
    if k_off > allowed or k_norm > DEPTH_ERR_FACTOR * max(p_norm, ATOL):
        raise AssertionError(f"{label}: backward kernel less accurate than the plain version")
    if vs_plain is not None and (o_off > vs_plain[0] * rows.numel() or o_norm > vs_plain[1]):
        raise AssertionError(f"{label}: backward kernel disagrees with the plain version")
    return k_err, {"values": rows.numel(), "kernel_off_tol": k_off,
                   "kernel_max_normalised_err": k_norm, "plain_f32_off_tol": p_off,
                   "plain_f32_max_normalised_err": p_norm,
                   "kernel_vs_plain_f32_off_tol": o_off,
                   "kernel_vs_plain_f32_max_normalised_err": o_norm}


def render_grads(gs, cam, cfg, loss_of, bg=None):
    """Gradients of loss_of(image, t_final) of the port's render in its
    five inputs (B1 + B2 + the fixed-order reduction, then autograd)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in gs]
    out = render(*leaves, cam, cfg, bg=bg)
    return torch.autograd.grad(loss_of(out.image, out.t_final), leaves)


def reproducible_grads(label, gs, cam, cfg, loss_of, bg=None):
    """render_grads twice: every gradient must be bitwise equal over the two
    calls (tests/test_determinism.py's property of the JAX package).
    Returns the first call's gradients."""
    first = render_grads(gs, cam, cfg, loss_of, bg)
    second = render_grads(gs, cam, cfg, loss_of, bg)
    for name, a, b in zip(GRAD_NAMES, first, second):
        if not torch.equal(a, b):
            n_diff = int((a != b).sum())
            raise AssertionError(
                f"{label}: two calls give render gradients of {name} that differ "
                f"in {n_diff} of {a.numel()} values")
    log(f"{label}: render gradients of {', '.join(GRAD_NAMES)} bitwise equal "
        "over two calls")
    return first


def phase_render_gradients(gs, cam, cfg):
    """The render's gradients on the card (B1 + B2 + the fixed-order
    reduction), bitwise equal over two calls, against the same loss's
    gradients through the plain blend versions."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    target = torch.rand((3, cfg.height, cfg.width), generator=gen, device=DEV)
    bg = torch.tensor([0.1, 0.2, 0.3], device=DEV)

    def loss_of(image, t_final):
        return torch.mean((image - target) ** 2) + 0.1 * torch.mean(t_final)

    got = reproducible_grads("512x512 @ 100k", gs, cam, cfg, loss_of, bg)

    leaves = [t.clone().requires_grad_(True) for t in gs]
    proj = preprocess(*leaves, cam, cfg)
    out4, _, _ = BlendFunction.apply(
        pack_fields(proj), proj.rect, proj.depths, proj.valid, cfg,
        blend_forward_torch, blend_backward_torch,
    )
    image = out4[:3] + out4[3][None] * bg[:, None, None]
    ref = torch.autograd.grad(loss_of(image, out4[3]), leaves)
    for name, a, b in zip(GRAD_NAMES, got, ref):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item() / max(scale, 1e-30)
        log(f"render gradient {name}: max normalised err {err:.3e} (max |grad| {scale:.3e})")
        if not (scale > 0 and err <= GRAD_ATOL and torch.isfinite(a).all()):
            raise AssertionError(f"render gradient of {name} disagrees with the plain versions")


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=300) as r:
        return r.status, r.read()


def phase_small_reference():
    """The port's render on the card against the per-pixel oracle."""
    arrays = bench_scene(300, 7, -0.8, 0.8, 0.02, 0.12)
    gs = on_card(arrays)
    cam = look_at_camera(eye=[0.2, -0.3, -2.8], target=[0, 0, 0], device=DEV)
    cfg = RasterConfig(width=96, height=80, max_instances=1 << 16)
    bg = torch.tensor([0.1, 0.2, 0.3], device=DEV)
    with torch.inference_mode():
        out = render(*gs, cam, cfg, bg=bg)
        img_n, t_n = render_naive(preprocess(*gs, cam, cfg), bg, cfg)
    err = max((out.image - img_n).abs().max().item(),
              (out.t_final - t_n).abs().max().item())
    log(f"small reference 96x80 @ 300: max_abs_err vs oracle {err:.3e}")
    if err > FLIP_BOUND or not torch.isfinite(out.image).all():
        raise AssertionError("render disagrees with the per-pixel oracle")


class Timer:
    """CUDA events recorded between the parts of one run; ms per part."""

    def __init__(self):
        self.marks = []

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def parts(self):
        self.marks[-1][1].synchronize()
        return {
            name: a.elapsed_time(b)
            for (_, a), (name, b) in zip(self.marks, self.marks[1:])
        }


def step_breakdown(state, opt, cam, gt, rcfg, tcfg, reps):
    """A train step at full SH degree, cut where the trainer's render and
    loss pass from one part to the next (the same calls as
    gs_trainer.train_step), with CUDA events between the parts. Returns the
    median ms of each part over reps runs, after one warm-up run, and the
    last run's blend inputs (fields, binned, out, g_out)."""
    bg = torch.zeros(3, device=DEV)
    runs = []
    for _ in range(reps + 1):
        p = state.params
        leaves = {g: getattr(p, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
        probe = torch.zeros((p.capacity, 2), device=DEV, requires_grad=True)
        t = Timer()
        t.mark("start")
        model = gauss_lib.activate(dataclasses.replace(p, **leaves))
        proj = preprocess(*model, cam, rcfg)
        proj = proj._replace(means2d=proj.means2d + probe)
        fields = pack_fields(proj)
        t.mark("preprocess")
        binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
        t.mark("binning")
        out = blend_cuda.blend_forward(fields.detach(), binned, rcfg)
        t.mark("blend_forward (B1)")
        out_leaf = out.requires_grad_(True)
        image = out_leaf[:3] + out_leaf[3][None] * bg[:, None, None]
        loss = (1.0 - tcfg.lambda_dssim) * l1_loss(image, gt) + (
            tcfg.lambda_dssim * (1.0 - ssim(image, gt)))
        (g_out,) = torch.autograd.grad(loss, out_leaf)
        t.mark("loss + SSIM, forward and backward")
        rows = blend_cuda.blend_backward(fields.detach(), binned, rcfg, out.detach(),
                                         g_out.contiguous())
        t.mark("blend_backward (B2)")
        dfields = sum_rows_by_gaussian(rows, binned.inst_gauss, fields.shape[0])
        t.mark("reduction (sorted segment sum)")
        *grads, _ = torch.autograd.grad(
            fields, [leaves[g] for g in opt_lib.GROUPS] + [probe], dfields)
        t.mark("preprocess backward")
        opt.step(p, dict(zip(opt_lib.GROUPS, grads)), state.opt_state,
                 torch.isfinite(loss.detach()))
        t.mark("Adam")
        runs.append(t.parts())
    runs = runs[1:]
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return parts, (fields.detach(), binned, out.detach(), g_out.contiguous())


def phase_training(model, rcfg):
    """The training main path: gs_trainer.train at full width. Returns
    (state, cameras, ground truth, train config, launches per kernel)."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in TRAIN_ORBITS]
    with torch.inference_mode():
        gt_imgs = np.stack([
            render(*model, c, rcfg).image.cpu().numpy() for c in cams
        ])
    pts, cols = synthetic.degraded_init(model, keep=1.0, jitter=TRAIN_JITTER, seed=1)
    tcfg = gs_trainer.GSTrainConfig(
        iterations=TRAIN_ITERS,
        capacity=TRAIN_CAPACITY,
        sh_increase_interval=10,
        densify_from=20,
        densify_until=31,
        densification_interval=10,
        size_threshold_from=25,
        # the reference's 20 px is for ~1000 px wide training images; scaled
        # to 1920 px, so that the isotropic init's own radii (~20 px near the
        # cameras) are not pruned wholesale
        max_screen_size=40.0,
        opacity_reset_interval=10 * TRAIN_ITERS,
        log_every=10,
    )
    t0 = time.time()
    init, _ = gs_trainer.init_state(pts, cols, TRAIN_EXTENT, tcfg, device=DEV)
    log(f"train init: {len(pts)} points, create_from_pcd (host KNN) "
        f"{time.time() - t0:.1f} s")
    before = gs_trainer.evaluate(init, cams, gt_imgs, rcfg, tcfg)
    del init
    torch.cuda.empty_cache()

    lines = []

    def log_train(line):
        lines.append(line)
        log("  " + line)

    before_counts = counts_now()
    t0 = time.time()
    state, history = gs_trainer.train(
        cams, gt_imgs, pts, cols, TRAIN_EXTENT, rcfg, tcfg, seed=0,
        log_fn=log_train, device=DEV,
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(zip(("blend_forward", "blend_backward"), rise(before_counts)))
    after = gs_trainer.evaluate(state, cams, gt_imgs, rcfg, tcfg)
    log(f"training: {TRAIN_ITERS} iterations at {MAIN_W}x{MAIN_H} from {len(pts)} "
        f"points in {wall:.1f} s (init included); it/s per log interval "
        f"{[round(h['iters_per_s'], 2) for h in history]}; launches {launches}")
    log(f"evaluate on the {len(cams)} views: before {before}, after {after}")
    densified = [x for x in lines if " densify " in x]
    if len(densified) < 2:
        raise AssertionError("the densify steps did not run")
    for name, n in launches.items():
        if n < TRAIN_ITERS:
            raise AssertionError(f"training launched {name} {n} times")
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError("a logged loss is not finite")
    if any(h["overflow"] for h in history):
        raise AssertionError("instance overflow during training")
    # a log step's flag is its own step's: re-bin every view with the final
    # state, so that no view's overflow goes unseen
    with torch.inference_mode():
        final = gauss_lib.activate(state.params)
        for c in cams:
            proj = preprocess(*final, c, rcfg)
            if bool(bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg).overflow):
                raise AssertionError("a training view overflows with the final state")
        del final, proj
    if not after["psnr"] > before["psnr"]:
        raise AssertionError("training did not raise PSNR")
    return state, cams, gt_imgs, tcfg, launches


def work(fields, binned, cfg):
    """This run's data: instances, pre-stop pairs (every pair up to each
    pixel's stop) and live pairs (at or above the 1/255 cutoff, up to and
    including the stop), and the bytes each kernel must move."""
    n_inst = int(binned.inst_gauss.numel())
    image_bytes = 4 * cfg.height * cfg.width * 4
    in_bytes = n_inst * 9 * 4 + n_inst * 4 + binned.tile_ranges.numel() * 4
    return {
        "instances": n_inst,
        "pairs": int(blend_work_torch(fields, binned, cfg)),
        "live": int(blend_work_torch(fields, binned, cfg, live=True)),
        # B1 reads each instance's fields once per tile and writes [4, H, W];
        # B2 also reads out and g_out and writes the [M, 9] rows
        "bytes_fwd": in_bytes + image_bytes,
        "bytes_bwd": in_bytes + 2 * image_bytes + n_inst * 9 * 4,
    }


def bounds(w):
    """{"live": ..., "prestop": ...} bounds of B1 and B2 for the work w, each
    (ms, "bytes" or "operations", bytes ms, operations ms)."""

    def one(bytes_moved, pairs, flops, sfu):
        b = bytes_moved / HBM_BYTES_S * 1e3
        o = max(pairs * flops / FP32_FLOP_S, pairs * sfu / SFU_OPS_S) * 1e3
        return max(b, o), ("bytes" if b > o else "operations"), b, o

    return tuple(
        {k: one(w[by], w[n], flops, sfu) for k, n in (("live", "live"), ("prestop", "pairs"))}
        for by, flops, sfu in (("bytes_fwd", FLOPS_PER_PAIR, SFU_PER_PAIR),
                               ("bytes_bwd", FLOPS_PER_PAIR_BWD, SFU_PER_PAIR_BWD))
    )


def fmt_bound(b):
    return " / ".join(
        f"{k} {v[0]:.4f} ms ({v[1]}; bytes {v[2]:.4f}, operations {v[3]:.4f})"
        for k, v in b.items())


def phase_reduction(fields, binned, cfg, out, g_out):
    """The per-Gaussian sum of B2's rows on the step's inputs: the port's
    fixed-order reduction against the index_add_ it replaced (times, how
    many values two calls of each disagree in, and their difference)."""
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g_out)
    n = fields.shape[0]

    def index_add():
        return torch.zeros((n, rows.shape[1]), device=DEV).index_add_(
            0, binned.inst_gauss.long(), rows)

    def fixed():
        return sum_rows_by_gaussian(rows, binned.inst_gauss, n)

    result = {}
    for name, fn in (("index_add_", index_add), ("sorted segment sum", fixed)):
        a, b = fn(), fn()
        result[name] = {"ms": cuda_ms(fn, 10),
                        "values_differing_over_two_calls": int((a != b).sum())}
    a, b = index_add(), fixed()
    diff = ((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-30)).max().item()
    log(f"reduction of {rows.shape[0]} rows into {n}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms, {v['values_differing_over_two_calls']} of "
        f"{a.numel()} values differ over two calls" for k, v in result.items())
        + f"; max normalised difference between the two {diff:.3e}")
    if result["sorted segment sum"]["values_differing_over_two_calls"]:
        raise AssertionError("the fixed-order reduction is not reproducible")
    if diff > GRAD_ATOL:
        raise AssertionError("the fixed-order reduction disagrees with index_add_")
    return result


def scan_reps_library(x):
    """P3 through PyTorch's own scan and product (timed as library_ms)."""
    acc = torch.zeros((x.shape[0], 1), device=x.device)
    y = x
    for _ in range(perf_scan_variants.REPS):
        acc = acc + torch.prod(torch.cumprod(y, 1), 1, keepdim=True)
        y = y * 0.999 + 1e-4
    return acc


def scan_once_library(x):
    """P4 through torch.cumprod followed by torch.prod."""
    incl = torch.cumprod(x, 1)
    return incl, torch.prod(incl, 1, keepdim=True)


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (v in float32)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def hold_probes():
    """P1-P4 against their plain versions on the TPU scripts' inputs, and
    the scans also on an input whose products stay near 0.1. Tolerances:
    the FMA chain rtol 1e-6 in float32 and 1 ulp in bf16 (0.25 y is exact,
    so both round each step once); the exp chain rtol 1e-5 in float32 and
    1e-2 in bf16 (other exp implementations; the chain contracts errors);
    the scans rtol 2e-5, values under 1e-30 held by atol 1e-30 alone (the
    order of a product decides its denormals; the kernels multiply in the
    plain versions' order, so equality is expected). Returns max abs error
    per probe and dtype / input."""
    errs = {}
    pv = perf_vpu_dtype
    for probe, fn, plain in (("chain_fma", pv.chain_fma, pv.chain_fma_torch),
                             ("chain_exp", pv.chain_exp, pv.chain_exp_torch)):
        for nm, dt in pv.DTYPES.items():
            x = pv.probe_input(dt, DEV)
            got, ref = fn(x).float(), plain(x).float()
            err = (got - ref).abs()
            if probe == "chain_fma":
                tol = 1e-6 * ref.abs() if nm == "f32" else bf16_ulp(ref)
            else:
                tol = (1e-5 if nm == "f32" else 1e-2) * ref.abs()
            errs[f"{probe}_{nm}"] = err.max().item()
            log(f"{probe}_{nm} [1024, 512]: max_abs_err {errs[f'{probe}_{nm}']:.3e}, "
                f"bitwise equal {torch.equal(got, ref)}, values in "
                f"[{ref.min().item():.6g}, {ref.max().item():.6g}]")
            if not (torch.isfinite(got).all() and (err <= tol).all()):
                raise AssertionError(f"{probe}_{nm} disagrees with its plain version")

    ps = perf_scan_variants

    def held(label, got, ref, lib):
        err = (got - ref).abs()
        lib_rel = ((lib - ref).abs() / ref.abs().clamp_min(1e-30))[ref.abs() > 1e-30]
        log(f"  {label}: max_abs_err {err.max().item():.3e}, bitwise equal "
            f"{torch.equal(got, ref)}; values in [{ref.min().item():.3e}, "
            f"{ref.max().item():.3e}]; torch.cumprod/prod differ by rel "
            f"{lib_rel.max().item() if lib_rel.numel() else 0.0:.3e}")
        if not (torch.isfinite(got).all() and (err <= 1e-30 + 2e-5 * ref.abs()).all()):
            raise AssertionError(f"{label} disagrees with its plain version")
        return err.max().item()

    for tag, lo in (("tpu", 0.9), ("nonzero", ps.NONZERO_LO)):
        # P3 on seed 0 (the TPU script's timing input), P4 on seed 1 (its
        # cross-check input)
        x = ps.probe_input(0, lo=lo, device=DEV)
        ref, lib = ps.scan_reps_torch(x), scan_reps_library(x)
        log(f"scan_reps, input uniform in [{lo}, 1) seed 0:")
        reps = {v: ps.scan_reps(x, v) for v in ps.VARIANTS}
        errs[f"scan_reps_{tag}"] = max(held(v, o, ref, lib) for v, o in reps.items())
        x = ps.probe_input(1, lo=lo, device=DEV)
        (ref_i, ref_p), (lib_i, lib_p) = ps.scan_once_torch(x), scan_once_library(x)
        log(f"scan_once, input uniform in [{lo}, 1) seed 1:")
        once = {v: ps.scan_once(x, v) for v in ps.VARIANTS}
        errs[f"scan_once_{tag}"] = max(
            max(held(v + " incl", i, ref_i, lib_i), held(v + " prod", p, ref_p, lib_p))
            for v, (i, p) in once.items())
        for outs in (list(reps.values()), [torch.cat(o, 1) for o in once.values()]):
            if not all(torch.equal(o, outs[0]) for o in outs):
                raise AssertionError("the scan variants are not bitwise equal")
    return errs


PROBE_COUNTERS = {
    "blend_forward": blend_cuda.blend_forward,
    "blend_backward": blend_cuda.blend_backward,
    "chain_fma": perf_vpu_dtype.chain_fma,
    "chain_exp": perf_vpu_dtype.chain_exp,
    "scan_reps": perf_scan_variants.scan_reps,
    "scan_once": perf_scan_variants.scan_once,
}


def phase_bench():
    """The bench main path: the port's four measurement entry points, in
    process, at their full sizes, each kernel's launches the rise of its
    count over the path (a CUDA graph's replays re-run the launches
    captured from its wrapper calls and are not counted). Returns
    (launches, the probes' times in ms)."""
    before = {name: fn.launches for name, fn in PROBE_COUNTERS.items()}
    times = perf_vpu_dtype.run(DEV, log=log)
    times.update(perf_scan_variants.run(DEV, log=log))
    log(json.dumps(bench_main.run(DEV)))
    log(json.dumps(bench_1080p.run(DEV, log=log)))
    torch.cuda.synchronize()
    launches = {name: fn.launches - before[name] for name, fn in PROBE_COUNTERS.items()}
    log(f"bench path launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the bench path did not launch {name}")
    return launches, times


def device_profile(label, fn):
    """Where one call of fn spends the card's time: torch.profiler's kernel
    time (the sum of every kernel's device time) over the wall time of an
    unprofiled call (CUDA events), and the five kernels that take most.
    Returns the busy share, or None where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall_ms = timed(fn, DEV)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"{label}: the profiler saw no device time; busy share not measured")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"{label}: wall {wall_ms:.3f} ms (unprofiled), kernels {busy_ms:.3f} ms, "
        f"device busy {busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}; "
        f"{sum(e.count for e in kernels)} kernel launches; largest: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return busy_ms / wall_ms


def bench_profiles():
    """Device busy share of 10 fwd+bwd and 10 fwd-only iterations of the
    bench's 512x512 @ 100k loops, and of 2 of each of bench_1080p's."""
    shares = {}
    for label, module, iters in (("512x512 @ 100k", bench_main, 10),
                                 ("1920x1080 @ 1M", bench_1080p, 2)):
        gs, cam, cfg, _ = module.setup(DEV)
        target = torch.zeros((3, cfg.height, cfg.width), device=DEV)
        shares[label] = {
            "fwd+bwd": device_profile(
                f"{label} fwd+bwd x{iters}",
                lambda: bench_common.fwd_bwd_loop(gs, cam, cfg, target, iters, 0.017)),
            "fwd": device_profile(
                f"{label} fwd-only x{iters}",
                lambda: bench_common.fwd_loop(gs, cam, cfg, iters, 0.013)),
        }
    return shares


def bound(bytes_moved, *ops_rates):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and each (operations, rate) pair's time."""
    b = bytes_moved / HBM_BYTES_S * 1e3
    o = max(n / r for n, r in ops_rates) * 1e3
    return max(b, o), ("bytes" if b > o else "operations")


def probe_timings(errs, times, launches):
    """The probes' kernel records: kernel times from the bench path's graph
    replays (P4's timed here), plain and library times by graph replay,
    and bounds from the probes' shapes."""
    pv, ps = perf_vpu_dtype, perf_scan_variants
    recs = []
    for name, line, fn_plain, ops in (
        ("chain_fma", 64, pv.chain_fma_torch,
         lambda n, rate: ((pv.fma_flops(n), rate),)),
        ("chain_exp", 89, pv.chain_exp_torch,
         lambda n, rate: ((pv.exp_count(n), SFU_OPS_S), (pv.exp_count(n), rate))),
    ):
        rec = {"name": name, "route": "cuda",
               "source": "frosting_tpu_torch/csrc/perf_vpu_dtype.cu",
               "replaces": f"scripts/perf_vpu_dtype.py:{line}",
               "launches": launches[name]}
        tpu_name = "chain_fma" if name == "chain_fma" else "chain_exp40"
        for nm, dt in pv.DTYPES.items():
            x = pv.probe_input(dt, DEV)
            key = "" if nm == "f32" else "_bf16"
            b_ms, b_by = bound(2 * x.numel() * x.element_size(),
                               *ops(x.numel(), FP32_FLOP_S if nm == "f32" else BF16X2_FLOP_S))
            rec.update({
                f"max_abs_err{key}": errs[f"{name}_{nm}"],
                f"ms{key}": times[f"{tpu_name}_{nm}"],
                f"plain_ms{key}": graph_ms(lambda: fn_plain(x), 10, 3),
                f"bound_ms{key}": b_ms, f"bound_by{key}": b_by,
            })
        rec["library_ms"] = None
        rec["library_note"] = (f"no one PyTorch call computes the "
                               f"{pv.FMA_REPS if name == 'chain_fma' else pv.EXP_REPS}-step chain")
        recs.append(rec)

    floor = times["empty_launch"]

    def scan_layout(ms, lanes, table, rounds):
        """The variants' times above the empty-launch floor, and the bound
        of the layout's shuffles and shared-memory accesses."""
        return {
            "ms_above_floor": ms["scan_concat+prod_concat"] - floor,
            "ms_above_floor_variants": {v: t - floor for v, t in ms.items()},
            "lanes_per_row": lanes,
            "pipe_bound_ms_variants": {
                v: rows * rounds * ps.pipe_ops(lanes, *f, table) / PIPE_OPS_S * 1e3
                for v, f in ps.VARIANTS.items()},
        }

    x = ps.probe_input(0, device=DEV)
    rows = x.shape[0]
    b_ms, b_by = bound(x.numel() * 4 + rows * 4, (ps.reps_flops(rows), FP32_FLOP_S))
    reps_ms = {v: times[v] for v in ps.VARIANTS}
    recs.append({
        "name": "scan_reps", "route": "cuda",
        "source": "frosting_tpu_torch/csrc/perf_scan_variants.cu",
        "replaces": "scripts/perf_scan_variants.py:76",
        "launches": launches["scan_reps"],
        "max_abs_err": max(errs["scan_reps_tpu"], errs["scan_reps_nonzero"]),
        "ms": times["scan_concat+prod_concat"],
        "ms_variants": reps_ms,
        "plain_ms": graph_ms(lambda: ps.scan_reps_torch(x), 10, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(lambda: scan_reps_library(x), 10, 3),
        "library_note": "30 rounds of torch.cumprod, torch.prod and the update",
        "launch_floor_ms": floor,
        **scan_layout(reps_ms, ps.REPS_LANES, True, ps.REPS),
    })
    x = ps.probe_input(1, device=DEV)
    incl, prod = torch.empty_like(x), torch.empty((rows, 1), device=DEV)
    once_ms = {v: graph_ms(lambda: ps.scan_once(x, v, incl, prod)) for v in ps.VARIANTS}
    b_ms, b_by = bound(2 * x.numel() * 4 + rows * 4, (ps.once_flops(rows), FP32_FLOP_S))
    recs.append({
        "name": "scan_once", "route": "cuda",
        "source": "frosting_tpu_torch/csrc/perf_scan_variants.cu",
        "replaces": "scripts/perf_scan_variants.py:116",
        "launches": launches["scan_once"],
        "max_abs_err": max(errs["scan_once_tpu"], errs["scan_once_nonzero"]),
        "ms": once_ms["scan_concat+prod_concat"],
        "ms_variants": once_ms,
        "plain_ms": graph_ms(lambda: ps.scan_once_torch(x), 10, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(lambda: scan_once_library(x)),
        "library_note": "torch.cumprod followed by torch.prod",
        "launch_floor_ms": floor,
        **scan_layout(once_ms, ps.ONCE_LANES, False, 1),
    })
    for r in recs:
        log(f"{r['name']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in r.items() if isinstance(v, float)))
    return recs


def host_ms(fn, reps):
    """Median host-clock ms of fn over reps calls (each ends in a sync)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_stages(raw, model, preamble):
    """The stages main path: a COLMAP scene of the 1M model written to disk;
    stage 3 (phase_extract) on it, and beside that run's host QEM, in a
    thread, first preamble(raw) (paths 3-7), then the stage 1-2 commands
    through stages_cli in process (train-gs, render, train-sugar for each
    method, in a directory of their own), their timings and the
    depth-render check of B1 and B2, and the pipeline paths; then stages
    4-5 (phase_frosting), stage 6 and editing, train-refined-sugar last
    (it takes the second stage-3 run's 200k mesh). Returns (preamble's
    result, launches per kernel of the stage 1-2 commands, of the first
    extract-shell, of each later command, timings)."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in STAGE_ORBITS]
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene_dir, out = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
        out_gs = os.path.join(tmp, "stages")
        for d in (out, out_gs):
            os.makedirs(d)
        # seeded LPIPS weights for every metrics.json of this phase (cli
        # --tiny, the full-width writer, stages_cli metrics), named before
        # any thread or process of the phase starts and unset at its end
        weights = synthetic.write_lpips_weights(os.path.join(tmp, "lpips_weights.npz"))
        os.environ["FROSTING_TPU_LPIPS_WEIGHTS"] = weights
        t0 = time.time()
        paths = synthetic.write_colmap_scene(scene_dir, model, cams, rcfg)
        log(f"stages: COLMAP scene of {len(cams)} PNG views at {MAIN_W}x{MAIN_H} and "
            f"{MAIN_N} points written in {time.time() - t0:.1f} s")
        timings["png_decode_1080p_ms"] = host_ms(lambda: image_io.read_image(paths[0]), 5)
        common = ["-s", scene_dir, "-o", out, "--max-instances", str(STAGE_MAX_INSTANCES),
                  "--device", DEV]
        common_gs = [out_gs if a == out else a for a in common]
        args = stages_cli.build_parser().parse_args(["render", *common_gs])
        t0 = time.perf_counter()
        scene, scams, gt, srcfg = stages_cli._load_scene(args)
        timings["scene_load_ms"] = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            want = np.clip(render(*model, cams[0], rcfg).image.cpu().numpy(), 0, 1)
        want = (want * 255).astype(np.uint8).astype(np.float32) / 255.0
        if not (np.array_equal(gt[0], want) and len(scams) == len(cams)
                and len(scene.points) == MAIN_N):
            raise AssertionError("the loaded scene differs from the one written")
        log(f"stages: 1080p PNG decode {timings['png_decode_1080p_ms']:.1f} ms "
            f"(median of 5); load_colmap_scene + _load_scene of {len(scams)} views "
            f"{timings['scene_load_ms']:.0f} ms; GT view 0 equals the written render")
        del gt

        def stages_1_2():
            """train-gs, render and train-sugar (each method) in out_gs,
            checked, then the stages timings. Run beside stage 3's host
            QEM (phase_extract), where it is the only work launching B1
            and B2: its launches are the counts' rise over the run."""
            before = (blend_cuda.blend_forward.launches, blend_cuda.blend_backward.launches)
            t0 = time.perf_counter()
            hist = stages_cli.main(["train-gs", *common_gs, "--iterations",
                                    str(STAGE_GS_ITERS), "--capacity", str(TRAIN_CAPACITY)])
            timings["train_gs_s"] = time.perf_counter() - t0
            if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hist):
                raise AssertionError(f"train-gs: a non-finite loss or an overflow: {hist}")
            t0 = time.perf_counter()
            stages_cli.main(["render", *common_gs])
            torch.cuda.synchronize()
            timings["render_command_s"] = time.perf_counter() - t0
            # train-gs's model, checked against the render command's PNG once
            # the commands' launches are read
            live = gauss_lib.activate(stages_cli.load_live_gaussians(
                os.path.join(out_gs, "gs.ply"), device=DEV))
            log(f"stages: train-gs {timings['train_gs_s']:.1f} s ({STAGE_GS_ITERS} iterations, "
                f"scene load and create_from_pcd included), render command "
                f"{timings['render_command_s']:.1f} s for {len(scams)} views")

            gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"),
                               os.path.join(out_gs, "gs.ply"))
            for method in SUGAR_METHODS:
                t0 = time.perf_counter()
                hist = stages_cli.main([
                    "train-sugar", *common_gs, "-r", method, "--start-iteration",
                    str(SUGAR_FROM), "--iterations", str(SUGAR_TO), "--capacity",
                    str(TRAIN_CAPACITY)])
                timings[f"train_sugar_{method}_s"] = time.perf_counter() - t0
                first, last = hist[0], hist[-1]
                secs = timings[f"train_sugar_{method}_s"]
                log(f"stages: train-sugar -r {method}: {secs:.1f} s; "
                    + "; ".join(f"it {h['iter']} [{h['phase']}] loss {h['loss']:.4f} psnr "
                                f"{h['psnr']:.2f} n {h['n_active']}" for h in hist)
                    + f"; PSNR margin {SUGAR_PSNR_MARGIN} dB")
                if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hist):
                    raise AssertionError(
                        f"train-sugar {method}: a non-finite loss or an overflow")
                if not last["psnr"] >= first["psnr"] - SUGAR_PSNR_MARGIN:
                    raise AssertionError(f"train-sugar {method}: PSNR fell past the margin")
                keep = first["n_active"] / MAIN_N
                if not (first["iter"] == 9000 and PRUNE_KEEP[0] <= keep <= PRUNE_KEEP[1]):
                    raise AssertionError(f"train-sugar {method}: the prune kept {keep:.3f}")
                back = gauss_lib.load_ply(os.path.join(out_gs, "sugar.ply"), device="cpu")
                if back.capacity != last["n_active"] or not torch.isfinite(back.means3d).all():
                    raise AssertionError(f"train-sugar {method}: sugar.ply does not load back")
            torch.cuda.synchronize()
            launches = {"blend_forward": blend_cuda.blend_forward.launches - before[0],
                        "blend_backward": blend_cuda.blend_backward.launches - before[1]}
            log(f"stages path launches {launches}")
            for name, n in launches.items():
                if n <= 0:
                    raise AssertionError(f"the stages path did not launch {name}")

            with torch.inference_mode():
                img = np.clip(render(*live, scams[0], srcfg).image.cpu().numpy(), 0, 1)
            got, mode = image_io.read_image(os.path.join(out_gs, "renders", "train_00000.png"))
            png = (img.transpose(1, 2, 0) * 255).astype(np.uint8)
            if not (mode == "RGB" and np.array_equal(got, png)):
                raise AssertionError("render: the PNG differs from the render it came from")
            timings["render_view_ms"] = host_ms(
                lambda: viewer.render_png(live, scams[0], srcfg), 3)
            del live
            log(f"stages: render + PNG of one view {timings['render_view_ms']:.1f} ms (host "
                "clock, median of 3); renders/train_00000.png decodes to the render")
            gt0 = torch.from_numpy(np.asarray(scene.train_cameras[0].image(),
                                              np.float32)).to(DEV)
            timings.update(stages_timings(os.path.join(out_gs, "gs.ply"), scene, gt0))
            return launches

        def beside_qem():
            """Paths 3-7, the stage 1-2 commands, then the coloured sphere's
            scene and the pipeline paths on it, and the multi-device
            pipeline: nothing of stage 3's."""
            pipes["preamble"] = preamble(raw)
            torch.cuda.empty_cache()
            stamp("stages 1-2 (beside the QEM)")
            launches = stages_1_2()
            torch.cuda.empty_cache()
            stamp("the formats path: train-gs on TIFF, BMP and JPEG views (beside the QEM)")
            pipes["formats_launches"], timings["formats"], timings[
                "formats_max_abs_err"] = phase_formats(tmp, scene_dir)
            torch.cuda.empty_cache()
            stamp("the coloured sphere's scene and the pipeline paths (beside the QEM)")
            pipes["scene_dir"] = write_sphere_scene(tmp)
            pipes["launches"], timings["pipelines"] = phase_pipelines(
                tmp, pipes["scene_dir"], weights)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            pipes["pmc_launches"], timings["pipeline_multichip"], timings[
                "pipeline_multichip_max_abs_err"] = phase_pipeline_multichip(tmp)
            timings["pipeline_multichip"]["phase_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            stamp("the work beside the QEM ends")
            return launches

        torch.cuda.empty_cache()
        stamp("stage 3 (extract-shell), with paths 3-7, stages 1-2 and the pipeline paths "
              "beside its host QEM")
        pipes = {}
        extract_launches, timings["extract_shell"], launches, finish = phase_extract(
            scene_dir, out, common, len(scams), beside_qem)
        del scene
        try:
            torch.cuda.empty_cache()
            stamp("stages 4-5 (train-frosting)")
            frosting_launches, timings["frosting"] = phase_frosting(
                tmp, pipes["scene_dir"], os.path.join(out, "sugar.ply"),
                os.path.join(out, "shell_surface.ply"))
            frosting_launches.update(pipes["launches"])
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            stamp("stage 6 (extract-texture)")
            frosting_launches["texture"], timings["texture"] = phase_texture(tmp)
            torch.cuda.empty_cache()
            stamp("blender_cli")
            blender, timings["blender"] = phase_blender(tmp)
            frosting_launches.update({f"blender_{k}": v for k, v in blender.items()})
            torch.cuda.empty_cache()
            stamp("the second stage-3 run (--both-poly)")
            timings["extract_shell"]["both_poly"] = finish()
        except BaseException:
            finish.kill()
            raise
        stamp("train-refined-sugar")
        frosting_launches["refined_sugar"], timings["refined_sugar"] = phase_refined_sugar(
            tmp, os.path.join(out, "sugar.ply"), os.path.join(out, "shell_lowpoly.ply"))
        timings["stage6_and_editing_s"] = time.perf_counter() - t0
        log(f"extract-texture, blender_cli and train-refined-sugar phases (the wait for the "
            f"second stage-3 run included): {timings['stage6_and_editing_s']:.1f} s")
        # last, once the second stage-3 run has ended: its device work after
        # its QEM and the gloo ranks' ~40 GiB do not fit on the card together
        torch.cuda.empty_cache()
        stamp("the sharded path")
        t0 = time.perf_counter()
        pipes["parallel_launches"], timings["parallel"], timings[
            "parallel_max_abs_err"] = phase_parallel(
            tmp, model, os.path.join(tmp, "pipeline_cache", "frosting_init.npz"))
        timings["parallel"]["phase_s"] = time.perf_counter() - t0
        del os.environ["FROSTING_TPU_LPIPS_WEIGHTS"]
    frosting_launches["parallel"] = pipes["parallel_launches"]
    frosting_launches["pipeline_multichip"] = pipes["pmc_launches"]
    frosting_launches["formats"] = pipes["formats_launches"]
    return pipes["preamble"], launches, extract_launches, frosting_launches, timings


def sphere_raw(n, seed=0):
    """Raw parameters of n Gaussians of scale SHELL_SCALE and opacity
    SHELL_OPACITY whose means lie on the unit sphere, coloured by position
    (seeded numpy)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = (d + 1.5) / 3.0  # colour by position (extraction reads no SH)
    return raw_params((d.astype(np.float32), np.full((n, 3), SHELL_SCALE, np.float32), quats,
                       np.full((n,), SHELL_OPACITY, np.float32), sh))


def median_radius(path):
    v, f = stages_cli.load_mesh(path)
    if not (np.isfinite(v).all() and len(f) and f.min() >= 0 and f.max() < len(v)):
        raise AssertionError(f"{path}: non-finite vertices or bad faces")
    return len(v), len(f), float(np.median(np.linalg.norm(v, axis=1)))


def _extract_results(lines):
    """{label: result} of the EXTRACT lines of _EXTRACT_CODE's output."""
    return {r["label"]: r for r in (json.loads(line[len("EXTRACT "):])
                                    for line in lines if line.startswith("EXTRACT "))}


def _log_extract(label, res):
    log(f"extract-shell {label}: {res['command_s']:.1f} s, peak device memory "
        f"{res['peak_gib']:.2f} GiB, Poisson {res['poisson_resolutions']}; parts (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["timings_ms"].items()))


def phase_extract(scene_dir, out, common, n_views, beside_qem):
    """Stage 3 on the stages path's scene: the known-answer sphere as
    sugar.ply, then extract-shell at full width in process (the 1M budget:
    B1 launched once per view, its parts' times, peak device memory, the
    mesh's counts and radius). A second run, extract-shell --both-poly in a
    process of its own, must write a shell.ply equal byte for byte to the
    first run's (the same Poisson mesh decimated to the same budget) and a
    shell_lowpoly.ply within the 200k budget, which train-refined-sugar
    takes. The second run starts first, and the first once the second has
    made its Poisson mesh, so that the second's quantile cleaning (device)
    runs beside the first's query KNN, density and Poisson, and its host QEM
    (both budgets) beside the rest. Its 200k budget is the longest QEM of
    the script: the first run, with the 1M budget alone, ends well before
    it, and stages 4-5, stage 6 and blender_cli run meanwhile; the returned
    `finish` waits for the second run and checks it, before
    train-refined-sugar. --method centers at Poisson 256^3 and --method
    marching at 256^3 run in a third process, each in a directory of its
    own, started when the first run enters its host QEM (its call of
    meshclean.decimate), by when the second is in its own: their device
    parts (seconds) share no device time with the stage-3 runs' parts
    before QEM, and their host QEM runs beside the others' (the start is
    logged). beside_qem (work that needs nothing of stage 3: the stage 1-2
    commands and their timings, the pipeline paths) runs in a thread of
    this process from the moment the ablation runs end, which is inside the
    first run's host QEM, when the card is otherwise idle but for the
    second run's host QEM; the first run launches B1 only before its QEM,
    so its launches are the counts at the QEM's start, and the counts at
    its end must be those plus the thread's own. The first run's shell.ply
    is kept as shell_surface.ply for stages 4-5. Returns (launches of the
    first command, results, beside_qem's result, finish); finish() returns
    the second run's results and leaves its shell_lowpoly.ply in `out`."""
    gauss_lib.save_ply(gauss_lib.params_from_numpy(sphere_raw(MAIN_N), device="cpu"),
                       os.path.join(out, "sugar.ply"))
    out_b = out + "_again"
    ablation_dirs = {method: f"{out}_{method}" for method, _band, _extra in ABLATIONS}
    for d in (out_b, *ablation_dirs.values()):
        os.makedirs(d)
        shutil.copy(os.path.join(out, "sugar.ply"), d)
    shell_ply = os.path.join(out, "shell.ply")
    results = {}

    common_b = [out_b if a == out else a for a in common]
    ablation_log = out + "_ablations.log"
    ablation_argv = [sys.executable, "-c", _EXTRACT_CODE, json.dumps(
        [(method, [*[out_d if a == out else a for a in common], "--method", method, *extra])
         for (method, _band, extra), out_d in zip(ABLATIONS, ablation_dirs.values())])]
    root = os.path.dirname(os.path.abspath(__file__))
    again = subprocess.Popen(
        [sys.executable, "-c", _EXTRACT_CODE,
         json.dumps([("--both-poly", [*common_b, "--both-poly"])])],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = {"again": again}
    # the second run's output, read by a thread of its own so that its pipe
    # never fills while the main thread is busy
    again_lines, poisson_done = [], threading.Event()

    def read_again():
        for line in again.stdout:
            again_lines.append(line.rstrip())
            if line.startswith("[shell/all] poisson res"):
                poisson_done.set()
        poisson_done.set()

    reader = threading.Thread(target=read_again, daemon=True)
    reader.start()
    lock = threading.Lock()
    decimate = meshclean.decimate

    side = {}

    def run_beside_qem():
        try:
            procs["ablations"].wait()
            side["start_s"] = time.perf_counter() - t_first
            before = counts_now()
            side["result"] = beside_qem()
            torch.cuda.synchronize()
            side["launches"] = tuple(a - b for a, b in zip(counts_now(), before))
            side["end_s"] = time.perf_counter() - t_first
        except BaseException as e:  # re-raised by the main thread
            side["error"] = e

    def start_ablations_then_decimate(*args, **kwargs):
        """The first run's QEM: its device parts before QEM are done, so
        the ablation runs start here, and then the work beside QEM."""
        with lock:
            if "ablations" not in procs:
                results["ablations_start_s"] = time.perf_counter() - t_first
                results["launches_before_qem"] = counts_now()
                results["peak_gib_before_qem"] = torch.cuda.max_memory_allocated() / 2**30
                with open(ablation_log, "w") as fh:
                    procs["ablations"] = subprocess.Popen(
                        ablation_argv, cwd=root, stdout=fh, stderr=subprocess.STDOUT,
                        text=True)
                side["thread"] = threading.Thread(target=run_beside_qem, daemon=True)
                side["thread"].start()
        return decimate(*args, **kwargs)

    def kill_all():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    try:
        t0 = time.perf_counter()
        poisson_done.wait()
        for line in again_lines:
            log(f"  [second run] {line}")
        if again.poll() is not None:
            raise AssertionError(f"the second extract-shell ended early ({again.wait()})")
        log(f"second run's Poisson mesh done in {time.perf_counter() - t0:.1f} s")
        shown = len(again_lines)
        reset_counts()
        meshclean.decimate = start_ablations_then_decimate
        t_first = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = stages_cli.main(["extract-shell", *common])
        torch.cuda.synchronize()
        res["command_s"] = time.perf_counter() - t_first
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        results["surface"] = res
        _log_extract("(1M budget)", res)
        meshclean.decimate = decimate
        if "thread" not in side:
            raise AssertionError("the first extract-shell run never entered its QEM")
        side["thread"].join()
        if "error" in side:
            raise side["error"]
        torch.cuda.synchronize()
        before_qem = results["launches_before_qem"]
        launches = {"blend_forward": before_qem[0], "blend_backward": before_qem[1]}
        log(f"extract-shell launches {launches} (all before its QEM); the work beside its QEM "
            f"ran from {side['start_s']:.1f} s to {side['end_s']:.1f} s into the run and "
            f"launched {side['launches']}; the run's peak device memory before its QEM "
            f"{results['peak_gib_before_qem']:.2f} GiB")
        if launches != {"blend_forward": n_views, "blend_backward": 0}:
            raise AssertionError(f"extract-shell should launch B1 once per view: {launches}")
        if tuple(a + b for a, b in zip(before_qem, side["launches"])) != counts_now():
            raise AssertionError("extract-shell launched a kernel after its QEM began")
        if "ablations" not in procs:
            raise AssertionError("the ablation runs did not start")
        procs["ablations"].wait()
    except BaseException:
        kill_all()
        raise
    finally:
        meshclean.decimate = decimate
    ablations = procs["ablations"]
    before_qem = sum(v for k, v in res["timings_ms"].items()
                     if k not in ("QEM decimation", "projection", "visibility culling")) / 1e3
    log(f"the ablation runs started {results['ablations_start_s']:.1f} s into the first run, "
        f"whose parts before its QEM took {before_qem:.1f} s and which took "
        f"{res['command_s']:.1f} s in all")
    with open(ablation_log) as fh:
        lines = fh.read().splitlines()
    for line in lines:
        log(f"  [ablations] {line}")
    if ablations.returncode != 0:
        kill_all()
        raise AssertionError(f"the ablation runs failed ({ablations.returncode})")
    results.update(_extract_results(lines))
    try:
        nv, nf, r = median_radius(shell_ply)
        log(f"shell.ply: {nv} vertices, {nf} faces, median radius {r:.5f} "
            f"(band {SHELL_RADIUS}, {SHELL_KEEP * SHELL_TARGETS[0]:.0f} to "
            f"{SHELL_TARGETS[0]} vertices)")
        if not (SHELL_KEEP * SHELL_TARGETS[0] <= nv <= SHELL_TARGETS[0]
                and SHELL_RADIUS[0] <= r <= SHELL_RADIUS[1]):
            raise AssertionError(f"{shell_ply}: {nv} vertices, median radius {r}")
        results["surface"]["shell.ply"] = {"verts": nv, "faces": nf, "median_r": r}
        shutil.copy(shell_ply, os.path.join(out, "shell_surface.ply"))
        for method, band, extra in ABLATIONS:
            res = results[method]
            _log_extract(f"--method {method} {' '.join(extra)} (beside the stage-3 runs' QEM)",
                         res)
            nv, nf, r = median_radius(os.path.join(ablation_dirs[method], "shell.ply"))
            log(f"--method {method}: {nv} vertices, {nf} faces, median radius {r:.5f} "
                f"(band {band})")
            if not (0 < nv <= SHELL_TARGETS[0] and band[0] <= r <= band[1]):
                raise AssertionError(f"--method {method}: {nv} vertices, median radius {r}")
            results[method]["shell.ply"] = {"verts": nv, "faces": nf, "median_r": r}
    except BaseException:
        kill_all()
        raise

    def finish():
        """Wait for the second run (--both-poly) and hold it: its shell.ply
        byte for byte the first run's, its shell_lowpoly.ply within the 200k
        budget and the band, copied into `out`. Returns its results."""
        try:
            t0 = time.perf_counter()
            code = again.wait()
            reader.join()
            waited = time.perf_counter() - t0
            for line in again_lines[shown:]:
                log(f"  [second run] {line}")
            if code != 0:
                raise AssertionError(f"the second extract-shell failed ({code})")
        finally:
            kill_all()
        res_b = _extract_results(again_lines)["--both-poly"]
        res_b["waited_s"] = waited
        _log_extract(f"--both-poly (a process of its own; {waited:.1f} s waited for)", res_b)
        low_ply = os.path.join(out_b, "shell_lowpoly.ply")
        nv, nf, r = median_radius(low_ply)
        log(f"shell_lowpoly.ply: {nv} vertices, {nf} faces, median radius {r:.5f} "
            f"(band {SHELL_RADIUS}, {SHELL_KEEP * SHELL_TARGETS[1]:.0f} to "
            f"{SHELL_TARGETS[1]} vertices)")
        if not (SHELL_KEEP * SHELL_TARGETS[1] <= nv <= SHELL_TARGETS[1]
                and SHELL_RADIUS[0] <= r <= SHELL_RADIUS[1]):
            raise AssertionError(f"{low_ply}: {nv} vertices, median radius {r}")
        res_b["shell_lowpoly.ply"] = {"verts": nv, "faces": nf, "median_r": r}
        with open(shell_ply, "rb") as f, open(os.path.join(out_b, "shell.ply"), "rb") as g:
            same = f.read() == g.read()
        log(f"second run (--both-poly): shell.ply {'equals' if same else 'DIFFERS from'} the "
            "first run's byte for byte")
        if not same:
            raise AssertionError("two extractions of the same model differ")
        shutil.copy(low_ply, os.path.join(out, "shell_lowpoly.ply"))
        return res_b

    finish.kill = kill_all
    return launches, results, side["result"], finish


def _counted(argv):
    """stages_cli.main(argv) with the kernels' counts set to 0 just before
    and read just after; returns (result, launches, seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = stages_cli.main(argv)
    torch.cuda.synchronize()
    launches = {"blend_forward": blend_cuda.blend_forward.launches,
                "blend_backward": blend_cuda.blend_backward.launches}
    return res, launches, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def _groups_equal(a, b):
    ga, gb = frosting_trainer.param_groups(a), frosting_trainer.param_groups(b)
    return ga.keys() == gb.keys() and all(torch.equal(ga[k], gb[k]) for k in ga)


def _mean_psnr(model, cams, gt, rcfg):
    """Mean PSNR (and each view's) of an activated model's renders against
    gt [n, 3, H, W]."""
    with torch.inference_mode():
        vals = [float(psnr(torch.clamp(render(*model, c, rcfg).image, 0.0, 1.0),
                           torch.from_numpy(g).to(DEV))) for c, g in zip(cams, gt)]
    return float(np.mean(vals)), vals


def phase_frosting(tmp, scene_dir, sugar_ply, shell_ply):
    """Stages 4-5 through stages_cli in process, at full width: a COLMAP
    scene of the coloured sphere's renders, sugar.ply and the surface
    method's 1M-vertex shell.ply; train-frosting at its defaults (2M
    Gaussians), checked and timed; a second run culled, with a learned and
    regularised shell; render of frosting.npz; the corner blend's backward
    bitwise over two calls and against the plain gather; a refinement step
    part by part, full and culled. Returns (launches of each command,
    results)."""
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    outs = [os.path.join(tmp, "frosting"), os.path.join(tmp, "frosting_culled")]
    for o in outs:
        os.makedirs(o)
        shutil.copy(sugar_ply, os.path.join(o, "sugar.ply"))
        shutil.copy(shell_ply, os.path.join(o, "shell.ply"))
    n_shell = len(stages_cli.load_mesh(shell_ply)[0])

    def common(o):
        return ["-s", scene_dir, "-o", o, "--max-instances", str(STAGE_MAX_INSTANCES),
                "--device", DEV]

    results, launches = {}, {}
    res, launches["frosting"], secs, peak = _counted(
        ["train-frosting", *common(outs[0]), "--gaussians", str(FROSTING_N),
         "--iterations", str(FROSTING_ITERS)])
    hist, (init_p, meta), trained = res["history"], res["init"], res["trained"]
    n = trained.bary_logits.shape[0]
    results["command_s"], results["peak_gib"] = secs, peak
    results["timings_ms"], results["history"] = res["timings_ms"], hist
    log(f"train-frosting (shell {n_shell} vertices, {n} Gaussians, {FROSTING_ITERS} "
        f"iterations): {secs:.1f} s, peak device memory {peak:.2f} GiB, launches "
        f"{launches['frosting']}; parts (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["timings_ms"].items()))
    log("  " + "; ".join(f"it {h['iter']} loss {h['loss']:.4f} psnr {h['psnr']:.2f} "
                         f"{h['iters_per_s']:.2f} it/s, overflow steps {h['overflow_steps']}"
                         for h in hist))
    want = {"blend_forward": FROSTING_ITERS, "blend_backward": FROSTING_ITERS}
    if launches["frosting"] != want:
        raise AssertionError(f"train-frosting launched {launches['frosting']}, not {want}")
    if not (n_shell >= SHELL_KEEP * SHELL_TARGETS[0] and n == FROSTING_N):
        raise AssertionError(f"train-frosting ran on {n_shell} vertices, {n} Gaussians")
    if not all(np.isfinite(h["loss"]) and not h["overflow"] and h["overflow_steps"] == 0
               for h in hist):
        raise AssertionError(f"train-frosting: a non-finite loss or an overflow: {hist}")
    loaded, lmeta = checkpoint.load_frosting(os.path.join(outs[0], "frosting.npz"), device=DEV)
    if not (_groups_equal(loaded, trained) and torch.equal(lmeta.cell_idx, meta.cell_idx)
            and torch.equal(lmeta.cell_bounds, meta.cell_bounds)
            and torch.equal(lmeta.faces, meta.faces)):
        raise AssertionError("frosting.npz does not load back to the refined model bitwise")
    ply = ply_io.read_ply(os.path.join(outs[0], "frosting.ply"))["vertex"]
    if not (len(ply["x"]) == n and all(np.isfinite(ply[k]).all() for k in ply)):
        raise AssertionError("frosting.ply does not load back")
    if not all(torch.isfinite(t).all() for t in frosting_trainer.param_groups(trained).values()):
        raise AssertionError("the refined model has non-finite values")
    with torch.inference_mode():
        centres = frosting_lib.to_gaussians(trained, meta)[0]
        inner, outer, _ = frosting_lib.shell_sheets(trained, meta.faces, meta.incidence)
        r_c = float(centres.norm(dim=1).median())
        band = (float(inner.norm(dim=1).median()), float(outer.norm(dim=1).median()))
        offsets = (float(trained.inner_dist.mean()), float(trained.outer_dist.mean()))
        del centres, inner, outer
    log(f"frosting centres' median radius {r_c:.5f}, the sheets' median radii {band}; "
        f"mean inner / outer offset {offsets}")
    if not (band[0] <= r_c <= band[1] and offsets[1] > 0 > offsets[0]):
        raise AssertionError("the frosting layer does not wrap the shell")
    args = stages_cli.build_parser().parse_args(["render", *common(outs[0])])
    _scene, scams, gt, _rcfg = stages_cli._load_scene(args)
    with torch.inference_mode():
        before, before_v = _mean_psnr(frosting_lib.to_gaussians(init_p, meta), scams, gt, rcfg)
        after, after_v = _mean_psnr(frosting_lib.to_gaussians(trained, meta), scams, gt, rcfg)
    results["psnr_init"], results["psnr_refined"] = before_v, after_v
    log(f"mean PSNR over the {len(scams)} views: init {before:.3f} dB, refined {after:.3f} dB "
        f"(gain {after - before:.3f}, required {FROSTING_PSNR_GAIN}); per view "
        f"{[round(v, 2) for v in before_v]} -> {[round(v, 2) for v in after_v]}")
    if not after >= before + FROSTING_PSNR_GAIN:
        raise AssertionError("refinement did not raise the mean PSNR by the margin")
    results["corner_blend"] = hold_corner_blend(trained, meta)

    res2, launches["frosting_culled"], secs, peak = _counted(
        ["train-frosting", *common(outs[1]), "--gaussians", str(FROSTING_N),
         "--iterations", str(FROSTING_CULLED_ITERS),
         "--occlusion-culling", "--learn-shell", "--regularize-shell"])
    init2, meta2 = res2["init"]
    trained2, culled_cap = res2["trained"], res2["culled_max_instances"]
    results["culled"] = {"command_s": secs, "peak_gib": peak, "timings_ms": res2["timings_ms"],
                         "history": res2["history"], "max_instances": culled_cap}
    log(f"train-frosting --occlusion-culling --learn-shell --regularize-shell "
        f"({FROSTING_CULLED_ITERS} iterations): {secs:.1f} s, peak {peak:.2f} GiB, launches "
        f"{launches['frosting_culled']}, culled instance capacity {culled_cap} (full "
        f"{STAGE_MAX_INSTANCES}); parts (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res2["timings_ms"].items()))
    want = {"blend_forward": FROSTING_CULLED_ITERS, "blend_backward": FROSTING_CULLED_ITERS}
    if launches["frosting_culled"] != want:
        raise AssertionError(f"the culled run launched {launches['frosting_culled']}")
    if not (culled_cap is not None and 0 < culled_cap < STAGE_MAX_INSTANCES):
        raise AssertionError(f"the culled run derived no smaller capacity: {culled_cap}")
    if not all(np.isfinite(h["loss"]) and not h["overflow"] and h["overflow_steps"] == 0
               for h in res2["history"]):
        raise AssertionError("the culled run: a non-finite loss or an overflow")
    if not (_groups_equal(init2, init_p) and all(
            torch.equal(getattr(meta, k), getattr(meta2, k))
            for k in ("faces", "cell_idx", "cell_bounds"))):
        raise AssertionError("two init_frosting calls with one seed differ")
    log("two init_frosting calls (one per command, generator seed 0) are bitwise equal")
    moved = [float((getattr(trained2, k) - getattr(init2, k)).abs().max())
             for k in ("inner_dist", "outer_dist")]
    if not (min(moved) > 0 and torch.isfinite(trained2.inner_dist).all()
            and torch.isfinite(trained2.outer_dist).all()):
        raise AssertionError(f"the learned shell's offsets did not move: {moved}")
    vis = frosting_trainer.precompute_visibility(init2, meta2, scams, rcfg)
    shares = vis[:, :n].mean(dim=1).tolist()
    results["culled"]["visible_share"] = shares
    log(f"visible share of the frosting Gaussians per view {[round(x, 4) for x in shares]}; "
        f"largest offset change {moved}")
    if not all(0.0 < x <= 0.5 for x in shares):
        raise AssertionError("a view's visible share lies outside (0, 0.5]")
    results["learned_shell_bitwise"] = hold_learned_shell(trained2, meta2, scams[0], gt[0],
                                                          rcfg)
    del res2, init2, meta2, trained2

    stages_cli.main(["render", *common(outs[0])])
    with torch.inference_mode():
        img = np.clip(render(*frosting_lib.to_gaussians(loaded, lmeta), scams[0],
                             rcfg).image.cpu().numpy(), 0, 1)
    png, mode = image_io.read_image(os.path.join(outs[0], "renders", "train_00000.png"))
    if not (mode == "RGB" and np.array_equal(png, (img.transpose(1, 2, 0) * 255).astype(np.uint8))):
        raise AssertionError("render of frosting.npz: the PNG differs from the render")
    log("render of frosting.npz: renders/train_00000.png decodes to the in-process render")
    del loaded, lmeta, init_p
    torch.cuda.empty_cache()
    results["step_ms"], results["max_abs_err"] = frosting_step_timings(
        trained, meta, scams[0], gt[0], rcfg,
        dataclasses.replace(rcfg, max_instances=culled_cap), vis[0])

    # stages_cli metrics on the refined frosting.npz: no test split here, so
    # the train views
    res_m, launches["stages_cli_metrics"], secs, _peak = _counted(["metrics", *common(outs[0])])
    with open(os.path.join(outs[0], "metrics.json")) as fh:
        back = json.load(fh)
    results["stages_cli_metrics"] = {"command_s": secs, **res_m}
    log(f"stages_cli metrics: {secs:.1f} s, launches {launches['stages_cli_metrics']}, "
        f"metrics.json {back}")
    if not (back == res_m and res_m["n_views"] == len(scams) and np.isfinite(res_m["psnr"])
            and np.isfinite(res_m["lpips"]) and launches["stages_cli_metrics"] == {"blend_forward": len(scams),
                                                   "blend_backward": 0}):
        raise AssertionError("stages_cli metrics: metrics.json or its launches")
    return launches, results


def obj_counts(path):
    """(v, vt, f line counts, the v lines' values [V, 3]) of an OBJ file."""
    with open(path, "rb") as fh:
        data = fh.read()
    counts = tuple(data.count(b"\n" + k) for k in (b"v ", b"vt ", b"f "))
    start = data.index(b"\nv ")
    end = data.index(b"\nvt ")
    rows = data[start:end].replace(b"\nv ", b"\n").split()
    return counts, np.array(rows, dtype=np.float64).reshape(-1, 3)


def atlas_corners(n_faces):
    """[F, 3, 2] float64 on the card: each face's corner UVs in
    extract-texture's atlas, written out from its definition (JAX's
    uv_atlas, after the reference's texture.py:35-72), not from
    extract/texture.py: B = ceil(sqrt((F + 1) // 2)) square blocks a side, two
    faces a block (face f in block f // 2, row-major from u = v = 0), the
    even face the lower-left triangle (0, 0), (1, 0), (0, 1) and the odd
    one the upper-right (1, 1), (0, 1), (1, 0), each shrunk towards its
    right-angle corner to leave 0.12 of the block at the block's edges and
    0.24 across its diagonal."""
    b = math.ceil(math.sqrt((n_faces + 1) // 2))
    f = torch.arange(n_faces, device=DEV, dtype=torch.float64)
    block = torch.div(f, 2, rounding_mode="floor")
    origin = torch.stack([block % b, torch.div(block, b, rounding_mode="floor")], 1) / b
    lower = torch.tensor([[0.12, 0.12], [0.76, 0.12], [0.12, 0.76]], device=DEV,
                         dtype=torch.float64)
    shape = torch.where((f % 2 == 0)[:, None, None], lower, 1.0 - lower)
    return origin[:, None, :] + shape / b


def texture_known_answer(verts, faces, scene_dir, out, tex, counts):
    """The known answer of extract-texture on the coloured sphere, computed
    without extract/texture.py: each covered pixel of each view (the mesh
    rasterizer's face and barycentrics) carries the position colour of its
    surface point on the shell (sphere_raw's SH DC (p / |p| + 1.5) / 3 as
    RGB: 0.5 + C0 * DC); its UV comes from atlas_corners, its texel from
    the UV (column u * S, row (1 - v) * S, clamped), and each texel's
    colours are averaged by torch.bincount in float64. Against the
    command's mesh.png (tex, uint8) and texel counts: the share of texels
    whose counts agree, and the mean absolute error over the texels both
    saw; beside it, as controls the check must be able to fail on, the
    error of a texture of one colour (the seen texels' mean) and of the
    seen texels shuffled (seeded); and, logged only, the error of each seen
    texel's centre mapped back through the atlas to one face and point
    (a texel spans ~1.02 blocks a side: it holds pieces of up to eight
    faces, which need not be neighbours on the mesh)."""
    s = TEXTURE_SIZE
    c0 = 0.28209479177387814
    cams = stages_cli._load_scene(stages_cli.build_parser().parse_args(
        ["render", "-s", scene_dir, "-o", out, "--device", DEV]))[1]
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    uv_c = atlas_corners(faces.shape[0])
    v64, f64 = verts.double(), faces.long()
    sums = torch.zeros((3, s * s), device=DEV, dtype=torch.float64)
    cnt = torch.zeros(s * s, device=DEV, dtype=torch.float64)
    with torch.inference_mode():
        for cam in cams:
            fr = mesh_raster.rasterize_mesh(verts, faces, cam, rcfg)
            pf = fr.pix_to_face.reshape(-1)
            hit = pf >= 0
            face, bary = pf[hit].long(), fr.bary.reshape(-1, 3)[hit].double()
            p = torch.einsum("nk,nkc->nc", bary, v64[f64[face]])
            col = 0.5 + c0 * (p / p.norm(dim=1, keepdim=True) + 1.5) / 3.0
            uv = torch.einsum("nk,nkc->nc", bary, uv_c[face])
            tx = (uv[:, 0] * s).clamp(0, s - 1).long()
            ty = ((1.0 - uv[:, 1]) * s).clamp(0, s - 1).long()
            tid = ty * s + tx
            cnt += torch.bincount(tid, minlength=s * s)
            for c in range(3):
                sums[c] += torch.bincount(tid, weights=col[:, c], minlength=s * s)
    cnt = cnt.cpu().numpy()
    want = (sums.cpu().numpy() / np.maximum(cnt, 1.0)).T.reshape(s, s, 3)
    cnt = cnt.reshape(s, s)
    seen = counts > 0
    both = seen & (cnt > 0)
    got = tex.astype(np.float64) / 255.0

    def mae(texels):
        return float(np.abs(texels - want[both]).mean())

    shuffled = got[both][np.random.default_rng(0).permutation(int(both.sum()))]
    # each seen texel's centre back through the atlas: block, half, then
    # the barycentrics of the centre in that face's (shrunk) triangle
    b = math.ceil(math.sqrt((faces.shape[0] + 1) // 2))
    ys, xs = np.nonzero(both)
    u, v = (xs + 0.5) / s * b, (1.0 - (ys + 0.5) / s) * b
    bx, by = np.minimum(u.astype(int), b - 1), np.minimum(v.astype(int), b - 1)
    lu, lv = u - bx, v - by
    upper = lu + lv > 1.0
    lu, lv = np.where(upper, 1.0 - lu, lu), np.where(upper, 1.0 - lv, lv)
    w = np.clip(np.stack([lu - 0.12, lv - 0.12], 1) / 0.64, 0.0, 1.0)
    w = np.clip(np.concatenate([1.0 - w.sum(1, keepdims=True), w], 1), 0.0, 1.0)
    w /= w.sum(1, keepdims=True)
    face = np.minimum((by * b + bx) * 2 + upper, faces.shape[0] - 1)
    tri = v64[f64[torch.from_numpy(face).to(DEV)]].cpu().numpy()
    p = np.einsum("nk,nkc->nc", w, tri)
    centre = 0.5 + c0 * (p / np.linalg.norm(p, axis=1, keepdims=True) + 1.5) / 3.0
    return {"seen_share": float(seen.mean()), "mean_count": float(counts[seen].mean()),
            "counts_equal_share": float((cnt == counts).mean()),
            "known_answer_mae": mae(got[both]),
            "constant_mae": mae(got[both].mean(axis=0)),
            "shuffled_mae": mae(shuffled),
            "texel_centre_mae": float(np.abs(got[both] - centre).mean())}


def phase_texture(tmp):
    """Stage 6 on phase_frosting's frosting.npz (2M Gaussians on the 1M-vertex
    extracted shell), in process: stages_cli extract-texture at
    --texture-size 1024 (B1 launched exactly once per view), then again into
    a second directory (mesh.png byte for byte the first's); the OBJ read
    back with the shell's vertex and face counts and its vertices; the seen
    texel share; the known answer (texture_known_answer): the scene is the
    unit sphere coloured by position, so the seen texels lie within
    TEXTURE_MAE (mean absolute error) of the position colours of their
    pixels' surface points, averaged per texel without extract/texture.py, and a
    texture of one colour or shuffled does not. Returns (launches of the
    first command, results)."""
    scene_dir = os.path.join(tmp, "frosting_scene")
    outs = [os.path.join(tmp, "frosting"), os.path.join(tmp, "texture_again")]
    os.makedirs(outs[1])
    shutil.copy(os.path.join(outs[0], "frosting.npz"), outs[1])
    results, runs = {}, []
    for o in outs:
        res, launches, secs, peak = _counted(
            ["extract-texture", "-s", scene_dir, "-o", o, "--max-instances",
             str(STAGE_MAX_INSTANCES), "--texture-size", str(TEXTURE_SIZE), "--device", DEV])
        runs.append((res, launches, secs, peak))
        log(f"extract-texture ({o}): {secs:.1f} s, peak {peak:.2f} GiB, launches {launches}, "
            f"seen texels {res['seen_share']:.4f}; parts (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["timings_ms"].items()))
    res, launches, secs, peak = runs[0]
    results.update(command_s=[r[2] for r in runs], peak_gib=peak, timings_ms=res["timings_ms"],
                   timings_ms_again=runs[1][0]["timings_ms"], seen_share=res["seen_share"])
    want = {"blend_forward": len(STAGE_ORBITS), "blend_backward": 0}
    if launches != want or runs[1][1] != want:
        raise AssertionError(f"extract-texture launched {launches} / {runs[1][1]}, not {want}")
    with open(os.path.join(outs[0], "mesh.png"), "rb") as a, \
            open(os.path.join(outs[1], "mesh.png"), "rb") as b:
        same = a.read() == b.read()
    log(f"extract-texture twice: mesh.png {'equal' if same else 'DIFFERS'} byte for byte")
    if not same:
        raise AssertionError("two texture bakes of one model differ")
    params, meta = checkpoint.load_frosting(os.path.join(outs[0], "frosting.npz"), device="cpu")
    verts, faces = params.shell_verts.numpy(), meta.faces.numpy()
    t0 = time.perf_counter()
    (nv, nvt, nf), v = obj_counts(os.path.join(outs[0], "mesh.obj"))
    log(f"mesh.obj read back in {time.perf_counter() - t0:.1f} s: {nv} v, {nvt} vt, {nf} f "
        f"(the shell: {len(verts)} vertices, {len(faces)} faces)")
    if (nv, nvt, nf) != (len(verts), 3 * len(faces), len(faces)) or not np.abs(
            v - verts).max() <= 5e-7 * max(1.0, np.abs(verts).max()):
        raise AssertionError("mesh.obj does not load back to the shell")
    tex, mode = image_io.read_image(os.path.join(outs[0], "mesh.png"))
    if (mode, tex.shape) != ("RGB", (TEXTURE_SIZE, TEXTURE_SIZE, 3)):
        raise AssertionError(f"mesh.png is {mode} {tex.shape}")
    ka = texture_known_answer(params.shell_verts.to(DEV), meta.faces.to(DEV), scene_dir,
                              outs[0], tex, res["texel_counts"])
    results.update(ka)
    log(f"seen texels {ka['seen_share']:.4f} of {TEXTURE_SIZE}^2 (mean count "
        f"{ka['mean_count']:.2f}); the independent bake's texel counts equal the command's on "
        f"{ka['counts_equal_share']:.5f} of the texels; mean absolute error of the seen texels "
        f"against the position colours of their pixels' surface points: "
        f"{ka['known_answer_mae']:.4f} (bound {TEXTURE_MAE}); the same error of the texture's "
        f"mean colour everywhere {ka['constant_mae']:.4f}, of its seen texels shuffled "
        f"{ka['shuffled_mae']:.4f}, of each texel's centre's own colour through the atlas "
        f"{ka['texel_centre_mae']:.4f} (logged)")
    if not (0.0 < ka["seen_share"] < 1.0 and ka["counts_equal_share"] >= TEXTURE_COUNTS_EQUAL
            and ka["known_answer_mae"] <= TEXTURE_MAE
            and min(ka["constant_mae"], ka["shuffled_mae"]) > TEXTURE_MAE):
        raise AssertionError("the baked texture is not the sphere's position colour, or the "
                             "check cannot tell a constant or shuffled texture from it")
    return launches, results


def refined_step_timings(params, meta, cam, gt, rcfg):
    """A refined-SuGaR step at full width part by part (CUDA events, median
    of FROSTING_STEP_REPS after a warm-up), cut where refined_sugar.train_step
    passes from one part to the next; the whole train_step (median of 5);
    then B1 and B2 held against their plain versions on the step's blend
    inputs, B2 with the loss's cotangent and against float64 beside the
    plain float32 walk. Returns (times, max abs errors)."""
    cfg = refined_sugar.MeshBoundTrainConfig()
    opt = refined_sugar.make_mesh_bound_optimizer(cfg, TRAIN_EXTENT)
    state = opt.init(refined_sugar.param_groups(params))
    gt = torch.from_numpy(gt).to(DEV)
    bg = torch.zeros(3, device=DEV)
    runs = []
    for _ in range(FROSTING_STEP_REPS + 1):
        groups = refined_sugar.param_groups(params)
        leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
        p = dataclasses.replace(params, **leaves)
        t = Timer()
        t.mark("start")
        act = mesh_bound_lib.activate_mesh_bound(p, meta)
        t.mark("mesh-bound activation")
        act_l = [a.detach().requires_grad_(True) for a in act]
        proj = preprocess(*act_l, cam, rcfg, active_sh_degree=3)
        fields = pack_fields(proj)
        t.mark("preprocess")
        binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
        t.mark("binning")
        o = blend_cuda.blend_forward(fields.detach(), binned, rcfg)
        t.mark("blend_forward (B1)")
        o_leaf = o.requires_grad_(True)
        loss = refined_sugar.photometric(o_leaf[:3] + o_leaf[3][None] * bg[:, None, None], gt,
                                         cfg)
        (g_out,) = torch.autograd.grad(loss, o_leaf)
        t.mark("loss + SSIM, forward and backward")
        rows = blend_cuda.blend_backward(fields.detach(), binned, rcfg, o.detach(),
                                         g_out.contiguous())
        t.mark("blend_backward (B2)")
        dfields = sum_rows_by_gaussian(rows, binned.inst_gauss, fields.shape[0])
        t.mark("reduction (sorted segment sum)")
        d_act = torch.autograd.grad(fields, act_l, dfields, allow_unused=True)
        t.mark("preprocess backward")
        used = [(a, d) for a, d in zip(act, d_act) if d is not None and a.requires_grad]
        grads = torch.autograd.grad([a for a, _ in used], list(leaves.values()),
                                    [d for _, d in used])
        t.mark("activation backward")
        opt.step(groups, dict(zip(leaves, grads)), state, torch.isfinite(loss.detach()))
        t.mark("Adam")
        runs.append(t.parts())
    runs = runs[1:]
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    parts["sum of parts"] = sum(parts.values())
    parts["instances"] = int(binned.num_instances)
    parts["overflow"] = bool(binned.overflow)
    parts["train_step"] = cuda_ms(lambda: refined_sugar.train_step(
        params, state, meta, cam, gt, opt, rcfg, cfg), 5)
    log(f"refined-SuGaR step at {MAIN_W}x{MAIN_H}, {params.opacities_raw.shape[0]} Gaussians: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" ms ({1e3 / parts['train_step']:.2f} it/s)")
    if parts["overflow"]:
        raise AssertionError("the refined-SuGaR step overflowed its instance capacity")
    held = "the refined-SuGaR step's blend inputs"
    with torch.no_grad():
        errs = {"blend_forward": compare(held, fields.detach(), binned, rcfg)}
        errs["blend_backward"], parts["b2_against_float64"] = compare_backward_float64(
            held, fields.detach(), binned, rcfg, g_out.contiguous(), vs_plain=None)
    return parts, errs


def phase_refined_sugar(tmp, sugar_ply, shell_lowpoly_ply):
    """stages_cli train-refined-sugar in process on the frosting phase's
    8-view scene, stage 3's 1M-Gaussian sphere as sugar.ply and its 200k-
    vertex budget mesh (shell_lowpoly.ply) as shell.ply, at 6 Gaussians per
    triangle for RS_ITERS iterations: B1 = B2 = iterations, no overflow,
    every value finite, refined_sugar.npz loading back to the trained model
    bitwise and refined_sugar.ply loading, the mean PSNR over the 8 views
    RS_PSNR_GAIN above the initialised model's; then a step part by part,
    and B1 and B2 held on its blend inputs. Returns (launches, results)."""
    scene_dir = os.path.join(tmp, "frosting_scene")
    out = os.path.join(tmp, "refined_sugar")
    os.makedirs(out)
    shutil.copy(sugar_ply, os.path.join(out, "sugar.ply"))
    shutil.copy(shell_lowpoly_ply, os.path.join(out, "shell.ply"))
    common = ["-s", scene_dir, "-o", out, "--max-instances", str(STAGE_MAX_INSTANCES),
              "--device", DEV]
    res, launches, secs, peak = _counted(
        ["train-refined-sugar", *common, "--iterations", str(RS_ITERS),
         "--gaussians-per-triangle", str(RS_PER_TRIANGLE)])
    trained, meta = res["trained"]
    hist = res["history"]
    n = trained.opacities_raw.shape[0]
    results = {"command_s": secs, "peak_gib": peak, "timings_ms": res["timings_ms"],
               "history": hist, "gaussians": n, "faces": int(meta.faces.shape[0])}
    log(f"train-refined-sugar ({meta.faces.shape[0]} faces, {n} Gaussians, {RS_ITERS} "
        f"iterations): {secs:.1f} s, peak {peak:.2f} GiB, launches {launches}; parts (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["timings_ms"].items()))
    log("  " + "; ".join(f"it {h['iter']} loss {h['loss']:.4f} psnr {h['psnr']:.2f} "
                         f"{h['iters_per_s']:.2f} it/s, overflow steps {h['overflow_steps']}"
                         for h in hist))
    want = {"blend_forward": RS_ITERS, "blend_backward": RS_ITERS}
    if launches != want:
        raise AssertionError(f"train-refined-sugar launched {launches}, not {want}")
    if n != RS_PER_TRIANGLE * meta.faces.shape[0]:
        raise AssertionError(f"train-refined-sugar made {n} Gaussians")
    if not all(np.isfinite(h["loss"]) and not h["overflow"] and h["overflow_steps"] == 0
               for h in hist):
        raise AssertionError(f"train-refined-sugar: a non-finite loss or an overflow: {hist}")
    groups = refined_sugar.param_groups(trained)
    if not all(torch.isfinite(t).all() for t in groups.values()):
        raise AssertionError("the refined-SuGaR model has non-finite values")
    back = checkpoint.load_npz(os.path.join(out, "refined_sugar.npz"), device=DEV,
                               cls=mesh_bound_lib.MeshBoundParams)
    if not all(torch.equal(getattr(back, k), t) for k, t in groups.items()):
        raise AssertionError("refined_sugar.npz does not load back to the trained model")
    ply = ply_io.read_ply(os.path.join(out, "refined_sugar.ply"))["vertex"]
    if not (len(ply["x"]) == n and all(np.isfinite(ply[k]).all() for k in ply)):
        raise AssertionError("refined_sugar.ply does not load back")
    args = stages_cli.build_parser().parse_args(["render", *common])
    _scene, scams, gt, rcfg = stages_cli._load_scene(args)
    # the command's initial model, made again from the same files
    coarse = stages_cli.load_live_gaussians(os.path.join(out, "sugar.ply"), device=DEV)
    init, _m = pipeline_lib.init_refined_sugar(*stages_cli.load_mesh(os.path.join(
        out, "shell.ply")), coarse.means3d, coarse, RS_PER_TRIANGLE, DEV)
    del coarse
    with torch.no_grad():
        before, before_v = _mean_psnr(mesh_bound_lib.activate_mesh_bound(init, meta),
                                      scams, gt, rcfg)
        after, after_v = _mean_psnr(mesh_bound_lib.activate_mesh_bound(trained, meta),
                                    scams, gt, rcfg)
    results["psnr_init"], results["psnr_refined"] = before_v, after_v
    log(f"refined SuGaR: mean PSNR over the {len(scams)} views: init {before:.3f} dB, "
        f"refined {after:.3f} dB (gain {after - before:.3f}, required {RS_PSNR_GAIN})")
    if not after >= before + RS_PSNR_GAIN:
        raise AssertionError("refined SuGaR did not raise the mean PSNR by the margin")
    del init, back, res
    torch.cuda.empty_cache()
    results["step_ms"], results["max_abs_err"] = refined_step_timings(
        trained, meta, scams[0], gt[0], rcfg)
    return launches, results


def blender_camera():
    """A Blender camera matrix_world (column-vector, looking down its -Z,
    +Y up) at BLENDER_EYE, looking at the origin with +Z up."""
    eye = np.asarray(BLENDER_EYE, np.float64)
    z = eye / np.linalg.norm(eye)  # backward
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(z, x), z, eye
    return m.tolist()


def write_blender_package(path, tpose):
    """One armatured mesh (the shell, tpose [V, 3]) with two bones: "fixed"
    (the identity) and "bend", which turns the upper hemisphere about the x
    axis by up to BLENDER_MAX_DEG degrees over BLENDER_FRAMES frames, its
    weight ramping from 0 to 1 over |z| < BLENDER_BAND; a static camera at
    MAIN_W x MAIN_H. The per-vertex lists are formatted as JSON text with
    %.9g (every float32 value read back exactly), the rest by json."""
    b = np.clip((tpose[:, 2] + BLENDER_BAND) / (2 * BLENDER_BAND), 0.0, 1.0).astype(np.float32)
    eye = np.eye(4).tolist()
    poses = []
    for t in range(BLENDER_FRAMES):
        a = math.radians(BLENDER_MAX_DEG) * t / (BLENDER_FRAMES - 1)
        m = np.eye(4)
        m[1:3, 1:3] = [[math.cos(a), -math.sin(a)], [math.sin(a), math.cos(a)]]
        poses.append(m.tolist())
    v = len(tpose)
    lists = {
        "@tpose@": ("[%.9g,%.9g,%.9g]," * v) % tuple(tpose.astype(np.float64).ravel().tolist()),
        "@groups@": '["fixed","bend"],' * v,
        "@weights@": ("[%.9g,%.9g]," * v) % tuple(
            np.stack([1.0 - b, b], 1).astype(np.float64).ravel().tolist()),
    }
    package = {
        "camera": {"lens": [50.0] * BLENDER_FRAMES, "sensor_width": 36.0, "width": MAIN_W,
                   "height": MAIN_H, "matrix_world": [blender_camera()] * BLENDER_FRAMES},
        "bones": [{
            "vertex": {"tpose_points": "@tpose@", "groups": "@groups@", "weights": "@weights@",
                       "matrix_world": eye},
            "armature": {"rest_bones": {"fixed": eye, "bend": eye},
                         "pose_bones": {"fixed": [eye] * BLENDER_FRAMES, "bend": poses}},
        }],
    }
    text = json.dumps(package)
    for key, body in lists.items():
        text = text.replace(f'"{key}"', "[" + body[:-1] + "]")
    with open(path, "w") as fh:
        fh.write(text)
    return package["camera"]


def phase_blender(tmp):
    """python -m frosting_tpu_torch.blender_cli, in process, on
    phase_frosting's frosting.npz and a package written here
    (write_blender_package: the 1M-vertex shell, two bones, 4 frames at
    1920x1080), twice: the complex adaptation with --occlusion-culling, and
    --adaptation simple. Each: B1 launched once per frame (B2 never), no
    overflow, every frame a finite, non-constant PNG, the last pose moving
    the image; frame 0 (the identity pose) equal, on >= 99.9% of the pixels
    and within one level on all (B1's rule at 8 bits), to the render of the
    same model from the package's camera in process: for the simple run
    the direct render of frosting.npz; for the complex run adapt_frosting
    at the identity (its least-squares cell transforms, regularised by
    1e-8 as in JAX, are not the identity in cells whose corners span
    ~1e-4: that render's distance to the direct one is logged) with the
    cells the camera sees. The masked Gaussians and each frame's
    adaptation, SVD and render (CUDA events) are logged. Returns (launches
    per run, results)."""
    npz = os.path.join(tmp, "frosting", "frosting.npz")
    params, meta = checkpoint.load_frosting(npz, device=DEV)
    pkg = os.path.join(tmp, "package.json")
    t0 = time.perf_counter()
    camera = write_blender_package(pkg, params.shell_verts.cpu().numpy())
    results = {"package_write_s": time.perf_counter() - t0,
               "package_mb": os.path.getsize(pkg) / 1e6}
    log(f"blender package of {params.shell_verts.shape[0]} vertices: "
        f"{results['package_mb']:.1f} MB written in {results['package_write_s']:.1f} s")
    cam = blender_cli.package_camera({"raw": {"camera": camera}}, 0, MAIN_W, MAIN_H, DEV)
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)

    def png_of(image):
        return (np.clip(image.cpu().numpy(), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)

    with torch.inference_mode():
        model = list(frosting_lib.to_gaussians(params, meta))
        direct = png_of(render(*model, cam, rcfg).image)
        pf = mesh_raster.rasterize_mesh(params.shell_verts, meta.faces, cam, rcfg).pix_to_face
        seen = torch.zeros(meta.faces.shape[0] + 1, dtype=torch.bool, device=DEV)
        seen[pf[pf >= 0]] = True
        seen = seen[meta.cell_idx].to(model[3].dtype)
        model[3] = model[3] * seen
        direct_culled = png_of(render(*model, cam, rcfg).image)
        eg = editing_lib.adapt_frosting(params, meta, params.shell_verts)
        adapted = png_of(editing_lib.render_edited(
            eg._replace(opacities=eg.opacities * seen), cam, rcfg).image)
    d = np.abs(adapted.astype(np.int16) - direct_culled.astype(np.int16))
    results["identity_adaptation_vs_direct"] = {"equal_share": float((d == 0).mean()),
                                                "max_levels": int(d.max())}
    log(f"the complex adaptation at the identity pose against the direct render (both culled): "
        f"{(d == 0).mean():.6f} of the pixels equal, max difference {int(d.max())} levels")
    del pf, seen, eg, model
    launches = {}
    for label, extra, want in (("complex_culled", ["--occlusion-culling"], adapted),
                               ("simple", ["--adaptation", "simple"], direct)):
        out = os.path.join(tmp, f"frames_{label}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = blender_cli.main(["--package", pkg, "--checkpoints", npz, "--out", out,
                                "--max-instances", str(STAGE_MAX_INSTANCES), "--device", DEV,
                                *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[label] = {"blend_forward": blend_cuda.blend_forward.launches,
                           "blend_backward": blend_cuda.blend_backward.launches}
        frames = res["frames"]
        log(f"blender_cli {' '.join(extra)}: {secs:.1f} s for {len(frames)} frames, launches "
            f"{launches[label]}, culled capacity {res['culled_capacity']}; per frame: "
            + "; ".join(f"{f['frame']}: adapt {f['adapt_ms']:.1f} ms (SVD {f['svd_ms']:.1f}), "
                        f"render {f['render_ms']:.1f} ms, {f['instances']} instances, "
                        f"masked {f['masked']}" for f in frames))
        if launches[label] != {"blend_forward": BLENDER_FRAMES, "blend_backward": 0}:
            raise AssertionError(f"blender_cli {label} launched {launches[label]}")
        if len(frames) != BLENDER_FRAMES or any(f["overflow"] or f["instances"] <= 0
                                                for f in frames):
            raise AssertionError(f"blender_cli {label}: a frame overflowed or is empty")
        imgs = [image_io.read_image(os.path.join(out, f"frame_{i:05d}.png"))
                for i in range(BLENDER_FRAMES)]
        if any(mode != "RGB" or img.std() < 1.0 for img, mode in imgs):
            raise AssertionError(f"blender_cli {label}: a frame is not an RGB image")
        first, last = imgs[0][0], imgs[-1][0]
        diff = np.abs(first.astype(np.int16) - want.astype(np.int16))
        moved = float(np.abs(last.astype(np.int16) - first.astype(np.int16)).mean())
        log(f"  frame 0 against the in-process render: {(diff == 0).mean():.6f} of the pixels "
            f"equal, max difference {int(diff.max())} levels; the last frame differs from "
            f"frame 0 by {moved:.3f} levels on average")
        if not ((diff == 0).mean() >= 0.999 and diff.max() <= 1 and moved > 0.1):
            raise AssertionError(f"blender_cli {label}: frame 0 is not the in-process render, "
                                 "or the pose moved nothing")
        results[label] = {"command_s": secs, "frames": frames,
                          "culled_capacity": res["culled_capacity"],
                          "frame0_equal_share": float((diff == 0).mean())}
    return launches, results


def _psnr8(got, src):
    mse = float(np.mean((got.astype(np.float64) - src) ** 2))
    return 10 * math.log10(255.0**2 / max(mse, 1e-12))


def encode_format(i, rgb):
    """View i of FORMATS as file bytes, written without PIL; for the
    arithmetic-coded view also the Huffman-coded file of the same
    coefficients (else None)."""
    if i == 0:
        return image_encode.tiff(rgb, 2, "deflate", predictor=True, rows_per_strip=64), None
    if i == 1:
        return image_encode.tiff(rgb, 2, "lzw", tile=(256, 256)), None
    if i == 2:
        return image_encode.bmp(rgb, 24), None
    if i == 3:
        return image_encode.bmp(rgb, 32, top_down=True, header=124,
                                masks=(0xFF0000, 0xFF00, 0xFF, 0)), None
    if i == 4:  # C, M, Y as Pillow returns them: the view; K = 255 composites as opaque
        cmyk = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
        return image_encode.jpeg(cmyk, "ycck"), None
    if i == 5:
        return image_encode.jpeg(rgb, "ycc", ((4, 1), (1, 1), (1, 1))), None
    if i == 6:
        huffman = image_encode.jpeg(rgb)
        return image_encode.jpeg_arithmetic(huffman, progressive=True), huffman
    return image_encode.jpeg_lossless(rgb, 7), None


def phase_formats(tmp, scene_dir):
    """The formats path: the stages scene's 8 PNG views re-encoded, one
    format each (FORMATS), as a second COLMAP scene with the same cameras
    and points; each view decoded (host clock) and held to its source
    (lossless views bitwise, lossy ones above JPEG_PSNR, the
    arithmetic-coded one bitwise equal to its Huffman-coded twin); every
    lossless view's ground truth, as the loader gives it, bitwise the PNG
    scene's; then stages_cli train-gs on it in process at 1920x1080
    (FORMATS_GS_ITERS iterations; B1 and B2 once an iteration, the counts'
    rise over the command: nothing else launches them beside stage 3's
    QEM), and B1 and B2 held against their plain versions on its model's
    first view. Returns (launches, results, max abs errors)."""
    fmt_dir, out = os.path.join(tmp, "formats_scene"), os.path.join(tmp, "formats_out")
    os.makedirs(os.path.join(fmt_dir, "images"))
    os.makedirs(out)
    shutil.copytree(os.path.join(scene_dir, "sparse"), os.path.join(fmt_dir, "sparse"))
    images_bin = os.path.join(fmt_dir, "sparse", "0", "images.bin")
    with open(images_bin, "rb") as fh:
        poses = fh.read()
    res = {"bytes": {}, "encode_s": {}, "decode_ms": {}, "psnr": {}}
    for i, (name, what, lossless) in enumerate(FORMATS):
        png = f"img_{i:03d}.png"
        poses = poses.replace(png.encode() + b"\x00", name.encode() + b"\x00")
        src, _mode = image_io.read_image(os.path.join(scene_dir, "images", png))
        t0 = time.perf_counter()
        body, twin = encode_format(i, src)
        res["encode_s"][name] = time.perf_counter() - t0
        path = os.path.join(fmt_dir, "images", name)
        with open(path, "wb") as fh:
            fh.write(body)
        got, mode = image_io.read_image(path)
        res["decode_ms"][name] = host_ms(lambda: image_io.read_image(path), 3)
        res["bytes"][name] = len(body)
        res["psnr"][name] = _psnr8(got[..., :3], src)
        log(f"formats: {name} ({what}): {len(body)} bytes, encoded in "
            f"{res['encode_s'][name]:.2f} s, decoded in {res['decode_ms'][name]:.1f} ms "
            f"(host clock, median of 3), {mode} {got.shape}, PSNR against its source "
            f"{res['psnr'][name]:.2f} dB")
        if lossless:
            ok = mode == "RGB" and np.array_equal(got, src)
        elif mode == "CMYK":
            ok = bool((got[..., 3] == 255).all()) and res["psnr"][name] >= JPEG_PSNR
        else:
            ok = mode == "RGB" and res["psnr"][name] >= JPEG_PSNR
        if twin is not None:
            ok = ok and np.array_equal(got, image_io.decode(twin)[0])
        if not ok:
            raise AssertionError(f"formats: {name} ({what}) is not its source")
    with open(images_bin, "wb") as fh:
        fh.write(poses)

    png_scene = dataset_lib.load_colmap_scene(scene_dir, eval_split=False, device=DEV)
    t0 = time.perf_counter()
    fmt_scene = dataset_lib.load_colmap_scene(fmt_dir, eval_split=False, device=DEV)
    gts = {c.image_name: c.image() for c in fmt_scene.train_cameras}
    res["scene_load_ms"] = (time.perf_counter() - t0) * 1e3
    for (name, what, lossless), cam in zip(FORMATS, png_scene.train_cameras):
        want = cam.image()
        got = gts[name]
        if lossless and not (got.dtype == want.dtype and np.array_equal(got, want)):
            raise AssertionError(f"formats: {name}'s ground truth differs from the PNG's")
        if not lossless and not (got.shape == want.shape and np.isfinite(got).all()):
            raise AssertionError(f"formats: {name}'s ground truth is not a {want.shape} image")
    del png_scene, fmt_scene, gts
    log(f"formats: the scene's 8 ground truths loaded in {res['scene_load_ms']:.0f} ms; the "
        "lossless views' bitwise the PNG scene's")

    common = ["-s", fmt_dir, "-o", out, "--max-instances", str(STAGE_MAX_INSTANCES),
              "--device", DEV]
    before = (blend_cuda.blend_forward.launches, blend_cuda.blend_backward.launches)
    t0 = time.perf_counter()
    hist = stages_cli.main(["train-gs", *common, "--iterations", str(FORMATS_GS_ITERS),
                            "--capacity", str(TRAIN_CAPACITY)])
    torch.cuda.synchronize()
    res["train_gs_s"] = time.perf_counter() - t0
    launches = {"blend_forward": blend_cuda.blend_forward.launches - before[0],
                "blend_backward": blend_cuda.blend_backward.launches - before[1]}
    log(f"formats: train-gs {res['train_gs_s']:.1f} s ({FORMATS_GS_ITERS} iterations, the "
        f"scene's decode included); "
        + "; ".join(f"it {h['iter']} loss {h['loss']:.4f}" for h in hist)
        + f"; launches {launches} (predicted {FORMATS_GS_ITERS} each)")
    if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hist):
        raise AssertionError(f"formats: train-gs, a non-finite loss or an overflow: {hist}")
    if launches != {"blend_forward": FORMATS_GS_ITERS, "blend_backward": FORMATS_GS_ITERS}:
        raise AssertionError(f"formats: train-gs launched {launches}")
    res["launches"] = launches

    args = stages_cli.build_parser().parse_args(["render", *common])
    _scene, scams, _gt, srcfg = stages_cli._load_scene(args)
    live = gauss_lib.activate(stages_cli.load_live_gaussians(
        os.path.join(out, "gs.ply"), device=DEV))
    with torch.inference_mode():
        fields, binned = blend_inputs(live, scams[0], srcfg)
        errs = {"blend_forward": compare("formats view 0", fields, binned, srcfg),
                "blend_backward": compare_backward("formats view 0", fields, binned, srcfg)}
    del live, fields, binned, _scene, _gt
    return launches, res, errs


def write_sphere_scene(tmp):
    """The coloured sphere (sphere_raw(MAIN_N)) rendered by B1 from the 8
    stage views as a COLMAP scene: stages 4-6 and the pipeline paths run on
    it. Returns its directory."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in STAGE_ORBITS]
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    scene_dir = os.path.join(tmp, "frosting_scene")
    t0 = time.perf_counter()
    with torch.inference_mode():
        sphere = gauss_lib.activate(gauss_lib.params_from_numpy(sphere_raw(MAIN_N), device=DEV))
        synthetic.write_colmap_scene(scene_dir, sphere, cams, rcfg)
        del sphere
    log(f"the coloured sphere's COLMAP scene ({len(cams)} views at {MAIN_W}x{MAIN_H}) written "
        f"in {time.perf_counter() - t0:.1f} s")
    return scene_dir


def write_cli_scene(src, dst, n_points):
    """The scene src (its images and poses) with its point cloud cut to the
    sphere's first n_points means, coloured as the sphere."""
    shutil.copytree(os.path.join(src, "images"), os.path.join(dst, "images"))
    sparse = os.path.join(dst, "sparse", "0")
    os.makedirs(sparse)
    for name in ("cameras.bin", "images.bin"):
        shutil.copy(os.path.join(src, "sparse", "0", name), sparse)
    raw = sphere_raw(MAIN_N)
    synthetic.write_points3d(sparse, raw["means3d"][:n_points], raw["sh_dc"][:n_points, 0])
    return dst


class StageLog:
    """A run_pipeline log_fn: logs each line and keeps, at each stage line
    ("=== ... ==="), the kernels' counts' rise since the log was made and
    the time."""

    def __init__(self):
        self.start = counts_now()
        self.marks = []

    def __call__(self, line):
        log(f"  {line}")
        if line.startswith("==="):
            self.marks.append((line.strip("= "), rise(self.start), time.perf_counter()))

    def launches_by_stage(self):
        """{stage line: (B1, B2) launched until the next stage line, or now}."""
        ends = [m[1] for m in self.marks[1:]] + [rise(self.start)]
        return {m[0]: tuple(b - a for a, b in zip(m[1], e)) for m, e in zip(self.marks, ends)}


def counts_now():
    return (blend_cuda.blend_forward.launches, blend_cuda.blend_backward.launches)


def rise(before):
    """(B1, B2) launched since the counts were `before`: work that runs
    beside another phase reads its launches this way and never resets the
    counts, which the other phase's check reads."""
    return tuple(a - b for a, b in zip(counts_now(), before))


def reset_counts():
    blend_cuda.blend_forward.launches = 0
    blend_cuda.blend_backward.launches = 0


def _read_back(out_dir, n_gaussians, n_verts, n_faces):
    """Every file the CLI writes, read back by the port's loaders; returns
    the metrics.json it holds."""
    for name in ("gs.ply", "sugar.ply"):
        if os.path.exists(os.path.join(out_dir, name)):
            p = gauss_lib.load_ply(os.path.join(out_dir, name), device="cpu")
            if not (p.capacity > 0 and torch.isfinite(p.means3d).all()):
                raise AssertionError(f"{name} does not load back")
    v, f = stages_cli.load_mesh(os.path.join(out_dir, "shell.ply"))
    if (len(v), len(f)) != (n_verts, n_faces):
        raise AssertionError(f"shell.ply: {len(v)} vertices, {len(f)} faces")
    ply = ply_io.read_ply(os.path.join(out_dir, "frosting.ply"))["vertex"]
    if not (len(ply["x"]) == n_gaussians and all(np.isfinite(ply[k]).all() for k in ply)):
        raise AssertionError(f"frosting.ply: {len(ply['x'])} Gaussians")
    (nv, nvt, nf), obj_v = obj_counts(os.path.join(out_dir, "mesh.obj"))
    if not (nv == n_verts and nf == n_faces and nvt == 3 * n_faces
            and np.isfinite(obj_v).all()):
        raise AssertionError(f"mesh.obj: {nv} v, {nvt} vt, {nf} f lines")
    for name in ("mesh.mtl", "mesh.png"):
        if not os.path.getsize(os.path.join(out_dir, name)):
            raise AssertionError(f"{name} is empty")
    with open(os.path.join(out_dir, "metrics.json")) as fh:
        return json.load(fh)


def _held_out_psnr(model, scene, rcfg):
    cam = scene.test_cameras[0]
    gt = torch.from_numpy(cam.image()).to(DEV)
    with torch.inference_mode():
        return float(psnr(torch.clamp(render(*model, cam.camera, rcfg).image, 0.0, 1.0), gt))


def phase_pipelines(tmp, scene_dir, weights):
    """The pipeline paths on the coloured sphere's scene: (1) cli.main
    --tiny --eval --export-obj, all six stages fresh; (2) the config cli
    builds for --eval --export-obj (1080p, 7 train views, capacity 2^19, 2M
    Frosting Gaussians; the iterations cut) through run_pipeline with a
    cache whose shell.npz holds a 1M-vertex UV sphere, then the cli's
    writer; (3) a second run_pipeline from that cache, bitwise equal; (4)
    LPIPS (weights: the npz FROSTING_TPU_LPIPS_WEIGHTS names) on the
    held-out view on the card and, in a process of its own, on the CPU; (5)
    stages_cli convert without colmap, in a process of its own; (6) a 1080p
    baseline JPEG decoded and timed. It runs beside the first stage-3 run's
    host QEM, so it changes no state of this process that the QEM reads
    (the kernels' counts, the peak memory statistics, the thread count,
    the environment): each path's launches are the counts' rise over it.
    Returns (launches per path, results)."""
    launches, res = {}, {}
    root = os.path.dirname(os.path.abspath(__file__))
    # (1) the entry point unchanged, --tiny
    tiny_scene = write_cli_scene(scene_dir, os.path.join(tmp, "cli_tiny", "sphere"),
                                 CLI_TINY_POINTS)
    out_tiny = os.path.join(tmp, "cli_tiny_out")
    stamp("cli --tiny (six stages fresh)")
    torch.cuda.synchronize()
    before = counts_now()
    t0 = time.perf_counter()
    out, tiny_metrics = cli.main(["-s", tiny_scene, "-o", out_tiny, "--tiny", "--eval",
                                  "--export-obj"])
    torch.cuda.synchronize()
    launches["cli_tiny"] = dict(zip(("blend_forward", "blend_backward"), rise(before)))
    args = cli.build_parser().parse_args(["-s", tiny_scene, "--tiny"])
    tcfg = cli.build_config(args, 1.0)
    n_test = -(-len(STAGE_ORBITS) // 8)  # --eval holds out every 8th view
    n_train = len(STAGE_ORBITS) - n_test
    sugar_iters = tcfg.sugar.iterations - tcfg.sugar.start_iteration + 1
    steps = tcfg.gs.iterations + sugar_iters + tcfg.refine.iterations
    want = {"blend_forward": steps + n_train + n_train + n_test, "blend_backward": steps}
    back = _read_back(os.path.join(out_tiny, "sphere"), tcfg.frosting.n_gaussians,
                      len(out["shell_verts"]), len(out["shell_faces"]))
    res["cli_tiny"] = {"command_s": time.perf_counter() - t0, "metrics": tiny_metrics,
                       "shell_verts": len(out["shell_verts"]),
                       "sugar_kept": out["sugar_history"][-1]["n_active"]}
    log(f"cli --tiny: {res['cli_tiny']['command_s']:.1f} s, launches {launches['cli_tiny']} "
        f"(predicted {want}: 3DGS {tcfg.gs.iterations} + SuGaR {sugar_iters} + refinement "
        f"{tcfg.refine.iterations} steps, stage 3 and the bake once per train view, metrics once "
        f"per test view), shell {len(out['shell_verts'])} vertices, metrics {tiny_metrics}")
    if launches["cli_tiny"] != want:
        raise AssertionError(f"cli --tiny launched {launches['cli_tiny']}, not {want}")
    if not (back == tiny_metrics and tiny_metrics["n_views"] == 1
            and all(np.isfinite(tiny_metrics[k]) for k in ("psnr", "ssim", "lpips"))):
        raise AssertionError(f"cli --tiny: metrics.json {back}")
    del out

    # (2) the full-width pipeline through run_pipeline and the cli's writer
    stamp("the full-width pipeline (stage 3 resumed from shell.npz)")
    full_scene = write_cli_scene(scene_dir, os.path.join(tmp, "cli_full", "sphere"), CLI_POINTS)
    args = cli.build_parser().parse_args(
        ["-s", full_scene, "-o", os.path.join(tmp, "cli_full_out"), "--eval", "--export-obj",
         "--max-instances", str(STAGE_MAX_INSTANCES)])
    scene, cams, gt, rcfg, out_dir = cli.load_scene(args)
    cfg = cli.build_config(args, scene.spatial_extent)
    cfg = dataclasses.replace(
        cfg, gs=dataclasses.replace(cfg.gs, iterations=PIPE_GS_ITERS),
        sugar=dataclasses.replace(cfg.sugar, start_iteration=PIPE_SUGAR[0],
                                  iterations=PIPE_SUGAR[1]),
        refine=dataclasses.replace(cfg.refine, iterations=PIPE_REFINE_ITERS,
                                   lr_max_steps=PIPE_REFINE_ITERS))
    cache = os.path.join(tmp, "pipeline_cache")
    os.makedirs(cache)
    verts, faces = synthetic.uv_sphere(UV_LAT, UV_LON)
    np.savez(os.path.join(cache, "shell.npz"), verts=verts, faces=faces,
             poisson_res=np.zeros(0, np.int64))
    parts = PartTimes(DEV)
    torch.cuda.synchronize()
    stages = StageLog()
    t0 = time.perf_counter()
    out = pipeline_lib.run_pipeline(cams, gt, scene.points, scene.colors,
                                    scene.spatial_extent, rcfg, cfg, cache_dir=cache,
                                    log_fn=stages, device=DEV, parts=parts)
    torch.cuda.synchronize()
    by_stage = stages.launches_by_stage()
    run_s = time.perf_counter() - t0
    before = counts_now()
    metrics_full = cli.write_outputs(args, out, scene, cams, rcfg, out_dir, parts)
    torch.cuda.synchronize()
    by_stage["exports, bake and metrics"] = rise(before)
    full = {"run_pipeline_s": run_s, "s_by_part": {k: v / 1e3 for k, v in parts.result().items()},
            "launches": by_stage, "metrics": metrics_full}
    res["pipeline_full_width"] = full
    launches["pipeline_full_width"] = dict(zip(
        ("blend_forward", "blend_backward"),
        (sum(v[i] for v in by_stage.values()) for i in range(2))))
    sugar_iters = PIPE_SUGAR[1] - PIPE_SUGAR[0] + 1
    want = {"stage 1: vanilla 3DGS": (PIPE_GS_ITERS, PIPE_GS_ITERS),
            "stage 2: coarse SuGaR": (sugar_iters, sugar_iters),
            "stage 3: resumed from cache": (0, 0), "stage 4: frosting init": (0, 0),
            "stage 5: frosting refinement": (PIPE_REFINE_ITERS, PIPE_REFINE_ITERS),
            "exports, bake and metrics": (len(cams) + len(scene.test_cameras), 0)}
    fparams, meta = out["frosting_params"], out["frosting_meta"]
    n = fparams.bary_logits.shape[0]
    log(f"full-width pipeline: {len(cams)} train views at {rcfg.width}x{rcfg.height}, "
        f"{len(scene.points)} points, capacity {cfg.gs.capacity}, {n} Frosting Gaussians on "
        f"{len(verts)} shell vertices: run_pipeline {run_s:.1f} s; seconds by part " + ", ".join(f"{k} {v:.2f}" for k, v in full["s_by_part"].items())
        + f"; launches by stage {by_stage} (predicted {want}); metrics {metrics_full}")
    if by_stage != want:
        raise AssertionError(f"the full-width pipeline launched {by_stage}, not {want}")
    if n != FROSTING_N:
        raise AssertionError(f"the full-width pipeline built {n} Frosting Gaussians")
    hists = out["gs_history"] + out["sugar_history"] + out["refine_history"]
    if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hists) or any(
            h["overflow_steps"] for h in out["refine_history"]):
        raise AssertionError(f"the full-width pipeline: a non-finite loss or an overflow {hists}")
    init, init_meta = checkpoint.load_frosting(os.path.join(cache, "frosting_init.npz"),
                                               device=DEV)
    psnr_init = _held_out_psnr(frosting_lib.to_gaussians(init, init_meta), scene, rcfg)
    full["psnr_held_out_init"] = psnr_init
    log(f"held-out PSNR: init {psnr_init:.3f} dB, refined {metrics_full['psnr']:.3f} dB")
    if not (np.isfinite(metrics_full["psnr"]) and metrics_full["psnr"] > psnr_init):
        raise AssertionError("the refined model's held-out PSNR is not above the init's")
    back = _read_back(out_dir, FROSTING_N, len(verts), len(faces))
    loaded, _ = checkpoint.load_frosting(os.path.join(out_dir, "frosting.npz"), device=DEV)
    if not (back == metrics_full and _groups_equal(loaded, fparams)):
        raise AssertionError("metrics.json or frosting.npz does not read back")
    del init, init_meta, loaded

    # (3) resume parity: a second run from the cache, now holding all three
    stamp("the full-width pipeline resumed from its cache")
    stages = StageLog()
    t0 = time.perf_counter()
    again = pipeline_lib.run_pipeline(cams, gt, scene.points, scene.colors,
                                      scene.spatial_extent, rcfg, cfg, cache_dir=cache,
                                      log_fn=stages, device=DEV)
    torch.cuda.synchronize()
    resumed = [m[0] for m in stages.marks]
    before_refine = stages.marks[-1][1]
    in_all = rise(stages.start)
    equal = _groups_equal(again["frosting_params"], fparams)
    res["pipeline_resumed"] = {"s": time.perf_counter() - t0, "bitwise_equal": equal,
                               "lines": resumed}
    launches["pipeline_resumed"] = dict(zip(("blend_forward", "blend_backward"), in_all))
    log(f"resumed run: {res['pipeline_resumed']['s']:.1f} s, stage lines {resumed}, launches "
        f"before stage 5 {before_refine}, in all {launches['pipeline_resumed']}; refined params "
        f"{'bitwise equal to' if equal else 'DIFFER from'} the first run's")
    if resumed != ["stages 1-2: resumed from cache", "stage 3: resumed from cache",
                   "stage 4: resumed from cache", "stage 5: frosting refinement"]:
        raise AssertionError(f"the rerun did not resume stages 1-4: {resumed}")
    if before_refine != (0, 0) or in_all != (PIPE_REFINE_ITERS, PIPE_REFINE_ITERS):
        raise AssertionError("the rerun launched a kernel before stage 5, or not once a step")
    if not equal:
        raise AssertionError("the resumed refinement differs from the first run's")
    del again

    # (4) LPIPS on the held-out 1080p view: the card against the CPU
    stamp("LPIPS at 1080p, the card against the CPU")
    with torch.inference_mode():
        cam = scene.test_cameras[0]
        img = torch.clamp(render(*frosting_lib.to_gaussians(fparams, meta), cam.camera,
                                 rcfg).image, 0.0, 1.0)
        gt0 = torch.from_numpy(cam.image()).to(DEV)
        lp = metrics_lib.LPIPS(weights, device=DEV)
        on_card = float(lp(img, gt0))
        lpips_ms = cuda_ms(lambda: lp(img, gt0), 5)
        pair = [os.path.join(tmp, f"lpips_{k}.npy") for k in ("img", "gt")]
        for path, t in zip(pair, (img, gt0)):
            np.save(path, t.cpu().numpy())
    # the CPU's value in a process of its own, on 4 threads: the stage-3
    # QEM's threads share the host, and this process's thread count is theirs
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-c", _LPIPS_CPU_CODE, weights, *pair], cwd=root,
                          capture_output=True, text=True, timeout=600)
    cpu_s = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"LPIPS on the CPU failed: {done.stderr[-2000:]}")
    on_cpu = float(done.stdout.split()[-1])
    res["lpips"] = {"card": on_card, "cpu": on_cpu, "card_ms": lpips_ms, "cpu_s": cpu_s,
                    "metrics_json": metrics_full["lpips"]}
    log(f"LPIPS (seeded VGG16-shaped weights) at {MAIN_W}x{MAIN_H}: card {on_card:.7g} "
        f"({lpips_ms:.2f} ms, CUDA events, median of 5), CPU {on_cpu:.7g} ({cpu_s:.1f} s, a "
        f"process of its own on 4 threads, its start included), metrics.json "
        f"{metrics_full['lpips']:.7g}; rtol {LPIPS_RTOL}")
    for v in (on_card, metrics_full["lpips"]):
        if not abs(v - on_cpu) <= LPIPS_RTOL * abs(on_cpu):
            raise AssertionError(f"LPIPS on the card {v} against the CPU's {on_cpu}")
    del out, fparams, meta, img, lp

    # (5) convert without colmap: a process of its own, whose PATH is an
    # empty directory (this process's PATH stays the QEM's)
    done = subprocess.run(
        [sys.executable, "-m", "frosting_tpu_torch.stages_cli", "convert", "-s",
         os.path.join(tmp, "raw")], cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PATH": os.path.join(tmp, "no_colmap")})
    message = done.stderr.strip().splitlines()[-1:]
    if done.returncode != 1 or message != [CONVERT_MESSAGE]:
        raise AssertionError(f"convert without colmap: exit {done.returncode}, {done.stderr}")
    log("stages_cli convert without colmap exits with the JAX package's message")

    # (6) a 1080p baseline JPEG: the held-out view through the Annex K tables
    src, _mode = image_io.read_image(scene.test_cameras[0].image_path)
    t0 = time.perf_counter()
    data = image_encode.jpeg(src)
    enc_s = time.perf_counter() - t0
    jpg = os.path.join(tmp, "view.jpg")
    with open(jpg, "wb") as fh:
        fh.write(data)
    got, mode = image_io.read_image(jpg)
    decode_ms = host_ms(lambda: image_io.read_image(jpg), 5)
    jpeg_psnr = _psnr8(got, src)
    res["jpeg"] = {"bytes": len(data), "decode_ms": decode_ms, "encode_s": enc_s,
                   "psnr": jpeg_psnr}
    log(f"JPEG: the held-out view as a {len(data)}-byte baseline 4:2:0 JPEG (numpy encoder, "
        f"{enc_s:.1f} s); decode {decode_ms:.1f} ms (host clock, median of 5), {mode} "
        f"{got.shape}, PSNR against its source {jpeg_psnr:.2f} dB (required {JPEG_PSNR})")
    if not (mode == "RGB" and got.shape == src.shape and jpeg_psnr >= JPEG_PSNR):
        raise AssertionError("the decoded JPEG is not its source")
    return launches, res


# The sharded path (phase_parallel): 1920 x 1088, whole 16-row tiles for 2
# or 4 strips (1080 is not a multiple of 16; the JAX package does not pad).
PAR_H = 1088
PAR_BG = 65_536  # background Gaussians added to the pipeline's Frosting init
PAR_SDF_SAMPLES = 200_000  # SugarTrainConfig's default, split over the ranks
PAR_TIMEOUT_S = 900
# Launches per rank (B1, B2), one strip per rank and step: the world of one
# runs the replicated 3DGS step twice; each gloo rank the replicated step
# twice, shard_params once, three more and one after the densify (5), the
# 1 x 4 all-gather and exchange steps (2), a SuGaR step per phase (3) and
# one depth strip (B1 only), and the Frosting step replicated and with
# shard_params (2).
PAR_LAUNCHES = {"nccl_1x1": (2, 2), "gloo_2x2": (2 + 5 + 2 + 3 + 1 + 2, 2 + 5 + 2 + 3 + 2)}


def _start_entry(argv, log_path):
    """Start argv (the parallel entry point, or torchrun over it) in a
    process group of its own, its output to log_path."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as fh:
        return subprocess.Popen(argv, cwd=root, stdout=fh, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)


def _finish_entry(label, proc, log_path, deadline):
    """Wait for a _start_entry process until the deadline (perf_counter
    seconds), killing its whole group past it; log its output. Returns the
    exit code."""
    try:
        return proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise
    finally:
        with open(log_path) as fin:
            for line in fin.read().splitlines():
                if not ("socket.cpp" in line or line.startswith("[W")):
                    log(f"  [{label}] {line}")


def phase_parallel(tmp, model, frosting_init):
    """The sharded path on the card through its entry point (python -m
    frosting_tpu_torch.parallel): a world of one NCCL rank (the 3DGS step on a
    1 x 1 mesh against gs_trainer.train_step) and, at the same time, four
    gloo ranks on the one card (torchrun; every check at 1920 x 1088: 3DGS at 1M Gaussians,
    replicated 2 x 2 against the single-process batch-mean step, shard_params
    against replicated, densify, the 1 x 4 exchange; SuGaR's three phases
    and depth strips; Frosting at 2M with background Gaussians on the
    pipeline path's frosting_init.npz). B1 and B2 are held against their
    plain versions on a middle strip's blend inputs first. Four ranks on one
    card over gloo measure correctness and cost, not scaling. Returns
    (launches per run and rank, results, max abs error per kernel)."""
    from frosting_tpu_torch.parallel.sharded_train import strip_config
    from frosting_tpu_torch.raster.preprocess import shift_projected

    res, launches = {}, {}
    # B1 and B2 on strip 1 of 4 of the 1M scene at 1920 x 1088
    full = RasterConfig(width=MAIN_W, height=PAR_H, chunk=128, max_instances=STAGE_MAX_INSTANCES)
    s_cfg = strip_config(full, 4)
    cam = viewer._orbit_camera(*TRAIN_ORBITS[0], ORBIT_R, device=DEV)
    with torch.no_grad():
        proj = shift_projected(preprocess(*model, cam, full), (0, s_cfg.height), s_cfg)
        binned = bin_gaussians(proj.rect, proj.depths, proj.valid, s_cfg)
        fields = pack_fields(proj)
    label = f"strip 1 of 4 ({MAIN_W}x{s_cfg.height} of {MAIN_W}x{PAR_H})"
    max_err = {"blend_forward": compare(label, fields, binned, s_cfg),
               "blend_backward": compare_backward(label, fields, binned, s_cfg)}
    del proj, binned, fields
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"parallel: the card's free memory before the ranks start {free / 2**30:.2f} of "
        f"{total / 2**30:.2f} GiB")
    common = ["--device", "cuda", "--width", str(MAIN_W), "--height", str(PAR_H),
              "--gaussians", str(MAIN_N), "--jitter", str(TRAIN_JITTER),
              "--max-instances", str(STAGE_MAX_INSTANCES),
              "--sdf-samples", str(PAR_SDF_SAMPLES)]
    entry = [sys.executable, "-m", "frosting_tpu_torch.parallel"]
    runs = {
        "nccl_1x1": entry + [*common, "--backend", "nccl", "--mesh", "1x1", "--checks", "gs"],
        "gloo_2x2": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                     "--nproc-per-node", "4", "-m", "frosting_tpu_torch.parallel", *common,
                     "--backend", "gloo", "--mesh", "2x2", "--checks", "all",
                     "--frosting-init", frosting_init, "--background", str(PAR_BG)],
    }
    # both runs at once: the world of one is short, and the gloo ranks spend
    # most of theirs on the host (start-up, scene, the all-reduce's copies)
    stamp("parallel: the NCCL world of one and the four gloo ranks")
    t0 = time.perf_counter()
    procs = {name: _start_entry(argv + ["--out", os.path.join(tmp, f"parallel_{name}.json")],
                                os.path.join(tmp, f"parallel_{name}.log"))
             for name, argv in runs.items()}
    codes = {}
    try:
        for name, proc in procs.items():
            codes[name] = _finish_entry(name, proc, os.path.join(tmp, f"parallel_{name}.log"),
                                        t0 + PAR_TIMEOUT_S)
            res.setdefault(name, {})["command_s"] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for name in runs:
        out = os.path.join(tmp, f"parallel_{name}.json")
        secs = res[name]["command_s"]
        if codes[name] != 0 or not os.path.exists(out):
            raise AssertionError(f"parallel {name}: exit {codes[name]}")
        with open(out) as fh:
            report = json.load(fh)
        if report["failed"]:
            raise AssertionError(f"parallel {name}: {report['failed']}")
        ranks = report["parallel"]
        res[name]["ranks"] = ranks
        want = dict(zip(("blend_forward", "blend_backward"), PAR_LAUNCHES[name]))
        for r in ranks:
            log(f"parallel {name} rank {r['rank']} ({r['backend']}, mesh {r['mesh']}): "
                f"{r['seconds']:.1f} s, peak {r.get('peak_gib', 0):.2f} GiB, free at start "
                f"{r.get('free_gib_at_start', 0):.2f} GiB, launches {r['launches']} "
                f"(predicted {want})")
            for step, entry_ in r["data"].items():
                ms = entry_.get("ms", {})
                coll = entry_.get("collectives", {})
                log(f"  rank {r['rank']} {step}: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in ms.items()) + " ms; collectives " + ", ".join(
                    f"{k} {v}" for k, v in coll.items() if k.endswith("bytes")))
            if r["launches"] != want:
                raise AssertionError(f"parallel {name} rank {r['rank']}: launches "
                                     f"{r['launches']}, predicted {want}")
        launches[name] = want
        log(f"parallel {name}: {secs:.1f} s from the start of both runs to its end; rank 0's "
            "checks:")
        for step, entry_ in ranks[0]["data"].items():
            held = {k: v for k, v in entry_.items()
                    if k not in ("ms", "collectives", "launches", "parity")}
            log(f"  {step}: {json.dumps(held)}")
    log("parallel: four ranks on one card over gloo measure correctness and cost, not "
        "scaling (they share one card and copy every collective through host memory; the "
        "world of one runs beside them)")
    return launches, res, max_err


# The multi-device pipeline (phase_pipeline_multichip): stages 1-5 with the
# sharded stages 1, 2 and 5, python -m frosting_tpu_torch.parallel.pipeline.
PMC_TIMEOUT_S = 900
# (a) full width, a world of one NCCL rank: the bench scene's 1M Gaussians
# over 8 views at 1920 x 1088, iterations cut to 20 / 20 / 20 (from 150 /
# 100 / 150), Poisson 256^3 and a 200k target, 2M Frosting Gaussians
PMC_FULL_ITERS = (20, 20, 20)
PMC_FULL_CAPACITY = 1 << 20
PMC_FULL_POISSON, PMC_FULL_TARGET = 256, 200_000
# (b) the script's own mesh and shapes: 8 gloo ranks on the card, 2 x 4 at
# 128^2, its 150 / 100 / 150 iterations. The known answers of the JAX
# package's run (PIPELINE_MC.json: 8 virtual CPU devices): stage 1's first
# loss 0.1036 (rounded to four digits; the scene, the init and the first
# batch are the same numpy draws), eval PSNR 36.08 dB, 8192 / 8 rows a chip
PMC_JAX_LOSS_FIRST, PMC_LOSS_FIRST_TOL = 0.1036, 1e-4
PMC_PSNR_MIN = 34.0  # dB
PMC_ROWS = 1024
PMC_RANKS = 8
# Launches per rank and stage (B1, B2): the ground truth's 8 views and 3
# held-out views once each; one B1 and one B2 a step of stages 1, 2
# (density: no depth strip) and 5; on rank 0 one B1 a view in stage 3's
# extraction (8) and a held-out view in the eval (3).


def pmc_launches(iters, rank):
    n1, n2, n5 = iters
    zero = [0, 0]
    return {"scene": [11, 0], "gs_sharded": [n1, n1], "sugar_sharded": [n2, n2],
            "shell": [8, 0] if rank == 0 else zero, "frosting_init": zero,
            "refine_sharded": [n5, n5], "eval": [3, 0] if rank == 0 else zero}


def _check_losses(label, name, losses, phases=None, may_rise=()):
    """Finite, and the mean of the last 10 below the first: stage 2 per
    phase, since its sdf terms join the loss at the switch; a phase named
    in may_rise ("stage" or "stage phase") is logged only."""
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label} {name}: a loss is not finite")
    runs = [(None, losses)]
    if phases:
        runs = [(ph, [v for v, p in zip(losses, phases) if p == ph])
                for ph in dict.fromkeys(phases)]
    for ph, vals in runs:
        last = float(np.mean(vals[-10:]))
        part = name if ph is None else f"{name} {ph}"
        log(f"  {label} {part}: {len(vals)} iterations, loss first {vals[0]!r}, last-10 mean "
            f"{last!r}")
        if part not in may_rise and not last < vals[0]:
            raise AssertionError(f"{label} {part}: the loss did not fall")


def phase_pipeline_multichip(tmp):
    """The pipeline entry point in processes of its own, two runs at once:
    (a) a world of one NCCL rank at full width and (b) eight gloo ranks
    on the card on the script's 2 x 4 mesh at its shapes. B1 and B2 are held
    against their plain versions on (b)'s strip shape first (the blob
    scene at 128^2, 32 x 16 tiles, strip 1 of 4). Every rank's launches per
    stage as predicted, the replicated and broadcast tensors' digests equal
    on every rank, stage 1's first step held against the single-process
    step, finite losses that fall (but full width's sdf phase), (b) against
    the JAX run's known answers. Returns (launches per run and rank, results, max abs error per
    kernel)."""
    from frosting_tpu_torch.parallel.sharded_train import strip_config
    from frosting_tpu_torch.raster.preprocess import shift_projected

    small = RasterConfig(width=128, height=128, tile_w=32, tile_h=16, chunk=32,
                         max_instances=1 << 15)
    s_cfg = strip_config(small, 4)
    gt = synthetic.gaussian_blob_scene(n=3000, seed=0, device=DEV)
    cam = synthetic.camera_ring(n_cams=8, radius=3.0, device=DEV)[0]
    with torch.no_grad():
        proj = shift_projected(preprocess(*gt, cam, small), (0, s_cfg.height), s_cfg)
        binned = bin_gaussians(proj.rect, proj.depths, proj.valid, s_cfg)
        fields = pack_fields(proj)
    label = "strip 1 of 4 (128x32 of 128x128, 32x16 tiles)"
    max_err = {"blend_forward": compare(label, fields, binned, s_cfg),
               "blend_backward": compare_backward(label, fields, binned, s_cfg)}
    del proj, binned, fields, gt
    entry = ["-m", "frosting_tpu_torch.parallel.pipeline"]
    full = ["--backend", "nccl", "--mesh", "1x1", "--width", str(MAIN_W), "--height",
            str(PAR_H), "--tile-w", "16", "--tile-h", "16", "--chunk", "128",
            "--max-instances", str(STAGE_MAX_INSTANCES), "--scene", "bench",
            "--scene-gaussians", str(MAIN_N), "--jitter", str(TRAIN_JITTER),
            "--capacity", str(PMC_FULL_CAPACITY),
            *[f for flag, n in zip(("--gs-iters", "--sugar-iters", "--refine-iters"),
                                   PMC_FULL_ITERS) for f in (flag, str(n))],
            "--sdf-samples", str(PAR_SDF_SAMPLES), "--poisson-resolution",
            str(PMC_FULL_POISSON), "--target-vertices", str(PMC_FULL_TARGET),
            "--frosting-gaussians", str(FROSTING_N)]
    # (run, its iterations, the losses that need not fall: at full width
    # the 12 sdf iterations on a random cube of tiny Gaussians rose from
    # 0.3242 to 0.3310; there stage 1's first step is held against
    # gs_trainer.train_step, as in every run)
    runs = {
        "nccl_1x1_full": ([sys.executable, *entry, *full], PMC_FULL_ITERS,
                          ("sugar_sharded sdf",)),
        "gloo_2x4_script": ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc-per-node", str(PMC_RANKS), *entry, "--backend", "gloo",
                             "--mesh", "2x4"], (150, 100, 150), ()),
    }
    stamp("the multi-device pipeline: the NCCL world of one at full width and the eight "
          "gloo ranks at the script's shapes")
    t0 = time.perf_counter()
    procs = {}
    for name, (argv, _iters, _may_rise) in runs.items():
        extra = ["--out", os.path.join(tmp, f"pmc_{name}.json"),
                 "--report", os.path.join(tmp, f"pmc_{name}_ranks.json")]
        procs[name] = _start_entry(argv + extra, os.path.join(tmp, f"pmc_{name}.log"))
    codes, res, launches = {}, {}, {}
    try:
        for name, proc in procs.items():
            codes[name] = _finish_entry(name, proc, os.path.join(tmp, f"pmc_{name}.log"),
                                        t0 + PMC_TIMEOUT_S)
            res[name] = {"command_s": time.perf_counter() - t0}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for name, (_argv, iters, may_rise) in runs.items():
        out = os.path.join(tmp, f"pmc_{name}.json")
        ranks_path = os.path.join(tmp, f"pmc_{name}_ranks.json")
        if codes[name] != 0 or not (os.path.exists(out) and os.path.exists(ranks_path)):
            raise AssertionError(f"pipeline {name}: exit {codes[name]}")
        with open(out) as fh:
            result = json.load(fh)
        with open(ranks_path) as fh:
            rep = json.load(fh)
        if rep["failed"]:
            raise AssertionError(f"pipeline {name}: {rep['failed']}")
        ranks = rep["pipeline_ranks"]
        log(f"pipeline {name}: {res[name]['command_s']:.1f} s from the start of both runs to "
            f"its end; {json.dumps(result)}")
        for r in ranks:
            want = pmc_launches(iters, r["rank"])
            got = {k: v["launches"] for k, v in r["stages"].items()}
            for stage, v in r["stages"].items():
                log(f"  rank {r['rank']} {stage}: {v['seconds']:.2f} s, launches "
                    f"{v['launches']} (predicted {want[stage]}), peak "
                    f"{v.get('peak_gib', 0):.2f} GiB; ms a step " + ", ".join(
                        f"{k} {x:.2f}" for k, x in v["ms_per_step"].items()) + "; collectives "
                    + ", ".join(f"{k} {x}" for k, x in v["collectives"].items()
                                if k.endswith("bytes")))
            if got != want:
                raise AssertionError(f"pipeline {name} rank {r['rank']}: launches {got}, "
                                     f"predicted {want}")
            if r["digests"] != ranks[0]["digests"]:
                raise AssertionError(f"pipeline {name} rank {r['rank']}: a replicated or "
                                     "broadcast tensor differs from rank 0's")
        s0 = ranks[0]["stages"]
        held = s0["gs_sharded"].get("first_step")
        if not (held and held["ok"]):
            raise AssertionError(f"pipeline {name}: stage 1's first step against the "
                                 f"single-process step: {held}")
        log(f"  pipeline {name} stage 1's first step against the single-process step: loss "
            f"{s0['gs_sharded']['losses'][0]!r} / {held['reference_loss']!r} (rel. "
            f"{held['loss_rel_err']:.2e}), update cosine {held['update_cosine']!r}, values off "
            + ", ".join(f"{g} {v['fraction_off']:.2e}" for g, v in held["parity"].items()))
        for stage in ("gs_sharded", "sugar_sharded", "refine_sharded"):
            _check_losses(f"pipeline {name}", stage, s0[stage]["losses"],
                          s0[stage].get("phases"), may_rise)
        n_ranks = len(ranks)
        rows = result["stages"]["refine_sharded"]["param_shard_rows_per_chip"]
        if rows * n_ranks != result["stages"]["frosting_init"]["n_gaussians"]:
            raise AssertionError(f"pipeline {name}: {rows} rows a rank")
        if not math.isfinite(result["eval_psnr"]):
            raise AssertionError(f"pipeline {name}: eval PSNR {result['eval_psnr']}")
        tot = [sum(v["launches"][i] for v in s0.values()) for i in (0, 1)]
        launches[name] = {"rank0": tot, "other_ranks": [
            sum(v["launches"][i] for v in ranks[-1]["stages"].values()) for i in (0, 1)]}
        res[name].update(result=result, stage_s=[
            {k: v["seconds"] for k, v in r["stages"].items()} for r in ranks])
    b = res["gloo_2x4_script"]["result"]
    first = b["stages"]["gs_sharded"]["loss_first"]
    log(f"pipeline gloo_2x4_script against PIPELINE_MC.json (JAX): stage-1 first loss "
        f"{first!r} (JAX {PMC_JAX_LOSS_FIRST}, within {PMC_LOSS_FIRST_TOL}), eval PSNR "
        f"{b['eval_psnr']!r} dB (required {PMC_PSNR_MIN}), rows a rank "
        f"{b['stages']['refine_sharded']['param_shard_rows_per_chip']} (JAX {PMC_ROWS})")
    if not (abs(first - PMC_JAX_LOSS_FIRST) <= PMC_LOSS_FIRST_TOL
            and b["eval_psnr"] >= PMC_PSNR_MIN
            and b["stages"]["refine_sharded"]["param_shard_rows_per_chip"] == PMC_ROWS
            and b["mesh"] == "2x4"):
        raise AssertionError("pipeline gloo_2x4_script: not the JAX run's known answers")
    return launches, res, max_err


def pmc_launch(frosting_launches, run, which, kernel):
    return frosting_launches["pipeline_multichip"][run][which][
        ("blend_forward", "blend_backward").index(kernel)]


def hold_learned_shell(params, meta, cam, gt, rcfg):
    """Two learned-shell, regularised refinement steps at full width from one
    state (the offsets' gradient through the cell corners' and the normal
    consistency's fixed-order gathers): bitwise equal parameters and Adam
    moments (mu = 0.1 g: equal moments, equal gradients)."""
    cfg = frosting_trainer.FrostingTrainConfig(learn_shell=True, regularize_shell=True)
    nc = mesh_ops.pair_incidence(torch.from_numpy(mesh_ops.adjacent_face_pairs(
        meta.faces.cpu().numpy())).to(DEV), meta.faces.shape[0])
    gt = torch.from_numpy(gt).to(DEV)
    out = []
    for _ in range(2):
        p = frosting_trainer.with_groups(params, {k: t.detach().clone() for k, t in
                                                  frosting_trainer.param_groups(params).items()})
        opt = frosting_trainer.make_frosting_optimizer(cfg, TRAIN_EXTENT,
                                                       background=p.bg is not None)
        state = opt.init(frosting_trainer.param_groups(p))
        frosting_trainer.train_step(p, state, meta, cam, gt, torch.ones(
            p.bary_logits.shape[0], device=DEV), opt, rcfg, cfg, 3, nc)
        out.append((frosting_trainer.param_groups(p), state))
    (ga, sa), (gb, sb) = out
    same = all(torch.equal(ga[k], gb[k]) for k in ga) and all(
        torch.equal(sa.mu[k], sb.mu[k]) and torch.equal(sa.nu[k], sb.nu[k]) for k in sa.mu)
    moved = float((ga["outer_dist"] - params.outer_dist).abs().max())
    log(f"two learned-shell refinement steps from one state: parameters and moments "
        f"{'bitwise equal' if same else 'DIFFER'} (offsets moved by up to {moved:.3e})")
    if not (same and moved > 0):
        raise AssertionError("a learned-shell refinement step is not bitwise reproducible")
    return same


def hold_sdf_samples(params):
    """The sdf step's draw (sugar_lib.sample_sdf_points at the trainer's
    sample count, every Gaussian visible) twice with one seed: bitwise equal
    points, Gaussians and neighbour sets."""
    means, scales, quats, _o, _sh = (t.detach() for t in gauss_lib.activate(params))
    knn_idx = sugar_trainer.compute_knn(params)
    n = sugar_trainer.SugarTrainConfig().n_sdf_samples
    draws = [sugar_lib.sample_sdf_points(
        means, scales, quats, knn_idx, torch.ones_like(means[:, 0], dtype=torch.bool), n,
        generator=torch.Generator(device=DEV).manual_seed(7)) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*draws))
    log(f"two sdf draws of {n} samples over {means.shape[0]} Gaussians with one seed: "
        f"{'bitwise equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("the sdf step's samples are not bitwise reproducible")
    return same


def hold_corner_blend(params, meta):
    """The corner blend's backward at full width: two calls bitwise equal,
    and against autograd through the plain gather (corners[cell_idx] and a
    weighted sum) to 1e-5 of each output's largest magnitude."""
    corners = frosting_lib.cell_corners(params, meta.faces, meta.incidence).detach()
    logits = params.bary_logits.detach()
    g = torch.randn((logits.shape[0], 3), generator=torch.Generator(device=DEV).manual_seed(0),
                    device=DEV)

    def grads(plain):
        w = torch.softmax(logits, -1).requires_grad_(True)
        c = corners.clone().requires_grad_(True)
        if plain:
            m = torch.sum(w[..., None] * c[meta.cell_idx], dim=1)
        else:
            m = frosting_lib.CornerBlend.apply(w, c, meta.cell_idx, meta.cell_bounds)
        return torch.autograd.grad(m, [w, c], g)

    first, second, plain = grads(False), grads(False), grads(True)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    errs = [float(((a - p).abs() / p.abs().max().clamp_min(1e-30)).max())
            for a, p in zip(first, plain)]
    plain_again = grads(True)
    plain_same = all(torch.equal(a, b) for a, b in zip(plain, plain_again))
    log(f"corner blend backward at {logits.shape[0]} rows: two calls "
        f"{'bitwise equal' if same else 'DIFFER'}; against the plain gather (normalised) "
        f"d_w {errs[0]:.3e}, d_corners {errs[1]:.3e}; the plain gather's two calls "
        f"{'equal' if plain_same else 'differ'}")
    if not same or max(errs) > 1e-5:
        raise AssertionError("the corner blend's backward is not reproducible or disagrees")
    return {"bitwise": same, "max_err_normalised": errs, "plain_bitwise": plain_same}


def frosting_step_timings(params, meta, cam, gt, rcfg, rcfg_culled, vis):
    """A refinement step at full width part by part (CUDA events between
    the parts, median of FROSTING_STEP_REPS after a warm-up), cut where
    frosting_trainer.train_step passes from one part to the next, on the
    full view (rcfg) and on the same view culled by its visibility mask
    (rcfg_culled, the culled run's derived capacity); then the whole
    train_step of each (CUDA events, median of 5); then B1 and B2 held
    against their plain versions on each view's blend inputs, B2 with the
    loss's cotangent. Returns (the times, the max abs errors)."""
    cfg = frosting_trainer.FrostingTrainConfig()
    opt = frosting_trainer.make_frosting_optimizer(cfg, TRAIN_EXTENT)
    state = opt.init(frosting_trainer.param_groups(params))
    corners = frosting_trainer.frozen_corners(params, meta, opt)
    gt = torch.from_numpy(gt).to(DEV)
    bg = torch.zeros(3, device=DEV)
    out, errs = {}, {}
    for label, mask, view_cfg in (("full", torch.ones_like(vis), rcfg),
                                  ("culled", vis, rcfg_culled)):
        runs = []
        for _ in range(FROSTING_STEP_REPS + 1):
            groups = frosting_trainer.param_groups(params)
            leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
            p = frosting_trainer.with_groups(params, leaves)
            t = Timer()
            t.mark("start")
            means, scales, quats, opac, sh = frosting_lib.activate_frosting(p, meta, corners)
            act = (means, scales, quats, opac * mask, sh)
            t.mark("corner blend + activation")
            act_l = [a.detach().requires_grad_(True) for a in act]
            proj = preprocess(*act_l, cam, view_cfg, active_sh_degree=3)
            fields = pack_fields(proj)
            t.mark("preprocess")
            binned = bin_gaussians(proj.rect, proj.depths, proj.valid, view_cfg)
            t.mark("binning")
            o = blend_cuda.blend_forward(fields.detach(), binned, view_cfg)
            t.mark("blend_forward (B1)")
            o_leaf = o.requires_grad_(True)
            loss = frosting_trainer.photometric(o_leaf[:3] + o_leaf[3][None] * bg[:, None, None],
                                                gt, cfg)
            (g_out,) = torch.autograd.grad(loss, o_leaf)
            t.mark("loss + SSIM, forward and backward")
            rows = blend_cuda.blend_backward(fields.detach(), binned, view_cfg, o.detach(),
                                             g_out.contiguous())
            t.mark("blend_backward (B2)")
            dfields = sum_rows_by_gaussian(rows, binned.inst_gauss, fields.shape[0])
            t.mark("reduction (sorted segment sum)")
            d_act = torch.autograd.grad(fields, act_l, dfields, allow_unused=True)
            t.mark("preprocess backward")
            used = [(a, d) for a, d in zip(act, d_act) if d is not None]
            grads = torch.autograd.grad([a for a, _ in used], list(leaves.values()),
                                        [d for _, d in used])
            t.mark("corner blend + activation backward")
            opt.step(groups, dict(zip(leaves, grads)), state, torch.isfinite(loss.detach()))
            t.mark("Adam")
            runs.append(t.parts())
        runs = runs[1:]
        parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        parts["sum of parts"] = sum(parts.values())
        parts["instances"] = int(binned.num_instances)
        parts["overflow"] = bool(binned.overflow)
        parts["train_step"] = cuda_ms(lambda: frosting_trainer.train_step(
            params, state, meta, cam, gt, mask, opt, view_cfg, cfg, 3, None, corners), 5)
        out[label] = parts
        log(f"refinement step at {MAIN_W}x{MAIN_H}, {params.bary_logits.shape[0]} Gaussians, "
            f"{label}: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f" ms ({1e3 / parts['train_step']:.2f} it/s), max_instances "
            f"{view_cfg.max_instances}")
        held = f"the refinement step's blend inputs, {label} view"
        with torch.no_grad():
            errs[label] = {
                "blend_forward": compare(held, fields.detach(), binned, view_cfg),
                "blend_backward": compare_backward(held, fields.detach(), binned, view_cfg,
                                                   plain_chunk=64, g=g_out.contiguous())}
        del fields, binned, o, o_leaf, g_out, rows, dfields
        torch.cuda.empty_cache()
    return out, errs


def stages_timings(gs_path, scene, gt0):
    """compute_knn at 1M and one SuGaR step per phase and method, part by
    part (CUDA events, median of 5 after a warm-up), on the 1M model and
    view 0; then B1 and B2 on a dn_consistency depth render's inputs."""
    cam = scene.train_cameras[0].camera
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    params = gauss_lib.load_ply(gs_path, capacity=TRAIN_CAPACITY, device=DEV)
    knn_runs = [timed(lambda: sugar_trainer.compute_knn(params), DEV)[0] for _ in range(3)]
    knn_idx = sugar_trainer.compute_knn(params)
    log(f"compute_knn at {MAIN_N} live of {TRAIN_CAPACITY}, k 16: "
        f"{', '.join(f'{t:.1f}' for t in knn_runs)} ms (CUDA events, three calls)")
    opt = opt_lib.make_gs_optimizer(scene.spatial_extent)
    opt_state = opt.init(params)
    gen = torch.Generator(device=DEV).manual_seed(0)
    steps = {}
    for method in SUGAR_METHODS:
        cfg = sugar_trainer.SugarTrainConfig(method=method, spatial_extent=scene.spatial_extent)
        for phase in (("photo", "entropy", "sdf") if method == "density" else ("sdf",)):
            runs = []
            for _ in range(6):
                t = Timer()
                t.mark("start")
                sugar_trainer.train_step(params, opt_state, cam, gt0, knn_idx, opt, rcfg, cfg,
                                         3, phase, generator=gen, mark=t.mark)
                runs.append(t.parts())
            runs = runs[1:]
            parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            parts["step"] = statistics.median(sum(r.values()) for r in runs)
            label = f"{method}/{phase}" if phase == "sdf" else phase
            steps[label] = parts
            log(f"SuGaR step {label} at {MAIN_W}x{MAIN_H}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()) + " ms (median of 5)")
    hold = hold_depth_render(params, cam, rcfg)
    return {"knn_ms": knn_runs, "sugar_step_ms": steps, **hold,
            "sdf_samples_bitwise": hold_sdf_samples(params)}


def hold_depth_render(params, cam, rcfg):
    """B1 and B2 against their plain versions on the blend inputs of the
    depth render of a dn_consistency step (colours are depths of ~3-4), B2
    with the cotangent the loss gives it: through depth / acc and acc = 1 -
    t_final, every covered pixel's transmittance row is nonzero."""
    means, scales, quats, opac, _sh = (t.detach() for t in gauss_lib.activate(params))
    depth_colors, normals = sugar_lib.depth_normal_colors(means, scales, quats, cam)
    no_sh = torch.zeros_like(means[:, None])
    proj = preprocess(means, scales, quats, opac, no_sh, cam, rcfg,
                      colors_precomp=depth_colors)
    fields = pack_fields(proj)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
    out_d = blend_cuda.blend_forward(fields, binned, rcfg).requires_grad_(True)
    with torch.no_grad():
        normal_img = render(means, scales, quats, opac, no_sh, cam, rcfg,
                            colors_precomp=normals).image
    acc = 1.0 - out_d[3]
    depth_map = out_d[0] / torch.clamp(acc, min=1e-6)
    normal_map = normal_img / torch.clamp(acc, min=1e-6)[None]
    loss = sugar_lib.dn_consistency_loss(depth_map, normal_map, acc, cam, rcfg)
    (g_out,) = torch.autograd.grad(loss, out_d)
    out_d = out_d.detach()
    label = "a dn_consistency depth render's inputs"
    nz = int((g_out[3] != 0).sum())
    colours = fields[binned.inst_gauss.long(), 6]
    log(f"{label}: instance colours in [{float(colours.min()):.3f}, "
        f"{float(colours.max()):.3f}], {nz} pixels with a nonzero transmittance cotangent")
    if nz == 0:
        raise AssertionError("the depth render gave B2 no transmittance cotangent")
    with torch.inference_mode():
        err_f = compare(label, fields, binned, rcfg)
        err_b, held = compare_backward_float64(label, fields, binned, rcfg, g_out.contiguous())
    return {"depth_render_max_abs_err": {"blend_forward": err_f, "blend_backward": err_b},
            "depth_render_b2_against_float64": held}


def phase_preamble(raw):
    """Paths 3-7: the kernels against their plain versions, serving,
    training, timing at 1080p and the bench path, on `raw` (the 1M scene).
    They run first in the thread beside the first stage-3 run's host QEM
    (phase_stages), where nothing else uses the card; each path's launches
    are the counts' rise over it. Returns what the kernels record reads."""
    # 3. kernels vs plain versions
    stamp("kernels against their plain versions")
    max_err = {"blend_forward": 0.0, "blend_backward": 0.0}

    def check(label, fields, binned, cfg, plain_chunk=None):
        max_err["blend_forward"] = max(
            max_err["blend_forward"], compare(label, fields, binned, cfg))
        max_err["blend_backward"] = max(
            max_err["blend_backward"],
            compare_backward(label, fields, binned, cfg, plain_chunk))

    with torch.inference_mode():
        phase_small_reference()
    gs = on_card(bench_scene(100_000, 0, -0.7, 0.7, 0.008, 0.04))
    cam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0, 0, 0], device=DEV)
    with torch.inference_mode():
        cfg512, _ = autotuned_config(gs, cam, 1 << 21, width=512, height=512)
        fields, binned = blend_inputs(gs, cam, cfg512)
        check("512x512 @ 100k", fields, binned, cfg512)
        ms512 = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg512), 10)
        plain512 = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg512), 3)
        log(f"512x512 @ 100k: kernel {ms512:.4f} ms, plain {plain512:.3f} ms")
    phase_render_gradients(gs, cam, cfg512)
    with torch.inference_mode():
        gs = on_card(bench_scene(20_000, 1, -0.7, 0.7, 0.008, 0.04))
        cfg_odd = RasterConfig(width=1000, height=600, max_instances=1 << 21)
        fields, binned = blend_inputs(gs, cam, cfg_odd)
        check("1000x600 @ 20k", fields, binned, cfg_odd)
        del gs, fields, binned
        fields, binned, cfg_adv = adversarial_blend_inputs(seed=0, device=DEV)
        check("adversarial 100x70, needles, a run of 12k", fields, binned, cfg_adv)
        del fields, binned

    # 4. serving path: gs.ply -> load_ply -> viewer at 1920x1080
    stamp("serving path")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gs.ply")
        t0 = time.time()
        gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), path)
        params = gauss_lib.load_ply(path, device=DEV)
        log(f"gs.ply: {os.path.getsize(path) / 1e6:.1f} MB written and "
            f"loaded in {time.time() - t0:.1f} s")
    with torch.inference_mode():
        model = gauss_lib.activate(params)
        cams, cfg = serving_views(model)
        fields, binned = blend_inputs(model, cams[0], cfg)
        # the plain backward's [tiles, pixels, chunk] temporaries at 1080p
        # take ~1 GB each at chunk 128: walk it 64 at a time
        check("1920x1080 @ 1M", fields, binned, cfg, plain_chunk=64)
        del fields, binned
        torch.cuda.empty_cache()

    before = counts_now()
    server = viewer.start(lambda: model, cfg, port=0, host="127.0.0.1", device=DEV)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        request_ms = []
        for az, el in ORBITS:
            t0 = time.perf_counter()
            status, body = get(base, f"/render?az={az}&el={el}&r={ORBIT_R}")
            request_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/render status {status}")
            img, mode = image_io.decode_png(body)
            if (mode, img.shape) != ("RGB", (MAIN_H, MAIN_W, 3)):
                raise AssertionError(f"the PNG is {mode} {img.shape}")
            if img.std() < 1.0:
                raise AssertionError("rendered image is constant")
        status, body = get(base, "/state")
        state = json.loads(body)
        if status != 200 or state != {"n_gaussians": MAIN_N}:
            raise AssertionError(f"/state: {status} {state}")
    finally:
        server.shutdown()
        server.server_close()
    serve_counts = dict(zip(("blend_forward", "blend_backward"), rise(before)))
    serve_launches = serve_counts["blend_forward"]
    log(f"viewer: 3 renders at {MAIN_W}x{MAIN_H} @ 1M, ms per request "
        f"{[round(t, 1) for t in request_ms]}, forward kernel launches "
        f"{serve_launches}, backward {serve_counts['blend_backward']}")
    if serve_launches < len(ORBITS):
        raise AssertionError("the serving path did not go through the kernel")

    # 5. training path at full width (max_instances far above the ground
    # truth's count: binning sizes its buffers to the views' real counts)
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128, max_instances=1 << 24)
    stamp("training path")
    state, tcams, gt_imgs, tcfg, launches = phase_training(model, rcfg)

    # 6. timing at 1080p @ 1M
    stamp("timing at 1080p")
    with torch.inference_mode():
        for c in cams:
            proj = preprocess(*model, c, cfg)
            if bool(bin_gaussians(proj.rect, proj.depths, proj.valid, cfg).overflow):
                raise AssertionError("instance overflow on the serving path")
        fields, binned = blend_inputs(model, cams[0], cfg)
        ms = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg), 10)
        plain_ms = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg), 3)
        render_ms = cuda_ms(lambda: render(*model, cams[0], cfg), 10)
        # where a render and a request spend their time
        pre_ms = cuda_ms(lambda: preprocess(*model, cams[0], cfg), 10)
        proj = preprocess(*model, cams[0], cfg)
        bin_ms = cuda_ms(
            lambda: bin_gaussians(proj.rect, proj.depths, proj.valid, cfg), 10
        )
        # each kernel's wrapper sorts the tiles before it launches
        order_ms = cuda_ms(lambda: blend_cuda.heaviest_first(binned.tile_ranges), 10)
        t0 = time.perf_counter()
        viewer.render_png(model, cams[0], cfg)
        png_ms = (time.perf_counter() - t0) * 1e3
        log(f"breakdown: preprocess {pre_ms:.3f} ms, binning {bin_ms:.3f} ms, "
            f"tile order (inside each of B1 and B2) {order_ms:.4f} ms, render "
            f"{render_ms:.3f} ms (device); render + PNG {png_ms:.1f} ms (host)")
        out = blend_cuda.blend_forward(fields, binned, cfg)
        g = torch.randn(out.shape, generator=torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
        ms_b = cuda_ms(lambda: blend_cuda.blend_backward(fields, binned, cfg, out, g), 10)
        plain_cfg = dataclasses.replace(cfg, chunk=64)
        plain_ms_b = cuda_ms(
            lambda: blend_backward_torch(fields, binned, plain_cfg, out, g), 3)
        serve = work(fields, binned, cfg)
        del fields, binned, out, g, proj
        torch.cuda.empty_cache()
    b_f, b_b = bounds(serve)
    log(f"{MAIN_W}x{MAIN_H} @ 1M: {serve['instances']} instances, {serve['pairs']} "
        f"pre-stop (instance, pixel) pairs, {serve['live']} live; B1 {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {fmt_bound(b_f)}; B2 {ms_b:.4f} ms, "
        f"plain {plain_ms_b:.3f} ms, bound {fmt_bound(b_b)}; whole render "
        f"{render_ms:.3f} ms")

    opt = opt_lib.make_gs_optimizer(TRAIN_EXTENT)
    gt0 = torch.from_numpy(gt_imgs[0]).to(DEV)
    parts, (f_s, b_s, o_s, g_s) = step_breakdown(
        state, opt, tcams[0], gt0, rcfg, tcfg, reps=5)
    step_ms = cuda_ms(lambda: gs_trainer.train_step(
        state, tcams[0], gt0, opt, rcfg, tcfg, tcfg.sh_degree), 5)
    log(f"train step at {MAIN_W}x{MAIN_H}, {int(state.params.num_active())} live "
        f"Gaussians of {TRAIN_CAPACITY}, {int(b_s.num_instances)} instances: "
        f"{step_ms:.3f} ms (CUDA events, median of 5), {1e3 / step_ms:.2f} it/s; "
        f"parts (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}")
    reproducible_grads("the train step's view, trained state",
                       gauss_lib.activate(state.params), tcams[0], rcfg,
                       lambda image, t_final: l1_loss(image, gt0))
    with torch.inference_mode():
        # the step's own blend inputs: the low-opacity, deep-run case
        label = "the train step's blend inputs"
        max_err["blend_forward"] = max(
            max_err["blend_forward"], compare(label, f_s, b_s, rcfg))
        max_err["blend_backward"] = max(
            max_err["blend_backward"],
            compare_backward(label, f_s, b_s, rcfg, plain_chunk=64, g=g_s))
        # the same launches back to back, without the step's host gaps
        ms_fs = cuda_ms(lambda: blend_cuda.blend_forward(f_s, b_s, rcfg), 10)
        ms_bs = cuda_ms(lambda: blend_cuda.blend_backward(f_s, b_s, rcfg, o_s, g_s), 10)
        plain_ms_fs = cuda_ms(lambda: blend_forward_torch(f_s, b_s, rcfg), 1)
        plain_ms_bs = cuda_ms(lambda: blend_backward_torch(
            f_s, b_s, dataclasses.replace(rcfg, chunk=64), o_s, g_s), 1)
        step = work(f_s, b_s, rcfg)
        reduction = phase_reduction(f_s, b_s, rcfg, o_s, g_s)
    s_f, s_b = bounds(step)
    log(f"the step's blend inputs alone: {step['instances']} instances, "
        f"{step['pairs']} pre-stop pairs, {step['live']} live; B1 {ms_fs:.4f} ms, "
        f"plain {plain_ms_fs:.3f} ms, bound {fmt_bound(s_f)}; B2 {ms_bs:.4f} ms, "
        f"plain {plain_ms_bs:.3f} ms, bound {fmt_bound(s_b)}")
    del f_s, b_s, o_s, g_s
    t = Timer()
    t.mark("start")
    gs_trainer.densify_step(state, torch.Generator(device=DEV).manual_seed(0),
                            TRAIN_EXTENT, tcfg, use_size_prune=True)
    t.mark("densify")
    log(f"densify step: {t.parts()['densify']:.3f} ms")
    del state, opt
    torch.cuda.empty_cache()

    # 7. the bench path: the probes held, then the entry points in process
    stamp("bench path")
    probe_err = hold_probes()
    bench_launches, bench_times = phase_bench()
    probe_records = probe_timings(probe_err, bench_times, bench_launches)
    bench_profiles()

    return types.SimpleNamespace(
        max_err=max_err, launches=launches, serve_counts=serve_counts,
        bench_launches=bench_launches, probe_records=probe_records,
        b_f=b_f, b_b=b_b, s_f=s_f, s_b=s_b, serve=serve, step=step, reduction=reduction,
        times_f=(ms, ms_fs), times_b=(ms_b, ms_bs),
        plain_f=(plain_ms, plain_ms_fs), plain_b=(plain_ms_b, plain_ms_bs))


def main():
    t_start = time.perf_counter()
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions' colour sums are batched matmuls: keep them FP32
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    log("device:", card, "|", torch.cuda.get_device_name(0),
        "| torch", torch.__version__, "cuda", torch.version.cuda)

    # 2. build
    t0 = time.time()
    logs = _build.build_all(
        blend_cuda.KERNELS + perf_vpu_dtype.KERNELS + perf_scan_variants.KERNELS)
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # 3-8. the stages path, with paths 3-7 (phase_preamble) run first beside
    # stage 3's host QEM
    raw = raw_params(bench_scene(MAIN_N, 0, -0.9, 0.9, 0.003, 0.015))
    with torch.inference_mode():
        model = gauss_lib.activate(gauss_lib.params_from_numpy(raw, device=DEV))
    stamp("stages path (stage 3; paths 3-7 and stages 1-2 beside its QEM; stages 4-6, "
          "editing)")
    pre, stage_launches, extract_launches, frosting_launches, stage_times = phase_stages(
        raw, model, phase_preamble)
    log(json.dumps({"stages": stage_times}))
    max_err = pre.max_err
    for errs in (stage_times["depth_render_max_abs_err"], stage_times["formats_max_abs_err"],
                 stage_times["parallel_max_abs_err"],
                 stage_times["pipeline_multichip_max_abs_err"],
                 *stage_times["frosting"]["max_abs_err"].values(),
                 stage_times["refined_sugar"]["max_abs_err"]):
        for name, err in errs.items():
            max_err[name] = max(max_err[name], err)

    def record(name, line, b, sb, times, plain):
        return {
            "name": name,
            "route": "cuda",
            "source": f"frosting_tpu_torch/csrc/{name}.cu",
            "replaces": f"frosting_tpu/raster/blend_pallas.py:{line}",
            # the training path's count; each main path's beside it
            "launches": pre.launches[name],
            "launches_by_path": {
                "serving": pre.serve_counts[name],
                "training": pre.launches[name],
                "bench": pre.bench_launches[name],
                "stages": stage_launches[name],
                "stages_formats": frosting_launches["formats"][name],
                "extract_shell": extract_launches[name],
                "frosting": frosting_launches["frosting"][name],
                "frosting_culled": frosting_launches["frosting_culled"][name],
                "extract_texture": frosting_launches["texture"][name],
                "train_refined_sugar": frosting_launches["refined_sugar"][name],
                "blender_cli_complex_culled": frosting_launches["blender_complex_culled"][name],
                "blender_cli_simple": frosting_launches["blender_simple"][name],
                "stages_cli_metrics": frosting_launches["stages_cli_metrics"][name],
                "cli_tiny": frosting_launches["cli_tiny"][name],
                "pipeline_full_width": frosting_launches["pipeline_full_width"][name],
                "pipeline_resumed": frosting_launches["pipeline_resumed"][name],
                # per rank: a world of one NCCL rank; each of four gloo ranks
                "parallel_nccl_1x1_rank": frosting_launches["parallel"]["nccl_1x1"][name],
                "parallel_gloo_2x2_rank": frosting_launches["parallel"]["gloo_2x2"][name],
                # the multi-device pipeline, per rank: the NCCL world of one at
                # full width; rank 0 and each of ranks 1-7 of the gloo 2 x 4
                "pipeline_mc_nccl_1x1_full_rank": pmc_launch(frosting_launches, "nccl_1x1_full",
                                                             "rank0", name),
                "pipeline_mc_gloo_2x4_rank0": pmc_launch(frosting_launches, "gloo_2x4_script",
                                                         "rank0", name),
                "pipeline_mc_gloo_2x4_other_ranks": pmc_launch(
                    frosting_launches, "gloo_2x4_script", "other_ranks", name),
            },
            "max_abs_err": max_err[name],
            # the serving view; *_step: the train step's own blend inputs
            "ms": times[0],
            "plain_ms": plain[0],
            # the least time for the live pairs (bound_live_ms); the bound
            # over every pre-stop pair beside it
            "bound_ms": b["live"][0],
            "bound_by": b["live"][1],
            # no PyTorch call computes either blend or any part of it
            "library_ms": None,
            "bound_live_ms": b["live"][0],
            "bound_prestop_ms": b["prestop"][0],
            "pairs": pre.serve["pairs"],
            "live_pairs": pre.serve["live"],
            "ms_step": times[1],
            "plain_ms_step": plain[1],
            "bound_live_ms_step": sb["live"][0],
            "bound_prestop_ms_step": sb["prestop"][0],
            "pairs_step": pre.step["pairs"],
            "live_pairs_step": pre.step["live"],
        }

    records = [
        record("blend_forward", 207, pre.b_f, pre.s_f, pre.times_f, pre.plain_f),
        record("blend_backward", 411, pre.b_b, pre.s_b, pre.times_b, pre.plain_b),
    ] + pre.probe_records
    records[1]["reduction"] = pre.reduction
    records[1]["depth_render"] = stage_times["depth_render_b2_against_float64"]
    records[1]["refined_sugar_step"] = stage_times["refined_sugar"]["step_ms"].pop(
        "b2_against_float64")
    stamp("the kernels record")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
