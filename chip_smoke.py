#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (`tpu_splat_torch`) on one GPU.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

It builds the CUDA kernels from `tpu_splat_torch/csrc/`, holds every kernel
variant against its plain PyTorch version, serves `render_fast` at
1088x1920 on a 1M-Gaussian cloud, and renders the trained snapshot in
`artifacts/` at its own size and tiled out to 1M surfels. Phase 6 drives the
training step (`make_train_step`, production switches, the ISP on): the
three backward kernels against their plain versions on inputs captured
inside a small step's autograd Functions, a small step on the card against
the CPU run, then 1 + 4 steps at 1088x1920 on 1M Gaussians, each of which
must launch all four kernels. Phase 7 drives the `--tight_culling` loop
body (the step with two-level binning, `run_scheduled_events`,
`check_growth`): `run_expand` bit-exact against its plain version on the
run tables binning builds at the bench frame, preprocess and tight
binning of a 100k subset on the card against the CPU (bit for bit), a
small loop on the card against the CPU event by event, 1 + 4 tight steps at 1088x1920 on 1M Gaussians (each
must launch `run_expand` twice and the other four kernels once), the loop
body at iterations where every scheduled event fires, `segment_sum_rows`
on the step's regroup rows, and a served tight frame. Phase 8 trains from a
dataset on disk: it writes a COLMAP scene of eight 1088x1920 views rendered
from the bench cloud (PNGs, a binary sparse model, 262,144 points), loads
it through `Scene`, runs the training CLI (`scripts/train.py:main`, tight
culling) in this process for 300 iterations with a densify event, growth
checks, test renders, a PLY snapshot and a checkpoint, and holds that the
run fits its views (the train-set PSNR rises, the loss falls; the held-out
view's PSNR is recorded) and that densify changed the cloud; then it checks
the files: the reloaded PLY renders bit equal, the checkpoint round-trips
bit equal, and a second run resumes from it. Phase 9 evaluates through the
evaluation CLIs, each `main` called in this process on the card with the
launch counts set to 0 before it: the bench cloud saved as a model of
phase 8's scene is rendered (`scripts/render.py`, at 40 dB PSNR or more
against phase 8's PNGs of it), scored (`metrics.py`, against phase 9's own means)
and timed (`eval_fps.py`, one forward launch a render); phase 8's trained
model is rendered from its PLY (the test PSNR within 0.05 dB of the
trainer's) and from its checkpoint with the ISP, its normal error measured
(`eval_mae.py`), its visible Gaussians pruned (`visible_gaussians.py`, the
pruned model re-renders every view), trajectories rendered at full width
(`render_videos.py`, `video.py`), and the reporting tools read the
outputs. Phase 10 extracts a mesh and serves the viewer, each `main` again
in this process with the counts set to 0 before it: `extract_mesh.py` on
phase 8's trained model at 512^3 over the bench cloud's cube (one forward
launch a view, no view dropping an instance, fuse.ply read back, the seen
vertices within a voxel of the rendered surface) and on phase 9's
full-orbit rig at the default bounds, the card's TSDF grid and mesh held
against the CPU's on the card's own maps; `view.py` in a thread on an
ephemeral port serving a loopback client in all 11 modes at 1088x1920 (each
frame the handler's render and encoder called directly, RGB that of
`Camera.create` at the same pose and fov, one forward launch a frame, the
round trip timed and split); the train CLI with its viewer on for 20
steps, a client asking for a frame mid-run; `test_rasterizer --headless`.
Phase 11 drives the modes off the main path on the bench cloud at 1088x1920:
11a the volumetric (3DGS EWA) frame through the tile kernels, antialiasing
off and on, max_instances sized from its first call when it would drop
instances: the forward kernel against its plain version on sampled tiles
in every variant, its (instance, warp) pair iterations with and without
the cull beside the surfel frame's (`kernel_ab.py`'s profile builds) and
the no-cull build bit for bit, one fwd+bwd of an L2 loss in means, scales,
rotations, opacity and SH (the backward kernel and segment sums against
their plain versions; the timed run's launches counted from 0), the stage
split, and the volumetric preprocess of 100k Gaussians on the card against
the CPU bit for bit; 11b the scan blend (backend="xla"): tile_depth grown
by `check_growth` from the first frame's max_tile_count, a served frame;
held against the tile-kernel path: the frame (pixels off tolerance only
where n_contrib flipped or a branch point lies within reach in float64),
the two blends' gradients under one cotangent (every row), and one
training step (rows beyond tolerance no more, and by no more, than a
jitter of the kernel path's own blend outputs moves); 11c the
bench view's binning under expand_mode="scan" against "gather", every
field; 11d the brute-force oracle at 48x48 against the kernel frame.
Phase 12 drives multi-GPU training (`tpu_splat_torch/dist/`) on 6c's load
(the bench cloud, the trainer's cubemap, the ISP, the deferred stage) at
1088x1920: 12a the tile-sharded step (`make_train_step(mesh=...)`) and the
camera-DP step (`make_train_step_dp`) over one NCCL rank in this process
against the unsharded step (the frame, n_contrib and every gradient, with
which leaves are bit equal), timed; 12b two ranks started by
`tpu_splat_torch.dist.launch` (over gloo sharing the card, or over NCCL on
two cards): each rank's slab of the frame against the unsharded frame,
its instance count (the ranks' sum against the unsharded count), the
tile-sharded step's gradients against the unsharded step's, the DP step
of two cameras against the mean of two single-camera steps (loss,
gradients, densify sums), the replicas' hashes after each step and after a
densify event, the gradient all-reduce and slab gather ms, each rank's
peak memory and launches; 12c the train CLI with `--mesh tiles` and
`--mesh dp` (`--mesh_devices 0`: one rank a card, started by the CLI) for
30 iterations of phase 8's scene, the files only rank 0 writes loaded back.
Phase 13 drives the convergence certificate
(`tpu_splat_torch/scripts/validate_e2e.py:main`) in this process at full
width (256x256, 48 + 6 views, production capacities) and reduced depth:
13a `recover` (200 steps), 13b `scratch` (1,002 steps, the fewest at which
every event kind of its schedule fires, densify among them), 13c
`recover_vol` (200 steps); the launch counts are set to 0 before each
task's first step and read after every step (#1-#4 once a step, #4 not in
the initial stage and never in recover_vol), every loss finite, the train
PSNR rising (recover_vol: the loss falling), each artifact written with
the card's name; 13d the parity CLI's three cases
(`tpu_splat_torch/tools/parity.py:run`) at 256x256.
Phase 14 drives the measurement scripts: 14a the bench CLI
(`python -m tpu_splat_torch.scripts.bench`) in a process of its own on the
synthetic cloud and on `artifacts/valid_torch_scratch_state.ply` tiled to
1M (its capacity probed), each fwd+bwd and `--forward_only`, at 1088x1920:
exactly one JSON line with a positive value, no instance over the capacity,
and each timed call's launches (#1-#4 once in fwd+bwd, #1 alone
forward-only); 14b the bench's fwd+bwd at 256x256 on 20,000 surfels, the
bench's switches and exact f32 rows, on the kernels against the plain
versions (the loss, the frame, every gradient leaf of the whole call
without the pixels whose reflected ray reads another env-map cell in the
two frames) and against the plain backward kernels on the kernel
forward's outputs (every gradient leaf); 14c the profiler
(`python -m tpu_splat_torch.tools.profile`) with all seven sections at
bench scale, every row finite and above 0.
Each phase prints one line a step; every failed check raises,
so the exit code is not 0. Details go to
chiprun_out/chip_smoke.json. The last four lines are phases 9 and 10's
forward launches by step, phase 11's volumetric fwd+bwd launches, phase
12's per-rank step launches, phase 13's launches by task and phase 14's
launches in one timed call of each bench variant, the kernels'
JSON record (launches over the 4 timed tight training steps), the card's
name and power limit as nvidia-smi reports them, and the result line.

Without a CUDA device, or without the rest of the repository beside it, it
exits with a non-zero code and prints no result.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

from tpu_splat_torch.eval.parity import (  # the holds 11b shares with tools/parity.py
    FLIPS_PER_4096, KNIFE_BAND, hold_images, knife_margins, patched_blend)
# the bench cloud and the trained snapshot's tiling (serve_ab.py and
# kernel_ab.py read them as chip_smoke.build_state / tile_checkpoint)
from tpu_splat_torch.scripts.bench import build_state, tile_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PLY = os.path.join(HERE, "artifacts", "valid_scratch_state.ply")

# the full width of bench.py --forward_only (bench.py:161-175)
H, W = 1088, 1920
N_GAUSS, CAPACITY = 1_000_000, 1 << 20
PROD = dict(max_tiles_per_gaussian=32, max_instances=3_981_312, tile_depth=2048, chunk=32)
N_VIEWS = 4
N_SAMPLED_TILES = 64
# scripts/render.py's RasterConfig(): full shape, f32 content rows, with the
# instance capacity raised to cover the bench frame
FULL_SHAPE = dict(max_instances=4_718_592, tile_depth=2048)
SMALL = dict(max_tiles_per_gaussian=16, max_instances=1 << 16, tile_depth=512, chunk=16)
SMALL_N, SMALL_H, SMALL_W = 3000, 192, 256
TRAINED = dict(max_tiles_per_gaussian=64, max_instances=1 << 21, tile_depth=2048, chunk=32)
# the trained snapshot tiled out to the bench size (bench.py:76), at the
# capacity bench.py's probe may grow to (bench.py:203-229)
TILED_N = N_GAUSS
TILED = dict(PROD, max_instances=8_368_128)
DEVICE = "cuda:0"

# tolerances of the kernel against its plain version (tests/test_torch_kernel.py)
TOL = 2e-5  # colour, T, normal, refl, scope, M1, M2, wmax: absolute
# depth rows (depth, median depth, distortion): 2e-5 relative to max(1, the
# depth the pixel composites)

# roofline of one H100 SXM (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# f32 operations of one (instance, pixel) alpha test in the kernel's pair
# loop: four linear fields (16), the low-pass exponent (5), the p2 guard and
# reciprocal (4), rho3d (6), the clamp/max/exp (4), depth (2), accept (2) --
# accepted pairs add the transmittance and accumulation work on top
ALPHA_TEST_OPS = 40
# f32 operations of one contributing pair in the backward's reverse step,
# beside its alpha test: log1p/exp and w (4), what (16), B and dL/da (7),
# the branch routing (6), the 26 per-pair field gradients (~27) and their
# share of the per-instance sums over the tile's pixels (26)
BWD_CONTRIB_OPS = 86

# the training path (slice 2): the trainer's cubemap, one ISP frame a view
TRAIN_CUBEMAP = 128
TRAIN_STEPS = N_VIEWS
# tolerances of the backward kernels against their plain versions
BWD_TOL = 1e-3  # each d_feats row, relative to the row's max |value|
SEGSUM_TOL = 1e-6  # relative to the largest |sum|; both sum each run in order
CUBEMAP_TOL = 1e-5  # relative to the largest |d_tex|; float atomics reorder sums
# the small step on the card against the CPU (tests/test_torch_train.py)
STEP_LOSS_TOL = 1e-5  # relative
STEP_GRAD_TOL = 1e-2  # of each leaf's max |g|, production bf16 regroup
TRAIN_KERNELS = ("tile_blend_forward", "tile_blend_backward", "segment_sum_ranges",
                 "cubemap_tap_accumulate")

# the tight-culling training loop (slice 3): the loop body of
# scripts/train.py:220-330 at iterations where, with the default
# OptimizationParams, every scheduled event fires (tpu_splat/train/loop.py):
# 1000 densify; 1500 densify, opacity-LR pulse, normal propagation, colour
# sabotage; 3000 densify, opacity reset; 15000 env doubling (128 -> 256)
LOOP_ITERATIONS = (1000, 1500, 3000, 15000)
LOOP_EVENTS = {1000: {"densify"},
               1500: {"densify", "opacity_lr_pulse", "normal_prop", "color_sabotage"},
               3000: {"densify", "reset_opacity"}, 15000: {"double_env_map"}}
TIGHT_KERNELS = ("run_expand",) + TRAIN_KERNELS
TIGHT_SUBSET, TIGHT_SUBSET_CAP = 100_000, 401_408  # surfels binned on the card and the CPU alike
# the small loop's schedule (the events' "- 500" offsets are the JAX
# package's): densify at 3 and 6, normal propagation at 4, sabotage at 5,
# opacity reset at 7
SMALL_LOOP_OPT = dict(init_until_iter=2, densify_from_iter=2, densification_interval=3,
                      densification_interval_when_prop=3, opacity_reset_interval=7,
                      densify_until_iter=20, opac_lr0_interval=2, normal_prop_interval=4,
                      normal_prop_until_iter=20, color_sabotage_interval=5,
                      color_sabotage_until_iter=20, densify_grad_threshold=2e-5)
SMALL_LOOP_ITERS = 7
EVENT_TOL = 1e-6  # event outputs card vs CPU on one input, of each leaf's max

# training from a dataset on disk (slice 6): a COLMAP scene of the bench
# cloud's views, through the train CLI with tight culling. The ISP's scene
# freeze covers a schedule's last 5000 iterations (is_scene_frozen), so the
# run takes a 5400-iteration schedule (frozen from 400) and stops after
# iteration 300. Its events: the opacity-LR pulse at 100, densify at 200
# (it prunes ~88% of this volumetric cloud), the env-map doubling at 250
# (densify_until_iter); growth of max_instances at 100.
P8_DIR = os.path.join(OUT_DIR, "phase8")
P8_VIEWS = 8
# azimuth offsets from the bench's view 0 (0.4 rad), in steps of pi/16: the
# held-out view (view_00, the first of every 8 by name) sits among the
# seven training views
P8_AZIMUTHS = tuple(0.4 + k * math.pi / 16 for k in (0, -1, 1, -2, 2, -3, 3, 4))
P8_POINTS = 262_144  # x 4 = capacity 1 << 20, the bench capacity (scripts/train.py:63)
P8_STOP, P8_RESUME_FROM, P8_RESUME_TO = 300, 150, 200
P8_WV_TOL = 1e-5  # each loaded camera's world_view against the one that rendered it
P8_ARGS = ["-r", "1", "--eval", "--tight_culling", "--disable_viewer", "-q",
           "--max_tiles_per_gaussian", "32", "--max_instances", "3981312",
           "--tile_depth", "2048", "--iterations", "5400", "--freeze_xyz_last_iters", "1000",
           "--init_until_iter", "50", "--densify_from_iter", "100",
           "--densification_interval", "100", "--densification_interval_when_prop", "100",
           "--densify_until_iter", "250",
           "--test_iterations", "1", "300", "--save_iterations", "150", "300",
           "--checkpoint_iterations", "150"]
P8_DENSIFY = 200  # the densify event of that schedule (train/loop.py)
P8_LOSS_WINDOW = 50  # steps averaged at each end of the run for the loss check
P8_WARMUP = 5  # first steps left out of the step-time spread

# evaluating a trained model (slice 7): the evaluation CLIs in this process,
# on the bench cloud saved as a model of phase 8's scene (9a-9c, at the
# bench capacities) and on phase 8's trained model (9d-9h)
P9_BENCH_CAPS = ["--max_tiles_per_gaussian", "32", "--max_instances", "3981312",
                 "--tile_depth", "2048"]
P9_MIN_PSNR = 40.0  # dB, 9a's renders against phase 8's PNGs of the same cloud
P9_FPS_REPEATS = 20
P9_TRAINER_GAP = 0.05  # dB, 9d: the PLY renders' test PSNR against the trainer's
P9_METRIC_TOL = dict(PSNR=1e-4, SSIM=1e-5)  # results.json against phase 9's own means
P9_MAE_TOL = 1e-4  # degrees, mae.txt against mae_degrees on the same tensors
P9_FRAMES = 8  # trajectory frames of render_videos.py and video.py

# extracting a mesh and serving the viewer (slice 8): extract_mesh on phase
# 8's trained model (and on 9g's full-orbit rig at the default bounds),
# view.py on that model and on the bench cloud, the train CLI with its
# viewer on, test_rasterizer --headless
P10_MESH_RES = 512
P10_BOUNDS = 2.0  # the bench cloud's half-extent (build_state: uniform in [-2, 2]^3)
P10_CHECK_RES = 128  # the card's grid against the CPU's on the card's maps
P10_TSDF_TOL = 1e-6
# the geometric check: for each vertex, over the views that see it (facing
# the camera, inside the frame, alpha > 0.5), the least distance between
# its camera depth and the rendered surf_depth at its pixel. A zero
# crossing needs a voxel that some view put within the truncation band
# (4 voxels) behind its surface, so at least half of the seen vertices lie
# within that band, and at least a tenth of the vertices are seen; a mesh
# off the renders' geometry (a transposed K, a swapped axis) has next to
# none there. The trained model is a volumetric cloud's fit, whose depth
# maps are rough (at 64x96 on the CPU: quartiles 0.7 / 2.0 / 6-9
# voxels, 67-69% within the band, 73-74% seen, at 64^3 to 192^3)
P10_SURFACE_VOXELS = 4.0
P10_SURFACE_SHARE = 0.5
P10_MIN_SEEN = 0.1
P10_TIMED_FRAMES = 12  # RGB round trips timed per model, after one in each mode
P10_STEPS = 20  # train CLI steps with the viewer on
P10_REQUEST_AT = 10  # the client connects once this iteration is served

# the modes off the main path (slice 9): the volumetric (3DGS EWA) frame and
# gradient through the tile kernels, the scan blend (backend="xla") with
# check_growth's tile_depth rule, expand_mode="scan", the brute-force oracle
P11_FWD_VARIANTS = ("fwd:no_cull", "fwd:profile", "fwd:profile_no_cull")  # kernel_ab.py builds
P11_HEADROOM = 1.25  # max_instances for a volumetric frame that would truncate: x its count
P11_GRAD_TOL = 1e-3  # of each input's or leaf's max: the blends' VJPs; the steps (see 11b)
# 11b's steps: the kernel step with its blend outputs jittered by this,
# relative (tests/scan_grad_witness.py): the rows float32-size noise moves
P11_JITTER = 2.0**-18
P11_BF_N, P11_BF_HW = 120, 48  # 11d: the brute-force oracle's scene
P11_SCAN_FIRST_DEPTH = 512  # 11b's first frame, before check_growth sizes tile_depth

# multi-GPU (slice 10): the tile-sharded step (make_train_step(mesh=...)) and
# the camera-DP step (make_train_step_dp) on the 6c load (the bench cloud,
# the trainer's cubemap, the ISP, the deferred stage) at full width; 12a one
# rank over NCCL in this process, 12b two ranks sharing the card over gloo
# (NCCL takes one rank a card; over NCCL on separate cards where there are
# two), 12c the train CLI's --mesh tiles|dp on phase 8's scene
P12_RANKS = 2
P12_TIMED = 3  # timed steps of each kind after a warm-up
P12_IMG_TOL = 2e-5  # the assembled frame against the unsharded one, absolute
P12_GW_TOL = 1e-6  # gaussian_weights, absolute
P12_GRAD_TOL = 1e-3  # 12b: each gradient leaf, of its max |g| (two ranks sum in another order)
# 12a: env_texture's gradient, of its max: the cubemap kernel's float atomics
# alone (two unsharded runs differ by 3.3e-7 to 6.0e-7 on the H100; the bound
# leaves ~7x of that); every other leaf is held bit-equal
P12_ENV_TOL = 4e-6
P12_LOSS_RTOL = 1e-5
P12_STAT_TOL = 1e-6  # the DP densify sums, of each field's max
P12_DENSIFY_AT = 1000  # an iteration whose scheduled events densify (train/loop.py)
P12_EXTENT = 6.6  # cameras_extent of the bench orbit (radius 6 x 1.1, as Scene takes it)
P12_CLI_ARGS = ["-r", "1", "--eval", "--disable_viewer", "-q", "--max_tiles_per_gaussian", "32",
                "--max_instances", "3981312", "--tile_depth", "2048", "--iterations", "30",
                "--init_until_iter", "10", "--test_iterations", "30", "--save_iterations", "30",
                "--checkpoint_iterations", "30", "--mesh_devices", "0"]

# the convergence certificate (slice 11): tpu_splat_torch/scripts/validate_e2e.py
# at full width (256x256, 48 + 6 views, production capacities) and reduced
# depth. scratch's schedule scales with its iterations, but its densify
# interval is 500 inside the normal-propagation window: 1,002 iterations is
# the fewest at which every event kind fires (densify at 500, before the
# window's end at 501)
P13_ITERATIONS = dict(recover=200, scratch=1002, recover_vol=200)
P13_KERNELS = dict(recover=TRAIN_KERNELS, scratch=TRAIN_KERNELS,
                   recover_vol=TRAIN_KERNELS[:3])  # no reflection: no cubemap kernel
P13_EVENTS = {"reset_opacity", "opacity_lr_pulse", "normal_prop", "color_sabotage",
              "double_env_map"}
P13_WINDOW = 25  # steps averaged at each end of a run: the PSNR rises, the loss falls

# the measurement scripts: the bench CLI
# (tpu_splat_torch/scripts/bench.py) on the synthetic cloud and the port's
# trained snapshot tiled to 1M, fwd+bwd and forward-only, each in a process
# of its own; the bench's fwd+bwd on the kernels against the plain versions
# at the JAX profiler's small scale; the profiler's seven sections
P14_CHECKPOINT = os.path.join("artifacts", "valid_torch_scratch_state.ply")
P14_RUNS = {"synthetic": [], "synthetic forward-only": ["--forward_only"],
            "trained": ["--checkpoint", P14_CHECKPOINT],
            "trained forward-only": ["--checkpoint", P14_CHECKPOINT, "--forward_only"]}
P14_KEYS = ("metric", "value", "unit", "vs_baseline")
P14_TIMEOUT = 300  # seconds a subprocess may take
P14_SMALL = dict(height=256, width=256, n=20_000, capacity=1 << 15)  # tools/profile.py's CPU scale
P14_SMALL_CAPS = dict(max_tiles_per_gaussian=16, max_instances=1 << 16, tile_depth=256, chunk=16)
P14_LOSS_TOL = 2e-5  # the kernel path's loss against the plain versions', absolute
P14_GRAD_TOL = 1e-3  # each gradient leaf, of the plain path's max |g|
P14_SCAN_DEPTH = 2048  # the float64 scan blend's tile depth: the small scene's deepest tile fits
P14_SECTIONS = ("full", "stages", "binning", "regroup", "env", "render", "tail")


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def small_scene(n, seed, device, opacity_logit=None):
    """A random_scene cloud as a port state (SH degree 1, 8^2 cubemap);
    opacity_logit overrides every surfel's raw opacity."""
    from tpu_splat_torch.data.synthetic import random_scene
    from tpu_splat_torch.model.convert import state_from_numpy

    raw = random_scene(n, seed=seed, sh_degree=1, extent=1.5)
    rng = np.random.default_rng(seed)
    opa = (raw["opacity"] if opacity_logit is None
           else np.full_like(raw["opacity"], opacity_logit))
    d = dict(
        xyz=raw["xyz"], features_dc=raw["sh"][:, :1], features_rest=raw["sh"][:, 1:],
        scaling=raw["scaling"] - 1.0, rotation=raw["rotation"], opacity=opa,
        refl=raw["refl"], texture=rng.uniform(-0.5, 0.5, (6, 3, 8, 8)).astype(np.float32),
        fail_value=np.zeros(3, np.float32), alive=np.ones(n, bool),
        active_sh_degree=1, max_sh_degree=1,
    )
    return state_from_numpy(d, device=device)


def captured_kernel_inputs(state, cam, cfg, bg):
    """Serve one frame with `tile_blend_forward` wrapped to keep its
    arguments: the tile kernel's inputs exactly as the served path builds
    them. Returns (feats, (starts, counts, org_x, org_y))."""
    from tpu_splat_torch.renderer import render_fast

    return captured_forward(lambda: render_fast(state, cam, cfg, bg, collect_weights=False))


def captured_forward(frame):
    """Run `frame()` without autograd, with `tile_blend_forward` wrapped to
    keep its arguments. Returns (feats, (starts, counts, org_x, org_y))."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    seen = []
    kernel = tb.tile_blend_forward

    def keep(*args, **kw):
        seen.append(args)
        return kernel(*args, **kw)

    tb.tile_blend_forward = keep
    try:
        with torch.no_grad():
            frame()
    finally:
        tb.tile_blend_forward = kernel
    (args,) = seen
    return args[0], tuple(args[1:5])


def compare(got, want, wm_got, wm_want):
    """Kernel output against the plain version's, at the stated tolerances.
    Returns the errors; raises if one is out of tolerance."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    abs_rows = [0, 1, 2, tb.O_T, tb.O_REFL, tb.O_NRM, tb.O_NRM + 1, tb.O_NRM + 2,
                tb.O_SCOPE, tb.O_M1, tb.O_M2]
    flip = got[:, tb.O_NCON] != want[:, tb.O_NCON]
    med_flip = got[:, tb.O_MEDRANK] != want[:, tb.O_MEDRANK]
    keep = ~flip
    npx = flip.numel()
    d = (got - want).abs()
    err_abs = float(d[:, abs_rows].amax(1)[keep].max()) if keep.any() else 0.0
    # depth rows relative to the depth the pixel composites: the weighted
    # mean for the depth sum, the value itself for median depth and distortion
    scale = want[:, [tb.O_DEPTH, tb.O_MED, tb.O_DIST]].abs()
    scale[:, 0] /= torch.clamp(1.0 - want[:, tb.O_T], min=1e-3)
    rel = d[:, [tb.O_DEPTH, tb.O_MED, tb.O_DIST]] / torch.clamp(scale, min=1.0)
    err_depth = float(rel.amax(1)[keep].max()) if keep.any() else 0.0
    err_wmax = float((wm_got - wm_want).abs().max()) if wm_got.numel() else 0.0
    res = dict(max_abs_err=max(err_abs, err_wmax), depth_rel_err=err_depth,
               ncon_flips=int(flip.sum()), medrank_flips=int(med_flip.sum()), pixels=npx)
    allowed = FLIPS_PER_4096 * npx / 4096
    if not (err_abs <= TOL and err_wmax <= TOL and err_depth <= TOL
            and res["ncon_flips"] <= allowed and res["medrank_flips"] <= allowed
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


def check_variants(inputs, tiles, label):
    """Every static variant of tile_blend_forward: the kernel over all tiles
    against the plain version over `tiles` (None = all). inputs maps
    packed_feats to the (feats, index) of a frame served with that slab."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    out = {}
    for train, packed, wm in itertools.product((False, True), repeat=3):
        feats, (starts, counts, ox, oy) = inputs[packed]
        sel = slice(None) if tiles is None else tiles
        kw = dict(train_shape=train, packed_feats=packed, collect_wmax=wm)
        o_k, w_k = tb.tile_blend_forward(feats, starts, counts, ox, oy, **kw)
        o_p, w_p = tb.tile_blend_forward_plain(
            feats, starts[sel], counts[sel], ox[sel], oy[sel], **kw)
        torch.cuda.synchronize()
        if tiles is not None:
            slots = torch.cat([torch.arange(int(starts[t]), int(starts[t]) + int(counts[t]),
                                            device=starts.device) for t in tiles.tolist()])
            w_k, w_p = w_k[slots], w_p[slots]
        if not wm and float(w_k.abs().max() if w_k.numel() else 0.0) != 0.0:
            raise AssertionError("collect_wmax=False wrote wmax")
        out[f"train={int(train)},packed={int(packed)},wmax={int(wm)}"] = compare(
            o_k[sel], o_p, w_k, w_p)
    worst = max(r["max_abs_err"] for r in out.values())
    log(f"3 kernel vs plain: {label}", variants=len(out), max_abs_err=f"{worst:.3g}",
        depth_rel_err=f"{max(r['depth_rel_err'] for r in out.values()):.3g}",
        ncon_flips=sum(r["ncon_flips"] for r in out.values()),
        pixels_per_variant=next(iter(out.values()))["pixels"])
    return out, worst


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, r


def check_frame(out, cfg, label):
    import torch

    for f in ("render", "alpha", "normal", "refl_strength", "base_color"):
        x = getattr(out, f)
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{label}: non-finite {f}")
    if tuple(out.render.shape) != (out.alpha.shape[0], out.alpha.shape[1], 3):
        raise AssertionError(f"{label}: render shape {tuple(out.render.shape)}")
    cover = float((out.alpha > 0.5).float().mean())
    if cover <= 0.0:
        raise AssertionError(f"{label}: empty frame")
    n_inst = int(out.num_instances)
    if n_inst > cfg.max_instances:
        raise AssertionError(f"{label}: {n_inst} instances > capacity {cfg.max_instances}")
    return cover, n_inst


class Capture:
    """Wrap the three backward kernels' wrappers for one training step and
    keep the arguments the step hands them (the inputs captured inside the
    autograd Functions)."""

    NAMES = (("tile_blend", "tile_blend_backward"), ("segment_reduce", "segment_sum_ranges"),
             ("cubemap_accum", "cubemap_tap_accumulate"), ("tile_blend", "regroup_grads"))

    def __init__(self):
        import importlib

        self.mods = {fn: importlib.import_module(f"tpu_splat_torch.kernels.{m}")
                     for m, fn in self.NAMES}
        self.seen = {fn: [] for _, fn in self.NAMES}

    def __enter__(self):
        self.orig = {fn: getattr(mod, fn) for fn, mod in self.mods.items()}
        for fn, mod in self.mods.items():
            def keep(*args, _fn=fn, **kw):
                self.seen[_fn].append((tuple(a.detach() if hasattr(a, "detach") else a
                                             for a in args), kw))
                return self.orig[_fn](*args, **kw)
            setattr(mod, fn, keep)
        return self

    def __exit__(self, *exc):
        for fn, mod in self.mods.items():
            setattr(mod, fn, self.orig[fn])


def unpacked_rows(d, packed):
    """d_feats -> [19, N] gradient rows, packed content unpacked."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    if not packed:
        return d[:tb.F_GRAD]
    hi, lo = tb._unpack2_bits(d[12:16].contiguous())
    return torch.cat([d[:12], hi, lo[:3]])


def check_backward(feats, index, fwd, ct, full, packed, tiles=None):
    """tile_blend_backward's kernel over all tiles against its plain version
    over `tiles` (None = all), on the columns of those tiles' used chunks:
    each gradient row within BWD_TOL of the row's max |value|."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    kw = dict(full_grads=full, packed_feats=packed)
    d_k = tb.tile_blend_backward(feats, *index, fwd, ct, **kw)
    sel = slice(None) if tiles is None else tiles
    d_p = tb.tile_blend_backward_plain(feats, *(x[sel] for x in index), fwd[sel], ct[sel], **kw)
    torch.cuda.synchronize()
    starts, counts = index[0][sel], index[1][sel]
    used = tb._used_chunks(fwd[sel], counts)
    cols = torch.cat([torch.arange(int(s), int(s) + int(u) * tb.CI, device=feats.device)
                      for s, u in zip(starts.tolist(), used.tolist())] or
                     [torch.zeros(0, dtype=torch.long, device=feats.device)])
    a, b = unpacked_rows(d_k, packed)[:, cols], unpacked_rows(d_p, packed)[:, cols]
    err = (a - b).abs()
    scale = b.abs().amax(1, keepdim=True)
    res = dict(max_abs_err=float(err.max()) if err.numel() else 0.0,
               max_rel_err=float((err / torch.clamp(scale, min=1e-30)).max()) if err.numel() else 0.0,
               columns=int(cols.numel()))
    if not (bool((err <= BWD_TOL * scale).all()) and bool(torch.isfinite(d_k).all())):
        raise AssertionError(f"tile_blend_backward disagrees with its plain version: {res} {kw}")
    return res


def check_segsum(rows, starts, ends):
    from tpu_splat_torch.kernels import segment_reduce as sr

    got = sr.segment_sum_ranges(rows, starts, ends)
    want = sr.segment_sum_ranges_plain(rows, starts, ends)
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not err <= SEGSUM_TOL * float(want.abs().max()):
        raise AssertionError(f"segment_sum_ranges disagrees with its plain version: {err}")
    return dict(max_abs_err=err, segments=int(starts.numel()), rows=int(rows.shape[0]))


def check_cubemap(args, kw):
    from tpu_splat_torch.kernels import cubemap_accum as ca

    got = ca.cubemap_tap_accumulate(*args, **kw)
    want = ca.cubemap_tap_accumulate_plain(*args, **kw)
    err = float((got - want).abs().max())
    if not err <= CUBEMAP_TOL * float(want.abs().max()):
        raise AssertionError(f"cubemap_tap_accumulate disagrees with its plain version: {err}")
    return dict(max_abs_err=err, pixels=int(args[0].shape[0]), texels=int(got.shape[0]))


def check_captured(cap, tiles=None, label=""):
    """Every captured kernel input of one step against the plain versions."""
    (bargs, bkw), = cap.seen["tile_blend_backward"]
    feats, index, fwd, ct = bargs[0], bargs[1:5], bargs[5], bargs[6]
    res = {"tile_blend_backward": check_backward(feats, index, fwd, ct, bkw["full_grads"],
                                                 bkw["packed_feats"], tiles)}
    (sargs, _), = cap.seen["segment_sum_ranges"]
    res["segment_sum_ranges"] = check_segsum(*sargs)
    (cargs, ckw), = cap.seen["cubemap_tap_accumulate"]
    res["cubemap_tap_accumulate"] = check_cubemap(cargs, ckw)
    log(f"6 kernels vs plain: {label}",
        **{k: f"{v['max_abs_err']:.3g}" for k, v in res.items()},
        bwd_rel=f"{res['tile_blend_backward']['max_rel_err']:.3g}")
    return res


def scatter_regroup(d_feats, group_key, rank_of, seg_start, seg_end, bf16_pack, packed_feats):
    """The regroup of a packed slab's gradients (tile_blend.regroup_grads)
    without its sort: the same bf16-pair rows added per depth rank by one
    atomic index_add_, then un-ranked. Timed beside the sort-plus-segment-
    sum design; the port does not use it."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    assert packed_feats
    words = [tb._pack2_bits(d_feats[2 * k], d_feats[2 * k + 1]) for k in range(6)]
    hi, lo = tb._unpack2_bits(torch.stack(words + [d_feats[12 + k] for k in range(4)]))
    geo = torch.stack([hi[:6], lo[:6]], dim=1).reshape(12, -1)
    rows = torch.cat([geo, hi[6:10], lo[6:9]])  # [19, N]
    P_ = rank_of.shape[0]
    out = torch.zeros((P_ + 1, rows.shape[0]), dtype=torch.float32, device=rows.device)
    out.index_add_(0, group_key.long(), rows.T)  # invalid slots carry rank P
    return out[:P_][rank_of.long()]


def train_start(state, n_frames):
    """A fresh TrainState in the deferred-reflection stage (the env pass and
    its backward run), and the trainer's step for `cfg`."""
    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.isp.ppisp import ISPConfig
    from tpu_splat_torch.train.step import TrainState

    opt = OptimizationParams()
    ts = TrainState.create(state, opt, num_frames=n_frames)
    ts.step = opt.init_until_iter
    isp = ISPConfig(controller_activation_ratio=(opt.iterations - 5000) / opt.iterations)
    return opt, ts, isp


def bwd_bound(feats, index, fwd, packed, tested, contributing):
    """(bytes, ops) the backward must move and do at these inputs: the used
    chunks' slab columns read and their gradients written, fwd_px and ct_px
    read once; the alpha test of every pair up to its pixel's n_contrib and
    the reverse step of every contributing one."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb

    used = tb._used_chunks(fwd, index[1])
    cols = int(torch.minimum(index[1].long(), used.long() * tb.CI).sum())
    f_io = tb.F_IN_PACKED if packed else tb.F_PAD
    n_bytes = 2 * cols * f_io * 4 + 2 * fwd.numel() * 4 + 5 * index[0].numel() * 4
    return n_bytes, ALPHA_TEST_OPS * tested + BWD_CONTRIB_OPS * contributing


class ExpandCapture:
    """Wrap binning's `run_expand` and keep the arguments binning hands it
    (the run tables of the tight levels, or of kernel mode)."""

    def __enter__(self):
        from tpu_splat_torch.raster import binning

        self.mod, self.orig, self.seen = binning, binning.run_expand, []

        def keep(*args):
            self.seen.append(tuple(a.detach() if hasattr(a, "detach") else a for a in args))
            return self.orig(*args)

        binning.run_expand = keep
        return self

    def __exit__(self, *exc):
        self.mod.run_expand = self.orig


def check_run_expand(args):
    """run_expand's kernel against its plain version: rows and j bit-exact.
    Returns the check and the timings at these inputs."""
    import torch

    from tpu_splat_torch.kernels import run_expand as rex

    table, off, total, r0, n_out = args
    rows, j = rex.run_expand(*args)
    want_rows, want_j = rex.run_expand_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(rows.view(torch.int32), want_rows.view(torch.int32))
            and torch.equal(j, want_j)):
        n_bad = int((rows.view(torch.int32) != want_rows.view(torch.int32)).any(0).sum())
        raise AssertionError(f"run_expand disagrees with its plain version in {n_bad} slots "
                             f"(K={table.shape[1]}, n_out={n_out})")
    P_, K = table.shape
    i = torch.arange(n_out, device=table.device)
    off64 = off.long()

    def lib():  # the same decode from one searchsorted and one index_select
        r = torch.clamp(torch.searchsorted(off64, i, right=True) - 1, min=0)
        return table.index_select(0, r)

    # bytes the decode needs: the table row and offset of each run that
    # emits a slot below min(total, n_out) (zero-length runs and runs past
    # total are never read), r0_sub and total, and the rows and j written
    end = torch.cat([off64[1:], total.long().reshape(1)])
    emitting = int(((off64 < min(int(total), n_out)) & (end > off64)).sum())
    n_bytes = (K + 1) * emitting * 4 + (K + 1) * n_out * 4 + r0.numel() * 4 + 4
    return dict(K=K, n_out=n_out, runs=P_, emitting_runs=emitting, total=int(total),
                max_abs_err=0.0,
                ms=cuda_ms(lambda: rex.run_expand(*args), 10),
                plain_ms=wall_ms(lambda: rex.run_expand_plain(*args))[0],
                library_ms=cuda_ms(lib, 10), bytes=n_bytes, ops=0)


def check_segsum_rows(rows_T, starts, ends):
    """segment_sum_rows' kernel against its plain version, and against
    segment_sum_ranges on the same data, on row-major rows: within 1e-6 of
    each column's max |sum|. Returns the check and the timings."""
    import torch

    from tpu_splat_torch.kernels import segment_reduce as sr

    rows = rows_T.T.contiguous()  # [N, F] row-major
    got = sr.segment_sum_rows(rows, starts, ends)
    want = sr.segment_sum_rows_plain(rows, starts, ends)
    ranges = sr.segment_sum_ranges(rows_T, starts, ends).T
    torch.cuda.synchronize()
    scale = want.abs().amax(0)
    err = (got - want).abs()
    err_r = (got - ranges).abs()
    if not (bool((err <= SEGSUM_TOL * scale).all()) and bool((err_r <= SEGSUM_TOL * scale).all())):
        raise AssertionError(f"segment_sum_rows disagrees: {float(err.max())}, "
                             f"vs segment_sum_ranges {float(err_r.max())}")
    covered = int((ends.long() - starts.long()).clamp(min=0).sum())
    lib_ms = None
    if bool((starts[1:] == ends[:-1]).all()):  # gap-free runs: one segment_reduce
        data = rows[int(starts[0]):int(ends[-1])]
        lengths = (ends - starts).long()
        lib_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths), 10)
    return dict(max_abs_err=float(err.max()), vs_ranges=float(err_r.max()),
                ms=cuda_ms(lambda: sr.segment_sum_rows(rows, starts, ends), 10),
                plain_ms=wall_ms(lambda: sr.segment_sum_rows_plain(rows, starts, ends))[0],
                library_ms=lib_ms, rows=int(rows.shape[0]), features=int(rows.shape[1]),
                segments=int(starts.numel()),
                bytes=rows.shape[1] * (covered + starts.numel()) * 4 + 2 * starts.numel() * 4,
                ops=0)


def bin_view(state, cam, cfg):
    """Binning of one view as a step runs it (preprocess + bin_gaussians)."""
    import torch

    from tpu_splat_torch.raster.binning import bin_gaussians
    from tpu_splat_torch.raster.preprocess import preprocess

    with torch.no_grad():
        p = preprocess(state.xyz, state.get_scaling(), state.rotation, cam.world_view,
                       cam.full_proj, cam.camera_center, cam.height, cam.width,
                       sh=state.get_features(), sh_degree=state.active_sh_degree,
                       opacity=state.get_opacity() if cfg.opacity_rect else None)
        valid = p.valid & state.alive
        p = p._replace(valid=valid, tiles_touched=torch.where(valid, p.tiles_touched, 0))
        return bin_gaussians(p, cam.height, cam.width, cfg)


def instance_pairs(b) -> np.ndarray:
    """The (Gaussian, tile) instances of a Binned as sorted gid * T + tile."""
    import torch

    starts = b.aligned_starts.long().cpu()
    slots = torch.nonzero(b.aligned_valid.cpu())[:, 0]
    tile = torch.searchsorted(starts, slots, right=True) - 1
    gid = b.aligned_gid.cpu()[slots].long()
    return np.sort((gid * starts.numel() + tile).numpy())


def knife_gaussians(ts_a, ts_b, cam_a, cam_b, cfg) -> np.ndarray:
    """Gaussians whose instances differ between two states' binnings (a
    tight tile-row range is a floor of the conic, so an ulp of difference
    in preprocess at that knife edge moves a tile)."""
    b_a = bin_view(ts_a.gaussians, cam_a, cfg)
    pa, pb = instance_pairs(b_a), instance_pairs(bin_view(ts_b.gaussians, cam_b, cfg))
    return np.unique(np.setxor1d(pa, pb) // b_a.aligned_starts.numel())


def ts_to_device(ts, device):
    """A TrainState's tensors copied to `device` (the generator stays)."""
    import dataclasses

    import torch

    from tpu_splat_torch.model.densify import DensifyStats

    mv = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
    g = ts.gaussians
    g2 = dataclasses.replace(g, **{f.name: mv(getattr(g, f.name))
                                   for f in dataclasses.fields(g) if f.name != "env"},
                             env=type(g.env)(*(mv(x) for x in g.env)))
    return dataclasses.replace(
        ts, gaussians=g2,
        opt=ts.opt._replace(mu={k: mv(v) for k, v in ts.opt.mu.items()},
                            nu={k: mv(v) for k, v in ts.opt.nu.items()}),
        stats=DensifyStats(*(mv(x) for x in ts.stats)),
        isp=None if ts.isp is None else type(ts.isp)(*(mv(x) for x in ts.isp)))


def compare_train_states(a, b, label, tol=EVENT_TOL):
    """Two TrainStates (as train_state_to_numpy gives them): the alive set,
    the opacity rate and every shape exactly; parameters, moments and
    statistics within tol of each leaf's max. Returns the worst relative
    difference."""
    ga, gb = a["gaussians"], b["gaussians"]
    if not np.array_equal(ga["alive"], gb["alive"]):
        raise AssertionError(f"{label}: alive sets differ in {int((ga['alive'] != gb['alive']).sum())}")
    if np.float32(a["opacity_lr"]) != np.float32(b["opacity_lr"]):
        raise AssertionError(f"{label}: opacity_lr {a['opacity_lr']} vs {b['opacity_lr']}")
    pairs = [(f"gaussians.{k}", ga[k], gb[k]) for k in ga if isinstance(ga[k], np.ndarray)]
    pairs += [(f"{m}.{k}", a[m][k], b[m][k]) for m in ("mu", "nu") for k in a[m]]
    pairs += [(f"stats.{k}", a["stats"][k], b["stats"][k]) for k in a["stats"]]
    worst = 0.0
    for name, x, y in pairs:
        if x.shape != y.shape:
            raise AssertionError(f"{label}: {name} shapes {x.shape} vs {y.shape}")
        if x.dtype == bool:
            continue
        scale = float(np.abs(x).max()) if x.size else 0.0
        d = float(np.abs(x - y).max()) if x.size else 0.0
        if d > tol * scale:
            raise AssertionError(f"{label}: {name} differs by {d} of {scale}")
        worst = max(worst, d / scale if scale else 0.0)
    return worst


def pack_features_card_vs_cpu(state, cam, cfg, bg):
    """Serve one frame keeping `pack_features`' arguments and result, run it
    again on the CPU on the same inputs: -> (differing words, words). Both
    devices run the same float32 helpers (core/f32.py), so they agree bit
    for bit."""
    import torch

    from tpu_splat_torch.kernels import tile_blend as tb
    from tpu_splat_torch.renderer import render_fast

    seen = []
    pack = tb.pack_features

    def keep(*args, **kw):
        out = pack(*args, **kw)
        seen.append((args, kw, out))
        return out

    tb.pack_features = keep
    try:
        render_fast(state, cam, cfg, bg, collect_weights=False)
    finally:
        tb.pack_features = pack
    ((args, kw, out),) = seen
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    want = pack(*(cpu(a) for a in args), **{k: cpu(v) for k, v in kw.items()})
    got = out.cpu()
    return int((got.view(torch.int32) != want.view(torch.int32)).sum()), got.numel()


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP's rotmat2qvec: (w, x, y, z) of a rotation matrix, w >= 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(R, np.float64).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def colmap_rig(cams):
    """One PINHOLE camera (the first view's) and the views' poses, the k-th
    named view_kk.png, as COLMAP records."""
    from tpu_splat_torch.data.colmap import ColmapCamera, ColmapImage

    K = cams[0].K.cpu().double().numpy()
    colmap_cams = {1: ColmapCamera(1, "PINHOLE", cams[0].width, cams[0].height,
                                   np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]))}
    imgs = {}
    for k, cam in enumerate(cams):
        wv = cam.world_view.cpu().double().numpy()
        imgs[k + 1] = ColmapImage(k + 1, rotmat_to_qvec(wv[:3, :3]), wv[:3, 3], 1,
                                  f"view_{k:02d}.png")
    return colmap_cams, imgs


def write_colmap_scene(root, state, cams, cfg, bg, seed=8, points=P8_POINTS):
    """A COLMAP scene of `cams` rendered from `state`: uint8 PNGs under
    images/, one PINHOLE camera, the views' poses, and `points` points
    sampled from the live rows with their DC colours, in a binary sparse
    model. -> {image name: camera}."""
    import torch

    from tpu_splat_torch.core.sh import SH_C0
    from tpu_splat_torch.data.colmap import write_model
    from tpu_splat_torch.data.native_loader import write_png
    from tpu_splat_torch.renderer import render_fast

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    by_name = {}
    for k, cam in enumerate(cams):
        out = render_fast(state, cam, cfg, bg, collect_weights=False)
        img = (torch.clamp(out.render, 0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()
        name = f"view_{k:02d}"
        write_png(os.path.join(root, "images", name + ".png"), img)
        by_name[name] = cam
    live = torch.nonzero(state.alive).squeeze(1).cpu().numpy()
    idx = np.sort(np.random.default_rng(seed).choice(live, points, replace=False))
    xyz = state.xyz.cpu().numpy()[idx].astype(np.float64)
    dc = state.features_dc[:, 0].cpu().numpy()[idx]
    rgb = np.clip((dc * SH_C0 + 0.5) * 255.0, 0, 255).round().astype(np.uint8)
    write_model(*colmap_rig(cams), (xyz, rgb, np.zeros(points)),
                os.path.join(root, "sparse", "0"), ext=".bin")
    return by_name


class _StopRun(Exception):
    """Raised by the wrapped step once the run has done its steps."""

    def __init__(self, ts):
        super().__init__(f"stopped after step {ts.step}")
        self.ts = ts


def run_train_cli(argv, stop_at, device):
    """`scripts.train.main(argv)` in this process, with its step, scheduled
    events, growth check and savers wrapped: each call is synchronised and
    timed on the host clock, each step's kernel launches are counted and its
    loss kept, and the run stops once `stop_at` steps are done (the state
    then is the CLI's after that iteration's events, renders and saves).
    -> (TrainState, record)."""
    import torch

    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.model import io as mio
    from tpu_splat_torch.scripts import train as cli
    from tpu_splat_torch.train import grow as grow_mod
    from tpu_splat_torch.train import loop as loop_mod
    from tpu_splat_torch.train import step as step_mod

    sync = torch.cuda.synchronize
    rec = dict(steps=[], events=[], growth=[], saves=[])
    originals = dict(make=step_mod.make_train_step, events=loop_mod.run_scheduled_events,
                     growth=grow_mod.check_growth, ply=mio.save_ply, ckpt=mio.save_checkpoint)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    def make_timed(*a, **k):
        step = originals["make"](*a, **k)

        def timed_step(ts, *sa, **sk):
            if ts.step >= stop_at:
                raise _StopRun(ts)
            before = dict(LAUNCHES)
            ms, out = timed(lambda: step(ts, *sa, **sk))
            rec["steps"].append(dict(
                iteration=ts.step + 1, ms=ms, loss=out[1].loss,
                launches={n: LAUNCHES[n] - before.get(n, 0) for n in LAUNCHES}))
            return out

        return timed_step

    def events_timed(ts, iteration, *a, **k):
        lg = k["log"]
        n0, d0 = len(lg.events), (lg.densified, lg.pruned, lg.overflowed)
        alive0 = int(ts.gaussians.alive.sum())
        ms, out = timed(lambda: originals["events"](ts, iteration, *a, **k))
        d = (lg.densified - d0[0], lg.pruned - d0[1], lg.overflowed - d0[2])
        # densify leaves no entry in the log: what it did shows in the counts
        fired = [e for _, e in lg.events[n0:]] + (["densify"] if any(d) else [])
        if fired:
            rec["events"].append(dict(
                iteration=iteration, ms=ms, events=fired, densified=d[0], pruned=d[1],
                overflow=d[2], alive_before=alive0, alive_after=int(out.gaussians.alive.sum())))
        return out

    def growth_timed(ts, cfg, **k):
        ms, dec = timed(lambda: originals["growth"](ts, cfg, **k))
        rec["growth"].append(dict(ms=ms, grew=dec.grew, reasons=list(dec.reasons),
                                  capacity=dec.ts.gaussians.capacity,
                                  max_instances=dec.cfg.max_instances, **k))
        return dec

    def saver(kind, fn):
        def save(*a, **k):
            ms, out = timed(lambda: fn(*a, **k))
            rec["saves"].append(dict(kind=kind, ms=ms))
            return out
        return save

    step_mod.make_train_step = make_timed
    loop_mod.run_scheduled_events = events_timed
    grow_mod.check_growth = growth_timed
    mio.save_ply = saver("ply", originals["ply"])
    mio.save_checkpoint = saver("checkpoint", originals["ckpt"])
    try:
        cli.main(argv, device=device)
        raise AssertionError(f"the CLI ended before step {stop_at}")
    except _StopRun as stop:
        ts = stop.ts
    finally:
        step_mod.make_train_step = originals["make"]
        loop_mod.run_scheduled_events = originals["events"]
        grow_mod.check_growth = originals["growth"]
        mio.save_ply, mio.save_checkpoint = originals["ply"], originals["ckpt"]
    return ts, rec


def phase8_train_from_disk(state, dev, detail):
    """Slice 6: train from a COLMAP scene on disk through the train CLI. Its
    files (~2 GB of images, snapshots and checkpoints) stay for phase 9;
    main removes them after."""
    import torch

    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.model import convert
    from tpu_splat_torch.model.io import load_checkpoint, load_ply, save_checkpoint
    from tpu_splat_torch.raster.config import RasterConfig, production_config
    from tpu_splat_torch.renderer import render_fast

    shutil.rmtree(P8_DIR, ignore_errors=True)
    scene_dir, model_dir = os.path.join(P8_DIR, "scene"), os.path.join(P8_DIR, "model")
    bg = torch.zeros(3, device=dev)

    # 8a. the scene: eight views on the bench orbit rendered from the bench cloud
    cams = [orbit_camera(H, W, radius=6.0, azimuth=a, elevation=0.3, device=dev)
            for a in P8_AZIMUTHS]
    t0 = time.perf_counter()
    by_name = write_colmap_scene(scene_dir, state, cams, production_config(**PROD), bg)
    write_s = time.perf_counter() - t0

    # 8b. load it through Scene: the loaded poses are the rendering ones
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = Scene(scene_dir, resolution=1, eval_split=True, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    wv_err = fp_err = 0.0
    for lc in scene.train_cameras + scene.test_cameras:
        want = by_name[lc.image_name]
        wv_err = max(wv_err, float((lc.camera.world_view - want.world_view).abs().max()))
        fp_err = max(fp_err, float((lc.camera.full_proj - want.full_proj).abs().max()))
        if (lc.camera.height, lc.camera.width) != (H, W) or lc.image.device != want.world_view.device:
            raise AssertionError(f"{lc.image_name}: loaded at the wrong size or device")
    n_train, n_test, decoder = len(scene.train_cameras), len(scene.test_cameras), scene.decoder
    del scene
    if wv_err > P8_WV_TOL or n_train + n_test != P8_VIEWS or n_test < 1:
        raise AssertionError(f"COLMAP poses: world_view off by {wv_err} ({n_train}+{n_test} views)")
    log("8 scene", views=P8_VIEWS, train=n_train, test=n_test, points=P8_POINTS,
        write_s=f"{write_s:.2f}", load_s=f"{load_s:.2f}", world_view_err=f"{wv_err:.3g}",
        full_proj_err=f"{fp_err:.3g}", decoder=repr(decoder))

    # 8c. the CLI, in this process; the launch counts read over the run
    argv = ["-s", scene_dir, "-m", model_dir, *P8_ARGS]
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ts, rec = run_train_cli(argv, P8_STOP, str(dev))
    cli_s = time.perf_counter() - t0
    run_launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # 8d. hold what came out
    losses = torch.stack([r["loss"] for r in rec["steps"]]).float().cpu()
    if len(rec["steps"]) != P8_STOP or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{len(rec['steps'])} steps, finite: {torch.isfinite(losses).all()}")
    # each step as a tight step launches: run_expand twice, the other
    # kernels once, but the cubemap's before init_until_iter (no reflection)
    init_until = int(P8_ARGS[P8_ARGS.index("--init_until_iter") + 1])
    want_launch = lambda it: (dict.fromkeys(TRAIN_KERNELS, 1) | {"run_expand": 2}
                              | ({"cubemap_tap_accumulate": 0} if it < init_until else {}))
    bad = [(r["iteration"], r["launches"]) for r in rec["steps"]
           if any(r["launches"].get(n, 0) != c for n, c in want_launch(r["iteration"]).items())]
    if bad:
        raise AssertionError(f"steps {bad[:5]} did not launch each kernel as a tight step does")
    with open(os.path.join(model_dir, "training_report.jsonl")) as f:
        report = [json.loads(line) for line in f]
    # the run fits its views: the train-set PSNR rises and the loss falls;
    # the held-out view's PSNR is recorded, not held
    psnr = {r["iteration"]: r["test"]["psnr"] for r in report}
    train_psnr = {r["iteration"]: r["train"]["psnr"] for r in report}
    loss_ends = [float(losses[:P8_LOSS_WINDOW].mean()), float(losses[-P8_LOSS_WINDOW:].mean())]
    if not train_psnr.get(P8_STOP, -math.inf) > train_psnr.get(1, math.inf):
        raise AssertionError(f"train-set PSNR did not rise: {train_psnr}")
    if not loss_ends[1] < loss_ends[0]:
        raise AssertionError(f"the loss did not fall: first and last {P8_LOSS_WINDOW} steps "
                             f"{loss_ends}")
    dens = [e for e in rec["events"] if e["iteration"] == P8_DENSIFY]
    if not dens or dens[0]["densified"] + dens[0]["pruned"] == 0 or \
            dens[0]["alive_after"] == dens[0]["alive_before"]:
        raise AssertionError(f"densify at {P8_DENSIFY} changed nothing: {dens}")
    if not rec["growth"]:
        raise AssertionError("no growth check ran")
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{P8_STOP}", "point_cloud.ply")
    loaded = load_ply(ply, capacity=ts.gaussians.capacity, device=dev)
    eval_cfg = RasterConfig(max_tiles_per_gaussian=32, max_instances=3_981_312, tile_depth=2048)
    a = render_fast(ts.gaussians, cams[0], eval_cfg, bg)
    b = render_fast(loaded, cams[0], eval_cfg, bg)
    ply_diff = sum(int((getattr(a, f).view(torch.int32) != getattr(b, f).view(torch.int32)).sum())
                   for f in ("render", "base_color", "alpha", "normal", "refl_strength"))
    if ply_diff or not os.path.exists(ply.replace(".ply", ".map.npz")):
        raise AssertionError(f"the reloaded PLY renders {ply_diff} words apart")
    ck = os.path.join(P8_DIR, "round_trip.npz")
    t0 = time.perf_counter()
    save_checkpoint(ck, ts, P8_STOP)
    ck_save_s = time.perf_counter() - t0
    back, it = load_checkpoint(ck, ts)
    la, lb = convert.train_state_to_leaves(ts), convert.train_state_to_leaves(back)
    ck_bad = [k for k in la if la[k].dtype != lb[k].dtype or not np.array_equal(
        la[k].reshape(-1).view(np.uint8), lb[k].reshape(-1).view(np.uint8))]
    if ck_bad or it != P8_STOP or back.gaussians.device != ts.gaussians.device or not torch.equal(
            back.generator.get_state(), ts.generator.get_state()):
        raise AssertionError(f"checkpoint round trip: leaves {ck_bad} differ")
    del back, a, b, loaded
    resume_argv = ["-s", scene_dir, "-m", os.path.join(P8_DIR, "resume"), *P8_ARGS,
                   "--start_checkpoint", os.path.join(model_dir, f"chkpnt{P8_RESUME_FROM}.npz")]
    ts_r, rec_r = run_train_cli(resume_argv, P8_RESUME_TO, str(dev))
    if ts_r.step != P8_RESUME_TO or len(rec_r["steps"]) != P8_RESUME_TO - P8_RESUME_FROM:
        raise AssertionError(f"the resumed run stopped at {ts_r.step}")

    # figures: step wall ms at iterations with no event, growth, render or
    # save at or just before them (and past the first steps)
    busy = ({e["iteration"] for e in rec["events"]} | set(range(100, P8_STOP + 1, 100))
            | {1, 150, P8_STOP})
    quiet = [r["ms"] for r in rec["steps"] if r["iteration"] > P8_WARMUP
             and r["iteration"] not in busy and r["iteration"] - 1 not in busy]
    q = np.percentile(quiet, [0, 10, 50, 90, 100])
    saves = {k: [r["ms"] / 1e3 for r in rec["saves"] if r["kind"] == k]
             for k in ("ply", "checkpoint")}
    out = dict(
        write_scene_s=write_s, load_scene_s=load_s, decoder=decoder, world_view_err=wv_err,
        full_proj_err=fp_err, cli_s=cli_s, steps=len(rec["steps"]),
        step_ms=dict(n=len(quiet), **{k: float(v) for k, v in zip(
            ("min", "p10", "median", "p90", "max"), q)}),
        events=rec["events"], growth=rec["growth"], ply_save_s=saves["ply"],
        checkpoint_save_s=saves["checkpoint"], round_trip_save_s=ck_save_s,
        peak_mem_gib=peak, launches=run_launches, test_psnr=psnr, train_psnr=train_psnr,
        report=report, loss_first_last_means=loss_ends,
        alive=int(ts.gaussians.alive.sum()), capacity=ts.gaussians.capacity,
        resume=dict(steps=len(rec_r["steps"]), step=ts_r.step),
        step_ms_all=[r["ms"] for r in rec["steps"]])
    detail["train_from_disk"] = out
    log("8 train from disk", load_s=f"{load_s:.2f}",
        step_ms_median=f"{q[2]:.2f}", step_ms_p10_p90=f"{q[1]:.2f}-{q[3]:.2f}",
        step_ms_min_max=f"{q[0]:.2f}-{q[4]:.2f}",
        event_ms=",".join(f"{e['iteration']}:{e['ms']:.1f}" for e in rec["events"]),
        ply_save_s=",".join(f"{v:.2f}" for v in saves["ply"]),
        checkpoint_save_s=",".join(f"{v:.2f}" for v in saves["checkpoint"]),
        peak_mem_gib=f"{peak:.2f}", decoder=repr(decoder),
        train_psnr=f"{train_psnr[1]:.2f}->{train_psnr[P8_STOP]:.2f}",
        loss=f"{loss_ends[0]:.4f}->{loss_ends[1]:.4f}",
        test_psnr=f"{psnr[1]:.2f}->{psnr[P8_STOP]:.2f}", alive=out["alive"],
        capacity=out["capacity"], resumed_to=ts_r.step)
    return out


@contextlib.contextmanager
def no_lpips_weights(home):
    """TORCH_HOME pointed at an empty directory and LPIPS_WEIGHTS unset, so
    the metrics CLI reports LPIPS as NaN (plus GMSD) whatever the machine
    has cached; the environment is restored after."""
    saved = {k: os.environ.get(k) for k in ("TORCH_HOME", "LPIPS_WEIGHTS")}
    os.makedirs(home, exist_ok=True)
    os.environ["TORCH_HOME"] = home
    os.environ.pop("LPIPS_WEIGHTS", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase9_evaluate(state, dev, detail):
    """Slice 7: the evaluation CLIs (render, metrics, eval_fps, eval_mae,
    visible_gaussians, render_videos, video and the reporting tools), each
    `main` called in this process on the card with the kernel launch counts
    set to 0 just before it and read just after. 9a-9c evaluate the bench
    cloud saved as a model of phase 8's scene, 9d-9h phase 8's trained
    model. Every image the CLIs write through `save_image_u8` is held
    finite. -> {step: tile_blend_forward launches}."""
    import argparse
    import glob
    import types

    import torch

    from tpu_splat_torch.config import build_parser, get_combined_args, save_cfg_args
    from tpu_splat_torch.data.colmap import write_model
    from tpu_splat_torch.data.native_loader import decode_png
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.eval import image_utils
    from tpu_splat_torch.eval.trajectories import generate_path
    from tpu_splat_torch.isp.ppisp import apply_isp
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.model.io import (
        load_checkpoint_gaussians,
        load_checkpoint_isp,
        load_ply,
        save_ply,
    )
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts import (
        collect_results,
        eval_fps,
        eval_mae,
        extract_metrics,
        metrics,
        render_videos,
        report,
        video,
        view_diff_maps,
        visible_gaussians,
    )
    from tpu_splat_torch.scripts import render as render_cli
    from tpu_splat_torch.scripts.eval_mae import mae_degrees
    from tpu_splat_torch.scripts.render import add_capacity_flags, capacity_config, find_max_iteration
    from tpu_splat_torch.train.losses import psnr, ssim

    scene_dir, model_dir = os.path.join(P8_DIR, "scene"), os.path.join(P8_DIR, "model")
    bench_dir, ck_dir = os.path.join(P8_DIR, "bench"), os.path.join(P8_DIR, "checkpoint")
    torch_home = os.path.join(P8_DIR, "torch_home")
    bgd = torch.zeros(3, device=dev)
    launches, seconds, saved, out = {}, {}, [], {}
    real_save = image_utils.save_image_u8

    def recording_save(path, img):
        saved.append((path, bool(np.isfinite(np.asarray(img)).all())))
        real_save(path, img)

    def run(label, cli, argv, renders=True):
        torch.cuda.synchronize()
        LAUNCHES.clear()
        n_saved = len(saved)
        t0 = time.perf_counter()
        cli.main(argv, device=str(dev))
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        launches[label] = LAUNCHES.get("tile_blend_forward", 0)
        if renders and launches[label] < 1:
            raise AssertionError(f"{label}: tile_blend_forward was not launched")
        bad = [p for p, finite in saved[n_saved:] if not finite]
        if bad:
            raise AssertionError(f"{label}: non-finite images {bad[:3]}")

    def u8(path):
        img = decode_png(path)
        if img is None:
            raise AssertionError(f"{path}: not decoded")
        return img[..., :3]

    def on_card(img):  # as the metrics CLI: / 255.0 in float64, then float32
        return torch.as_tensor(img / 255.0, dtype=torch.float32, device=dev)

    def png_metrics(split_dir):
        """{name: (PSNR, SSIM)} of renders/ against gt/ under split_dir."""
        names = sorted(os.listdir(os.path.join(split_dir, "renders")))
        res = {}
        for n in names:
            a, b = (on_card(u8(os.path.join(split_dir, d, n))) for d in ("renders", "gt"))
            res[n] = (float(psnr(a, b)), float(ssim(a, b)))
        return res

    def results(model, method):
        with open(os.path.join(model, "results.json")) as f:
            return json.load(f)[method]

    def hold_capacity(model, cams, cfg):
        """A CLI's config holds this model's frames: no instance dropped, no
        pad past its budget. -> the most instances."""
        most = 0
        for cam in cams:
            o = render_fast(model, cam, cfg, bgd)
            n = int(o.num_instances)
            if n > cfg.max_instances or int(o.pad_overflow):
                raise AssertionError(f"{n} instances (capacity {cfg.max_instances}), "
                                     f"pad overflow {int(o.pad_overflow)}")
            most = max(most, n)
        return most

    image_utils.save_image_u8 = recording_save
    try:
        # 9a. the bench cloud as a model of phase 8's scene, through render.py
        t0 = time.perf_counter()
        save_ply(state, os.path.join(bench_dir, "point_cloud", "iteration_1", "point_cloud.ply"))
        save_cfg_args(bench_dir, build_parser().parse_args(
            ["-s", scene_dir, "-m", bench_dir, "-r", "1", "--eval"]))
        ply_s = time.perf_counter() - t0
        caps_parser = argparse.ArgumentParser()
        add_capacity_flags(caps_parser)
        bench_cfg = capacity_config(caps_parser.parse_args(P9_BENCH_CAPS))
        scene = Scene(scene_dir, resolution=1, eval_split=True, shuffle=False, device=dev)
        views = [lc.camera for lc in (*scene.test_cameras, *scene.train_cameras)]
        test_cam = views[0]
        inst_a = hold_capacity(state, views, bench_cfg)
        run("9a render", render_cli, ["-m", bench_dir, *P9_BENCH_CAPS])
        split = {k: os.path.join(bench_dir, k, "ours_1") for k in ("train", "test")}
        n_png = {k: (len(os.listdir(os.path.join(d, "renders"))), len(os.listdir(os.path.join(d, "gt"))))
                 for k, d in split.items()}
        envs = [os.path.exists(os.path.join(bench_dir, f"env_cood{i}.png")) for i in (1, 2)]
        if n_png != {"train": (P8_VIEWS - 1,) * 2, "test": (1, 1)} or not all(envs):
            raise AssertionError(f"9a wrote {n_png} renders/gt, env previews {envs}")
        if launches["9a render"] != P8_VIEWS:
            raise AssertionError(f"9a: {launches['9a render']} launches for {P8_VIEWS} views")
        gt_equal = np.array_equal(u8(os.path.join(split["test"], "gt", "00000.png")),
                                  u8(os.path.join(scene_dir, "images", "view_00.png")))
        bench_psnr = {f"{k}/{n}": v[0] for k, d in split.items() for n, v in png_metrics(d).items()}
        min_psnr = min(bench_psnr.values())
        if min_psnr < P9_MIN_PSNR or not gt_equal:
            raise AssertionError(f"9a: PSNR against phase 8's PNGs {bench_psnr}, gt equal {gt_equal}")
        out["render_bench"] = dict(ply_save_s=ply_s, cli_s=seconds["9a render"],
                                   launches=launches["9a render"], psnr=bench_psnr,
                                   min_psnr=min_psnr, instances=inst_a)
        log("9a render", gaussians=state.num_alive, views=P8_VIEWS, pngs=json.dumps(n_png),
            min_psnr=f"{min_psnr:.2f}", instances=inst_a, launches=launches["9a render"],
            cli_s=f"{seconds['9a render']:.2f}", ply_save_s=f"{ply_s:.2f}")

        # 9b. metrics.py on 9a's output, against phase 9's own means
        with no_lpips_weights(torch_home):
            run("9b metrics", metrics, ["-m", bench_dir], renders=False)
        res = results(bench_dir, "ours_1")
        test_views = png_metrics(split["test"]).values()
        own = dict(PSNR=float(np.mean([v[0] for v in test_views])),
                   SSIM=float(np.mean([v[1] for v in test_views])))
        off = {k: abs(res[k] - own[k]) for k in own}
        if (any(off[k] > P9_METRIC_TOL[k] for k in off) or not math.isnan(res["LPIPS"])
                or res["LPIPS_METRIC"] != "unavailable (NaN)" or not math.isfinite(res["GMSD"])):
            raise AssertionError(f"9b: results.json {res} against {own}")
        out["metrics_bench"] = dict(results=res, own=own, off=off)
        log("9b metrics", psnr=f"{res['PSNR']:.4f}", ssim=f"{res['SSIM']:.5f}",
            gmsd=f"{res['GMSD']:.5f}", lpips=res["LPIPS_METRIC"].replace(" ", "_"),
            psnr_off=f"{off['PSNR']:.2g}", ssim_off=f"{off['SSIM']:.2g}")

        # 9c. eval_fps.py on the bench model: one warm-up, then the repeats
        run("9c eval_fps", eval_fps, ["-m", bench_dir, "--repeats", str(P9_FPS_REPEATS),
                                      *P9_BENCH_CAPS])
        with open(os.path.join(bench_dir, "fps.txt")) as f:
            fps, count = f.read().split()
        want = 1 + P9_FPS_REPEATS * n_png["test"][0]
        if launches["9c eval_fps"] != want or int(count) != state.num_alive:
            raise AssertionError(f"9c: {launches['9c eval_fps']} launches (want {want}), "
                                 f"count {count} (want {state.num_alive})")
        served = detail["serve"]
        out["eval_fps"] = dict(fps=float(fps), ms_frame=1e3 / float(fps), gaussians=int(count),
                               launches=want, served_view0_ms=served["view0"]["wall_ms"],
                               served_full_shape_ms=served["full-shape"]["wall_ms"])
        log("9c eval_fps", fps=f"{float(fps):.2f}", ms_frame=f"{1e3 / float(fps):.2f}",
            gaussians=count, launches=want,
            phase4_served_ms=f"{served['view0']['wall_ms']:.2f}",
            phase4_full_shape_ms=f"{served['full-shape']['wall_ms']:.2f}")

        # 9d. phase 8's trained model: the PLY of its newest iteration, then
        # its checkpoint with the ISP (a model directory of its own: the
        # train CLI's cfg_args holds start_checkpoint=None, and persisted
        # values win over the command line, as in the JAX package)
        run("9d render", render_cli, ["-m", model_dir])
        ply_test = png_metrics(os.path.join(model_dir, "test", f"ours_{P8_STOP}"))
        ply_psnr = float(np.mean([v[0] for v in ply_test.values()]))
        trainer = detail["train_from_disk"]["test_psnr"][P8_STOP]
        if abs(ply_psnr - trainer) > P9_TRAINER_GAP:
            raise AssertionError(f"9d: test PSNR {ply_psnr} from the PNGs, the trainer's {trainer}")
        ck = os.path.join(model_dir, f"chkpnt{P8_RESUME_FROM}.npz")
        save_cfg_args(ck_dir, build_parser().parse_args(
            ["-s", scene_dir, "-m", ck_dir, "-r", "1", "--eval"]))
        run("9d render checkpoint", render_cli, ["-m", ck_dir, "--start_checkpoint", ck,
                                                  *P9_BENCH_CAPS])
        with no_lpips_weights(torch_home):
            run("9d metrics", metrics, ["-m", model_dir, ck_dir], renders=False)
        res_ply, res_ck = results(model_dir, f"ours_{P8_STOP}"), results(ck_dir, f"ours_{P8_RESUME_FROM}")
        # the checkpoint's test render with the ISP's controller, in process
        ck_state, _ = load_checkpoint_gaussians(ck, device=dev)
        isp = load_checkpoint_isp(ck, device=dev)
        plain = render_fast(ck_state, test_cam, bench_cfg, bgd).render
        q = lambda t: np.clip(t.cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8).astype(int)
        png = u8(os.path.join(ck_dir, "test", f"ours_{P8_RESUME_FROM}", "renders", "00000.png"))
        isp_off = np.abs(png - q(apply_isp(isp, plain, frame_idx=-1))).max(-1)
        isp_moved = int((np.abs(png - q(plain)).max(-1) > 0).sum())
        del ck_state, plain
        if isp_off.max() > 1 or int((isp_off > 0).sum()) > FLIPS_PER_4096 * isp_off.size / 4096 \
                or isp_moved == 0:
            raise AssertionError(f"9d: checkpoint PNG off the in-process ISP render by "
                                 f"{int(isp_off.max())} levels; the ISP moved {isp_moved} px")
        out["trained"] = dict(test_psnr_png=ply_psnr, trainer_test_psnr=trainer,
                              gap=ply_psnr - trainer, results_ply=res_ply, results_checkpoint=res_ck,
                              checkpoint_isp_px_moved=isp_moved,
                              checkpoint_off_inprocess_px=int((isp_off > 0).sum()))
        log("9d trained", test_psnr_png=f"{ply_psnr:.4f}", trainer=f"{trainer:.4f}",
            gap=f"{ply_psnr - trainer:+.4f}", metrics_ply=f"{res_ply['PSNR']:.4f}",
            metrics_checkpoint=f"{res_ck['PSNR']:.4f}", isp_px_moved=isp_moved,
            launches=f"{launches['9d render']},{launches['9d render checkpoint']}")

        # 9e. eval_mae.py against the bench cloud's normals of the test view
        normals_dir = os.path.join(scene_dir, "normals")
        gt_normal = render_fast(state, test_cam, bench_cfg, bgd).normal
        real_save(os.path.join(normals_dir, "view_00.png"), gt_normal.cpu().numpy() * 0.5 + 0.5)
        trained = load_ply(os.path.join(model_dir, "point_cloud", f"iteration_{P8_STOP}",
                                        "point_cloud.ply"), device=dev)
        # the config eval_mae, visible_gaussians and the videos render at:
        # their capacity flags, which the trainer's cfg_args fills (the JAX
        # CLIs' RasterConfig() holds 1<<20 instances; this model needs more)
        parser = build_parser(fill_none_model=True)
        add_capacity_flags(parser)
        cli_cfg = capacity_config(get_combined_args(parser, ["-m", model_dir]))
        inst_e = hold_capacity(trained, [test_cam], cli_cfg)
        run("9e eval_mae", eval_mae, ["-m", model_dir, "--gt_normals_dir", normals_dir])
        with open(os.path.join(model_dir, "mae.txt")) as f:
            mae = float(f.read())
        o = render_fast(trained, test_cam, cli_cfg, bgd)
        gt = u8(os.path.join(normals_dir, "view_00.png")) / 255.0 * 2.0 - 1.0
        mae_own = mae_degrees(o.normal.cpu().numpy(), gt, o.alpha.cpu().numpy()[..., 0])
        if not abs(mae - mae_own) <= P9_MAE_TOL:
            raise AssertionError(f"9e: mae.txt {mae} against {mae_own}")
        out["eval_mae"] = dict(mae=mae, in_process=mae_own, instances=inst_e)
        log("9e eval_mae", mae_deg=f"{mae:.4f}", in_process=f"{mae_own:.4f}", instances=inst_e,
            capacity=cli_cfg.max_instances, launches=launches["9e eval_mae"])

        # 9f. visible_gaussians.py over every view (eval_split off: all train)
        inst_f = hold_capacity(trained, views, cli_cfg)
        run("9f visible_gaussians", visible_gaussians, ["-m", model_dir, "--iteration", str(P8_STOP)])
        with open(os.path.join(model_dir, "visible.txt")) as f:
            visible, total = map(int, f.read().split())
        pruned = load_ply(os.path.join(model_dir, "point_cloud", f"iteration_{P8_STOP}_visible",
                                       "point_cloud.ply"), device=dev)
        # the pruned model re-renders every view: the kernel carries T from
        # one 128-instance chunk to the next (the JAX chunk semantics), so
        # pruning shifts the chunk bounds and rounds T apart by ulps; and a
        # Gaussian with max weight 0 may still have passed the alpha test as
        # the one that ends a pixel (its T_after < 1e-4), whose removal can
        # let a later one in (PARITY.md D4). So: colour and alpha within TOL
        # but at most FLIPS_PER_4096 px a view; every word apart is counted.
        words, over, worst = 0, 0, 0.0
        seen = torch.zeros(pruned.capacity, dtype=torch.bool, device=dev)
        for cam in views:
            a, b = render_fast(trained, cam, cli_cfg, bgd), render_fast(pruned, cam, cli_cfg, bgd)
            words += sum(int((getattr(a, f).view(torch.int32) != getattr(b, f).view(torch.int32)).sum())
                         for f in ("render", "alpha"))
            d = torch.maximum((a.render - b.render).abs().amax(-1), (a.alpha - b.alpha).abs()[..., 0])
            over += int((d > TOL).sum())
            worst = max(worst, float(d.max()))
            seen |= b.gaussian_weights > 0.0
        try:
            find_max_iteration(model_dir)
            raise AssertionError("find_max_iteration read iteration_*_visible")
        except ValueError:  # the JAX package's behaviour: later steps pass --iteration
            pass
        if not (visible <= total == trained.num_alive and pruned.num_alive == visible
                and over <= FLIPS_PER_4096 * len(views) * H * W / 4096 and bool(seen.all())):
            raise AssertionError(f"9f: visible {visible}/{total} (alive {trained.num_alive}), "
                                 f"pruned re-render: {over} px over {TOL}, max {worst}, "
                                 f"{int((~seen).sum())} kept Gaussians unseen")
        out["visible"] = dict(visible=visible, total=total, instances=inst_f,
                              rerender_words_apart=words, rerender_px_over_tol=over,
                              rerender_max_abs=worst)
        log("9f visible", visible=visible, total=total, rerender_words_apart=words,
            rerender_px_over_tol=over, rerender_max_abs=f"{worst:.3g}", instances=inst_f,
            launches=launches["9f visible_gaussians"])
        del pruned, seen

        # 9g. the trajectory CLIs (full render, render_fast) at full width.
        # generate_path fits an ellipse around the cameras' centroid and
        # aims at it (MipNeRF-360's path, for captures that circle the
        # scene); phase 8's views span 3pi/8 of arc, so its path looks past
        # the cloud: recorded below. The CLIs run on phase 8's trained PLY
        # under a rig of eight views around the full orbit (phase 8's
        # images, read but unused by these CLIs; the rig's cameras stand in
        # for the CLI's COLMAP round trip, ~1e-8 apart, in the capacity hold)
        arc_path = generate_path(scene.test_cameras + scene.train_cameras, n_frames=P9_FRAMES)
        arc_lit = [float((render_fast(trained, c, cli_cfg, bgd).render > 0).any(-1).float().mean())
                   for c in arc_path]
        rig = [orbit_camera(H, W, radius=6.0, azimuth=0.4 + k * 2 * math.pi / P8_VIEWS,
                            elevation=0.3, device=dev) for k in range(P8_VIEWS)]
        orbit_scene, orbit_model = os.path.join(P8_DIR, "orbit_scene"), os.path.join(P8_DIR, "orbit")
        os.makedirs(orbit_scene)
        os.symlink(os.path.join(scene_dir, "images"), os.path.join(orbit_scene, "images"))
        xyz = trained.xyz[:1024].cpu().double().numpy()
        write_model(*colmap_rig(rig), (xyz, np.zeros((len(xyz), 3), np.uint8), np.zeros(len(xyz))),
                    os.path.join(orbit_scene, "sparse", "0"))
        ply_dir = os.path.join("point_cloud", f"iteration_{P8_STOP}")
        shutil.copytree(os.path.join(model_dir, ply_dir), os.path.join(orbit_model, ply_dir))
        save_cfg_args(orbit_model, build_parser().parse_args(
            ["-s", orbit_scene, "-m", orbit_model, "-r", "1"]))
        path = generate_path([types.SimpleNamespace(camera=c) for c in rig], n_frames=P9_FRAMES)
        inst_g = hold_capacity(trained, path, bench_cfg)
        del scene, trained
        it = ["-m", orbit_model, "--iteration", str(P8_STOP), "--n_frames", str(P9_FRAMES),
              *P9_BENCH_CAPS]
        run("9g render_videos", render_videos, [*it, "--render_path"])
        run("9g video", video, it)
        traj = os.path.join(orbit_model, "traj", f"ours_{P8_STOP}")
        frames = {k: sorted(glob.glob(os.path.join(traj, *g))) for k, g in
                  (("color", ("renders", "*.png")), ("depth", ("depth", "*.png")),
                   ("video", ("*.png",)))}
        lit = {k: [float((u8(f) > 0).any(-1).mean()) for f in v] for k, v in frames.items()}
        shapes = {u8(f).shape for v in frames.values() for f in v}
        mp4 = {name: os.path.exists(os.path.join(orbit_model, name)) for name in
               (f"traj_color_{P8_STOP}.mp4", f"traj_depth_{P8_STOP}.mp4", f"traj_{P8_STOP}.mp4")}
        if (any(len(v) != P9_FRAMES for v in frames.values()) or shapes != {(H, W, 3)}
                or min(min(v) for v in lit.values()) <= 0.0
                or launches["9g render_videos"] != P9_FRAMES or launches["9g video"] != P9_FRAMES):
            raise AssertionError(f"9g: frames {({k: len(v) for k, v in frames.items()})}, "
                                 f"shapes {shapes}, lit {lit}, launches {launches}")
        out["trajectories"] = dict(frames=P9_FRAMES, lit_share=lit, mp4=mp4, instances=inst_g,
                                   phase8_arc_path_lit_share=arc_lit,
                                   seconds={k: seconds[k] for k in ("9g render_videos", "9g video")})
        log("9g trajectories", frames=P9_FRAMES, size=f"{H}x{W}",
            min_lit_share=f"{min(min(v) for v in lit.values()):.3f}",
            arc_path_lit=",".join(f"{v:.2f}" for v in arc_lit), instances=inst_g,
            mp4=("written" if all(mp4.values()) else "muxer missing"),
            render_videos_s=f"{seconds['9g render_videos']:.2f}", video_s=f"{seconds['9g video']:.2f}")

        # 9h. the reporting tools on 9a's and 9d's outputs
        run("9h view_diff_maps", view_diff_maps, ["-m", bench_dir, model_dir], renders=False)
        sheets = (glob.glob(os.path.join(bench_dir, "test", "ours_1", "diff_maps", "*.png"))
                  + glob.glob(os.path.join(model_dir, "test", f"ours_{P8_STOP}", "diff_maps", "*.png")))
        scenes = ["bench", "model", "checkpoint"]
        extract_metrics.main(["--output_path", P8_DIR, "--scenes", *scenes])
        collect_results.main(["--output_path", P8_DIR, "--scenes", *scenes])
        run("9h report", report, ["-m", model_dir, "--iteration", str(P8_STOP)], renders=False)
        with open(os.path.join(P8_DIR, "results.csv")) as f:
            csv_rows = [r.split("\t") for r in f.read().splitlines()]
        with open(os.path.join(P8_DIR, "results_all.csv")) as f:
            all_rows = [r.split("\t") for r in f.read().splitlines()]
        with open(os.path.join(model_dir, "stats.json")) as f:
            stats = json.load(f)
        if (len(sheets) != 2 or any(u8(p).ndim != 3 for p in sheets)
                or csv_rows[0][:3] != scenes or len(csv_rows) != 6
                or [r[0] for r in all_rows] != ["scene", *scenes]
                or all_rows[1][-1] != str(state.num_alive)
                or stats["n_gaussians"] != total):
            raise AssertionError(f"9h: sheets {sheets}, results.csv {csv_rows}, "
                                 f"results_all.csv {all_rows}, stats {stats}")
        out["reports"] = dict(diff_sheets=len(sheets), results_all=all_rows, stats=stats)
        log("9h reports", diff_sheets=len(sheets), results_csv_rows=len(csv_rows),
            results_all_rows=len(all_rows), stats_gaussians=stats["n_gaussians"])
    finally:
        image_utils.save_image_u8 = real_save
    out.update(launches=launches, cli_seconds=seconds)
    detail["evaluate"] = out
    return launches


def read_mesh_ply(path):
    """-> (vertices [V,3] f32, colours [V,3] u8, faces [F,3] i32) of a
    save_mesh_ply file."""
    with open(path, "rb") as f:
        data = f.read()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    count = lambda e: int(next(l for l in lines if l.startswith(f"element {e}")).split()[-1])
    v = np.frombuffer(body, np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)]), count("vertex"))
    f = np.frombuffer(body[v.nbytes:], np.dtype([("n", "u1"), ("idx", "<i4", 3)]), count("face"))
    if (f["n"] != 3).any() or len(body) != v.nbytes + f.nbytes:
        raise AssertionError(f"{path}: not a triangle mesh of the counts in its header")
    return v["xyz"], v["rgb"], f["idx"]


def surface_distance(mesh, ex, spacing):
    """The geometric check of a fused mesh: for each vertex, over the views
    that see it (its normal, summed from its faces, faces the camera; it
    projects inside the frame where alpha > 0.5), the least |camera depth -
    rendered surf_depth at its pixel|, in voxels. -> (its quartiles over the
    seen vertices, the share of them within P10_SURFACE_VOXELS, the share of
    vertices seen)."""
    import torch

    dev = ex.depthmaps[0].device
    v = torch.as_tensor(mesh.vertices, device=dev).double()
    f = torch.as_tensor(mesh.faces, device=dev).long()
    fn = torch.linalg.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]], dim=-1)
    vn = torch.zeros_like(v).index_add_(0, f.reshape(-1), fn.repeat_interleave(3, dim=0))
    best = torch.full((len(v),), math.inf, dtype=torch.float64, device=dev)
    for cam, depth, alpha in zip(ex.cameras, ex.depthmaps, ex.alphamaps):
        wv, K = cam.world_view.double(), cam.K.double()
        pc = v @ wv[:3, :3].T + wv[:3, 3]
        z = pc[:, 2]
        u = torch.round(K[0, 0] * pc[:, 0] / z + K[0, 2])
        w = torch.round(K[1, 1] * pc[:, 1] / z + K[1, 2])
        facing = ((cam.camera_center.double() - v) * vn).sum(-1) > 0
        inside = facing & (z > 1e-6) & (u >= 0) & (u < cam.width) & (w >= 0) & (w < cam.height)
        ui, wi = u.clamp(0, cam.width - 1).long(), w.clamp(0, cam.height - 1).long()
        d = depth[wi, ui].double()
        seen = inside & (alpha[wi, ui] > 0.5) & (d > 0)
        best = torch.minimum(best, torch.where(seen, (z - d).abs(), math.inf))
    seen = torch.isfinite(best)
    gap = best[seen] / spacing
    if gap.numel() == 0:
        return [math.inf] * 3, 0.0, 0.0
    quartiles = [float(gap.quantile(q)) for q in (0.25, 0.5, 0.75)]
    return (quartiles, float((gap < P10_SURFACE_VOXELS).double().mean()),
            float(seen.double().mean()))


def phase10_mesh_and_viewer(state, dev, detail):
    """Slice 8: extract_mesh, view.py, the train CLI's viewer and
    test_rasterizer, each `main` called in this process on the card with
    the kernel launch counts set to 0 just before it and read just after.
    10a extracts phase 8's trained model at P10_MESH_RES over the bench
    cloud's cube (and 9g's full-orbit rig at the default bounds), and holds
    the card's grid against the CPU's on the card's maps; 10b serves phase
    8's model and the bench cloud (9a's model) to a loopback client in every
    mode; 10c trains P10_STEPS steps of phase 8's scene with the viewer on
    and a client asking for a frame mid-run; 10d renders the stage scene
    headless. -> {step: tile_blend_forward launches}."""
    import io
    import socket
    import struct
    import threading

    import torch

    from tpu_splat_torch import renderer
    from tpu_splat_torch.eval import mesh as tmesh
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.raster.config import RasterConfig
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.scripts import extract_mesh, test_rasterizer, view
    from tpu_splat_torch.scripts.render import load_iteration
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.viewer import network_gui

    scene_dir, model_dir = os.path.join(P8_DIR, "scene"), os.path.join(P8_DIR, "model")
    bench_dir, orbit_model = os.path.join(P8_DIR, "bench"), os.path.join(P8_DIR, "orbit")
    sync = torch.cuda.synchronize
    launches, out = {}, {}

    def clock(store, key, fn):
        """fn wrapped: each call synchronised and timed (seconds) into
        store[key], a list."""
        def call(*a, **k):
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            sync()
            store.setdefault(key, []).append(time.perf_counter() - t0)
            return r
        return call

    # 10a. extract_mesh
    def run_extract(label, argv):
        rec, real = {}, (tmesh.GaussianExtractor, tmesh.tsdf_fusion, tmesh.marching_tetrahedra)

        class Recording(real[0]):
            def reconstruction(self, cameras):
                rec["extractor"] = self
                return clock(rec, "render", super().reconstruction)(cameras)

        def fuse(*a, **k):
            rec["grid"] = clock(rec, "fusion", real[1])(*a, **k)
            return rec["grid"]

        def march(*a, **k):
            rec["mesh"] = clock(rec, "marching", real[2])(*a, **k)
            return rec["mesh"]

        tmesh.GaussianExtractor, tmesh.tsdf_fusion, tmesh.marching_tetrahedra = Recording, fuse, march
        try:
            sync()
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            extract_mesh.main(argv, device=str(dev))
            sync()
            total = time.perf_counter() - t0
            launches[label] = LAUNCHES.get("tile_blend_forward", 0)
        finally:
            tmesh.GaussianExtractor, tmesh.tsdf_fusion, tmesh.marching_tetrahedra = real
        peak = torch.cuda.max_memory_allocated() / 2**30
        ex, (tsdf, _, weight, origin, spacing), mesh = rec["extractor"], rec["grid"], rec["mesh"]
        n_views = len(ex.cameras)
        inst = [int(n) for n in ex.num_instances]
        model = argv[argv.index("-m") + 1]
        verts, _, faces = read_mesh_ply(os.path.join(model, "mesh", "fuse.ply"))
        quartiles, within, seen = surface_distance(mesh, ex, spacing)
        res = dict(views=n_views, launches=launches[label], instances=inst,
                   max_instances=ex.cfg.max_instances, voxels=int(tsdf.numel()),
                   observed_voxels=int((weight > 0).sum()), vertices=len(verts),
                   faces=len(faces), spacing=spacing, origin=origin.tolist(),
                   render_s=sum(rec["render"]), fusion_s=sum(rec["fusion"]),
                   marching_s=sum(rec["marching"]), total_s=total, peak_mem_gib=peak,
                   surface_gap_quartiles_voxels=quartiles, within_band_share=within,
                   seen_share=seen)
        if (launches[label] != n_views or max(inst) >= ex.cfg.max_instances
                or not np.array_equal(verts, mesh.vertices) or not np.array_equal(faces, mesh.faces)
                or len(faces) == 0 or not np.isfinite(verts).all()):
            raise AssertionError(f"{label}: {res}")
        if not (within >= P10_SURFACE_SHARE and seen >= P10_MIN_SEEN):
            raise AssertionError(f"{label}: {within:.3f} of the seen vertices within "
                                 f"{P10_SURFACE_VOXELS} voxels of the rendered surface, "
                                 f"{seen:.3f} seen: {res}")
        log(label, size=f"{H}x{W}", views=n_views, res=argv[argv.index("--mesh_res") + 1],
            voxels=res["voxels"], observed=res["observed_voxels"], vertices=len(verts),
            faces=len(faces), render_s=f"{res['render_s']:.2f}", fusion_s=f"{res['fusion_s']:.2f}",
            marching_s=f"{res['marching_s']:.2f}", total_s=f"{total:.2f}",
            peak_mem_gib=f"{peak:.2f}",
            gap_quartiles_voxels=",".join(f"{q:.2f}" for q in quartiles),
            within_band=f"{within:.3f}", seen_share=f"{seen:.3f}", max_instances_view=max(inst),
            capacity=ex.cfg.max_instances, launches=launches[label])
        return res, ex

    out["extract"], ex = run_extract("10a extract_mesh", [
        "-m", model_dir, "--iteration", str(P8_STOP), "--mesh_res", str(P10_MESH_RES),
        "--bounds", str(P10_BOUNDS)])
    # the card's grid against the CPU's, fed the card's maps
    maps = dict(depths=ex.depthmaps, colors=ex.rgbmaps, alphas=ex.alphamaps,
                Ks=[c.K for c in ex.cameras], w2cs=[c.world_view for c in ex.cameras],
                bounds_min=-np.ones(3) * P10_BOUNDS, bounds_max=np.ones(3) * P10_BOUNDS)
    grids, meshes, secs = {}, {}, {}
    for where in ("cuda", "cpu"):
        m = maps if where == "cuda" else {k: [t.cpu() for t in v] if isinstance(v, list) else v
                                          for k, v in maps.items()}
        t0 = time.perf_counter()
        grids[where] = tmesh.tsdf_fusion(**m, resolution=P10_CHECK_RES,
                                         z_chunk=P10_CHECK_RES if where == "cuda" else 16)
        meshes[where] = tmesh.marching_tetrahedra(grids[where][0], 0.0, origin=grids[where][3],
                                                  spacing=grids[where][4])
        sync()
        secs[where] = time.perf_counter() - t0
    tsdf_off = float((grids["cuda"][0].cpu() - grids["cpu"][0]).abs().max())
    weights_equal = torch.equal(grids["cuda"][2].cpu(), grids["cpu"][2])
    mesh_equal = all(np.array_equal(a, b) for a, b in zip(meshes["cuda"][:2], meshes["cpu"][:2]))
    out["card_vs_cpu"] = dict(res=P10_CHECK_RES, tsdf_max_abs=tsdf_off, weights_equal=weights_equal,
                              mesh_equal=mesh_equal, vertices=len(meshes["cpu"].vertices),
                              card_s=secs["cuda"], cpu_s=secs["cpu"])
    if tsdf_off > P10_TSDF_TOL or not weights_equal or not mesh_equal:
        raise AssertionError(f"10a card vs CPU: {out['card_vs_cpu']}")
    log("10a card vs cpu", res=P10_CHECK_RES, tsdf_max_abs=f"{tsdf_off:.3g}",
        weights_equal=weights_equal, mesh_equal=mesh_equal,
        vertices=len(meshes["cpu"].vertices), card_s=f"{secs['cuda']:.2f}",
        cpu_s=f"{secs['cpu']:.2f}")
    del ex, maps, grids, meshes
    if os.path.isdir(orbit_model):
        out["extract_orbit"], _ = run_extract("10a extract_mesh orbit", [
            "-m", orbit_model, "--iteration", str(P8_STOP), "--mesh_res", str(P10_MESH_RES),
            *P9_BENCH_CAPS])

    # 10b. view.py in a thread on an ephemeral port, a loopback client
    cam = orbit_camera(H, W, radius=6.0, azimuth=P8_AZIMUTHS[0], elevation=0.3, device=dev)

    def request(sock, mode, keep_alive=True):
        view_m = cam.world_view.cpu().numpy().T.copy()
        view_m[:, 1:3] *= -1
        vp = cam.full_proj.cpu().numpy().T.copy()
        vp[:, 1] *= -1
        hdr = json.dumps(dict(resolution_x=W, resolution_y=H, train=False, fov_y=cam.fovy,
                              fov_x=cam.fovx, z_near=cam.znear, z_far=cam.zfar,
                              keep_alive=keep_alive, scaling_modifier=1.0,
                              render_mode=mode)).encode()
        sock.sendall(struct.pack("<I", len(hdr)) + hdr + view_m.tobytes() + vp.tobytes())

    def recv(sock, n):
        buf = bytearray()
        while len(buf) < n:
            c = sock.recv(min(n - len(buf), 1 << 22))
            if not c:
                raise AssertionError("the server closed the connection")
            buf += c
        return bytes(buf)

    def reply(sock):
        frame = np.frombuffer(recv(sock, H * W * 3), np.uint8).reshape(H, W, 3)
        (n,) = struct.unpack("<I", recv(sock, 4))
        recv(sock, n)
        (n,) = struct.unpack("<I", recv(sock, 4))
        return frame, json.loads(recv(sock, n))

    def modes(sock):
        (n,) = struct.unpack("<I", recv(sock, 4))
        return json.loads(recv(sock, n))

    def recording_gui(guis, times):
        class Recording(network_gui.NetworkGUI):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                guis.append(self)

            def send(self, frame, *a, **k):
                return clock(times, "send", super().send)(frame, *a, **k)
        return Recording

    def wait_for(guis, errors, what):
        for _ in range(2400):
            if guis or errors:
                break
            time.sleep(0.05)
        if errors or not guis:
            raise AssertionError(f"{what} did not bind its viewer: {errors}")
        return guis[0].listener.getsockname()[1]

    def serve_view(label, model, iteration):
        guis, times, errors, frames, rtt = [], {}, [], {}, []
        real = (network_gui.NetworkGUI, renderer.render_fast, network_gui.encode_u8,
                network_gui.render_net_image)
        network_gui.NetworkGUI = recording_gui(guis, times)
        renderer.render_fast = clock(times, "render", real[1])
        network_gui.render_net_image = clock(times, "image", real[3])
        network_gui.encode_u8 = clock(times, "encode", real[2])

        def run():
            try:
                view.main(["-m", model, "--port", "0", "--iteration", str(iteration)],
                          device=str(dev))
            except BaseException as e:  # reported by the phase
                errors.append(repr(e))

        LAUNCHES.clear()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            port = wait_for(guis, errors, label)
            with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
                announced = modes(s)
                for i, mode in enumerate(network_gui.RENDER_MODES):
                    request(s, i)
                    frames[mode], metrics = reply(s)
                for _ in range(P10_TIMED_FRAMES):
                    t0 = time.perf_counter()
                    request(s, 0)
                    reply(s)
                    rtt.append((time.perf_counter() - t0) * 1e3)
        finally:
            if guis:
                guis[0].close()
            t.join(timeout=120)
            (network_gui.NetworkGUI, renderer.render_fast, network_gui.encode_u8,
             network_gui.render_net_image) = real
        n_frames = len(network_gui.RENDER_MODES) + P10_TIMED_FRAMES
        launches[label] = LAUNCHES.get("tile_blend_forward", 0)
        if t.is_alive() or errors or announced != network_gui.RENDER_MODES \
                or launches[label] != n_frames:
            raise AssertionError(f"{label}: alive {t.is_alive()}, errors {errors}, "
                                 f"{launches[label]} launches for {n_frames} frames")
        # each frame: the handler's render and encoder called directly
        st, _ = load_iteration(model, iteration, 3, dev)
        cfg = RasterConfig(**view.VIEW_CAPS)
        bgd = torch.zeros(3, device=dev)
        vcam = network_gui.viewer_camera(dict(
            width=W, height=H, fovx=cam.fovx, fovy=cam.fovy, znear=cam.znear, zfar=cam.zfar,
            world_view=cam.world_view.cpu().numpy(), full_proj=cam.full_proj.cpu().numpy()), dev)
        o = render_fast(st, vcam, cfg, bgd, collect_weights=False)
        apart = [m for m in network_gui.RENDER_MODES if not np.array_equal(
            frames[m], network_gui.encode_u8(network_gui.render_net_image(o, m)).cpu().numpy())]
        want = network_gui.encode_u8(render_fast(st, cam, cfg, bgd).render).cpu().numpy()
        off = np.abs(frames["RGB"].astype(int) - want.astype(int)).max(-1)
        n_off = int((off > 0).sum())
        # per timed frame: render_fast, the frame map and the uint8 encoder,
        # the copy to the host and the socket writes
        last = {k: np.array(v[-P10_TIMED_FRAMES:]) * 1e3 for k, v in times.items()}
        split = dict(render=float(np.median(last["render"])),
                     encode=float(np.median(last["image"] + last["encode"])),
                     send=float(np.median(last["send"])))
        # view.py's caps are the JAX view.py's: a frame past 1<<21 instances
        # drops the farthest there too (recorded, not held)
        res = dict(frames=n_frames, launches=launches[label], frames_apart_from_direct=apart,
                   instances=int(o.num_instances), max_instances=cfg.max_instances,
                   rgb_vs_camera_create_max=int(off.max()), rgb_vs_camera_create_px=n_off,
                   round_trip_ms=rtt, round_trip_ms_median=float(np.median(rtt)),
                   split_ms_median=split, metrics=metrics, gaussians=st.num_alive)
        if apart or off.max() > 1 or n_off > FLIPS_PER_4096 * off.size / 4096:
            raise AssertionError(f"{label}: {res}")
        log(label, gaussians=st.num_alive, size=f"{H}x{W}", frames=n_frames,
            launches=launches[label], round_trip_ms_median=f"{np.median(rtt):.2f}",
            render_ms=f"{split['render']:.2f}", encode_ms=f"{split['encode']:.2f}",
            send_ms=f"{split['send']:.2f}", rgb_px_off_camera_create=n_off,
            instances=int(o.num_instances), capacity=cfg.max_instances)
        return res

    # (9f's iteration_*_visible directory makes the newest-iteration search
    # raise, as in the JAX package: the iteration is named)
    out["view_trained"] = serve_view("10b view trained", model_dir, P8_STOP)
    out["view_bench"] = serve_view("10b view bench", bench_dir, 1)

    # 10c. the train CLI with its viewer on; a client asks for one frame mid-run
    guis, times, errors, got, served = [], {}, [], {}, []
    go = threading.Event()
    real = (network_gui.NetworkGUI, network_gui.service_viewer)

    def service(gui, st, cfg, bg, source, metrics, isp=None):
        if metrics["it"] == P10_REQUEST_AT:
            go.set()
        n0 = LAUNCHES.get("tile_blend_forward", 0)
        sync()
        t0 = time.perf_counter()
        ok = real[1](gui, st, cfg, bg, source, metrics, isp=isp)
        sync()
        served.append(dict(iteration=metrics["it"], frame=ok, ms=(time.perf_counter() - t0) * 1e3,
                           launches=LAUNCHES.get("tile_blend_forward", 0) - n0))
        return ok

    def client():
        try:
            if not go.wait(600):
                raise AssertionError(f"iteration {P10_REQUEST_AT} was not reached")
            port = guis[0].listener.getsockname()[1]
            with socket.create_connection(("127.0.0.1", port), timeout=300) as s:
                modes(s)
                t0 = time.perf_counter()
                request(s, 0, keep_alive=False)
                got["frame"], got["metrics"] = reply(s)
                got["round_trip_ms"] = (time.perf_counter() - t0) * 1e3
                got["closed"] = s.recv(1) == b""
        except BaseException as e:  # reported by the phase
            errors.append(repr(e))

    network_gui.NetworkGUI, network_gui.service_viewer = recording_gui(guis, times), service
    argv = ["-s", scene_dir, "-m", os.path.join(P8_DIR, "viewer_run"),
            *[a for a in P8_ARGS if a != "--disable_viewer"], "--port", "0"]
    ct = threading.Thread(target=client, daemon=True)
    ct.start()
    LAUNCHES.clear()
    try:
        ts, rec = run_train_cli(argv, P10_STEPS, str(dev))
    finally:
        go.set()
        network_gui.NetworkGUI, network_gui.service_viewer = real
        ct.join(timeout=300)
    launches["10c train viewer"] = LAUNCHES.get("tile_blend_forward", 0)
    frames = [r for r in served if r["frame"]]
    quiet = [r["ms"] for r in served if not r["frame"]]
    after = {r["iteration"] for r in frames}
    step_ms = {r["iteration"]: r["ms"] for r in rec["steps"]}
    quiet_steps = [ms for it, ms in step_ms.items() if it > P8_WARMUP and it not in after
                   and it - 1 not in after]
    res = dict(steps=len(rec["steps"]), step=ts.step, served=frames, errors=errors,
               quiet_service_ms_median=float(np.median(quiet)) if quiet else None,
               quiet_step_ms_median=float(np.median(quiet_steps)),
               request_steps_ms={it: step_ms.get(it + 1) for it in after},
               client_round_trip_ms=got.get("round_trip_ms"), metrics=got.get("metrics"))
    if (errors or ts.step != P10_STEPS or len(frames) != 1 or frames[0]["launches"] != 1
            or got.get("frame") is None or not got["frame"].any() or not got.get("closed")
            or not guis or not guis[0].closed):
        raise AssertionError(f"10c: {res}")
    log("10c train viewer", steps=ts.step, frame_at_iteration=frames[0]["iteration"],
        frame_service_ms=f"{frames[0]['ms']:.2f}",
        quiet_service_ms=f"{res['quiet_service_ms_median']:.4f}",
        client_round_trip_ms=f"{got['round_trip_ms']:.2f}",
        quiet_step_ms_median=f"{res['quiet_step_ms_median']:.2f}",
        step_after_request_ms=",".join(f"{v:.2f}" for v in res["request_steps_ms"].values()
                                       if v is not None),
        launches=launches["10c train viewer"])
    out["train_viewer"] = res
    del ts, rec

    # 10d. test_rasterizer --headless
    LAUNCHES.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        test_rasterizer.main(["--headless"], device=str(dev))
    launches["10d test_rasterizer"] = LAUNCHES.get("tile_blend_forward", 0)
    line = buf.getvalue().strip().splitlines()[-1]
    coverage = float(line.split("coverage ")[1].split(",")[0])
    if not (line.startswith("stage render: (128, 128, 3)") and line.endswith("nan=False")
            and coverage > 0.0 and launches["10d test_rasterizer"] == 1):
        raise AssertionError(f"10d: {line!r}, {launches['10d test_rasterizer']} launches")
    out["test_rasterizer"] = dict(line=line, coverage=coverage)
    log("10d test_rasterizer", coverage=f"{coverage:.3f}", nan=False,
        launches=launches["10d test_rasterizer"])
    out["launches"] = launches
    detail["mesh_viewer"] = out
    return launches


def volumetric_leaves(state):
    """The bench cloud as volumetric Gaussians, as gradient leaves: three
    scale axes (the two surfel scales and the first again, as
    tests/test_raster.py:202 does), the rotations, the activated opacity and
    the SH; and each surfel's normal (its rotation's third column)."""
    import torch

    from tpu_splat_torch.core.transforms import quat_to_rotmat

    with torch.no_grad():
        sc = state.get_scaling()
        leaves = dict(xyz=state.xyz, scales3=torch.cat([sc, sc[:, :1]], 1),
                      rotation=state.rotation, opacity=state.get_opacity(),
                      sh=state.get_features())
        normals = quat_to_rotmat(state.rotation)[:, :, 2]
    return {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}, normals


def volumetric_frame(state, leaves, normals, cam, cfg, bg, aa, collect_weights=True):
    from tpu_splat_torch.raster import rasterize

    return rasterize(leaves["xyz"], leaves["scales3"], leaves["rotation"], leaves["opacity"],
                     state.get_refl().detach(), cam, bg, cfg, sh=leaves["sh"],
                     sh_degree=state.max_sh_degree, alive=state.alive, mode="volumetric",
                     normals=normals, antialiasing=aa, collect_weights=collect_weights)


@contextlib.contextmanager
def blend_inputs(store):
    """Record in `store` the gradients that reach the blend's inputs (the
    preprocess outputs hom, xy, normal_view, color, and the opacity): the
    blend's own backward, before the preprocess VJP."""
    import tpu_splat_torch.raster as rp

    edge = rp.backward_edge
    names = ("hom", "xy", "normal_view", "color", "opacity")

    def recording(name, kind, *xs):
        if name == "preprocess_vjp" and kind == "start":
            for k, x in zip(names, xs):
                if x.requires_grad:
                    x.register_hook(lambda g, k=k: store.__setitem__(k, g.detach()))
        return edge(name, kind, *xs)

    rp.backward_edge = recording
    try:
        yield
    finally:
        rp.backward_edge = edge


@contextlib.contextmanager
def jittered_kernel_maps(rel, seed=0):
    """The kernel path's blend outputs (colour, maps, reflection strength)
    each multiplied by 1 + u * rel, u uniform in [-1, 1] from `seed`: how
    far a step's gradients move when the blend's outputs move by rounding
    noise. A no-op for rel None."""
    import torch

    import tpu_splat_torch.raster as rp

    kp = rp.blend_kernel_path
    if rel is None:
        yield
        return
    gen = torch.Generator().manual_seed(9 + seed)

    def jittered(*a, **kw):
        o = kp(*a, **kw)
        jit = lambda x: x * (1.0 + rel * (2.0 * torch.rand(x.shape, generator=gen) - 1.0)
                             .to(x.device))
        return o._replace(color=jit(o.color), others=jit(o.others), refl_map=jit(o.refl_map))

    rp.blend_kernel_path = jittered
    try:
        yield
    finally:
        rp.blend_kernel_path = kp


def forward_visits(libs, feats, index, kw):
    """The forward's (instance, warp) pair iterations on these inputs, from
    the profile builds with and without the cull (one launch each)."""
    import ctypes

    import torch

    import kernel_ab

    out = {}
    for name in ("fwd:profile", "fwd:profile_no_cull"):
        f = libs[name].tile_blend_fwd_profile
        f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int
        buf = (ctypes.c_ulonglong * 5)()
        f(buf)  # zero the counters
        kernel_ab.fwd_launch(libs[name], feats, index, **kw)
        torch.cuda.synchronize()
        if f(buf) != 0:
            raise RuntimeError(f"{name}: reading the profile failed")
        out[name] = dict(pair_iterations=int(buf[3]), accepting_iterations=int(buf[4]))
    visited = out["fwd:profile"]["pair_iterations"]
    uncut = out["fwd:profile_no_cull"]["pair_iterations"]
    return dict(visited=visited, without_cull=uncut, culled_share=1.0 - visited / max(uncut, 1),
                accepting=out["fwd:profile"]["accepting_iterations"])


def phase11_modes(dev, detail, views, fwd_libs):
    """Slice 9: the volumetric frame and gradient through the tile kernels
    (11a), the scan blend (11b), expand_mode="scan" (11c) and the
    brute-force oracle (11d). Returns the kernel launches of 11a's timed
    volumetric fwd+bwd, counted from 0."""
    import dataclasses

    import torch

    import kernel_ab
    from tpu_splat_torch.core.device import record_stages
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.kernels import tile_blend as tb
    from tpu_splat_torch.raster import rasterize
    from tpu_splat_torch.raster.binning import bin_gaussians
    from tpu_splat_torch.raster.bruteforce import blend_bruteforce
    from tpu_splat_torch.raster.config import RasterConfig, production_config
    from tpu_splat_torch.raster.preprocess import preprocess
    from tpu_splat_torch.raster.volumetric import preprocess_volumetric
    from tpu_splat_torch.renderer import render_fast
    from tpu_splat_torch.train.grow import check_growth
    from tpu_splat_torch.train.step import make_train_step

    card = card_line()
    bgd = torch.zeros(3, device=dev)
    state = build_state(N_GAUSS, CAPACITY, device=dev)
    cam = views[0]
    p11 = detail["phase11"] = {"card": card}

    # 11a. the volumetric frame at the bench capacities and production
    # switches; a frame that would drop instances (a circular 3-sigma rect
    # covers more tiles than the surfel AABB) sizes max_instances from its
    # first call
    leaves, normals = volumetric_leaves(state)
    caps = dict(PROD)
    probes = {}
    for aa in (False, True):
        with torch.no_grad():
            o = volumetric_frame(state, leaves, normals, cam, production_config(**caps), bgd, aa)
        probes[aa] = dict(instances=int(o.num_instances), max_tile_count=int(o.tile_counts.max()),
                          pad_overflow=int(o.pad_overflow))
    need = max(p["instances"] for p in probes.values())
    if need > caps["max_instances"]:
        caps["max_instances"] = -(-int(need * P11_HEADROOM) // 4096) * 4096
    pad = 128 if any(p["pad_overflow"] for p in probes.values()) else 96
    cfg = production_config(**caps, pad_per_tile=pad)
    full_cfg = RasterConfig(**caps)
    log("11a volumetric first call", **{f"aa={int(k)}": json.dumps(v).replace(" ", "")
                                        for k, v in probes.items()},
        max_instances_used=caps["max_instances"], pad_per_tile=pad, card=repr(card))
    p11["first_call"] = dict(probes={int(k): v for k, v in probes.items()},
                             max_instances=caps["max_instances"], pad_per_tile=pad)

    # the forward kernel against its plain version on sampled tiles of the
    # volumetric frame, every variant, both slabs; the visited pairs and the
    # cull's exactness (the no-cull build bit for bit) beside the surfel frame
    surfel_in = captured_kernel_inputs(state, cam, production_config(**PROD), bgd)
    served = dict(train_shape=True, packed_feats=True, collect_wmax=False)
    visits = {"surfel": forward_visits(fwd_libs, *surfel_in, served)}
    del surfel_in
    g = torch.Generator().manual_seed(11)
    fwd_res = {}
    for aa in (False, True):
        inputs = {p: captured_forward(lambda c=c: volumetric_frame(
            state, leaves, normals, cam, c, bgd, aa, collect_weights=False))
            for p, c in ((True, cfg), (False, full_cfg))}
        counts = inputs[True][1][1]
        others = torch.randperm(counts.numel(), generator=g)[: N_SAMPLED_TILES - 1].to(dev)
        tiles = torch.unique(torch.cat([torch.argmax(counts)[None], others]))
        res, worst = check_variants(inputs, tiles, f"volumetric aa={int(aa)}, sampled tiles")
        fwd_res[aa] = dict(variants=res, max_abs_err=worst)
        bad = {}
        for train, packed, wm in itertools.product((False, True), repeat=3):
            kw = dict(train_shape=train, packed_feats=packed, collect_wmax=wm)
            feats_p, index_p = inputs[packed]
            o_k, w_k = tb.tile_blend_forward(feats_p, *index_p, **kw)
            o_n, w_n = kernel_ab.fwd_launch(fwd_libs["fwd:no_cull"], feats_p, index_p, **kw)
            n = (int((o_k.view(torch.int32) != o_n.view(torch.int32)).sum())
                 + int((w_k.view(torch.int32) != w_n.view(torch.int32)).sum()))
            if n:
                bad[f"train={int(train)},packed={int(packed)},wmax={int(wm)}"] = n
        if bad:
            raise AssertionError(f"volumetric aa={int(aa)}: the cull moved bits: {bad}")
        visits[f"volumetric aa={int(aa)}"] = dict(
            forward_visits(fwd_libs, *inputs[True], served), cull_bit_exact=True)
        del inputs
    log("11a forward visits", **{k: json.dumps(v).replace(" ", "") for k, v in visits.items()})
    p11["forward"] = {int(k): v for k, v in fwd_res.items()}
    p11["forward_visits"] = visits

    # one fwd+bwd of an L2 loss in means, scales3, rotations, opacity and SH:
    # a warm-up with the backward kernels' inputs captured (held against
    # their plain versions), then the timed run, its launches counted from 0
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(21)).to(dev)

    def fwd_bwd(aa):
        out = volumetric_frame(state, leaves, normals, cam, cfg, bgd, aa)
        loss = ((out.color - gt) ** 2).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return out, loss, grads

    grad_res = {}
    for aa in (False, True):
        with Capture() as cap:
            out, loss, grads = fwd_bwd(aa)
        (bargs, bkw), = cap.seen["tile_blend_backward"]
        feats, index, fwd, ct = bargs[0], bargs[1:5], bargs[5], bargs[6]
        counts = index[1]
        others = torch.randperm(counts.numel(), generator=g)[: N_SAMPLED_TILES - 1].to(dev)
        tiles = torch.unique(torch.cat([torch.argmax(counts)[None], others]))
        (sargs, _), = cap.seen["segment_sum_ranges"]
        grad_res[aa] = dict(
            tile_blend_backward=check_backward(feats, index, fwd, ct, bkw["full_grads"],
                                               bkw["packed_feats"], tiles),
            segment_sum_ranges=check_segsum(*sargs), loss=float(loss.detach()),
            instances=int(out.num_instances))
        for k, gr in zip(leaves, grads):
            if not (bool(torch.isfinite(gr).all()) and float(gr.abs().max()) > 0.0):
                raise AssertionError(f"volumetric aa={int(aa)}: bad gradient {k}")
        del cap, bargs, feats, fwd, ct, sargs, grads, out
        log("11a volumetric kernels vs plain", aa=int(aa),
            bwd=f"{grad_res[aa]['tile_blend_backward']['max_abs_err']:.3g}/"
                f"{grad_res[aa]['tile_blend_backward']['max_rel_err']:.3g}",
            segsum=f"{grad_res[aa]['segment_sum_ranges']['max_abs_err']:.3g}",
            instances=grad_res[aa]["instances"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ms_fb, (out, loss, grads) = wall_ms(lambda: fwd_bwd(False))
    launched = dict(LAUNCHES)
    missing = [n for n in TRAIN_KERNELS if n != "cubemap_tap_accumulate"
               and launched.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"volumetric fwd+bwd: kernels not launched: {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del out, grads
    frame_ms = {}
    for aa in (False, True):
        volumetric_frame(state, leaves, normals, cam, cfg, bgd, aa, collect_weights=False)
        with torch.no_grad():
            frame_ms[aa], _ = wall_ms(lambda: volumetric_frame(
                state, leaves, normals, cam, cfg, bgd, aa, collect_weights=False))
    runs = []
    for _ in range(3):
        with record_stages() as st_ms:
            total, _ = wall_ms(lambda: fwd_bwd(False))
        runs.append(dict(st_ms, fwd_bwd_wall=total))
    stages = {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[-1]}
    timing = dict(frame_ms={int(k): v for k, v in frame_ms.items()}, fwd_bwd_ms=ms_fb,
                  peak_mem_gib=peak, launches=launched, stages_ms=stages,
                  instances=int(grad_res[False]["instances"]))
    log("11a volumetric", frame_ms=f"{frame_ms[False]:.2f}", frame_aa_ms=f"{frame_ms[True]:.2f}",
        fwd_bwd_ms=f"{ms_fb:.2f}", instances=timing["instances"], peak_mem_gib=f"{peak:.2f}",
        launches=json.dumps(launched).replace(" ", ""), card=repr(card))
    log("11a volumetric stages", **{k: f"{v:.2f}" for k, v in stages.items()})
    p11["gradient"] = {int(k): v for k, v in grad_res.items()}
    p11["volumetric"] = timing

    # the volumetric preprocess on the card against the CPU, 100k of the
    # bench cloud at the bench view: every field binning reads, bit for bit
    preps = {}
    for d_ in ("cpu", dev):
        lv = {k: v.detach()[:TIGHT_SUBSET].to(d_) for k, v in leaves.items()}
        cam_d = orbit_camera(H, W, radius=6.0, azimuth=0.4, elevation=0.3, device=d_)
        with torch.no_grad():
            preps[d_] = preprocess_volumetric(
                lv["xyz"], lv["scales3"], lv["rotation"], normals[:TIGHT_SUBSET].to(d_),
                cam_d.world_view, cam_d.full_proj, cam_d.camera_center, H, W, cam_d.tanfovx,
                cam_d.tanfovy, sh=lv["sh"], sh_degree=state.max_sh_degree, antialiasing=True)
    prep_fields = ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
                   "tiles_touched", "valid")
    bad = {f: int((getattr(preps[dev][0], f).cpu() != getattr(preps["cpu"][0], f)).sum())
           for f in prep_fields}
    bad["opacity_scale"] = int((preps[dev][1].cpu() != preps["cpu"][1]).sum())
    if any(bad.values()):
        raise AssertionError(f"volumetric preprocess card vs CPU: {bad}")
    log("11a volumetric preprocess card vs cpu", gaussians=TIGHT_SUBSET, fields=len(bad),
        differing=0, valid=int(preps["cpu"][0].valid.sum()))
    p11["preprocess_card_vs_cpu"] = bad
    del preps, leaves, normals

    # 11b. the scan blend (backend="xla"): render_fast and one training step
    # at full width, tile_depth grown by check_growth's rule from the first
    # frame's max_tile_count; held against the kernel path with the same
    # (f32, RasterConfig) switches and capacities
    opt, ts, isp = train_start(state, N_VIEWS)
    scan_cfg = RasterConfig(**dict(PROD, tile_depth=P11_SCAN_FIRST_DEPTH), backend="xla")
    with torch.no_grad():
        first = render_fast(state, cam, scan_cfg, bgd)
    mtc = int(first.max_tile_count)
    diag = dict(n_alive=int(state.alive.sum()), num_instances=int(first.num_instances),
                max_tile_count=mtc, densify_overflow=0, pad_overflow=0)
    dec = check_growth(ts, scan_cfg, **diag)
    want_depth = -(-int(mtc * 1.5) // scan_cfg.chunk) * scan_cfg.chunk
    if mtc <= scan_cfg.tile_depth or dec.cfg.tile_depth != want_depth:
        raise AssertionError(f"check_growth: max_tile_count {mtc}, {dec.reasons}")
    # the grown config (the state's rows are not grown: the frame reads them)
    scan_cfg, growth = dec.cfg, list(dec.reasons)
    ker_cfg = dataclasses.replace(scan_cfg, backend="auto")
    del first, dec
    log("11b scan growth", first_tile_depth=P11_SCAN_FIRST_DEPTH, **diag,
        growth=repr("; ".join(growth)), tile_depth=scan_cfg.tile_depth,
        chunks=scan_cfg.n_chunks, max_instances=scan_cfg.max_instances)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    ms_scan, o_s = wall_ms(lambda: render_fast(state, cam, scan_cfg, bgd))
    peak_scan_frame = torch.cuda.max_memory_allocated() / 2**30
    if sum(LAUNCHES.values()):
        raise AssertionError(f"the scan frame launched kernels: {dict(LAUNCHES)}")
    check_frame(o_s, scan_cfg, "scan frame")
    del o_s

    def frame(c, record=None):
        with torch.no_grad(), patched_blend(record=record):
            return rasterize(state.xyz, state.get_scaling(), state.rotation, state.get_opacity(),
                             state.get_refl(), cam, bgd, c, sh=state.get_features(),
                             sh_degree=state.max_sh_degree, alive=state.alive)

    # the frame, with the pixels near a branch point of the blend in float64
    rec = []
    o_scan = frame(scan_cfg, rec)
    _, px_margin, _ = knife_margins(rec[0])
    near_knife = px_margin.amin(0) < KNIFE_BAND
    del rec, px_margin
    scan_vs_kernel = hold_images(o_scan, frame(ker_cfg), "scan vs kernel frame", near_knife)
    scan_vs_kernel["near_knife_pixels"] = int(near_knife.sum())
    log("11b scan vs kernel frame", **{k: (f"{v:.3g}" if isinstance(v, float) else v)
                                       for k, v in scan_vs_kernel.items()})
    del o_scan, near_knife

    # the two blends' VJPs under one cotangent (seeded) on colour, maps and
    # reflection strength: the gradients at the blend's inputs and at the
    # reflection strength, every row within P11_GRAD_TOL of each one's max
    gen = torch.Generator().manual_seed(5)
    cot = [torch.rand(sh, generator=gen).to(dev) - 0.5 for sh in ((H, W, 3), (H, W, 8), (H, W))]
    vjp = {}
    for name, c in (("kernel", ker_cfg), ("scan", scan_cfg)):
        vjp[name] = {}
        lv = [t.detach().requires_grad_() for t in (
            state.xyz, state.get_scaling(), state.rotation, state.get_opacity(),
            state.get_refl(), state.get_features())]
        with blend_inputs(vjp[name]):
            o = rasterize(*lv[:5], cam, bgd, c, sh=lv[5], sh_degree=state.max_sh_degree,
                          alive=state.alive)
            loss = sum((m * w).sum() for m, w in zip((o.color, o.others, o.refl_map), cot))
            vjp[name]["refl"] = torch.autograd.grad(loss, lv)[4]
        del o, loss, lv
    vjp_cmp = {}
    for k, gk in vjp["kernel"].items():
        n = gk.shape[0]
        scale = max(float(gk.abs().max()), 1e-30)
        rel = float((vjp["scan"][k] - gk).reshape(n, -1).abs().max()) / scale
        vjp_cmp[k] = rel
        if rel > P11_GRAD_TOL:
            raise AssertionError(f"scan blend VJP d{k}: {rel} of its max against the kernel's")
    log("11b scan vs kernel blend VJP", **{f"d{k}": f"{v:.3g}" for k, v in vjp_cmp.items()})
    del vjp, cot

    # one training step three ways: the kernels, the scan, and the kernels
    # with their blend outputs jittered by P11_JITTER (the rows such noise
    # moves: the step's loss amplifies its inputs' rounding, chiefly through
    # the normal loss; tests/scan_grad_witness.py)
    gt0 = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    steps = {}
    for name, c, jit in (("kernel", ker_cfg, None), ("scan", scan_cfg, None),
                         ("jittered", ker_cfg, P11_JITTER)):
        step = make_train_step(opt, c, 1.0, isp_cfg=isp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with jittered_kernel_maps(jit):
            ms, (_, aux) = wall_ms(lambda: step(ts, cam, gt0, bgd, frame_idx=0))
        steps[name] = dict(ms=ms, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                           aux=aux)
    ka, sa, ja = (steps[n]["aux"] for n in ("kernel", "scan", "jittered"))
    # each leaf: every row (a Gaussian's, or one entry of another leaf)
    # within P11_GRAD_TOL of the leaf's max, but for as many rows as the
    # jitter moves beyond it and at most FLIPS_PER_4096 per 4096 rows with
    # a gradient, each within twice the jitter's largest move
    grad_cmp = {}
    for k, ga in ka.grads.items():
        n = ga.shape[0] if ga.shape[0] == CAPACITY else ga.numel()
        scale = max(float(ga.abs().max()), 1e-30)
        err = (sa.grads[k] - ga).reshape(n, -1).abs().amax(1) / scale
        moved = (ja.grads[k] - ga).reshape(n, -1).abs().amax(1) / scale
        live = int((ga.reshape(n, -1).abs().amax(1) > 0).sum())
        over = err > P11_GRAD_TOL
        r = dict(rows_over=int(over.sum()), rows_with_gradient=live, worst=float(err.max()),
                 rel_others=float(err[~over].max()) if bool((~over).any()) else 0.0,
                 jitter_rows_over=int((moved > P11_GRAD_TOL).sum()),
                 jitter_worst=float(moved.max()))
        grad_cmp[k] = r
        if r["rows_over"] and (r["rows_over"] > r["jitter_rows_over"]
                               or r["rows_over"] > FLIPS_PER_4096 * live / 4096
                               or r["worst"] > 2.0 * r["jitter_worst"]):
            raise AssertionError(f"scan step gradient {k}: {r}")
    loss_rel = abs(float(sa.loss) - float(ka.loss)) / abs(float(ka.loss))
    if loss_rel > STEP_LOSS_TOL:
        raise AssertionError(f"scan step loss {float(sa.loss)} against {float(ka.loss)}")
    log("11b scan", frame_ms=f"{ms_scan:.1f}", frame_peak_gib=f"{peak_scan_frame:.2f}",
        step_ms=f"{steps['scan']['ms']:.1f}", step_peak_gib=f"{steps['scan']['peak_mem_gib']:.2f}",
        kernel_step_ms=f"{steps['kernel']['ms']:.1f}", loss_rel=f"{loss_rel:.3g}",
        rows_over=json.dumps({k: [v["rows_over"], v["jitter_rows_over"], f"{v['worst']:.3g}",
                                  f"{v['jitter_worst']:.3g}"] for k, v in grad_cmp.items()
                              if v["rows_over"]}).replace(" ", ""),
        card=repr(card))
    p11["scan"] = dict(first_frame=diag, growth=growth,
                       tile_depth=scan_cfg.tile_depth, frame_ms=ms_scan,
                       frame_peak_mem_gib=peak_scan_frame, vs_kernel=scan_vs_kernel,
                       blend_vjp=vjp_cmp,
                       steps={n: {k: v for k, v in r.items() if k != "aux"}
                              for n, r in steps.items()},
                       loss_rel=loss_rel, grads=grad_cmp)
    del steps, ka, sa, ja, ts

    # 11c. the bench view's binning under expand_mode="scan" equals
    # "gather"'s in every field, on the card (aligned and dense layouts)
    with torch.no_grad():
        prep = preprocess(state.xyz, state.get_scaling(), state.rotation, cam.world_view,
                          cam.full_proj, cam.camera_center, H, W, sh=state.get_features(),
                          sh_degree=state.max_sh_degree, opacity=state.get_opacity())
    prep = prep._replace(valid=prep.valid & state.alive)
    expand = {}
    for aligned in (True, False):
        b = {m: bin_gaussians(prep, H, W, production_config(**PROD, expand_mode=m),
                              aligned=aligned) for m in ("gather", "scan")}
        bad = {f: int((getattr(b["scan"], f) != getattr(b["gather"], f)).sum())
               for f in b["gather"]._fields}
        if any(bad.values()):
            raise AssertionError(f"expand_mode scan against gather (aligned={aligned}): {bad}")
        expand["aligned" if aligned else "dense"] = dict(
            fields=len(bad), instances=int(b["scan"].num_instances))
    log("11c expand_mode scan vs gather", **{k: json.dumps(v).replace(" ", "")
                                             for k, v in expand.items()}, differing=0)
    p11["expand_scan"] = expand
    del prep, b

    # 11d. the brute-force oracle against the kernel frame on the card
    st = small_scene(P11_BF_N, 4, dev)
    bcam = orbit_camera(P11_BF_HW, P11_BF_HW, radius=4.0, azimuth=0.4, elevation=0.3,
                        device=dev)
    bcfg = RasterConfig(**SMALL)
    bbg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    with torch.no_grad():
        ko = rasterize(st.xyz, st.get_scaling(), st.rotation, st.get_opacity(), st.get_refl(),
                       bcam, bbg, bcfg, sh=st.get_features(), sh_degree=1)
        bp = preprocess(st.xyz, st.get_scaling(), st.rotation, bcam.world_view, bcam.full_proj,
                        bcam.camera_center, P11_BF_HW, P11_BF_HW, sh=st.get_features(),
                        sh_degree=1)
        color, others, refl, T, ncon = blend_bruteforce(
            bp, st.get_opacity(), st.get_refl(), torch.ones_like(st.alive), bbg,
            P11_BF_HW, P11_BF_HW)
    bf = type(ko)(color=color, others=others, refl_map=refl, final_T=T, n_contrib=ncon,
                  radii=ko.radii, gaussian_weights=ko.gaussian_weights,
                  num_instances=ko.num_instances, max_area=ko.max_area,
                  tile_counts=ko.tile_counts, pad_overflow=ko.pad_overflow)
    bf_res = hold_images(ko, bf, "kernel frame vs brute force")
    if float(others[..., 1].max()) < 0.5:
        raise AssertionError("11d: the brute-force frame is empty")
    log("11d bruteforce vs kernel", size=f"{P11_BF_HW}x{P11_BF_HW}", gaussians=P11_BF_N,
        **{k: (f"{v:.3g}" if isinstance(v, float) else v) for k, v in bf_res.items()})
    p11["bruteforce"] = bf_res
    del state
    return launched


def p12_sizes() -> dict:
    """Phase 12's load, handed to its ranks (which import this file anew)."""
    return dict(h=H, w=W, n=N_GAUSS, capacity=CAPACITY, prod=PROD, cubemap=TRAIN_CUBEMAP)


def p12_load(dev, sz):
    """6c's load: (opt, TrainState in the deferred stage, ISPConfig, config,
    views 0 and 1 of the bench orbit, their ground truth, bg)."""
    import torch

    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.raster.config import production_config

    state = build_state(sz["n"], sz["capacity"], cubemap=sz["cubemap"], device=dev)
    opt, ts, isp = train_start(state, N_VIEWS)
    views = [orbit_camera(sz["h"], sz["w"], radius=6.0, azimuth=0.4 + k * math.pi / 2,
                          elevation=0.3, device=dev) for k in range(P12_RANKS)]
    gts = [torch.rand((sz["h"], sz["w"], 3), generator=torch.Generator().manual_seed(1 + k))
           .to(dev) for k in range(P12_RANKS)]
    return opt, ts, isp, production_config(**sz["prod"]), views, gts, torch.zeros(3, device=dev)


def p12_frame(state, cam, bg, mesh, sz):
    """The rasterizer's frame of the production switches with every channel
    (n_contrib among them), unsharded or over `mesh`."""
    import torch

    from tpu_splat_torch.raster import rasterize
    from tpu_splat_torch.raster.config import production_config

    cfg = production_config(grad_channels="full", **sz["prod"])
    with torch.no_grad():
        return rasterize(state.xyz, state.get_scaling(), state.rotation, state.get_opacity(),
                         state.get_refl(), cam, bg, cfg, sh=state.get_features(),
                         sh_degree=state.max_sh_degree, alive=state.alive, mesh=mesh)


def p12_leaf_errs(got: dict, want: dict) -> dict:
    """Each leaf's largest difference over its largest |value|."""
    out = {}
    for k, w in want.items():
        scale = float(w.abs().max())
        d = float((got[k] - w).abs().max())
        out[k] = d / scale if scale else d
    return out


def p12_hash(ts) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(ts.gaussians.param_pytree().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    h.update(ts.gaussians.alive.cpu().numpy().tobytes())
    for k in sorted(ts.opt.mu):
        h.update(ts.opt.mu[k].cpu().numpy().tobytes() + ts.opt.nu[k].cpu().numpy().tobytes())
    for x in ts.stats:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def p12_timed(fn, dev, reps=P12_TIMED):
    """fn() once to warm up, then `reps` host-clock runs ending in a
    synchronize; -> (median ms, the last result, the launches and the stage
    ms (CUDA events; none off the card) of the first timed run)."""
    import torch

    from tpu_splat_torch.core.device import record_stages
    from tpu_splat_torch.kernels import LAUNCHES

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed():
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    fn()
    LAUNCHES.clear()
    with record_stages() if on_card else contextlib.nullcontext({}) as stages:
        first, out = timed()
    launches = dict(LAUNCHES)
    times = [first] + [timed()[0] for _ in range(reps - 1)]
    return float(np.median(times)), out, launches, dict(stages)


def phase12a_one_rank(dev, detail, sz, backend="nccl"):
    """12a: the tile-sharded and DP steps over one NCCL rank in this
    process, against the unsharded step from the same state: bit for bit
    but env_texture's gradient, held to two unsharded runs' atomics gap."""
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_splat_torch.dist import make_mesh
    from tpu_splat_torch.train.step import make_train_step, make_train_step_dp

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            opt, ts, isp, cfg, views, gts, bg = p12_load(dev, sz)
            single = make_train_step(opt, cfg, 1.0, isp_cfg=isp)
            tiles = make_train_step(opt, cfg, 1.0, isp_cfg=isp, mesh=make_mesh(1, "tiles"))
            dp = make_train_step_dp(opt, cfg, 1.0, make_mesh(1, "dp"), isp_cfg=isp)
            runs = {
                "single": lambda: single(ts, views[0], gts[0], bg, frame_idx=0),
                "tiles": lambda: tiles(ts, views[0], gts[0], bg, frame_idx=0),
                "dp": lambda: dp(ts, views[:1], gts[:1], bg, frame_idx=[0]),
            }
            res = {name: p12_timed(fn, dev) for name, fn in runs.items()}
            _, s_again = runs["single"]()
            f1 = p12_frame(ts.gaussians, views[0], bg, None, sz)
            ft = p12_frame(ts.gaussians, views[0], bg, make_mesh(1, "tiles"), sz)
        finally:
            dist.destroy_process_group()
    (_, (s_new, s_aux), _, _) = res["single"]
    # with one rank the slab is the whole image and every collective the
    # identity: the frame, the loss, the render, the densify statistics and
    # every gradient leaf but env_texture are held bit for bit
    env_atomics = p12_leaf_errs({"env_texture": s_again.grads["env_texture"]},
                                {"env_texture": s_aux.grads["env_texture"]})["env_texture"]
    del s_again
    out = dict(frame=dict(color_equal=bool(torch.equal(f1.color, ft.color)),
                          n_contrib_equal=bool(torch.equal(f1.n_contrib, ft.n_contrib)),
                          gw_equal=bool(torch.equal(f1.gaussian_weights, ft.gaussian_weights)),
                          instances=(int(f1.num_instances), int(ft.num_instances))),
               env_texture_two_unsharded_runs=env_atomics)
    if not (out["frame"]["color_equal"] and out["frame"]["n_contrib_equal"]
            and out["frame"]["gw_equal"]
            and out["frame"]["instances"][0] == out["frame"]["instances"][1]):
        raise AssertionError(f"12a: the one-rank sharded frame departs: {out['frame']}")
    if env_atomics > P12_ENV_TOL:
        raise AssertionError(f"12a: two unsharded steps' env_texture gradients differ by "
                             f"{env_atomics:.3g} of its max, past P12_ENV_TOL")
    for name, (ms, (new, aux), launches, stages) in res.items():
        rec = dict(step_ms=ms, launches=launches, loss=float(aux.loss),
                   stages_ms={k: round(v, 3) for k, v in stages.items()})
        missing = [k for k in TRAIN_KERNELS if launches.get(k, 0) < 1]
        if missing and dev.type == "cuda":
            raise AssertionError(f"12a {name}: kernels not launched: {missing}")
        if name != "single":
            errs = p12_leaf_errs(aux.grads, s_aux.grads)
            bits = {k: bool(torch.equal(aux.grads[k], g)) for k, g in s_aux.grads.items()}
            stats_bits = all(bool(torch.equal(a, b)) for a, b in zip(new.stats, s_new.stats))
            rec.update(loss_equal=bool(torch.equal(aux.loss, s_aux.loss)),
                       render_equal=bool(torch.equal(aux.render, s_aux.render)),
                       grads_bit_equal=sorted(k for k, v in bits.items() if v),
                       grads_apart={k: errs[k] for k, v in bits.items() if not v},
                       stats_bit_equal=stats_bits)
            apart = set(rec["grads_apart"]) - {"env_texture"}
            if (not rec["loss_equal"] or not rec["render_equal"] or not stats_bits or apart
                    or errs["env_texture"] > P12_ENV_TOL):
                raise AssertionError(f"12a {name}: departs from the unsharded step: {rec}")
        out[name] = rec
        log(f"12a one rank, {backend}", step=name, ms=f"{ms:.2f}", loss=f"{float(aux.loss):.6f}",
            env_texture_two_unsharded_runs=f"{env_atomics:.3g}",
            **{k: json.dumps(v).replace(" ", "") for k, v in rec.items()
               if k in ("loss_equal", "render_equal", "grads_apart", "stats_bit_equal")})
    detail["phase12a"] = out
    return out


def phase12b_rank(rank: int, n: int, sz: dict) -> dict:
    """12b, one rank (started by tpu_splat_torch.dist.launch): the frame and
    the tile-sharded step against the unsharded ones, the DP step of n
    cameras against the mean of n single-camera steps, then a densify
    event; -> numbers and hashes (the parent compares the ranks)."""
    import torch

    from tpu_splat_torch.dist import make_mesh
    from tpu_splat_torch.train.loop import EventLog, run_scheduled_events
    from tpu_splat_torch.train.step import make_train_step, make_train_step_dp

    on_card = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opt, ts, isp, cfg, views, gts, bg = p12_load(dev, sz)
    mesh_t, mesh_d = make_mesh(n, "tiles"), make_mesh(n, "dp")
    out = dict(rank=rank, device=str(dev))

    f1 = p12_frame(ts.gaussians, views[0], bg, None, sz)
    fs = p12_frame(ts.gaussians, views[0], bg, mesh_t, sz)
    tiles_y, tiles_x = -(-sz["h"] // 16), -(-sz["w"] // 16)
    rh = -(-tiles_y // n)
    per_rank = [int(fs.tile_counts[k * rh * tiles_x:(k + 1) * rh * tiles_x].sum())
                for k in range(n)]
    out["frame"] = dict(
        color_err=float((fs.color - f1.color).abs().max()),
        n_contrib_equal=bool(torch.equal(fs.n_contrib, f1.n_contrib)),
        gw_err=float((fs.gaussian_weights - f1.gaussian_weights).abs().max()),
        instances_single=int(f1.num_instances), instances_per_rank=per_rank,
        instances_global_units=int(fs.num_instances))
    del f1, fs

    single = make_train_step(opt, cfg, 1.0, isp_cfg=isp)
    tiles = make_train_step(opt, cfg, 1.0, isp_cfg=isp, mesh=mesh_t)
    s_ms, (s_new, s_aux), _, _ = p12_timed(
        lambda: single(ts, views[0], gts[0], bg, frame_idx=0), dev)
    t_ms, (t_new, t_aux), t_launch, t_stages = p12_timed(
        lambda: tiles(ts, views[0], gts[0], bg, frame_idx=0), dev)
    out["tiles"] = dict(
        step_ms=t_ms, single_step_ms=s_ms, launches=t_launch,
        stages_ms={k: round(v, 3) for k, v in t_stages.items()},
        loss=(float(s_aux.loss), float(t_aux.loss)),
        render_err=float((t_aux.render - s_aux.render).abs().max()),
        grad_errs=p12_leaf_errs(t_aux.grads, s_aux.grads), hash=p12_hash(t_new))
    del t_new, t_aux

    dp = make_train_step_dp(opt, cfg, 1.0, mesh_d, isp_cfg=isp)
    d_ms, (d_new, d_aux), d_launch, d_stages = p12_timed(
        lambda: dp(ts, views, gts, bg, frame_idx=list(range(n))), dev)
    singles = [(s_new, s_aux)] + [single(ts, views[k], gts[k], bg, frame_idx=k)
                                  for k in range(1, n)]
    mean_g = {k: sum(a.grads[k] for _, a in singles) / n for k in d_aux.grads
              if k != "screen_offset"}
    stats = [s.stats for s, _ in singles]
    want = dict(grad_accum=sum(x.grad_accum for x in stats), denom=sum(x.denom for x in stats),
                accum_w=sum(x.accum_w for x in stats), denom_w=sum(x.denom_w for x in stats),
                max_radii=torch.stack([x.max_radii for x in stats]).amax(0))
    stat_errs = {}
    for f, w in want.items():
        scale = float(w.abs().max())
        stat_errs[f] = float((getattr(d_new.stats, f) - w).abs().max()) / (scale or 1.0)
    log_ = EventLog()
    ev = run_scheduled_events(d_new, P12_DENSIFY_AT, opt, cameras_extent=P12_EXTENT,
                              cameras_mean=np.zeros(3, np.float32), log=log_)
    out["dp"] = dict(
        step_ms=d_ms, launches=d_launch, stages_ms={k: round(v, 3) for k, v in d_stages.items()},
        loss=float(d_aux.loss), mean_single_loss=float(sum(float(a.loss) for _, a in singles) / n),
        grad_errs=p12_leaf_errs({k: d_aux.grads[k] for k in mean_g}, mean_g),
        stat_errs=stat_errs, hash_adam=p12_hash(d_new), hash_densify=p12_hash(ev),
        densify=dict(densified=log_.densified, pruned=log_.pruned,
                     alive=(int(d_new.gaussians.alive.sum()), int(ev.gaussians.alive.sum()))))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    return out


def phase12b_ranks(detail, sz):
    """12b: P12_RANKS ranks on the card(s); every rank's numbers held, and
    the ranks' states against each other."""
    import torch

    from tpu_splat_torch.dist import launch

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= P12_RANKS else "gloo"
    mode = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    t0 = time.perf_counter()
    ranks = launch(phase12b_rank, P12_RANKS, args=(P12_RANKS, sz), backend=backend)
    wall_s = time.perf_counter() - t0
    label = ("two ranks on separate cards over nccl" if backend == "nccl" else
             "two ranks sharing one card over gloo: not a speed measurement")
    log("12b ranks", backend=backend, cards=n_cards, compute_mode=repr(mode), seconds=f"{wall_s:.1f}",
        timing=repr(label))
    for r in ranks:
        f, t, d = r["frame"], r["tiles"], r["dp"]
        log("12b rank", rank=r["rank"], device=r["device"], peak_gib=f"{r['peak_gib']:.2f}",
            instances=json.dumps(f["instances_per_rank"]).replace(" ", ""),
            single=f["instances_single"], color_err=f"{f['color_err']:.3g}",
            n_contrib_equal=f["n_contrib_equal"], gw_err=f"{f['gw_err']:.3g}")
        log("12b rank", rank=r["rank"], tiles_ms=f"{t['step_ms']:.2f}",
            single_ms=f"{t['single_step_ms']:.2f}", dp_ms=f"{d['step_ms']:.2f}",
            grad_allreduce_ms=f"{t['stages_ms'].get('grad_allreduce', 0.0):.2f}",
            slab_gather_ms=f"{t['stages_ms'].get('slab_gather', 0.0):.2f}",
            dp_allreduce_ms=f"{d['stages_ms'].get('grad_allreduce', 0.0):.2f}",
            tiles_grad_err=f"{max(t['grad_errs'].values()):.3g}",
            dp_grad_err=f"{max(d['grad_errs'].values()):.3g}",
            dp_loss=f"{d['loss']:.6f}", mean_single_loss=f"{d['mean_single_loss']:.6f}",
            densify=json.dumps(d["densify"]).replace(" ", ""),
            launches=json.dumps({"tiles": t["launches"], "dp": d["launches"]}).replace(" ", ""))
        if sum(f["instances_per_rank"]) != f["instances_single"] or not f["n_contrib_equal"] \
                or f["color_err"] > P12_IMG_TOL or f["gw_err"] > P12_GW_TOL:
            raise AssertionError(f"12b rank {r['rank']}: the sharded frame departs: {f}")
        a, b = t["loss"]
        if abs(a - b) > P12_LOSS_RTOL * abs(a) or t["render_err"] > P12_IMG_TOL \
                or max(t["grad_errs"].values()) > P12_GRAD_TOL:
            raise AssertionError(f"12b rank {r['rank']}: the tile-sharded step departs: {t}")
        if abs(d["loss"] - d["mean_single_loss"]) > P12_LOSS_RTOL * abs(d["mean_single_loss"]) \
                or max(d["grad_errs"].values()) > P12_GRAD_TOL \
                or max(d["stat_errs"].values()) > P12_STAT_TOL:
            raise AssertionError(f"12b rank {r['rank']}: the DP step departs: {d}")
        for kind in ("tiles", "dp"):
            missing = [k for k in TRAIN_KERNELS if r[kind]["launches"].get(k, 0) < 1]
            if missing and r["device"].startswith("cuda"):
                raise AssertionError(f"12b rank {r['rank']} {kind}: not launched: {missing}")
    for key in (("tiles", "hash"), ("dp", "hash_adam"), ("dp", "hash_densify")):
        hashes = {r[key[0]][key[1]] for r in ranks}
        if len(hashes) != 1:
            raise AssertionError(f"12b: the replicas part after {key}: {hashes}")
    dens = ranks[0]["dp"]["densify"]
    if not (dens["densified"] or dens["pruned"]):
        raise AssertionError(f"12b: the densify event changed nothing: {dens}")
    log("12b replicas", identical_after=["tiles step", "dp adam", "dp densify"],
        hashes=json.dumps({"tiles": ranks[0]["tiles"]["hash"],
                           "dp": ranks[0]["dp"]["hash_adam"],
                           "densify": ranks[0]["dp"]["hash_densify"]}).replace(" ", ""))
    detail["phase12b"] = dict(backend=backend, compute_mode=mode, cards=n_cards,
                              seconds=wall_s, label=label, ranks=ranks)
    return {f"rank{r['rank']}": {k: r[k]["launches"] for k in ("tiles", "dp")} for r in ranks}


def phase12c_cli(dev, detail):
    """12c: the train CLI with --mesh tiles and --mesh dp on phase 8's scene;
    the CLI starts one rank a card itself. Only rank 0 writes, the same
    files a one-device run writes, and they load in the port."""
    import torch

    from tpu_splat_torch.model.io import load_checkpoint, load_ply
    from tpu_splat_torch.scripts import train as cli

    scene_dir = os.path.join(P8_DIR, "scene")
    ply = os.path.join("point_cloud", "iteration_30", "point_cloud")
    expect = sorted(["cameras.json", "cfg_args", "chkpnt30.npz", "training_report.jsonl",
                     ply + ".ply", ply + ".map", ply + ".map.npz"])
    out = {}
    for mode in ("tiles", "dp"):
        model_dir = os.path.join(P8_DIR, f"mesh_{mode}")
        t0 = time.perf_counter()
        ts = cli.main(["-s", scene_dir, "-m", model_dir, *P12_CLI_ARGS, "--mesh", mode],
                      device=str(dev))
        secs = time.perf_counter() - t0
        files = sorted(os.path.relpath(os.path.join(d, f), model_dir)
                       for d, _, names in os.walk(model_dir) for f in names)
        if files != expect or ts.step != 30:
            raise AssertionError(f"12c --mesh {mode}: step {ts.step}, files {files}")
        g = ts.gaussians
        back = load_ply(os.path.join(model_dir, ply + ".ply"), device=dev)
        alive = g.alive
        n_alive = int(alive.sum())
        ply_equal = all(bool(torch.equal(getattr(back, f)[:n_alive], getattr(g, f)[alive]))
                        for f in ("xyz", "features_dc", "scaling", "rotation", "opacity", "refl"))
        ck, it = load_checkpoint(os.path.join(model_dir, "chkpnt30.npz"), ts)
        ck_equal = it == 30 and all(bool(torch.equal(a, b)) for a, b in zip(
            ck.gaussians.param_pytree().values(), g.param_pytree().values()))
        if not (ply_equal and ck_equal):
            raise AssertionError(f"12c --mesh {mode}: PLY {ply_equal}, checkpoint {ck_equal}")
        out[mode] = dict(seconds=secs, files=len(files), ply_equal=ply_equal,
                         checkpoint_equal=ck_equal, alive=int(alive.sum()))
        log("12c cli", mesh=mode, ranks=torch.cuda.device_count(), seconds=f"{secs:.1f}",
            files=len(files), ply_equal=ply_equal, checkpoint_equal=ck_equal)
    detail["phase12c"] = out


def phase13_certificate(dev, detail) -> dict:
    """13a recover, 13b scratch, 13c recover_vol through `validate_e2e.main`
    on the card, the launch counts set to 0 before each task's first step
    and read after every step; 13d the parity CLI's cases in this process.
    Returns the launches of each task's steps, summed."""
    import torch

    import tpu_splat_torch.train.loop as tloop
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.scripts import validate_e2e as ve
    from tpu_splat_torch.tools import parity

    p13, totals = {}, {}
    card = card_line()
    events_fn = tloop.run_scheduled_events
    for sub, task in (("13a", "recover"), ("13b", "scratch"), ("13c", "recover_vol")):
        kernels, steps = P13_KERNELS[task], []
        logs = []

        def on_step(it, aux):
            if it == 0:
                LAUNCHES.clear()
                return
            launched = {n: LAUNCHES[n] for n in kernels}
            LAUNCHES.clear()
            loss = float(aux if task == "recover_vol" else aux.loss)
            steps.append(dict(launched=launched, loss=loss,
                              psnr=None if task == "recover_vol" else float(aux.psnr)))

        def logging_events(ts, it, opt, *a, log=None, **kw):
            if log is not None and not any(x is log for x in logs):
                logs.append(log)
            return events_fn(ts, it, opt, *a, log=log, **kw)

        out = os.path.join(OUT_DIR, f"p13_{task}.json")
        tloop.run_scheduled_events = logging_events
        t0 = time.perf_counter()
        try:
            verdict = ve.main(["--task", task, "--iterations", str(P13_ITERATIONS[task]),
                               "--out", out, "--device", str(dev)], on_step=on_step)
        finally:
            tloop.run_scheduled_events = events_fn
        seconds = time.perf_counter() - t0
        with open(out) as f:
            art = json.load(f)
        # the initial stage (steps before init_until_iter) runs no env pass
        from tpu_splat_torch.config import OptimizationParams

        sched = (ve.scratch_schedule if task == "scratch" else ve.recover_schedule)(
            OptimizationParams(), P13_ITERATIONS[task])
        want = lambda it: {n: int(n != "cubemap_tap_accumulate" or it >= sched.init_until_iter)
                           for n in kernels}
        bad = [(i + 1, s_["launched"]) for i, s_ in enumerate(steps)
               if s_["launched"] != want(i + 1)]
        if len(steps) != P13_ITERATIONS[task] or bad:
            raise AssertionError(f"{sub} {task}: {len(steps)} steps, launches off at {bad[:5]}")
        losses = [s_["loss"] for s_ in steps]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{sub} {task}: a non-finite loss")
        w = P13_WINDOW
        if task == "recover_vol":
            first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
            if not last < first:
                raise AssertionError(f"{sub} {task}: the loss did not fall: {first} -> {last}")
        else:
            psnr = [s_["psnr"] for s_ in steps]
            first, last = float(np.mean(psnr[:w])), float(np.mean(psnr[-w:]))
            if not last > first:
                raise AssertionError(f"{sub} {task}: train PSNR did not rise: {first} -> {last}")
        if (art["task"] != task or art["verdict"] != verdict or art["device"] != card
                or art["bars"] != ve.BARS[task] or art["backend"] != "gpu"
                or art["workload"]["iterations"] != P13_ITERATIONS[task]):
            raise AssertionError(f"{sub} {task}: artifact {art}")
        rec = dict(seconds=seconds, steps=len(steps), verdict=verdict,
                   first_window=first, last_window=last,
                   train_view_psnr=art["train_view_psnr"], held_out_psnr=art["held_out_psnr"],
                   held_out_ssim=art["held_out_ssim"], wall_seconds=art["wall_seconds"],
                   step_ms=1e3 * art["wall_seconds"] / len(steps))
        if task == "scratch":
            log_ = logs[0]
            kinds = {e for _, e in log_.events}
            if P13_EVENTS - kinds or not log_.densified:
                raise AssertionError(f"{sub} scratch: events {sorted(kinds)}, densified "
                                     f"{log_.densified}")
            rec.update(densified=log_.densified, pruned=log_.pruned, overflowed=log_.overflowed,
                       events=len(log_.events))
        totals[task] = {n: sum(s_["launched"][n] for s_ in steps) for n in kernels}
        p13[task] = rec
        log(f"{sub} {task}", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in rec.items()},
            launches=json.dumps(totals[task]).replace(" ", ""))
        torch.cuda.empty_cache()
    # 13d. the parity CLI's three cases at 256x256 on the card
    t0 = time.perf_counter()
    res = parity.run(device=dev)
    seconds = time.perf_counter() - t0
    if not res["ok"]:
        raise AssertionError(f"13d parity: {res}")
    p13["parity"] = dict(seconds=seconds, **{c: res[c]["rows"] for c in parity.CASES})
    worst = {c: max(r["rel"] if r["relative"] else r["max_abs"] for r in res[c]["rows"]
                    if not r["name"].startswith("fwd middepth") and "hold" not in r["name"])
             for c in parity.CASES}
    log("13d parity", seconds=f"{seconds:.1f}", **{c: f"{v:.3g}" for c, v in worst.items()})
    p13["step_stages"] = phase13_step_stages(dev)
    detail["certificate"] = p13
    return totals


def phase13_step_stages(dev) -> dict:
    """13e. Where a 256x256 step's time goes: the recover task's step
    (after a warm-up) on view 0, the stages' CUDA-event ms (median of 3),
    the host clock, and the host synchronizations of one step."""
    import torch

    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.core.device import record_stages
    from tpu_splat_torch.scripts import validate_e2e as ve
    from tpu_splat_torch.train.step import TrainState, make_train_step

    cfg = ve.task_config(False)
    gt_state, _ = ve.build_gt_state(False, dev)
    cam = ve.make_cameras(256, 256, 48, 6, device=dev)[0]
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        gt = ve.render(gt_state, cam, cfg, bg, initial_stage=False).render
    opt = ve.recover_schedule(OptimizationParams(), P13_ITERATIONS["recover"])
    ts = TrainState.create(ve.recover_state(gt_state, np.random.default_rng(9)), opt)
    step = make_train_step(opt, cfg, spatial_lr_scale=4.2)
    ts, _ = step(ts, cam, gt, bg)
    runs = []
    for _ in range(3):
        with record_stages() as st_ms:
            ms, (ts, _) = wall_ms(lambda: step(ts, cam, gt, bg))
        runs.append(dict(st_ms, step_wall=ms))
    stages = {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[-1]}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ts, _ = step(ts, cam, gt, bg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    stages["host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    log("13e recover step stages", **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                                      for k, v in stages.items()})
    return stages


@contextlib.contextmanager
def plain_kernels(names=TRAIN_KERNELS):
    """The named kernels of the training path replaced by their plain
    PyTorch versions, which run on any device and count no launch."""
    from tpu_splat_torch.kernels import cubemap_accum as ca
    from tpu_splat_torch.kernels import segment_reduce as sr
    from tpu_splat_torch.kernels import tile_blend as tb

    mods = dict(tile_blend_forward=tb, tile_blend_backward=tb, segment_sum_ranges=sr,
                cubemap_tap_accumulate=ca)
    orig = {n: getattr(mods[n], n) for n in names}
    for n in names:
        setattr(mods[n], n, getattr(mods[n], f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(mods[n], n, fn)


def p14_bench_run(label: str, args: list) -> dict:
    """14a. One bench CLI run in a process of its own: exactly one result
    line (every other line starts with "#"), the JSON script's four keys,
    a positive value, no instance over the capacity, and the launches of
    each timed call: #1-#4 once in fwd+bwd, #1 alone forward-only."""
    from tpu_splat_torch.scripts.bench import KERNELS

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tpu_splat_torch.scripts.bench", *args], cwd=HERE,
                       capture_output=True, text=True, timeout=P14_TIMEOUT)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"14a {label}: exit {r.returncode}\n{r.stderr[-3000:]}")
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    results = [ln for ln in lines if not ln.startswith("#")]
    if len(results) != 1:
        raise AssertionError(f"14a {label}: {len(results)} result lines: {results[:3]}")
    rec = json.loads(results[0])
    if (any(k not in rec for k in P14_KEYS) or not math.isfinite(rec["value"])
            or rec["value"] <= 0 or rec["instances"] > rec["capacity"]):
        raise AssertionError(f"14a {label}: {rec}")
    forward_only = "--forward_only" in args
    want = {k: int(k == "tile_blend_forward" or not forward_only) for k in KERNELS}
    bad = [(k, n) for k in KERNELS for n in rec["launches"][k] if n != want[k]]
    if bad or any(len(rec["launches"][k]) != rec["iters"] for k in KERNELS):
        raise AssertionError(f"14a {label}: launches {rec['launches']}, want {want} a call")
    if "--checkpoint" in args:
        probe = [m for m in map(re.compile(r"# trained load: (\d+) instances, cap (\d+)$").match,
                                lines) if m]
        if len(probe) != 1:
            raise AssertionError(f"14a {label}: no probe line in {lines[:5]}")
        n_inst, cap = (int(x) for x in probe[0].groups())
        if n_inst > cap or cap != rec["capacity"]:
            raise AssertionError(f"14a {label}: probe {n_inst} / {cap}, capacity "
                                 f"{rec['capacity']}")
        rec["probe"] = dict(instances=n_inst, capacity=cap)
    rec["seconds"] = seconds
    log(f"14a bench {label}", value=rec["value"], vs_baseline=rec["vs_baseline"],
        ms_median=f"{rec['ms_median']:.3f}", ms_p10=f"{rec['ms_p10']:.3f}",
        ms_p90=f"{rec['ms_p90']:.3f}", instances=rec["instances"], capacity=rec["capacity"],
        launches=json.dumps({k: v[0] for k, v in rec["launches"].items()}).replace(" ", ""),
        seconds=f"{seconds:.1f}")
    return rec


def p14_kernels_vs_plain(dev) -> dict:
    """14b. The bench's fwd+bwd at the JAX profiler's small scale, under the
    bench's switches and with exact f32 rows, on the kernels (each launched
    once) against the same call on the plain versions on the card: the loss
    within P14_LOSS_TOL, the frame within TOL but at the knife edge
    (FLIPS_PER_4096), and every gradient leaf within P14_GRAD_TOL of the
    plain leaf's max |g|, for the whole call and for the plain backward
    kernels on the kernel forward's outputs. The whole call leaves out of
    the loss, on both sides, the pixels whose reflected ray reads another
    env-map cell in the two frames (`env_cells`): the sample's gradient
    jumps between cells, so there a last-bit difference in the normal
    decides which texel pair the pixel's gradient comes from. Each such
    pixel's normals must agree within TOL; the float64 scan blend says
    which frame's cell it reads (exact rows only: the scan blend has no
    bf16 content rows)."""
    import dataclasses

    import torch

    from tpu_splat_torch.eval.parity import env_cells, env_texel_coords
    from tpu_splat_torch.kernels import LAUNCHES
    from tpu_splat_torch.raster.config import production_config
    from tpu_splat_torch.renderer import render
    from tpu_splat_torch.scripts import bench

    sz = P14_SMALL
    state = build_state(sz["n"], sz["capacity"], device=dev)
    cam = bench.bench_camera(sz["height"], sz["width"], dev)
    gt = bench.bench_target(sz["height"], sz["width"], dev)
    bg = torch.zeros(3, device=dev)
    prod = production_config(**P14_SMALL_CAPS)
    res_env = state.env.texture.shape[-1]

    def run(cfg, names=()):
        with plain_kernels(names):
            LAUNCHES.clear()
            loss, grads, out = bench.fwd_bwd(state, cam, cfg, gt, bg)
            return loss, grads, out, {k: LAUNCHES[k] for k in TRAIN_KERNELS}

    def grads_kept(cfg, keep, names=()):
        """The bench's fwd+bwd with the L1 loss over the `keep` pixels."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.param_pytree().items()}
        with plain_kernels(names), torch.enable_grad():
            r = render(state.with_params(params), cam, cfg, bg, initial_stage=False).render
            loss = torch.sum(torch.abs(r - gt) * keep[..., None]) / r.numel()
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return {k: torch.zeros_like(x) if g is None else g
                for (k, x), g in zip(params.items(), got)}

    def rel(a, b):
        return {k: float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
                for k in b}

    out = {}
    for name, cfg in (("production", prod),
                      ("exact", dataclasses.replace(prod, bf16_grads=False, bf16_feats=False))):
        run(cfg)  # warm-up
        loss_k, g_k, out_k, launched = run(cfg)
        loss_p, g_p, out_p, plain_launched = run(cfg, TRAIN_KERNELS)
        _, g_b, _, bwd_launched = run(cfg, TRAIN_KERNELS[1:])
        px = (out_k.render.detach() - out_p.render.detach()).abs().amax(-1)
        n_k, n_p = out_k.normal.detach(), out_p.normal.detach()
        cells_k, cells_p = env_cells(cam, n_k, res_env), env_cells(cam, n_p, res_env)
        knife = (cells_k != cells_p).any(-1)
        knives = []
        if bool(knife.any()):
            g_kk = grads_kept(cfg, (~knife).float())
            g_pk = grads_kept(cfg, (~knife).float(), TRAIN_KERNELS)
            cells_64 = None
            if not cfg.bf16_feats:  # the float64 scan blend: which frame's cell
                xcfg = dataclasses.replace(cfg, backend="xla", tile_depth=P14_SCAN_DEPTH)
                with patched_blend(dtype=torch.float64), torch.no_grad():
                    o64 = render(state, cam, xcfg, bg, initial_stage=False)
                if int(o64.max_tile_count) > P14_SCAN_DEPTH:
                    raise AssertionError(f"14b {name}: the scan blend's depth "
                                         f"{P14_SCAN_DEPTH} < {int(o64.max_tile_count)}")
                cells_64 = env_cells(cam, o64.normal, res_env)
                xy_64 = env_texel_coords(cam, o64.normal, res_env)[1]
            xy_k, xy_p = (env_texel_coords(cam, n, res_env)[1] for n in (n_k, n_p))
            for y, x in knife.nonzero().tolist():
                side = None if cells_64 is None else (
                    "kernel" if torch.equal(cells_64[y, x], cells_k[y, x]) else
                    "plain" if torch.equal(cells_64[y, x], cells_p[y, x]) else "neither")
                knives.append(dict(y=y, x=x, cell_kernel=cells_k[y, x].tolist(),
                                   cell_plain=cells_p[y, x].tolist(),
                                   texel_kernel=xy_k[y, x].tolist(),
                                   texel_plain=xy_p[y, x].tolist(),
                                   texel_float64=None if cells_64 is None else
                                   xy_64[y, x].tolist(),
                                   normal_max_abs_err=float((n_k[y, x] - n_p[y, x]).abs().max()),
                                   float64_reads=side))
        else:
            g_kk, g_pk = g_k, g_p
        errs, whole = rel(g_k, g_b), rel(g_kk, g_pk)
        res = dict(loss=float(loss_k), loss_err=abs(float(loss_k) - float(loss_p)),
                   frame_max_abs_err=float(px.max()), frame_px_over_tol=int((px > TOL).sum()),
                   grad_rel_err=errs, grad_rel_err_whole=whole, grad_tol=P14_GRAD_TOL,
                   env_knife_pixels=knives,
                   # recorded: the whole call with the env-knife pixels in the loss
                   grad_rel_err_whole_all_pixels=rel(g_k, g_p),
                   launches=launched,
                   plain_launches=plain_launched, plain_backward_launches=bwd_launched,
                   instances=int(out_k.num_instances), max_instances=cfg.max_instances, **sz)
        want_bwd = {k: int(k == "tile_blend_forward") for k in TRAIN_KERNELS}
        if (any(n != 1 for n in launched.values()) or any(plain_launched.values())
                or bwd_launched != want_bwd
                or int(out_k.num_instances) != int(out_p.num_instances)
                or res["instances"] > cfg.max_instances or res["loss_err"] > P14_LOSS_TOL
                or res["frame_px_over_tol"] + len(knives) > FLIPS_PER_4096 * px.numel() / 4096
                or any(not k["normal_max_abs_err"] <= TOL for k in knives)
                or any(not e <= P14_GRAD_TOL for e in list(errs.values()) + list(whole.values()))):
            raise AssertionError(f"14b bench kernels vs plain, {name}: {res}")
        log("14b bench kernels vs plain", switches=name, loss_err=f"{res['loss_err']:.3g}",
            frame_px_over_tol=res["frame_px_over_tol"], env_knife_pixels=len(knives),
            worst_grad_whole=f"{max(whole.values()):.3g}",
            worst_grad_whole_all_pixels=f"{max(res['grad_rel_err_whole_all_pixels'].values()):.3g}",
            worst_grad_plain_bwd=f"{max(errs.values()):.3g}", instances=res["instances"],
            launches=json.dumps(launched).replace(" ", ""))
        for k in knives:
            log("14b env knife", switches=name, **{a: json.dumps(b).replace(" ", "")
                                                   for a, b in k.items()})
        out[name] = res
    return out


def p14_profile() -> dict:
    """14c. The profiler's seven sections at bench scale in a process of its
    own: each section prints its rows, each row finite and above 0."""
    out = os.path.join(OUT_DIR, "p14_profile.json")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tpu_splat_torch.tools.profile", *P14_SECTIONS,
                        "--json", out], cwd=HERE, capture_output=True, text=True,
                       timeout=P14_TIMEOUT)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"14c profile: exit {r.returncode}\n{r.stderr[-3000:]}")
    with open(out) as f:
        rows = json.load(f)["sections"]
    bad = [(s, x["name"]) for s in P14_SECTIONS for x in rows.get(s, [])
           if not (math.isfinite(x["value"]) and x["value"] > 0)]
    empty = [s for s in P14_SECTIONS if not rows.get(s)]
    if bad or empty or any(f"--- {s} ---" not in r.stdout for s in P14_SECTIONS):
        raise AssertionError(f"14c profile: rows not above 0 {bad}, sections empty {empty}")
    log("14c profile", seconds=f"{seconds:.1f}", **{s: len(rows[s]) for s in P14_SECTIONS})
    return dict(seconds=seconds, sections=rows)


def phase14_measurement(dev, detail) -> dict:
    """14a the bench CLI's four variants, 14b its fwd+bwd on the kernels
    against the plain versions, 14c the profiler. -> the launches of one
    timed bench call of each variant."""
    t0 = time.perf_counter()
    runs = {label: p14_bench_run(label, args) for label, args in P14_RUNS.items()}
    small = p14_kernels_vs_plain(dev)
    prof = p14_profile()
    seconds = time.perf_counter() - t0
    detail["measurement"] = dict(bench=runs, kernels_vs_plain=small, profile=prof,
                                 seconds=seconds)
    log("14 done", seconds=f"{seconds:.1f}")
    return {label: {k: v[0] for k, v in rec["launches"].items()} for label, rec in runs.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from tpu_splat_torch.core.device import record_stages
    from tpu_splat_torch.data.synthetic import orbit_camera
    from tpu_splat_torch.kernels import LAUNCHES, build
    from tpu_splat_torch.kernels import tile_blend as tb
    from tpu_splat_torch.model.io import load_ply
    from tpu_splat_torch.raster.config import RasterConfig, production_config
    from tpu_splat_torch.renderer import render_fast

    t_start = time.perf_counter()
    detail: dict = {}

    # 1. device
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log("1 device", name=repr(kind), count=count, card=repr(card),
        torch=torch.__version__, cuda=torch.version.cuda)
    detail["card"] = card

    # 2. build every kernel source, one nvcc each, all at once; beside them
    # the forward's variants phase 11 reads (kernel_ab.py), in a thread
    import threading

    import kernel_ab

    fwd_builds: dict = {}

    def build_fwd_variants():
        try:
            fwd_builds.update(kernel_ab.build_variants(
                "", os.path.join(build.BUILD_DIR, "p11"), P11_FWD_VARIANTS))
        except Exception as e:  # re-raised where phase 11 needs them
            fwd_builds["error"] = e

    variant_thread = threading.Thread(target=build_fwd_variants)
    variant_thread.start()
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, rec in logs.items():
        log("2 build", source=f"csrc/{name}.cu", seconds=f"{rec['seconds']:.1f}",
            ptxas=repr(" | ".join(rec["ptxas"])))
    log("2 build", total_seconds=f"{build_s:.1f}", sources=len(build.sources()))
    detail["build"] = {"seconds": build_s, "log": logs}

    # 3a. kernel vs plain on a small scene, all tiles, every static variant,
    # on the inputs the served path hands the kernel (bf16-packed slab from
    # the production switches, f32 slab from the full-shape ones)
    small_cfgs = {True: production_config(**SMALL), False: RasterConfig(**SMALL)}
    bgd = torch.zeros(3, device=dev)
    detail["small"] = {}
    errs = []
    for label, logit in (("small random", None), ("small opaque", 4.6)):
        st = small_scene(SMALL_N, 1, dev, opacity_logit=logit)
        cam = orbit_camera(SMALL_H, SMALL_W, radius=4.0, azimuth=0.3, elevation=0.2,
                           device=dev)
        inputs = {p: captured_kernel_inputs(st, cam, c, bgd) for p, c in small_cfgs.items()}
        res, worst = check_variants(inputs, None, label)
        detail["small"][label] = res
        errs.append(worst)

    # 3b. the same end to end: render_fast on the card against the CPU run
    st_c = small_scene(SMALL_N, 2, "cpu")
    cam_c = orbit_camera(SMALL_H, SMALL_W, radius=4.0, azimuth=0.5, elevation=0.2,
                         device="cpu")
    st_g = small_scene(SMALL_N, 2, dev)
    cam_g = orbit_camera(SMALL_H, SMALL_W, radius=4.0, azimuth=0.5, elevation=0.2,
                         device=dev)
    bg = [0.1, 0.2, 0.3]
    e2e = {}
    for name, cfg in (("production", small_cfgs[True]), ("full", small_cfgs[False])):
        a = render_fast(st_c, cam_c, cfg, torch.tensor(bg))
        b = render_fast(st_g, cam_g, cfg, torch.tensor(bg, device=dev))
        diff = (b.render.cpu() - a.render).abs().amax(-1)
        n_bad = int((diff > TOL).sum())
        e2e[name] = dict(max_abs_err=float(diff.max()), pixels_over_tol=n_bad,
                         instances=(int(a.num_instances), int(b.num_instances)))
        if (int(a.num_instances) != int(b.num_instances)
                or n_bad > FLIPS_PER_4096 * diff.numel() / 4096):
            raise AssertionError(f"render_fast on the card disagrees with the CPU run: {e2e}")
    log("3 render_fast card vs cpu", **{k: json.dumps(v).replace(" ", "") for k, v in e2e.items()})
    detail["small_e2e"] = e2e

    # 3c. kernel vs plain at full width: the bench frame, sampled tiles
    t0 = time.perf_counter()
    state = build_state(N_GAUSS, CAPACITY, device=dev)
    torch.cuda.synchronize()
    log("3 state", gaussians=N_GAUSS, capacity=CAPACITY, seconds=f"{time.perf_counter() - t0:.1f}")
    cfg = production_config(**PROD)
    full_cfg = RasterConfig(**FULL_SHAPE)
    views = [orbit_camera(H, W, radius=6.0, azimuth=0.4 + k * math.pi / 2, elevation=0.3,
                          device=dev) for k in range(N_VIEWS)]
    inputs = {True: captured_kernel_inputs(state, views[0], cfg, bgd),
              False: captured_kernel_inputs(state, views[0], full_cfg, bgd)}
    counts = {p: inputs[p][1][1] for p in inputs}
    g = torch.Generator().manual_seed(0)
    others = torch.randperm(counts[True].numel(), generator=g)[: N_SAMPLED_TILES - 2].to(dev)
    tiles = torch.unique(torch.cat([torch.argmax(counts[True])[None],
                                    torch.argmax(counts[False])[None], others]))
    res, worst = check_variants(inputs, tiles, "full width, sampled tiles")
    detail["full_width_sampled"] = res
    errs.append(worst)
    # pack_features on the card against the CPU on the same inputs
    pack_bits = {}
    for name, c in (("production", cfg), ("full", full_cfg)):
        n_diff, n_words = pack_features_card_vs_cpu(state, views[0], c, bgd)
        pack_bits[name] = dict(differing_words=n_diff, words=n_words)
        if n_diff:
            raise AssertionError(f"pack_features card vs CPU: {pack_bits}")
    log("3 pack_features card vs cpu", **{k: f"{v['differing_words']}/{v['words']}"
                                           for k, v in pack_bits.items()})
    detail["pack_features_card_vs_cpu"] = pack_bits

    # kernel time at the main path's shapes (train-shaped, packed, no wmax)
    main_kw = dict(train_shape=True, packed_feats=True, collect_wmax=False)
    feats0, index0 = inputs[True]
    k_ms = cuda_ms(lambda: tb.tile_blend_forward(feats0, *index0, **main_kw), 10)
    # ... and as the training step calls it, with wmax on
    train_ms = cuda_ms(lambda: tb.tile_blend_forward(feats0, *index0,
                                                     **dict(main_kw, collect_wmax=True)), 10)
    full_ms = cuda_ms(lambda: tb.tile_blend_forward(inputs[False][0], *inputs[False][1]), 5)
    plain_ms, (_, _, pairs) = wall_ms(lambda: tb.tile_blend_forward_plain(
        feats0, *index0, return_pairs=True, **main_kw))
    n_valid = int(index0[1].sum())
    n_tiles = index0[1].numel()
    bytes_moved = (n_valid * tb.F_IN_PACKED * 4  # the tiles' feature columns
                   + n_tiles * 16 * tb.L * 4  # out_px
                   + 4 * n_tiles * 4)  # starts, counts, org_x, org_y
    ops = ALPHA_TEST_OPS * pairs
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    fwd_k_ms, fwd_plain_ms, fwd_bound_ms, fwd_bound_by = k_ms, plain_ms, bound_ms, bound_by
    log("3 kernel time", ms=f"{k_ms:.4f}", train_ms=f"{train_ms:.4f}",
        full_shape_ms=f"{full_ms:.4f}", plain_ms=f"{plain_ms:.1f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bytes=bytes_moved, alpha_tests=pairs, instances=n_valid,
        tiles=n_tiles, max_tile_count=int(index0[1].max()))
    detail["kernel_time"] = dict(ms=k_ms, train_ms=train_ms, full_shape_ms=full_ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 bytes=bytes_moved, alpha_tests=pairs, ops=ops,
                                 instances=n_valid)
    del inputs, feats0, index0

    def serve(label, st, cam, c, cw=False):
        """One served frame, checked; its kernel launches are counted from 0."""
        LAUNCHES.clear()
        ms, out = wall_ms(lambda: render_fast(st, cam, c, bgd, collect_weights=cw))
        launched = dict(LAUNCHES)
        cover, n_inst = check_frame(out, c, label)
        if launched.get("tile_blend_forward", 0) < 1:
            raise AssertionError(f"{label}: the tile kernel was not launched")
        rec = dict(wall_ms=ms, instances=n_inst, capacity=c.max_instances,
                   pad_overflow=int(out.pad_overflow), coverage=cover,
                   launches=launched["tile_blend_forward"])
        if cw:
            gw = out.gaussian_weights
            if not (bool(torch.isfinite(gw).all()) and float(gw.max()) > 0.0):
                raise AssertionError(f"{label}: bad gaussian_weights")
            rec["weights_nonzero"] = int((gw > 0).sum())
        log("4 serve" if st is state else "5 trained", frame=label,
            **{k: (f"{v:.2f}" if isinstance(v, float) else v) for k, v in rec.items()})
        return rec

    # 4. serve: the main path (the production views), with the launch counts
    # set to 0 just before it and read just after; then the full-shape and
    # collect_weights frames, each counted on its own
    render_fast(state, views[0], cfg, bgd, collect_weights=False)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    main_runs = [(f"view{k}", *wall_ms(lambda: render_fast(
        state, views[k], cfg, bgd, collect_weights=False))) for k in range(N_VIEWS)]
    launches = LAUNCHES["tile_blend_forward"]
    if launches < N_VIEWS:
        raise AssertionError(f"the tile kernel ran {launches} times over {N_VIEWS} views")
    served = {}
    for label, ms, out in main_runs:
        cover, n_inst = check_frame(out, cfg, label)
        served[label] = dict(wall_ms=ms, instances=n_inst, capacity=cfg.max_instances,
                             pad_overflow=int(out.pad_overflow), coverage=cover)
        log("4 serve", frame=label, **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                                       for k, v in served[label].items()})
    del main_runs
    log("4 serve", path="production views", views=N_VIEWS, size=f"{H}x{W}",
        launches=launches)
    served["full-shape"] = serve("full-shape", state, views[1], full_cfg, cw=True)
    served["collect_weights"] = serve("collect_weights", state, views[2], cfg, cw=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log("4 serve", peak_mem_gib=f"{peak_gb:.2f}")
    detail["serve"] = served
    detail["serve_launches"] = {"production views": launches,
                                "full-shape": served["full-shape"]["launches"],
                                "collect_weights": served["collect_weights"]["launches"]}
    detail["serve_peak_mem_gib"] = peak_gb

    # where one production frame's time goes: CUDA events around the stages
    # of render_fast itself (median of 5 frames, view 0)
    runs = []
    for _ in range(5):
        with record_stages() as st_ms:
            total, _ = wall_ms(lambda: render_fast(state, views[0], cfg, bgd,
                                                   collect_weights=False))
        runs.append(dict(st_ms, render_fast_wall=total))
    stages = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    log("4 stages", **{k: f"{v:.2f}" for k, v in stages.items()})
    detail["stages_ms"] = stages

    # 5. the trained snapshot at its own size
    tstate = load_ply(PLY, device=dev)
    xyz = tstate.xyz[tstate.alive]
    center = tuple(float(x) for x in xyz.mean(0))
    tcam = orbit_camera(H, W, radius=5.0, azimuth=0.4, elevation=0.3, target=center,
                        device=dev)
    tcfg = production_config(**TRAINED)
    detail["trained"] = serve("trained", tstate, tcam, tcfg)
    detail["trained"]["gaussians"] = tstate.num_alive

    # ... and tiled out to the bench size, at the bench view
    big, n_big = tile_checkpoint(tstate, TILED_N, CAPACITY, dev)
    del tstate
    bcfg = production_config(**TILED)
    render_fast(big, views[0], bcfg, bgd, collect_weights=False)  # warm-up
    detail["trained_tiled"] = serve("trained tiled", big, views[0], bcfg)
    detail["trained_tiled"]["gaussians"] = n_big
    del big


    # 6. the training step (slice 2's main path): make_train_step with the
    # production switches and the ISP on, in the deferred-reflection stage
    from tpu_splat_torch.kernels import cubemap_accum as ca
    from tpu_splat_torch.kernels import segment_reduce as sr
    from tpu_splat_torch.train.step import make_train_step

    bg_train = torch.zeros(3, device=dev)

    def small_step(cfg_s, device, capture=False):
        st = small_scene(SMALL_N, 3, device)
        opt, ts, isp = train_start(st, 2)
        cam = orbit_camera(SMALL_H, SMALL_W, radius=4.0, azimuth=0.5, elevation=0.2,
                           device=device)
        gt = torch.tensor(np.random.default_rng(1).uniform(0, 1, (SMALL_H, SMALL_W, 3))
                          .astype(np.float32), device=device)
        step = make_train_step(opt, cfg_s, 1.0, isp_cfg=isp)
        if not capture:
            return step(ts, cam, gt, torch.zeros(3, device=device), frame_idx=1)[1], None
        with Capture() as cap:
            aux = step(ts, cam, gt, torch.zeros(3, device=device), frame_idx=1)[1]
        return aux, cap

    # 6a. each backward kernel against its plain version on the inputs a
    # small training step hands it (production and exact switches), and the
    # four static variants of tile_blend_backward
    detail["train_small"] = {}
    kernel_errs = {k: [] for k in TRAIN_KERNELS[1:]}
    caps = {}
    for name, over in (("production", {}), ("exact", dict(bf16_grads=False, bf16_feats=False))):
        aux, cap = small_step(production_config(**SMALL, **over), dev, capture=True)
        caps[name] = cap
        res = check_captured(cap, label=f"small {name} step")
        detail["train_small"][name] = res
        for k, v in res.items():
            kernel_errs[k].append(v["max_abs_err"])
    g = torch.Generator().manual_seed(0)
    variants = {}
    for name, packed in (("production", True), ("exact", False)):
        (bargs, _), = caps[name].seen["tile_blend_backward"]
        feats, index = bargs[0], bargs[1:5]
        for full in (True, False):
            fwd, _ = tb.tile_blend_forward(feats, *index, train_shape=not full, packed_feats=packed)
            ct = torch.randn(fwd.shape, generator=g).to(dev)
            r = check_backward(feats, index, fwd, ct, full, packed)
            variants[f"full={int(full)},packed={int(packed)}"] = r
            kernel_errs["tile_blend_backward"].append(r["max_abs_err"])
    log("6 tile_blend_backward variants", **{k: f"{v['max_abs_err']:.3g}/{v['max_rel_err']:.3g}"
                                            for k, v in variants.items()})
    detail["train_small"]["bwd_variants"] = variants
    del caps

    # 6b. the small production step on the card against the CPU run
    a, _ = small_step(production_config(**SMALL), "cpu")
    b, _ = small_step(production_config(**SMALL), dev)
    cmp = {}
    for f in ("loss", "l1", "ssim", "normal_loss"):
        va, vb = float(getattr(a, f)), float(getattr(b, f))
        cmp[f] = abs(va - vb) / max(abs(va), 1e-30)
        if cmp[f] > STEP_LOSS_TOL:
            raise AssertionError(f"small step {f}: cpu {va} card {vb}")
    diff = (b.render.cpu() - a.render).abs().amax(-1)
    cmp["render_px_over_tol"] = int((diff > TOL).sum())
    if cmp["render_px_over_tol"] > FLIPS_PER_4096 * diff.numel() / 4096:
        raise AssertionError(f"small step render: {cmp}")
    over_1e3 = {}
    for k, ga in a.grads.items():
        gb = b.grads[k].cpu()
        scale = float(ga.abs().max())
        err = (gb - ga).abs()
        if float(err.max()) > STEP_GRAD_TOL * scale + 1e-30:
            raise AssertionError(f"small step gradient {k}: {float(err.max())} of {scale}")
        over_1e3[k] = int((err > 1e-3 * scale).sum())
    cmp["grad_entries_over_1e-3"] = over_1e3
    log("6 train step card vs cpu", **{k: (f"{v:.3g}" if isinstance(v, float) else
                                          json.dumps(v).replace(" ", "")) for k, v in cmp.items()})
    detail["train_card_vs_cpu"] = cmp
    del a, b

    # 6c. the training path at full width: the bench cloud with the
    # trainer's 128^2 cubemap, 1088x1920, production switches, the ISP with
    # one frame per view; random uniform ground truth (bench.py:235-236)
    del state
    tstate = build_state(N_GAUSS, CAPACITY, cubemap=TRAIN_CUBEMAP, device=dev)
    opt, ts, isp = train_start(tstate, N_VIEWS)
    step = make_train_step(opt, cfg, 1.0, isp_cfg=isp)
    gts = [torch.rand((H, W, 3), generator=torch.Generator().manual_seed(1 + k)).to(dev)
           for k in range(N_VIEWS)]
    before = {k: v.clone() for k, v in ts.gaussians.param_pytree().items()}
    with Capture() as cap:  # warm-up step, its kernel inputs captured
        ts, aux = step(ts, views[0], gts[0], bg_train, frame_idx=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    for k in range(TRAIN_STEPS):
        LAUNCHES.clear()
        ms, (ts, aux) = wall_ms(lambda: step(ts, views[k], gts[k], bg_train, frame_idx=k))
        per_step.append(dict(LAUNCHES))
        losses = {f: float(getattr(aux, f)) for f in ("loss", "l1", "ssim", "normal_loss")}
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train step {k}: non-finite loss {losses}")
        missing = [n for n in TRAIN_KERNELS if per_step[-1].get(n, 0) < 1]
        if missing:
            raise AssertionError(f"train step {k}: kernels not launched: {missing}")
        steps.append(dict(wall_ms=ms, instances=int(aux.num_instances),
                          pad_overflow=int(aux.pad_overflow), **losses))
        log("6 train", step=k, **{f: (f"{v:.4f}" if isinstance(v, float) else v)
                                   for f, v in steps[-1].items()},
            launches=json.dumps(per_step[-1]).replace(" ", ""))
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    train_launches = {n: sum(p.get(n, 0) for p in per_step) for n in TRAIN_KERNELS}
    after = ts.gaussians.param_pytree()
    # every leaf with a gradient moved (the env fail value has none: no
    # pixel reflects a zero direction)
    unchanged = [k for k in before if bool(torch.equal(before[k], after[k]))
                 and bool(aux.grads[k].abs().sum() > 0)]
    if unchanged:
        raise AssertionError(f"leaves not updated by the steps: {unchanged}")
    st_ = ts.stats
    if not (float(st_.denom.sum()) > 0 and float(st_.grad_accum.sum()) > 0
            and float(st_.accum_w.sum()) > 0 and float(st_.max_radii.max()) > 0):
        raise AssertionError("densify stats did not accumulate")
    log("6 train", steps=TRAIN_STEPS, size=f"{H}x{W}", gaussians=N_GAUSS,
        peak_mem_gib=f"{peak_train:.2f}", launches=json.dumps(train_launches).replace(" ", ""),
        visible=int((st_.denom > 0).sum()))
    # where one step's time goes: CUDA events around its stages (view 0)
    runs = []
    for _ in range(3):
        with record_stages() as st_ms:
            total, (ts, aux) = wall_ms(lambda: step(ts, views[0], gts[0], bg_train, frame_idx=0))
        runs.append(dict(st_ms, step_wall=total))
    train_stages = {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[-1]}
    log("6 train stages", **{k: f"{v:.2f}" for k, v in train_stages.items()})
    detail["train"] = dict(steps=steps, launches_per_step=per_step, peak_mem_gib=peak_train,
                           stages_ms=train_stages)

    # the backward kernels at full width, on the warm-up step's inputs:
    # against their plain versions (tile_blend_backward on sampled tiles),
    # and timed beside their plain versions, a library call and their bound
    (bargs, bkw), = cap.seen["tile_blend_backward"]
    feats, index, fwd, ct = bargs[0], bargs[1:5], bargs[5], bargs[6]
    counts_t = index[1]
    others = torch.randperm(counts_t.numel(), generator=g)[: N_SAMPLED_TILES - 1].to(dev)
    tiles = torch.unique(torch.cat([torch.argmax(counts_t)[None], others]))
    full_res = check_captured(cap, tiles=tiles, label="full width, sampled tiles")
    detail["train_full_width_check"] = full_res
    for k, v in full_res.items():
        kernel_errs[k].append(v["max_abs_err"])
    timing = {}
    bkw_ = dict(full_grads=bkw["full_grads"], packed_feats=bkw["packed_feats"])
    k_ms = cuda_ms(lambda: tb.tile_blend_backward(feats, *index, fwd, ct, **bkw_), 5)
    p_ms, (_, tested, contributing, warp_pairs) = wall_ms(lambda: tb.tile_blend_backward_plain(
        feats, *index, fwd, ct, return_pairs=True, **bkw_))
    nb, nops = bwd_bound(feats, index, fwd, bkw["packed_feats"], tested, contributing)
    timing["tile_blend_backward"] = dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bytes=nb,
                                         ops=nops, tested_pairs=tested,
                                         contributing_pairs=contributing,
                                         contributing_warp_pairs=warp_pairs)
    (sargs, _), = cap.seen["segment_sum_ranges"]
    rows, s_, e_ = sargs
    k_ms = cuda_ms(lambda: sr.segment_sum_ranges(rows, s_, e_), 10)
    p_ms, _ = wall_ms(lambda: sr.segment_sum_ranges_plain(rows, s_, e_))
    covered = int((e_.long() - s_.long()).clamp(min=0).sum())
    lib_ms = None
    if bool((s_[1:] == e_[:-1]).all()):  # gap-free runs: one segment_reduce
        data = rows[:, int(s_[0]):int(e_[-1])].T.contiguous()
        lengths = (e_ - s_).long()
        lib_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths), 10)
    timing["segment_sum_ranges"] = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
        bytes=rows.shape[0] * (covered + s_.numel()) * 4 + 2 * s_.numel() * 4, ops=0)
    (cargs, ckw), = cap.seen["cubemap_tap_accumulate"]
    k_ms = cuda_ms(lambda: ca.cubemap_tap_accumulate(*cargs, **ckw), 10)
    p_ms, _ = wall_ms(lambda: ca.cubemap_tap_accumulate_plain(*cargs, **ckw))
    idx, w = ca.tap_rows(*cargs[1:], L=ckw["L"])
    vals = (w[..., None] * cargs[0][None]).reshape(-1, ckw["C"])
    idx = idx.reshape(-1)
    n_texels = 6 * ckw["L"] ** 2

    def lib():
        torch.zeros((n_texels, ckw["C"]), device=dev).index_add_(0, idx, vals)

    # a pixel's record: g, the separable indices and weights (4 + 3 words)
    # and, when given, the generic taps (12 words)
    n_pix, n_taps = cargs[0].shape[0], w.shape[0]
    words = ckw["C"] + 7 + (12 if cargs[3] is not None else 0)
    timing["cubemap_tap_accumulate"] = dict(
        ms=k_ms, plain_ms=p_ms, library_ms=cuda_ms(lib, 10),
        bytes=n_pix * words * 4 + n_texels * ckw["C"] * 4,
        ops=n_pix * n_taps * ckw["C"] * 2, taps=n_taps)
    for k, v in timing.items():
        t_b, t_o = v["bytes"] / PEAK_BYTES_PER_S * 1e3, v["ops"] / PEAK_F32_PER_S * 1e3
        v.update(bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")
        log("6 kernel time", kernel=k, **{f: (f"{x:.4f}" if isinstance(x, float) else x)
                                         for f, x in v.items()})
    detail["train_kernel_time"] = timing
    # does Hopper keep the sort-plus-segment-sum regroup? Against one atomic
    # index_add_ of the same rows per depth rank, on the warm-up step's
    # regroup inputs
    (rargs, _), = cap.seen["regroup_grads"]
    want = tb.regroup_grads(*rargs)[:, :tb.F_GRAD]
    got = scatter_regroup(*rargs)
    reg_err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    regroup = dict(sort_segsum_ms=cuda_ms(lambda: tb.regroup_grads(*rargs), 10),
                   index_add_ms=cuda_ms(lambda: scatter_regroup(*rargs), 10),
                   rel_diff=reg_err, instances=int(rargs[0].shape[1]))
    log("6 regroup", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                        for k, v in regroup.items()})
    detail["train_regroup"] = regroup
    del cap, feats, fwd, ct, rows, vals, rargs, want, got


    # 7. the tight-culling training loop (slice 3's main path): the step with
    # two-level binning, the scheduled events and capacity growth
    import dataclasses

    from tpu_splat_torch.config import OptimizationParams
    from tpu_splat_torch.model.convert import train_state_to_numpy
    from tpu_splat_torch.raster.binning import bin_gaussians
    from tpu_splat_torch.raster.preprocess import preprocess
    from tpu_splat_torch.train import loop as tloop
    from tpu_splat_torch.train.grow import check_growth

    del ts, step, tstate, before, after
    tight_cfg = production_config(**PROD, tight_culling=True)

    # 7a. run_expand against its plain version on the run tables tight
    # binning builds at the bench frame (both levels) and kernel mode
    # builds, and timed there
    state = build_state(N_GAUSS, CAPACITY, device=dev)
    with ExpandCapture() as xcap:
        render_fast(state, views[0], tight_cfg, bgd, collect_weights=False)
        render_fast(state, views[0], production_config(**PROD, expand_mode="kernel"), bgd,
                    collect_weights=False)
    if len(xcap.seen) != 3:
        raise AssertionError(f"expected 3 run_expand calls, got {len(xcap.seen)}")
    expand = {name: check_run_expand(a)
              for name, a in zip(("tight level 1", "tight level 2", "kernel mode"), xcap.seen)}
    for name, r in expand.items():
        t_b = r["bytes"] / PEAK_BYTES_PER_S * 1e3
        r.update(bound_ms=t_b, bound_by="bytes")
        log("7 run_expand vs plain", table=repr(name), bit_exact=True,
            **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in r.items()})
    detail["run_expand"] = expand
    del xcap

    # 7b. preprocess and tight binning on the card against the CPU: a
    # 100k-surfel subset at the bench view, each device preprocessing (from
    # the state's own activations) and binning on its own; what binning
    # reads of preprocess, and every field of Binned, bit for bit
    sub_cfg = production_config(**dict(PROD, max_instances=TIGHT_SUBSET_CAP), tight_culling=True)
    preps, bins = {}, {}
    for d_ in ("cpu", dev):
        s_ = dataclasses.replace(state, **{
            f: getattr(state, f)[:TIGHT_SUBSET].to(d_) for f in
            ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "refl",
             "alive")}, env=type(state.env)(*(x.to(d_) for x in state.env)))
        cam_d = orbit_camera(H, W, radius=6.0, azimuth=0.4, elevation=0.3, device=d_)
        with torch.no_grad():
            preps[d_] = preprocess(s_.xyz, s_.get_scaling(), s_.rotation, cam_d.world_view,
                                   cam_d.full_proj, cam_d.camera_center, H, W,
                                   sh=s_.get_features(), sh_degree=3, opacity=s_.get_opacity())
        bins[d_] = bin_gaussians(preps[d_], H, W, sub_cfg)
    prep_fields = ("hom", "xy", "depth", "normal_view", "radius", "rect_min", "rect_max",
                   "tiles_touched", "valid")
    bad_prep = {f: int((getattr(preps[dev], f).cpu() != getattr(preps["cpu"], f)).sum())
                for f in prep_fields}
    bad = {f: int((getattr(bins[dev], f).cpu() != getattr(bins["cpu"], f)).sum())
           for f in bins["cpu"]._fields}
    if any(bad_prep.values()) or any(bad.values()):
        raise AssertionError(f"preprocess / tight binning on the card differ from the CPU: "
                             f"{bad_prep} {bad}")
    log("7 preprocess + tight binning card vs cpu", surfels=TIGHT_SUBSET,
        preprocess_fields=len(bad_prep), binned_fields=len(bad), differing=0,
        instances=int(bins["cpu"].num_instances), capacity=sub_cfg.max_instances)
    detail["tight_card_vs_cpu"] = dict(instances=int(bins["cpu"].num_instances),
                                       differing=bad, preprocess_differing=bad_prep)
    del preps, bins, s_

    # 7c. the small loop on the card against the CPU: each step and each
    # iteration's events run on the card, and again on the CPU from the
    # card's state before them (the events with the same draws)
    # under the exact switches: with the bf16 regroup a last-bit difference
    # in one per-instance gradient moves a sum by 2^-8 of its terms, which
    # put one row of a cancelling sum 3.4e-2 of its leaf's max apart on the
    # card (phase 6b holds the production step; 7d runs it at full width).
    # Each device bins its own preprocess output, which rounds alike on
    # both (7b): equal instance counts at every iteration, the Gaussians
    # whose instances differ counted (knife_gaussians), and every gradient
    # row held at slice 2's tolerance
    small_cfg = production_config(**SMALL, tight_culling=True, bf16_grads=False,
                                  bf16_feats=False)
    lopt = OptimizationParams(**SMALL_LOOP_OPT)
    st = small_scene(SMALL_N, 3, dev)
    _, ts, isp = train_start(st, 2)
    ts.step = 0
    cam_s = {d_: orbit_camera(SMALL_H, SMALL_W, radius=4.0, azimuth=0.5, elevation=0.2, device=d_)
             for d_ in ("cpu", dev)}
    gt_np = np.random.default_rng(1).uniform(0, 1, (SMALL_H, SMALL_W, 3)).astype(np.float32)
    steps_s = {d_: make_train_step(lopt, small_cfg, 1.0, isp_cfg=isp) for d_ in ("cpu", dev)}
    small_loop = []
    logs = {d_: tloop.EventLog() for d_ in ("cpu", dev)}
    for it in range(1, SMALL_LOOP_ITERS + 1):
        ts_c = pre_c = ts_to_device(ts, "cpu")
        run = {d_: steps_s[d_](t_, cam_s[d_], torch.tensor(gt_np, device=d_),
                               torch.zeros(3, device=d_), frame_idx=1)
               for d_, t_ in ((dev, ts), ("cpu", ts_c))}
        (ts, aux_g), (ts_c, aux_c) = run[dev], run["cpu"]
        if int(aux_g.num_instances) != int(aux_c.num_instances):
            raise AssertionError(f"small loop iteration {it}: {int(aux_g.num_instances)} "
                                 f"instances on the card, {int(aux_c.num_instances)} on the CPU")
        # loss and l1 relative; ssim absolute: against random ground truth it
        # is ~0.02, and the loss takes 1 - ssim
        rec = {f: abs(float(getattr(aux_g, f)) - float(getattr(aux_c, f)))
               / (max(abs(float(getattr(aux_c, f))), 1e-30) if f != "ssim" else 1.0)
               for f in ("loss", "l1", "ssim")}
        if max(rec.values()) > STEP_LOSS_TOL:
            raise AssertionError(f"small loop iteration {it}: losses {rec}")
        worst_grad = 0.0
        for k, ga in aux_c.grads.items():
            err = float((aux_g.grads[k].cpu() - ga).abs().max())
            scale = float(ga.abs().max())
            if err > STEP_GRAD_TOL * scale + 1e-30:
                raise AssertionError(f"small loop iteration {it}: gradient {k} off by "
                                     f"{err} of {scale}")
            worst_grad = max(worst_grad, err / max(scale, 1e-30))
        knife = knife_gaussians(pre_c, ts_to_device(pre_c, dev), cam_s["cpu"], cam_s[dev],
                                small_cfg)
        cached = {}
        draw_g = tloop.generator_draws(ts.generator)

        def draws(name, shape):  # one set of draws for both devices
            if name not in cached:
                cached[name] = draw_g(name, shape)
            return cached[name]

        ts_c = ts_to_device(ts, "cpu")
        ts = tloop.run_scheduled_events(ts, it, lopt, 1.6, np.zeros(3), log=logs[dev],
                                        draws=draws)
        ts_c = tloop.run_scheduled_events(ts_c, it, lopt, 1.6, np.zeros(3), log=logs["cpu"],
                                          draws=draws)
        worst = compare_train_states(train_state_to_numpy(ts_c), train_state_to_numpy(ts),
                                     f"small loop iteration {it}")
        if dataclasses.asdict(logs[dev]) != dataclasses.asdict(logs["cpu"]):
            raise AssertionError(f"small loop iteration {it}: event logs differ")
        small_loop.append(dict(iteration=it, instances=int(aux_g.num_instances),
                               cpu_instances=int(aux_c.num_instances),
                               knife_gaussians=knife.tolist(), grad_rel=worst_grad,
                               loss_rel=max(rec.values()), events_rel=worst,
                               alive=int(ts.gaussians.alive.sum())))
    if logs[dev].densified + logs[dev].pruned == 0:
        raise AssertionError("the small loop's densify events changed nothing")
    log("7 small loop card vs cpu", iterations=SMALL_LOOP_ITERS,
        events=json.dumps(logs[dev].events).replace(" ", ""), densified=logs[dev].densified,
        pruned=logs[dev].pruned, worst_event_rel=f"{max(r['events_rel'] for r in small_loop):.3g}",
        worst_loss_rel=f"{max(r['loss_rel'] for r in small_loop):.3g}",
        worst_grad_rel=f"{max(r['grad_rel'] for r in small_loop):.3g}",
        knife_gaussians=sum(len(r["knife_gaussians"]) for r in small_loop))
    detail["small_loop"] = dict(iterations=small_loop, log=dataclasses.asdict(logs[dev]))
    del ts, ts_c, run, steps_s

    # 7d. the slice at full width: 1M Gaussians in a 2^20 capacity, the
    # production switches with tight culling, the ISP on; a warm-up step and
    # four timed steps over the four views, then the loop body at
    # LOOP_ITERATIONS: step, scheduled events, check_growth
    del state
    tstate = build_state(N_GAUSS, CAPACITY, cubemap=TRAIN_CUBEMAP, device=dev)
    opt, ts, isp = train_start(tstate, N_VIEWS)
    del tstate
    step = make_train_step(opt, tight_cfg, 1.0, isp_cfg=isp)
    with Capture() as cap:  # warm-up step, its segment-sum inputs captured
        ts, aux = step(ts, views[0], gts[0], bg_train, frame_idx=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    tight_steps, tight_per_step = [], []
    for k in range(TRAIN_STEPS):
        before_k = dict(LAUNCHES)
        ms, (ts, aux) = wall_ms(lambda: step(ts, views[k], gts[k], bg_train, frame_idx=k))
        launched = {n: LAUNCHES[n] - before_k.get(n, 0) for n in TIGHT_KERNELS}
        tight_per_step.append(launched)
        want = {n: 2 if n == "run_expand" else 1 for n in TIGHT_KERNELS}
        if launched != want:
            raise AssertionError(f"tight step {k}: launches {launched}, want {want}")
        loss = float(aux.loss)
        if not math.isfinite(loss):
            raise AssertionError(f"tight step {k}: non-finite loss {loss}")
        tight_steps.append(dict(wall_ms=ms, instances=int(aux.num_instances), loss=loss))
        log("7 tight train", step=k, wall_ms=f"{ms:.2f}", instances=tight_steps[-1]["instances"],
            loss=f"{loss:.4f}", launches=json.dumps(launched).replace(" ", ""))
    tight_launches = {n: sum(p_[n] for p_ in tight_per_step) for n in TIGHT_KERNELS}
    # host synchronizations inside one step, rect and tight: CUDA's sync
    # debug mode warns at each
    syncs = {}
    for name, st_fn in (("rect", make_train_step(opt, cfg, 1.0, isp_cfg=isp)), ("tight", step)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ts, aux = st_fn(ts, views[0], gts[0], bg_train, frame_idx=0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        where = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        syncs[name] = len(where)
        if name == "tight":  # the source lines that synchronize, most first
            detail["tight_sync_sources"] = sorted(
                ((where.count(x), x) for x in set(where)), reverse=True)
    # the densify event's draws: made on the CPU, copied to the card
    draw_ms, _ = wall_ms(lambda: tloop.generator_draws(ts.generator)(
        "densify_eps", (2, ts.gaussians.capacity, 2)).to(dev))
    draw_bytes = 2 * 2 * ts.gaussians.capacity * 4
    log("7 tight train", host_syncs_per_step=json.dumps(syncs).replace(" ", ""),
        densify_draws_ms=f"{draw_ms:.2f}", draws_mb=f"{draw_bytes / 1e6:.1f}")
    peak_tight = torch.cuda.max_memory_allocated() / 2**30
    runs = []
    for _ in range(3):
        with record_stages() as st_ms:
            total, (ts, aux) = wall_ms(lambda: step(ts, views[0], gts[0], bg_train, frame_idx=0))
        runs.append(dict(st_ms, step_wall=total))
    tight_stages = {k: float(np.median([r.get(k, 0.0) for r in runs])) for k in runs[-1]}
    tight_stages["binning_rest"] = tight_stages["binning"] - sum(
        tight_stages.get(k, 0.0) for k in ("tight_level1_decode", "tight_column_range",
                                            "tight_level2_decode"))
    log("7 tight train stages", **{k: f"{v:.2f}" for k, v in tight_stages.items()})
    inst = [dict(view=k, tight=int(bin_view(ts.gaussians, views[k], tight_cfg).num_instances),
                 rect=int(bin_view(ts.gaussians, views[k], cfg).num_instances))
            for k in range(N_VIEWS)]
    log("7 instances tight vs rect", **{f"view{r['view']}": f"{r['tight']}/{r['rect']}"
                                        for r in inst})
    # segment_sum_rows on the warm-up step's regroup rows, made row-major
    (sargs, _), = cap.seen["segment_sum_ranges"]
    segrows = check_segsum_rows(*sargs)
    segrows.update(bound_ms=segrows["bytes"] / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
    log("7 segment_sum_rows vs plain", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                          for k, v in segrows.items()})
    del cap, sargs

    # the loop body at LOOP_ITERATIONS (scripts/train.py:220-330): growth is
    # checked after every one of them (each is a multiple of 100)
    counted = {"densify": 0}
    densify_fn = tloop.densify_and_prune

    def counting_densify(*a, **kw):
        counted["densify"] += 1
        return densify_fn(*a, **kw)

    tloop.densify_and_prune = counting_densify
    ev_log = tloop.EventLog()
    loop_recs, cur_cfg = [], tight_cfg
    extent, cam_mean = 6.0, np.zeros(3, np.float32)
    try:
        for it in LOOP_ITERATIONS:
            ts = dataclasses.replace(ts, step=it - 1)
            k = LOOP_ITERATIONS.index(it) % N_VIEWS
            ms_step, (ts, aux) = wall_ms(lambda: step(ts, views[k], gts[k], bg_train,
                                                      frame_idx=k))
            n_dens, n_events = counted["densify"], len(ev_log.events)
            prev_overflow = ev_log.overflowed
            ms_ev, ts = wall_ms(lambda: tloop.run_scheduled_events(
                ts, it, opt, extent, cam_mean, log=ev_log))
            fired = {e for i, e in ev_log.events[n_events:]}
            if counted["densify"] > n_dens:
                fired.add("densify")
            missing = LOOP_EVENTS[it] - fired
            if missing:
                raise AssertionError(f"iteration {it}: events {sorted(missing)} did not fire")
            diag = dict(n_alive=int(aux.n_alive), num_instances=int(aux.num_instances),
                        max_tile_count=int(aux.max_tile_count),
                        densify_overflow=ev_log.overflowed - prev_overflow,
                        pad_overflow=int(aux.pad_overflow))
            ms_grow, dec = wall_ms(lambda: check_growth(ts, cur_cfg, **diag))
            if dec.grew:
                ts, cur_cfg = dec.ts, dec.cfg
                step = make_train_step(opt, cur_cfg, 1.0, isp_cfg=isp)
            loop_recs.append(dict(iteration=it, step_ms=ms_step, events_ms=ms_ev,
                                  growth_ms=ms_grow, events=sorted(fired),
                                  growth=list(dec.reasons), capacity=ts.gaussians.capacity,
                                  max_instances=cur_cfg.max_instances, **diag,
                                  opacity_lr=ts.opacity_lr,
                                  cubemap=ts.gaussians.env.resolution))
            log("7 loop", iteration=it, step_ms=f"{ms_step:.2f}", events_ms=f"{ms_ev:.2f}",
                growth_ms=f"{ms_grow:.2f}", events=",".join(sorted(fired)),
                growth=repr("; ".join(dec.reasons)), capacity=ts.gaussians.capacity,
                instances=diag["num_instances"], alive=diag["n_alive"],
                cubemap=ts.gaussians.env.resolution)
    finally:
        tloop.densify_and_prune = densify_fn
    # one step after the events and growth: the grown, doubled state trains
    ts = dataclasses.replace(ts, step=LOOP_ITERATIONS[-1])
    ms_after, (ts, aux) = wall_ms(lambda: step(ts, views[0], gts[0], bg_train, frame_idx=0))
    if not math.isfinite(float(aux.loss)) or ts.gaussians.env.resolution != 2 * TRAIN_CUBEMAP:
        raise AssertionError("the step after the events failed")
    peak_loop = torch.cuda.max_memory_allocated() / 2**30
    log("7 loop", event_log=json.dumps(dataclasses.asdict(ev_log)).replace(" ", ""),
        step_after_ms=f"{ms_after:.2f}", peak_mem_gib=f"{peak_loop:.2f}",
        alive=int(ts.gaussians.alive.sum()), capacity=ts.gaussians.capacity)
    detail["tight_train"] = dict(
        steps=tight_steps, launches_per_step=tight_per_step, stages_ms=tight_stages,
        instances=inst, peak_mem_gib=peak_tight, loop=loop_recs, step_after_ms=ms_after,
        event_log=dataclasses.asdict(ev_log), loop_peak_mem_gib=peak_loop,
        densify_draw_bytes=draw_bytes, densify_draws_ms=draw_ms,
        host_syncs_per_step=syncs)
    del ts, step, aux

    # 7e. one served frame with tight culling beside the rect frame of phase
    # 4, and the binning stage of each expansion (median of 3 frames)
    state = build_state(N_GAUSS, CAPACITY, device=dev)
    render_fast(state, views[0], tight_cfg, bgd, collect_weights=False)  # warm-up
    ms_t, out_t = wall_ms(lambda: render_fast(state, views[0], tight_cfg, bgd,
                                              collect_weights=False))
    check_frame(out_t, tight_cfg, "tight served")
    served_tight = dict(wall_ms=ms_t, instances=int(out_t.num_instances),
                        rect_wall_ms=served["view0"]["wall_ms"],
                        rect_instances=served["view0"]["instances"])
    for name, c in (("gather", cfg), ("kernel", production_config(**PROD, expand_mode="kernel")),
                    ("tight", tight_cfg)):
        ms_b = []
        for _ in range(3):
            with record_stages() as st_ms:
                render_fast(state, views[0], c, bgd, collect_weights=False)
            ms_b.append(st_ms["binning"])
        served_tight[f"binning_ms_{name}"] = float(np.median(ms_b))
    log("7 serve tight", **{k: (f"{v:.2f}" if isinstance(v, float) else v)
                            for k, v in served_tight.items()})
    detail["serve_tight"] = served_tight
    del out_t

    # 8. train from a COLMAP scene on disk through the train CLI; 9. evaluate
    # the bench cloud and the trained model through the evaluation CLIs; 10.
    # extract a mesh and serve the viewer. Their files (~2 GB) are removed
    # after.
    try:
        phase8_train_from_disk(state, dev, detail)
        eval_launches = phase9_evaluate(state, dev, detail)
        mesh_launches = phase10_mesh_and_viewer(state, dev, detail)
        # 12. multi-GPU (slice 10); 12c trains on phase 8's scene
        torch.cuda.empty_cache()
        phase12a_one_rank(dev, detail, p12_sizes())
        torch.cuda.empty_cache()
        p12_launches = phase12b_ranks(detail, p12_sizes())
        phase12c_cli(dev, detail)
    finally:
        # a trainer's failure snapshot (scripts/train.py) outlives the files
        for root, _, names in os.walk(P8_DIR):
            for nm in names:
                if nm.startswith("snapshot_"):
                    shutil.move(os.path.join(root, nm),
                                os.path.join(OUT_DIR, f"phase8_{os.path.basename(root)}_{nm}"))
        shutil.rmtree(P8_DIR, ignore_errors=True)
    del state

    # 11. the modes off the main path (slice 9)
    variant_thread.join()
    if "error" in fwd_builds:
        raise fwd_builds["error"]
    import ctypes

    fwd_libs = {name: ctypes.CDLL(rec["path"]) for name, rec in fwd_builds.items()}
    log("11 forward variants built", **{k: f"{v['seconds']:.1f}s" for k, v in fwd_builds.items()})
    vol_launches = phase11_modes(dev, detail, views, fwd_libs)

    # 13. the convergence certificate and the parity CLI (slice 11)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    p13_launches = phase13_certificate(dev, detail)
    log("13 done", seconds=f"{time.perf_counter() - t13:.1f}")

    # 14. the measurement scripts: the bench CLI and the profiler
    torch.cuda.empty_cache()
    p14_launches = phase14_measurement(dev, detail)

    # the kernels' record: launches over the 4 timed steps of the newest
    # main path (the tight-culling step; segment_sum_rows is on no path)
    expand_sum = {f: sum(r[f] for r in list(expand.values())[:2])
                  for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    timing["run_expand"] = dict(expand_sum, bound_by="bytes")
    timing["segment_sum_rows"] = segrows
    kernel_errs["run_expand"] = [0.0]
    kernel_errs["segment_sum_rows"] = [segrows["max_abs_err"]]
    timing["tile_blend_forward"] = dict(ms=fwd_k_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound_ms,
                                        bound_by=fwd_bound_by, library_ms=None)
    kernel_errs["tile_blend_forward"] = errs
    sources = {
        "tile_blend_forward": ("tpu_splat_torch/csrc/tile_blend_fwd.cu",
                               "tpu_splat/kernels/tile_blend.py:670"),
        "tile_blend_backward": ("tpu_splat_torch/csrc/tile_blend_bwd.cu",
                                "tpu_splat/kernels/tile_blend.py:1347"),
        "segment_sum_ranges": ("tpu_splat_torch/csrc/segment_sum_ranges.cu",
                               "tpu_splat/kernels/segment_reduce.py:229"),
        "cubemap_tap_accumulate": ("tpu_splat_torch/csrc/cubemap_accum.cu",
                                   "tpu_splat/kernels/cubemap_accum.py:132"),
        "run_expand": ("tpu_splat_torch/csrc/run_expand.cu",
                       "tpu_splat/kernels/run_expand.py:128"),
        "segment_sum_rows": ("tpu_splat_torch/csrc/segment_sum_rows.cu",
                             "tpu_splat/kernels/segment_reduce.py:107"),
    }
    record = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": sources[name][0],
        "replaces": sources[name][1],
        "launches": tight_launches.get(name, 0),
        "max_abs_err": max(kernel_errs[name]),
        "ms": timing[name]["ms"],
        "plain_ms": timing[name]["plain_ms"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": timing[name]["library_ms"],
    } for name in sources]}
    detail["launches_slice2_steps"] = train_launches
    detail["record"] = record
    detail["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    log("done", seconds=f"{detail['seconds']:.1f}")
    print(json.dumps({"phase9_launches": {"tile_blend_forward": eval_launches},
                      "phase10_launches": {"tile_blend_forward": mesh_launches},
                      "phase11_volumetric_launches": vol_launches,
                      "phase12_launches_per_rank": p12_launches,
                      "phase13_launches": p13_launches,
                      "phase14_bench_launches_per_call": p14_launches}))
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
