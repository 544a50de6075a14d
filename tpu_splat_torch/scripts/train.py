"""Training CLI (port of tpu_splat/scripts/train.py; role of the reference
train.py).

    python -m tpu_splat_torch.scripts.train -s <scene_dir> -m <model_dir> [flags]

The reference's schedule: two-stage deferred reflection, the densification
window, normal propagation, colour sabotage, opacity-LR pulsing, env-map
doubling, the xyz freeze, the learned ISP with the late scene freeze, plus
capacity growth, checkpoints, PLY snapshots and cfg_args, all in files the
JAX package reads, and the network viewer (one request served an
iteration unless --disable_viewer).

`--volumetric` trains volumetric 3DGS Gaussians (3DGS-DR: three scale axes,
each Gaussian's normal its shortest axis) in place of 2DGS surfels; the
PLY's `scale_2` column carries the third axis to the other CLIs.

`--mesh tiles` splits each step's tile grid over several ranks, `--mesh dp`
renders one camera per rank (`dp` views a step from the same epoch
shuffle; cameras of mixed sizes are padded to one size and masked in the
loss). The one command starts `--mesh_devices` ranks itself (0: one per
local card; on the CPU, 0 is one rank), at most one per card, or joins
torchrun's group when started under torchrun. Every rank runs the same
schedule with the same draws, so the replicas stay identical; rank 0 alone
writes the files (the same files a one-device run writes) and serves the
viewer.
"""
from __future__ import annotations

import math
import os
import random
import time

import numpy as np


def training(args, argv_namespace=None, device: str = "cuda"):
    """Train from `args` (the parsed flags of `main`) on `device`; returns
    the final TrainState."""
    import torch

    from tpu_splat_torch.config import (
        ModelParams,
        OptimizationParams,
        PipelineParams,
        save_cfg_args,
    )
    from tpu_splat_torch.core.device import resolve_device
    from tpu_splat_torch.data.scene import Scene
    from tpu_splat_torch.isp.ppisp import ISPConfig
    from tpu_splat_torch.model.io import load_checkpoint, save_checkpoint
    from tpu_splat_torch.model.state import init_from_pcd
    from tpu_splat_torch.raster.config import RasterConfig, production_config
    from tpu_splat_torch.train.debug_dump import dump_snapshot
    from tpu_splat_torch.train.grow import check_growth
    from tpu_splat_torch.train.loop import EventLog, is_scene_frozen, run_scheduled_events
    from tpu_splat_torch.train.report import TrainReporter
    from tpu_splat_torch.train.step import TrainState, make_train_step, make_train_step_dp

    dev = resolve_device(device)
    mesh_mode = getattr(args, "mesh", "none")
    mesh = None
    if mesh_mode in ("tiles", "dp"):
        from tpu_splat_torch.dist import make_mesh

        mesh = make_mesh(getattr(args, "mesh_devices", 0) or None, axis=mesh_mode)
        if mesh is None:  # a rank past --mesh_devices of torchrun's group
            return None
    rank0 = mesh is None or mesh.rank == 0
    dp_n = mesh.size if mesh_mode == "dp" else 1
    model = ModelParams.extract(args).finalize()
    opt = OptimizationParams.extract(args)
    pipe = PipelineParams.extract(args)
    if getattr(args, "normal_propagation", None) is False:
        opt.disable_normal_propagation = True
    if getattr(args, "color_sabotage", None) is False:
        opt.disable_color_sabotage = True

    volumetric = bool(getattr(args, "volumetric", False))
    if volumetric and getattr(args, "tight_culling", False):
        raise SystemExit("--volumetric bins by the rect: drop --tight_culling")

    if rank0:
        os.makedirs(model.model_path, exist_ok=True)
        if argv_namespace is not None:
            save_cfg_args(model.model_path, argv_namespace)

    if rank0:
        print(f"Loading scene {model.source_path}")
    scene = Scene(
        model.source_path,
        model.model_path,
        images=model.images,
        resolution=model.resolution,
        eval_split=model.eval,
        num_points=model.num_points,
        # the images live on the data device, or with the model on the CPU
        device=dev if dev.type == "cpu" else model.data_device,
    )
    if rank0:
        scene.save_cameras_json()
    pts, cols = scene.point_cloud
    capacity = 1 << max(int(np.ceil(np.log2(max(len(pts) * 4, 1 << 14)))), 14)
    state = init_from_pcd(
        pts,
        cols,
        capacity=capacity,
        max_sh_degree=model.sh_degree,
        init_refl_value=1e-3,  # reference create_from_pcd local default
        cubemap_resolution=model.cubemap_resol,
        device=dev,
        volumetric=volumetric,
    )
    if rank0:
        print(f"{len(pts)} points, capacity {capacity}, extent {scene.cameras_extent:.2f}")

    # the shipped config (production_config); --exact_grads or a nonzero
    # depth_ratio take the exact f32 full-channel path
    exact = pipe.depth_ratio != 0.0 or bool(getattr(args, "exact_grads", False))
    cfg = production_config(
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        max_instances=args.max_instances,
        tile_depth=args.tile_depth,
        chunk=32,
        depth_ratio=pipe.depth_ratio,
        **(dict(grad_channels="full", bf16_grads=False, bf16_feats=False) if exact else {}),
        tight_culling=bool(getattr(args, "tight_culling", False)),
        opacity_rect=bool(getattr(args, "opacity_rect", True)),
    )

    ts = TrainState.create(
        state, opt, num_frames=len(scene.train_cameras) if model.post_process else None
    )
    first_iter = 0
    if args.start_checkpoint:
        ts, first_iter = load_checkpoint(args.start_checkpoint, ts)
        print(f"Restored checkpoint at iteration {first_iter}")

    isp_cfg = None
    if model.post_process:
        isp_cfg = ISPConfig(
            controller_activation_ratio=(opt.iterations - 5000) / opt.iterations
        )
    bg_list = [1.0, 1.0, 1.0] if model.white_background else [0.0, 0.0, 0.0]
    bg = torch.tensor(bg_list, device=dev)

    if mesh is not None:
        n_sizes = _bucket_camera_sizes(scene.train_cameras) if mesh_mode == "dp" else 1
        if rank0:
            print(f"mesh: {mesh_mode} over {mesh.size} devices")
            if n_sizes > 1:
                lc = scene.train_cameras[0]
                print(f"--mesh dp: bucketing {n_sizes} camera sizes to "
                      f"{lc.camera.height}x{lc.camera.width} with loss masks")

    def build_step(raster_cfg):
        common = dict(
            spatial_lr_scale=scene.cameras_extent,
            use_env_scope=opt.use_env_scope,
            env_scope_center=opt.env_scope_center,
            env_scope_radius=opt.env_scope_radius,
            isp_cfg=isp_cfg,
        )
        if mesh_mode == "dp":
            return make_train_step_dp(opt, raster_cfg, mesh=mesh, **common)
        return make_train_step(opt, raster_cfg, mesh=mesh, mesh_axis="tiles", **common)

    step_fn = build_step(cfg)
    reporter = TrainReporter(model.model_path, enable_tb=not args.quiet) if rank0 else None
    gui = None
    if rank0 and not args.disable_viewer:
        from tpu_splat_torch.viewer import network_gui

        try:
            gui = network_gui.NetworkGUI(args.ip, args.port)
        except OSError as e:
            print(f"viewer disabled (cannot bind {args.ip}:{args.port}: {e})")
    eval_cfg = RasterConfig(
        max_tiles_per_gaussian=args.max_tiles_per_gaussian,
        max_instances=args.max_instances,
        tile_depth=args.tile_depth,
        depth_ratio=pipe.depth_ratio,
    )

    cams = scene.train_cameras
    order = []
    rng = random.Random(0)
    ema_loss = 0.0
    log = EventLog()
    t_start = time.time()

    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
            frozen = is_scene_frozen(iteration, opt, model.post_process)
            # dp_n views a step (one for one device or --mesh tiles) from the
            # same without-replacement epoch shuffle on every rank
            vinds = []
            while len(vinds) < dp_n:
                if not order:
                    order = list(range(len(cams)))
                    rng.shuffle(order)
                vinds.append(order.pop())
            if mesh_mode == "dp":
                batch = [cams[v] for v in vinds]
                cam = batch[mesh.rank]  # this rank's, for a failure snapshot
                gt = cam.image.to(dev)
                gts = [gt if lc is cam else lc.image for lc in batch]
                alphas = None
                if all(lc.alpha is not None for lc in batch):
                    alphas = [lc.alpha.to(dev) for lc in batch]
                masks = None
                if any(getattr(lc, "pix_mask", None) is not None for lc in batch):
                    masks = [lc.pix_mask.to(dev) for lc in batch]
                ts, aux = step_fn(ts, [lc.camera for lc in batch], gts, bg, gt_alphas=alphas,
                                  frozen=frozen, frame_idx=vinds, pix_masks=masks)
            else:
                cam = cams[vinds[0]]
                gt = cam.image.to(dev)
                alpha = cam.alpha.to(dev) if cam.alpha is not None else None
                ts, aux = step_fn(ts, cam.camera, gt, bg, gt_alpha=alpha, frozen=frozen,
                                  frame_idx=vinds[0])

            # a device-side EMA: the host reads the loss only when it prints
            ema_loss = 0.4 * aux.loss + 0.6 * ema_loss
            if iteration % 100 == 0 or iteration == 1:
                loss_now = float(aux.loss)
                if not math.isfinite(loss_now):
                    # reference-style failure snapshot (diff_surfel_rasterization/
                    # __init__.py:91-98): dump every rasterizer input once, then
                    # stop, so the failure reproduces offline
                    p = None if not rank0 else dump_snapshot(
                        model.model_path, ts.gaussians, cam.camera, gt, iteration,
                        f"non-finite loss {loss_now} at iteration {iteration}",
                        cfg=cfg, bg=bg,
                    )
                    raise RuntimeError(
                        f"non-finite loss at iteration {iteration}; "
                        f"rasterizer inputs dumped to {p or 'existing snapshot_fw.npz'}"
                    )
                if rank0:
                    print(
                        f"[{iteration}] loss {float(ema_loss):.5f} psnr {float(aux.psnr):.2f} "
                        f"pts {int(aux.n_alive)} inst {int(aux.num_instances)} "
                        f"maxtile {int(aux.max_tile_count)} "
                        f"({(time.time()-t_start):.0f}s)"
                    )
            prev_overflow = log.overflowed
            ts = run_scheduled_events(
                ts,
                iteration,
                opt,
                cameras_extent=scene.cameras_extent,
                cameras_mean=scene.cameras_mean,
                scene_frozen=frozen,
                log=log,
            )

            # geometric capacity growth (role of the reference's resize
            # callback, rasterize_points.cu:31-37): after a densify overflow
            # and every 100 steps, grow whatever is (nearly) full and rebuild
            # the step
            if log.overflowed != prev_overflow or iteration % 100 == 0:
                dec = check_growth(
                    ts,
                    cfg,
                    n_alive=int(aux.n_alive),
                    num_instances=int(aux.num_instances),
                    max_tile_count=int(aux.max_tile_count),
                    densify_overflow=log.overflowed - prev_overflow,
                    pad_overflow=int(aux.pad_overflow),
                )
                if dec.grew:
                    ts, cfg = dec.ts, dec.cfg
                    if rank0:
                        print(f"[{iteration}] GROW: " + "; ".join(dec.reasons))
                    step_fn = build_step(cfg)
                elif rank0 and int(aux.num_instances) >= cfg.max_instances:
                    # the forward dropped instances this step and growth did not
                    # trigger: keep a one-shot snapshot for an offline repro
                    p = dump_snapshot(
                        model.model_path, ts.gaussians, cam.camera, gt, iteration,
                        f"instance overflow {int(aux.num_instances)} >= "
                        f"{cfg.max_instances} at iteration {iteration}",
                        cfg=cfg, bg=bg,
                    )
                    if p:
                        print(f"[{iteration}] OVERFLOW snapshot -> {p}")

            if not rank0:
                continue
            if iteration % 100 == 0:
                reporter.scalars(
                    iteration,
                    {
                        "train_loss_patches/total_loss": float(aux.loss),
                        "train_loss_patches/l1_loss": float(aux.l1),
                        "train_loss_patches/normal_loss": float(aux.normal_loss),
                        "total_points": int(aux.n_alive),
                    },
                )
            if iteration in args.test_iterations:
                reporter.evaluate(
                    iteration, ts.gaussians, eval_cfg, bg_list,
                    scene.test_cameras, scene.train_cameras,
                )
                reporter.model_stats(iteration, ts.gaussians)
            if gui is not None:
                network_gui.service_viewer(gui, ts.gaussians, eval_cfg, bg, model.source_path,
                                           {"it": iteration}, isp=ts.isp)
            if iteration in args.save_iterations:
                print(f"[ITER {iteration}] Saving Gaussians")
                scene.save(ts.gaussians, iteration)
            if iteration in args.checkpoint_iterations:
                print(f"[ITER {iteration}] Saving Checkpoint")
                save_checkpoint(
                    os.path.join(model.model_path, f"chkpnt{iteration}.npz"), ts, iteration
                )
    finally:
        if gui is not None:
            gui.close()

    if rank0:
        reporter.close()
        scene.save(ts.gaussians, opt.iterations)
        dt_min = (time.time() - t_start) / 60
        print(f"Training complete in {dt_min:.1f} min; events: {len(log.events)}, "
              f"densified {log.densified}, pruned {log.pruned}, overflow {log.overflowed}")
    return ts


def _bucket_camera_sizes(cams) -> int:
    """Camera-size bucketing for --mesh dp: when the training cameras come
    in more than one size, pad each camera (`Camera.pad_to` keeps the
    original pixels in place), its image and alpha to the largest height
    and width, and give it `pix_mask`, 1 on its own pixels, for the loss.
    -> the number of sizes."""
    import torch.nn.functional as F

    sizes = {(lc.camera.height, lc.camera.width) for lc in cams}
    if len(sizes) < 2:
        return len(sizes)
    hmax = max(h for h, _ in sizes)
    wmax = max(w for _, w in sizes)
    for lc in cams:
        h0, w0 = lc.image.shape[:2]
        grow = (0, 0, 0, wmax - w0, 0, hmax - h0)
        mask = lc.image.new_zeros((hmax, wmax, 1))
        mask[:h0, :w0] = 1.0
        lc.pix_mask = mask
        lc.camera = lc.camera.pad_to(hmax, wmax)
        lc.image = F.pad(lc.image, grow)
        if lc.alpha is not None:
            lc.alpha = F.pad(lc.alpha, grow)
    return len(sizes)


def _mesh_ranks(requested: int, device: str) -> int:
    """Ranks for --mesh_devices: on the card at most one per local card (0:
    all of them), on the CPU as asked (0: one)."""
    import torch

    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count()
        return min(requested, n) if requested else n
    return requested or 1


def _train_rank(rank: int, args, device: str):
    """One rank of a multi-rank run: train on this rank's card (or the
    CPU); rank 0 returns the final TrainState."""
    import torch

    dev = f"cuda:{torch.cuda.current_device()}" if torch.device(device).type == "cuda" else device
    ts = training(args, argv_namespace=args, device=dev)
    return ts if rank == 0 else None


def main(argv=None, device: str = "cuda"):
    """The JAX CLI's flags and defaults (tpu_splat/scripts/train.py:main);
    `device` is where the model trains (the tests pass "cpu")."""
    from argparse import SUPPRESS, BooleanOptionalAction

    from tpu_splat_torch.config import build_parser

    parser = build_parser()
    parser.add_argument("--iterations_override", type=int, default=None)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7000, 30000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--max_tiles_per_gaussian", type=int, default=64)
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--tile_depth", type=int, default=1024)
    parser.add_argument(
        "--exact_grads", action="store_true",
        help="disable bf16 compression of per-instance gradient rows",
    )
    parser.add_argument(
        "--tight_culling", action="store_true",
        help="per-column 3-sigma-conic tile binning (PARITY.md D2): fewer "
        "instances on anisotropic scenes at higher binning cost",
    )
    parser.add_argument(
        "--volumetric", action="store_true", default=SUPPRESS,
        help="volumetric 3DGS Gaussians (three scale axes, 3DGS-DR's shortest-axis "
        "normals) in place of 2DGS surfels; recorded in cfg_args only when given",
    )
    parser.add_argument(
        "--opacity_rect", action=BooleanOptionalAction, default=True,
        help="opacity-aware tile rect: stop emitting (gaussian, tile) "
        "overlaps that can only contribute alpha < 1/255. Default on; "
        "--no-opacity_rect disables",
    )
    parser.add_argument(
        "--mesh", type=str, default="none", choices=["none", "tiles", "dp"],
        help="multi-device mode: split the tile grid of each step over the ranks (tiles) "
        "or render one camera per rank (dp)",
    )
    parser.add_argument(
        "--mesh_devices", type=int, default=0,
        help="ranks in the mesh, one per card (0 = every local card)",
    )
    parser.add_argument("--quiet", "-q", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--auto_test", action="store_true",
                        help="test every 5000 iterations (reference train.py:515-516)")
    args = parser.parse_args(argv)
    args.save_iterations = list(args.save_iterations)
    if args.iterations_override:
        args.iterations = args.iterations_override
    if args.auto_test:
        args.test_iterations = list(range(5000, args.iterations + 1, 5000))
    if args.iterations not in args.save_iterations:
        args.save_iterations.append(args.iterations)
    if args.mesh == "none":
        return training(args, argv_namespace=args, device=device)
    import torch

    from tpu_splat_torch.dist import launch, multihost_init

    on_card = torch.device(device).type == "cuda"
    rank, _ = multihost_init(backend="nccl" if on_card else "gloo")
    if torch.distributed.is_initialized():
        # a rank of torchrun's group (or of one its caller set up): its card
        # is its local rank
        if on_card and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        return _train_rank(rank, args, device)
    k = _mesh_ranks(args.mesh_devices, device)
    return launch(_train_rank, k, args=(args, device),
                  backend="nccl" if on_card else "gloo")[0]


if __name__ == "__main__":
    main()
