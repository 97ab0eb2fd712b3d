"""Scan3D: 3D scanning from depth — tracking + fusion CLI.

Flag-compatible re-design of the reference app
(`cpp/depth_scanning/src/main_scan_3d.cpp:62-319`):
  --input --results --pose-file --first --last --scan-type --data-type
  --voxel-size --trunc --zmax --save-sdf
Flow preserved: if a GT pose file loads, run fusion-only with GT poses
(:250-254); otherwise first frame initializes the map with identity pose and
subsequent frames run GN tracking, fusing only converged frames (:256-266).
Per-frame poses stream to `<results>_poses.txt` in TUM format (:267-280);
teardown writes mesh + oriented point cloud PLYs and optional sparse SDF
dumps (:288-311).

Usage:  python -m gradient_sdf_tpu.apps.scan3d --input <dir> [...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as cfg_mod
from ..data import loaders
from ..models.grad_sdf import GradSdfMap
from ..models.pixel_sdf import PixelSdfMap
from ..models import tracker as tracker_mod
from ..utils import compile_cache, tumio
from ..utils.timer import Timer


def build_parser():
    p = argparse.ArgumentParser(
        "scan3d", description="3D scanning from depth (gradient-SDF)"
    )
    p.add_argument("--input", required=True, help="path to input data")
    p.add_argument("--results", default="./", help="folder to store results")
    p.add_argument("--pose-file", dest="pose_file", default="pose.txt",
                   help="GT trajectory file relative to --input; if it loads, "
                        "tracking is bypassed (fusion-only)")
    p.add_argument("--first", type=int, default=0, help="first frame index")
    p.add_argument("--last", type=int, default=-1, help="last frame index (inclusive)")
    p.add_argument("--scan-type", dest="scan_type", default="grad-sdf",
                   choices=["grad-sdf", "base-sdf"])
    p.add_argument("--data-type", dest="data_type", default="tum",
                   choices=["tum", "synth", "printed", "rw", "redwood"])
    p.add_argument("--voxel-size", dest="voxel_size", type=float, default=0.01)
    p.add_argument("--trunc", type=float, default=5.0,
                   help="truncation distance in multiples of voxel size")
    p.add_argument("--zmax", type=float, default=3.5, help="maximum depth")
    p.add_argument("--sampling", type=int, default=0,
                   help="tracking pixel stride (reference optimize_sampled, "
                        "RigidPointOptimizer.h:63-66); 0 = default DENSE "
                        "(sampling=1, the reference optimize() default); "
                        "stride 2 is ~2x cheaper at VGA with negligible "
                        "accuracy loss")
    p.add_argument("--fusion-stride", dest="fusion_stride", type=int,
                   default=1,
                   help="integrate every s-th pixel's ray walk (1 = every "
                        "pixel like the reference; 2 quarters fusion cost, "
                        "per-voxel means stay unbiased)")
    p.add_argument("--fast", action="store_true",
                   help="real-time preset: stride-2 fusion + stride-3 "
                        "tracking. Engages at VGA+ resolution only "
                        "(below that strided pixels under-cover the voxel "
                        "band). Non-parity: per-voxel integration weights "
                        "scale by ~1/4, tracking uses ~1/9 of the pixels "
                        "(accuracy covered by tests/test_tracker.py stride "
                        "tests); also enables --merged-step. Explicit "
                        "--sampling/--fusion-stride win")
    p.add_argument("--eval-gt", dest="eval_gt", default="groundtruth.txt",
                   help="TUM-format GT trajectory (relative to --input) used "
                        "ONLY for ATE evaluation of the tracked poses; "
                        "ignored if absent")
    p.add_argument("--save-sdf", dest="save_sdf", action="store_true")
    p.add_argument("--metrics-json", default=None,
                   help="optional path for per-run structured metrics")
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int,
                   default=0, help="write a state checkpoint every N frames")
    p.add_argument("--resume", default=None,
                   help="resume reconstruction from a state checkpoint")
    p.add_argument("--profile", default=None,
                   help="write a jax.profiler trace of one frame to this dir")
    p.add_argument("--sync-growth-checks", dest="lagged_flags",
                   action="store_false",
                   help="resolve each frame's convergence/growth flags "
                        "BEFORE dispatching the next frame (reference-exact "
                        "growth timing). Default is lagged-by-one-frame "
                        "resolution in --merged-step/--fast mode: the "
                        "flags' device->host transfer then overlaps the "
                        "next frame's device compute. Only consequence: a "
                        "capacity/directory growth triggered by frame i "
                        "takes effect at frame i+2 instead of i+1 — one "
                        "frame of bounded out-of-capacity sample loss when "
                        "growth fires (rare); tracking/fusion math is "
                        "unchanged")
    p.add_argument("--warm-start", dest="warm_alpha", nargs="?",
                   const=0.5, type=float, default=None,
                   help="constant-velocity tracking warm start: GN starts "
                        "from T_prev * exp(ALPHA * log(delta_prev)) instead "
                        "of the previous pose (the reference init, "
                        "main_scan_3d.cpp:256-266). Bare flag = damped "
                        "ALPHA 0.5 — full extrapolation (1.0) AMPLIFIES "
                        "accumulated drift through the fusion feedback "
                        "loop and diverged on the 150-frame loop protocol "
                        "(models/tracker.extrapolate_pose). Default: off "
                        "(reference init)")
    p.add_argument("--no-warm-start", dest="no_warm", action="store_true",
                   help="force the warm start off (overrides an explicit "
                        "--warm-start; no preset enables warm starting "
                        "implicitly)")
    p.add_argument("--cosine-fusion", dest="cosine_fusion",
                   action="store_true",
                   help="scale fused sample distances by the incidence "
                        "cosine (point-to-plane TSDF; "
                        "FusionConfig.cosine_correction). NON-parity "
                        "accuracy experiment: halves the measured grazing "
                        "bias on planar scenes (PARITY.md box stage) but "
                        "does not yet rescue box-scene GN convergence")
    p.add_argument("--devices", type=int, default=0,
                   help="run the reconstruction multi-device on an N-device "
                        "(rays x blocks) jax.sharding.Mesh: tracking "
                        "residuals shard over rays, the volume's per-voxel "
                        "storage resident-shards over blocks (1/D_b memory "
                        "per device), collectives ride NVLink "
                        "(parallel/sharding.py). grad-sdf only. 0/1 = "
                        "single-device. Validate on CPU with "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N")
    p.add_argument("--block-parallel", dest="block_parallel", type=int,
                   default=0,
                   help="devices on the block (grid-storage) axis; must "
                        "divide --devices. 0 = auto (2 when --devices is "
                        "even, else 1); the rest go to the ray axis")
    p.add_argument("--merged-step", dest="merged_step", action="store_true",
                   help="run tracking + conditionally-gated fusion as ONE "
                        "jitted program per frame (lax.cond on convergence; "
                        "identical semantics). Removes the mid-frame "
                        "device->host sync on the convergence flag.")
    return p


def make_merged_step(sdf_map, K, tcfg, track_mode: str, warm_alpha: float):
    """Build THE per-frame merged program: GN tracking + lax.cond-gated
    fusion + packed decision flags, as one jitted fn — single- or
    multi-device depending on whether `sdf_map` has a mesh attached
    (`GradSdfMap.attach_mesh`). Shared by the app loop and
    `__graft_entry__.dryrun_multichip`, so the driver's multi-chip dry run
    exercises the REAL app step, not a hand-rolled copy.

    The three per-frame host decisions (converged / capacity overflow /
    out-of-range samples) ride ONE packed transfer instead of three scalar
    fetches, each a device->host sync.
    """
    gcfg_l, fcfg_l = sdf_map.cfg.grid, sdf_map.cfg.fusion
    cache_l = sdf_map.cache
    mesh = getattr(sdf_map, "mesh", None)
    warm = warm_alpha > 0.0
    K_j = jnp.asarray(K, jnp.float32)

    def merged_fn(g, d, R, t, Rpp, tpp):
        if mesh is not None:
            from ..parallel import sharding

            g, R_n, t_n, conv, iters = sharding.sharded_track_and_fuse_frame(
                mesh, g, d, K_j, R, t, cache_l, gcfg_l, fcfg_l, tcfg,
                R_prev2=(Rpp if warm else None),
                t_prev2=(tpp if warm else None), warm_alpha=warm_alpha)
            res = tracker_mod.TrackResult(
                R=R_n, t=t_n, converged=conv, num_iters=iters,
                energy=jnp.float32(0.0), num_valid=jnp.int32(0))
        else:
            g, res = tracker_mod.track_and_fuse_frame(
                g, d, K_j, R, t, cache_l, gcfg_l, fcfg_l, tcfg,
                mode=track_mode,
                R_prev2=(Rpp if warm else None),
                t_prev2=(tpp if warm else None), warm_alpha=warm_alpha)
        flags = jnp.stack([
            res.converged.astype(jnp.int32),
            g.overflow.astype(jnp.int32),
            (g.oob_samples > 0).astype(jnp.int32)])
        return g, res, flags

    return jax.jit(merged_fn)


def run_scan(args) -> dict:
    """Run the app on parsed `args`; returns the run's metrics."""
    return reconstruct(args)[0]


def reconstruct(args):
    """The app's whole run on parsed `args`: returns (metrics, the final
    map), so a caller can also query the reconstruction it built."""
    T = Timer()
    cfg = cfg_mod.preset(args.data_type)
    fusion_stride = max(1, getattr(args, "fusion_stride", 1))
    # --fast's stride-2 fusion engages lazily at first frame (VGA+ only:
    # below that the strided pixel footprint exceeds the voxel size and
    # punches holes in the truncation band); explicit --fusion-stride wins
    fast_fusion = getattr(args, "fast", False) and fusion_stride == 1
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, voxel_size=args.voxel_size),
        fusion=dataclasses.replace(
            cfg.fusion, trunc_voxels=args.trunc, z_max=args.zmax,
            fusion_stride=fusion_stride,
            cosine_correction=getattr(args, "cosine_fusion", False),
        ),
    )

    loader = loaders.make_loader(args.data_type, args.input)
    K = loader.load_intrinsics("intrinsics.txt")
    if K is None:
        raise SystemExit(f"No intrinsics file found in {args.input}!")
    print("K:\n", K)

    gt = loader.load_poses(args.pose_file)
    gt_mode = gt is not None
    if gt_mode:
        print(f"{len(gt)} GT poses are loaded!")
    else:
        print("No GT poses are available!")

    if args.scan_type == "grad-sdf":
        sdf_map = GradSdfMap(cfg)
        track_mode = "grad"
    else:
        sdf_map = PixelSdfMap(cfg)
        track_mode = "trilinear"

    os.makedirs(args.results, exist_ok=True)
    pose_path = os.path.join(args.results, "_poses.txt")
    pose_entries = []

    R_cur = jnp.eye(3, dtype=jnp.float32)
    t_cur = jnp.zeros(3, dtype=jnp.float32)
    # pose one frame older than (R_cur, t_cur) — feeds the constant-velocity
    # warm start; equal to the current pose until two frames are tracked
    R_pp, t_pp = R_cur, t_cur
    if getattr(args, "no_warm", False):
        warm_alpha = 0.0
    else:
        warm_alpha = float(getattr(args, "warm_alpha", None) or 0.0)
    warm = warm_alpha > 0.0
    invalid_frames = []
    merged_jit = {"key": None, "fn": None}  # --merged-step program cache
    lagged = getattr(args, "lagged_flags", True)
    pending_flags = None  # (frame_idx, device flags) awaiting resolution

    def resolve_flags(idx, flags):
        """Act on a frame's (converged, overflow, oob) decision scalars —
        ONE packed device->host transfer for the three host decisions."""
        conv_f, overflow_f, oob_f = (int(x) for x in np.asarray(flags))
        if conv_f:
            sdf_map.counter += 1
            if overflow_f:
                sdf_map._grow()
                merged_jit["key"] = None
            if oob_f:
                sdf_map._grow_directory()
                merged_jit["key"] = None
        else:
            invalid_frames.append(idx)
    last = None if args.last < 0 else args.last + 1

    first = args.first
    resume_counter = 0
    if args.resume:
        from ..utils import checkpoint as ckpt

        state = ckpt.load_state(args.resume)
        sdf_map.grid = state["grid"]
        if state.get("grid_cfg") is not None:
            # restore the (possibly grown) grid geometry: dir_dim defines
            # the directory key linearization. The checkpoint's voxel size
            # is authoritative (legacy checkpoints lack it -> CLI value)
            gc = state["grid_cfg"]
            import math

            if math.isnan(gc.voxel_size):
                gc = dataclasses.replace(gc, voxel_size=cfg.grid.voxel_size)
            cfg = dataclasses.replace(cfg, grid=gc)
            sdf_map.cfg = dataclasses.replace(sdf_map.cfg, grid=gc)
            sdf_map._fuse_jit = None
        if state["vis"] is not None and hasattr(sdf_map, "vis"):
            sdf_map.vis = state["vis"]
        sdf_map.counter = state["counter"]
        resume_counter = state["counter"]
        pose_entries.extend(state["poses"])
        if state["poses"]:
            _, R_last, t_last = state["poses"][-1]
            R_cur = jnp.asarray(R_last)
            t_cur = jnp.asarray(t_last)
            if len(state["poses"]) >= 2:
                _, R_p, t_p = state["poses"][-2]
                R_pp, t_pp = jnp.asarray(R_p), jnp.asarray(t_p)
            else:
                R_pp, t_pp = R_cur, t_cur
        # poses are recorded per processed frame (fused or not) -> they, not
        # the fusion counter, define where to pick up
        first = args.first + (len(state["poses"]) or resume_counter)
        print(f"Resumed at frame {first} ({resume_counter} frames integrated)")

    mesh = None
    if getattr(args, "devices", 0) and args.devices > 1:
        # multi-device: attach AFTER a possible resume so the restored grid
        # is the one that gets resident-sharded
        if args.scan_type != "grad-sdf":
            raise SystemExit("--devices requires --scan-type grad-sdf "
                             "(sharded tracking is the gradient path)")
        from ..parallel import mesh as mesh_mod

        bp = getattr(args, "block_parallel", 0) or (
            2 if args.devices % 2 == 0 else 1)
        mesh = mesh_mod.make_mesh(args.devices, block_parallel=bp)
        sdf_map.attach_mesh(mesh)
        print(f"Mesh: {args.devices} devices "
              f"({args.devices // bp} rays x {bp} blocks)")
    track_jit = {"key": None, "fn": None}  # sharded split-path program cache

    ckpt_path = os.path.join(args.results, "checkpoint.npz")

    n_frames = 0
    frame_wall_s = []  # app-loop wall time of each frame, host clock
    profiled = False
    sampling_set = False

    def drain_poses():
        """Materialize device-array poses in pose_entries to host numpy in
        TWO batched transfers. A per-frame np.asarray(pose) would put a
        device->host sync on the frame loop's critical path; poses are only
        NEEDED on host at drain points — checkpoint writes and teardown —
        so they stay as device arrays until then, exactly like the lagged
        decision flags."""
        idxs = [j for j, (_, Rj, _) in enumerate(pose_entries)
                if not isinstance(Rj, np.ndarray)]
        if not idxs:
            return
        Rs = np.asarray(jnp.stack([pose_entries[j][1] for j in idxs]))
        ts = np.asarray(jnp.stack([pose_entries[j][2] for j in idxs]))
        for k_, j in enumerate(idxs):
            pose_entries[j] = (pose_entries[j][0], Rs[k_], ts[k_])

    frame_iter = iter(loader.frames(first, last))
    nxt = next(frame_iter, None)
    # depth uploads are issued one frame AHEAD: frame i+1's host->device
    # transfer is dispatched right after frame i's compute so it pipelines
    # behind the device work (the native prefetcher already decoded the
    # bytes)
    nxt_depth = jnp.asarray(nxt.depth) if nxt is not None else None
    while nxt is not None:
        t_frame = time.perf_counter()
        frame, depth = nxt, nxt_depth
        i = frame.index
        this_flags = None  # this frame's packed decision flags (merged mode)
        if not sampling_set:
            # DENSE tracking by default (sampling=1) — the reference's
            # optimize() default (RigidPointOptimizer.h:68-71).
            # --sampling opts into strides (reference
            # optimize_sampled precedent); --fast uses stride 3 at VGA+
            # (the ||xi||<1e-3 gate, RigidOptimizer.h:72, needs >= ~320x240
            # effective residual resolution, so the fast stride only
            # engages when the strided image keeps that many pixels)
            fast_ok = (getattr(args, "fast", False)
                       and frame.depth.shape[1] >= 640)
            s = args.sampling or (3 if fast_ok else 1)
            # --fast also relaxes the convergence gate to 2e-3: the
            # reference's 1e-3 (RigidOptimizer.h:72) is tuned for dense
            # VGA residual counts and sits ON the stride-3 GN noise floor.
            # Measured on 10-frame noisy VGA runs (round 4): at 1e-3,
            # 2-3/9 frames flag non-converged whether GN starts from the
            # previous pose or a constant-velocity warm start — the floor
            # is genuine strided-GN oscillation, not a start-point
            # problem; at 2e-3 the rate is 0-1/9 (again init-independent).
            # Non-parity like the rest of the preset; explicit --sampling
            # keeps the reference 1e-3.
            conv = (2e-3 if (fast_ok and not args.sampling)
                    else cfg.tracker.conv_threshold)
            # GN-buffer cap sized to the scene's depth-valid fraction
            # (tracker.adaptive_compact_cap; exact semantics — denser
            # frames fall back to the full-width loop)
            cap = tracker_mod.adaptive_compact_cap(frame.depth, cfg.fusion)
            cfg = dataclasses.replace(
                cfg, tracker=dataclasses.replace(
                    cfg.tracker, sampling=s, conv_threshold=conv,
                    compact_cap_frac=cap)
            )
            if fast_fusion and frame.depth.shape[1] >= 640:
                new_f = dataclasses.replace(sdf_map.cfg.fusion,
                                            fusion_stride=2)
                cfg = dataclasses.replace(cfg, fusion=new_f)
                sdf_map.cfg = dataclasses.replace(sdf_map.cfg, fusion=new_f)
                sdf_map._fuse_jit = None
            sampling_set = True
        print(f"Working on frame: {i}")
        if args.profile and n_frames == 2 and not profiled:
            # third frame: compiles are done, steady-state behavior
            jax.profiler.start_trace(args.profile)
            profiled = True
        if i == first and resume_counter == 0:
            T.tic()
            if gt_mode:
                R_cur = jnp.asarray(gt[0][1])
                t_cur = jnp.asarray(gt[0][2])
                sdf_map.update(depth, K, (R_cur, t_cur))
            else:
                sdf_map.setup(depth, K)
            T.toc("Integrate depth data into Sdf")
        elif gt_mode:
            T.tic()
            R_cur = jnp.asarray(gt[i][1])
            t_cur = jnp.asarray(gt[i][2])
            sdf_map.update(depth, K, (R_cur, t_cur))
            T.toc("Integrate depth data into Sdf")
        elif getattr(args, "merged_step", False) or getattr(args, "fast",
                                                            False):
            # one program: track + lax.cond-gated fuse (no mid-frame sync)
            T.tic()
            sdf_map.ensure_cache(np.asarray(K), depth.shape[1],
                                 depth.shape[0])
            key = (sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker,
                   track_mode, warm_alpha)
            if merged_jit.get("key") != key:
                merged_jit["fn"] = make_merged_step(
                    sdf_map, K, cfg.tracker, track_mode, warm_alpha)
                merged_jit["key"] = key
            new_grid, res, flags = merged_jit["fn"](
                sdf_map.grid, depth, R_cur, t_cur, R_pp, t_pp)
            R_pp, t_pp = R_cur, t_cur
            R_cur, t_cur = res.R, res.t
            sdf_map.grid = new_grid
            this_flags = (i, flags)  # resolved below, after the prefetch
            T.toc("Track+fuse (merged)")
        else:
            T.tic()
            # read grid/fusion config from the map: capacity or directory
            # growth between frames changes them (stale configs index the
            # enlarged directory with the wrong linearization)
            R_init, t_init = ((tracker_mod.extrapolate_pose(
                R_cur, t_cur, R_pp, t_pp, warm_alpha))
                if warm else (R_cur, t_cur))
            if mesh is not None:
                key = (sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker)
                if track_jit.get("key") != key:
                    from ..parallel import sharding as sh_mod

                    gcfg_l, fcfg_l = sdf_map.cfg.grid, sdf_map.cfg.fusion
                    tcfg_l = cfg.tracker
                    track_jit["fn"] = jax.jit(
                        lambda g, d, R, t: sh_mod.sharded_track_frame(
                            mesh, g, d, jnp.asarray(K), R, t,
                            gcfg_l, fcfg_l, tcfg_l))
                    track_jit["key"] = key
                R_n, t_n, conv_d, iters = track_jit["fn"](
                    sdf_map.grid, depth, R_init, t_init)
                res = tracker_mod.TrackResult(
                    R=R_n, t=t_n, converged=conv_d, num_iters=iters,
                    energy=jnp.float32(0.0), num_valid=jnp.int32(0))
            else:
                res = tracker_mod.track_frame(
                    sdf_map.grid, depth, jnp.asarray(K), R_init, t_init,
                    sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker,
                    mode=track_mode,
                )
            conv = bool(res.converged)
            T.toc("Point optimization")
            R_pp, t_pp = R_cur, t_cur
            R_cur, t_cur = res.R, res.t
            if conv:
                T.tic()
                sdf_map.update(depth, K, (R_cur, t_cur))
                T.toc("Integrate depth data into Sdf")
            else:
                invalid_frames.append(i)

        # prefetch: decode the NEXT frame and dispatch its depth upload
        # while this frame's program runs on device
        T.tic()
        nxt = next(frame_iter, None)
        nxt_depth = jnp.asarray(nxt.depth) if nxt is not None else None
        T.toc("Load data")

        if this_flags is not None:
            if lagged:
                # resolve the PREVIOUS frame's flags now — this frame's
                # program and the next frame's upload are already
                # dispatched, so the host sync overlaps device work (this frame's
                # flags resolve next frame / at drain)
                if pending_flags is not None:
                    resolve_flags(*pending_flags)
                pending_flags = this_flags
            else:
                resolve_flags(*this_flags)

        # poses stay device arrays until a drain point (see drain_poses)
        pose_entries.append((frame.timestamp, R_cur, t_cur))
        n_frames += 1
        frame_wall_s.append(time.perf_counter() - t_frame)
        if profiled and n_frames == 3:
            jax.profiler.stop_trace()

        if args.checkpoint_every:
            k = args.checkpoint_every
            # the cadence gate must see the counter a --sync-growth-checks
            # run would see at this frame, but under lagged flags this
            # frame's convergence (a possible +1) is still in flight. Drain
            # only when the gate COULD fire either way — the pending frame
            # converging (counter+1) or not (counter) — so frames that
            # cannot hit the cadence keep the lagged-flag overlap.
            might_fire = (sdf_map.counter % k == 0) or (
                pending_flags is not None and (sdf_map.counter + 1) % k == 0
            )
            if might_fire and pending_flags is not None:
                # the checkpoint must capture a fully-resolved state
                # (counter / growth / invalid_frames), or a resume would
                # silently drop this frame's decisions. Costs one sync, and
                # save_state already syncs the whole grid to host anyway.
                resolve_flags(*pending_flags)
                pending_flags = None
            if might_fire and sdf_map.counter % k == 0:
                from ..utils import checkpoint as ckpt

                drain_poses()
                ckpt.save_state(
                    ckpt_path, sdf_map.grid,
                    vis=getattr(sdf_map, "vis", None),
                    counter=sdf_map.counter, poses=pose_entries,
                    grid_cfg=sdf_map.cfg.grid,
                )

    if pending_flags is not None:  # drain the last frame's lagged flags
        resolve_flags(*pending_flags)
    drain_poses()

    tumio.write_trajectory(pose_path, pose_entries)

    prefix = os.path.join(args.results, "gradient_sdf")
    T.tic()
    if not sdf_map.extract_mesh(prefix + "_mesh_final.ply"):
        print(f"Could not save mesh!")
    T.toc("Save mesh to disk")
    if hasattr(sdf_map, "extract_pc"):
        T.tic()
        sdf_map.extract_pc(prefix + "_cloud_final.ply")
        T.toc("Save point cloud to disk")
    if args.save_sdf:
        T.tic()
        sdf_map.save_sdf(prefix)
        T.toc("Save sdf txt files to disk")

    metrics = {
        "frames": n_frames,
        "invalid_frames": invalid_frames,
        "num_blocks_active": int(sdf_map.grid.num_active),
        "overflow": bool(sdf_map.grid.overflow),
        "growth_events": list(getattr(sdf_map, "growth_events", [])),
        "timers": T.summary(),
        "frame_wall_s": frame_wall_s,
    }

    # ATE vs an evaluation-only GT trajectory (the external-tooling protocol
    # the reference relies on for its TUM pose outputs, main_scan_3d.cpp:278-280)
    if not gt_mode and args.eval_gt:
        gt_eval = loader.load_poses(args.eval_gt)
        if gt_eval:
            from ..utils import ate as ate_mod

            est = [(ts, t) for ts, _, t in pose_entries]
            ref = [(ts, np.asarray(t)) for ts, _, t in gt_eval]
            res = ate_mod.evaluate_ate(est, ref)
            if res is not None:
                metrics["ate_rmse"] = float(res.rmse)
                metrics["ate_pairs"] = int(res.num_pairs)
                print(f"ATE RMSE vs {args.eval_gt}: {res.rmse:.4f} m "
                      f"({res.num_pairs} pairs)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics, sdf_map


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    return run_scan(args)


if __name__ == "__main__":
    main()
