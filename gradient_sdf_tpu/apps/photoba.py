"""PhotoBA: photometric bundle adjustment CLI.

Flag-compatible re-design of the reference app
(`cpp/photometric_opt/src/main_photo_ba.cpp:65-347`): Phase 1 runs the same
tracking+fusion loop as Scan3D (grad-sdf hard-wired, :214) with online
keyframe selection — a converged frame becomes a keyframe when it passes the
sharpness test or the gap since the last keyframe exceeds 5 (:246-259); the
first frame is always a keyframe (see the deviation note in
models/photo_ba.py). Phase 2 evenly subsamples keyframes to at most
--key-frame (default 30, `sampleKeyFrame` :319-347, always keeping the
last), runs PhotometricOptimizer.optimize() (alternating pose/dist solves),
then the ColorUpsampler computes subvoxel albedo and exports the HR colored
mesh + cloud (:300-311).

Usage:  python -m gradient_sdf_tpu.apps.photoba --input <dir> [...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from .. import config as cfg_mod
from ..data import loaders
from ..models import color_upsampler, photo_ba, sharpness
from ..models import tracker as tracker_mod
from ..models.grad_sdf import GradSdfMap
from ..utils import compile_cache, tumio
from ..utils.timer import Timer


def build_parser():
    p = argparse.ArgumentParser("photoba", description="photometric BA")
    p.add_argument("--input", required=True)
    p.add_argument("--results", default="./")
    p.add_argument("--first", type=int, default=0)
    p.add_argument("--last", type=int, default=-1)
    p.add_argument("--data-type", dest="data_type", default="tum",
                   choices=["tum", "synth", "printed", "rw", "redwood"])
    p.add_argument("--voxel-size", dest="voxel_size", type=float, default=0.01)
    p.add_argument("--trunc", type=float, default=5.0)
    p.add_argument("--zmax", type=float, default=3.5)
    p.add_argument("--pose-file", dest="pose_file", default=None,
                   help="TUM trajectory relative to --input: phase 1 runs "
                        "FUSION-ONLY with these poses (tracking bypassed, "
                        "every frame treated as converged). Used by the "
                        "golden parity harness to pin phase-1 state to the "
                        "reference binary's own tracked trajectory so the "
                        "BA comparison is isolated from tracking fp noise.")
    p.add_argument("--key-frame", dest="key_frame", type=int, default=30,
                   help="maximum number of keyframes used in BA")
    p.add_argument("--ba-init-pose-file", dest="ba_init_pose_file",
                   default=None,
                   help="TUM trajectory relative to --input: OVERRIDE the "
                        "BA keyframes' initial poses (matched by "
                        "timestamp) after phase 1. With --pose-file "
                        "gt_poses.txt this is the BA-recovery fixture: the "
                        "map is fused at ground truth and BA starts from "
                        "perturbed poses (parity/run_golden_parity.py "
                        "--ba-recovery measures how far each "
                        "implementation recovers)")
    p.add_argument("--coupled-poses", action="store_true",
                   help="use the full 6Fx6F pose system (solvePoseFull)")
    p.add_argument("--channel-mix-parity", action="store_true",
                   help="replicate the reference's channel-REVERSED image "
                        "gradients (PhotometricOptimizer.cpp:102-126) so "
                        "per-iteration BA energies are gateable against "
                        "the reference binary on COLORED data")
    p.add_argument("--sharded-ba", action="store_true",
                   help="shard BA over the surface-voxel axis across all "
                        "local devices (psum'd pose systems)")
    p.add_argument("--keyframe-gap", dest="keyframe_gap", type=int,
                   default=None,
                   help="override dist_to_last_keyframe gap (reference "
                        "hardcodes 5, main_photo_ba.cpp:246)")
    p.add_argument("--max-recorded-keyframes", dest="max_recorded_keyframes",
                   type=int, default=None,
                   help="visibility-bitfield slot capacity (default 128; "
                        "4 uint32 words per voxel per 128 slots)")
    p.add_argument("--metrics-json", default=None)
    return p


def sample_keyframes(items: list, max_num: int) -> list:
    """Evenly subsample to <= max_num keeping the last — exact mirror of
    `sampleKeyFrame` (main_photo_ba.cpp:319-347): max_num-1 picks at
    float32-accumulated stride len/(max_num-1), truncated to int, plus the
    last item. (A linspace+round variant picked {0,2,5} where the reference
    picks {0,3,5} on 6->3 — caught by the golden parity harness.)"""
    if len(items) < max_num:
        return items
    n = max_num - 1
    step = np.float32(len(items)) / np.float32(n)
    out = []
    f = np.float32(0.0)
    for _ in range(n):
        out.append(items[int(f)])
        f += step
    out.append(items[-1])
    return out


def run_photoba(args) -> dict:
    T = Timer()
    cfg = cfg_mod.preset(args.data_type)
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, voxel_size=args.voxel_size),
        fusion=dataclasses.replace(cfg.fusion, trunc_voxels=args.trunc,
                                   z_max=args.zmax),
        photo_ba=dataclasses.replace(
            cfg.photo_ba, max_keyframes=args.key_frame,
            channel_mix_parity=getattr(args, "channel_mix_parity", False),
            **{k: v for k, v in (
                ("keyframe_gap", getattr(args, "keyframe_gap", None)),
                ("max_recorded_keyframes",
                 getattr(args, "max_recorded_keyframes", None)),
            ) if v is not None}),
    )
    sharp_thr = cfg.photo_ba.sharpness_threshold

    loader = loaders.make_loader(args.data_type, args.input)
    K = loader.load_intrinsics("intrinsics.txt")
    if K is None:
        raise SystemExit(f"No intrinsics file found in {args.input}!")

    sdf_map = GradSdfMap(cfg, with_vis=True)
    os.makedirs(args.results, exist_ok=True)

    last = None if args.last < 0 else args.last + 1
    gt_poses = None
    if getattr(args, "pose_file", None):
        loaded = loader.load_poses(args.pose_file)
        if loaded:
            gt_poses = [(np.asarray(R), np.asarray(t))
                        for _, R, t in loaded]
            print(f"{len(gt_poses)} poses loaded; phase 1 is fusion-only")
            # pose rows are indexed by (frame - first): a short file (or a
            # full-trajectory file combined with --first > 0) would raise a
            # raw IndexError mid-run or silently fuse misaligned poses
            n_avail = (len(loader) if hasattr(loader, "__len__") else None)
            n_need = ((last - args.first) if last is not None else n_avail)
            if n_need is not None and len(gt_poses) < n_need:
                raise SystemExit(
                    f"pose file {args.pose_file} has {len(gt_poses)} poses "
                    f"but frames {args.first}..{args.first + n_need - 1} "
                    f"need {n_need}; rows are consumed as pose[frame - "
                    f"first] — align --first/--last with the file")
            if args.first != 0:
                print(f"WARNING: --first={args.first}: pose rows are read "
                      f"as pose[frame - {args.first}] — make sure the file "
                      f"starts at that frame, not at frame 0")

    R_cur = jnp.eye(3, dtype=jnp.float32)
    t_cur = jnp.zeros(3, dtype=jnp.float32)
    pose_entries = []
    keyframes = []  # list of dicts: frame, stamp, image, pose, slot
    invalid_frames = []
    suppressed_keyframes = 0  # keyframe-worthy frames past the slot cap
    dist_to_last_kf = 0

    for frame in loader.frames(args.first, last):
        i = frame.index
        print(f"Working on frame: {i}")
        depth = jnp.asarray(frame.depth)

        if i == args.first:
            # first frame: identity pose, always a keyframe. Keyframe dicts
            # keep the frame INDEX, not the pixels: the <= --key-frame
            # sampled images are re-decoded right before BA, bounding host
            # memory to O(max_keyframes) images (the reference copies EVERY
            # candidate image into RAM, main_photo_ba.cpp:228-231/:252-254)
            slot = len(keyframes)
            if gt_poses is not None:
                R0, t0 = gt_poses[0]
                R_cur = jnp.asarray(R0)
                t_cur = jnp.asarray(t0)
                sdf_map.setup(depth, K, pose=(R_cur, t_cur), kf_slot=slot)
                first_pose = (np.asarray(R0, np.float32),
                              np.asarray(t0, np.float32))
            else:
                sdf_map.setup(depth, K, kf_slot=slot)
                first_pose = (np.eye(3, dtype=np.float32),
                              np.zeros(3, dtype=np.float32))
            keyframes.append(dict(frame=i - args.first, stamp=frame.timestamp,
                                  index=i, pose=first_pose, slot=slot))
        else:
            if gt_poses is not None:
                if i - args.first >= len(gt_poses):
                    raise SystemExit(
                        f"pose file {args.pose_file} exhausted at frame {i} "
                        f"({len(gt_poses)} poses, consumed as pose[frame - "
                        f"{args.first}]); align --first/--last with the file")
                R_cur = jnp.asarray(gt_poses[i - args.first][0])
                t_cur = jnp.asarray(gt_poses[i - args.first][1])
                conv = True
            else:
                T.tic()
                # live map config: capacity/directory may grow mid-run
                res = tracker_mod.track_frame(
                    sdf_map.grid, depth, jnp.asarray(K), R_cur, t_cur,
                    sdf_map.cfg.grid, sdf_map.cfg.fusion, cfg.tracker,
                )
                T.toc("Point optimization")
                R_cur, t_cur = res.R, res.t
                conv = bool(res.converged)
            if conv:
                wants_kf = (
                    sharpness.sharp_detector(frame.color, sharp_thr)
                    or dist_to_last_kf > cfg.photo_ba.keyframe_gap
                )
                # visibility bitfield has max_recorded_keyframes slots (the
                # reference records per-frame visibility unboundedly,
                # MapGradPixelSdf.h:70); warn loudly when the cap bites so
                # long sequences aren't silently truncated
                is_kf = wants_kf and (
                    len(keyframes) < cfg.photo_ba.max_recorded_keyframes
                )
                if wants_kf and not is_kf:
                    suppressed_keyframes += 1
                    if suppressed_keyframes == 1:
                        print(
                            f"WARNING: keyframe slot cap "
                            f"({cfg.photo_ba.max_recorded_keyframes}) reached "
                            f"at frame {i}; later keyframes are not recorded "
                            f"(raise PhotoBAConfig.max_recorded_keyframes)"
                        )
                slot = len(keyframes) if is_kf else -1
                T.tic()
                sdf_map.update(depth, K, (R_cur, t_cur), kf_slot=slot)
                T.toc("Integrate depth data into Sdf")
                if is_kf:
                    dist_to_last_kf = 0
                    keyframes.append(dict(
                        frame=i - args.first, stamp=frame.timestamp,
                        index=i,
                        pose=(np.array(R_cur), np.array(t_cur)), slot=slot,
                    ))
                else:
                    dist_to_last_kf += 1
            else:
                invalid_frames.append(i - args.first)
        pose_entries.append((frame.timestamp, np.array(R_cur), np.array(t_cur)))

    tumio.write_trajectory(os.path.join(args.results, "_poses.txt"), pose_entries)

    # LR exports
    sdf_map.extract_mesh(os.path.join(args.results, "mesh_lr.ply"))
    sdf_map.extract_pc(os.path.join(args.results, "cloud_lr.ply"))

    # Phase 2: subsample keyframes, decode ONLY their images, run BA
    kfs = sample_keyframes(keyframes, cfg.photo_ba.max_keyframes)
    print(f"{len(kfs)} keyframes selected for BA")
    images = np.stack(
        [loader.load_color_at(k["index"]) for k in kfs]).astype(np.float32)
    poses = [k["pose"] for k in kfs]
    slots = [k["slot"] for k in kfs]
    if getattr(args, "ba_init_pose_file", None):
        loaded = loader.load_poses(args.ba_init_pose_file)
        if not loaded:
            raise SystemExit(f"cannot load {args.ba_init_pose_file}")
        init = {ts: (np.asarray(R, np.float32), np.asarray(t, np.float32))
                for ts, R, t in loaded}
        missing = [k["stamp"] for k in kfs if k["stamp"] not in init]
        if missing:
            raise SystemExit(
                f"--ba-init-pose-file lacks keyframe stamps {missing}")
        poses = [init[k["stamp"]] for k in kfs]
        print(f"BA initial poses overridden from {args.ba_init_pose_file}")

    gcfg_live = sdf_map.cfg.grid  # may have grown during phase 1
    problem, state = photo_ba.build_problem(
        sdf_map.grid, sdf_map.vis, slots, images, poses, K, gcfg_live
    )
    mesh = None
    if args.sharded_ba:
        from ..parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh()
    # the optimizer owns the pose snapshots at the reference's exact points
    # (before BA + every optimize() exit, PhotometricOptimizer.cpp:614,647,
    # 653,660) so an aborted BA still leaves the latest poses on disk
    opt = photo_ba.PhotometricOptimizer(
        problem, state, gcfg_live, cfg.photo_ba,
        coupled_poses=args.coupled_poses, mesh=mesh,
        save_path=args.results, key_stamps=[k["stamp"] for k in kfs],
    )
    T.tic()
    converged = opt.optimize()
    T.toc("Photometric BA")

    opt_poses = [
        (np.array(opt.state.R[i]), np.array(opt.state.t[i]))
        for i in range(len(kfs))
    ]
    sdf_map.grid = photo_ba.write_back_dist(
        sdf_map.grid, opt.problem, opt.state, gcfg_live
    )

    # Phase 3: color upsampling + HR exports
    T.tic()
    hr = color_upsampler.build_hr_voxels(sdf_map.grid, sdf_map.vis, slots,
                                         gcfg_live)
    hr = color_upsampler.compute_color(hr, images, opt_poses, K, gcfg_live)
    T.toc("Color upsampling")
    color_upsampler.extract_mesh_hr(
        hr, os.path.join(args.results, "coarse_BA_mesh_after_upsample.ply"),
        gcfg_live,
    )
    color_upsampler.extract_cloud(
        hr, os.path.join(args.results, "coarse_BA_cloud_after_upsample.ply"),
        gcfg_live,
    )

    metrics = {
        "keyframes": len(kfs),
        "invalid_frames": invalid_frames,
        "suppressed_keyframes": suppressed_keyframes,
        "ba_converged": bool(converged),
        "ba_energies": opt.energies,
        "timers": T.summary(),
    }
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    args = build_parser().parse_args(argv)
    compile_cache.enable()
    return run_photoba(args)


if __name__ == "__main__":
    main()
