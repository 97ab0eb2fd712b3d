"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: end-to-end Scan3D frame rate at EXACT parity settings on the
GOLDEN-PROTOCOL scene — the same protocol the reference binary's CPU
baseline is measured on by parity/run_golden_parity.py (640x480 synthetic
spheres seed 2, 6 frames over a 4-degree arc, vs=2 cm, trunc=5): DENSE
consecutive-frame tracking (sampling=1, the reference optimize() default,
RigidPointOptimizer.h:68-71 — frame i tracked from pose i-1, exactly what
the reference's per-frame timer measures) plus full fusion.
vs_measured_reference compares against the measured reference binary
(parity/last_report.json: non-OMP single thread, plus ref_cpu_fps_omp for
the OpenMP build); vs_baseline is fps / 30 (the BASELINE.md real-time
target).

Secondary fields: stride2_fps (--sampling 2, the ~2x-cheaper stride),
fast_fps (scan3d --fast), fusion Mvoxel-updates/s; raycast Mrays/s is
measured on the round-1/2 comparable scene (vs=1 cm, 16-pose orbit) so the
north-star numbers stay comparable across rounds.

Runs on a GPU only (`python bench.py` from the repo root; on the CPU it
refuses). Every phase is jitted and runs in this one process. A phase that
raises records its error in the JSON line, the remaining phases still run,
and the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def timeit(fn, args_list, iters=10, warmup=1):
    """Mean time per call of `iters` back-to-back calls with one block at
    the end (pipelined dispatch), cycling distinct argument sets."""
    for _ in range(warmup):
        out = fn(*args_list[0])
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(*args_list[i % len(args_list)])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


# Fallback when parity/last_report.json is absent: the reference binary
# measured by the golden parity harness on this container's CPU,
# 2026-08 (round 3), non-OMP single-thread build.
REF_CPU_FPS_FALLBACK = 17.0


def measured_reference_fps():
    """(fps_single_thread, fps_omp_or_None) from the parity artifact."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parity", "last_report.json")
    try:
        with open(path) as f:
            rep = json.load(f)
        # the BEST fps the reference achieved across harness runs (its
        # timings bounce ~±15% run-to-run) is the honest comparison bar
        return (float(rep.get("ref_cpu_fps_best",
                              rep.get("ref_cpu_fps", REF_CPU_FPS_FALLBACK))),
                rep.get("ref_cpu_fps_omp_best", rep.get("ref_cpu_fps_omp")))
    except (OSError, ValueError):
        return REF_CPU_FPS_FALLBACK, None


def main():
    import argparse
    import dataclasses

    import subprocess

    from gradient_sdf_tpu.utils import compile_cache

    ap = argparse.ArgumentParser("bench")
    ap.add_argument("--profile", default=None)
    opts, _ = ap.parse_known_args()

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        # a timing from another backend is not a device metric
        print(f"bench: no GPU (JAX's default device is {dev.platform})",
              file=sys.stderr)
        sys.exit(3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    from gradient_sdf_tpu.config import FusionConfig, GridConfig, TrackerConfig
    from gradient_sdf_tpu.data import synth
    from gradient_sdf_tpu.models import tracker
    from gradient_sdf_tpu.ops import fusion, normals, raycast
    from gradient_sdf_tpu.ops import voxel_grid as vg

    W, H = 640, 480
    K = synth.KINECT_K
    cache = normals.build_cache(W, H, K, window=11)

    result = {
        "metric": "scan3d_dense_fps_640x480",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": card},
    }

    # ---- Phase A: golden-protocol track+fuse ------------------------------
    gcfg = GridConfig(voxel_size=0.02, num_blocks=1024)
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = synth.random_spheres(seed=2)
    poses = synth.orbit_poses(n=6, radius=2.0, arc=np.deg2rad(4.0))

    render_jit = jax.jit(
        lambda R, t: synth.render_depth(world, R, t, K, W, H)
    )
    fuse_jit = jax.jit(
        lambda g, d, R, t: fusion.fuse_frame(g, d, cache, R, t, gcfg, fcfg)
    )

    try:
        log("compiling renderer + fusion...")
        t0 = time.time()
        grid = vg.create(gcfg)
        frames = []
        for i in range(6):
            R, t = (jnp.asarray(poses[i][0]), jnp.asarray(poses[i][1]))
            d = render_jit(R, t)
            frames.append((d, R, t))
            grid = fuse_jit(grid, d, R, t)
        jax.block_until_ready(grid.dist)
        log(f"map built ({time.time()-t0:.0f}s incl. compiles), "
            f"{int(grid.num_active)} blocks, overflow={bool(grid.overflow)}")

        fargs = [(grid, d, R, t) for d, R, t in frames[2:6]]
        if opts.profile:
            with jax.profiler.trace(opts.profile):
                jax.block_until_ready(fuse_jit(*fargs[0]).dist)
        fuse_s = timeit(fuse_jit, fargs, iters=12)
        voxel_updates = W * H * (2 * int(fcfg.trunc_voxels) + 1)
        result["fusion_mvoxel_updates_per_s"] = round(
            voxel_updates / fuse_s / 1e6, 2)
        result["fuse_ms"] = round(fuse_s * 1e3, 2)
    except Exception as e:  # pragma: no cover
        result["fusion_error"] = repr(e)[:200]
        print(json.dumps(result))
        sys.exit(1)

    # consecutive-frame tracking: frame i's depth from pose i-1 — the same
    # situation the reference binary's "Point optimization" timer measures
    targs = []
    for i in range(1, 6):
        d, _, _ = frames[i]
        _, Rp, tp = frames[i - 1]
        targs.append((grid, d, Rp, tp))

    # GN-buffer cap sized to the scene like scan3d does at its first frame
    cap = tracker.adaptive_compact_cap(np.asarray(frames[1][0]), fcfg)
    result["track_compact_cap"] = cap

    def track_cfg(s):
        return jax.jit(
            lambda g, d, R, t: tracker.track_frame(
                g, d, jnp.asarray(K), R, t, gcfg, fcfg,
                TrackerConfig(sampling=s, compact_cap_frac=cap)
            )
        )

    try:
        log("compiling dense tracker...")
        track_jit = track_cfg(1)
        track_s = timeit(track_jit, targs, iters=10)
        res0 = track_jit(*targs[2])
        result["track_ms"] = round(track_s * 1e3, 2)
        result["track_converged"] = bool(res0.converged)
        result["track_iters"] = int(res0.num_iters)

        # WARM-started dense tracking — OPT-IN (scan3d --warm-start;
        # damped alpha=0.5). NOT the headline: full constant-velocity
        # extrapolation destabilized the 150-frame loop protocol
        # (models/tracker.extrapolate_pose), so the parity default stays
        # the reference's previous-pose init.
        warm_jit = jax.jit(
            lambda g, d, R1, t1, R2, t2: tracker.track_frame(
                g, d, jnp.asarray(K),
                *tracker.extrapolate_pose(R1, t1, R2, t2, 0.5),
                gcfg, fcfg,
                TrackerConfig(sampling=1, compact_cap_frac=cap)))
        wargs = []
        for i in range(2, 6):
            d, _, _ = frames[i]
            _, R1, t1 = frames[i - 1]
            _, R2, t2 = frames[i - 2]
            wargs.append((grid, d, R1, t1, R2, t2))
        log("compiling warm-start tracker...")
        track_w = timeit(warm_jit, wargs, iters=10)
        resw = warm_jit(*wargs[1])
        result["track_warm_ms"] = round(track_w * 1e3, 2)
        result["track_warm_converged"] = bool(resw.converged)
        result["track_warm_iters"] = int(resw.num_iters)

        # headline = the scan3d parity default: previous-pose init
        frame_s = track_s + fuse_s
        result["value"] = round(1.0 / frame_s, 3)
        result["vs_baseline"] = round(1.0 / frame_s / 30.0, 3)
        result["warm_fps"] = round(1.0 / (track_w + fuse_s), 3)
        ref_fps, ref_fps_omp = measured_reference_fps()
        result["ref_cpu_fps_measured"] = ref_fps
        result["vs_measured_reference"] = round(1.0 / frame_s / ref_fps, 3)
        if ref_fps_omp:
            result["ref_cpu_fps_omp"] = ref_fps_omp
            result["vs_measured_reference_omp"] = round(
                1.0 / frame_s / ref_fps_omp, 3)

        log("compiling stride-2 tracker...")
        track_s2_jit = track_cfg(2)
        track_s2 = timeit(track_s2_jit, targs, iters=10)
        result["stride2_track_ms"] = round(track_s2 * 1e3, 2)
        result["stride2_fps"] = round(1.0 / (track_s2 + fuse_s), 3)
    except Exception as e:  # pragma: no cover
        result["track_error"] = repr(e)[:200]

    try:
        # the REAL app loop: EXACTLY what scan3d runs per frame by default —
        # one merged warm-started track+fuse program, then ONE packed
        # host fetch of the (converged, overflow, oob) decision scalars
        log("compiling merged step...")

        def merged_fn(g, d, R, t, Rpp, tpp):
            del Rpp, tpp  # parity default: previous-pose init
            new_g, res = tracker.track_and_fuse_frame(
                g, d, jnp.asarray(K), R, t, cache, gcfg, fcfg,
                TrackerConfig(sampling=1, compact_cap_frac=cap))
            flags = jnp.stack([
                res.converged.astype(jnp.int32),
                new_g.overflow.astype(jnp.int32),
                (new_g.oob_samples > 0).astype(jnp.int32)])
            return new_g, res, flags

        merged = jax.jit(merged_fn)
        g2, _, _ = merged(grid, frames[1][0], frames[0][1], frames[0][2],
                          frames[0][1], frames[0][2])
        jax.block_until_ready(g2.dist)

        # host copies: the loop below pays the real app's per-frame
        # host->device depth upload (the native prefetcher hands scan3d
        # decoded numpy frames; decode IO overlaps and is not device time)
        frames_np = [np.asarray(d) for d, _, _ in frames]

        def app_loop(lagged):
            # mirrors the scan3d loop: lagged=True is the default (frame
            # i's flags resolve on the host after frame i+1 is dispatched;
            # frame i+1's depth upload is dispatched behind frame i's
            # compute; poses stay device arrays until the teardown drain,
            # outside the per-frame budget like scan3d's). lagged=False is
            # --sync-growth-checks.
            g = grid
            R, t = frames[0][1], frames[0][2]
            Rpp, tpp = R, t
            pending = None
            poses = []
            t0 = time.perf_counter()
            dev_depth = jnp.asarray(frames_np[1])
            for i in range(1, 6):
                g, res, flags = merged(g, dev_depth, R, t, Rpp, tpp)
                if i + 1 < 6:
                    dev_depth = jnp.asarray(frames_np[i + 1])
                if lagged:
                    if pending is not None:
                        assert np.asarray(pending)[0] >= 0
                    pending = flags
                else:
                    assert np.asarray(flags)[0] >= 0
                Rpp, tpp = R, t
                R, t = res.R, res.t
                poses.append((res.R, res.t))
            if pending is not None:
                np.asarray(pending)
            jax.block_until_ready(g.dist)
            dt = (time.perf_counter() - t0) / 5
            # scan3d.drain_poses equivalent: two batched transfers at
            # TEARDOWN (once per run, not per frame) — kept outside the
            # per-frame figure but still executed for fidelity
            np.asarray(jnp.stack([p[0] for p in poses]))
            np.asarray(jnp.stack([p[1] for p in poses]))
            return dt

        app_s = min(app_loop(True) for _ in range(3))
        result["app_loop_ms_per_frame"] = round(app_s * 1e3, 2)
        result["app_loop_fps"] = round(1.0 / app_s, 3)
        app_sync = min(app_loop(False) for _ in range(3))
        result["app_loop_sync_fps"] = round(1.0 / app_sync, 3)
    except Exception as e:  # pragma: no cover
        result["app_loop_error"] = repr(e)[:200]

    try:
        # fast mode: stride-2 fusion + stride-3 tracking (scan3d --fast)
        fcfg_fast = dataclasses.replace(fcfg, fusion_stride=2)
        log("compiling fast-mode fusion...")
        fuse_fast = jax.jit(
            lambda g, d, R, t: fusion.fuse_frame(g, d, cache, R, t, gcfg,
                                                 fcfg_fast)
        )
        fuse_fast_s = timeit(fuse_fast, fargs, iters=12)
        result["fast_fuse_ms"] = round(fuse_fast_s * 1e3, 2)
        log("compiling fast-mode tracker...")
        track_fast = track_cfg(3)
        track_fast_s = timeit(track_fast, targs, iters=10)
        result["fast_track_ms"] = round(track_fast_s * 1e3, 2)
        result["fast_fps"] = round(1.0 / (fuse_fast_s + track_fast_s), 3)
        result["fast_vs_measured_reference"] = round(
            1.0 / (fuse_fast_s + track_fast_s)
            / measured_reference_fps()[0], 3)
    except Exception as e:  # pragma: no cover
        result["fast_error"] = repr(e)[:200]

    # ---- Phase B: raycast north star (round-1/2 comparable scene) ---------
    try:
        gcfg_rc = GridConfig(voxel_size=0.01, num_blocks=2**15)
        world_rc = synth.random_spheres(seed=3)
        poses_rc = synth.orbit_poses(n=16, radius=2.0)
        log("building raycast scene (vs=1 cm)...")
        fuse_rc = jax.jit(
            lambda g, d, R, t: fusion.fuse_frame(g, d, cache, R, t,
                                                 gcfg_rc, fcfg)
        )
        render_rc = jax.jit(
            lambda R, t: synth.render_depth(world_rc, R, t, K, W, H))
        grid_rc = vg.create(gcfg_rc)
        for i in range(6):
            R, t = (jnp.asarray(poses_rc[i][0]), jnp.asarray(poses_rc[i][1]))
            grid_rc = fuse_rc(grid_rc, render_rc(R, t), R, t)
        jax.block_until_ready(grid_rc.dist)
        R4, t4 = (jnp.asarray(poses_rc[4][0]), jnp.asarray(poses_rc[4][1]))

        log("compiling raycaster...")
        rc_jit = jax.jit(
            lambda g, R, t: raycast.render_depth_normal(
                g, jnp.asarray(K), R, t, W, H, gcfg_rc, fcfg, s_max=3.5
            )
        )
        rc_s = timeit(rc_jit, [(grid_rc, R4, t4)], iters=5)
        result["raycast_mrays_per_s"] = round(W * H / rc_s / 1e6, 3)

        # incremental frame-to-model rendering: previous frame's depth as
        # the march prior, prior holes skipped, 4-voxel window margin
        d_prev, _, _ = rc_jit(grid_rc, R4, t4)
        rci_jit = jax.jit(
            lambda g, R, t, dp: raycast.render_depth_normal(
                g, jnp.asarray(K), R, t, W, H, gcfg_rc, fcfg, s_max=3.5,
                depth_prior=dp, depth_prior_holes="skip",
                prior_margin_voxels=4.0,
            )
        )
        rci_s = timeit(rci_jit, [(grid_rc, R4, t4, d_prev)], iters=5)
        result["raycast_incremental_mrays_per_s"] = round(
            W * H / rci_s / 1e6, 3)
    except Exception as e:  # pragma: no cover
        result["raycast_error"] = repr(e)[:200]

    # ---- Phase C: PhotoBA iteration at scale (F=30 keyframes x V=100k
    # surface voxels, VGA images): one alternation = solvePose + energy +
    # solveDist + energy, exactly PhotometricOptimizer.optimize's loop ----
    try:
        from gradient_sdf_tpu.config import PhotoBAConfig
        from gradient_sdf_tpu.models import photo_ba

        rng = np.random.RandomState(11)
        F, V = 30, 100 * 1024
        vox = rng.randint(-60, 60, size=(V, 3)).astype(np.int32)
        g = rng.randn(V, 3).astype(np.float32)
        problem = photo_ba.BAProblem(
            vox=jnp.asarray(vox),
            grad=jnp.asarray(g),
            weight=jnp.asarray(rng.uniform(1, 20, V).astype(np.float32)),
            vmask=jnp.ones((V,), bool),
            vis=jnp.asarray(rng.rand(V, F) < 0.4),
            images=jnp.asarray(
                rng.rand(F, H, W, 3).astype(np.float32)),
            K=jnp.asarray(K),
        )
        state = photo_ba.BAState(
            dist=jnp.asarray(
                rng.uniform(-0.005, 0.005, V).astype(np.float32)),
            R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (F, 1, 1)),
            t=jnp.asarray(rng.uniform(-0.1, 0.1, (F, 3)).astype(np.float32)),
        )
        pcfg = PhotoBAConfig()
        gcfg_ba = GridConfig(voxel_size=0.01)

        def ba_iter(p, s):
            s = photo_ba.solve_pose(p, s, gcfg_ba, pcfg)
            e1 = photo_ba.energy(p, s, gcfg_ba)
            s = photo_ba.solve_dist(p, s, gcfg_ba, pcfg)
            e2 = photo_ba.energy(p, s, gcfg_ba)
            return s, e1, e2

        log("compiling BA iteration (F=30 x V=100k)...")
        ba_jit = jax.jit(ba_iter)
        ba_s = timeit(ba_jit, [(problem, state)], iters=4)
        result["ba_iteration_ms_f30_v100k"] = round(ba_s * 1e3, 2)
    except Exception as e:  # pragma: no cover
        result["ba_error"] = repr(e)[:200]

    print(json.dumps(result))
    if any(k.endswith("_error") for k in result):
        sys.exit(1)


if __name__ == "__main__":
    main()
