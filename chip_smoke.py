"""On-card smoke test: the main path end to end on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py               # phases 0-5 on one GPU
    python chip_smoke.py --four-cards  # only the 4-GPU sharded path

Everything runs in this one process: a JAX process reserves most of the
card's memory, so no second JAX process is ever started. The apps are driven
through their own entry points (`make_synth.main`, `scan3d`'s parser and
`reconstruct`, `photoba.main`).

Phases (one line each with its result, wall and compile seconds):

  0 device   -- a GPU must be JAX's default device; reports the card, the
                JAX version and whether the native host library loaded.
  1 data     -- seeded synthetic handheld-style sequence: 640x480 Kinect
                depth with Kinect noise, 30 frames, seed 2 (TUM fr1 shape).
  2 scan3d   -- default dense tracking + fusion at 1 cm voxels, trunc 5,
                the default 2^14-block grid. Gates below.
  3 scan3d --merged-step -- the one-program-per-frame path, same gates.
  4 numerics -- on-card results against the plain reference: the same
                jitted functions run on the host CPU in this process.
  5 photoba  -- photometric BA + colour upsampling on the phase-1 data.

Any failed phase makes the script exit non-zero. The last line of standard
output is one JSON object; {"ok": true, ...} only when every phase passed.
Without a GPU, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# ---- the run -----------------------------------------------------------------
WIDTH, HEIGHT = 640, 480   # VGA, the Kinect / TUM RGB-D sensor resolution
N_FRAMES = 30
SEED = 2
ARC_DEG = 30.0             # total orbit: 1 degree of rotation per frame
VOXEL = 0.01               # scan3d's default --voxel-size
TRUNC = 5.0                # --trunc, in voxels

# ---- gates and tolerances, each with its reason ------------------------------
# scan3d rejects (does not fuse) frames whose Gauss-Newton step does not fall
# below 1e-3; on noisy data a few may sit on that floor, most must not.
MAX_INVALID_FRAC = 0.10
# ATE RMSE bound in voxels: the drift bound tests/test_long_sequence.py holds
# on the CPU for a noisy orbit.
ATE_VOXELS = 1.5
# Fusion accumulation, GPU vs CPU, fed IDENTICAL samples: GPU scatter-adds
# are atomic, so only the float32 summation order differs. A sum of n
# positive weights moves by ~n*eps relative; the weighted-mean distance by
# ~eps * T. Gradient sums are signed (w * n, |n| <= 1): reordering moves
# them by at most ~n*eps*sum|w n| <= ~n*eps*weight, so their absolute part
# scales with the voxel's own weight.
WEIGHT_RTOL = 1e-5
DIST_ATOL = 1e-5           # metres
GRAD_RTOL = 1e-4
GRAD_ATOL_PER_WEIGHT = 1e-5
# fuse_frame end to end, GPU vs CPU, same depth and poses. The samples
# themselves differ in the last bits: FALS normals solve a 3x3 system whose
# condition number is ~4e4 at VGA with the 11-pixel window, so float32
# normals carry up to ~2e-3 error against float64 on either device, and the
# gradient sums w * n agree to that times the weight. Weight ramps
# (1 - sdf / T) round differently with and without fused multiply-add:
# ~1e-6 per sample, <= ~1e-4 per voxel. Last-bit differences also flip a
# few discrete decisions (a pixel gate at its threshold, a sample on a
# half-voxel boundary), which moves whole samples between voxels: those
# voxels may differ by any amount, and must stay a small fraction.
E2E_WEIGHT_ATOL = 1e-4
E2E_GRAD_ATOL_PER_WEIGHT = 5e-3
MAX_FLIPPED_FRAC = 1e-2
# Same-map tracking, GPU vs CPU, same initial pose: the bound
# __graft_entry__.dryrun_multichip holds for sharded vs single-device GN.
POSE_TOL = 5e-4
# One BA iteration, GPU vs CPU: energies are float32 sums over ~10^6
# (voxel, frame) terms taken in another order.
ENERGY_RTOL = 1e-3
# Raycast of the scan3d map against the analytic render at the same camera:
# the median depth error over pixels both hit stays below one voxel.
RAYCAST_MEDIAN_VOXELS = 1.0
# Four cards: fields of the sharded fusion vs one device (reduce-scatter
# reorders the sums), the bound __graft_entry__.dryrun_multichip holds.
SHARDED_FIELD_ATOL = 1e-3
WARMUP_FRAMES = 3          # frames that compile, left out of the median


class GateError(AssertionError):
    """A phase ran but its result is outside a stated gate."""


def check(failures):
    if failures:
        raise GateError("; ".join(failures))


def gpu_info() -> str:
    """`nvidia-smi` name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


class Phases:
    """Runs phases, prints one result line each, remembers failures."""

    def __init__(self):
        import jax

        self.failed = []
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration

    def run(self, name, fn, *args, **kwargs):
        c0, t0 = self.compile_s, time.perf_counter()
        try:
            out, ok = fn(*args, **kwargs), True
        except Exception:  # the boundary: report, keep going, fail at exit
            traceback.print_exc()
            out, ok = None, False
            self.failed.append(name)
        print(f"phase {name}: {'ok' if ok else 'FAILED'} "
              f"wall_s={time.perf_counter() - t0:.1f} "
              f"compile_s={self.compile_s - c0:.1f}", flush=True)
        return out


# ---- phase bodies (also called directly by tests at tiny sizes) -------------

def make_data(out_dir, width=WIDTH, height=HEIGHT, frames=N_FRAMES,
              seed=SEED, arc_deg=ARC_DEG, noise=True):
    """Phase 1: the seeded synthetic sequence, through make_synth's CLI."""
    from gradient_sdf_tpu.apps import make_synth

    argv = ["--out", out_dir, "--frames", str(frames), "--seed", str(seed),
            "--width", str(width), "--height", str(height),
            "--arc-deg", str(arc_deg)]
    if not noise:
        argv.append("--no-noise")
    make_synth.main(argv)
    return out_dir


def run_scan3d(data_dir, out_dir, voxel=VOXEL, extra=()):
    """scan3d on `data_dir` through its own parser; returns (metrics, map).
    No --pose-file exists in the data, so tracking really runs; the GT file
    serves only the ATE evaluation."""
    from gradient_sdf_tpu.apps import scan3d

    argv = ["--input", data_dir, "--results", out_dir,
            "--data-type", "synth", "--voxel-size", str(voxel),
            "--trunc", str(TRUNC), "--eval-gt", "gt_poses.txt",
            "--metrics-json", os.path.join(out_dir, "metrics.json"),
            *extra]
    return scan3d.reconstruct(scan3d.build_parser().parse_args(argv))


def ply_vertices(path, need_color=False) -> int:
    from gradient_sdf_tpu.utils.ply import load_ply

    ply = load_ply(path)
    v = ply["vertex"]
    if need_color and "red" not in (v.dtype.names or ()):
        raise GateError(f"{path}: no vertex colour")
    return len(v)


def scan_failures(metrics, out_dir, voxel=VOXEL):
    """The phase-2/3 gates; returns the failed ones as text."""
    fails = []
    if metrics["overflow"]:
        fails.append("grid overflowed")
    if metrics["num_blocks_active"] <= 0:
        fails.append("no active blocks")
    n_bad = len(metrics["invalid_frames"])
    if n_bad > MAX_INVALID_FRAC * metrics["frames"]:
        fails.append(f"{n_bad}/{metrics['frames']} frames rejected")
    ate = metrics.get("ate_rmse")
    if ate is None or not ate <= ATE_VOXELS * voxel:
        fails.append(f"ATE {ate} m > {ATE_VOXELS} voxels")
    for name in ("gradient_sdf_mesh_final.ply",
                 "gradient_sdf_cloud_final.ply"):
        try:
            if ply_vertices(os.path.join(out_dir, name)) == 0:
                fails.append(f"{name} is empty")
        except (OSError, ValueError, KeyError, StopIteration) as e:
            fails.append(f"{name} does not parse: {e!r}")
    return fails


def steady_ms_per_frame(metrics) -> float:
    walls = metrics["frame_wall_s"][WARMUP_FRAMES:] or metrics["frame_wall_s"]
    return float(np.median(walls) * 1e3)


def scan_phase(label, data_dir, out_dir, card, voxel=VOXEL, extra=()):
    """Phases 2 and 3: run scan3d, print its numbers, apply the gates."""
    import jax

    metrics, sdf_map = run_scan3d(data_dir, out_dir, voxel, extra)
    print(f"{label}: frames={metrics['frames']} "
          f"invalid={metrics['invalid_frames']} "
          f"active_blocks={metrics['num_blocks_active']} "
          f"overflow={metrics['overflow']} ate_rmse_m={metrics.get('ate_rmse')}")
    print(f"{label}: steady-state median "
          f"{steady_ms_per_frame(metrics):.2f} ms/frame (frames "
          f"{WARMUP_FRAMES}+, host clock) on {card}")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"{label}: peak_bytes_in_use={stats['peak_bytes_in_use']}")
    check(scan_failures(metrics, out_dir, voxel))
    return metrics, sdf_map


# ---- phase 4: on-card numerics vs the host CPU ------------------------------

def load_frames(data_dir, n):
    """First n depth frames (metres), GT poses and K of a make_synth dir."""
    from gradient_sdf_tpu.data import loaders

    loader = loaders.make_loader("synth", data_dir)
    K = loader.load_intrinsics("intrinsics.txt")
    gt = loader.load_poses("gt_poses.txt")
    depths = [f.depth for f in loader.frames(0, n)]
    poses = [(np.asarray(R, np.float32), np.asarray(t, np.float32))
             for _, R, t in gt]
    return depths, poses, K


def fuse_on(dev, depths, poses, K, gcfg, fcfg, fuse):
    """Fuse `depths` at `poses` into a fresh grid, all on device `dev`."""
    import jax

    from gradient_sdf_tpu.ops import normals
    from gradient_sdf_tpu.ops import voxel_grid as vg

    h, w = depths[0].shape
    put = lambda x: jax.device_put(x, dev)  # noqa: E731
    with jax.default_device(dev):
        cache = put(normals.build_cache(w, h, K, fcfg.normal_window))
        g = put(vg.create(gcfg))
        for d, (R, t) in zip(depths, poses):
            g = fuse(g, put(d), cache, put(R), put(t))
        jax.block_until_ready(g)
    return g, cache


def _field_diffs(a, b):
    """Per-voxel |a - b| of weight, dist and gradient (host arrays), the
    reference's weight and gradient, and the voxels either grid observed."""
    wa, wb = np.asarray(a.weight), np.asarray(b.weight)
    seen = (wa > 0) | (wb > 0)
    d_w = np.abs(wa - wb)
    d_d = np.where(seen, np.abs(np.asarray(a.dist) - np.asarray(b.dist)), 0)
    d_g = np.abs(np.asarray(a.grad) - np.asarray(b.grad))
    stats = {"voxels_seen": int(seen.sum()),
             "max_abs_weight": float(d_w.max()),
             "max_abs_dist_m": float(d_d.max()),
             "max_abs_grad": float(d_g.max())}
    return d_w, d_d, d_g, wb, np.abs(np.asarray(b.grad)), seen, stats


def field_failures(a, b):
    """Accumulation gates between grid `a` (under test) and reference `b`
    built from identical samples: every voxel within the reorder bounds."""
    if int(a.num_active) != int(b.num_active):
        return [f"num_active {int(a.num_active)} vs {int(b.num_active)}"], {}
    d_w, d_d, d_g, wb, gb, _, stats = _field_diffs(a, b)
    g_lim = GRAD_RTOL * gb + GRAD_ATOL_PER_WEIGHT * wb[..., None]
    fails = []
    for what, n in (("weight", int(np.sum(d_w > WEIGHT_RTOL * wb))),
                    ("dist", int(np.sum(d_d > DIST_ATOL))),
                    ("grad", int(np.sum(np.any(d_g > g_lim, axis=-1))))):
        if n:
            fails.append(f"{n} voxels outside the {what} tolerance")
    return fails, stats


def fusion_e2e_failures(a, b):
    """End-to-end fuse_frame gates between `a` and reference `b`: equal
    block count, and all but MAX_FLIPPED_FRAC of the observed voxels within
    the float32 bounds (the rest received a different set of samples)."""
    if int(a.num_active) != int(b.num_active):
        return [f"num_active {int(a.num_active)} vs {int(b.num_active)}"], {}
    d_w, d_d, d_g, wb, gb, seen, stats = _field_diffs(a, b)
    g_lim = GRAD_RTOL * gb + E2E_GRAD_ATOL_PER_WEIGHT * wb[..., None]
    off = ((d_w > E2E_WEIGHT_ATOL) | (d_d > DIST_ATOL)
           | np.any(d_g > g_lim, axis=-1)) & seen
    stats["voxels_flipped"] = int(off.sum())
    frac = off.sum() / max(int(seen.sum()), 1)
    if not frac <= MAX_FLIPPED_FRAC:
        return [f"{int(off.sum())} of {int(seen.sum())} observed voxels "
                f"differ beyond the float32 bounds"], stats
    return [], stats


def pose_diff(Ra, ta, Rb, tb):
    return (float(np.max(np.abs(np.asarray(Ra) - np.asarray(Rb)))),
            float(np.max(np.abs(np.asarray(ta) - np.asarray(tb)))))


def ba_test_problem(F, V, width, height, K, seed=11):
    """A PhotoBA problem with real geometry: V surface voxels 1-2 m in front
    of F cameras near the origin, smooth random textures, 40% visibility."""
    from scipy import ndimage
    from scipy.spatial.transform import Rotation

    from gradient_sdf_tpu.models import photo_ba

    rng = np.random.RandomState(seed)
    vox = np.stack([rng.randint(-40, 40, V), rng.randint(-30, 30, V),
                    rng.randint(100, 200, V)], -1).astype(np.int32)
    grad = (np.array([0.0, 0.0, -1.0]) + 0.3 * rng.randn(V, 3))
    ch, cw = height // 16, width // 16
    coarse = rng.rand(F, ch, cw, 3)
    images = ndimage.zoom(coarse, (1, height / ch, width / cw, 1), order=1)
    R = Rotation.from_rotvec(0.02 * rng.randn(F, 3)).as_matrix()
    problem = photo_ba.BAProblem(
        vox=vox, grad=grad.astype(np.float32),
        weight=rng.uniform(1, 20, V).astype(np.float32),
        vmask=np.ones((V,), bool), vis=rng.rand(V, F) < 0.4,
        images=images.astype(np.float32), K=np.asarray(K, np.float32))
    state = photo_ba.BAState(
        dist=rng.uniform(-0.005, 0.005, V).astype(np.float32),
        R=R.astype(np.float32),
        t=rng.uniform(-0.05, 0.05, (F, 3)).astype(np.float32))
    return problem, state


def ba_iteration(gcfg):
    """One BA alternation as photoba runs it: solvePose, energy, solveDist,
    energy (PhotometricOptimizer._iteration)."""
    import jax

    from gradient_sdf_tpu.config import PhotoBAConfig
    from gradient_sdf_tpu.models import photo_ba

    pcfg = PhotoBAConfig()

    def step(p, s):
        s = photo_ba.solve_pose(p, s, gcfg, pcfg)
        e1 = photo_ba.energy(p, s, gcfg)
        s = photo_ba.solve_dist(p, s, gcfg, pcfg)
        return s, e1, photo_ba.energy(p, s, gcfg)

    return jax.jit(step)


def rel_diff(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def median_ms(fn, args, reps=10):
    """Median host-clock time of `reps` calls, each ending in a block."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def numerics_phase(data_dir, scan_map, card, *, n_fuse=3, ba_F=30,
                   ba_V=100 * 1024, voxel=VOXEL, cpu=None, dev=None):
    """Phase 4: fusion, tracking and one BA iteration on the card against
    the same jitted functions on the host CPU; the raycast of the scan3d
    map against the analytic render. Returns the measured numbers."""
    import jax
    import jax.numpy as jnp
    from gradient_sdf_tpu.config import (FusionConfig, GridConfig,
                                         TrackerConfig)
    from gradient_sdf_tpu.data import synth
    from gradient_sdf_tpu.models import tracker
    from gradient_sdf_tpu.ops import fusion, normals, raycast
    from gradient_sdf_tpu.ops import voxel_grid as vg

    dev = dev or jax.devices()[0]
    cpu = cpu or jax.devices("cpu")[0]
    out, fails = {}, []
    depths, poses, K = load_frames(data_dir, n_fuse + 1)
    h, w = depths[0].shape
    gcfg = GridConfig(voxel_size=voxel)
    fcfg = FusionConfig(trunc_voxels=TRUNC)

    # -- fusion (a): the accumulation alone, on identical samples --------
    # samples made once on the CPU; block claims, scatter-adds and the
    # merge then run on each device
    sample = jax.jit(lambda d, c, R, t: fusion._sample_frame(
        d, normals.compute_normals(c, d), c, R, t, gcfg, fcfg))
    integrate = jax.jit(lambda g, s: fusion._integrate_samples(
        g, s, gcfg, True, None, None)[0])
    with jax.default_device(cpu):
        c_cpu = jax.device_put(
            normals.build_cache(w, h, K, fcfg.normal_window), cpu)
        samples = [sample(*jax.device_put((d, c_cpu, R, t), cpu))
                   for d, (R, t) in zip(depths[:n_fuse], poses)]
    acc = {}
    for where in (dev, cpu):
        with jax.default_device(where):
            g = jax.device_put(vg.create(gcfg), where)
            for s_ in samples:
                g = integrate(g, jax.device_put(s_, where))
            acc[where] = g
    f_fails, stats = field_failures(acc[dev], acc[cpu])
    fails += [f"fusion accumulation: {m}" for m in f_fails]
    out["fusion_accumulation"] = stats
    out["accumulate_ms"] = median_ms(
        integrate, (acc[dev], jax.device_put(samples[-1], dev)))
    print(f"numerics fusion accumulation (GPU vs CPU, identical samples of "
          f"{n_fuse} frames {w}x{h}): {stats}; block claims + scatter-adds "
          f"+ merge of one uncompacted frame {out['accumulate_ms']:.2f} ms "
          f"median on {card}")

    # -- fusion (b): fuse_frame end to end at GT poses --------------------
    fuse = jax.jit(lambda g, d, c, R, t: fusion.fuse_frame(
        g, d, c, R, t, gcfg, fcfg))
    g_dev, cache = fuse_on(dev, depths[:n_fuse], poses, K, gcfg, fcfg, fuse)
    g_cpu, _ = fuse_on(cpu, depths[:n_fuse], poses, K, gcfg, fcfg, fuse)
    f_fails, stats = fusion_e2e_failures(g_dev, g_cpu)
    fails += [f"fuse_frame: {m}" for m in f_fails]
    out["fusion"] = stats
    R2, t2 = (jax.device_put(x, dev) for x in poses[n_fuse - 1])
    out["fuse_ms"] = median_ms(
        fuse, (g_dev, jax.device_put(depths[n_fuse - 1], dev), cache, R2, t2))
    print(f"numerics fuse_frame (GPU vs CPU, {n_fuse} frames {w}x{h}): "
          f"{stats}; fuse_frame {out['fuse_ms']:.2f} ms median on {card}")

    # -- tracking: next frame on the SAME map, same initial pose --------
    cap = tracker.adaptive_compact_cap(depths[n_fuse], fcfg)
    tcfg = TrackerConfig(compact_cap_frac=cap)
    track = jax.jit(lambda g, d, K_, R, t: tracker.track_frame(
        g, d, K_, R, t, gcfg, fcfg, tcfg))
    args = (depths[n_fuse], np.asarray(K), *poses[n_fuse - 1])
    r_dev = track(g_dev, *(jax.device_put(a, dev) for a in args))
    g_host = jax.device_put(g_dev, cpu)
    with jax.default_device(cpu):
        r_cpu = track(g_host, *(jax.device_put(a, cpu) for a in args))
    d_R, d_t = pose_diff(r_dev.R, r_dev.t, r_cpu.R, r_cpu.t)
    out["track"] = {"dR": d_R, "dt": d_t,
                    "iters": (int(r_dev.num_iters), int(r_cpu.num_iters)),
                    "converged": (bool(r_dev.converged),
                                  bool(r_cpu.converged))}
    print(f"numerics tracking (GPU vs CPU, same map): {out['track']}")
    if not (d_R < POSE_TOL and d_t < POSE_TOL):
        fails.append(f"tracking: |dR|={d_R:.2e} |dt|={d_t:.2e} "
                     f">= {POSE_TOL}")

    # -- one PhotoBA iteration at F x V ---------------------------------
    problem, state = ba_test_problem(ba_F, ba_V, w, h, K)
    step = ba_iteration(gcfg)
    p_dev, s_dev = jax.device_put((problem, state), dev)
    _, e1_d, e2_d = step(p_dev, s_dev)
    with jax.default_device(cpu):
        _, e1_c, e2_c = step(*jax.device_put((problem, state), cpu))
    out["ba"] = {"e_pose": (float(e1_d), float(e1_c)),
                 "e_dist": (float(e2_d), float(e2_c)),
                 "ms": median_ms(step, (p_dev, s_dev), reps=3)}
    print(f"numerics BA iteration (F={ba_F} x V={ba_V}, GPU vs CPU): "
          f"{out['ba']} on {card}")
    for a, b, what in ((e1_d, e1_c, "pose"), (e2_d, e2_c, "dist")):
        if not rel_diff(a, b) < ENERGY_RTOL:
            fails.append(f"BA energy after {what} step {float(a)} vs "
                         f"{float(b)}")

    # -- raycast of the scan3d map vs the analytic render ---------------
    if scan_map is not None:
        # the last fused frame, at the pose scan3d tracked (map frame)
        sdf_map, est_poses, invalid = scan_map
        i = max(j for j in range(len(est_poses)) if j not in invalid)
        R_est, t_est = (jnp.asarray(x, jnp.float32) for x in est_poses[i][1:])
        mcfg = sdf_map.cfg
        render = jax.jit(lambda g, R, t: raycast.render_depth_normal(
            g, jnp.asarray(K), R, t, w, h, mcfg.grid, mcfg.fusion,
            s_max=3.5))
        d_map, _, hit = render(sdf_map.grid, R_est, t_est)
        spheres = np.loadtxt(os.path.join(data_dir, "spheres.txt"))
        world = synth.SphereWorld(
            centers=jnp.asarray(spheres[:, :3], jnp.float32),
            radii=jnp.asarray(spheres[:, 3], jnp.float32))
        d_gt = synth.render_depth(world, *(jnp.asarray(x) for x in poses[i]),
                                  K, w, h)
        both = np.asarray(hit) & (np.asarray(d_gt) > 0)
        err = np.abs(np.asarray(d_map) - np.asarray(d_gt))[both]
        med = float(np.median(err)) if err.size else float("inf")
        out["raycast"] = {"pixels_both_hit": int(both.sum()),
                          "gt_pixels": int((np.asarray(d_gt) > 0).sum()),
                          "median_abs_err_m": med,
                          "ms": median_ms(render,
                                          (sdf_map.grid, R_est, t_est), 3)}
        print(f"numerics raycast (frame {i}, scan3d map vs analytic): "
              f"{out['raycast']} on {card}")
        if not med < RAYCAST_MEDIAN_VOXELS * mcfg.grid.voxel_size:
            fails.append(f"raycast median |error| {med} m")
    check(fails)
    return out


def photoba_phase(data_dir, out_dir, voxel=VOXEL):
    """Phase 5: photoba through its CLI; BA energy must not increase and
    the coloured outputs must parse."""
    from gradient_sdf_tpu.apps import photoba

    metrics = photoba.main([
        "--input", data_dir, "--results", out_dir, "--data-type", "synth",
        "--voxel-size", str(voxel),
        "--metrics-json", os.path.join(out_dir, "metrics.json")])
    e = metrics["ba_energies"]
    print(f"photoba: keyframes={metrics['keyframes']} "
          f"invalid={metrics['invalid_frames']} energies {e[0]:.6g} -> "
          f"{e[-1]:.6g} over {(len(e) - 1) // 2} iterations")
    fails = []
    if not e[-1] <= e[0]:
        fails.append(f"BA energy rose {e[0]} -> {e[-1]}")
    for name in ("coarse_BA_mesh_after_upsample.ply",
                 "coarse_BA_cloud_after_upsample.ply"):
        try:
            if ply_vertices(os.path.join(out_dir, name), need_color=True) == 0:
                fails.append(f"{name} is empty")
        except (OSError, ValueError, KeyError, StopIteration) as e_:
            fails.append(f"{name} does not parse: {e_!r}")
    check(fails)
    return metrics


# ---- --four-cards: the sharded path against one device ----------------------

def four_card_phase(data_dir, out_dir, card, *, voxel=VOXEL, **kw):
    """scan3d --devices 4 --block-parallel 2 with the phase-2 gates, then
    `sharded_vs_single`; fails if either does."""
    fails = []
    try:  # the app's gates; the op comparisons run either way
        scan_phase("scan3d --devices 4", data_dir, out_dir, card, voxel,
                   ("--devices", "4", "--block-parallel", "2"))
    except GateError as e:
        fails.append(f"scan3d --devices 4: {e}")
    out, op_fails = sharded_vs_single(data_dir, voxel=voxel, **kw)
    check(fails + op_fails)
    return out


def sharded_vs_single(data_dir, *, n_fuse=3, ba_F=30, ba_V=100 * 1024,
                      voxel=VOXEL):
    """Each sharded op against its single-device counterpart on identical
    inputs: fusion, same-map tracking, the sharded render, and one
    --sharded-ba iteration. Returns (numbers, failed gates)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from gradient_sdf_tpu.config import (FusionConfig, GridConfig,
                                         PipelineConfig, TrackerConfig)
    from gradient_sdf_tpu.models import tracker
    from gradient_sdf_tpu.models.grad_sdf import GradSdfMap
    from gradient_sdf_tpu.ops import fusion
    from gradient_sdf_tpu.parallel import mesh as mesh_mod
    from gradient_sdf_tpu.parallel import sharding

    out, fails = {}, []
    depths, poses, K = load_frames(data_dir, n_fuse + 1)
    h, w = depths[0].shape
    gcfg = GridConfig(voxel_size=voxel)
    fcfg = FusionConfig(trunc_voxels=TRUNC)
    mesh = mesh_mod.make_mesh(4, block_parallel=2)
    one = jax.devices()[0]

    # -- fusion: sharded map (as scan3d --devices uses it) vs one device -
    pcfg = dataclasses.replace(PipelineConfig(), grid=gcfg, fusion=fcfg)
    smap = GradSdfMap(pcfg)
    smap.attach_mesh(mesh)
    for d, (R, t) in zip(depths[:n_fuse], poses):
        smap.update(d, K, (R, t))
    fuse = jax.jit(lambda g, d, c, R, t: fusion.fuse_frame(
        g, d, c, R, t, gcfg, fcfg))
    g_one, _ = fuse_on(one, depths[:n_fuse], poses, K, gcfg, fcfg, fuse)
    g_sh = smap.grid
    d_w = float(np.max(np.abs(np.asarray(g_sh.weight)
                              - np.asarray(g_one.weight))))
    d_d = float(np.max(np.abs(np.asarray(g_sh.dist)
                              - np.asarray(g_one.dist))))
    out["fusion"] = {"max_abs_weight": d_w, "max_abs_dist": d_d,
                     "num_active": (int(g_sh.num_active),
                                    int(g_one.num_active))}
    print(f"four cards fusion (sharded vs one device): {out['fusion']}")
    if int(g_sh.num_active) != int(g_one.num_active):
        fails.append("sharded fusion: num_active differs")
    if not (d_w < SHARDED_FIELD_ATOL and d_d < SHARDED_FIELD_ATOL):
        fails.append(f"sharded fusion fields differ ({d_w}, {d_d})")

    # -- tracking on the same map ----------------------------------------
    cap = tracker.adaptive_compact_cap(depths[n_fuse], fcfg)
    tcfg = TrackerConfig(compact_cap_frac=cap)
    Kj = jnp.asarray(K)
    R0, t0 = (jnp.asarray(x) for x in poses[n_fuse - 1])
    d_next = jnp.asarray(depths[n_fuse])
    R_s, t_s, conv_s, it_s = jax.jit(
        lambda g, d, R, t: sharding.sharded_track_frame(
            mesh, g, d, Kj, R, t, gcfg, fcfg, tcfg))(g_sh, d_next, R0, t0)
    g_same = jax.device_put(g_sh, one)
    r_one = jax.jit(lambda g, d, R, t: tracker.track_frame(
        g, d, Kj, R, t, gcfg, fcfg, tcfg))(g_same, d_next, R0, t0)
    d_R, d_t = pose_diff(R_s, t_s, r_one.R, r_one.t)
    out["track"] = {"dR": d_R, "dt": d_t,
                    "iters": (int(it_s), int(r_one.num_iters))}
    print(f"four cards tracking (sharded vs one device, same map): "
          f"{out['track']}")
    if not (d_R < POSE_TOL and d_t < POSE_TOL):
        fails.append(f"sharded tracking: |dR|={d_R:.2e} |dt|={d_t:.2e}")

    # -- sharded render --------------------------------------------------
    n_act = int(g_sh.num_active)
    cap_blocks = -(-n_act // 256) * 256
    if n_act > cap_blocks:
        fails.append("render cap below num_active")
    d_img, _, hit = jax.jit(
        lambda g, R, t: sharding.sharded_render_depth_normal(
            mesh, g, Kj, R, t, w, h, gcfg, fcfg, s_max=3.5,
            active_cap=cap_blocks))(g_sh, R0, t0)
    n_hit = int(jnp.sum(hit))
    out["render_hits"] = n_hit
    print(f"four cards render: {n_hit} hits of {w * h} rays "
          f"(active cap {cap_blocks} >= {n_act} blocks)")
    if n_hit == 0 or not np.isfinite(np.asarray(d_img)).all():
        fails.append("sharded render has no hits or non-finite depth")

    # -- one --sharded-ba iteration vs one device --------------------------
    from gradient_sdf_tpu.config import PhotoBAConfig

    problem, state = ba_test_problem(ba_F, ba_V, w, h, K)
    _, e1, e2 = ba_iteration(gcfg)(*jax.device_put((problem, state), one))
    # uncommitted inputs, as photoba --sharded-ba hands them over
    problem, state = jax.tree.map(jnp.asarray, (problem, state))
    _, e1_s, e2_s = sharding.sharded_ba_step(
        mesh_mod.make_mesh(4), problem, state, gcfg, PhotoBAConfig())
    out["ba"] = {"e_pose": (float(e1_s), float(e1)),
                 "e_dist": (float(e2_s), float(e2))}
    print(f"four cards BA iteration (sharded vs one device): {out['ba']}")
    for a, b, what in ((e1_s, e1, "pose"), (e2_s, e2, "dist")):
        if not rel_diff(a, b) < ENERGY_RTOL:
            fails.append(f"sharded BA energy after {what} step {float(a)} "
                         f"vs {float(b)}")
    return out, fails


# ---- entry point --------------------------------------------------------------

def _device_or_none(need):
    """(jax, devices) when a GPU is JAX's default backend with at least
    `need` devices, else None with the reason on stderr."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{devs[0].platform}); nothing to measure", file=sys.stderr)
        return None
    if len(devs) < need:
        print(f"chip_smoke: {len(devs)} GPU(s) visible, {need} needed",
              file=sys.stderr)
        return None
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("chip_smoke", description=__doc__.split(
        "\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its "
                         "single-device comparison")
    opts = ap.parse_args(argv)

    # the CPU backend stays available beside the GPU: phase 4's reference
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    try:
        from gradient_sdf_tpu.utils import compile_cache
    except ImportError:
        print("chip_smoke: run from the root of a gradient_sdf_tpu checkout",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    devs = _device_or_none(4 if opts.four_cards else 1)
    if devs is None:
        return 3

    import jax

    phases = Phases()
    info = {}

    def device_phase():
        from gradient_sdf_tpu import native

        info["card"] = gpu_info()
        d = jax.devices()[0]
        print(f"device: platform={d.platform} kind={d.device_kind} "
              f"count={len(jax.devices())} jax={jax.__version__}")
        print(f"nvidia-smi: {info['card']}")
        print(f"native host library: "
              f"{'loaded' if native.available() else 'unavailable (Python fallback)'}")
        print(f"compile cache: {compile_cache.cache_dir()}")

    phases.run("0 device", device_phase)
    card = info.get("card", "unknown card").splitlines()[0]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        data = os.path.join(work, "data")
        phases.run("1 data", make_data, data)
        if opts.four_cards:
            phases.run("four cards", four_card_phase, data,
                       os.path.join(work, "scan3d_4"), card)
        else:
            scan = phases.run("2 scan3d", scan_phase, "scan3d", data,
                              os.path.join(work, "scan3d"), card)
            phases.run("3 scan3d --merged-step", scan_phase,
                       "scan3d --merged-step", data,
                       os.path.join(work, "scan3d_merged"), card,
                       VOXEL, ("--merged-step",))
            scan_map = None
            if scan is not None:
                from gradient_sdf_tpu.utils import tumio

                scan_map = (scan[1], tumio.read_trajectory(os.path.join(
                    work, "scan3d", "_poses.txt")),
                    set(scan[0]["invalid_frames"]))
            phases.run("4 numerics", numerics_phase, data, scan_map, card)
            phases.run("5 photoba", photoba_phase, data,
                       os.path.join(work, "photoba"))

    d = jax.devices()[0]
    result = {"ok": not phases.failed,
              "device": {"platform": d.platform, "kind": d.device_kind,
                         "count": len(jax.devices())}}
    if phases.failed:
        result["failed"] = phases.failed
    print(f"card: {info.get('card', 'unknown')}")
    print(json.dumps(result), flush=True)
    return 0 if not phases.failed else 1


if __name__ == "__main__":
    sys.exit(main())
