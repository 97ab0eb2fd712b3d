"""Golden parity harness: run the COMPILED C++ reference and this framework
on the same synthetic dataset and compare outputs numerically.

This closes SURVEY.md §7's "parity harness" item with the real thing — not
oracle re-implementations but the reference binary itself
(`cpp/depth_scanning/src/main_scan_3d.cpp`), built by
`parity/build_reference.sh` (thin standard-semantics shims for its
not-checked-out header-only submodules; see parity/refshim/).

Protocol (both configs on one make_synth VGA dataset; the reference
hardcodes its NormalEstimator to 640x480, main_scan_3d.cpp:183):
  1. GT-pose fusion-only + --save-sdf  -> voxel-by-voxel dump comparison
     (dist/weight/gradients over the identical bounding box).
  2. Tracking mode (no pose file)      -> TUM trajectory comparison.

Measured reference per-frame times are reported as the CPU baseline
(non-OMP build, single thread on this host).

Usage: python parity/run_golden_parity.py [--binary PATH] [--work DIR]
Exits nonzero if any parity threshold fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BIN = "/tmp/depth_scanning/bin/Scan3D"

# Thresholds (measured headroom ~2-10x on the 6-frame VGA protocol; see
# PARITY.md "Golden parity" for the observed values they gate):
MAX_VOXEL_SET_DELTA = 0.01   # fraction of observed voxels unique to one side
MAX_W_MISMATCH_FRAC = 0.10   # voxels whose sample multiset differs (fp ties)
MAX_D_SAMEW = 1e-3           # max |dist diff| where multisets agree (m)
MAX_TRAJ_T = 2e-3            # max translation diff per frame (m)
MAX_TRAJ_Q = 2e-3            # max per-component quaternion diff
MAX_BA_POSE_T = 1e-2         # max post-BA keyframe translation diff (m).
# Both implementations end BA in the reference's own diverge-abort
# (PhotometricOptimizer.cpp:651-655) — its rel_diff < 5e-4 stop never
# fires on any synthetic we could build, the energy floor keeps yielding
# ~2%/iter decreases until one overstep — so final poses reflect each
# side's last overstep (measured 4.0 mm apart on the grayscale fixture),
# not a converged state. The strong gate is the per-iteration one below.
MAX_BA_E_PREFIX_REL = 0.02   # max relative per-iteration energy diff over
# the shared iteration prefix (measured <= 0.6% across 10 consecutive
# energies on the grayscale no-noise fixture; see PARITY.md)
# HR gates anchor on the reference CLOUD (its HR MESH carries a ~0.4
# HR-voxel per-axis vertex jitter against its own cloud — acknowledged
# index bugs, HrLayeredMarchingCubes.cpp:764; see PARITY.md). HR voxel is
# 1 cm at the protocol's vs=2 cm. Measured: mesh->refcloud median 1.8 mm,
# cloud medians sub-mm, envelope p999 ~9 mm.
MAX_HR_MESH_MED = 0.004      # our HR mesh -> ref cloud median (m)
MAX_HR_CLOUD_MED = 0.002     # our HR cloud -> ref cloud median (m)
MAX_HR_CLOUD_P99 = 0.008     # tail: post-BA dist deltas move rim points
MAX_HR_ENVELOPE = 0.02       # ref-mesh agreement envelope (both dirs p999)
MAX_HR_COLOR = 12.0          # mean |albedo diff| at matched points (uint8)
MIN_HR_NRM_DOT = 0.9         # 1st percentile of matched normal dot


def run(cmd, **kw):
    print("+", " ".join(cmd), flush=True)
    return subprocess.run(cmd, check=True, capture_output=True, text=True,
                          **kw)


def load_traj(path):
    rows = [l.split() for l in open(path) if l.strip()]
    return np.array([[float(x) for x in r[1:]] for r in rows])


def main():
    ap = argparse.ArgumentParser("golden-parity")
    ap.add_argument("--binary", default=DEFAULT_BIN)
    ap.add_argument("--work", default="/tmp/golden_parity")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--omp-binary", default="/tmp/refomp/build/depth_scanning/bin/Scan3D",
                    help="OpenMP-build Scan3D (OMP=1 parity/build_reference.sh); "
                         "timed as ref_cpu_fps_omp when present — the "
                         "reference's own README claims paper-comparable "
                         "runtimes only for OMP builds (README.md:46)")
    ap.add_argument("--ba", action="store_true",
                    help="also run the grayscale-textured FULL-BA "
                         "convergence comparison (both implementations' "
                         "PhotoBA to convergence; post-BA keyframe poses "
                         "and energy trajectories gated)")
    ap.add_argument("--noisy", action="store_true",
                    help="also run the 30-frame Kinect-noise ATE comparison "
                         "(the fr1/desk-style accuracy protocol; ~7 extra "
                         "minutes on this host)")
    ap.add_argument("--long", dest="long_run", action="store_true",
                    help="also run the 150-frame LOOP-REVISIT protocol "
                         "(full VGA orbit that re-enters the start view: "
                         "accumulated drift + revisit consistency — the "
                         "axis a short arc cannot test; ~25 extra minutes, "
                         "our side runs on CPU)")
    ap.add_argument("--long-frames", type=int, default=150)
    ap.add_argument("--box", action="store_true",
                    help="also run the BOX-WORLD parity stage (planar faces "
                         "+ creases + occlusion edges, make_synth --world "
                         "box): GT-fusion voxel parity, mesh parity at "
                         "creases, stored-gradient accuracy vs analytic box "
                         "normals, and tracking parity-of-failure (BOTH "
                         "implementations' GN oscillates above the 1e-3 "
                         "gate on all-axis-aligned grazing planes — a "
                         "formulation-level projective-TSDF bias shared "
                         "with the reference, measured round 5)")
    ap.add_argument("--ba-recovery", dest="ba_recovery", action="store_true",
                    help="also run the BA-RECOVERY fixture: fuse the "
                         "grayscale world at GROUND-TRUTH "
                         "poses, hand BOTH implementations' optimizers "
                         "perturbed keyframe poses (via "
                         "parity/probe_ba_recovery.cpp for the reference, "
                         "photoba --ba-init-pose-file for ours), and gate "
                         "that BA measurably RECOVERS (post < pre aligned "
                         "ATE) and that ours converges (optimize() True)")
    opts = ap.parse_args()

    if not os.path.isfile(opts.binary):
        print(f"reference binary missing at {opts.binary}; "
              f"run parity/build_reference.sh first", file=sys.stderr)
        return 2

    os.makedirs(opts.work, exist_ok=True)
    data = os.path.join(opts.work, "data")
    py = [sys.executable, "-c"]

    def run_py(code):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run(
            [sys.executable, "-c",
             "import jax; jax.config.update('jax_platforms','cpu')\n" + code],
            check=True, env=env, cwd=REPO, capture_output=True, text=True)

    if not os.path.isfile(os.path.join(data, "gt_poses.txt")):
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['make_synth','--out',{data!r},'--frames',"
            f"'{opts.frames}','--seed','2','--width','640','--height','480',"
            "'--arc-deg','4','--no-noise']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
            "run_name='__main__')")

    report = {}

    # ---- 1. GT-pose fusion golden run -----------------------------------
    ref_out = os.path.join(opts.work, "ref_gt") + "/"
    our_out = os.path.join(opts.work, "ours_gt")
    os.makedirs(ref_out, exist_ok=True)
    t0 = time.time()
    r = run([opts.binary, "--input", data + "/", "--results", ref_out,
             "--pose-file", "gt_poses.txt", "--data-type", "synth",
             "--scan-type", "grad-sdf", "--voxel-size", "0.02",
             "--trunc", "5", "--save-sdf"])
    report["ref_gt_wall_s"] = round(time.time() - t0, 2)
    fuse_ms = [float(m) for m in re.findall(
        r"Integrate depth data into Sdf: ([0-9.]+)ms", r.stdout)]
    report["ref_fuse_ms_median"] = round(float(np.median(fuse_ms)), 2)

    run_py(
        "import runpy, sys\n"
        f"sys.argv=['scan3d','--input',{data!r},'--results',{our_out!r},"
        "'--pose-file','gt_poses.txt','--data-type','synth',"
        "'--voxel-size','0.02','--trunc','5','--save-sdf']\n"
        "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
        "run_name='__main__')")

    sys.path.insert(0, REPO)
    from gradient_sdf_tpu.analysis.gradient_analysis import load_sdf_dump

    ref = load_sdf_dump(os.path.join(ref_out, "gradient_sdf"))
    ours = load_sdf_dump(os.path.join(our_out, "gradient_sdf"))
    assert ref["d"].shape == ours["d"].shape, \
        f"bounding boxes differ: {ref['d'].shape} vs {ours['d'].shape}"
    wr, wo = ref["w"], ours["w"]
    both = (wr > 0) & (wo > 0)
    either = (wr > 0) | (wo > 0)
    set_delta = 1.0 - both.sum() / max(either.sum(), 1)
    w_mis = float((np.abs(wr - wo)[both] > 0.01).mean())
    same_w = both & (np.abs(wr - wo) <= 0.01)
    d_err = float(np.abs(ref["d"] - ours["d"])[same_w].max())
    report.update(observed_ref=int((wr > 0).sum()),
                  observed_ours=int((wo > 0).sum()),
                  voxel_set_delta=round(float(set_delta), 5),
                  w_mismatch_frac=round(w_mis, 5),
                  d_max_same_weight=float(d_err))

    # ---- 1b. Marching-cubes mesh parity (same fused map) -----------------
    # The reference's transcribed-LUT MC vs our generated-table MC: vertex
    # sets must coincide geometrically (the reference writes raw triangle
    # soup, we dedup vertices — counts differ by design, PARITY.md).
    from gradient_sdf_tpu.utils.ply import load_ply

    def verts(path):
        v = np.asarray(load_ply(path)["vertex"])
        return (np.stack([v[n] for n in ("x", "y", "z")], -1)
                if v.dtype.fields else v)

    rv = verts(os.path.join(ref_out, "gradient_sdf_mesh_final.ply"))
    ov = verts(os.path.join(our_out, "gradient_sdf_mesh_final.ply"))

    def nn(a, b):
        out = []
        for i in range(0, len(a), 2000):
            out.append(np.linalg.norm(
                a[i:i + 2000, None, :] - b[None, :, :], axis=-1).min(1))
        return np.concatenate(out)

    d_ro, d_or = nn(rv, ov), nn(ov, rv)
    report["mesh_ref2ours_p999"] = float(np.quantile(d_ro, 0.999))
    report["mesh_ours2ref_max"] = float(d_or.max())
    mesh_ok = (report["mesh_ref2ours_p999"] <= 0.25 * 0.02
               and report["mesh_ours2ref_max"] <= 0.25 * 0.02)

    # ---- 2. Tracking-mode trajectory ------------------------------------
    ref_out_t = os.path.join(opts.work, "ref_track") + "/"
    our_out_t = os.path.join(opts.work, "ours_track")
    os.makedirs(ref_out_t, exist_ok=True)
    r = run([opts.binary, "--input", data + "/", "--results", ref_out_t,
             "--pose-file", "nonexistent.txt", "--data-type", "synth",
             "--scan-type", "grad-sdf", "--voxel-size", "0.02",
             "--trunc", "5"])
    track_ms = [float(m) for m in re.findall(
        r"Point optimization: ([0-9.]+)ms", r.stdout)]
    report["ref_track_ms_median"] = round(float(np.median(track_ms)), 2)
    report["ref_cpu_fps"] = round(
        1e3 / (np.median(track_ms) + np.median(fuse_ms)), 2)

    # ---- 2b. OMP reference baseline (timing only) ------------------------
    # The reference's real performance claim is its OMP build
    # (/root/reference/README.md:46; source toggle cpp/CMakeLists.txt:45-58,
    # tracking pinned to 4 threads RigidPointOptimizerOmp.cpp:68). Same
    # tracking-mode protocol; trajectory equality with the non-OMP build is
    # NOT gated (OMP fusion applies running means in nondeterministic pixel
    # order), only timed.
    if os.path.isfile(opts.omp_binary):
        ref_out_o = os.path.join(opts.work, "ref_track_omp") + "/"
        os.makedirs(ref_out_o, exist_ok=True)
        r = run([opts.omp_binary, "--input", data + "/", "--results",
                 ref_out_o, "--pose-file", "nonexistent.txt",
                 "--data-type", "synth", "--scan-type", "grad-sdf",
                 "--voxel-size", "0.02", "--trunc", "5"])
        omp_track = [float(m) for m in re.findall(
            r"Point optimization: ([0-9.]+)ms", r.stdout)]
        omp_fuse = [float(m) for m in re.findall(
            r"Integrate depth data into Sdf: ([0-9.]+)ms", r.stdout)]
        report["ref_omp_track_ms_median"] = round(
            float(np.median(omp_track)), 2)
        report["ref_omp_fuse_ms_median"] = round(
            float(np.median(omp_fuse)), 2)
        report["ref_cpu_fps_omp"] = round(
            1e3 / (np.median(omp_track) + np.median(omp_fuse)), 2)
    else:
        report["ref_cpu_fps_omp"] = None

    # --no-warm-start: this stage gates TRAJECTORY EQUALITY against the
    # reference, so GN must start from the previous pose exactly like the
    # binary does (warm starting is off by default anyway; the flag pins
    # it against future default changes)
    run_py(
        "import runpy, sys\n"
        f"sys.argv=['scan3d','--input',{data!r},'--results',{our_out_t!r},"
        "'--pose-file','nonexistent.txt','--data-type','synth',"
        "'--voxel-size','0.02','--trunc','5','--sampling','1',"
        "'--no-warm-start']\n"
        "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
        "run_name='__main__')")

    tr = load_traj(os.path.join(ref_out_t, "_poses.txt"))
    to = load_traj(os.path.join(our_out_t, "_poses.txt"))
    assert len(tr) == len(to), f"frame counts differ: {len(tr)} vs {len(to)}"
    t_diff = float(np.linalg.norm(tr[:, :3] - to[:, :3], axis=1).max())
    # quaternions are compared up to the q/-q double cover: sign-align each
    # frame's pair on their dot product before differencing
    qr, qo = tr[:, 3:7], to[:, 3:7]
    sign = np.where(np.sum(qr * qo, axis=1, keepdims=True) < 0.0, -1.0, 1.0)
    q_diff = float(np.abs(qr - sign * qo).max())
    report["traj_t_max"] = t_diff
    report["traj_q_max"] = q_diff

    # ---- 3. PhotoBA: keyframe policy + pre-BA pose parity ----------------
    # (BA step magnitudes differ by a documented reference channel-order
    # inconsistency, PARITY.md "Golden parity" — not gated here)
    ba_bin = os.path.join(os.path.dirname(os.path.dirname(opts.binary)),
                          "..", "photometric_opt", "bin", "PhotoBA")
    ba_bin = os.path.normpath(ba_bin)
    kf_ok = None
    if os.path.isfile(ba_bin):
        ref_ba = os.path.join(opts.work, "ref_ba") + "/"
        our_ba = os.path.join(opts.work, "ours_ba")
        os.makedirs(ref_ba, exist_ok=True)
        run([ba_bin, "--input", data + "/", "--results", ref_ba,
             "--data-type", "synth", "--voxel-size", "0.02",
             "--trunc", "5", "--key-frame", "3"])
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['photoba','--input',{data!r},'--results',{our_ba!r},"
            "'--data-type','synth','--voxel-size','0.02','--trunc','5',"
            "'--key-frame','3']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.photoba',"
            "run_name='__main__')")
        sel = "selected_frame_poses_before_optimization.txt"
        kr = load_traj(os.path.join(ref_ba, sel))
        ko = load_traj(os.path.join(our_ba, sel))
        stamps_r = [l.split()[0] for l in open(os.path.join(ref_ba, sel))]
        stamps_o = [l.split()[0] for l in open(os.path.join(our_ba, sel))]
        report["kf_stamps_ref"] = stamps_r
        report["kf_stamps_ours"] = stamps_o
        kf_t = float(np.linalg.norm(kr[:, :3] - ko[:, :3], axis=1).max()) \
            if len(kr) == len(ko) else float("inf")
        report["kf_pose_t_max"] = kf_t
        kf_ok = (stamps_r == stamps_o) and kf_t <= MAX_TRAJ_T
    else:
        report["photoba_skipped"] = f"binary missing at {ba_bin}"

    # ---- 3b (opt-in). FULL-BA convergence parity on grayscale ------------
    # On a GRAYSCALE-TEXTURED synthetic the reference's channel-reversed
    # image gradients (PhotometricOptimizer.cpp:102-126) coincide with
    # residual-consistent ones, so both implementations' complete BA loops
    # (:611-663) are directly comparable: gate post-BA keyframe poses and
    # energy-trajectory agreement.
    ba_conv_ok = None
    if opts.ba and os.path.isfile(ba_bin):
        # noise-free: with Kinect noise both implementations hit the shared
        # diverge-abort (measured: ref at iter 4, ours at iter 3 — energies
        # tracking within ~3-30% — but post-overstep poses scatter ~16 mm);
        # the clean CONVERGENCE gate needs a dataset where the reference's
        # rel_diff < 5e-4 stop actually fires
        gdata = os.path.join(opts.work, "data_gray")
        if not os.path.isfile(os.path.join(gdata, "gt_poses.txt")):
            run_py(
                "import runpy, sys\n"
                f"sys.argv=['make_synth','--out',{gdata!r},'--frames','24',"
                "'--seed','5','--width','640','--height','480',"
                "'--arc-deg','48','--gray-texture','--no-noise']\n"
                "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
                "run_name='__main__')")
        ref_g = os.path.join(opts.work, "ref_gray_ba") + "/"
        our_g = os.path.join(opts.work, "ours_gray_ba")
        os.makedirs(ref_g, exist_ok=True)
        r = run([ba_bin, "--input", gdata + "/", "--results", ref_g,
                 "--data-type", "synth", "--voxel-size", "0.02",
                 "--trunc", "5", "--key-frame", "8"])
        e_ref = [float(m) for m in re.findall(
            r"Energy (?:before BA|after \d+ iterations of coarse BA "
            r"\((?:pose|dist)\)): ([0-9.eE+-]+)", r.stdout)]
        # pin OUR phase-1 state to the REFERENCE's own tracked trajectory
        # (fusion is golden-gated voxel-for-voxel, so both BAs then start
        # from the same optimization problem): our tracker's endpoint
        # wanders ~0.5-1 mm at the GN noise floor between fp-equivalent
        # programs, and the BA trajectory chaotically amplifies that
        # (measured: 0.6% energy prefix agreement on one build, 7% on a
        # bit-different one) — pinning isolates the BA comparison.
        import shutil

        ref_traj = [f for f in os.listdir(ref_g) if f.endswith("_poses.txt")
                    and f.startswith("map-")]
        assert ref_traj, os.listdir(ref_g)
        shutil.copy(os.path.join(ref_g, ref_traj[0]),
                    os.path.join(gdata, "ref_phase1_poses.txt"))
        ro = run_py(
            "import runpy, sys\n"
            f"sys.argv=['photoba','--input',{gdata!r},'--results',{our_g!r},"
            "'--data-type','synth','--voxel-size','0.02','--trunc','5',"
            "'--key-frame','8','--pose-file','ref_phase1_poses.txt']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.photoba',"
            "run_name='__main__')")
        e_ours = [float(m) for m in re.findall(
            r"Energy (?:before BA|after \d+ iterations of coarse BA "
            r"\((?:pose|dist)\)): ([0-9.eE+-]+)", ro.stdout)]

        opt = "coarse_BA_poses_optimized.txt"
        pr = load_traj(os.path.join(ref_g, opt))
        po = load_traj(os.path.join(our_g, opt))
        stamps_r = [l.split()[0] for l in open(os.path.join(ref_g, opt))]
        stamps_o = [l.split()[0] for l in open(os.path.join(our_g, opt))]
        ba_t = (float(np.linalg.norm(pr[:, :3] - po[:, :3], axis=1).max())
                if len(pr) == len(po) else float("inf"))
        report["ba_kf_stamps_match"] = stamps_r == stamps_o
        report["ba_post_pose_t_max"] = ba_t
        report["ba_energy_ref"] = e_ref
        report["ba_energy_ours"] = e_ours
        # PER-ITERATION energy agreement over the shared prefix (excluding
        # each side's final diverge-overstep entry): the strongest BA gate
        # — every solvePose/solveDist half-step's energy must match
        n_shared = max(min(len(e_ref), len(e_ours)) - 1, 0)
        prefix_rel = max(
            (abs(a - b) / max(a, 1e-9)
             for a, b in zip(e_ref[:n_shared], e_ours[:n_shared])),
            default=float("inf"))
        # both sides must END the same way (here: the reference's own
        # diverge-abort; a convergent fixture would report [True, True])
        mono_ref = all(b <= a * 1.0005 for a, b in zip(e_ref, e_ref[1:]))
        mono_ours = all(b <= a * 1.0005 for a, b in zip(e_ours, e_ours[1:]))
        report["ba_energy_prefix_rel_max"] = prefix_rel
        report["ba_energy_shared_prefix"] = n_shared
        report["ba_monotone"] = [mono_ref, mono_ours]
        ba_conv_ok = (stamps_r == stamps_o
                      and ba_t <= MAX_BA_POSE_T
                      and n_shared >= 6
                      and prefix_rel <= MAX_BA_E_PREFIX_REL
                      and mono_ref == mono_ours)

        # ---- 3c. HR colored pipeline golden gates ------------------------
        # ColorUpsampler subvoxel albedo + HR colored marching cubes
        # (ColorUpsampler.cpp:334-377, HrLayeredMarchingCubes.cpp:824-864)
        # compared on the SAME grayscale run: HR mesh geometry like the LR
        # gate, plus albedo at nearest-point pairs for mesh and cloud.
        from gradient_sdf_tpu.utils.ply import load_ply

        def cols(path, n_geom):
            v = np.asarray(load_ply(path)["vertex"])
            if v.dtype.fields:
                names = v.dtype.names
                geom = np.stack([v[n] for n in names[:n_geom]], -1)
                rgb = np.stack(
                    [v[n].astype(np.float64)
                     for n in ("red", "green", "blue")], -1)
                return geom.astype(np.float64), rgb
            return (v[:, :n_geom].astype(np.float64),
                    v[:, n_geom:n_geom + 3].astype(np.float64))

        # The reference's HR MESH vertices are jittered ~0.4 HR voxels
        # per axis against its OWN upsampled cloud (measured: ref mesh ->
        # ref cloud median 7.1 mm vs ours -> ours 1.8 mm; its
        # HrLayeredMarchingCubes acknowledges index bugs, :764), so the
        # bug-free cross-implementation anchor is the reference CLOUD:
        # our mesh and cloud are gated against it for geometry, albedo,
        # and normals; the ref mesh only bounds an agreement envelope.
        from scipy.spatial import cKDTree

        hrm_o, rgb_mo = cols(
            os.path.join(our_g, "coarse_BA_mesh_after_upsample.ply"), 3)
        hrm_r, _ = cols(
            os.path.join(ref_g, "coarse_BA_mesh_after_upsample.ply"), 3)
        hrc_r, rgb_cr = cols(
            os.path.join(ref_g, "coarse_BA_cloud_after_upsample.ply"), 6)
        hrc_o, rgb_co = cols(
            os.path.join(our_g, "coarse_BA_cloud_after_upsample.ply"), 6)

        ref_cloud_tree = cKDTree(hrc_r[:, :3])
        dm, im = ref_cloud_tree.query(hrm_o, workers=-1)
        report["hr_mesh2refcloud_median"] = float(np.median(dm))
        report["hr_mesh2refcloud_p99"] = float(np.quantile(dm, 0.99))
        mclose = dm <= 0.5 * 0.01  # half HR voxel
        report["hr_mesh_color_mean_abs"] = float(
            np.abs(rgb_mo[mclose] - rgb_cr[im[mclose]]).mean())

        dc, j_or = ref_cloud_tree.query(hrc_o[:, :3], workers=-1)
        report["hr_cloud_ours2ref_median"] = float(np.median(dc))
        report["hr_cloud_ours2ref_p99"] = float(np.quantile(dc, 0.99))
        cclose = dc <= 0.25 * 0.01
        report["hr_cloud_color_mean_abs"] = float(
            np.abs(rgb_co[cclose] - rgb_cr[j_or[cclose]]).mean())
        nrm_dot = np.sum(hrc_o[cclose, 3:6] * hrc_r[j_or[cclose], 3:6],
                         axis=-1)
        report["hr_cloud_normal_dot_p01"] = float(np.quantile(nrm_dot, 0.01))
        report["hr_match_fracs"] = [float(mclose.mean()),
                                    float(cclose.mean())]
        # envelope vs the (jittered) reference mesh, both directions
        d_env, _ = cKDTree(hrm_o).query(hrm_r, workers=-1)
        report["hr_mesh_envelope_p999"] = float(
            max(np.quantile(d_env, 0.999),
                np.quantile(cKDTree(hrm_r).query(hrm_o, workers=-1)[0],
                            0.999)))
        hr_ok = (report["hr_mesh2refcloud_median"] <= MAX_HR_MESH_MED
                 and report["hr_cloud_ours2ref_median"] <= MAX_HR_CLOUD_MED
                 and report["hr_cloud_ours2ref_p99"] <= MAX_HR_CLOUD_P99
                 and report["hr_mesh_envelope_p999"] <= MAX_HR_ENVELOPE
                 and report["hr_mesh_color_mean_abs"] <= MAX_HR_COLOR
                 and report["hr_cloud_color_mean_abs"] <= MAX_HR_COLOR
                 and report["hr_cloud_normal_dot_p01"] >= MIN_HR_NRM_DOT)
        ba_conv_ok = ba_conv_ok and hr_ok
    elif opts.ba:
        report["ba_skipped"] = f"PhotoBA binary missing at {ba_bin}"

    # ---- 4 (opt-in). Noisy-sequence tracking accuracy (ATE) --------------
    ate_ok = None
    if opts.noisy:
        from gradient_sdf_tpu.utils import ate as ate_mod, tumio

        ndata = os.path.join(opts.work, "data_noisy")
        if not os.path.isfile(os.path.join(ndata, "gt_poses.txt")):
            run_py(
                "import runpy, sys\n"
                f"sys.argv=['make_synth','--out',{ndata!r},'--frames','30',"
                "'--seed','5','--width','640','--height','480',"
                "'--arc-deg','2']\n"
                "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
                "run_name='__main__')")
        ref_n = os.path.join(opts.work, "ref_noisy") + "/"
        our_n = os.path.join(opts.work, "ours_noisy")
        os.makedirs(ref_n, exist_ok=True)
        run([opts.binary, "--input", ndata + "/", "--results", ref_n,
             "--pose-file", "nonexistent.txt", "--data-type", "synth",
             "--scan-type", "grad-sdf", "--voxel-size", "0.02",
             "--trunc", "5"])
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['scan3d','--input',{ndata!r},'--results',{our_n!r},"
            "'--pose-file','nonexistent.txt','--data-type','synth',"
            "'--voxel-size','0.02','--trunc','5',"
            "'--eval-gt','gt_poses.txt',"
            f"'--metrics-json','{our_n}/m.json']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
            "run_name='__main__')")
        gt = tumio.read_trajectory(os.path.join(ndata, "gt_poses.txt"))
        est = tumio.read_trajectory(os.path.join(ref_n, "_poses.txt"))
        r = ate_mod.evaluate_ate([(ts, t) for ts, _, t in est],
                                 [(ts, np.asarray(t)) for ts, _, t in gt])
        report["noisy_ate_ref"] = float(r.rmse)
        m = json.load(open(os.path.join(our_n, "m.json")))
        report["noisy_ate_ours"] = m.get("ate_rmse")
        # parity: our ATE within 1.5x of the reference's (measured: 3.4 vs
        # 3.3 mm), both under 1 cm on this 2 deg/frame, 60 cm-motion orbit
        ate_ok = (report["noisy_ate_ours"] is not None
                  and report["noisy_ate_ours"] <= max(
                      1.5 * report["noisy_ate_ref"], 0.01))

    # ---- 5 (opt-in). Long loop-revisiting drift protocol ------------------
    # 150 VGA frames on a CLOSED orbit (make_synth --loop): the camera
    # leaves the start view, circles the scene, and re-enters it — models
    # accumulated drift and fusion-on-revisit consistency, which the
    # 6-frame golden arc cannot (reference protocol precedent: the 90-pose
    # matlab spiral, matlab/poses.txt; real-data analog README.md:50,67).
    long_ok = None
    if opts.long_run:
        from scipy.spatial import cKDTree

        from gradient_sdf_tpu.utils import ate as ate_mod, tumio

        ldata = os.path.join(opts.work, "data_loop")
        if not os.path.isfile(os.path.join(ldata, "gt_poses.txt")):
            run_py(
                "import runpy, sys\n"
                f"sys.argv=['make_synth','--out',{ldata!r},'--frames',"
                f"'{opts.long_frames}','--seed','2','--width','640',"
                "'--height','480','--no-noise','--loop']\n"
                "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
                "run_name='__main__')")
        ref_l = os.path.join(opts.work, "ref_loop") + "/"
        our_l = os.path.join(opts.work, "ours_loop")
        os.makedirs(ref_l, exist_ok=True)
        run([opts.binary, "--input", ldata + "/", "--results", ref_l,
             "--pose-file", "nonexistent.txt", "--data-type", "synth",
             "--scan-type", "grad-sdf", "--voxel-size", "0.02",
             "--trunc", "5"])
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['scan3d','--input',{ldata!r},'--results',{our_l!r},"
            "'--pose-file','nonexistent.txt','--data-type','synth',"
            "'--voxel-size','0.02','--trunc','5',"
            "'--eval-gt','gt_poses.txt',"
            f"'--metrics-json','{our_l}/m.json']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
            "run_name='__main__')")

        gt = tumio.read_trajectory(os.path.join(ldata, "gt_poses.txt"))
        gt_pairs = [(ts, np.asarray(t)) for ts, _, t in gt]

        def ate_of(path, tail=None):
            est = tumio.read_trajectory(path)
            if tail:
                est = est[-tail:]
            r = ate_mod.evaluate_ate([(ts, t) for ts, _, t in est], gt_pairs)
            return float(r.rmse) if r is not None else None

        report["loop_ate_ref"] = ate_of(os.path.join(ref_l, "_poses.txt"))
        report["loop_ate_ours"] = ate_of(os.path.join(our_l, "_poses.txt"))
        # revisit drift: pose error over the final 10 frames (back at the
        # start view after the full excursion)
        report["loop_tail_ate_ref"] = ate_of(
            os.path.join(ref_l, "_poses.txt"), tail=10)
        report["loop_tail_ate_ours"] = ate_of(
            os.path.join(our_l, "_poses.txt"), tail=10)
        m = json.load(open(os.path.join(our_l, "m.json")))
        report["loop_invalid_frames_ours"] = len(m.get("invalid_frames", []))

        # revisit-consistency of the fused geometry: both final meshes
        # describe the same world; nearest-neighbor medians/p99 must agree
        # to voxel scale despite each side's own accumulated drift
        mv_r = verts(os.path.join(ref_l, "gradient_sdf_mesh_final.ply"))
        mv_o = verts(os.path.join(our_l, "gradient_sdf_mesh_final.ply"))
        d_or_ = cKDTree(mv_r).query(mv_o, workers=-1)[0]
        d_ro_ = cKDTree(mv_o).query(mv_r, workers=-1)[0]
        report["loop_mesh_ours2ref_median"] = float(np.median(d_or_))
        report["loop_mesh_ours2ref_p99"] = float(np.quantile(d_or_, 0.99))
        report["loop_mesh_ref2ours_p99"] = float(np.quantile(d_ro_, 0.99))
        long_ok = (
            report["loop_ate_ours"] is not None
            and report["loop_ate_ours"] <= max(
                1.5 * (report["loop_ate_ref"] or 0.0), 0.01)
            and report["loop_tail_ate_ours"] <= max(
                1.5 * (report["loop_tail_ate_ref"] or 0.0), 0.015)
            and report["loop_mesh_ours2ref_median"] <= 0.5 * 0.02
            and report["loop_mesh_ours2ref_p99"] <= 1.5 * 0.02
            and report["loop_mesh_ref2ours_p99"] <= 1.5 * 0.02
        )

    # ---- 7 (opt-in). BA-recovery fixture ---------------------------------
    # Does BA demonstrably IMPROVE a reconstruction? The reference app
    # cannot start BA from known-bad poses, so parity/probe_ba_recovery.cpp
    # links its libraries: fuse 24 grayscale VGA frames at GT (vs=1 cm),
    # select keyframes with the reference's own policy, hand optimize()
    # poses perturbed by a fixed-seed 2 mm / 0.2 deg and 3 mm / 0.3 deg
    # twist, and measure Horn-aligned keyframe ATE before/after. Measured
    # round 5 (PARITY.md "BA recovery" for the full story): at 2 mm both
    # sides recover ~2x (ref 1.84 -> 0.94 mm, ours -> 1.12 mm); at 3 mm
    # ours CONVERGES (optimize() True) and recovers 2.76 -> 1.71 mm.
    ba_rec_ok = None
    if opts.ba_recovery:
        from gradient_sdf_tpu.utils import ate as ate_mod
        from gradient_sdf_tpu.utils import tumio

        gdata = os.path.join(opts.work, "data_gray")
        if not os.path.isfile(os.path.join(gdata, "gt_poses.txt")):
            run_py(
                "import runpy, sys\n"
                f"sys.argv=['make_synth','--out',{gdata!r},'--frames','24',"
                "'--seed','5','--width','640','--height','480',"
                "'--arc-deg','48','--gray-texture','--no-noise']\n"
                "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
                "run_name='__main__')")
        probe = "/tmp/probe_ba_recovery"
        if not os.path.isfile(probe):
            eigen = subprocess.run(
                [sys.executable, "-c",
                 "import tensorflow, os; print(os.path.join(os.path.dirname("
                 "tensorflow.__file__), 'include'))"],
                capture_output=True, text=True).stdout.strip()
            pkg = subprocess.run(["pkg-config", "--cflags", "--libs",
                                  "opencv4"], capture_output=True,
                                 text=True).stdout.split()
            run(["g++", "-O2", "-std=c++17", "-fopenmp",
                 os.path.join(REPO, "parity", "probe_ba_recovery.cpp"),
                 "-isystem", os.path.join(REPO, "parity", "refshim"),
                 "-isystem", eigen,
                 "-I", "/root/reference/cpp/include",
                 "-I", "/root/reference/cpp/third"] + pkg +
                ["/tmp/refbuild/libsdf_tracker_lib.a",
                 "/tmp/refbuild/libcolor_lib.a",
                 "/tmp/refbuild/libmc_lib.a", "-o", probe])

        # deterministic twist perturbations of the GT trajectory
        gt = tumio.read_trajectory(os.path.join(gdata, "gt_poses.txt"))
        gt_pairs = [(ts, np.asarray(t)) for ts, _, t in gt]

        def write_pert(mag_t, mag_deg, path):
            from gradient_sdf_tpu.utils import se3
            import jax.numpy as jnp

            rng = np.random.RandomState(11)
            rows = []
            for ts, R, t in gt:
                w = rng.randn(3)
                w *= np.deg2rad(mag_deg) / np.linalg.norm(w)
                v = rng.randn(3)
                v *= mag_t / np.linalg.norm(v)
                dR, dt = se3.se3_exp(
                    jnp.asarray(np.concatenate([v, w]), jnp.float32))
                Rn, tn = se3.se3_mul(jnp.asarray(R, jnp.float32),
                                     jnp.asarray(t, jnp.float32), dR, dt)
                rows.append((ts, np.asarray(Rn), np.asarray(tn)))
            tumio.write_trajectory(path, rows)

        def aligned_ate(path):
            tr = tumio.read_trajectory(path)
            r = ate_mod.evaluate_ate([(ts, t) for ts, _, t in tr], gt_pairs)
            return float(r.rmse)

        ba_rec_ok = True
        for tag, mag_t, mag_deg in (("2mm", 0.002, 0.2), ("3mm", 0.003, 0.3)):
            pert = os.path.join(gdata, f"barec_{tag}.txt")
            write_pert(mag_t, mag_deg, pert)
            ref_o = os.path.join(opts.work, f"barec_ref_{tag}") + "/"
            our_o = os.path.join(opts.work, f"barec_ours_{tag}")
            os.makedirs(ref_o, exist_ok=True)
            r = run([probe, gdata + "/", ref_o, pert, "8", "0.01"])
            ref_conv = "converge after" in r.stdout
            ro = run_py(
                "import runpy, sys\n"
                f"sys.argv=['photoba','--input',{gdata!r},"
                f"'--results',{our_o!r},'--data-type','synth',"
                "'--voxel-size','0.01','--trunc','5','--key-frame','8',"
                "'--pose-file','gt_poses.txt',"
                f"'--ba-init-pose-file','barec_{tag}.txt',"
                f"'--metrics-json',{our_o + '/m.json'!r}]\n"
                "runpy.run_module('gradient_sdf_tpu.apps.photoba',"
                "run_name='__main__')")
            pre = "selected_frame_poses_before_optimization.txt"
            post = "coarse_BA_poses_optimized.txt"
            res = {
                "pre_ate": aligned_ate(os.path.join(ref_o, pre)),
                "ref_post_ate": aligned_ate(os.path.join(ref_o, post)),
                "ours_post_ate": aligned_ate(os.path.join(our_o, post)),
                "ref_converged": ref_conv,
                "ours_converged": json.load(
                    open(os.path.join(our_o, "m.json")))["ba_converged"],
                "kf_stamps_match": (
                    [l.split()[0] for l in open(os.path.join(ref_o, post))]
                    == [l.split()[0]
                        for l in open(os.path.join(our_o, post))]),
            }
            report[f"ba_recovery_{tag}"] = res
            # gates: identical keyframe sets; OURS must RECOVER (post <
            # pre) on both fixtures and land within 2.5 mm; the reference
            # is reported, not pose-gated (its dist-half-step stop can
            # freeze it early — 3.66 mm at 3 mm, see PARITY.md); on the
            # 3 mm fixture ours must return converged=True
            ba_rec_ok = (ba_rec_ok
                         and res["kf_stamps_match"]
                         and res["ours_post_ate"] < res["pre_ate"]
                         and res["ours_post_ate"] <= 0.0025)
            if tag == "3mm":
                ba_rec_ok = ba_rec_ok and res["ours_converged"]

    # ---- 6 (opt-in). Box-world parity (creases + occlusion edges) --------
    box_ok = None
    if opts.box:
        from gradient_sdf_tpu.utils import se3, tumio

        bdata = os.path.join(opts.work, "data_box")
        if not os.path.isfile(os.path.join(bdata, "gt_poses.txt")):
            run_py(
                "import runpy, sys\n"
                f"sys.argv=['make_synth','--out',{bdata!r},'--frames','6',"
                "'--seed','2','--width','640','--height','480',"
                "'--arc-deg','4','--no-noise','--world','box']\n"
                "runpy.run_module('gradient_sdf_tpu.apps.make_synth',"
                "run_name='__main__')")

        # 6a. GT-pose fusion voxel parity (stage-1 gates on box geometry:
        # the per-voxel walk now crosses creases and occlusion shadows)
        ref_b = os.path.join(opts.work, "ref_box") + "/"
        our_b = os.path.join(opts.work, "ours_box")
        os.makedirs(ref_b, exist_ok=True)
        run([opts.binary, "--input", bdata + "/", "--results", ref_b,
             "--pose-file", "gt_poses.txt", "--data-type", "synth",
             "--scan-type", "grad-sdf", "--voxel-size", "0.02",
             "--trunc", "5", "--save-sdf"])
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['scan3d','--input',{bdata!r},'--results',{our_b!r},"
            "'--pose-file','gt_poses.txt','--data-type','synth',"
            "'--voxel-size','0.02','--trunc','5','--save-sdf']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
            "run_name='__main__')")
        refd = load_sdf_dump(os.path.join(ref_b, "gradient_sdf"))
        ourd = load_sdf_dump(os.path.join(our_b, "gradient_sdf"))
        assert refd["d"].shape == ourd["d"].shape, \
            f"box bounding boxes differ: {refd['d'].shape} vs {ourd['d'].shape}"
        wr_b, wo_b = refd["w"], ourd["w"]
        both_b = (wr_b > 0) & (wo_b > 0)
        either_b = (wr_b > 0) | (wo_b > 0)
        box_set = 1.0 - both_b.sum() / max(either_b.sum(), 1)
        box_wmis = float((np.abs(wr_b - wo_b)[both_b] > 0.01).mean())
        same_wb = both_b & (np.abs(wr_b - wo_b) <= 0.01)
        d_diff_b = np.abs(refd["d"] - ourd["d"])[same_wb]
        # the box scene has a VISIBILITY RIM the closed sphere surfaces
        # don't: the floor slab leaves the frustum at grazing incidence,
        # and there a half-ulp projection difference flips which depth
        # pixel a rim voxel's sample reads — measured: exactly 1 voxel
        # (floor rim corner) above 1e-3, p999 6e-5. Gate the bulk at the
        # sphere threshold and bound the rim-outlier count.
        report.update(box_voxel_set_delta=round(float(box_set), 5),
                      box_w_mismatch_frac=round(box_wmis, 5),
                      box_d_p999_same_weight=float(
                          np.quantile(d_diff_b, 0.999)),
                      box_d_outliers=int((d_diff_b > MAX_D_SAMEW).sum()),
                      box_d_max_same_weight=float(d_diff_b.max()))

        # 6b. mesh parity at creases. Same rim caveat: each side owns a
        # handful of marginal observation-boundary voxels the other lacks
        # (one extra grazing sample flips `observed`), so triangles exist
        # on the floor rim of one mesh only — measured 8/2353 of our
        # vertices, 14/12852 of the reference's, ALL at z=-0.4 rim. Gate
        # the bulk at stage-1b tightness + bound the rim fraction.
        rv_b = verts(os.path.join(ref_b, "gradient_sdf_mesh_final.ply"))
        ov_b = verts(os.path.join(our_b, "gradient_sdf_mesh_final.ply"))
        d_ro_b, d_or_b = nn(rv_b, ov_b), nn(ov_b, rv_b)
        report["box_mesh_ref2ours_p99"] = float(np.quantile(d_ro_b, 0.99))
        report["box_mesh_ours2ref_p99"] = float(np.quantile(d_or_b, 0.99))
        report["box_mesh_rim_frac"] = [float((d_ro_b > 0.005).mean()),
                                       float((d_or_b > 0.005).mean())]
        report["box_mesh_ours2ref_max"] = float(d_or_b.max())

        # 6c. stored gradients vs ANALYTIC box normals (crease-band
        # accuracy of our dump; the box analog of the Fig. 3 analysis)
        from gradient_sdf_tpu.analysis.gradient_analysis import analyze_boxes

        boxes = np.atleast_2d(np.loadtxt(os.path.join(bdata, "boxes.txt")))
        ares = analyze_boxes(ourd, boxes[:, :3], boxes[:, 3:], num_bins=5)
        near = [b for b in ares["stored"] if b.get("count")][0]
        report["box_grad_near_median_deg"] = near["median"]

        # 6d. tracking parity-of-failure: on the all-axis-aligned box scene
        # BOTH GN trackers oscillate at the cm level and never hit the 1e-3
        # gate (projective-TSDF bias at grazing incidence on the floor
        # slab; reference behaves identically — zero "Convergence after"
        # lines). Gate: identical zero-convergence bookkeeping AND same-
        # order error envelopes vs GT relative motion.
        ref_bt = os.path.join(opts.work, "ref_box_track") + "/"
        our_bt = os.path.join(opts.work, "ours_box_track")
        os.makedirs(ref_bt, exist_ok=True)
        r = run([opts.binary, "--input", bdata + "/", "--results", ref_bt,
                 "--pose-file", "nonexistent.txt", "--data-type", "synth",
                 "--scan-type", "grad-sdf", "--voxel-size", "0.02",
                 "--trunc", "5"])
        ref_conv = len(re.findall(r"Convergence after", r.stdout))
        run_py(
            "import runpy, sys\n"
            f"sys.argv=['scan3d','--input',{bdata!r},'--results',{our_bt!r},"
            "'--pose-file','nonexistent.txt','--data-type','synth',"
            "'--voxel-size','0.02','--trunc','5','--no-warm-start',"
            f"'--metrics-json','{our_bt}/m.json']\n"
            "runpy.run_module('gradient_sdf_tpu.apps.scan3d',"
            "run_name='__main__')")
        mb = json.load(open(os.path.join(our_bt, "m.json")))
        report["box_ref_converged_frames"] = ref_conv
        report["box_ours_invalid_frames"] = len(mb.get("invalid_frames", []))

        def rel_errs(path):
            est = tumio.read_trajectory(path)
            gtb = tumio.read_trajectory(os.path.join(bdata, "gt_poses.txt"))

            def rel(traj, i):
                import jax.numpy as jnp
                R0, t0 = jnp.asarray(traj[0][1]), jnp.asarray(traj[0][2])
                Ri, ti = jnp.asarray(traj[i][1]), jnp.asarray(traj[i][2])
                return np.asarray(
                    se3.se3_mul(*se3.se3_inv(R0, t0), Ri, ti)[1])

            return [float(np.linalg.norm(rel(est, i) - rel(gtb, i)))
                    for i in range(1, len(est))]

        errs_ref = rel_errs(os.path.join(ref_bt, "_poses.txt"))
        errs_our = rel_errs(os.path.join(our_bt, "_poses.txt"))
        report["box_track_err_max_ref"] = round(max(errs_ref), 4)
        report["box_track_err_max_ours"] = round(max(errs_our), 4)

        box_ok = (box_set <= MAX_VOXEL_SET_DELTA
                  and box_wmis <= MAX_W_MISMATCH_FRAC
                  and report["box_d_p999_same_weight"] <= MAX_D_SAMEW
                  and report["box_d_outliers"] <= 5
                  and report["box_mesh_ref2ours_p99"] <= 0.25 * 0.02
                  and report["box_mesh_ours2ref_p99"] <= 0.25 * 0.02
                  and max(report["box_mesh_rim_frac"]) <= 0.01
                  and report["box_grad_near_median_deg"] <= 5.0
                  and ref_conv == 0
                  and report["box_ours_invalid_frames"] == 5
                  and max(errs_ref) <= 0.06 and max(errs_our) <= 0.06)

    print(json.dumps(report, indent=2))
    # persist the measurement so bench.py reads the ACTUAL measured
    # reference fps for vs_measured_reference instead of a hardcoded copy
    # (re-running this harness on new hardware refreshes it). Reference
    # timings bounce ~±15% run-to-run on this host; the BEST observed fps
    # is kept as the honest comparison bar.
    path = os.path.join(REPO, "parity", "last_report.json")
    try:
        with open(path) as f:
            prev = json.load(f)
    except (OSError, ValueError):
        prev = {}
    for k in ("ref_cpu_fps", "ref_cpu_fps_omp"):
        vals = [v for v in (report.get(k), prev.get(k), prev.get(k + "_best"))
                if v]
        if vals:
            report[k + "_best"] = max(vals)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    ok = (set_delta <= MAX_VOXEL_SET_DELTA
          and w_mis <= MAX_W_MISMATCH_FRAC
          and d_err <= MAX_D_SAMEW
          and t_diff <= MAX_TRAJ_T
          and q_diff <= MAX_TRAJ_Q
          and mesh_ok
          and kf_ok is not False
          and ba_conv_ok is not False
          and ate_ok is not False
          and long_ok is not False
          and box_ok is not False
          and ba_rec_ok is not False)
    print("PARITY " + ("OK" if ok else "FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
