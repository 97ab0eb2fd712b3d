"""Photometric bundle adjustment: joint keyframe-pose + SDF refinement.

Re-designs `PhotometricOptimizer`
(`cpp/include/ps_optimizer/PhotometricOptimizer.{h,cpp}`) as fully
vectorized JAX passes over (surface voxel x keyframe) pairs:

  * Surface point per voxel: x_j = voxel_center - dist_j * ghat_j, projected
    into keyframe i with camera-to-world pose (R_i, t_i)
    (`getIntensity`, :238-260).
  * Residual: RGB intensity A_ij minus the per-voxel mean over visible
    keyframes (zero-mean photoconsistency — albedo eliminated analytically;
    `getEnergy`, :273-321).
  * Jacobians are the closed forms the reference hand-derives, evaluated
    batched: w.r.t. dist `Jd = dI * dpi * (-R^T g_j)` with *unnormalized* g
    ("gradient norm treated as constant", `computeJdOneFrame` :161-196);
    w.r.t. pose `Jc = [-dI dpi R^T, dI dpi skew(p)]` (`computeJc` :200-233).
    The image gradient dI is the exact derivative of the bilinear sampler,
    which coincides with the reference's bilinearly-weighted forward
    differences in the interior (`computeImageGradient` :81-139).
  * solveDist: independent scalar GN per voxel with the mean-subtraction
    folded in: H = sum J^2 - (sum J)^2/N + reg_weight * weight_j,
    b = sum A.J - (sum A).(sum J)/N, dist -= damping * b/H (:326-388).
  * solvePose: decoupled per-frame 6x6 solves with the (1 - 1/N) diagonal
    factor (:499-590); solvePoseFull assembles the full 6Fx6F system with
    -1/N cross-frame blocks (:392-496) — both provided; decoupled is the
    default like the reference (:627-628).
  * optimize(): alternate solvePose / solveDist, track energy, stop on
    relative decrease < 5e-4, abort on divergence (:611-663).

Gating preserved: voxels participate when |dist| <= voxel_size (solvePose /
energy; solveDist is ungated like the reference), per-(voxel, frame)
visibility bits from fusion, in-image projection, and the TRUNC_L2 intensity
gate max_ch A^2 > lambda^2 in the solvers but not the energy (:364, :435,
:542 vs :273-321).

Pose update convention matches the reference exactly: t -= delta_t,
R <- R * exp(-omega) (right-multiplicative, :585-589).

One deliberate deviation: the reference's keyframe bookkeeping misaligns
`key_images` (includes frame `first`) with `keyframes`/`key_poses` (exclude
it) — main_photo_ba.cpp:226-233 vs :246-254. We keep the first frame a
keyframe in *all* arrays (see apps/photo_ba_app.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GridConfig, PhotoBAConfig
from ..ops import voxel_grid as vg
from ..ops.filters import bilinear_sample_grad as _bilerp_rgb
from ..utils import se3


class BAProblem(NamedTuple):
    """Static per-run data for PhotoBA (device arrays; V voxels, F frames)."""

    vox: jax.Array       # int32 [V, 3] voxel indices
    grad: jax.Array      # f32 [V, 3] stored (unnormalized) gradients
    weight: jax.Array    # f32 [V] fusion weights
    vmask: jax.Array     # bool [V] true for real (non-padding) voxels
    vis: jax.Array       # bool [V, F] per-keyframe visibility
    images: jax.Array    # f32 [F, H, W, 3]
    K: jax.Array         # f32 [3, 3]


class BAState(NamedTuple):
    dist: jax.Array      # f32 [V] optimized SDF values
    R: jax.Array         # f32 [F, 3, 3] camera-to-world rotations
    t: jax.Array         # f32 [F, 3]


def _surface_points(problem: BAProblem, dist: jax.Array, voxel_size: float):
    ghat = problem.grad / jnp.maximum(
        jnp.linalg.norm(problem.grad, axis=-1, keepdims=True), 1e-12
    )
    return problem.vox.astype(jnp.float32) * voxel_size - dist[:, None] * ghat


def _per_frame_terms(problem: BAProblem, x: jax.Array, Ri, ti, img, vis_i,
                     channel_mix: bool = False):
    """All per-(voxel, frame-i) quantities: A, Jd factor pieces, validity.

    Returns dict with A [V,3], dI_dpi_cam (the 3x3 `image_grad @ pi_grad`
    matrix) [V,3,3], point_cam [V,3], valid [V].

    `channel_mix` replicates the reference's `computeImageGradient`
    channel REVERSAL (`Vec3f(v0[2],v0[1],v0[0])`,
    PhotometricOptimizer.cpp:102-126): its image gradients come back
    BGR-reversed while residuals keep native order, so each channel's
    residual pairs with another channel's gradient in the GN vector b
    (the Hessian channel sum is swap-invariant). Default OFF — we keep
    residual-consistent gradients; ON (PhotoBAConfig.channel_mix_parity)
    makes per-iteration BA steps gateable against the reference binary on
    COLORED data (on grayscale the two coincide).
    """
    K = problem.K
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Rt = Ri.T
    p = jnp.matmul(x - ti, Ri,  # = R^T (x - t) rowwise
                   precision=jax.lax.Precision.HIGHEST)
    z = p[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1.0)
    z_inv = 1.0 / safe_z
    u = fx * p[..., 0] * z_inv + cx
    v = fy * p[..., 1] * z_inv + cy
    A, dAdu, dAdv, inb = _bilerp_rgb(img, u, v)
    valid = vis_i & inb & (z > 1e-12) & problem.vmask

    # dI/dp_cam = dAdu * dpi_u/dp + dAdv * dpi_v/dp   -> [V, 3(ch), 3(xyz)]
    z_inv_sq = z_inv * z_inv
    du_dp = jnp.stack(
        [fx * z_inv, jnp.zeros_like(z_inv), -fx * p[..., 0] * z_inv_sq], axis=-1
    )  # [V,3]
    dv_dp = jnp.stack(
        [jnp.zeros_like(z_inv), fy * z_inv, -fy * p[..., 1] * z_inv_sq], axis=-1
    )
    dI_dp = dAdu[..., None] * du_dp[:, None, :] + dAdv[..., None] * dv_dp[:, None, :]
    if channel_mix:
        dI_dp = dI_dp[:, ::-1, :]
    return A, dI_dp, p, valid


def _scan_frames(problem: BAProblem, state: BAState, fn, init):
    """lax.scan over frames applying fn(carry, (R, t, img, vis_col, idx))."""
    F = problem.images.shape[0]

    def body(carry, xs):
        return fn(carry, xs), None

    xs = (state.R, state.t, problem.images,
          jnp.moveaxis(problem.vis, 1, 0), jnp.arange(F))
    carry, _ = jax.lax.scan(body, init, xs)
    return carry


def energy(problem: BAProblem, state: BAState, gcfg: GridConfig) -> jax.Array:
    """Total photometric energy (getEnergy, :273-321): voxels with
    |dist| <= voxel_size, E = sum_j sum_i |A_ij - mean_j|^2."""
    x = _surface_points(problem, state.dist, gcfg.voxel_size)
    gate = (jnp.abs(state.dist) <= gcfg.voxel_size) & problem.vmask

    def accum(carry, xs):
        Ri, ti, img, vis_i, _ = xs
        n, sA, sAA = carry
        A, _, _, valid = _per_frame_terms(problem, x, Ri, ti, img, vis_i)
        valid = valid & gate
        w = valid.astype(jnp.float32)[:, None]
        return (n + w[:, 0], sA + w * A, sAA + w * jnp.sum(A * A, axis=-1,
                                                           keepdims=True))

    z = jnp.zeros_like(problem.weight)
    n, sA, sAA = _scan_frames(
        problem, state, accum,
        (z, jnp.zeros_like(problem.grad), z[:, None]),
    )
    n_safe = jnp.maximum(n, 1.0)
    # sum_i |A_i - mean|^2 = sum|A|^2 - |sum A|^2/N >= 0 exactly; the f32
    # cancellation can leave a tiny negative when residuals ~ 0, so clamp
    e_per_vox = jnp.maximum(
        sAA[:, 0] - jnp.sum(sA * sA, axis=-1) / n_safe, 0.0)
    return jnp.sum(jnp.where(n > 0, e_per_vox, 0.0))


def solve_dist(problem: BAProblem, state: BAState, gcfg: GridConfig,
               pcfg: PhotoBAConfig) -> BAState:
    """One SDF half-step (solveDist, :326-388)."""
    x = _surface_points(problem, state.dist, gcfg.voxel_size)
    trunc_gate = pcfg.loss == "trunc_l2"
    lambda_sq = pcfg.lambda_ * pcfg.lambda_

    def accum(carry, xs):
        Ri, ti, img, vis_i, _ = xs
        n, sA, sJ, sAJ, sJJ = carry
        A, dI_dp, p, valid = _per_frame_terms(
            problem, x, Ri, ti, img, vis_i,
            channel_mix=getattr(pcfg, "channel_mix_parity", False))
        if trunc_gate:  # TRUNC_L2 intensity gate (reference :364-365)
            valid = valid & (jnp.max(A * A, axis=-1) <= lambda_sq)
        # Jd = dI_dp @ (-R^T g)  (unnormalized g, :181)
        Rtg = -jnp.matmul(problem.grad, Ri,  # rowwise R^T g
                          precision=jax.lax.Precision.HIGHEST)
        Jd = jnp.einsum("vcd,vd->vc", dI_dp, Rtg,
                        precision=jax.lax.Precision.HIGHEST)
        w = valid.astype(jnp.float32)[:, None]
        return (
            n + w[:, 0],
            sA + w * A,
            sJ + w * Jd,
            sAJ + w * A * Jd,
            sJJ + w * Jd * Jd,
        ), None

    V = x.shape[0]
    z3 = jnp.zeros_like(problem.grad)
    F = problem.images.shape[0]
    xs = (state.R, state.t, problem.images,
          jnp.moveaxis(problem.vis, 1, 0), jnp.arange(F))
    (n, sA, sJ, sAJ, sJJ), _ = jax.lax.scan(
        accum, (jnp.zeros_like(problem.weight), z3, z3, z3, z3), xs
    )
    inv_n = 1.0 / jnp.maximum(n, 1.0)
    H = jnp.sum(sJJ, axis=-1) - inv_n * jnp.sum(sJ * sJ, axis=-1)
    b = jnp.sum(sAJ, axis=-1) - inv_n * jnp.sum(sA * sJ, axis=-1)
    H = H + pcfg.reg_weight * problem.weight
    step = jnp.where((n > 0) & (H != 0.0), pcfg.damping * b / H, 0.0)
    return state._replace(dist=state.dist - step)


def _make_frame_AJ(problem: BAProblem, x: jax.Array, gate: jax.Array, pcfg):
    """Closure computing per-frame (A, Jc, valid) for given surface points."""
    trunc_gate = pcfg.loss == "trunc_l2"
    lambda_sq = pcfg.lambda_ * pcfg.lambda_

    def frame_AJ(Ri, ti, img, vis_i):
        A, dI_dp, p, valid = _per_frame_terms(
            problem, x, Ri, ti, img, vis_i,
            channel_mix=getattr(pcfg, "channel_mix_parity", False))
        valid = valid & gate
        if trunc_gate:  # TRUNC_L2 intensity gate (reference :435, :542)
            valid = valid & (jnp.max(A * A, axis=-1) <= lambda_sq)
        # Jc = [-dI_dp @ R^T | dI_dp @ skew(p)]  -> [V, 3, 6]
        left = -jnp.einsum("vcd,ed->vce", dI_dp, Ri,  # dI_dp @ R^T
                           precision=jax.lax.Precision.HIGHEST)
        sk = se3.hat(p)  # [V,3,3]
        right = jnp.einsum("vcd,vde->vce", dI_dp, sk,
                           precision=jax.lax.Precision.HIGHEST)
        Jc = jnp.concatenate([left, right], axis=-1)
        return A, Jc, valid

    return frame_AJ


def _pose_terms(problem: BAProblem, state: BAState, gcfg, pcfg):
    """Shared pass for solve_pose variants: per-voxel counts/means plus a
    function computing per-frame (A, Jc, valid)."""
    x = _surface_points(problem, state.dist, gcfg.voxel_size)
    gate = (jnp.abs(state.dist) <= gcfg.voxel_size) & problem.vmask
    frame_AJ = _make_frame_AJ(problem, x, gate, pcfg)

    # first pass: per-voxel N and mean
    def accum(carry, xs):
        Ri, ti, img, vis_i, _ = xs
        n, sA = carry
        A, _, valid = frame_AJ(Ri, ti, img, vis_i)
        w = valid.astype(jnp.float32)[:, None]
        return (n + w[:, 0], sA + w * A), None

    V = x.shape[0]
    F = problem.images.shape[0]
    xs = (state.R, state.t, problem.images,
          jnp.moveaxis(problem.vis, 1, 0), jnp.arange(F))
    zv = jnp.zeros_like(problem.weight)
    (n, sA), _ = jax.lax.scan(accum, (zv, jnp.zeros_like(problem.grad)), xs)
    inv_n = 1.0 / jnp.maximum(n, 1.0)
    mean_A = sA * inv_n[:, None]
    return frame_AJ, n, inv_n, mean_A, xs


def solve_pose(problem: BAProblem, state: BAState, gcfg: GridConfig,
               pcfg: PhotoBAConfig) -> BAState:
    """Decoupled per-frame pose half-step (solvePose, :499-590)."""
    frame_AJ, n, inv_n, mean_A, xs = _pose_terms(problem, state, gcfg, pcfg)

    def per_frame(carry, xsi):
        Ri, ti, img, vis_i, _ = xsi
        A, Jc, valid = frame_AJ(Ri, ti, img, vis_i)
        w = (valid & (n > 0)).astype(jnp.float32)
        r = A - mean_A
        b = jnp.einsum("v,vc,vce->e", w, r, Jc,
                       precision=jax.lax.Precision.HIGHEST)
        H = jnp.einsum("v,vce,vcf->ef", w * (1.0 - inv_n), Jc, Jc,
                       precision=jax.lax.Precision.HIGHEST)
        return carry, (H, b)

    _, (H, b) = jax.lax.scan(per_frame, None, xs)  # H [F,6,6], b [F,6]
    delta = jax.vmap(
        lambda Hi, bi: jnp.linalg.solve(Hi + 1e-12 * jnp.eye(6), bi)
    )(H, b)
    return _apply_pose_delta(state, delta)


def _pose_full_system(problem: BAProblem, state: BAState, gcfg: GridConfig,
                      pcfg: PhotoBAConfig, *, chunk: int = 8192):
    """Assemble the coupled 6Fx6F system (solvePoseFull, :392-496):
    diagonal blocks (1 - 1/N_j) Jc_i^T Jc_i, cross blocks
    -1/N_j Jc_i1^T Jc_i2. Returns (Hfull [6F,6F], bfull [6F]).

    The cross term needs all frames' Jacobians per voxel; materializing
    [F, V, 3, 6] once would cost F*V*72 bytes (~4 GB at F=30, V=1e5 with
    intermediates), so the voxel axis is scanned in `chunk`-sized slices:
    per slice the [F, chunk, 3, 6] Jacobian block (a few MB) is built and
    folded into the running (b [F,6], Hdiag [F,6,6], cross [F,F,6,6])
    accumulators. The assembled system is chunk-size invariant (pure sums,
    up to f32 summation order)."""
    frame_AJ, n, inv_n, mean_A, xs = _pose_terms(problem, state, gcfg, pcfg)
    F = problem.images.shape[0]
    V = problem.vox.shape[0]
    chunk = min(chunk, V)
    pad = (-V) % chunk
    C = (V + pad) // chunk

    def padded(a):
        if pad == 0:
            return a
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    # per-voxel slices reshaped to [C, chunk, ...]; the frame-indexed xs
    # (poses, images) stay whole and are re-scanned per slice
    vox_c = padded(problem.vox).reshape(C, chunk, 3)
    grad_c = padded(problem.grad).reshape(C, chunk, 3)
    vmask_c = padded(problem.vmask).reshape(C, chunk)
    weight_c = padded(problem.weight).reshape(C, chunk)
    vis_c = padded(problem.vis).reshape(C, chunk, F)
    dist_c = padded(state.dist).reshape(C, chunk)
    n_c = padded(n).reshape(C, chunk)
    invn_c = padded(inv_n).reshape(C, chunk)
    meanA_c = padded(mean_A).reshape(C, chunk, 3)

    def chunk_body(carry, xc):
        b_acc, hd_acc, cross_acc = carry
        voxs, grads, vmasks, weights, viss, dists, ns, invns, means = xc
        sub = BAProblem(vox=voxs, grad=grads, weight=weights, vmask=vmasks,
                        vis=viss, images=problem.images, K=problem.K)
        x_sub = _surface_points(sub, dists, gcfg.voxel_size)
        gate_sub = (jnp.abs(dists) <= gcfg.voxel_size) & vmasks
        sub_AJ = _make_frame_AJ(sub, x_sub, gate_sub, pcfg)

        def per_frame(c2, xsi):
            Ri, ti, img, vis_i, _ = xsi
            A, Jc, valid = sub_AJ(Ri, ti, img, vis_i)
            w = (valid & (ns > 0)).astype(jnp.float32)
            r = A - means
            b = jnp.einsum("v,vc,vce->e", w, r, Jc,
                           precision=jax.lax.Precision.HIGHEST)
            hd = jnp.einsum("v,vce,vcf->ef", w, Jc, Jc,
                            precision=jax.lax.Precision.HIGHEST)
            return c2, (b, hd, w[:, None, None] * Jc)

        sub_xs = (state.R, state.t, problem.images,
                  jnp.moveaxis(viss, 1, 0), jnp.arange(F))
        _, (b, hd, Jm) = jax.lax.scan(per_frame, None, sub_xs)
        cross = jnp.einsum("avce,v,bvcf->abef", Jm, invns, Jm,
                           precision=jax.lax.Precision.HIGHEST)
        return (b_acc + b, hd_acc + hd, cross_acc + cross), None

    init = (jnp.zeros((F, 6)), jnp.zeros((F, 6, 6)), jnp.zeros((F, F, 6, 6)))
    (b, Hdiag, cross), _ = jax.lax.scan(
        chunk_body, init,
        (vox_c, grad_c, vmask_c, weight_c, vis_c, dist_c, n_c, invn_c,
         meanA_c),
    )
    H = -cross
    diag_ix = jnp.arange(F)
    H = H.at[diag_ix, diag_ix].add(Hdiag)
    Hfull = H.transpose(0, 2, 1, 3).reshape(6 * F, 6 * F)
    bfull = b.reshape(6 * F)
    return Hfull, bfull


def solve_pose_full(problem: BAProblem, state: BAState, gcfg: GridConfig,
                    pcfg: PhotoBAConfig, *, chunk: int = 8192) -> BAState:
    """Coupled pose step: assemble the 6Fx6F system (voxel-chunked, see
    _pose_full_system) and solve."""
    F = problem.images.shape[0]
    Hfull, bfull = _pose_full_system(problem, state, gcfg, pcfg, chunk=chunk)
    delta = jnp.linalg.solve(Hfull + 1e-9 * jnp.eye(6 * F), bfull).reshape(F, 6)
    return _apply_pose_delta(state, delta)


def _apply_pose_delta(state: BAState, delta: jax.Array) -> BAState:
    """Reference update (:585-589 / :487-494): t -= dt, R <- R exp(-w);
    NaN deltas skipped per frame."""
    bad = jnp.any(jnp.isnan(delta), axis=-1)
    dt = jnp.where(bad[:, None], 0.0, delta[:, :3])
    omega = jnp.where(bad[:, None], 0.0, delta[:, 3:])
    Rd = se3.so3_exp(-omega)
    newR = jnp.einsum("fij,fjk->fik", state.R, Rd,
                      precision=jax.lax.Precision.HIGHEST)
    return state._replace(R=newR, t=state.t - dt)


class PhotometricOptimizer:
    """Driver mirroring PhotometricOptimizer::optimize (:611-663)."""

    def __init__(self, problem: BAProblem, state: BAState, gcfg: GridConfig,
                 pcfg: PhotoBAConfig, *, coupled_poses: bool = False,
                 verbose: bool = True, mesh=None, save_path=None,
                 key_stamps=None):
        self.problem = problem
        self.state = state
        self.gcfg = gcfg
        self.pcfg = pcfg
        self.energies: list = []
        self.verbose = verbose
        self.mesh = mesh  # device mesh -> voxel-sharded GN steps
        # pose-snapshot sink (reference savePoses, :592-609): directory +
        # per-keyframe timestamps; None disables the snapshot writes
        self.save_path = save_path
        self.key_stamps = key_stamps
        pose_fn = solve_pose_full if coupled_poses else solve_pose
        self._solve_pose = jax.jit(
            lambda p, s: pose_fn(p, s, gcfg, pcfg)
        )
        self._solve_dist = jax.jit(lambda p, s: solve_dist(p, s, gcfg, pcfg))
        self._energy = jax.jit(lambda p, s: energy(p, s, gcfg))

    def _iteration(self):
        """One pose+dist step; returns (E_after_pose, E_after_dist)."""
        if self.mesh is not None:
            from ..parallel import sharding

            self.state, e_pose, e_dist = sharding.sharded_ba_step(
                self.mesh, self.problem, self.state, self.gcfg, self.pcfg
            )
            return float(e_pose), float(e_dist)
        self.state = self._solve_pose(self.problem, self.state)
        e_pose = float(self._energy(self.problem, self.state))
        self.state = self._solve_dist(self.problem, self.state)
        e_dist = float(self._energy(self.problem, self.state))
        return e_pose, e_dist

    def save_poses(self, filename: str) -> bool:
        """Snapshot the CURRENT optimizer poses as a TUM trajectory —
        mirror of `PhotometricOptimizer::savePoses` (:592-609), called at
        the same points the reference calls it: once before BA (:614) and
        at every optimize() exit (:647 converge, :653 diverge, :660
        iteration cap), so a killed/aborted run still leaves the latest
        pose state on disk."""
        if self.save_path is None or self.key_stamps is None:
            return False
        import os

        import numpy as np

        from ..utils import tumio

        entries = [
            (stamp, np.asarray(self.state.R[i]), np.asarray(self.state.t[i]))
            for i, stamp in enumerate(self.key_stamps)
        ]
        tumio.write_trajectory(
            os.path.join(self.save_path, filename + ".txt"), entries)
        if self.verbose:
            print("poses file is successfully saved!")
        return True

    def optimize(self) -> bool:
        # save poses before optimization for comparison (:614)
        self.save_poses("selected_frame_poses_before_optimization")
        E = float(self._energy(self.problem, self.state))
        self.energies.append(E)
        if self.verbose:
            print(f"Energy before BA: {E}")
        for it in range(self.pcfg.max_iterations):
            e_pose, E = self._iteration()
            self.energies.append(e_pose)
            if self.verbose:
                print(f"Energy after {it} iterations of coarse BA (pose): {e_pose}")
            self.energies.append(E)
            if self.verbose:
                print(f"Energy after {it} iterations of coarse BA (dist): {E}")
            # reference (:649): rel_diff = |E_pose - E_dist| / E_pose, where
            # E_pose is the energy after this iteration's pose step
            prev = self.energies[-2]
            rel_diff = abs(prev - E) / max(prev, 1e-30)
            if rel_diff < self.pcfg.conv_threshold:
                if self.verbose:
                    print(f"converged after {it} iterations")
                self.save_poses("coarse_BA_poses_optimized")     # :647
                return True
            if self.energies[-2] < self.energies[-1]:
                if self.verbose:
                    print(f"DIVERGE after {it} iterations")
                self.save_poses("coarse_BA_poses_optimized")     # :653
                return False
        self.save_poses("coarse_BA_poses_optimized")             # :660
        return False


def build_problem(
    grid: vg.VoxelGrid,
    vis_bits: jax.Array,       # uint32 [num_blocks, B^3, words]
    kf_slots: list,            # keyframe slots to optimize over
    images: np.ndarray,        # [F, H, W, 3] float32
    poses: list,               # [(R, t)] camera-to-world per keyframe
    K: np.ndarray,
    gcfg: GridConfig,
    *,
    band_voxels: float = 3.0,
    pad_to: int = 1024,
) -> Tuple[BAProblem, BAState]:
    """Host-side compaction: select voxels near the surface
    (|dist| <= band_voxels * voxel_size and weight > 0), gather their
    visibility bits for the chosen keyframe slots, pad to a static size."""
    na = int(grid.num_active)
    vox = np.asarray(vg.block_local_to_voxel(grid.block_coords[:na], gcfg))
    vox = vox.reshape(-1, 3)
    dist = np.asarray(grid.dist[:na]).reshape(-1)
    weight = np.asarray(grid.weight[:na]).reshape(-1)
    grad = np.asarray(grid.grad[:na]).reshape(-1, 3)
    vis_np = np.asarray(vis_bits[:na]).reshape(na * vis_bits.shape[1], -1)

    sel = (weight > 0) & (np.abs(dist) <= band_voxels * gcfg.voxel_size)
    vox, dist, weight, grad = vox[sel], dist[sel], weight[sel], grad[sel]
    vis_np = vis_np[sel]

    F = len(kf_slots)
    vis = np.zeros((len(vox), F), dtype=bool)
    for i, s in enumerate(kf_slots):
        vis[:, i] = (vis_np[:, s // 32] >> (s % 32)) & 1

    V = len(vox)
    Vp = max(pad_to, int(np.ceil(V / pad_to)) * pad_to)
    pad = Vp - V

    def padded(a, fill=0):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                      constant_values=fill)

    problem = BAProblem(
        vox=jnp.asarray(padded(vox), jnp.int32),
        grad=jnp.asarray(padded(grad), jnp.float32),
        weight=jnp.asarray(padded(weight), jnp.float32),
        vmask=jnp.asarray(np.arange(Vp) < V),
        vis=jnp.asarray(padded(vis)),
        images=jnp.asarray(images, jnp.float32),
        K=jnp.asarray(K, jnp.float32),
    )
    state = BAState(
        dist=jnp.asarray(padded(dist), jnp.float32),
        R=jnp.asarray(np.stack([p[0] for p in poses]), jnp.float32),
        t=jnp.asarray(np.stack([p[1] for p in poses]), jnp.float32),
    )
    return problem, state


def write_back_dist(grid: vg.VoxelGrid, problem: BAProblem, state: BAState,
                    gcfg: GridConfig) -> vg.VoxelGrid:
    """Write optimized dist values back into the sparse grid."""
    lin, present = vg.lookup_voxels(grid, problem.vox, gcfg)
    ok = problem.vmask & present
    nvox = grid.num_blocks * grid.voxels_per_block
    lin = jnp.where(ok, lin, nvox)
    flat = vg.flat_field(grid.dist)
    flat = flat.at[lin].set(jnp.where(ok, state.dist, 0.0), mode="drop")
    return grid._replace(dist=flat.reshape(grid.dist.shape))
