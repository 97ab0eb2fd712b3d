"""Frame-to-model rigid camera tracking: Gauss-Newton on SE(3).

Re-designs `RigidPointOptimizer::optimize_sampled`
(`cpp/include/sdf_tracker/RigidPointOptimizer.cpp:40-98`) as a single jitted
`lax.while_loop`: each iteration is one fully-vectorized residual pass over
all (optionally strided) pixels — backproject, transform by the current pose,
query the semi-implicit SDF (one gather), accumulate
(E, g, H) = (sum phi^2, sum phi*J, sum J J^T) with J = [grad, p x grad] —
followed by a replicated 6x6 solve and a left-multiplicative pose update
pose <- exp(-xi) * pose. The reduction replaces the reference's custom
OpenMP vecsum/matsum reductions (`RigidPointOptimizerOmp.cpp:41-69`); on a
device mesh the same accumulators are `psum`-reduced over the ray axis
(see parallel/sharding.py).

Semantics preserved exactly:
  * pixels gated by z in (z_min, z_max) and map weight > 0 (:65, :72);
  * at most `num_iterations` (25) iterations; converged when
    ||xi||^2 < conv_threshold^2 *before* applying the update (:86-91);
  * NaN xi updates are skipped but iteration continues (:94-95);
  * returns converged flag — non-converged frames are not fused
    (`main_scan_3d.cpp:258-266`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FusionConfig, GridConfig, TrackerConfig
from ..ops import query
from ..ops import voxel_grid as vg
from ..utils import se3


class TrackResult(NamedTuple):
    R: jax.Array          # (3,3) refined camera-to-world rotation
    t: jax.Array          # (3,)
    converged: jax.Array  # bool
    num_iters: jax.Array  # int32 iterations executed
    energy: jax.Array     # f32 final sum of squared residuals
    num_valid: jax.Array  # int32 residual count in final iteration


def _pack_fields(grid):
    """[nvox, 8] row-packed field array (dist, weight, gx, gy, gz, 0, 0, 0)
    rebuilt once per tracked frame: every GN iteration then needs ONE row
    gather instead of 5 element gathers (plus the directory lookup) —
    dense build ~1 ms at capacity, amortized over the iterations."""
    z = jnp.zeros_like(vg.flat_field(grid.dist))
    return jnp.stack(
        [vg.flat_field(grid.dist), vg.flat_field(grid.weight),
         vg.flat_field(grid.grad_x), vg.flat_field(grid.grad_y),
         vg.flat_field(grid.grad_z), z, z, z], axis=-1)


def _tsdf_grad_packed(grid, packed, points, gcfg, fcfg):
    """query.tsdf_grad semantics from the row-packed field array: identical
    math, 2 random passes (directory lookup + one [*, 8] row gather)."""
    vs = gcfg.voxel_size
    vi = vg.point_to_voxel(points, vs)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)
    row = packed[lin]
    dist, weight = row[..., 0], row[..., 1]
    gx, gy, gz = row[..., 2], row[..., 3], row[..., 4]
    present = present & (weight > 0.0)
    inv_norm = 1.0 / jnp.maximum(jnp.sqrt(gx * gx + gy * gy + gz * gz), 1e-12)
    s = fcfg.grad_scale * inv_norm
    cmp = vi.astype(jnp.float32) * vs - points
    phi = dist + s * (gx * cmp[..., 0] + gy * cmp[..., 1] + gz * cmp[..., 2])
    grad = jnp.stack([s * gx, s * gy, s * gz], axis=-1)
    phi = jnp.where(present, phi, 0.0)
    grad = jnp.where(present[..., None], grad, 0.0)
    weight = jnp.where(present, weight, 0.0)
    return phi, grad, weight


def _residual_pass(grid, points_cam, z_valid, R, t, gcfg, fcfg, mode="grad",
                   packed=None):
    """One linearization pass: returns (E, g, H, count).

    mode="grad": semi-implicit gradient-SDF query (flagship path).
    mode="trilinear": 8-corner interpolation, the base-sdf ablation
    (`--scan-type base-sdf`, tracked through `MapPixelSdf::tsdf`)."""
    pts = se3.se3_apply(R, t, points_cam)
    if mode == "grad":
        # the reference calls weights() then tsdf() on the same voxel
        # (RigidPointOptimizer.cpp:72-75); one gather serves both here
        if packed is not None:
            phi, grad, w0 = _tsdf_grad_packed(grid, packed, pts, gcfg, fcfg)
        else:
            phi, grad, w0 = query.tsdf_grad(grid, pts, gcfg, fcfg)
        valid = z_valid & (w0 > 0.0)
    else:
        phi, grad, full = query.tsdf_trilinear(grid, pts, gcfg, fcfg)
        valid = z_valid & full
    phi = jnp.where(valid, phi, 0.0)
    grad = jnp.where(valid[..., None], grad, 0.0)

    cross = jnp.cross(pts, grad)
    J = jnp.concatenate([grad, cross], axis=-1)  # [N, 6]
    E = jnp.sum(phi * phi)
    g = jnp.sum(phi[..., None] * J, axis=0)
    H = jnp.einsum("ni,nj->ij", J, J, precision=jax.lax.Precision.HIGHEST)
    return E, g, H, jnp.sum(valid.astype(jnp.int32))


def adaptive_compact_cap(depth, fcfg, *, slack: float = 1.3,
                         floor: float = 0.125,
                         ceil_frac: float = 0.5) -> float:
    """Pick `TrackerConfig.compact_cap_frac` from a frame's depth-valid
    fraction (host-side, numpy).

    The compacted GN buffer is STATIC, so every iteration's random-access
    traffic scales with the CAP, not the frame's actual valid count.
    `slack`*fraction,
    rounded UP to a 1/8 grid so caps are stable across frames; frames
    that exceed the cap anyway fall back to the full-width loop (exact
    semantics either way). Scenes denser than `ceil_frac` return 0.0
    (compaction disabled — the fallback would fire every frame and the
    per-frame nonzero pass is pure overhead there)."""
    import math

    d = np.asarray(depth)
    frac = float(np.mean((d > fcfg.z_min) & (d < fcfg.z_max)))
    target = frac * slack
    if target > ceil_frac:
        return 0.0
    return max(floor, math.ceil(target * 8.0) / 8.0)


def extrapolate_pose(R1, t1, R2, t2, alpha: float = 1.0):
    """Constant-velocity warm start: predict the next camera-to-world pose
    from the two most recent ones, T_pred = T1 * exp(alpha * log(T2^{-1} *
    T1)) — alpha=1 is the full body-frame constant-velocity model, alpha in
    (0, 1) a geodesically damped one, alpha=0 the previous pose (the
    reference's init, `main_scan_3d.cpp:256-266`).

    STABILITY (measured on the 150-frame loop protocol): frame-to-model SDF
    tracking closes a feedback loop through fusion — the extrapolation
    seeds the next frame with (1+alpha) x the previous pose error, and on
    marginal protocols (per-frame motion near the truncation distance at
    coarse voxels) alpha=1 AMPLIFIED accumulated drift into divergence on
    the 150-frame loop protocol while the previous-pose init tracked it
    fine; alpha=0.5 matched the previous-pose init's error curve with
    fewer GN iterations. Warm starting is therefore OPT-IN (scan3d
    --warm-start, damped 0.5 when enabled bare) and never a parity or
    preset default — at --fast's stride 3 the skip-flake rate proved
    init-independent, so the preset gains nothing from it either.
    """
    R2i, t2i = se3.se3_inv(R2, t2)
    Rd, td = se3.se3_mul(R2i, t2i, R1, t1)
    if alpha != 1.0:
        xi = se3.se3_log(Rd, td) * alpha
        Rd, td = se3.se3_exp(xi)
    return se3.se3_mul(R1, t1, Rd, td)


def backproject_grid(depth: jax.Array, K, sampling: int = 1):
    """Depth image -> camera-frame points [N,3] + validity-by-depth mask.

    Mirrors the reference's per-pixel backprojection (:62-70); `sampling`
    strides pixels like `optimize_sampled`'s parameter.
    """
    H, W = depth.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    ys = jnp.arange(0, H, sampling, dtype=jnp.float32)
    xs = jnp.arange(0, W, sampling, dtype=jnp.float32)
    xg, yg = jnp.meshgrid(xs, ys)
    z = depth[::sampling, ::sampling]
    x0 = (xg - cx) / fx
    y0 = (yg - cy) / fy
    pts = jnp.stack([x0 * z, y0 * z, z], axis=-1).reshape(-1, 3)
    return pts, z.reshape(-1)


def track_frame(
    grid: vg.VoxelGrid,
    depth: jax.Array,
    K: jax.Array,
    R0: jax.Array,
    t0: jax.Array,
    gcfg: GridConfig,
    fcfg: FusionConfig,
    tcfg: TrackerConfig,
    mode: str = "grad",
) -> TrackResult:
    """Refine pose (R0, t0) against the current map for one depth frame."""
    pts_cam, z = backproject_grid(depth, K, tcfg.sampling)
    z_valid = (z > fcfg.z_min) & (z < fcfg.z_max)
    conv_sq = tcfg.conv_threshold * tcfg.conv_threshold
    packed = (_pack_fields(grid)
              if (mode == "grad"
                  and getattr(tcfg, "packed_row_gather", False))
              else None)

    def gn_loop(pts, valid):
        def cond(carry):
            R, t, k, converged, E, cnt = carry
            return (k < tcfg.num_iterations) & ~converged

        def body(carry):
            R, t, k, converged, _, _ = carry
            E, g, H, cnt = _residual_pass(grid, pts, valid, R, t, gcfg,
                                          fcfg, mode, packed=packed)
            # Gauss-Newton step; tiny diagonal floor keeps the solve finite
            # when H is singular (no residuals) — xi is then ~0 and
            # NaN-gated anyway.
            xi = tcfg.damping * jnp.linalg.solve(
                H + 1e-12 * jnp.eye(6, dtype=H.dtype), g
            )
            small = jnp.sum(xi * xi) < conv_sq
            bad = jnp.any(jnp.isnan(xi))
            dR, dt = se3.se3_exp(-xi)
            Rn, tn = se3.se3_mul(dR, dt, R, t)
            apply = ~small & ~bad
            R = jnp.where(apply, Rn, R)
            t = jnp.where(apply, tn, t)
            return R, t, k + 1, small, E, cnt

        init = (
            jnp.asarray(R0, jnp.float32),
            jnp.asarray(t0, jnp.float32),
            jnp.int32(0),
            jnp.asarray(False),
            jnp.float32(0.0),
            jnp.int32(0),
        )
        return jax.lax.while_loop(cond, body, init)

    # z-gating is pose-independent, so the surviving pixels can be compacted
    # ONCE before the GN loop — every iteration's ~6 random-access passes
    # (directory lookup + 5 field gathers) then scale with the frame's
    # depth-valid count instead of the full strided pixel count. Frames
    # with more valid pixels than the buffer fall back to full width.
    n = pts_cam.shape[0]
    cap = int(n * float(getattr(tcfg, "compact_cap_frac", 0.0)))
    if 0 < cap < n:
        count = jnp.sum(z_valid.astype(jnp.int32))
        (idx,) = jnp.nonzero(z_valid, size=cap, fill_value=0)
        mask = jnp.arange(cap, dtype=jnp.int32) < count
        pts_c = pts_cam[idx]

        R, t, k, converged, E, cnt = jax.lax.cond(
            count <= cap,
            lambda: gn_loop(pts_c, mask),
            lambda: gn_loop(pts_cam, z_valid),
        )
    else:
        R, t, k, converged, E, cnt = gn_loop(pts_cam, z_valid)
    return TrackResult(R=R, t=t, converged=converged, num_iters=k, energy=E, num_valid=cnt)


def track_and_fuse_frame(grid, depth, K, R0, t0, cache, gcfg, fcfg, tcfg,
                         mode: str = "grad", R_prev2=None, t_prev2=None,
                         warm_alpha: float = 1.0):
    """ONE jitted program for a full Scan3D frame: GN tracking followed by
    `lax.cond`-gated fusion of the refined pose (non-converged frames are
    not fused — main_scan_3d.cpp:258-266 semantics preserved exactly).

    With (R_prev2, t_prev2) — the pose BEFORE (R0, t0) — tracking starts
    from the constant-velocity extrapolation `extrapolate_pose(R0, t0,
    R_prev2, t_prev2, warm_alpha)` instead of (R0, t0); computed inside
    the program so the warm start costs no extra dispatch (see
    extrapolate_pose's stability note for why alpha<1 is the app default).

    Rationale: the app's python-level `if res.converged:` between the two
    programs forces a device->host sync mid-frame. Merging lets the fusion
    dispatch ride the same program. (Pipelining track(n+1) with fuse(n)
    would remove the same host sync, but at the price of tracking against
    a one-frame-stale map.)
    """
    from ..ops import fusion

    if R_prev2 is not None:
        R0, t0 = extrapolate_pose(R0, t0, R_prev2, t_prev2, warm_alpha)
    res = track_frame(grid, depth, K, R0, t0, gcfg, fcfg, tcfg, mode=mode)
    grid = jax.lax.cond(
        res.converged,
        lambda g: fusion.fuse_frame(
            g, depth, cache, res.R, res.t, gcfg, fcfg,
            accumulate_gradients=(mode == "grad")),
        lambda g: g,
        grid,
    )
    return grid, res
