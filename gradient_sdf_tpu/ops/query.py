"""SDF queries: semi-implicit (gradient-SDF) and trilinear (baseline).

`tsdf_grad` is the paper's core idea (reference `MapGradPixelSdf::tsdf`,
`MapGradPixelSdf.h:109-115`): the distance at an arbitrary point is the
*nearest voxel's* stored distance plus a first-order correction along the
stored (normalized) gradient — no 8-corner interpolation, one gather per
query. The 1.2 factor is the reference's stated heuristic correcting
projective-SDF scaling; it is `FusionConfig.grad_scale` here.

`tsdf_trilinear` is the ablation baseline (`MapPixelSdf.cpp:43-111`):
8-corner trilinear interpolation with the analytic trilinear gradient,
returning -T ("extrapolated") when no corner exists and 0 when only some
corners exist. We implement the *correct* transform math (the reference's
non-OMP fusion has a double-applied transform bug at `MapPixelSdf.cpp:160`
that we do not replicate — see SURVEY.md §2 row 6).

All queries are pure gathers + elementwise math: differentiable,
vmap/shard-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import FusionConfig, GridConfig
from . import voxel_grid as vg


def tsdf_grad(grid: vg.VoxelGrid, points: jax.Array, gcfg: GridConfig,
              fcfg: FusionConfig):
    """Semi-implicit SDF query at world points (…,3).

    Returns (phi (…,), grad (…,3), weight (…,)). Missing voxels give
    weight 0 (callers gate on weight like the reference tracker does,
    `RigidPointOptimizer.cpp:72-75`); their phi/grad are zeros.
    """
    vs = gcfg.voxel_size
    vi = vg.point_to_voxel(points, vs)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)

    dist = vg.flat_field(grid.dist)[lin]
    weight = vg.flat_field(grid.weight)[lin]
    # component gathers, one per scalar field
    gx = vg.flat_field(grid.grad_x)[lin]
    gy = vg.flat_field(grid.grad_y)[lin]
    gz = vg.flat_field(grid.grad_z)[lin]
    # block allocation granularity is 8^3: a voxel "exists" (reference: has a
    # hash entry, MapGradPixelSdf.h:117-125) only if it was ever observed
    present = present & (weight > 0.0)

    inv_norm = 1.0 / jnp.maximum(jnp.sqrt(gx * gx + gy * gy + gz * gz), 1e-12)
    scale = fcfg.grad_scale
    s = scale * inv_norm
    cmp = vi.astype(jnp.float32) * vs - points  # voxel_center - point
    phi = dist + s * (gx * cmp[..., 0] + gy * cmp[..., 1] + gz * cmp[..., 2])
    grad = jnp.stack([s * gx, s * gy, s * gz], axis=-1)

    phi = jnp.where(present, phi, 0.0)
    grad = jnp.where(present[..., None], grad, 0.0)
    weight = jnp.where(present, weight, 0.0)
    return phi, grad, weight


def weights_at(grid: vg.VoxelGrid, points: jax.Array, gcfg: GridConfig):
    """Nearest-voxel fusion weight (reference `MapGradPixelSdf::weights`,
    `MapGradPixelSdf.h:117-125`): 0 where the voxel is unallocated."""
    vi = vg.point_to_voxel(points, gcfg.voxel_size)
    lin, present = vg.lookup_voxels(grid, vi, gcfg)
    w = vg.flat_field(grid.weight)[lin]
    return jnp.where(present, w, 0.0)


def tsdf_trilinear(grid: vg.VoxelGrid, points: jax.Array, gcfg: GridConfig,
                   fcfg: FusionConfig):
    """Trilinear TSDF query (baseline `MapPixelSdf::tsdf`,
    `MapPixelSdf.cpp:43-111`).

    Returns (phi (…,), grad (…,3), valid (…,)). Semantics:
      * all 8 corners allocated -> trilinear value + analytic gradient,
      * no corner allocated      -> phi = -T (extrapolation), invalid,
      * partial coverage         -> phi = 0, invalid.
    """
    vs = gcfg.voxel_size
    T = fcfg.trunc_voxels * vs
    # voxel centers sit at vs*i; the cell containing p has lower corner
    # base = floor(p/vs), and frac is p's position between the two centers
    base = jnp.floor(points / vs).astype(jnp.int32)  # (…,3)
    frac = jnp.clip(points / vs - base.astype(jnp.float32), 0.0, 1.0)

    offs = jnp.stack(
        jnp.meshgrid(
            jnp.arange(2, dtype=jnp.int32),
            jnp.arange(2, dtype=jnp.int32),
            jnp.arange(2, dtype=jnp.int32),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(8, 3)  # corner offsets (x-major order below)

    corners = base[..., None, :] + offs  # (…,8,3)
    lin, present = vg.lookup_voxels(grid, corners, gcfg)
    d = vg.flat_field(grid.dist)[lin]  # (…,8)
    w = vg.flat_field(grid.weight)[lin]
    present = present & (w > 0.0)  # existence = observed (see tsdf_grad)
    d = jnp.where(present, d, 0.0)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = jnp.stack([1 - fx, fx], axis=-1)  # (…,2)
    wy = jnp.stack([1 - fy, fy], axis=-1)
    wz = jnp.stack([1 - fz, fz], axis=-1)
    # corner weight for offset (i,j,k): wx[i] * wy[j] * wz[k]
    cw = (
        wx[..., offs[:, 0]] * wy[..., offs[:, 1]] * wz[..., offs[:, 2]]
    )  # (…,8)
    phi = jnp.sum(cw * d, axis=-1)

    # analytic trilinear gradient (d interp / d point), chain rule 1/vs
    dwx = jnp.stack([-jnp.ones_like(fx), jnp.ones_like(fx)], axis=-1)
    gx = jnp.sum(dwx[..., offs[:, 0]] * wy[..., offs[:, 1]] * wz[..., offs[:, 2]] * d, axis=-1)
    gy = jnp.sum(wx[..., offs[:, 0]] * dwx[..., offs[:, 1]] * wz[..., offs[:, 2]] * d, axis=-1)
    gz = jnp.sum(wx[..., offs[:, 0]] * wy[..., offs[:, 1]] * dwx[..., offs[:, 2]] * d, axis=-1)
    grad = jnp.stack([gx, gy, gz], axis=-1) / vs

    num_present = jnp.sum(present, axis=-1)
    full = num_present == 8
    none = num_present == 0
    phi = jnp.where(full, phi, jnp.where(none, -T, 0.0))
    grad = jnp.where(full[..., None], grad, 0.0)
    return phi, grad, full


def weights_trilinear(grid: vg.VoxelGrid, points: jax.Array, gcfg: GridConfig):
    """Minimum corner weight; 0 unless all 8 corners exist
    (reference `MapPixelSdf.h:118-143`)."""
    vs = gcfg.voxel_size
    base = jnp.floor(points / vs).astype(jnp.int32)
    offs = jnp.stack(
        jnp.meshgrid(
            jnp.arange(2, dtype=jnp.int32),
            jnp.arange(2, dtype=jnp.int32),
            jnp.arange(2, dtype=jnp.int32),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(8, 3)
    corners = base[..., None, :] + offs
    lin, present = vg.lookup_voxels(grid, corners, gcfg)
    w = vg.flat_field(grid.weight)[lin]
    present = present & (w > 0.0)  # existence = observed (see tsdf_grad)
    w = jnp.where(present, w, 0.0)
    full = jnp.all(present, axis=-1)
    return jnp.where(full, jnp.min(w, axis=-1), 0.0)
