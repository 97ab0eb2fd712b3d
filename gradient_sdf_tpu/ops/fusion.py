"""TSDF + gradient fusion: integrate one RGB-D frame into the sparse grid.

Re-designs `MapGradPixelSdf::update` (`MapGradPixelSdf.cpp:43-122`) as one
fused, jit-compiled pass with no data-dependent control flow:

  1. FALS normals for the frame (ops.normals).
  2. Per-pixel gating: depth in (z_min, z_max); finite normal with
     ||n||^2 >= 0.1; viewing angle (n·h)^2/||h||^2 >= 0.25
     (reference lines :87, :95, :98).
  3. Every valid pixel walks 2*floor(T/vs)+1 voxel samples along its ray
     (reference :79, :101-104): sample point -> nearest voxel -> projective
     SDF = (R^T (voxel_center - t))_z - z (:105-106).
  4. Block allocation for all touched voxels (deterministic scatter-min
     insert, ops.voxel_grid), then a commutative scatter-add of
     (w, w * trunc(sdf), w * R n) per voxel.
  5. Merge with running state:  W' = W + sum(w),
     d' = (d W + sum(w * trunc_sdf)) / W',  g' = g + sum(w * R n)  — exactly
     the fixed point of the reference's sequential running mean
     (:108-116: `v.dist += (truncate(sdf) - v.dist) * w / v.weight`) but
     order-independent, so it is parallel-safe without the reference's
     `omp critical` (`MapGradPixelSdfOmp.cpp:112-121`).

Adaptive work via **valid-ray compaction**: the frame cost is
dominated by the ~6 random-access passes (1 slot lookup + 5 scatter-adds) over
all H*W*K samples, yet typically only 30-70% of pixels survive the gates.
`fuse_frame` therefore compacts the valid pixel indices (`jnp.nonzero`) and
integrates them in fixed-size chunks of `FusionConfig.compact_chunk_rays`
rays inside a `lax.while_loop` — the number of executed chunks, and hence
the random-pass traffic, scales with the frame's valid-pixel count instead
of H*W. Chunking is exact: the per-chunk state merge is associative (the
running weighted mean is linear in the accumulators) and chunk-ordered
allocation assigns block slots in the same (pixel, k) candidate order as a
single full-frame pass.

Layout: all coordinate math is carried as separate x/y/z component arrays
of shape [N] / [N, K] rather than [N, 3] arrays with a 3-wide minor axis.
Block keys are packed ONCE per sample and reused for both allocation
(claim insert) and the scatter lookup.

The per-voxel *visibility* bitmask (reference `vis_`,
`MapGradPixelSdf.h:70`, consumed by PhotoBA/ColorUpsampler) is kept as a
dense uint32 bitfield over keyframe slots: fusion marks bit `kf_slot` for
every voxel it touches when the frame was selected as a keyframe.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import FusionConfig, GridConfig
from . import voxel_grid as vg
from .filters import median_blur
from .normals import NormalEstimatorCache, compute_normals


class FrameSamples(NamedTuple):
    """Flattened per-sample fusion contributions (component arrays)."""

    keys: jax.Array       # int32 [N] packed block keys (EMPTY where invalid)
    local_lin: jax.Array  # int32 [N] intra-block voxel offset
    w: jax.Array          # f32 [N] integration weight (0 where invalid)
    wd: jax.Array         # f32 [N] w * trunc(sdf)
    wn_x: jax.Array       # f32 [N] w * (R n)_x
    wn_y: jax.Array
    wn_z: jax.Array
    oob: jax.Array        # int32 [] valid samples outside the directory range


class FrameRays(NamedTuple):
    """Flat per-pixel quantities feeding the sample walk (all [H*W])."""

    z: jax.Array        # depth
    hx: jax.Array       # ray direction x0 (camera frame, z=1 plane)
    hy: jax.Array
    nx: jax.Array       # FALS normal (camera frame; zeroed where non-finite)
    ny: jax.Array
    nz: jax.Array
    valid: jax.Array    # bool: all three reference pixel gates


def _pixel_rays(
    depth: jax.Array,
    normal_img: jax.Array,
    cache: NormalEstimatorCache,
    fcfg: FusionConfig,
) -> FrameRays:
    """Per-pixel gating (reference `MapGradPixelSdf.cpp:85-98`)."""
    z = depth
    hx, hy = cache.x0, cache.y0
    nx = normal_img[..., 0]
    ny = normal_img[..., 1]
    nz = normal_img[..., 2]

    n_finite = jnp.isfinite(nx) & jnp.isfinite(ny) & jnp.isfinite(nz)
    nx = jnp.where(n_finite, nx, 0.0)
    ny = jnp.where(n_finite, ny, 0.0)
    nz = jnp.where(n_finite, nz, 0.0)
    n_sq = nx * nx + ny * ny + nz * nz
    ndoth = nx * hx + ny * hy + nz
    valid = (
        (z > fcfg.z_min)
        & (z < fcfg.z_max)
        & n_finite
        & (n_sq >= fcfg.normal_sq_min)
        & (ndoth * ndoth * cache.n_sq_inv >= fcfg.view_angle_cos_sq)
    )
    stride = int(getattr(fcfg, "fusion_stride", 1))
    if stride > 1:
        # integrate every stride-th pixel only (FusionConfig.fusion_stride):
        # with valid-ray compaction this directly divides the random-pass
        # traffic; gates/normals above still use the full image
        hh, ww = z.shape
        row_ok = (jnp.arange(hh, dtype=jnp.int32) % stride == 0)[:, None]
        col_ok = (jnp.arange(ww, dtype=jnp.int32) % stride == 0)[None, :]
        valid = valid & row_ok & col_ok
    return FrameRays(
        z=z.reshape(-1),
        hx=jnp.broadcast_to(hx, z.shape).reshape(-1),
        hy=jnp.broadcast_to(hy, z.shape).reshape(-1),
        nx=nx.reshape(-1),
        ny=ny.reshape(-1),
        nz=nz.reshape(-1),
        valid=valid.reshape(-1),
    )


def _ray_samples(
    rays: FrameRays,
    R: jax.Array,
    t: jax.Array,
    gcfg: GridConfig,
    fcfg: FusionConfig,
) -> FrameSamples:
    """Walk 2*floor(T/vs)+1 voxel samples along each (flat) ray
    (reference :79, :101-116) -> packed keys + weighted contributions."""
    vs = gcfg.voxel_size
    inv_vs = 1.0 / vs
    b = gcfg.block_shape
    T = fcfg.trunc_voxels * vs
    factor = int(fcfg.trunc_voxels)  # floor(T / vs), reference :79
    K = 2 * factor + 1

    z, hx, hy = rays.z, rays.hx, rays.hy
    nx, ny, nz = rays.nx, rays.ny, rays.nz

    # rotated ray and normal, componentwise ([N] each)
    rh_x = R[0, 0] * hx + R[0, 1] * hy + R[0, 2]
    rh_y = R[1, 0] * hx + R[1, 1] * hy + R[1, 2]
    rh_z = R[2, 0] * hx + R[2, 1] * hy + R[2, 2]
    rn_x = R[0, 0] * nx + R[0, 1] * ny + R[0, 2] * nz
    rn_y = R[1, 0] * nx + R[1, 1] * ny + R[1, 2] * nz
    rn_z = R[2, 0] * nx + R[2, 1] * ny + R[2, 2] * nz

    ks = jnp.arange(-factor, factor + 1, dtype=jnp.float32)  # [K]
    depth_k = z[:, None] + ks * vs  # [N, K]

    px = depth_k * rh_x[:, None] + t[0]
    py = depth_k * rh_y[:, None] + t[1]
    pz = depth_k * rh_z[:, None] + t[2]
    vi_x = jnp.round(px * inv_vs).astype(jnp.int32)
    vi_y = jnp.round(py * inv_vs).astype(jnp.int32)
    vi_z = jnp.round(pz * inv_vs).astype(jnp.int32)

    # projective SDF: (R^T (c - t))_z = column 2 of R dotted with (c - t)
    sdf = (
        R[0, 2] * (vi_x.astype(jnp.float32) * vs - t[0])
        + R[1, 2] * (vi_y.astype(jnp.float32) * vs - t[1])
        + R[2, 2] * (vi_z.astype(jnp.float32) * vs - t[2])
        - z[:, None]
    )

    if getattr(fcfg, "cosine_correction", False):
        # OPT-IN accuracy correction (round 5, NON-parity — the reference
        # stores the raw projective distance, MapGradPixelSdf.cpp:95-101):
        # the camera-z difference overestimates the true signed distance
        # by 1/cos(theta) at incidence angle theta, which biases the
        # stored field on grazing surfaces — the measured root cause of
        # BOTH implementations' tracking failure on the all-planar box
        # scene (PARITY.md box stage). Scaling by the FALS-normal
        # incidence cosine stores the point-to-plane distance instead
        # (classic TSDF correction, e.g. Bylow et al. 2013). Floored at
        # 0.1 so near-silhouette samples cannot collapse the whole band
        # to zero distance.
        n_norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
        h_norm = jnp.sqrt(hx * hx + hy * hy + 1.0)
        cosang = jnp.abs(nx * hx + ny * hy + nz) / jnp.maximum(
            n_norm * h_norm, 1e-12)
        sdf = sdf * jnp.clip(cosang, 0.1, 1.0)[:, None]

    # integration weight (Sdf.h:76-85): 1 behind surface, linear drop in front
    w = jnp.where(sdf <= 0.0, 1.0, jnp.maximum(0.0, 1.0 - sdf / T))
    w = jnp.where(rays.valid[:, None], w, 0.0)
    trunc_sdf = jnp.clip(sdf, -T, T)

    bx = jnp.floor_divide(vi_x, b)
    by = jnp.floor_divide(vi_y, b)
    bz = jnp.floor_divide(vi_z, b)
    lx = vi_x - bx * b
    ly = vi_y - by * b
    lz = vi_z - bz * b
    local_lin = (lz * b + ly) * b + lx
    keys = vg.pack_key_xyz(bx, by, bz, gcfg)
    # valid samples whose block lies outside the directory's world range are
    # dropped THIS frame but counted so the driver can grow the directory
    # (vg.grow_directory) — the reference's map is unbounded
    oob = jnp.sum(((keys < 0) & (w > 0.0)).astype(jnp.int32))
    keys = jnp.where(w > 0.0, keys, vg.EMPTY_KEY)

    return FrameSamples(
        keys=keys.reshape(-1),
        local_lin=local_lin.reshape(-1),
        w=w.reshape(-1),
        wd=(w * trunc_sdf).reshape(-1),
        wn_x=(w * rn_x[:, None]).reshape(-1),
        wn_y=(w * rn_y[:, None]).reshape(-1),
        wn_z=(w * rn_z[:, None]).reshape(-1),
        oob=oob,
    )


def _sample_frame(
    depth: jax.Array,
    normal_img: jax.Array,
    cache: NormalEstimatorCache,
    R: jax.Array,
    t: jax.Array,
    gcfg: GridConfig,
    fcfg: FusionConfig,
) -> FrameSamples:
    """Full-frame (uncompacted) sample generation — used by the sharded
    fusion path, which shards rays across devices instead of compacting."""
    rays = _pixel_rays(depth, normal_img, cache, fcfg)
    return _ray_samples(rays, R, t, gcfg, fcfg)


def _alloc_slots(grid: vg.VoxelGrid, s: FrameSamples, gcfg: GridConfig,
                 walk_k: int = 0):
    """Block allocation + scatter-slot lookup for one sample batch.

    On steady-state batches (no unseen blocks) the whole claim/insert pass
    and its re-lookup are skipped — the initial lookup both answers
    "anything new?" and provides the scatter slots. With `walk_k` (the
    per-ray walk length, FusionConfig.dedup_lookup) the lookup gathers
    only positions where the block key CHANGES along each ray
    (vg.lookup_keys_dedup — ~4-5x fewer random reads, bit-identical).

    Returns (grid, lin, ok): flat voxel indices (out-of-map samples pointed
    one past the end so `mode="drop"` discards them) and their validity."""
    def look(g):
        if walk_k > 1:
            return vg.lookup_keys_dedup(g, s.keys, gcfg, walk_k)
        return vg.lookup_keys(g, s.keys, gcfg)

    slot0 = look(grid)
    need = (s.keys >= 0) & (slot0 < 0)

    def _with_insert(g):
        g2 = vg.insert_new(g, s.keys, need, gcfg)
        return g2, look(g2)

    def _no_insert(g):
        return g, slot0

    grid, slot = jax.lax.cond(jnp.any(need), _with_insert, _no_insert, grid)
    grid = grid._replace(oob_samples=grid.oob_samples + s.oob)
    ok = slot >= 0
    nvox = grid.num_blocks * grid.voxels_per_block
    lin = jnp.where(ok, slot * gcfg.voxels_per_block + s.local_lin, nvox)
    return grid, lin, ok


def _zero_accs(grid: vg.VoxelGrid, accumulate_gradients: bool,
               mode: str = "fields"):
    """Fresh flat per-frame accumulators (w, wd, wn_x, wn_y, wn_z): five
    [nvox] arrays, or ONE [nvox, 8] row array (rows8)."""
    nvox = grid.num_blocks * grid.voxels_per_block
    if mode == "rows8":
        return (jnp.zeros((nvox, 8), jnp.float32),)
    z = jnp.zeros((nvox,), jnp.float32)
    n_grad = 3 if accumulate_gradients else 0
    return (z, z) + (z,) * n_grad


def _scatter_samples(accs, lin, s: FrameSamples, mode: str = "fields"):
    """Scatter one batch's contributions into the frame accumulators.

    Two formulations (identical sums up to f32 add order; equality tests in
    tests/test_fusion.py):
      * "fields": five separate 1-channel scatter-adds;
      * "rows8": ONE [N, 8]-row scatter-add.
    Accumulators are *carried* across compacted chunks so the dense
    zero-init/merge passes run once per frame, not once per chunk. On a GPU
    the scatter-adds are atomic, so float32 sums are taken in no fixed
    order."""
    if mode == "rows8":
        z = jnp.zeros_like(s.w)
        payload = jnp.stack(
            [s.w, s.wd, s.wn_x, s.wn_y, s.wn_z, z, z, z], axis=-1)
        return (accs[0].at[lin].add(payload, mode="drop"),)
    vals = (s.w, s.wd, s.wn_x, s.wn_y, s.wn_z)
    return tuple(a.at[lin].add(v, mode="drop")
                 for a, v in zip(accs, vals))


def _merge_accumulators(grid: vg.VoxelGrid, accs, accumulate_gradients: bool):
    """One dense merge of the frame accumulators into the running state:
    W' = W + sum(w), d' = (d W + sum(w trunc_sdf)) / W', g' = g + sum(w R n)
    — the order-independent fixed point of the reference's sequential
    running mean (MapGradPixelSdf.cpp:108-116)."""
    shape = grid.dist.shape
    if len(accs) == 1:  # rows8: unpack the row accumulator
        a = accs[0]
        accs = (a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4])
    w_acc = accs[0].reshape(shape)
    wd_acc = accs[1].reshape(shape)
    new_weight = grid.weight + w_acc
    new_dist = jnp.where(
        new_weight > 0.0,
        (grid.dist * grid.weight + wd_acc) / jnp.maximum(new_weight, 1e-30),
        grid.dist,
    )
    if accumulate_gradients:
        grid = grid._replace(
            grad_x=grid.grad_x + accs[2].reshape(shape),
            grad_y=grid.grad_y + accs[3].reshape(shape),
            grad_z=grid.grad_z + accs[4].reshape(shape),
        )
    return grid._replace(dist=new_dist, weight=new_weight)


def _merge_vis(grid: vg.VoxelGrid, vis, touched_flat, kf_slot):
    """OR the frame's touched-voxel mask into keyframe-slot `kf_slot` of the
    visibility bitfield (negative slot = not a keyframe -> unchanged)."""
    shape = grid.dist.shape
    touched = touched_flat.reshape(shape).astype(jnp.uint32)
    kslot = jnp.asarray(kf_slot, jnp.int32)
    word = jnp.clip(kslot // 32, 0, vis.shape[-1] - 1)
    bit = (kslot % 32).astype(jnp.uint32)
    mark = jnp.where(kslot >= 0, touched << bit, jnp.uint32(0))
    onehot = (jnp.arange(vis.shape[-1], dtype=jnp.int32) == word)
    return vis | jnp.where(onehot, mark[..., None], jnp.uint32(0))


def _integrate_samples(grid, s: FrameSamples, gcfg, accumulate_gradients,
                       vis, kf_slot, mode="fields", walk_k=0):
    """Allocate + scatter + merge one batch of samples (and mark vis)."""
    grid, lin, ok = _alloc_slots(grid, s, gcfg, walk_k)
    accs = _zero_accs(grid, accumulate_gradients, mode)
    accs = _scatter_samples(accs, lin, s, mode)
    grid = _merge_accumulators(grid, accs, accumulate_gradients)

    if vis is not None:
        nvox = grid.num_blocks * grid.voxels_per_block
        touched = jnp.zeros((nvox,), jnp.int32).at[lin].max(
            ok.astype(jnp.int32), mode="drop"
        )
        vis = _merge_vis(grid, vis, touched, kf_slot)
    return grid, vis


def _gather_ray_chunk(rays: FrameRays, idx: jax.Array, start, chunk: int,
                      count) -> FrameRays:
    """Slice `chunk` compacted ray indices at `start` and gather their
    per-pixel data; rays past `count` are masked invalid."""
    ii = jax.lax.dynamic_slice(idx, (start,), (chunk,))
    mask = (start + jnp.arange(chunk, dtype=jnp.int32)) < count
    return FrameRays(
        z=rays.z[ii], hx=rays.hx[ii], hy=rays.hy[ii],
        nx=rays.nx[ii], ny=rays.ny[ii], nz=rays.nz[ii],
        valid=mask,
    )


def fuse_frame(
    grid: vg.VoxelGrid,
    depth: jax.Array,
    cache: NormalEstimatorCache,
    R: jax.Array,
    t: jax.Array,
    gcfg: GridConfig,
    fcfg: FusionConfig,
    *,
    vis: Optional[jax.Array] = None,
    kf_slot: Optional[jax.Array] = None,
    accumulate_gradients: bool = True,
):
    """Integrate one depth frame under pose (R, t) (camera-to-world).

    Returns the updated grid (and updated vis bitfield if given).
    `vis` is uint32 [num_blocks, B^3, kf_words]; `kf_slot` the keyframe slot
    to mark (negative = not a keyframe -> vis unchanged).
    `accumulate_gradients=False` gives the baseline TSDF fusion
    (`MapPixelSdf::update`, MapPixelSdf.cpp:114-189: identical gating and
    dist/weight updates, no gradient) — used by the base-sdf ablation path.
    """
    normal_img = compute_normals(cache, depth)
    if fcfg.median_blur_depth:
        depth = median_blur(depth, 5)
    rays = _pixel_rays(depth, normal_img, cache, fcfg)
    n_rays = rays.z.shape[0]
    chunk = int(fcfg.compact_chunk_rays)
    stride = int(getattr(fcfg, "fusion_stride", 1))
    if chunk > 0 and stride > 1:
        # expected valid count scales ~1/stride^2; shrink the work quantum
        chunk = max(8 * 1024, chunk // (stride * stride))

    # per-frame accumulator layout: five [nvox] fields, or one [nvox, 8]
    # row array (FusionConfig.acc_rows8)
    mode = "rows8" if fcfg.acc_rows8 else "fields"
    walk_k = ((2 * int(fcfg.trunc_voxels) + 1)
              if getattr(fcfg, "dedup_lookup", False) else 0)
    if chunk <= 0 or chunk >= n_rays:
        # single full-frame pass (no compaction)
        s = _ray_samples(rays, R, t, gcfg, fcfg)
        grid, vis = _integrate_samples(
            grid, s, gcfg, accumulate_gradients, vis, kf_slot, mode, walk_k
        )
        return (grid, vis) if vis is not None else grid

    count = jnp.sum(rays.valid.astype(jnp.int32))
    # compacted valid-pixel indices, padded so fixed-size chunk slices never
    # clamp (a clamped dynamic_slice would re-integrate earlier rays)
    (idx,) = jnp.nonzero(rays.valid, size=n_rays, fill_value=0)
    idx = idx.astype(jnp.int32)
    pad = (-n_rays) % chunk
    if pad:
        idx = jnp.pad(idx, (0, pad))

    has_vis = vis is not None
    nvox = grid.num_blocks * grid.voxels_per_block
    accs0 = _zero_accs(grid, accumulate_gradients, mode)
    touched0 = (jnp.zeros((nvox,), jnp.int32) if has_vis
                else jnp.zeros((0,), jnp.int32))

    # accumulators are CARRIED across chunks and merged once after the loop
    # (algebraically identical to per-chunk merging — the running weighted
    # mean is linear in the accumulators — but the dense zero-init/merge
    # passes over all num_blocks*B^3 voxels leave the loop, dropping the
    # fixed per-chunk cost from ~2.5 ms to the random-pass cost alone)
    def cond(carry):
        start = carry[0]
        return start < count

    def body(carry):
        start, g, accs, touched = carry
        rc = _gather_ray_chunk(rays, idx, start, chunk, count)
        s = _ray_samples(rc, R, t, gcfg, fcfg)
        g, lin, ok = _alloc_slots(g, s, gcfg, walk_k)
        accs = _scatter_samples(accs, lin, s, mode)
        if has_vis:
            touched = touched.at[lin].max(ok.astype(jnp.int32), mode="drop")
        return start + chunk, g, accs, touched

    _, grid, accs, touched = jax.lax.while_loop(
        cond, body, (jnp.int32(0), grid, accs0, touched0)
    )
    grid = _merge_accumulators(grid, accs, accumulate_gradients)
    if has_vis:
        vis = _merge_vis(grid, vis, touched, kf_slot)
        return grid, vis
    return grid
