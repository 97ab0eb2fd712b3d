"""Sharded tracking + fusion steps (shard_map over the device mesh).

Parallelization of the two hot loops (SURVEY.md §3.1), with the grid's
per-voxel STORAGE resident-sharded over the `blocks` mesh axis: the
dist/weight/grad fields live as [num_blocks/D_b, B^3] shards on each device
(place once with `shard_grid`; fusion returns them sharded, so per-device
persistent memory is 1/D_b of the volume). Index structures (directory,
block_coords, counters) are small and replicated.

  * Tracking residual pass: pixels sharded over `rays`; block values are
    NOT all-gathered — each device resolves the residuals whose voxel slot
    falls in its resident block shard (owner-computes) and the
    (E, g, H, count) accumulators are `psum`-reduced over BOTH axes — the
    SPMD analog of the reference's OpenMP custom reductions
    (`RigidPointOptimizerOmp.cpp:41-69`). The 6x6 solve is replicated.

  * Fusion: samples sharded over (rays x blocks); every device scatter-adds
    its sample shard's contributions (sum w, sum w*sdf, sum w*Rn) into a
    transient full-size accumulator, which is `psum`(rays)-reduced and
    `psum_scatter`(blocks, tiled)-reduced so each device receives exactly
    its block shard's contribution and merges it into its RESIDENT shard —
    collectives ride NVLink. Block-table insertion runs replicated
    (deterministic claim insert, identical on every device).
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models import tracker as tracker_mod
from ..ops import fusion as fusion_mod
from ..ops import voxel_grid as vg
from ..utils import se3
from .mesh import BLOCK_AXIS, RAY_AXIS


def grid_block_specs():
    """PartitionSpec pytree for resident-sharded storage: per-voxel fields
    sharded over the block axis, index structures replicated."""
    bs = P(BLOCK_AXIS)
    return vg.VoxelGrid(
        directory=P(), coarse_occ=P(), num_active=P(), overflow=P(),
        oob_samples=P(),
        block_coords=P(), dist=bs, weight=bs,
        grad_x=bs, grad_y=bs, grad_z=bs,
    )


def shard_grid(mesh, grid: vg.VoxelGrid) -> vg.VoxelGrid:
    """Place the grid with block-sharded storage on `mesh` (call once;
    sharded_fuse_frame keeps the placement, so the volume stays 1/D_b per
    device across frames)."""
    from jax.sharding import NamedSharding

    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        grid, grid_block_specs(),
    )


def _owned_voxel_fields(grid_shard, pts, gcfg):
    """Owner-computes query against the local block shard.

    `grid_shard` is the per-device view inside shard_map: directory full
    (replicated), per-voxel fields = this device's [nb/D_b, B^3] slice.
    Returns (dist, weight, gx, gy, gz, owned) for points whose block slot
    falls in the local shard; owned=False (zero fields) elsewhere — exactly
    one device on the block axis owns each allocated voxel, so a
    psum(BLOCK_AXIS) of any owned-masked quantity recovers the global one.
    """
    vi = vg.point_to_voxel(pts, gcfg.voxel_size)
    block, local = vg.voxel_to_block(vi, gcfg)
    keys = vg.pack_key(block, gcfg)
    d3 = gcfg.dir_dim**3
    slot = grid_shard.directory[jnp.clip(keys, 0, d3 - 1)]
    slot = jnp.where(keys >= 0, slot, -1)

    nb_local = grid_shard.dist.shape[0]
    lo = jax.lax.axis_index(BLOCK_AXIS) * nb_local
    owned = (slot >= lo) & (slot < lo + nb_local)
    lin = jnp.where(owned, (slot - lo) * gcfg.voxels_per_block + local, 0)

    dist = vg.flat_field(grid_shard.dist)[lin]
    weight = vg.flat_field(grid_shard.weight)[lin]
    gx = vg.flat_field(grid_shard.grad_x)[lin]
    gy = vg.flat_field(grid_shard.grad_y)[lin]
    gz = vg.flat_field(grid_shard.grad_z)[lin]
    owned = owned & (weight > 0.0)
    z = jnp.zeros_like(dist)
    return (jnp.where(owned, dist, z), jnp.where(owned, weight, z),
            jnp.where(owned, gx, z), jnp.where(owned, gy, z),
            jnp.where(owned, gz, z), owned)


def sharded_residual_pass(mesh, grid, points_cam, z_valid, R, t, gcfg, fcfg):
    """(E, g, H, count) with pixels sharded over the ray axis and the grid
    resident-sharded over the block axis (owner-computes residual terms,
    psum over both axes); results replicated."""

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(grid_block_specs(), P(RAY_AXIS), P(RAY_AXIS), P(), P()),
        out_specs=(P(), P(), P(), P()),
    )
    def pass_(grid_shard, pts, zv, R, t):
        pts_w = se3.se3_apply(R, t, pts)
        dist, weight, gx, gy, gz, owned = _owned_voxel_fields(
            grid_shard, pts_w, gcfg
        )
        valid = zv & owned
        # semi-implicit query (query.tsdf_grad semantics, componentwise)
        inv_norm = 1.0 / jnp.maximum(
            jnp.sqrt(gx * gx + gy * gy + gz * gz), 1e-12
        )
        s = fcfg.grad_scale * inv_norm
        vi = vg.point_to_voxel(pts_w, gcfg.voxel_size)
        cmp = vi.astype(jnp.float32) * gcfg.voxel_size - pts_w
        phi = dist + s * (gx * cmp[..., 0] + gy * cmp[..., 1]
                          + gz * cmp[..., 2])
        grad = jnp.stack([s * gx, s * gy, s * gz], axis=-1)
        phi = jnp.where(valid, phi, 0.0)
        grad = jnp.where(valid[..., None], grad, 0.0)

        cross = jnp.cross(pts_w, grad)
        J = jnp.concatenate([grad, cross], axis=-1)
        E = jnp.sum(phi * phi)
        g = jnp.sum(phi[..., None] * J, axis=0)
        H = jnp.einsum("ni,nj->ij", J, J,
                       precision=jax.lax.Precision.HIGHEST)
        cnt = jnp.sum(valid.astype(jnp.int32))
        axes = (RAY_AXIS, BLOCK_AXIS)
        return (jax.lax.psum(E, axes), jax.lax.psum(g, axes),
                jax.lax.psum(H, axes), jax.lax.psum(cnt, axes))

    return pass_(grid, points_cam, z_valid, R, t)


def sharded_track_frame(mesh, grid, depth, K, R0, t0, gcfg, fcfg, tcfg):
    """Gauss-Newton tracking with the residual pass sharded over the mesh."""
    pts_cam, z = tracker_mod.backproject_grid(depth, K, tcfg.sampling)
    n_dev = mesh.devices.size
    pad = (-pts_cam.shape[0]) % n_dev
    if pad:
        pts_cam = jnp.pad(pts_cam, ((0, pad), (0, 0)))
        z = jnp.pad(z, (0, pad))
    z_valid = (z > fcfg.z_min) & (z < fcfg.z_max)
    conv_sq = tcfg.conv_threshold**2

    def cond(carry):
        R, t, k, converged = carry
        return (k < tcfg.num_iterations) & ~converged

    def body(carry):
        R, t, k, _ = carry
        E, g, H, cnt = sharded_residual_pass(
            mesh, grid, pts_cam, z_valid, R, t, gcfg, fcfg
        )
        xi = tcfg.damping * jnp.linalg.solve(H + 1e-12 * jnp.eye(6), g)
        small = jnp.sum(xi * xi) < conv_sq
        bad = jnp.any(jnp.isnan(xi))
        dR, dt = se3.se3_exp(-xi)
        Rn, tn = se3.se3_mul(dR, dt, R, t)
        apply = ~small & ~bad
        return (
            jnp.where(apply, Rn, R),
            jnp.where(apply, tn, t),
            k + 1,
            small,
        )

    R, t, k, converged = jax.lax.while_loop(
        cond, body,
        (jnp.asarray(R0, jnp.float32), jnp.asarray(t0, jnp.float32),
         jnp.int32(0), jnp.asarray(False)),
    )
    return R, t, converged, k


def sharded_fuse_frame(mesh, grid, depth, cache, R, t, gcfg, fcfg,
                       *, touched_cap: int = 0):
    """Fusion with samples sharded over (rays x blocks) and the grid's
    per-voxel storage RESIDENT-sharded over the block axis: the returned
    grid keeps block-sharded dist/weight/grad (place the initial grid with
    `shard_grid` and per-device volume memory stays 1/D_b across frames).

    Block allocation runs replicated (deterministic claim insert). The
    per-frame contribution collective is COMPACT: the frame's touched-block
    set (one tiny [num_blocks] psum) is enumerated identically on every
    device, samples scatter into a [touched_cap, B^3] accumulator, ONE psum
    over both axes reduces it, and each device merges the rows it owns into
    its resident shard — collective bytes scale with the frame's touched
    blocks, not the grid capacity (a VGA frame touches a few hundred
    blocks; capacity is 2^14). Frames touching more than `touched_cap`
    blocks fall back to the full-capacity psum+psum_scatter path
    (lax.cond, identical results). `touched_cap` 0 = auto
    (min(num_blocks, 4096)); equality vs the single-device path and the
    fallback are CPU-mesh-tested in tests/test_parallel.py.
    """
    normals_img = fusion_mod.compute_normals(cache, depth)
    s = fusion_mod._sample_frame(depth, normals_img, cache, R, t, gcfg, fcfg)

    grid = vg.insert_keys(grid, s.keys, gcfg)
    grid = grid._replace(oob_samples=grid.oob_samples + s.oob)

    n_dev = mesh.devices.size
    pad = (-s.keys.shape[0]) % n_dev
    if pad:
        s = fusion_mod.FrameSamples(
            keys=jnp.pad(s.keys, (0, pad), constant_values=vg.EMPTY_KEY),
            local_lin=jnp.pad(s.local_lin, (0, pad)),
            w=jnp.pad(s.w, (0, pad)),
            wd=jnp.pad(s.wd, (0, pad)),
            wn_x=jnp.pad(s.wn_x, (0, pad)),
            wn_y=jnp.pad(s.wn_y, (0, pad)),
            wn_z=jnp.pad(s.wn_z, (0, pad)),
            oob=s.oob,
        )

    nb = grid.num_blocks
    nvox = nb * grid.voxels_per_block
    vpb = gcfg.voxels_per_block
    cap = int(touched_cap) if touched_cap > 0 else min(nb, 4096)
    axes = (RAY_AXIS, BLOCK_AXIS)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(grid_block_specs(),) + (P((RAY_AXIS, BLOCK_AXIS)),) * 7,
        out_specs=grid_block_specs(),
    )
    def accumulate(grid_shard, keys, local_lin, w, wd, wnx, wny, wnz):
        d3 = gcfg.dir_dim**3
        slot = grid_shard.directory[jnp.clip(keys, 0, d3 - 1)]
        slot = jnp.where(keys >= 0, slot, -1)
        ok = slot >= 0
        nb_local = grid_shard.dist.shape[0]
        lo = jax.lax.axis_index(BLOCK_AXIS) * nb_local

        def merge(w_acc, wd_acc, gx_acc, gy_acc, gz_acc):
            # merge into the RESIDENT shard (stays sharded on block axis)
            new_weight = grid_shard.weight + w_acc
            new_dist = jnp.where(
                new_weight > 0.0,
                (grid_shard.dist * grid_shard.weight + wd_acc)
                / jnp.maximum(new_weight, 1e-30),
                grid_shard.dist,
            )
            return grid_shard._replace(
                dist=new_dist, weight=new_weight,
                grad_x=grid_shard.grad_x + gx_acc,
                grad_y=grid_shard.grad_y + gy_acc,
                grad_z=grid_shard.grad_z + gz_acc,
            )

        # the frame's touched-block set, identical on every device (tiny
        # [nb] int psum = 4*nb bytes, negligible next to the field traffic)
        touched = jnp.zeros((nb,), jnp.int32).at[
            jnp.where(ok, slot, nb)].max(1, mode="drop")
        touched = jax.lax.psum(touched, axes)
        count = jnp.sum((touched > 0).astype(jnp.int32))
        (tidx,) = jnp.nonzero(touched > 0, size=cap, fill_value=nb)
        inv = jnp.full((nb + 1,), -1, jnp.int32).at[tidx].set(
            jnp.arange(cap, dtype=jnp.int32))

        def compact_path(_):
            # samples scatter into the compact [cap, B^3] accumulator; one
            # psum over both axes; each device keeps the rows it owns.
            # inv[nb] may hold a padded-tidx write, but only non-ok samples
            # index it and they are masked by `ok`.
            cslot = inv[jnp.where(ok, slot, nb)]
            ok_c = ok & (cslot >= 0)
            lin = jnp.where(ok_c, cslot * vpb + local_lin, cap * vpb)
            owned = (tidx >= lo) & (tidx < lo + nb_local)
            dest_row = jnp.where(owned, tidx - lo, nb_local)
            outs = []
            for vals in (w, wd, wnx, wny, wnz):
                a = jnp.zeros((cap * vpb,), jnp.float32).at[lin].add(
                    vals, mode="drop")
                a = jax.lax.psum(a, axes)
                buf = jnp.zeros((nb_local, vpb), jnp.float32).at[
                    dest_row].add(a.reshape(cap, vpb), mode="drop")
                outs.append(buf.reshape(grid_shard.dist.shape))
            return merge(*outs)

        def full_path(_):
            # fallback: transient full-size accumulator, psum(rays) + tiled
            # psum_scatter(blocks) hands each device its resident slice
            lin = jnp.where(ok, slot * vpb + local_lin, nvox)
            accs = []
            for vals in (w, wd, wnx, wny, wnz):
                a = jnp.zeros((nvox,), jnp.float32).at[lin].add(
                    vals, mode="drop")
                a = jax.lax.psum(a, RAY_AXIS)
                a = jax.lax.psum_scatter(a, BLOCK_AXIS, tiled=True)
                accs.append(a.reshape(grid_shard.dist.shape))
            return merge(*accs)

        return jax.lax.cond(count <= cap, compact_path, full_path, None)

    return accumulate(
        grid, s.keys, s.local_lin, s.w, s.wd, s.wn_x, s.wn_y, s.wn_z
    )


def sharded_track_and_fuse_frame(mesh, grid, depth, K, R0, t0, cache, gcfg,
                                 fcfg, tcfg, *, R_prev2=None, t_prev2=None,
                                 warm_alpha: float = 1.0):
    """ONE jitted program for a full multi-device Scan3D frame: sharded GN
    tracking followed by `lax.cond`-gated sharded fusion at the refined
    pose — the mesh analog of `tracker.track_and_fuse_frame` (same
    main_scan_3d.cpp:258-266 semantics: non-converged frames are not
    fused). The grid stays resident-sharded on the block axis through both
    branches, so per-device volume memory remains 1/D_b.

    Returns (grid, R, t, converged, num_iters).
    """
    if R_prev2 is not None:
        R0, t0 = tracker_mod.extrapolate_pose(R0, t0, R_prev2, t_prev2,
                                              warm_alpha)
    R, t, conv, iters = sharded_track_frame(
        mesh, grid, depth, K, R0, t0, gcfg, fcfg, tcfg
    )
    grid = jax.lax.cond(
        conv,
        lambda g: sharded_fuse_frame(mesh, g, depth, cache, R, t, gcfg, fcfg),
        lambda g: g,
        grid,
    )
    return grid, R, t, conv, iters


# ---------------------------------------------------------------------------
# sharded rendering (rays are the embarrassingly parallel axis — SURVEY.md
# §5.7 names ray sharding as the first scale-out axis)
# ---------------------------------------------------------------------------


def sharded_render_depth_normal(mesh, grid, K, R, t, width, height,
                                gcfg, fcfg, *, s_min=0.1, s_max=5.0,
                                active_cap: int = 0, **kw):
    """Render depth/normal/hit images with RAYS sharded over the whole mesh
    and the grid's per-voxel storage resident-sharded on the block axis.

    The march gathers voxels at data-dependent positions every step, so
    owner-computes would cost one collective per step; instead each device
    assembles the per-voxel fields ONCE per render and sphere traces its
    private ray slice with the stock single-device `raycast` — identical
    results to an unsharded render, wall-clock ~1/n_devices.

    `active_cap` bounds the per-render collective: block slots are a dense
    allocation prefix [0, num_active), so with cap >= num_active only the
    first `cap` block rows need to move — each device contributes its
    owned rows of the prefix and ONE psum over the block axis assembles
    the [cap, B^3] fields (collective bytes scale with the ACTIVE volume,
    not the 2^14-block capacity; same capacity-vs-work compaction the
    fusion collective uses). The caller supplies a host-known cap
    (`num_active` rounded up to a retrace rung, bench/app style); 0 = full
    capacity all_gather. A cap below num_active does not read garbage —
    directory entries >= cap are masked to unallocated, those blocks
    render as empty (caller contract violation, bounded effect).

    Returns (depth [H,W], normal [H,W,3], hit [H,W]) replicated.
    """
    from ..ops import raycast as rc_mod

    origins, dirs, inv_hnorm = rc_mod.camera_rays(K, R, t, width, height)
    n = origins.shape[0]
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    if pad:
        origins = jnp.pad(origins, ((0, pad), (0, 0)))
        # padded rays point along +z with s_end = s_min: they march zero
        # steps and are dropped after the shard_map
        dirs = jnp.concatenate(
            [dirs, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                            (pad, 1))], axis=0)
    ray_spec = P((RAY_AXIS, BLOCK_AXIS))
    nb = grid.num_blocks
    cap = min(int(active_cap), nb) if active_cap > 0 else 0

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(grid_block_specs(), ray_spec, ray_spec),
        out_specs=(ray_spec, ray_spec, ray_spec),
        # the march while_loop mixes replicated-constant carry inits with
        # ray-varying updates; skip the varying-axes consistency check
        # (results are per-ray local — no cross-device reduction to get
        # wrong)
        check_vma=False,
    )
    def render(grid_shard, o, d):
        if cap and cap < nb:
            # active-prefix assembly: each device owns a contiguous slot
            # range; its intersection with the prefix [0, cap) scatters
            # into a [cap+1, B^3] buffer (row `cap` absorbs the rest) and
            # one psum sums the disjoint contributions
            nb_local = grid_shard.dist.shape[0]
            lo = jax.lax.axis_index(BLOCK_AXIS) * nb_local
            rows = lo + jnp.arange(nb_local, dtype=jnp.int32)
            dest = jnp.where(rows < cap, rows, cap)

            def prefix(field):
                buf = jnp.zeros((cap + 1,) + field.shape[1:], field.dtype)
                buf = buf.at[dest].add(field, mode="drop")
                return jax.lax.psum(buf, BLOCK_AXIS)[:cap]

            full = grid_shard._replace(
                # mask slots beyond the prefix (none exist when the caller
                # honors cap >= num_active; bounded miss otherwise)
                directory=jnp.where(grid_shard.directory < cap,
                                    grid_shard.directory, -1),
                dist=prefix(grid_shard.dist),
                weight=prefix(grid_shard.weight),
                grad_x=prefix(grid_shard.grad_x),
                grad_y=prefix(grid_shard.grad_y),
                grad_z=prefix(grid_shard.grad_z),
            )
        else:
            full = grid_shard._replace(
                dist=jax.lax.all_gather(
                    grid_shard.dist, BLOCK_AXIS, tiled=True),
                weight=jax.lax.all_gather(
                    grid_shard.weight, BLOCK_AXIS, tiled=True),
                grad_x=jax.lax.all_gather(
                    grid_shard.grad_x, BLOCK_AXIS, tiled=True),
                grad_y=jax.lax.all_gather(
                    grid_shard.grad_y, BLOCK_AXIS, tiled=True),
                grad_z=jax.lax.all_gather(
                    grid_shard.grad_z, BLOCK_AXIS, tiled=True),
            )
        res = rc_mod.raycast(full, o, d, gcfg, fcfg,
                             s_min=s_min, s_max=s_max, **kw)
        return res.depth, res.normal, res.hit

    depth, normal, hit = render(grid, origins, dirs)
    depth = (depth[:n] * inv_hnorm).reshape(height, width)
    return (depth, normal[:n].reshape(height, width, 3),
            hit[:n].reshape(height, width))


# ---------------------------------------------------------------------------
# sharded photometric bundle adjustment
# ---------------------------------------------------------------------------


def _ba_problem_spec(vspec):
    """PartitionSpec pytree for BAProblem with voxel arrays on `vspec`."""
    from ..models import photo_ba as pba

    return pba.BAProblem(
        vox=vspec, grad=vspec, weight=vspec, vmask=vspec, vis=vspec,
        images=P(), K=P(),
    )


def _ba_state_spec(vspec):
    from ..models import photo_ba as pba

    return pba.BAState(dist=vspec, R=P(), t=P())


def sharded_ba_step(mesh, problem, state, gcfg, pcfg):
    """One PhotoBA iteration (pose step + dist step) with the surface-voxel
    axis sharded across the mesh — the "sharded Gauss-Newton" of the north
    star: per-frame 6x6 pose systems are psum-reduced over voxel shards,
    the per-voxel scalar dist solves are embarrassingly parallel, and poses
    stay replicated.

    Requires problem.vox.shape[0] divisible by the mesh size (build_problem
    pads to a multiple of 1024, so pad `pad_to` accordingly).
    """
    from ..models import photo_ba as pba

    axes = (RAY_AXIS, BLOCK_AXIS)
    vspec = P(axes)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(_ba_problem_spec(vspec), _ba_state_spec(vspec)),
        out_specs=(_ba_state_spec(vspec), P(), P()),
    )
    def step(problem, state):
        # pose step: per-voxel terms (counts, means over frames) are local
        # to each voxel shard; only the per-frame (H, b) need the psum
        frame_AJ, n, inv_n, mean_A, xs = pba._pose_terms(
            problem, state, gcfg, pcfg
        )

        def per_frame(carry, xsi):
            Ri, ti, img, vis_i, _ = xsi
            A, Jc, valid = frame_AJ(Ri, ti, img, vis_i)
            w = (valid & (n > 0)).astype(jnp.float32)
            r = A - mean_A
            b = jax.lax.psum(
                jnp.einsum("v,vc,vce->e", w, r, Jc,
                           precision=jax.lax.Precision.HIGHEST), axes)
            H = jax.lax.psum(
                jnp.einsum("v,vce,vcf->ef", w * (1.0 - inv_n), Jc, Jc,
                           precision=jax.lax.Precision.HIGHEST), axes
            )
            return carry, (H, b)

        _, (H, b) = jax.lax.scan(per_frame, None, xs)
        delta = jax.vmap(
            lambda Hi, bi: jnp.linalg.solve(Hi + 1e-12 * jnp.eye(6), bi)
        )(H, b)
        state = pba._apply_pose_delta(state, delta)

        e_pose = jax.lax.psum(pba.energy(problem, state, gcfg), axes)
        # dist step: per-voxel scalar solves, fully local to each shard
        state = pba.solve_dist(problem, state, gcfg, pcfg)
        e_dist = jax.lax.psum(pba.energy(problem, state, gcfg), axes)
        return state, e_pose, e_dist

    return step(problem, state)
