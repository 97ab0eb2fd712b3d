"""Worker for the 2-process jax.distributed test (see test_distributed.py).

Each process contributes 2 virtual CPU devices -> a 4-device global
(rays, blocks) mesh spanning processes. Exercises all three sharded hot
paths with cross-process collectives on the block axis: FUSION (two frames,
storage resident-sharded, result vs process-local reference), RENDER (rays
over the whole mesh, fields gathered across processes), and TRACKING
(owner-computes GN residual psum, gated same-map vs the local tracker).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from gradient_sdf_tpu.parallel import distributed

    assert distributed.init(coordinator, num_procs, pid)
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == 2 * num_procs

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from gradient_sdf_tpu.config import FusionConfig, GridConfig
    from gradient_sdf_tpu.data import synth
    from gradient_sdf_tpu.ops import fusion, normals
    from gradient_sdf_tpu.ops import voxel_grid as vg
    from gradient_sdf_tpu.parallel import sharding

    W, H = 64, 48
    K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], np.float32)
    gcfg = GridConfig(voxel_size=0.02, num_blocks=2048)
    fcfg = FusionConfig(trunc_voxels=5.0)
    world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1]], jnp.float32),
        radii=jnp.asarray([0.25, 0.15], jnp.float32),
    )
    cache = normals.build_cache(W, H, K, window=5)
    poses = synth.orbit_poses(n=4, radius=1.5)

    # block axis spans the two processes -> storage sharded across hosts
    mesh = distributed.global_mesh(block_parallel=2)
    assert mesh.devices.shape == (2, 2)

    specs = sharding.grid_block_specs()
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: not isinstance(x, vg.VoxelGrid))
    grid = jax.jit(lambda: vg.create(gcfg), out_shardings=shardings)()

    step = jax.jit(
        lambda g, d, R, t: sharding.sharded_fuse_frame(
            mesh, g, d, cache, R, t, gcfg, fcfg
        ),
        donate_argnums=(0,),
    )

    # process-local reference on one local device
    ref = vg.create(gcfg)
    for i in range(2):
        R, t = (jnp.asarray(poses[i][0]), jnp.asarray(poses[i][1]))
        depth = synth.render_depth(world, R, t, K, W, H)
        depth_np = np.asarray(depth)
        ref = fusion.fuse_frame(ref, depth, cache, R, t, gcfg, fcfg)
        grid = step(grid, depth_np, np.asarray(poses[i][0]),
                    np.asarray(poses[i][1]))

    # each process only holds its block shard; fully-reduced scalars are
    # replicated and locally readable
    stats = jax.jit(
        lambda g: (jnp.sum(g.weight), jnp.sum(jnp.abs(g.dist)),
                   jnp.sum(g.grad_x), g.num_active),
        out_shardings=NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )(grid)
    wsum, dsum, gxsum, na = (float(stats[0]), float(stats[1]),
                             float(stats[2]), int(stats[3]))
    wref = float(jnp.sum(ref.weight))
    dref = float(jnp.sum(jnp.abs(ref.dist)))
    gxref = float(jnp.sum(ref.grad_x))
    assert na == int(ref.num_active), (na, int(ref.num_active))
    assert abs(wsum - wref) < 1e-2 * max(1.0, abs(wref)), (wsum, wref)
    assert abs(dsum - dref) < 1e-2 * max(1.0, abs(dref)), (dsum, dref)
    assert abs(gxsum - gxref) < 1e-2 * max(1.0, abs(gxref)), (gxsum, gxref)
    # resident shard is half the blocks
    rows = {s.data.shape[0] for s in grid.dist.addressable_shards}
    assert rows == {gcfg.num_blocks // 2}, rows

    # sharded RENDER across the two processes: rays map-parallel over the
    # whole 4-device mesh, block-sharded fields all-gathered over the
    # cross-process block axis; must match a local single-device render
    from gradient_sdf_tpu.ops import raycast

    Rr, tr = (jnp.asarray(poses[1][0]), jnp.asarray(poses[1][1]))
    d_par, n_par, h_par = jax.jit(
        lambda g, R, t: sharding.sharded_render_depth_normal(
            mesh, g, jnp.asarray(K), R, t, W, H, gcfg, fcfg,
            s_max=2.5, max_steps=48),
        out_shardings=NamedSharding(mesh, jax.sharding.PartitionSpec()),
    )(grid, Rr, tr)
    d_ref = raycast.render_depth_normal(
        ref, jnp.asarray(K), Rr, tr, W, H, gcfg, fcfg, s_max=2.5,
        prior_stride=0, max_steps=48)[0]
    hits = int(jnp.sum(h_par))
    assert hits > 100, hits
    derr = float(jnp.max(jnp.abs(d_par - d_ref)))
    assert derr < 1e-4, derr
    # sharded TRACKING across the two processes: pixels shard over rays,
    # residuals resolve owner-computes against the cross-process block
    # shards, (E, g, H) psum over both axes. Gated against the local
    # single-device tracker ON THE SAME MAP (the sharded volume replicated
    # and pulled to host — an independently re-fused map carries reduction-
    # order fp noise that GN amplifies, see __graft_entry__'s tracking note).
    from gradient_sdf_tpu.config import TrackerConfig
    from gradient_sdf_tpu.models import tracker as tracker_mod
    from jax.sharding import PartitionSpec as P

    rep = jax.tree.map(lambda s: NamedSharding(mesh, P()), specs,
                       is_leaf=lambda x: not isinstance(x, vg.VoxelGrid))
    grid_rep = jax.jit(lambda g: g, out_shardings=rep)(grid)
    grid_local = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), grid_rep)

    tcfg = TrackerConfig(num_iterations=5)
    depth1 = synth.render_depth(world, Rr, tr, K, W, H)
    Rt, tt, conv, iters = jax.jit(
        lambda g, d, R, t: sharding.sharded_track_frame(
            mesh, g, d, jnp.asarray(K), R, t, gcfg, fcfg, tcfg),
        out_shardings=NamedSharding(mesh, P()),
    )(grid, depth1, jnp.asarray(poses[0][0]), jnp.asarray(poses[0][1]))
    res_loc = tracker_mod.track_frame(
        grid_local, depth1, jnp.asarray(K), jnp.asarray(poses[0][0]),
        jnp.asarray(poses[0][1]), gcfg, fcfg, tcfg)
    assert int(iters) == int(res_loc.num_iters), \
        (int(iters), int(res_loc.num_iters))
    d_R = float(jnp.max(jnp.abs(Rt - res_loc.R)))
    d_t = float(jnp.max(jnp.abs(tt - res_loc.t)))
    assert d_R < 5e-4 and d_t < 5e-4, (d_R, d_t)

    print(f"DIST_OK pid={pid} active={na} wsum={wsum:.3f} "
          f"render_hits={hits} track_dR={d_R:.2e}", flush=True)


if __name__ == "__main__":
    main()
