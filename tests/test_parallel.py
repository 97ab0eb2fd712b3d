"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gradient_sdf_tpu.config import GridConfig, FusionConfig, TrackerConfig
from gradient_sdf_tpu.ops import voxel_grid as vg
from gradient_sdf_tpu.ops import fusion, normals
from gradient_sdf_tpu.models import tracker
from gradient_sdf_tpu.parallel import mesh as mesh_mod
from gradient_sdf_tpu.parallel import sharding
from gradient_sdf_tpu.data import synth

W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=2048)
FCFG = FusionConfig(trunc_voxels=5.0)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def scene():
    world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.3, 0.2, -0.1]], jnp.float32),
        radii=jnp.asarray([0.25, 0.15], jnp.float32),
    )
    cache = normals.build_cache(W, H, K, window=5)
    poses = synth.orbit_poses(n=8, radius=1.5)
    return world, cache, poses


@pytest.mark.parametrize("block_parallel", [1, 2])
def test_sharded_fusion_matches_single_device(scene, block_parallel):
    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=block_parallel)
    R, t = poses[0]
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)

    ref = vg.create(GCFG)
    ref = fusion.fuse_frame(ref, depth, cache, jnp.asarray(R), jnp.asarray(t),
                            GCFG, FCFG)

    par = vg.create(GCFG)
    par = sharding.sharded_fuse_frame(mesh, par, depth, cache, jnp.asarray(R),
                                      jnp.asarray(t), GCFG, FCFG)

    assert int(par.num_active) == int(ref.num_active)
    np.testing.assert_allclose(np.asarray(par.weight), np.asarray(ref.weight),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(par.dist), np.asarray(ref.dist),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(par.grad), np.asarray(ref.grad),
                               rtol=1e-4, atol=1e-5)


def test_sharded_tracking_matches_single_device(scene):
    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=2)
    grid = vg.create(GCFG)
    for i in range(3):
        R, t = poses[i]
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R),
                                 jnp.asarray(t), GCFG, FCFG)

    R, t = poses[1]
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    tcfg = TrackerConfig(num_iterations=5)
    res = tracker.track_frame(grid, depth, jnp.asarray(K), jnp.asarray(R),
                              jnp.asarray(t), GCFG, FCFG, tcfg)
    Rp, tp, conv, iters = sharding.sharded_track_frame(
        mesh, grid, depth, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
        GCFG, FCFG, tcfg,
    )
    np.testing.assert_allclose(np.asarray(Rp), np.asarray(res.R), atol=2e-5)
    np.testing.assert_allclose(np.asarray(tp), np.asarray(res.t), atol=2e-5)


def test_sharded_photoba_step_matches_single_device():
    import sys, os
    sys.path.insert(0, os.path.dirname(__file__))
    from test_photo_ba import _make_plane_problem, GCFG as BA_GCFG, PCFG

    from gradient_sdf_tpu.models import photo_ba

    problem, state, _ = _make_plane_problem(F=3, seed=7, pose_noise=0.004)
    # pad voxel axis to a multiple of 8 for the mesh
    V = problem.vox.shape[0]
    pad = (-V) % 8
    if pad:
        import numpy as _np

        def padv(a, fill=0):
            w = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            return jnp.asarray(_np.pad(_np.asarray(a), w, constant_values=fill))

        problem = photo_ba.BAProblem(
            vox=padv(problem.vox), grad=padv(problem.grad),
            weight=padv(problem.weight), vmask=padv(problem.vmask),
            vis=padv(problem.vis), images=problem.images, K=problem.K,
        )
        state = state._replace(dist=padv(state.dist))

    # single-device reference: one pose step + one dist step
    ref = photo_ba.solve_pose(problem, state, BA_GCFG, PCFG)
    ref = photo_ba.solve_dist(problem, ref, BA_GCFG, PCFG)
    e_ref = float(photo_ba.energy(problem, ref, BA_GCFG))

    mesh = mesh_mod.make_mesh(8, block_parallel=2)
    out_state, e_pose, e_par = sharding.sharded_ba_step(
        mesh, problem, state, BA_GCFG, PCFG)
    np.testing.assert_allclose(np.asarray(out_state.R), np.asarray(ref.R),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out_state.t), np.asarray(ref.t),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(out_state.dist),
                               np.asarray(ref.dist), atol=2e-5)
    assert abs(float(e_par) - e_ref) < 1e-3 * max(e_ref, 1.0)


def test_resident_block_sharding_persists(scene):
    """Grid storage placed with shard_grid stays block-sharded through
    fusion and matches the single-device result; per-device shard = 1/D_b
    of the blocks (the ZeRO-style storage sharding of SURVEY §5.8)."""
    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=4)
    par = sharding.shard_grid(mesh, vg.create(GCFG))
    ref = vg.create(GCFG)
    for i in range(3):
        R, t = poses[i]
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        ref = fusion.fuse_frame(ref, depth, cache, jnp.asarray(R),
                                jnp.asarray(t), GCFG, FCFG)
        par = sharding.sharded_fuse_frame(mesh, par, depth, cache,
                                          jnp.asarray(R), jnp.asarray(t),
                                          GCFG, FCFG)
        rows = {s.data.shape[0] for s in par.dist.addressable_shards}
        assert rows == {GCFG.num_blocks // 4}, rows  # still resident-sharded
    np.testing.assert_allclose(np.asarray(par.weight), np.asarray(ref.weight),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(par.dist), np.asarray(ref.dist),
                               rtol=1e-4, atol=1e-6)
    # owner-computes tracking against the sharded volume == replicated
    R, t = poses[1]
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    tcfg = TrackerConfig(num_iterations=4)
    res = tracker.track_frame(ref, depth, jnp.asarray(K), jnp.asarray(R),
                              jnp.asarray(t), GCFG, FCFG, tcfg)
    Rp, tp, conv, iters = sharding.sharded_track_frame(
        mesh, par, depth, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t),
        GCFG, FCFG, tcfg,
    )
    np.testing.assert_allclose(np.asarray(Rp), np.asarray(res.R), atol=2e-5)
    np.testing.assert_allclose(np.asarray(tp), np.asarray(res.t), atol=2e-5)


@pytest.mark.parametrize("block_parallel", [1, 2])
def test_sharded_render_matches_single_device(scene, block_parallel):
    """Ray-sharded rendering against the block-sharded grid must reproduce
    the single-device render bit-for-bit semantics (same march, same
    refinement); rays are the embarrassingly parallel axis."""
    from gradient_sdf_tpu.ops import raycast

    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=block_parallel)
    grid = vg.create(GCFG)
    for i in range(3):
        R, t = poses[i]
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                   K, W, H)
        grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R),
                                 jnp.asarray(t), GCFG, FCFG)

    R, t = poses[1]
    d_ref, n_ref, h_ref = raycast.render_depth_normal(
        grid, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H,
        GCFG, FCFG, s_max=2.5, prior_stride=0,
    )
    par = sharding.shard_grid(mesh, grid)
    d_par, n_par, h_par = sharding.sharded_render_depth_normal(
        mesh, par, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H,
        GCFG, FCFG, s_max=2.5,
    )
    assert int(jnp.sum(h_ref)) > 100  # scene actually renders
    np.testing.assert_array_equal(np.asarray(h_par), np.asarray(h_ref))
    np.testing.assert_allclose(np.asarray(d_par), np.asarray(d_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(n_par), np.asarray(n_ref),
                               atol=1e-5)


def test_sharded_render_active_cap(scene):
    """Compact render collective: with active_cap >=
    num_active the per-render collective assembles only the [cap, B^3]
    active prefix (block slots are a dense allocation prefix) and results
    equal the unsharded render; the lowered program moves NO capacity-sized
    field tensor through any collective."""
    from gradient_sdf_tpu.ops import raycast

    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=2)
    grid = vg.create(GCFG)
    for i in range(2):
        R, t = poses[i]
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                   K, W, H)
        grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R),
                                 jnp.asarray(t), GCFG, FCFG)
    R, t = poses[0]
    d_ref, n_ref, h_ref = raycast.render_depth_normal(
        grid, jnp.asarray(K), jnp.asarray(R), jnp.asarray(t), W, H,
        GCFG, FCFG, s_max=2.5, prior_stride=0,
    )
    par = sharding.shard_grid(mesh, grid)
    cap = 128
    assert int(grid.num_active) <= cap < GCFG.num_blocks

    def fn(g, R, t):
        return sharding.sharded_render_depth_normal(
            mesh, g, jnp.asarray(K), R, t, W, H, GCFG, FCFG, s_max=2.5,
            active_cap=cap,
        )

    d_par, n_par, h_par = fn(par, jnp.asarray(R), jnp.asarray(t))
    assert int(jnp.sum(h_ref)) > 100
    np.testing.assert_array_equal(np.asarray(h_par), np.asarray(h_ref))
    np.testing.assert_allclose(np.asarray(d_par), np.asarray(d_ref),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(n_par), np.asarray(n_ref),
                               atol=1e-5)

    hlo = jax.jit(fn).lower(par, jnp.asarray(R), jnp.asarray(t)).as_text()
    vpb = GCFG.voxels_per_block
    # the 5 field collectives are [cap+1, B^3] psums (+1: the absorber row)
    assert hlo.count(f"tensor<{cap + 1}x{vpb}xf32>") >= 5
    # and no collective carries a capacity-sized field tensor
    full = f"tensor<{GCFG.num_blocks}x{vpb}xf32>"
    for op in ("stablehlo.all_gather", "stablehlo.all_reduce"):
        for seg in hlo.split(op)[1:]:
            assert full not in seg[:600], f"capacity-sized {op}"


@pytest.mark.parametrize("touched_cap", [256, 1])
def test_sharded_fusion_touched_compaction(scene, touched_cap):
    """Compact-collective fusion (touched_cap >= frame's touched blocks)
    and the cap-overflow fallback (touched_cap=1 forces the full-capacity
    path) both reproduce the single-device volume."""
    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=2)
    ref = vg.create(GCFG)
    par = sharding.shard_grid(mesh, vg.create(GCFG))
    for i in range(3):
        R, t = (jnp.asarray(poses[i][0]), jnp.asarray(poses[i][1]))
        depth = synth.render_depth(world, R, t, K, W, H)
        ref = fusion.fuse_frame(ref, depth, cache, R, t, GCFG, FCFG)
        par = sharding.sharded_fuse_frame(mesh, par, depth, cache, R, t,
                                          GCFG, FCFG,
                                          touched_cap=touched_cap)
    assert int(par.num_active) == int(ref.num_active)
    if touched_cap == 256:
        # the compact path must actually be in play (not the fallback)
        assert int(ref.num_active) <= touched_cap
    np.testing.assert_allclose(np.asarray(par.weight), np.asarray(ref.weight),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(par.dist), np.asarray(ref.dist),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(par.grad), np.asarray(ref.grad),
                               rtol=1e-4, atol=1e-5)


def test_sharded_fusion_collective_sized_by_touched_cap(scene):
    """The per-frame field collective is [touched_cap * B^3]-sized, not
    capacity-sized: the lowered program's all-reduces on the compact branch
    carry cap*512 elements (the full-capacity reduce only exists on the
    fallback branch, selected when a frame touches more than cap blocks)."""
    world, cache, poses = scene
    mesh = mesh_mod.make_mesh(8, block_parallel=2)
    par = sharding.shard_grid(mesh, vg.create(GCFG))
    R, t = (jnp.asarray(poses[0][0]), jnp.asarray(poses[0][1]))
    depth = synth.render_depth(world, R, t, K, W, H)
    cap = 128
    lowered = jax.jit(
        lambda g, d: sharding.sharded_fuse_frame(
            mesh, g, d, cache, R, t, GCFG, FCFG, touched_cap=cap)
    ).lower(par, depth)
    hlo = lowered.as_text()
    compact_elems = cap * GCFG.voxels_per_block
    nvox = GCFG.num_blocks * GCFG.voxels_per_block
    # both cond branches lower into the program; the runtime predicate
    # (touched count <= cap, equality-tested above) picks the compact one.
    # Structural check: the compact branch's field psums are all_reduces of
    # tensor<cap*B^3 x f32> — 1/16 the capacity size here — and the only
    # full-capacity collectives are the fallback branch's.
    segs = hlo.split("stablehlo.all_reduce")
    compact_ar = [s for s in segs[1:]
                  if f"tensor<{compact_elems}xf32>" in s[:600]]
    assert len(compact_ar) >= 5, (
        f"expected >=5 compact [{compact_elems}] field all_reduces")
    full_ar = [s for s in segs[1:] if f"tensor<{nvox}xf32>" in s[:600]]
    # the fallback's 5 field psum(rays); nothing else may move nvox floats
    assert len(full_ar) <= 5, f"{len(full_ar)} full-size all_reduces"
