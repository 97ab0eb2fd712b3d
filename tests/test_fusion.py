import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gradient_sdf_tpu.config import GridConfig, FusionConfig
from gradient_sdf_tpu.ops import voxel_grid as vg
from gradient_sdf_tpu.ops import fusion, normals, query
from gradient_sdf_tpu.utils import se3
from gradient_sdf_tpu.data import synth

from oracle import fuse_oracle

# small camera for fast CPU tests
W, H = 64, 48
K = np.array([[52.5, 0, 31.5], [0, 52.5, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=2048)
FCFG = FusionConfig(trunc_voxels=5.0)


@pytest.fixture(scope="module")
def world():
    return synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 0.0], [0.35, 0.2, -0.1]], jnp.float32),
        radii=jnp.asarray([0.25, 0.15], jnp.float32),
    )


@pytest.fixture(scope="module")
def cache():
    return normals.build_cache(W, H, K, window=5)


def make_pose(i=0):
    poses = synth.orbit_poses(n=8, radius=1.5)
    return poses[i]


def test_fusion_matches_oracle(world, cache):
    R, t = make_pose(0)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    nrm = normals.compute_normals(cache, depth)

    grid = vg.create(GCFG)
    grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)

    state = fuse_oracle(
        np.asarray(depth), np.asarray(nrm), np.asarray(cache.x0),
        np.asarray(cache.y0), np.asarray(cache.n_sq_inv), R, t,
        GCFG.voxel_size, FCFG.trunc_voxels * GCFG.voxel_size,
    )
    assert len(state) > 100

    # every oracle voxel exists in the grid with matching values
    vox = np.array(list(state.keys()), dtype=np.int32)
    lin, present = vg.lookup_voxels(grid, jnp.asarray(vox), GCFG)
    assert np.all(np.asarray(present))
    dist = np.asarray(vg.flat_field(grid.dist)[lin])
    weight = np.asarray(vg.flat_field(grid.weight)[lin])
    grad = np.asarray(vg.flat_field(grid.grad)[lin])
    exp_d = np.array([state[tuple(v)]["dist"] for v in vox])
    exp_w = np.array([state[tuple(v)]["weight"] for v in vox])
    exp_g = np.array([state[tuple(v)]["grad"] for v in vox])
    np.testing.assert_allclose(weight, exp_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist, exp_d, rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(grad, exp_g, rtol=1e-3, atol=1e-4)

    # and the grid has no extra occupied voxels
    total_w = float(jnp.sum(grid.weight))
    assert abs(total_w - exp_w.sum()) < 1e-2 * max(1.0, exp_w.sum())


def test_two_frame_fusion_matches_oracle(world, cache):
    grid = vg.create(GCFG)
    state = None
    for i in range(2):
        R, t = make_pose(i)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        nrm = normals.compute_normals(cache, depth)
        grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)
        state = fuse_oracle(
            np.asarray(depth), np.asarray(nrm), np.asarray(cache.x0),
            np.asarray(cache.y0), np.asarray(cache.n_sq_inv), R, t,
            GCFG.voxel_size, FCFG.trunc_voxels * GCFG.voxel_size,
            state=state, frame_id=i,
        )
    vox = np.array(list(state.keys()), dtype=np.int32)
    lin, present = vg.lookup_voxels(grid, jnp.asarray(vox), GCFG)
    assert np.all(np.asarray(present))
    dist = np.asarray(vg.flat_field(grid.dist)[lin])
    weight = np.asarray(vg.flat_field(grid.weight)[lin])
    exp_d = np.array([state[tuple(v)]["dist"] for v in vox])
    exp_w = np.array([state[tuple(v)]["weight"] for v in vox])
    np.testing.assert_allclose(weight, exp_w, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dist, exp_d, rtol=1e-3, atol=3e-5)


def test_fused_sdf_approximates_analytic(world, cache):
    """After fusing several GT-pose frames, the stored dist/grad at
    near-surface voxels should approximate the analytic sphere SDF."""
    grid = vg.create(GCFG)
    for i in range(4):
        R, t = make_pose(i * 2)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        grid = fusion.fuse_frame(grid, depth, cache, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)

    na = int(grid.num_active)
    assert na > 10
    vox = vg.block_local_to_voxel(grid.block_coords[:na], GCFG).reshape(-1, 3)
    w = np.asarray(grid.weight[:na]).reshape(-1)
    d = np.asarray(grid.dist[:na]).reshape(-1)
    g = np.asarray(grid.grad[:na]).reshape(-1, 3)
    pts = np.asarray(vox) * GCFG.voxel_size
    sdf_true, grad_true = synth.sphere_sdf(world, jnp.asarray(pts, jnp.float32))
    sdf_true = np.asarray(sdf_true)
    grad_true = np.asarray(grad_true)

    # focus on well-observed voxels near the surface
    sel = (w >= 0.8) & (np.abs(sdf_true) < 1.5 * GCFG.voxel_size)
    assert sel.sum() > 50
    # reference sign convention: projective SDF is NEGATIVE in observed free
    # space and positive behind the surface (weight fn Sdf.h:76-85 gives w=1
    # for sdf<=0), i.e. dist ~ -(outside-positive Euclidean SDF), scaled up
    # by ray obliqueness (the paper's 1.2 heuristic corrects this at query
    # time, MapGradPixelSdf.h:111-114)
    err = np.abs(d[sel] + sdf_true[sel])
    assert np.median(err) < GCFG.voxel_size  # dist within one voxel

    gn = g[sel] / np.maximum(np.linalg.norm(g[sel], axis=-1, keepdims=True), 1e-12)
    # stored gradients are inward normals => compare against -grad_true
    cos = np.sum(gn * (-grad_true[sel]), axis=-1)
    assert np.median(cos) > 0.99  # < ~8 deg median angle error


def test_visibility_bits(world, cache):
    grid = vg.create(GCFG)
    vis = jnp.zeros((GCFG.num_blocks, GCFG.voxels_per_block, 2), jnp.uint32)
    R, t = make_pose(0)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    grid, vis = fusion.fuse_frame(
        grid, depth, cache, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG,
        vis=vis, kf_slot=jnp.int32(33),
    )
    vis_np = np.asarray(vis)
    # bit 1 of word 1 set exactly where weight > 0
    w = np.asarray(grid.weight)
    marked = (vis_np[..., 1] >> 1) & 1
    np.testing.assert_array_equal(marked.astype(bool), w > 0)
    assert np.all(vis_np[..., 0] == 0)

    # non-keyframe update leaves vis unchanged
    grid2, vis2 = fusion.fuse_frame(
        grid, depth, cache, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG,
        vis=vis, kf_slot=jnp.int32(-1),
    )
    np.testing.assert_array_equal(np.asarray(vis2), vis_np)


def test_chunked_compaction_matches_full(world, cache):
    """Valid-ray compaction (FusionConfig.compact_chunk_rays) is exact: same
    block slot order, same state, same vis bits as a full-frame pass."""
    f_chunk = FusionConfig(trunc_voxels=5.0, compact_chunk_rays=512)
    f_full = FusionConfig(trunc_voxels=5.0, compact_chunk_rays=0)
    ga, gb = vg.create(GCFG), vg.create(GCFG)
    for i in range(3):
        R, t = make_pose(i)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        ga = fusion.fuse_frame(ga, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, f_full)
        gb = fusion.fuse_frame(gb, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, f_chunk)
    assert int(ga.num_active) == int(gb.num_active)
    np.testing.assert_array_equal(np.asarray(ga.block_coords),
                                  np.asarray(gb.block_coords))
    np.testing.assert_allclose(np.asarray(gb.weight), np.asarray(ga.weight),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gb.dist), np.asarray(ga.dist),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gb.grad), np.asarray(ga.grad),
                               rtol=1e-4, atol=1e-5)

    vis_a = jnp.zeros(ga.dist.shape + (2,), jnp.uint32)
    vis_b = jnp.zeros(gb.dist.shape + (2,), jnp.uint32)
    R, t = make_pose(3)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    _, va = fusion.fuse_frame(ga, depth, cache, jnp.asarray(R), jnp.asarray(t),
                              GCFG, f_full, vis=vis_a, kf_slot=jnp.int32(5))
    _, vb = fusion.fuse_frame(gb, depth, cache, jnp.asarray(R), jnp.asarray(t),
                              GCFG, f_chunk, vis=vis_b, kf_slot=jnp.int32(5))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


def test_median_blur_depth_option(world, cache):
    """FusionConfig.median_blur_depth pre-filters the sampled depth (the
    reference's intended-but-dead cv::medianBlur, MapGradPixelSdf.cpp:53)."""
    f_med = FusionConfig(trunc_voxels=5.0, median_blur_depth=True)
    R, t = make_pose(0)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    # salt a single pixel with extreme depth noise: median kills it
    noisy = depth.at[24, 32].set(3.4)
    ga = fusion.fuse_frame(vg.create(GCFG), noisy, cache, jnp.asarray(R),
                           jnp.asarray(t), GCFG, f_med)
    gb = fusion.fuse_frame(vg.create(GCFG), noisy, cache, jnp.asarray(R),
                           jnp.asarray(t), GCFG, FCFG)
    # the outlier allocates a far block without the median (normals window
    # rejects some neighborhood either way); with it, no 3.4 m geometry
    vox_a = vg.block_local_to_voxel(
        ga.block_coords[: int(ga.num_active)], GCFG).reshape(-1, 3)
    w_a = np.asarray(ga.weight[: int(ga.num_active)]).reshape(-1)
    pts_a = np.asarray(vox_a) * GCFG.voxel_size
    r_a = np.linalg.norm(pts_a[w_a > 0] - np.asarray(t), axis=-1)
    assert r_a.max() < 2.5  # scene sits ~1.5 m from the camera


def test_fusion_beyond_world_range_counts_and_recovers():
    """Geometry outside the directory's world range is counted
    (grid.oob_samples) and integrates after vg.grow_directory — no silent
    loss (reference equivalence: unbounded map, MapGradPixelSdf.h:65-68)."""
    import dataclasses

    gcfg = dataclasses.replace(GCFG, dir_dim=16)  # +-1.28 m world range
    # sphere at 2 m: every surface sample is out of range
    far_world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
        radii=jnp.asarray([0.3], jnp.float32),
    )
    cache2 = normals.build_cache(W, H, K, window=5)
    R = jnp.eye(3, dtype=jnp.float32)
    t = jnp.zeros(3, jnp.float32)
    depth = synth.render_depth(far_world, R, t, K, W, H)

    grid = vg.create(gcfg)
    grid = fusion.fuse_frame(grid, depth, cache2, R, t, gcfg, FCFG)
    assert int(grid.oob_samples) > 1000
    assert int(grid.num_active) == 0

    grid, gcfg = vg.grow_directory(grid, gcfg)  # +-2.56 m
    assert int(grid.oob_samples) == 0
    grid = fusion.fuse_frame(grid, depth, cache2, R, t, gcfg, FCFG)
    assert int(grid.oob_samples) == 0
    assert int(grid.num_active) > 10


def test_grad_sdf_map_auto_grows_directory():
    """GradSdfMap.update grows the directory when a frame reports
    out-of-range samples."""
    from gradient_sdf_tpu import config as cfg_mod
    from gradient_sdf_tpu.models.grad_sdf import GradSdfMap
    import dataclasses

    cfg = cfg_mod.PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, voxel_size=0.02, num_blocks=2048,
                                 dir_dim=16),
    )
    far_world = synth.SphereWorld(
        centers=jnp.asarray([[0.0, 0.0, 2.0]], jnp.float32),
        radii=jnp.asarray([0.3], jnp.float32),
    )
    R = np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    depth = synth.render_depth(far_world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    m = GradSdfMap(cfg)
    m.update(depth, K, (jnp.asarray(R), jnp.asarray(t)))
    assert m.cfg.grid.dir_dim == 32          # grew after the first frame
    m.update(depth, K, (jnp.asarray(R), jnp.asarray(t)))
    assert int(m.grid.num_active) >= 4       # second frame integrates
    assert int(m.grid.oob_samples) == 0


def test_fusion_stride_unbiased_quarter_weight(world, cache):
    """fusion_stride=2 integrates every other pixel: per-voxel weights drop
    ~4x, dist/grad means stay unbiased (close to full-res fusion)."""
    import dataclasses

    f2 = dataclasses.replace(FCFG, fusion_stride=2)
    ga, gb = vg.create(GCFG), vg.create(GCFG)
    for i in range(3):
        R, t = make_pose(i)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
        ga = fusion.fuse_frame(ga, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, FCFG)
        gb = fusion.fuse_frame(gb, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, f2)
    wa = float(jnp.sum(ga.weight))
    wb = float(jnp.sum(gb.weight))
    assert 0.15 * wa < wb < 0.4 * wa  # ~quarter total weight

    # voxels well-observed in BOTH runs carry nearly the same mean dist
    wa_f = np.asarray(vg.flat_field(ga.weight))
    wb_f = np.asarray(vg.flat_field(gb.weight))
    lin_a, _ = vg.lookup_voxels(
        ga, vg.block_local_to_voxel(
            gb.block_coords[: int(gb.num_active)], GCFG).reshape(-1, 3), GCFG)
    # compare on voxels present in the strided run with weight in both
    da = np.asarray(vg.flat_field(ga.dist)[lin_a])
    db = np.asarray(vg.flat_field(gb.dist)[: int(gb.num_active) * 512])
    sa = wa_f[np.asarray(lin_a)]
    sb = wb_f[: int(gb.num_active) * 512]
    # tiny 64x48 fixture -> small absolute weights
    sel = (sa > 0.5) & (sb > 0.12)
    assert sel.sum() > 50
    assert np.median(np.abs(da[sel] - db[sel])) < 0.25 * GCFG.voxel_size


def test_rows8_accumulator_matches_default(world, cache):
    """acc_rows8 (one [N,8]-row scatter-add for all five fields) must equal
    the five-scatter layout bitwise-in-semantics: same adds, same order."""
    import dataclasses

    fcfg8 = dataclasses.replace(FCFG, acc_rows8=True)
    ref = vg.create(GCFG)
    r8 = vg.create(GCFG)
    for i in range(3):
        R, t = make_pose(i)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                   K, W, H)
        ref = fusion.fuse_frame(ref, depth, cache, jnp.asarray(R),
                                jnp.asarray(t), GCFG, FCFG)
        r8 = fusion.fuse_frame(r8, depth, cache, jnp.asarray(R),
                               jnp.asarray(t), GCFG, fcfg8)
    assert int(r8.num_active) == int(ref.num_active)
    np.testing.assert_allclose(np.asarray(r8.weight), np.asarray(ref.weight),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r8.dist), np.asarray(ref.dist),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r8.grad), np.asarray(ref.grad),
                               rtol=1e-5, atol=1e-6)
    # uncompacted single-pass path too
    fcfg8_nc = dataclasses.replace(fcfg8, compact_chunk_rays=0)
    fcfg_nc = dataclasses.replace(FCFG, compact_chunk_rays=0)
    R, t = make_pose(0)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    a = fusion.fuse_frame(vg.create(GCFG), depth, cache, jnp.asarray(R),
                          jnp.asarray(t), GCFG, fcfg_nc)
    b = fusion.fuse_frame(vg.create(GCFG), depth, cache, jnp.asarray(R),
                          jnp.asarray(t), GCFG, fcfg8_nc)
    np.testing.assert_allclose(np.asarray(b.dist), np.asarray(a.dist),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(b.weight), np.asarray(a.weight),
                               rtol=1e-6, atol=1e-6)


def test_dedup_lookup_matches_default(world, cache):
    """dedup_lookup (slots gathered only at per-ray block-key changes,
    forward-filled) must produce bit-identical fused state."""
    import dataclasses

    fcfgd = dataclasses.replace(FCFG, dedup_lookup=True)
    ref = vg.create(GCFG)
    ded = vg.create(GCFG)
    for i in range(3):
        R, t = make_pose(i)
        depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t),
                                   K, W, H)
        ref = fusion.fuse_frame(ref, depth, cache, jnp.asarray(R),
                                jnp.asarray(t), GCFG, FCFG)
        ded = fusion.fuse_frame(ded, depth, cache, jnp.asarray(R),
                                jnp.asarray(t), GCFG, fcfgd)
    assert int(ded.num_active) == int(ref.num_active)
    np.testing.assert_array_equal(np.asarray(ded.weight),
                                  np.asarray(ref.weight))
    np.testing.assert_array_equal(np.asarray(ded.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(ded.grad), np.asarray(ref.grad))

    # raw slot equality incl. the overflow fallback path (cap_per_ray=1
    # forces full-width fallback)
    R, t = make_pose(1)
    depth = synth.render_depth(world, jnp.asarray(R), jnp.asarray(t), K, W, H)
    normal_img = fusion.compute_normals(cache, depth)
    rays = fusion._pixel_rays(depth, normal_img, cache, FCFG)
    s = fusion._ray_samples(rays, jnp.asarray(R), jnp.asarray(t), GCFG, FCFG)
    kk = 2 * int(FCFG.trunc_voxels) + 1
    a = vg.lookup_keys(ref, s.keys, GCFG)
    b = vg.lookup_keys_dedup(ref, s.keys, GCFG, kk)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    c = vg.lookup_keys_dedup(ref, s.keys, GCFG, kk, cap_per_ray=1)
    np.testing.assert_array_equal(np.asarray(c), np.asarray(a))
