"""PhotoBA unit + convergence tests on a tiny synthetic setup."""

import numpy as np
import jax.numpy as jnp
import pytest

from gradient_sdf_tpu.config import GridConfig, FusionConfig, PhotoBAConfig
from gradient_sdf_tpu.models import photo_ba
from gradient_sdf_tpu.ops import voxel_grid as vg
from gradient_sdf_tpu.utils import se3

W, H = 64, 48
K = np.array([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]], dtype=np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=512)
PCFG = PhotoBAConfig(max_iterations=10)


def _make_plane_problem(F=3, V=200, seed=0, pose_noise=0.0):
    """Voxels on a textured plane z=1 (world), F cameras looking at it."""
    rng = np.random.RandomState(seed)
    # voxels on the plane, gradient pointing -z (inward = away from camera)
    xs = rng.uniform(-0.3, 0.3, V)
    ys = rng.uniform(-0.2, 0.2, V)
    vox = np.round(np.stack([xs, ys, np.full(V, 1.0)], -1) / GCFG.voxel_size)
    vox = np.unique(vox.astype(np.int32), axis=0)
    V = len(vox)
    grad = np.tile([0.0, 0.0, 5.0], (V, 1)).astype(np.float32)  # inward +z
    dist = np.zeros(V, np.float32)

    # smooth random texture (bilinear-friendly)
    tex = rng.rand(6, 8, 3).astype(np.float32)
    big = np.kron(tex, np.ones((H // 6, W // 8, 1))).astype(np.float32)
    from scipy.ndimage import gaussian_filter

    img0 = gaussian_filter(big, sigma=(3, 3, 0))

    # cameras at z=0 looking +z
    poses = []
    images = []
    for i in range(F):
        t = np.array([0.02 * i, -0.01 * i, 0.0], np.float32)
        R = np.eye(3, dtype=np.float32)
        if pose_noise > 0 and i > 0:
            xi = rng.randn(6).astype(np.float32) * pose_noise
            dR, dt = se3.se3_exp(jnp.asarray(xi))
            R = np.asarray(jnp.asarray(R) @ dR)
            t = t + np.asarray(dt)
        poses.append((R, t))
        # render plane texture into this camera analytically: pixel (u,v)
        # sees plane point p = t + z*(x0,y0,1) with z chosen so p_z=1
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        x0 = (u - cx) / fx
        y0 = (v - cy) / fy
        zplane = (1.0 - t[2])
        px = t[0] + zplane * x0
        py = t[1] + zplane * y0
        # texture lookup: map world xy in [-0.4,0.4]x[-0.3,0.3] to img coords
        tu = (px + 0.4) / 0.8 * (W - 1)
        tv = (py + 0.3) / 0.6 * (H - 1)
        ti = np.clip(tv.astype(int), 0, H - 1), np.clip(tu.astype(int), 0, W - 1)
        images.append(img0[ti])
    images = np.stack(images)

    vis = np.ones((V, F), dtype=bool)
    problem = photo_ba.BAProblem(
        vox=jnp.asarray(vox), grad=jnp.asarray(grad),
        weight=jnp.asarray(np.full(V, 10.0, np.float32)),
        vmask=jnp.ones(V, bool), vis=jnp.asarray(vis),
        images=jnp.asarray(images), K=jnp.asarray(K),
    )
    state = photo_ba.BAState(
        dist=jnp.asarray(dist),
        R=jnp.asarray(np.stack([p[0] for p in poses])),
        t=jnp.asarray(np.stack([p[1] for p in poses])),
    )
    return problem, state, poses


def test_energy_zero_for_perfect_consistency():
    """Identical images + identical projections -> zero energy."""
    problem, state, _ = _make_plane_problem(F=2, V=64, seed=1)
    # make both frames the same image and same pose -> residual exactly 0
    imgs = np.array(problem.images)
    imgs[1] = imgs[0]
    problem = problem._replace(images=jnp.asarray(imgs))
    state = state._replace(
        R=jnp.stack([state.R[0], state.R[0]]),
        t=jnp.stack([state.t[0], state.t[0]]),
    )
    e = float(photo_ba.energy(problem, state, GCFG))
    # per-voxel energies are clamped at 0 (f32 cancellation guard), so the
    # signed rounding noise no longer cancels across voxels — the total is
    # a one-sided ~1e-10/voxel fp floor rather than ~0
    assert e < 1e-5


def test_energy_decreases_under_optimization():
    problem, state, _ = _make_plane_problem(F=3, seed=2, pose_noise=0.004)
    opt = photo_ba.PhotometricOptimizer(problem, state, GCFG, PCFG,
                                        verbose=False)
    opt.optimize()
    assert len(opt.energies) >= 3
    assert opt.energies[-1] <= opt.energies[0] * 1.0001
    # substantial decrease expected with a noisy pose
    assert opt.energies[-1] < 0.9 * opt.energies[0]


def test_solve_dist_moves_toward_photoconsistency():
    problem, state, _ = _make_plane_problem(F=3, seed=3, pose_noise=0.0)
    # perturb dist away from the plane; solver should pull it back
    d0 = np.asarray(state.dist) + 0.004
    state2 = state._replace(dist=jnp.asarray(d0))
    e_before = float(photo_ba.energy(problem, state2, GCFG))
    state3 = photo_ba.solve_dist(problem, state2, GCFG, PCFG)
    e_after = float(photo_ba.energy(problem, state3, GCFG))
    assert e_after <= e_before * 1.05  # reg term may slow it, but no blow-up
    assert np.isfinite(np.asarray(state3.dist)).all()


def test_write_back_dist_roundtrip():
    problem, state, _ = _make_plane_problem(F=2, V=32, seed=4)
    grid = vg.create(GCFG)
    V = problem.vox.shape[0]
    grid = vg.ensure_blocks(grid, problem.vox, jnp.ones(V, bool), GCFG)
    state = state._replace(dist=jnp.arange(V, dtype=jnp.float32) * 1e-3)
    grid = photo_ba.write_back_dist(grid, problem, state, GCFG)
    lin, present = vg.lookup_voxels(grid, problem.vox, GCFG)
    got = np.asarray(vg.flat_field(grid.dist)[lin])
    np.testing.assert_allclose(got, np.arange(V) * 1e-3, atol=1e-7)


def test_coupled_pose_solver_decreases_energy():
    """solvePoseFull (6Fx6F coupled system) also reduces energy."""
    problem, state, _ = _make_plane_problem(F=3, seed=5, pose_noise=0.004)
    e0 = float(photo_ba.energy(problem, state, GCFG))
    state2 = photo_ba.solve_pose_full(problem, state, GCFG, PCFG)
    e1 = float(photo_ba.energy(problem, state2, GCFG))
    assert np.isfinite(e1)
    assert e1 < e0


def test_solve_pose_full_chunk_invariant():
    """The voxel-chunked cross-term accumulation (no [F,V,3,6]
    materialization) assembles the same 6Fx6F system for any chunk size
    (up to f32 summation order)."""
    problem, state, _ = _make_plane_problem(pose_noise=2e-3)
    V = problem.vox.shape[0]
    H_all, b_all = photo_ba._pose_full_system(problem, state, GCFG, PCFG,
                                              chunk=V)
    scale_H = float(jnp.max(jnp.abs(H_all)))
    scale_b = float(jnp.max(jnp.abs(b_all)))
    for c in (64, 100):
        Hc, bc = photo_ba._pose_full_system(problem, state, GCFG, PCFG,
                                            chunk=c)
        np.testing.assert_allclose(np.asarray(Hc), np.asarray(H_all),
                                   atol=1e-5 * scale_H)
        np.testing.assert_allclose(np.asarray(bc), np.asarray(b_all),
                                   atol=1e-5 * scale_b)


def test_solve_pose_full_at_scale_f30_v100k():
    """Scale point: F=30, V~=1e5 coupled solve runs memory-bounded
    (chunked; would need ~GBs with a materialized [F,V,3,6])."""
    rng = np.random.RandomState(3)
    F, V = 30, 100_352  # 98 chunks of 1024
    W2 = H2 = 16  # tiny images: the test targets the cross-term memory path
    problem = photo_ba.BAProblem(
        vox=jnp.asarray(rng.randint(-40, 40, (V, 3)), jnp.int32),
        grad=jnp.asarray(rng.randn(V, 3), jnp.float32),
        weight=jnp.ones(V, jnp.float32),
        vmask=jnp.ones(V, bool),
        vis=jnp.asarray(rng.rand(V, F) < 0.4),
        images=jnp.asarray(rng.rand(F, H2, W2, 3), jnp.float32),
        K=jnp.asarray([[8.0, 0, 7.5], [0, 8.0, 7.5], [0, 0, 1]], jnp.float32),
    )
    state = photo_ba.BAState(
        dist=jnp.asarray(rng.randn(V) * 0.005, jnp.float32),
        R=jnp.asarray(np.tile(np.eye(3, dtype=np.float32), (F, 1, 1))),
        t=jnp.asarray(rng.randn(F, 3) * 0.01, jnp.float32),
    )
    out = photo_ba.solve_pose_full(problem, state, GCFG, PCFG, chunk=8192)
    assert np.all(np.isfinite(np.asarray(out.R)))
    assert np.all(np.isfinite(np.asarray(out.t)))


def test_channel_mix_parity_reverses_gradient_channels():
    """PhotoBAConfig.channel_mix_parity must reproduce the reference's
    computeImageGradient channel REVERSAL (PhotometricOptimizer.cpp:102-126):
    image gradients come back BGR-reversed while residuals keep native
    order. Verified structurally: the per-frame dI/dp with the switch ON
    equals the switch-OFF dI/dp with its channel axis flipped, residuals A
    unchanged; and the pose step matches a direct recomputation with
    flipped gradients."""
    import dataclasses

    problem, state, _ = _make_plane_problem(F=3, seed=6, pose_noise=0.003)
    x = photo_ba._surface_points(problem, state.dist, GCFG.voxel_size)
    Ri, ti = state.R[1], state.t[1]
    img, vis_i = problem.images[1], problem.vis[:, 1]
    A0, dI0, p0, v0 = photo_ba._per_frame_terms(problem, x, Ri, ti, img,
                                                vis_i, channel_mix=False)
    A1, dI1, p1, v1 = photo_ba._per_frame_terms(problem, x, Ri, ti, img,
                                                vis_i, channel_mix=True)
    np.testing.assert_array_equal(np.asarray(A0), np.asarray(A1))
    np.testing.assert_array_equal(np.asarray(v0), np.asarray(v1))
    np.testing.assert_array_equal(np.asarray(dI1),
                                  np.asarray(dI0)[:, ::-1, :])

    # the mixed pose step differs from the unmixed one on colored data
    pcfg_mix = dataclasses.replace(PCFG, channel_mix_parity=True)
    s0 = photo_ba.solve_pose(problem, state, GCFG, PCFG)
    s1 = photo_ba.solve_pose(problem, state, GCFG, pcfg_mix)
    assert float(jnp.max(jnp.abs(s0.t - s1.t))) > 1e-7

    # on GRAYSCALE images (equal channels) the reversal is a no-op
    gray = jnp.mean(problem.images, axis=-1, keepdims=True)
    problem_g = problem._replace(images=jnp.repeat(gray, 3, axis=-1))
    g0 = photo_ba.solve_pose(problem_g, state, GCFG, PCFG)
    g1 = photo_ba.solve_pose(problem_g, state, GCFG, pcfg_mix)
    # fp summation order differs (reversed channel axis in the einsum
    # reductions), so equality is to f32 tolerance, not bitwise
    np.testing.assert_allclose(np.asarray(g0.t), np.asarray(g1.t),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(g0.R), np.asarray(g1.R),
                               atol=2e-5)
