"""Precision policy: every float32 contraction on the main path is pinned to
`Precision.HIGHEST`.

On a GPU an unpinned float32 matmul may run in TF32 (about 3 decimal
digits), which is millimetres at a 1 m range. Each case traces one main-path
function to a jaxpr (no compile, no device work) and asserts that every
`dot_general` in it, including inside loops, conds and scans, carries
HIGHEST on both operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gradient_sdf_tpu.config import (FusionConfig, GridConfig, PhotoBAConfig,
                                     TrackerConfig)
from gradient_sdf_tpu.data import synth
from gradient_sdf_tpu.models import color_upsampler, photo_ba, tracker
from gradient_sdf_tpu.ops import fusion, normals, raycast
from gradient_sdf_tpu.ops import voxel_grid as vg

W, H = 32, 24
K = np.array([[26.0, 0, 15.5], [0, 26.0, 11.5], [0, 0, 1]], np.float32)
GCFG = GridConfig(voxel_size=0.02, num_blocks=64, dir_dim=32)
FCFG = FusionConfig(trunc_voxels=3.0, normal_window=5)
R0 = jnp.eye(3, dtype=jnp.float32)
T0 = jnp.asarray([0.0, 0.0, -1.0], jnp.float32)
DEPTH = jnp.full((H, W), 1.0, jnp.float32)


def _ba_args(F=2, V=64):
    problem = photo_ba.BAProblem(
        vox=jnp.zeros((V, 3), jnp.int32),
        grad=jnp.ones((V, 3), jnp.float32),
        weight=jnp.ones((V,), jnp.float32),
        vmask=jnp.ones((V,), bool),
        vis=jnp.ones((V, F), bool),
        images=jnp.zeros((F, H, W, 3), jnp.float32),
        K=jnp.asarray(K),
    )
    state = photo_ba.BAState(
        dist=jnp.zeros((V,), jnp.float32),
        R=jnp.tile(R0, (F, 1, 1)),
        t=jnp.zeros((F, 3), jnp.float32),
    )
    return problem, state


def _ba_iteration(problem, state):
    pcfg = PhotoBAConfig()
    state = photo_ba.solve_pose(problem, state, GCFG, pcfg)
    e1 = photo_ba.energy(problem, state, GCFG)
    state = photo_ba.solve_dist(problem, state, GCFG, pcfg)
    return state, e1, photo_ba.energy(problem, state, GCFG)


def _case(name):
    cache = normals.build_cache(W, H, K, window=5)
    grid = vg.create(GCFG)
    world = synth.random_spheres(seed=2)
    boxes = synth.default_boxes(seed=0)
    cases = {
        "fuse_frame": (
            lambda g, d, R, t: fusion.fuse_frame(g, d, cache, R, t, GCFG,
                                                 FCFG),
            (grid, DEPTH, R0, T0)),
        "track_frame": (
            lambda g, d, R, t: tracker.track_frame(
                g, d, jnp.asarray(K), R, t, GCFG, FCFG, TrackerConfig()),
            (grid, DEPTH, R0, T0)),
        "track_and_fuse_frame": (
            lambda g, d, R, t: tracker.track_and_fuse_frame(
                g, d, jnp.asarray(K), R, t, cache, GCFG, FCFG,
                TrackerConfig()),
            (grid, DEPTH, R0, T0)),
        "photoba_iteration": (_ba_iteration, _ba_args()),
        "photoba_pose_full": (
            lambda p, s: photo_ba.solve_pose_full(p, s, GCFG,
                                                  PhotoBAConfig()),
            _ba_args()),
        "color_upsampler": (
            color_upsampler.accumulate_colors,
            (jnp.zeros((16, 8, 3)), jnp.zeros((2, H, W, 3)),
             jnp.tile(R0, (2, 1, 1)), jnp.zeros((2, 3)),
             jnp.ones((2, 16), bool), jnp.asarray(K))),
        "render_depth": (
            lambda R, t: synth.render_depth(world, R, t, K, W, H), (R0, T0)),
        "render_depth_boxes": (
            lambda R, t: synth.render_depth_boxes(boxes, R, t, K, W, H),
            (R0, T0)),
        "raycast": (
            lambda g, R, t: raycast.render_depth_normal(
                g, jnp.asarray(K), R, t, W, H, GCFG, FCFG, s_max=2.0),
            (grid, R0, T0)),
    }
    return cases[name]


def _subjaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def dot_generals(jaxpr):
    """Every dot_general equation in `jaxpr`, recursively."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from dot_generals(sub)


def unpinned_dots(jaxpr):
    """(operand shapes, precision) of each dot_general in `jaxpr` whose
    precision is not HIGHEST on both operands."""
    bad = []
    for eqn in dot_generals(jaxpr):
        prec = eqn.params.get("precision")
        if not (isinstance(prec, tuple) and len(prec) == 2 and all(
                p == jax.lax.Precision.HIGHEST for p in prec)):
            bad.append(([tuple(v.aval.shape) for v in eqn.invars], prec))
    return bad


@pytest.mark.parametrize("name", [
    "fuse_frame", "track_frame", "track_and_fuse_frame", "photoba_iteration",
    "photoba_pose_full", "color_upsampler", "render_depth",
    "render_depth_boxes", "raycast",
])
def test_contractions_pinned_highest(name):
    fn, args = _case(name)
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    assert list(dot_generals(jaxpr)), f"{name}: no contraction traced"
    assert unpinned_dots(jaxpr) == [], name


def test_unpinned_detector_catches_default_precision():
    """The walker finds an unpinned contraction nested inside a scan."""
    def f(a):
        def body(c, x):
            return c + jnp.matmul(x, x), None
        return jax.lax.scan(body, jnp.zeros((3, 3)), a)[0]

    bad = unpinned_dots(jax.make_jaxpr(f)(jnp.zeros((2, 3, 3))).jaxpr)
    assert len(bad) == 1
