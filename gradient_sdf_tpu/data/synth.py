"""Synthetic sphere world: analytic renderer + Kinect noise + ground truth.

JAX port of the reference's MATLAB validation pipeline
(`matlab/RenderSpheres.m:36-139`, `matlab/add_kinect_noise.m:50-74`):
five random non-intersecting spheres rendered as analytic ray-casts at
Kinect intrinsics K = [525 0 319.5; 0 525 239.5; 0 0 1], with
disparity-domain Gaussian noise (sigma = 0.5 px) and disparity quantization.

This is the framework's permanent ground-truth fixture: depth images come
with *exact* analytic SDF values and gradients (sphere normals), so fusion /
query / tracking accuracy can be scored quantitatively with no dataset
download (reproduces the paper's Fig. 3 gradient-accuracy analysis,
`matlab/GradientAnalysisSpheres.m`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import se3

KINECT_K = np.array(
    [[525.0, 0.0, 319.5], [0.0, 525.0, 239.5], [0.0, 0.0, 1.0]], dtype=np.float32
)


class SphereWorld(NamedTuple):
    centers: jax.Array  # [S, 3]
    radii: jax.Array    # [S]


def random_spheres(seed: int = 0, n: int = 5) -> SphereWorld:
    """Five random non-intersecting spheres, same distribution as the
    reference (`RenderSpheres.m:46-53`): centers uniform in [-0.5, 0.5]^3,
    radii in [0.0625, 0.5], rejection-sampled for pairwise separation."""
    rng = np.random.RandomState(seed)
    centers, radii = [], []
    while len(centers) < n:
        c = rng.rand(3) - 0.5
        r = 0.0625 + 0.4375 * rng.rand()
        ok = all(
            np.linalg.norm(c - c2) > (r + r2) for c2, r2 in zip(centers, radii)
        )
        if ok:
            centers.append(c)
            radii.append(r)
    return SphereWorld(
        centers=jnp.asarray(np.array(centers), jnp.float32),
        radii=jnp.asarray(np.array(radii), jnp.float32),
    )


def sphere_sdf(world: SphereWorld, points: jax.Array):
    """Analytic SDF + unit gradient of the sphere union at world points (…,3)."""
    diff = points[..., None, :] - world.centers  # (…,S,3)
    d = jnp.linalg.norm(diff, axis=-1) - world.radii  # (…,S)
    s = jnp.argmin(d, axis=-1)
    sdf = jnp.min(d, axis=-1)
    nearest = jnp.take_along_axis(diff, s[..., None, None], axis=-2)[..., 0, :]
    grad = nearest / jnp.maximum(jnp.linalg.norm(nearest, axis=-1, keepdims=True), 1e-12)
    return sdf, grad


def render_depth(
    world: SphereWorld,
    R: jax.Array,
    t: jax.Array,
    K: np.ndarray = KINECT_K,
    width: int = 640,
    height: int = 480,
) -> jax.Array:
    """Analytic ray-sphere depth render under camera-to-world pose (R, t).

    Solves A z^2 + B z + C = 0 per pixel per sphere exactly as
    `RenderSpheres.m:96-120`; missed rays get depth 0.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = (jnp.arange(width, dtype=jnp.float32) - cx) / fx
    v = (jnp.arange(height, dtype=jnp.float32) - cy) / fy
    cu, cv = jnp.meshgrid(u, v)
    A = cu * cu + cv * cv + 1.0

    # sphere centers in camera frame
    c_cam = se3.se3_apply(*se3.se3_inv(R, t), world.centers)  # [S,3]
    c_sq_r = jnp.sum(c_cam * c_cam, axis=-1) - world.radii**2  # [S]

    B = -2.0 * (
        cu[..., None] * c_cam[:, 0] + cv[..., None] * c_cam[:, 1] + c_cam[:, 2]
    )  # [H,W,S]
    disc = B * B - 4.0 * A[..., None] * c_sq_r
    hit = disc >= 0.0
    z = (-B - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * A[..., None])
    z = jnp.where(hit & (z > 0.0), z, jnp.inf)
    depth = jnp.min(z, axis=-1)
    return jnp.where(jnp.isinf(depth), 0.0, depth)


class BoxWorld(NamedTuple):
    """Axis-aligned box union: the NON-SPHERE analytic fixture.

    The sphere world is smooth and convex everywhere; the reference's
    target data is planar indoor scenes with creases and occlusion edges
    (`README.md:50,67`, RedwoodLoader/Printed3dLoader). Boxes supply
    exactly the features spheres cannot: flat low-curvature faces (the
    hard case for point-to-plane-style GN tracking), 90-degree creases
    (MC + FALS at gradient discontinuities), and depth steps where a box
    occludes the floor slab (silhouette handling in normals/raycast) —
    while keeping EXACT analytic SDF values and gradients for scoring.
    """

    centers: jax.Array       # [B, 3]
    half_extents: jax.Array  # [B, 3]


def default_boxes(seed: int = 0, n: int = 3) -> BoxWorld:
    """Floor slab (top face at z = -0.4) plus n boxes resting on it,
    rejection-sampled for xy separation >= 5 cm so creases and occlusion
    edges stay isolated. Deterministic per seed, like random_spheres."""
    rng = np.random.RandomState(seed)
    centers = [np.array([0.0, 0.0, -0.45])]
    halfs = [np.array([0.8, 0.8, 0.05])]
    placed: list = []
    while len(placed) < n:
        h = 0.06 + 0.14 * rng.rand(3)
        c = np.array([rng.uniform(-0.35, 0.35), rng.uniform(-0.35, 0.35),
                      -0.4 + h[2]])
        ok = all(
            np.max(np.abs(c[:2] - p[:2]) - (h[:2] + ph[:2])) > 0.05
            for p, ph in placed
        )
        if ok:
            placed.append((c, h))
    for c, h in placed:
        centers.append(c)
        halfs.append(h)
    return BoxWorld(
        centers=jnp.asarray(np.array(centers), jnp.float32),
        half_extents=jnp.asarray(np.array(halfs), jnp.float32),
    )


def box_sdf(world: BoxWorld, points: jax.Array):
    """Exact SDF + unit gradient of the box union at world points (…,3).

    Per box, with q = |p - c| - h: outside distance ||max(q, 0)||, inside
    max_i(q_i); union by min like sphere_sdf. Gradients: the outward
    face/edge/corner direction outside, the one-hot max-axis normal inside
    (exact a.e.; crease lines themselves are measure zero)."""
    d = points[..., None, :] - world.centers          # (…,B,3)
    q = jnp.abs(d) - world.half_extents               # (…,B,3)
    qp = jnp.maximum(q, 0.0)
    out = jnp.linalg.norm(qp, axis=-1)                # (…,B)
    qmax = jnp.max(q, axis=-1)
    sdf_b = out + jnp.minimum(qmax, 0.0)
    b = jnp.argmin(sdf_b, axis=-1)
    sdf = jnp.min(sdf_b, axis=-1)
    dn = jnp.take_along_axis(d, b[..., None, None], axis=-2)[..., 0, :]
    qn = jnp.take_along_axis(q, b[..., None, None], axis=-2)[..., 0, :]
    outn = jnp.take_along_axis(out, b[..., None], axis=-1)[..., 0]
    g_out = (jnp.sign(dn) * jnp.maximum(qn, 0.0)
             / jnp.maximum(outn[..., None], 1e-12))
    ax = jnp.argmax(qn, axis=-1)
    g_in = jnp.sign(dn) * jax.nn.one_hot(ax, 3, dtype=points.dtype)
    grad = jnp.where((outn > 0.0)[..., None], g_out, g_in)
    return sdf, grad


def render_depth_boxes(
    world: BoxWorld,
    R: jax.Array,
    t: jax.Array,
    K: np.ndarray = KINECT_K,
    width: int = 640,
    height: int = 480,
) -> jax.Array:
    """Exact ray/AABB (slab) depth render under camera-to-world (R, t).

    Rays use the UNNORMALIZED camera direction [cu, cv, 1], so the slab
    parameter IS the camera-space depth z; per box tn = max_i min(t1, t2),
    tf = min_i max(t1, t2), hit iff tn <= tf and tf > 0 (tf handles a
    camera inside a box); missed rays get depth 0 like render_depth."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = (jnp.arange(width, dtype=jnp.float32) - cx) / fx
    v = (jnp.arange(height, dtype=jnp.float32) - cy) / fy
    cu, cv = jnp.meshgrid(u, v)
    d_cam = jnp.stack([cu, cv, jnp.ones_like(cu)], axis=-1)    # [H,W,3]
    d_w = jnp.einsum("ij,hwj->hwi", jnp.asarray(R, jnp.float32), d_cam,
                     precision=jax.lax.Precision.HIGHEST)
    d_safe = jnp.where(jnp.abs(d_w) < 1e-12, 1e-12, d_w)
    inv = 1.0 / d_safe                                         # [H,W,3]
    o = jnp.asarray(t, jnp.float32)
    bmin = world.centers - world.half_extents                  # [B,3]
    bmax = world.centers + world.half_extents
    t1 = (bmin - o) * inv[..., None, :]                        # [H,W,B,3]
    t2 = (bmax - o) * inv[..., None, :]
    tn = jnp.max(jnp.minimum(t1, t2), axis=-1)                 # [H,W,B]
    tf = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (tn <= tf) & (tf > 0.0)
    s = jnp.where(tn > 0.0, tn, tf)
    s = jnp.where(hit, s, jnp.inf)
    depth = jnp.min(s, axis=-1)
    return jnp.where(jnp.isinf(depth), 0.0, depth)


def add_kinect_noise(depth: jax.Array, key: jax.Array) -> jax.Array:
    """Disparity-domain Kinect noise (`add_kinect_noise.m:50-74`):
    d = (3 - 1/z)/2.85e-3, d += 0.5*N(0,1), round, invert."""
    mask = depth > 0.0
    safe_z = jnp.where(mask, depth, 1.0)
    d = (3.0 - 1.0 / safe_z) / 2.85e-3
    d = d + 0.5 * jax.random.normal(key, depth.shape, dtype=depth.dtype)
    d = jnp.round(d)
    z_inv = -2.85e-3 * d + 3.0
    return jnp.where(mask, 1.0 / z_inv, 0.0)


def quantize_depth(depth: jax.Array, unit: float = 1e-3) -> jax.Array:
    """16-bit PNG round-trip (`RenderSpheres.m:136`: uint16(1000*z))."""
    return jnp.round(depth / unit) * unit


def orbit_poses(
    n: int = 90,
    radius: float = 2.0,
    height_range: tuple = (-0.3, 0.3),
    target: np.ndarray | None = None,
    arc: float = 2.0 * np.pi,
    closed: bool = False,
) -> list:
    """Spiral of camera-to-world look-at poses circling the sphere cluster,
    analogous to the reference's `matlab/poses.txt` trajectory (a spiral at
    ~2 m viewing the origin). `arc` bounds the swept angle so short
    sequences keep realistic (small) inter-frame motion.

    `closed=True` makes the trajectory LOOP-CLOSING: with arc=2*pi the
    azimuth returns to the start and the height follows a sine out-and-back
    ramp instead of a linear one, so the final frames re-enter the first
    frame's view — the drift/revisit-consistency protocol (a short arc
    cannot test what happens when the camera sees early-fused geometry
    again after a long excursion).
    Returns [(R, t)] as numpy arrays."""
    target = np.zeros(3) if target is None else np.asarray(target)
    poses = []
    for i in range(n):
        ang = arc * i / n
        if closed:
            h = (height_range[0]
                 + (height_range[1] - height_range[0]) * np.sin(np.pi * i / n))
        else:
            h = height_range[0] + (height_range[1] - height_range[0]) * i / max(n - 1, 1)
        eye = target + np.array([radius * np.cos(ang), radius * np.sin(ang), h])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up_hint = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up_hint)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        # camera axes: x right, y down, z forward (pinhole convention)
        R = np.stack([right, down, fwd], axis=1).astype(np.float32)
        poses.append((R, eye.astype(np.float32)))
    return poses
