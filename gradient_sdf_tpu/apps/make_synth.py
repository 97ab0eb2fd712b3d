"""Synthetic dataset generator: renders the sphere world to disk.

Replaces the reference's MATLAB `RenderSpheres.m` + `add_kinect_noise.m`
pipeline: writes `depth/%03d.png` (16-bit, millimeters), `rgb/%03d.png`,
`albedo/%03d.png`, `intrinsics.txt`, and `poses.txt` (TUM format) in the
layout `SynthLoader` expects, so the full Scan3D/PhotoBA apps can run on a
self-generated ground-truth dataset with zero downloads.

Usage:  python -m gradient_sdf_tpu.apps.make_synth --out <dir> [--frames 90]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..data import synth
from ..utils import compile_cache, png, tumio

# matplotlib's default color cycle, as used for sphere albedo in
# RenderSpheres.m:82-87
SPHERE_COLORS = np.array(
    [
        [0.0, 0.4470, 0.7410],
        [0.8500, 0.3250, 0.0980],
        [0.9290, 0.6940, 0.1250],
        [0.4940, 0.1840, 0.5560],
        [0.4660, 0.6740, 0.1880],
    ],
    dtype=np.float32,
)


def render_color(world, R, t, K, width, height, gray_texture: bool = False):
    """Albedo render: each pixel takes its nearest sphere's flat color, or —
    with `gray_texture` — a smooth GRAYSCALE world-anchored pattern (equal
    RGB channels). Grayscale texture is the BA-convergence parity fixture:
    with identical channels the reference's channel-reversed image
    gradients (PhotometricOptimizer.cpp:102-126) coincide with
    residual-consistent ones, so full-BA iterations are directly
    comparable; the spatial texture gives the photometric energy interior
    gradients (flat albedo constrains BA only at silhouettes)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    from ..utils import se3

    u = (jnp.arange(width, dtype=jnp.float32) - cx) / fx
    v = (jnp.arange(height, dtype=jnp.float32) - cy) / fy
    cu, cv = jnp.meshgrid(u, v)
    A = cu * cu + cv * cv + 1.0
    c_cam = se3.se3_apply(*se3.se3_inv(R, t), world.centers)
    c_sq_r = jnp.sum(c_cam * c_cam, axis=-1) - world.radii**2
    B = -2.0 * (cu[..., None] * c_cam[:, 0] + cv[..., None] * c_cam[:, 1] + c_cam[:, 2])
    disc = B * B - 4.0 * A[..., None] * c_sq_r
    hit = disc >= 0.0
    z = (-B - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2.0 * A[..., None])
    z = jnp.where(hit & (z > 0.0), z, jnp.inf)
    sidx = jnp.argmin(z, axis=-1)
    any_hit = jnp.any(jnp.isfinite(z), axis=-1)
    if gray_texture:
        z_hit = jnp.min(z, axis=-1)
        zs = jnp.where(any_hit, z_hit, 0.0)
        # world-space hit point (pose-consistent texture across frames)
        px = zs * cu, zs * cv, zs
        pw = se3.se3_apply(
            R, t, jnp.stack([px[0], px[1], px[2]], axis=-1))
        g = (0.55
             + 0.15 * jnp.sin(31.0 * pw[..., 0])
             + 0.15 * jnp.sin(29.0 * pw[..., 1])
             + 0.15 * jnp.sin(27.0 * pw[..., 2]))
        img = jnp.where(any_hit, g, 0.0)[..., None] * jnp.ones((3,), jnp.float32)
        return img
    colors = jnp.asarray(SPHERE_COLORS[: world.centers.shape[0]])
    img = jnp.where(any_hit[..., None], colors[sidx], 0.0)
    return img


def render_color_boxes(world, R, t, K, width, height,
                       gray_texture: bool = False):
    """Albedo render for the box world: flat per-box colors (cycled sphere
    palette) or the same grayscale world-anchored pattern render_color
    uses (the BA fixture works identically on boxes)."""
    from ..utils import se3

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    depth = synth.render_depth_boxes(world, R, t, K, width, height)
    hit = depth > 0.0
    u = (jnp.arange(width, dtype=jnp.float32) - cx) / fx
    v = (jnp.arange(height, dtype=jnp.float32) - cy) / fy
    cu, cv = jnp.meshgrid(u, v)
    pw = se3.se3_apply(
        R, t, jnp.stack([depth * cu, depth * cv, depth], axis=-1))
    if gray_texture:
        g = (0.55
             + 0.15 * jnp.sin(31.0 * pw[..., 0])
             + 0.15 * jnp.sin(29.0 * pw[..., 1])
             + 0.15 * jnp.sin(27.0 * pw[..., 2]))
        return jnp.where(hit, g, 0.0)[..., None] * jnp.ones((3,), jnp.float32)
    # surface points' nearest box IS the hit box
    d = pw[..., None, :] - world.centers
    q = jnp.abs(d) - world.half_extents
    sdf_b = (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
             + jnp.minimum(jnp.max(q, axis=-1), 0.0))
    bidx = jnp.argmin(sdf_b, axis=-1)
    colors = jnp.asarray(
        SPHERE_COLORS[np.arange(world.centers.shape[0]) % len(SPHERE_COLORS)])
    return jnp.where(hit[..., None], colors[bidx], 0.0)


def write_png16(path, depth_m):
    mm = np.clip(np.round(np.asarray(depth_m) * 1000.0), 0, 65535).astype(np.uint16)
    png.write_png(path, mm)


def write_png8(path, img):
    arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    png.write_png(path, arr)


def generate(out: str, frames: int = 90, seed: int = 0, width: int = 640,
             height: int = 480, noise: bool = True, arc_deg: float = None,
             gray_texture: bool = False, loop: bool = False,
             world_kind: str = "spheres"):
    # Kinect intrinsics, scaled when rendering below the native 640x480
    K = synth.KINECT_K.copy()
    K[0] *= width / 640.0
    K[1] *= height / 480.0
    # default sweep ~4 deg/frame like the reference's 90-pose spiral; pass a
    # smaller arc for TUM-like per-frame motion at low resolutions.
    # --loop closes the trajectory (full orbit + sine height ramp) so the
    # final frames revisit the first frame's view after a long excursion.
    if arc_deg is None:
        arc_deg = 360.0 if loop else 360.0 * frames / 90.0

    for sub in ("depth", "rgb", "albedo"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    np.savetxt(os.path.join(out, "intrinsics.txt"), K, fmt="%.6f")

    if world_kind == "box":
        world = synth.default_boxes(seed=seed)
        # the box scene sits on a floor slab (top at z=-0.4): orbit lower
        # and from above so faces, creases, AND box-over-floor occlusion
        # edges are all in view
        poses = synth.orbit_poses(
            n=frames, radius=1.8, height_range=(0.35, 0.6),
            target=np.array([0.0, 0.0, -0.25]),
            arc=np.deg2rad(arc_deg), closed=loop)
        np.savetxt(
            os.path.join(out, "boxes.txt"),
            np.concatenate([np.asarray(world.centers),
                            np.asarray(world.half_extents)], axis=1),
            fmt="%.6f",
            header="cx cy cz hx hy hz",
        )

        def depth_fn(R, t):
            return synth.render_depth_boxes(world, R, t, K, width, height)

        def color_fn(R, t):
            return render_color_boxes(world, R, t, K, width, height,
                                      gray_texture=gray_texture)
    else:
        world = synth.random_spheres(seed=seed)
        poses = synth.orbit_poses(n=frames, radius=2.0,
                                  arc=np.deg2rad(arc_deg), closed=loop)
        np.savetxt(
            os.path.join(out, "spheres.txt"),
            np.concatenate([np.asarray(world.centers),
                            np.asarray(world.radii)[:, None]], axis=1),
            fmt="%.6f",
            header="cx cy cz r",
        )

        def depth_fn(R, t):
            return synth.render_depth(world, R, t, K, width, height)

        def color_fn(R, t):
            return render_color(world, R, t, K, width, height,
                                gray_texture=gray_texture)

    tumio.write_trajectory(
        os.path.join(out, "gt_poses.txt"),
        [(f"{i + 1:03d}", R, t) for i, (R, t) in enumerate(poses)],
    )

    key = jax.random.PRNGKey(seed)
    for i, (R, t) in enumerate(poses):
        depth = depth_fn(jnp.asarray(R), jnp.asarray(t))
        if noise:
            key, sub = jax.random.split(key)
            depth = synth.add_kinect_noise(depth, sub)
        color = color_fn(jnp.asarray(R), jnp.asarray(t))
        name = f"{i + 1:03d}.png"
        write_png16(os.path.join(out, "depth", name), depth)
        write_png8(os.path.join(out, "rgb", name), color)
        write_png8(os.path.join(out, "albedo", name), color)
    print(f"wrote {frames} frames to {out}")


def main(argv=None):
    p = argparse.ArgumentParser("make_synth")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=90)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--no-noise", action="store_true")
    p.add_argument("--arc-deg", dest="arc_deg", type=float, default=None,
                   help="total orbit sweep in degrees (default: 4 deg/frame)")
    p.add_argument("--gray-texture", action="store_true",
                   help="grayscale world-anchored albedo texture (the BA"
                        " convergence-parity fixture: equal RGB channels"
                        " neutralize the reference channel reversal)")
    p.add_argument("--loop", action="store_true",
                   help="loop-closing trajectory: full orbit + sine height "
                        "ramp; the final frames re-enter the first frame's "
                        "view (drift / revisit-consistency protocol)")
    p.add_argument("--world", choices=["spheres", "box"], default="spheres",
                   help="analytic world: smooth convex spheres (default, "
                        "the MATLAB protocol) or a box scene with planar "
                        "faces, creases, and occlusion edges (the indoor-"
                        "scene feature set; data/synth.BoxWorld)")
    a = p.parse_args(argv)
    compile_cache.enable()
    generate(a.out, a.frames, a.seed, a.width, a.height, noise=not a.no_noise,
             arc_deg=a.arc_deg, gray_texture=a.gray_texture, loop=a.loop,
             world_kind=a.world)


if __name__ == "__main__":
    main()
