"""FALS surface normals from depth (Badino et al.), XLA-native.

Re-implements the reference's `cv::NormalEstimator<T>`
(`cpp/include/normals/NormalEstimator.h:81-204`) with the same math:
per-pixel unit rays nbar = (x0, y0, 1)/|.|, a per-pixel 3x3 normal-equation
matrix M = sum_window nbar nbar^T precomputed once and inverted analytically
(adjugate), then per frame b = sum_window nbar / z and n = M^{-1} b,
normalized. Box sums are unnormalized box filters realized as two banded
matmuls (see box_sum_matrix), so the whole per-frame pass is two small
matmuls plus fused elementwise ops. M is ill-conditioned over an 11-pixel
window (condition number ~4e4 at VGA), so float32 normals carry ~1e-3
error against float64 whatever the device.

Border handling matches OpenCV's default BORDER_REFLECT_101 via jnp.pad
(mode="reflect").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def box_sum_matrix(n: int, window: int) -> np.ndarray:
    """[n, n] matrix S with (S^T x)_i = sum of x over the window around i,
    BORDER_REFLECT_101 folded in. Box filtering then becomes two small
    matmuls. (A summed-area formulation would be O(HW); which is faster on
    the GPU is not yet measured.)"""
    r = window // 2
    S = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        for di in range(-r, r + 1):
            j = i + di
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * n - 2 - j
            S[j, i] += 1.0
    return S


def box_filter(img: jax.Array, window: int, Sh=None, Sw=None) -> jax.Array:
    """Unnormalized box sum over a window x window neighborhood
    (cv::boxFilter(..., normalize=false), BORDER_REFLECT_101).

    With precomputed banded matrices Sh [H,H], Sw [W,W] (box_sum_matrix),
    this is (Sh^T @ img) @ Sw; without them it falls back to a
    general formulation."""
    if Sh is not None and Sw is not None:
        v = jnp.matmul(Sh.T, img, precision=jax.lax.Precision.HIGHEST)
        return jnp.matmul(v, Sw, precision=jax.lax.Precision.HIGHEST)
    r = window // 2
    x = jnp.pad(img, ((r, r), (r, r)), mode="reflect")
    return jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (window, window), (1, 1), "VALID"
    )


class NormalEstimatorCache(NamedTuple):
    """Per-camera precomputed LUTs (reference `cache()`,
    NormalEstimator.h:81-154). Also reused by fusion for the per-pixel
    homogeneous ray (x0, y0, 1) and 1/|(x0,y0,1)|^2 — reference exposes
    these via x0_ptr/y0_ptr/n_sq_inv_ptr (NormalEstimator.h:206-210)."""

    x0: jax.Array        # f32 [H, W]  (u - cx) / fx
    y0: jax.Array        # f32 [H, W]  (v - cy) / fy
    n_sq_inv: jax.Array  # f32 [H, W]  1 / (1 + x0^2 + y0^2)
    x0_n_sq_inv: jax.Array
    y0_n_sq_inv: jax.Array
    Q: jax.Array         # f32 [H, W, 6] packed symmetric inverse (11,12,13,22,23,33)
    window: int
    Sh: jax.Array        # f32 [H, H] vertical box-sum matrix
    Sw: jax.Array        # f32 [W, W] horizontal box-sum matrix


def build_cache(width: int, height: int, K: np.ndarray, window: int = 11) -> NormalEstimatorCache:
    """Precompute the FALS LUTs in float64 (reference does the cache pass in
    double, NormalEstimator.h:84-124) then cast to float32."""
    K = np.asarray(K, dtype=np.float64)
    fx_inv, fy_inv = 1.0 / K[0, 0], 1.0 / K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    u = (np.arange(width, dtype=np.float64) - cx) * fx_inv
    v = (np.arange(height, dtype=np.float64) - cy) * fy_inv
    x0, y0 = np.meshgrid(u, v)

    n_sq = 1.0 + x0 * x0 + y0 * y0
    n_sq_inv = 1.0 / n_sq
    x0n = x0 * n_sq_inv
    y0n = y0 * n_sq_inv

    def bf(a):
        return _np_box_filter(a, window)

    M11 = bf(x0 * x0 * n_sq_inv)
    M12 = bf(x0 * y0 * n_sq_inv)
    M13 = bf(x0n)
    M22 = bf(y0 * y0 * n_sq_inv)
    M23 = bf(y0n)
    M33 = bf(n_sq_inv)

    det = (
        M11 * M22 * M33
        + 2.0 * M12 * M23 * M13
        - (M13 * M13 * M22 + M12 * M12 * M33 + M23 * M23 * M11)
    )
    det_inv = 1.0 / det
    Q11 = det_inv * (M22 * M33 - M23 * M23)
    Q12 = det_inv * (M13 * M23 - M12 * M33)
    Q13 = det_inv * (M12 * M23 - M13 * M22)
    Q22 = det_inv * (M11 * M33 - M13 * M13)
    Q23 = det_inv * (M12 * M13 - M11 * M23)
    Q33 = det_inv * (M11 * M22 - M12 * M12)
    Q = np.stack([Q11, Q12, Q13, Q22, Q23, Q33], axis=-1)

    f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
    return NormalEstimatorCache(
        x0=f32(x0),
        y0=f32(y0),
        n_sq_inv=f32(n_sq_inv),
        x0_n_sq_inv=f32(x0n),
        y0_n_sq_inv=f32(y0n),
        Q=f32(Q),
        window=window,
        Sh=f32(box_sum_matrix(height, window)),
        Sw=f32(box_sum_matrix(width, window)),
    )


def _np_box_filter(a: np.ndarray, window: int) -> np.ndarray:
    """NumPy reflect-101 box sum for the (host-side, once-per-camera) cache."""
    r = window // 2
    x = np.pad(a, r, mode="reflect")
    c = np.cumsum(x, axis=1)
    c = np.pad(c, ((0, 0), (1, 0)))
    h = c[:, window:] - c[:, :-window]
    c2 = np.cumsum(h, axis=0)
    c2 = np.pad(c2, ((1, 0), (0, 0)))
    return c2[window:, :] - c2[:-window, :]


def compute_normals(cache: NormalEstimatorCache, depth: jax.Array) -> jax.Array:
    """Per-frame FALS normals: depth [H, W] -> unit normals [H, W, 3].

    Matches reference `compute()` (NormalEstimator.h:179-204): zero-depth
    pixels contribute 0 to the window sums; output normals point *toward*
    the camera (inward) like the reference's. Pixels whose window carries no
    valid depth yield non-finite values — callers gate on
    ||n||^2 (fusion rejects ||n||^2 < 0.1, MapGradPixelSdf.cpp:95).
    """
    z_inv = jnp.where(depth != 0.0, 1.0 / depth, 0.0)
    b1 = box_filter(cache.x0_n_sq_inv * z_inv, cache.window, cache.Sh, cache.Sw)
    b2 = box_filter(cache.y0_n_sq_inv * z_inv, cache.window, cache.Sh, cache.Sw)
    b3 = box_filter(cache.n_sq_inv * z_inv, cache.window, cache.Sh, cache.Sw)
    Q = cache.Q
    nx = b1 * Q[..., 0] + b2 * Q[..., 1] + b3 * Q[..., 2]
    ny = b1 * Q[..., 1] + b2 * Q[..., 3] + b3 * Q[..., 4]
    nz = b1 * Q[..., 2] + b2 * Q[..., 4] + b3 * Q[..., 5]
    norm = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    n = jnp.stack([nx, ny, nz], axis=-1) / norm[..., None]
    return n
