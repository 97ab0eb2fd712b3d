"""SO(3)/SE(3) Lie-group math in JAX.

Replacement for the reference's Sophus usage (reference
`cpp/include/mat.h:47-66` typedefs `SE3 = Sophus::SE3<float>` etc.).
Poses are represented as `(R, t)` pairs of `jnp` arrays — a (3,3) rotation
and a (3,) translation — so every function is trivially `vmap`/`jit`-able
and batches of poses are just leading axes.

All functions are float32-first (the reference is float32 throughout) and
use series expansions near theta=0 so gradients are finite everywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Geometry must be exact float32: an unpinned float32 matmul may run in TF32
# on a GPU (about 3 decimal digits), and a 1e-3 error in a rotation matrix
# is millimetres at 1 m, at the SDF residual scale. All matrix products here
# pin HIGHEST (tests/test_precision.py checks the main path).
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def hat(w):
    """so(3) hat operator: (…,3) -> (…,3,3) skew-symmetric matrix."""
    w = jnp.asarray(w)
    zero = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], zero, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def vee(W):
    """Inverse of `hat`: (…,3,3) -> (…,3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_factors(theta_sq):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3).

    Computed with small-angle Taylor fallbacks so the expressions are
    numerically stable and differentiable at theta = 0.
    """
    theta = jnp.sqrt(jnp.maximum(theta_sq, _EPS * _EPS))
    small = theta_sq < 1e-8
    a = jnp.where(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / theta_sq)
    c = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - jnp.sin(theta)) / (theta_sq * theta))
    return a, b, c


def so3_exp(w):
    """Rodrigues formula: axis-angle (…,3) -> rotation matrix (…,3,3)."""
    w = jnp.asarray(w)
    theta_sq = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_factors(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix (…,3,3) -> axis-angle (…,3).

    Handles theta near 0 (Taylor) and near pi (diagonal extraction).
    """
    R = jnp.asarray(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    theta_sq = theta * theta

    # Generic branch: w = theta/(2 sin theta) * vee(R - R^T)
    sin_theta = jnp.sin(theta)
    # factor = theta / (2 sin theta), Taylor near 0: 1/2 + theta^2/12
    near_zero = theta < 1e-4
    safe_sin = jnp.where(jnp.abs(sin_theta) < _EPS, 1.0, sin_theta)
    factor = jnp.where(near_zero, 0.5 + theta_sq / 12.0, theta / (2.0 * safe_sin))
    w_generic = factor[..., None] * vee(R - jnp.swapaxes(R, -1, -2))

    # Near-pi branch: |sin theta| small but trace ~ -1.
    # R = I + 2/theta^2 * W^2 (approx) => diag gives axis magnitudes.
    # axis_i^2 = (R_ii + 1) / 2  (for theta = pi exactly)
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.maximum((diag + 1.0) * 0.5, 0.0)
    axis = jnp.sqrt(axis_sq)
    # fix signs using off-diagonal sums: axis_i*axis_j = (R_ij + R_ji)/4 (theta=pi)
    # pick the largest component positive, derive others from products
    k = jnp.argmax(axis_sq, axis=-1)

    def _sign_fix(R, axis, k):
        # R, axis for one item; k scalar
        off = jnp.array(
            [
                (R[0, 1] + R[1, 0]) * 0.25,
                (R[0, 2] + R[2, 0]) * 0.25,
                (R[1, 2] + R[2, 1]) * 0.25,
            ]
        )

        def from0(_):
            a0 = axis[0]
            s1 = jnp.where(off[0] < 0, -1.0, 1.0)
            s2 = jnp.where(off[1] < 0, -1.0, 1.0)
            return jnp.stack([a0, s1 * axis[1], s2 * axis[2]])

        def from1(_):
            a1 = axis[1]
            s0 = jnp.where(off[0] < 0, -1.0, 1.0)
            s2 = jnp.where(off[2] < 0, -1.0, 1.0)
            return jnp.stack([s0 * axis[0], a1, s2 * axis[2]])

        def from2(_):
            a2 = axis[2]
            s0 = jnp.where(off[1] < 0, -1.0, 1.0)
            s1 = jnp.where(off[2] < 0, -1.0, 1.0)
            return jnp.stack([s0 * axis[0], s1 * axis[1], a2])

        return jax.lax.switch(k, [from0, from1, from2], None)

    if R.ndim == 2:
        axis_fixed = _sign_fix(R, axis, k)
    else:
        flat_R = R.reshape(-1, 3, 3)
        flat_axis = axis.reshape(-1, 3)
        flat_k = k.reshape(-1)
        axis_fixed = jax.vmap(_sign_fix)(flat_R, flat_axis, flat_k).reshape(axis.shape)

    norm = jnp.linalg.norm(axis_fixed, axis=-1, keepdims=True)
    axis_unit = axis_fixed / jnp.maximum(norm, _EPS)
    w_near_pi = theta[..., None] * axis_unit

    near_pi = cos_theta < -0.999
    return jnp.where(near_pi[..., None], w_near_pi, w_generic)


def se3_exp(xi):
    """se(3) exp: twist (…,6) [v, w] -> (R (…,3,3), t (…,3)).

    Twist convention matches Sophus: first three = translational part v,
    last three = rotational part w; t = V(w) @ v.
    """
    xi = jnp.asarray(xi)
    v = xi[..., :3]
    w = xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    a, b, c = _sinc_factors(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = _einsum("...ij,...j->...i", V, v)
    return R, t


def se3_log(R, t):
    """Inverse of `se3_exp`: -> twist (…,6) [v, w]."""
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    a, b, _ = _sinc_factors(theta_sq)
    W = hat(w)
    W2 = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    # V^{-1} = I - 1/2 W + (1/theta^2)(1 - a/(2b)) W^2
    small = theta_sq < 1e-8
    safe_theta_sq = jnp.maximum(theta_sq, _EPS)
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - a / (2.0 * b)) / safe_theta_sq,
    )
    V_inv = eye - 0.5 * W + coef[..., None, None] * W2
    v = _einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def se3_mul(Ra, ta, Rb, tb):
    """Compose two SE(3) elements: (Ra,ta) * (Rb,tb)."""
    return _mm(Ra, Rb), _einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inv(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -_einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, points):
    """Apply pose to points of shape (…,3)."""
    return _einsum("...ij,...j->...i", R, points) + t


def identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype)


# ---------------------------------------------------------------------------
# Quaternion conversions (TUM trajectory format: tx ty tz qx qy qz qw;
# reference writes these at cpp/depth_scanning/src/main_scan_3d.cpp:267-280)
# ---------------------------------------------------------------------------


def quat_to_rotmat(q):
    """Unit quaternion (…,4) in (qx, qy, qz, qw) order -> (…,3,3)."""
    q = jnp.asarray(q)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def rotmat_to_quat(R):
    """Rotation matrix (3,3) -> quaternion (4,) in (qx, qy, qz, qw) order.

    Shepperd's method via the four-branch max trick, numerically stable.
    """
    R = jnp.asarray(R)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    trace = m00 + m11 + m22

    def case_w(_):
        s = jnp.sqrt(jnp.maximum(trace + 1.0, _EPS)) * 2.0
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s])

    def case_x(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
        return jnp.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s])

    def case_y(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2.0
        return jnp.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s])

    def case_z(_):
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2.0
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s])

    cands = jnp.stack([trace, m00, m11, m22])
    idx = jnp.argmax(cands)
    q = jax.lax.switch(idx, [case_w, case_x, case_y, case_z], None)
    return q / jnp.linalg.norm(q)
