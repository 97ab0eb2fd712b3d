"""Pure-NumPy golden-model of the reference fusion semantics.

Implements the sequential per-sample update loop of
`MapGradPixelSdf::update` (MapGradPixelSdf.cpp:81-117) — running weighted
mean, weight accumulation, gradient accumulation, visibility list — against
which the vectorized/scattered fusion op is checked bit-for-fixed-point.
"""

import numpy as np


def weight_fn(sdf, T):
    if sdf <= 0.0:
        return 1.0
    if sdf <= T:
        return 1.0 - sdf / T
    return 0.0


def fuse_oracle(
    depth, normals, x0, y0, n_sq_inv, R, t, voxel_size, T,
    z_min=0.5, z_max=3.5, state=None, frame_id=0,
):
    """state: dict voxel_tuple -> dict(dist, weight, grad, vis:set)."""
    if state is None:
        state = {}
    H, W = depth.shape
    factor = int(np.floor(T / voxel_size))
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    for m in range(H):
        for n in range(W):
            z = float(depth[m, n])
            if z <= z_min or z >= z_max:
                continue
            h = np.array([x0[m, n], y0[m, n], 1.0])
            nvec = normals[m, n].astype(np.float64)
            if not np.all(np.isfinite(nvec)):
                continue
            if nvec @ nvec < 0.1:
                continue
            ndh = nvec @ h
            if ndh * ndh * n_sq_inv[m, n] < 0.25:
                continue
            Rh = R @ h
            Rn = R @ nvec
            for k in range(-factor, factor + 1):
                point = (z + k * voxel_size) * Rh + t
                vi = tuple(np.round(point / voxel_size).astype(int))
                center = np.array(vi) * voxel_size
                sdf = (R.T @ (center - t))[2] - z
                w = weight_fn(sdf, T)
                if w > 0:
                    v = state.setdefault(
                        vi,
                        {"dist": 0.0, "weight": 0.0, "grad": np.zeros(3), "vis": set()},
                    )
                    v["weight"] += w
                    trunc = np.clip(sdf, -T, T)
                    v["dist"] += (trunc - v["dist"]) * w / v["weight"]
                    v["grad"] += w * Rn
                    v["vis"].add(frame_id)
    return state
