"""GradSdfMap: the gradient-SDF volume model (flagship map type).

Stateful wrapper bundling the block-sparse grid, visibility bitfield, frame
counter, and camera LUT cache, with the same API surface as the reference's
`Sdf` base + `MapGradPixelSdf` (`cpp/include/sdf_tracker/Sdf.h:113-145`,
`MapGradPixelSdf.h`): `setup / update / tsdf / weights / extract_mesh /
extract_pc / save_sdf`. Device state lives in jax arrays; methods are thin
shells over jitted ops so a full track+fuse frame stays on-device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ops import fusion, normals, query
from ..ops import voxel_grid as vg
from ..utils.ply import save_point_cloud_ply


class GradSdfMap:
    def __init__(self, cfg: PipelineConfig, with_vis: bool = False):
        self.cfg = cfg
        self.grid = vg.create(cfg.grid)
        self.counter = 0
        # machine-readable growth trace (capacity/world-range events), dumped
        # by scan3d --metrics-json so headless runs can't silently double
        # their memory
        self.growth_events: list = []
        self.cache: Optional[normals.NormalEstimatorCache] = None
        kf_words = max(1, -(-cfg.photo_ba.max_recorded_keyframes // 32))
        self.vis = (
            jnp.zeros(
                (cfg.grid.num_blocks, cfg.grid.voxels_per_block, kf_words),
                dtype=jnp.uint32,
            )
            if with_vis
            else None
        )
        self._fuse_jit = None
        self.mesh = None  # set via attach_mesh for multi-device operation

    # -- multi-device -------------------------------------------------------
    def attach_mesh(self, mesh):
        """Switch the map to multi-device operation on `mesh`: the grid's
        per-voxel storage is resident-sharded over the mesh's block axis
        (parallel/sharding.shard_grid) and `update` fuses via
        `sharded_fuse_frame`, so per-device volume memory is 1/D_b. Growth
        re-shards. Call after any checkpoint restore (scan3d does)."""
        from ..parallel import sharding

        assert self.vis is None, "visibility recording is single-device only"
        self.mesh = mesh
        self.grid = sharding.shard_grid(mesh, self.grid)
        self._fuse_jit = None

    def _reshard(self):
        if self.mesh is not None:
            from ..parallel import sharding

            self.grid = sharding.shard_grid(self.mesh, self.grid)

    # -- camera cache -------------------------------------------------------
    def ensure_cache(self, K: np.ndarray, width: int, height: int):
        if self.cache is None:
            self.cache = normals.build_cache(
                width, height, K, self.cfg.fusion.normal_window
            )

    # -- fusion -------------------------------------------------------------
    def setup(self, depth, K, pose=None, kf_slot: int = -1):
        """First-frame integration with identity pose (Sdf.h:119-121)."""
        R = jnp.eye(3, dtype=jnp.float32)
        t = jnp.zeros(3, dtype=jnp.float32)
        if pose is not None:
            R, t = pose
        self.update(depth, K, (R, t), kf_slot=kf_slot)

    def update(self, depth, K, pose, kf_slot: int = -1):
        """Integrate one depth frame (MapGradPixelSdf.cpp:43-122)."""
        depth = jnp.asarray(depth, jnp.float32)
        H, W = depth.shape
        self.ensure_cache(np.asarray(K), W, H)
        R, t = pose
        if self._fuse_jit is None:
            gcfg, fcfg = self.cfg.grid, self.cfg.fusion
            with_vis = self.vis is not None
            mesh = self.mesh

            @jax.jit
            def _fuse(grid, vis, depth, R, t, kf_slot):
                if mesh is not None:
                    from ..parallel import sharding

                    return sharding.sharded_fuse_frame(
                        mesh, grid, depth, self.cache, R, t, gcfg, fcfg
                    ), vis
                if with_vis:
                    return fusion.fuse_frame(
                        grid, depth, self.cache, R, t, gcfg, fcfg,
                        vis=vis, kf_slot=kf_slot,
                    )
                return fusion.fuse_frame(grid, depth, self.cache, R, t, gcfg, fcfg), vis

            self._fuse_jit = _fuse
        self.grid, self.vis = self._fuse_jit(
            self.grid, self.vis, depth, jnp.asarray(R, jnp.float32),
            jnp.asarray(t, jnp.float32), jnp.int32(kf_slot),
        )
        self.counter += 1
        if bool(self.grid.overflow):
            self._grow()
        if int(self.grid.oob_samples) > 0:
            self._grow_directory()

    def _grow(self):
        """Episodic host-side rehash on capacity overflow (vg.grow)."""
        import dataclasses

        old_blocks = self.cfg.grid.num_blocks
        self.grid, new_gcfg = vg.grow(self.grid, self.cfg.grid)
        self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)
        if self.vis is not None:
            pad = new_gcfg.num_blocks - old_blocks
            self.vis = jnp.concatenate(
                [self.vis, jnp.zeros((pad,) + self.vis.shape[1:], jnp.uint32)]
            )
        self._fuse_jit = None  # config changed -> retrace
        self._reshard()  # growth concatenates host-placed arrays
        from ..utils.logging_util import get_logger

        get_logger().warning("Grid grown to %d blocks", new_gcfg.num_blocks)
        self.growth_events.append(
            {"frame": self.counter, "kind": "capacity",
             "num_blocks": int(new_gcfg.num_blocks)}
        )

    def _grow_directory(self):
        """Enlarge the directory's world range when fusion reported samples
        beyond it (reference equivalence: unbounded tsdf_[vi] upsert,
        MapGradPixelSdf.cpp:108). The reporting frame's out-of-range samples
        are lost; subsequent frames integrate."""
        import dataclasses

        lost = int(self.grid.oob_samples)
        self.grid, new_gcfg, grew = vg.handle_oob_growth(
            self.grid, self.cfg.grid)
        self.growth_events.append(
            {"frame": self.counter, "kind": "world_range",
             "dir_dim": int(new_gcfg.dir_dim), "oob_samples": lost,
             "grew": grew}
        )
        if grew:
            self.cfg = dataclasses.replace(self.cfg, grid=new_gcfg)
            self._fuse_jit = None  # config changed -> retrace
            self._reshard()

    # -- queries ------------------------------------------------------------
    def tsdf(self, points):
        """Semi-implicit SDF + gradient at world points (…,3)."""
        phi, grad, _ = query.tsdf_grad(self.grid, jnp.asarray(points, jnp.float32),
                                       self.cfg.grid, self.cfg.fusion)
        return phi, grad

    def weights(self, points):
        return query.weights_at(self.grid, jnp.asarray(points, jnp.float32),
                                self.cfg.grid)

    # -- export (host side) -------------------------------------------------
    def occupied(self):
        """Host view: (voxel_idx [M,3], dist [M], weight [M], grad [M,3])
        for all voxels in allocated blocks."""
        na = int(self.grid.num_active)
        gcfg = self.cfg.grid
        bc = np.asarray(self.grid.block_coords[:na])  # [M,3]
        vox = np.asarray(vg.block_local_to_voxel(jnp.asarray(bc), gcfg))
        vox = vox.reshape(-1, 3)
        dist = np.asarray(self.grid.dist[:na]).reshape(-1)
        weight = np.asarray(self.grid.weight[:na]).reshape(-1)
        grad = np.asarray(self.grid.grad[:na]).reshape(-1, 3)
        return vox, dist, weight, grad

    def extract_pc(self, filename: str, min_weight: float = 5.0) -> bool:
        """Oriented point cloud export (MapGradPixelSdf.cpp:177-220):
        voxels with weight >= min_weight whose displacement d = dist * 1.2 ghat
        stays inside the half-voxel box emit point (center - d), normal -1.2 ghat."""
        vox, dist, weight, grad = self.occupied()
        vs = self.cfg.grid.voxel_size
        scale = self.cfg.fusion.grad_scale
        norms = np.linalg.norm(grad, axis=-1)
        ok = (weight >= min_weight) & (norms > 1e-12)
        g = scale * grad[ok] / norms[ok, None]
        d = dist[ok, None] * g
        inside = np.all(np.abs(d) < 0.5 * vs, axis=-1)
        pts = vox[ok][inside] * vs - d[inside]
        nrm = -g[inside]
        return save_point_cloud_ply(filename, pts, normals=nrm)

    def extract_mesh(self, filename: str) -> bool:
        from ..ops import marching_cubes as mc

        verts, faces = mc.extract_mesh(self.grid, self.cfg.grid)
        from ..utils.ply import save_mesh_ply

        return save_mesh_ply(filename, verts, faces)

    def save_sdf(self, filename: str) -> bool:
        """Sparse SDF text dump, format-compatible with the reference
        (`MapGradPixelSdf.cpp:222-296`): grid_info + `lin_idx value` lines in
        files _sdf_d/_sdf_weight/_sdf_n0/_sdf_n1/_sdf_n2 — consumed by the
        gradient-accuracy analysis (analysis/gradient_analysis.py)."""
        vox, dist, weight, grad = self.occupied()
        occupied = weight > 0
        vox, dist, weight, grad = (
            vox[occupied], dist[occupied], weight[occupied], grad[occupied]
        )
        if vox.size == 0:
            return False
        vmin = vox.min(axis=0)
        vmax = vox.max(axis=0)
        dim = vmax - vmin + 1
        lin = (
            dim[0] * dim[1] * (vox[:, 2] - vmin[2])
            + dim[0] * (vox[:, 1] - vmin[1])
            + (vox[:, 0] - vmin[0])
        )
        vs = self.cfg.grid.voxel_size
        with open(filename + "_grid_info.txt", "w") as f:
            f.write(f"voxel size: {vs}\n")
            f.write(f"voxel dim: {dim[0]} {dim[1]} {dim[2]}\n")
            f.write(f"voxel min: {vmin[0]} {vmin[1]} {vmin[2]}\n")
            f.write(f"voxel max: {vmax[0]} {vmax[1]} {vmax[2]}\n")
        for suffix, values in [
            ("_sdf_d.txt", dist),
            ("_sdf_weight.txt", weight),
            ("_sdf_n0.txt", grad[:, 0]),
            ("_sdf_n1.txt", grad[:, 1]),
            ("_sdf_n2.txt", grad[:, 2]),
        ]:
            with open(filename + suffix, "w") as f:
                for li, v in zip(lin, values):
                    f.write(f"{li} {v}\n")
        return True
