"""Block-sparse voxel grid: dense block directory + SoA voxel blocks.

Replaces the reference's pointer-stable CPU hash map
(`cpp/include/sdf_tracker/MapGradPixelSdf.h:65-68`:
`phmap::parallel_node_hash_map<Vec3i, SdfVoxel>`) with a design for
accelerator memory: voxels live in dense 8x8x8 blocks stored as
structure-of-arrays in device memory, and a **dense block directory** — an int32 array
over the representable block volume (dir_dim^3, 8 MB at the default 128^3)
— maps block coordinates to block slots by pure arithmetic + one direct
gather. Everything — lookup, insertion, scatter updates — is vectorized
with static shapes, so the whole fusion/tracking pipeline stays inside one
`jit`.

Design note: open-addressing hashing, as GPU voxel-hashing pipelines use,
needs a chain of probes per lookup, and random access is the frame's
dominant cost. A dense directory does one gather per query, needs no
collision handling,
and makes insertion a single scatter-min claim — deterministic, no
atomics/mutexes (contrast `MapGradPixelSdfOmp.cpp:112-121`). Memory is the
trade: dir_dim^3 * 4 bytes (8 MB covers +-5.1 m at 1 cm voxels; 256^3 =
67 MB covers +-10 m).

Terminology: a "key" is the directory's linear index for a block
(EMPTY_KEY = -1 for out-of-range/invalid), produced by `pack_key_xyz` from
block coordinates.

Other differences from the CPU design:
  * CPU: `float` running weighted mean updated sequentially per sample
    (`MapGradPixelSdf.cpp:108-116`). Here: commutative per-frame
    accumulators (sum w, sum w·sdf, sum w·n) merged once — order-independent
    and exactly equal to the sequential running mean in exact arithmetic.
  * Coordinate math is carried as separate x/y/z component arrays in hot
    paths rather than [N, 3] arrays with a 3-wide minor axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import GridConfig

EMPTY_KEY = jnp.int32(-1)
COARSE_FACTOR = 4  # blocks per coarse occupancy cell edge
INT32_MAX = jnp.int32(2**31 - 1)


class VoxelGrid(NamedTuple):
    """Pytree holding the sparse SDF volume.

    Per-voxel fields mirror `SdfVoxel{dist, grad, weight}`
    (`cpp/include/sdf_voxel/SdfVoxel.h:45-57`); `dist` stores the running
    weighted mean of truncated projective SDF samples, `grad` the weighted
    sum of world-frame (inward) normals, `weight` the accumulated fusion
    weight.
    """

    # dense block directory: block dir-index -> slot (-1 = unallocated)
    directory: jax.Array    # int32 [dir_dim^3]
    # coarse occupancy mip over 4^3-block cells (1 = any block allocated):
    # lets the raycaster DDA through far empty space in 4-block steps
    coarse_occ: jax.Array   # int32 [(dir_dim/4)^3]
    num_active: jax.Array   # int32 [], allocated block count
    overflow: jax.Array     # bool [], sticky capacity-overflow flag
    # samples that fell outside the directory's world range (the reference
    # hash map is unbounded, MapGradPixelSdf.h:65-68; our directory is not —
    # fusion counts the loss and the driver grows the directory episodically,
    # see grow_directory)
    oob_samples: jax.Array  # int32 [], sticky out-of-range sample counter
    # block store (SoA), voxel-linearized x-fastest within each block.
    # gradient components are separate scalar fields: a [.., 3] array would
    # make the hot queries gather 3-wide rows
    block_coords: jax.Array  # int32 [num_blocks, 3]
    dist: jax.Array          # f32 [num_blocks, B^3]
    weight: jax.Array        # f32 [num_blocks, B^3]
    grad_x: jax.Array        # f32 [num_blocks, B^3]
    grad_y: jax.Array
    grad_z: jax.Array

    @property
    def num_blocks(self) -> int:
        return self.dist.shape[0]

    @property
    def voxels_per_block(self) -> int:
        return self.dist.shape[1]

    @property
    def grad(self) -> jax.Array:
        """Stacked [num_blocks, B^3, 3] view for host-side consumers.
        Hot jitted code must use the component fields directly."""
        return jnp.stack([self.grad_x, self.grad_y, self.grad_z], axis=-1)


def create(cfg: GridConfig) -> VoxelGrid:
    nb, vpb = cfg.num_blocks, cfg.voxels_per_block
    d3 = cfg.dir_dim**3
    c3 = (cfg.dir_dim // COARSE_FACTOR) ** 3
    return VoxelGrid(
        directory=jnp.full((d3,), EMPTY_KEY, dtype=jnp.int32),
        coarse_occ=jnp.zeros((c3,), dtype=jnp.int32),
        num_active=jnp.zeros((), dtype=jnp.int32),
        overflow=jnp.zeros((), dtype=bool),
        oob_samples=jnp.zeros((), dtype=jnp.int32),
        block_coords=jnp.zeros((nb, 3), dtype=jnp.int32),
        dist=jnp.zeros((nb, vpb), dtype=jnp.float32),
        weight=jnp.zeros((nb, vpb), dtype=jnp.float32),
        grad_x=jnp.zeros((nb, vpb), dtype=jnp.float32),
        grad_y=jnp.zeros((nb, vpb), dtype=jnp.float32),
        grad_z=jnp.zeros((nb, vpb), dtype=jnp.float32),
    )


# ---------------------------------------------------------------------------
# coordinate <-> directory index
# ---------------------------------------------------------------------------


def pack_key_xyz(x: jax.Array, y: jax.Array, z: jax.Array,
                 cfg: GridConfig) -> jax.Array:
    """Block coordinate components -> directory linear index (int32).

    Out-of-range coordinates return EMPTY_KEY (treated as unmappable — the
    sample is dropped, mirroring "outside the representable volume").
    Component-array API: hot paths keep x/y/z as separate full-size arrays.
    """
    D = cfg.dir_dim
    half = D // 2
    xs = x + half
    ys = y + half
    zs = z + half
    in_range = (
        (xs >= 0) & (xs < D) & (ys >= 0) & (ys < D) & (zs >= 0) & (zs < D)
    )
    key = (xs * D + ys) * D + zs
    return jnp.where(in_range, key, EMPTY_KEY)


def pack_key(block_coords: jax.Array, cfg: GridConfig) -> jax.Array:
    """(…,3)-array convenience wrapper over pack_key_xyz."""
    return pack_key_xyz(
        block_coords[..., 0], block_coords[..., 1], block_coords[..., 2], cfg
    )


def unpack_key(key: jax.Array, cfg: GridConfig) -> jax.Array:
    D = cfg.dir_dim
    half = D // 2
    z = key % D
    y = (key // D) % D
    x = key // (D * D)
    return jnp.stack([x - half, y - half, z - half], axis=-1)


# ---------------------------------------------------------------------------
# voxel <-> block addressing
# ---------------------------------------------------------------------------


def point_to_voxel(points: jax.Array, voxel_size: float) -> jax.Array:
    """World point -> nearest voxel index (reference `float2vox`,
    `MapGradPixelSdf.h:74-77`: round(p / voxel_size))."""
    return jnp.round(points / voxel_size).astype(jnp.int32)


def voxel_to_point(voxel_idx: jax.Array, voxel_size: float) -> jax.Array:
    """Voxel index -> world-space voxel center (reference `vox2float`)."""
    return voxel_idx.astype(jnp.float32) * voxel_size


def voxel_to_block(voxel_idx: jax.Array, cfg: GridConfig):
    """Split voxel index into (block coords, intra-block linear offset)."""
    b = cfg.block_shape
    block = jnp.floor_divide(voxel_idx, b)
    local = voxel_idx - block * b
    local_lin = (local[..., 2] * b + local[..., 1]) * b + local[..., 0]
    return block, local_lin


def block_local_to_voxel(block_coords: jax.Array, cfg: GridConfig) -> jax.Array:
    """All B^3 voxel indices of given blocks: (…,3) -> (…,B^3,3)."""
    b = cfg.block_shape
    r = jnp.arange(b, dtype=jnp.int32)
    lx = jnp.tile(r, b * b)
    ly = jnp.tile(jnp.repeat(r, b), b)
    lz = jnp.repeat(r, b * b)
    local = jnp.stack([lx, ly, lz], axis=-1)  # [B^3, 3], x fastest
    return block_coords[..., None, :] * b + local


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------


def lookup_keys(grid: VoxelGrid, keys: jax.Array, cfg: GridConfig) -> jax.Array:
    """Directory indices (…,) -> block slots; -1 where absent/invalid.

    One direct gather — no probing, no collisions (see module docstring).
    """
    d3 = cfg.dir_dim**3
    safe = jnp.clip(keys, 0, d3 - 1)
    slot = grid.directory[safe]
    return jnp.where(keys >= 0, slot, -1)


def lookup_keys_dedup(grid: VoxelGrid, keys: jax.Array, cfg: GridConfig,
                      K: int, cap_per_ray: int = 5) -> jax.Array:
    """lookup_keys for per-ray sample walks, paying one random gather per
    DISTINCT consecutive block instead of per sample.

    `keys` is flat [C*K] laid out as C rays x K consecutive walk samples
    (fusion's 2*floor(T/vs)+1 steps): consecutive samples share their
    block ~4-5x on average, so only positions where the key CHANGES are
    gathered (nonzero-compacted to a C*cap_per_ray buffer; rays with more
    distinct blocks than cap fall back to the full-width gather via
    lax.cond) and the slots forward-filled along the walk (log-shift
    fill). Bit-identical to lookup_keys (equality-tested)."""
    flat = keys.reshape(-1, K)
    C = flat.shape[0]
    change = jnp.concatenate(
        [jnp.ones((C, 1), bool), flat[:, 1:] != flat[:, :-1]], axis=1)
    fchange = change.reshape(-1)
    cnt = jnp.sum(fchange.astype(jnp.int32))
    cap = C * cap_per_ray

    def dedup():
        (idx,) = jnp.nonzero(fchange, size=cap, fill_value=0)
        valid = jnp.arange(cap, dtype=jnp.int32) < cnt
        got = lookup_keys(grid, keys.reshape(-1)[idx], cfg)  # >= -1
        # sentinel -2 = "not a change position": forward-fill from the
        # last change position on the left (same block -> same slot)
        sparse = jnp.full((C * K,), -2, jnp.int32).at[
            jnp.where(valid, idx, C * K)
        ].set(got, mode="drop")
        ss = sparse.reshape(C, K)
        shift = 1
        while shift < K:
            shifted = jnp.concatenate(
                [jnp.full((C, shift), -2, jnp.int32), ss[:, :-shift]],
                axis=1)
            ss = jnp.where(ss == -2, shifted, ss)
            shift *= 2
        return ss.reshape(keys.shape)

    def full():
        return lookup_keys(grid, keys, cfg)

    return jax.lax.cond(cnt <= cap, dedup, full)


def lookup_coarse(grid: VoxelGrid, points: jax.Array, cfg: GridConfig):
    """World points (…,3) -> coarse-cell occupancy (bool); False outside
    the representable volume. One gather from a tiny (128 KB) array."""
    cell = cfg.block_shape * COARSE_FACTOR  # voxels per coarse cell edge
    D = cfg.dir_dim
    C = D // COARSE_FACTOR
    half = C // 2
    vi = point_to_voxel(points, cfg.voxel_size)
    cx = jnp.floor_divide(vi[..., 0], cell) + half
    cy = jnp.floor_divide(vi[..., 1], cell) + half
    cz = jnp.floor_divide(vi[..., 2], cell) + half
    in_range = (
        (cx >= 0) & (cx < C) & (cy >= 0) & (cy < C) & (cz >= 0) & (cz < C)
    )
    lin = jnp.clip((cx * C + cy) * C + cz, 0, C * C * C - 1)
    return (grid.coarse_occ[lin] > 0) & in_range


def lookup_voxels(grid: VoxelGrid, voxel_idx: jax.Array, cfg: GridConfig):
    """Voxel indices (…,3) -> (linear store index (…,), present mask (…,)).

    Linear index addresses the flattened [num_blocks * B^3] SoA arrays;
    absent voxels get index 0 with present=False (callers mask).
    """
    block, local = voxel_to_block(voxel_idx, cfg)
    keys = pack_key(block, cfg)
    slot = lookup_keys(grid, keys, cfg)
    present = slot >= 0
    lin = jnp.where(present, slot, 0) * cfg.voxels_per_block + local
    return lin, present


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------


def insert_new(grid: VoxelGrid, keys: jax.Array, want: jax.Array,
               cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for keys where `want` is set (duplicates allowed).

    Deterministic parallel claim: every new key scatter-mins its candidate
    index into a claims array; per distinct key the lowest candidate wins
    and is assigned the next block slot in candidate order (stable ->
    bit-for-bit reproducible). Capacity overflow sets the sticky flag and
    drops the claim (samples into it are dropped that frame and recovered
    on later frames once the grid has grown).
    """
    d3 = cfg.dir_dim**3
    n = keys.shape[0]
    cand_ids = jnp.arange(n, dtype=jnp.int32)

    claims = jnp.full((d3,), INT32_MAX, dtype=jnp.int32)
    claims = claims.at[jnp.where(want, keys, d3)].min(
        jnp.where(want, cand_ids, INT32_MAX), mode="drop"
    )
    won = want & (claims[jnp.clip(keys, 0, d3 - 1)] == cand_ids)

    order = jnp.cumsum(won.astype(jnp.int32)) - 1
    new_slot = grid.num_active + order
    ok = won & (new_slot < grid.num_blocks)
    overflow = grid.overflow | jnp.any(won & ~ok)

    directory = grid.directory.at[jnp.where(ok, keys, d3)].set(
        jnp.where(ok, new_slot, -1), mode="drop"
    )
    # coarse occupancy: mark the 4^3-block cell of every new block
    D = cfg.dir_dim
    C = D // COARSE_FACTOR
    kz = keys % D
    ky = (keys // D) % D
    kx = keys // (D * D)
    ckey = ((kx // COARSE_FACTOR) * C + (ky // COARSE_FACTOR)) * C + (
        kz // COARSE_FACTOR
    )
    coarse_occ = grid.coarse_occ.at[jnp.where(ok, ckey, C * C * C)].max(
        1, mode="drop"
    )
    coords = unpack_key(jnp.maximum(keys, 0), cfg)
    block_coords = grid.block_coords.at[
        jnp.where(ok, new_slot, grid.num_blocks)
    ].set(jnp.where(ok[:, None], coords, 0), mode="drop")

    return grid._replace(
        directory=directory,
        coarse_occ=coarse_occ,
        num_active=grid.num_active + jnp.sum(ok.astype(jnp.int32)),
        overflow=overflow,
        block_coords=block_coords,
    )


def insert_keys(grid: VoxelGrid, keys: jax.Array, cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for the given directory indices (1-D; duplicates and
    EMPTY_KEY padding allowed — no pre-deduplication needed)."""
    existing = lookup_keys(grid, keys, cfg)
    want = (keys >= 0) & (existing < 0)
    return insert_new(grid, keys, want, cfg)


def ensure_blocks(grid: VoxelGrid, voxel_idx: jax.Array, valid: jax.Array,
                  cfg: GridConfig) -> VoxelGrid:
    """Allocate blocks for all (valid) voxel indices that need them
    (claim-based insert; duplicates fine, no deduplication needed)."""
    block, _ = voxel_to_block(voxel_idx.reshape(-1, 3), cfg)
    keys = pack_key(block, cfg)
    keys = jnp.where(valid.reshape(-1), keys, EMPTY_KEY)
    return insert_keys(grid, keys, cfg)


# ---------------------------------------------------------------------------
# growth (episodic host-side capacity increase)
# ---------------------------------------------------------------------------


def grow(grid: VoxelGrid, cfg: GridConfig, factor: int = 2):
    """Return (bigger_grid, bigger_cfg): block capacity scaled by `factor`.

    The directory is spatial (size fixed by dir_dim) and slot ids are
    preserved, so growth is a pure array enlargement — no rehash. Replaces
    phmap's automatic growth (SURVEY.md §7 "hard parts"): capacity can't
    resize under jit, so fusion sets the sticky `overflow` flag and the
    driver grows the arrays between frames.
    """
    import dataclasses

    new_cfg = dataclasses.replace(cfg, num_blocks=cfg.num_blocks * factor)
    nb, vpb = cfg.num_blocks, cfg.voxels_per_block
    pad = new_cfg.num_blocks - nb

    def ext(a):
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
        )

    big = grid._replace(
        block_coords=ext(grid.block_coords),
        dist=ext(grid.dist),
        weight=ext(grid.weight),
        grad_x=ext(grid.grad_x),
        grad_y=ext(grid.grad_y),
        grad_z=ext(grid.grad_z),
        overflow=jnp.zeros((), bool),
    )
    return big, new_cfg


def grow_directory(grid: VoxelGrid, cfg: GridConfig, factor: int = 2):
    """Return (grid, cfg) with the directory's world range scaled by
    `factor` (dir_dim doubled by default -> representable volume 8x).

    The reference's hash map is unbounded (`MapGradPixelSdf.h:65-68`); the
    dense directory is not, so fusion counts valid samples that fall outside
    (`oob_samples`) and the driver calls this between frames. Block storage
    and slot ids are untouched — only the spatial index is rebuilt from
    `block_coords` (one scatter), plus the coarse occupancy mip. Memory:
    dir_dim^3 * 4 B (256^3 = 67 MB, 512^3 = 536 MB — cap growth around
    there and accept range loss beyond, like any bounded-world system).
    """
    import dataclasses

    new_cfg = dataclasses.replace(cfg, dir_dim=cfg.dir_dim * factor)
    D = new_cfg.dir_dim
    d3 = D**3
    C = D // COARSE_FACTOR
    nb = grid.num_blocks
    slots = jnp.arange(nb, dtype=jnp.int32)
    active = slots < grid.num_active

    keys = pack_key(grid.block_coords, new_cfg)
    keys = jnp.where(active, keys, d3)
    directory = jnp.full((d3,), EMPTY_KEY, jnp.int32).at[keys].set(
        slots, mode="drop"
    )

    half = C // 2
    cx = jnp.floor_divide(grid.block_coords[:, 0], COARSE_FACTOR) + half
    cy = jnp.floor_divide(grid.block_coords[:, 1], COARSE_FACTOR) + half
    cz = jnp.floor_divide(grid.block_coords[:, 2], COARSE_FACTOR) + half
    ckey = (cx * C + cy) * C + cz
    coarse = jnp.zeros((C * C * C,), jnp.int32).at[
        jnp.where(active, ckey, C * C * C)
    ].max(1, mode="drop")

    big = grid._replace(
        directory=directory,
        coarse_occ=coarse,
        oob_samples=jnp.zeros((), jnp.int32),
    )
    return big, new_cfg


MAX_DIR_DIM = 512  # 512^3 int32 = 536 MB spatial index


def handle_oob_growth(grid: VoxelGrid, cfg: GridConfig):
    """Shared driver policy for out-of-range samples: grow the directory
    (factor 2, up to MAX_DIR_DIM) when fusion reported any, else warn and
    clear the counter. Returns (grid, cfg, grew: bool). Events go through
    the structured logger (utils.logging_util); callers that keep a
    growth_events list (GradSdfMap/PixelSdfMap) also record them for
    --metrics-json observability."""
    from ..utils.logging_util import get_logger

    lost = int(grid.oob_samples)
    if lost == 0:
        return grid, cfg, False
    if cfg.dir_dim >= MAX_DIR_DIM:
        get_logger().warning(
            "%d samples beyond the maximum world range (dir_dim=%d) "
            "were dropped", lost, cfg.dir_dim)
        return grid._replace(oob_samples=jnp.zeros((), jnp.int32)), cfg, False
    grid, cfg = grow_directory(grid, cfg)
    half = cfg.dir_dim // 2 * cfg.block_shape * cfg.voxel_size
    get_logger().warning(
        "Directory grown to dir_dim=%d (world range +-%.2f m); %d "
        "out-of-range samples from the triggering frame were dropped",
        cfg.dir_dim, half, lost)
    return grid, cfg, True


# ---------------------------------------------------------------------------
# field access helpers
# ---------------------------------------------------------------------------


def flat_field(x: jax.Array) -> jax.Array:
    """View a [num_blocks, B^3, ...] field as [num_blocks * B^3, ...]."""
    return x.reshape((-1,) + x.shape[2:])
