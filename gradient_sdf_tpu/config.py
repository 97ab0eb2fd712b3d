"""Central configuration for the framework.

The reference scatters its constants across classes and `main`s
(`cpp/include/sdf_tracker/Sdf.h:67-68,97-101`, `RigidOptimizer.h:70-76`,
`ps_optimizer/PhotometricOptimizer.h:50-67`, `main_scan_3d.cpp:75-90`,
`main_photo_ba.cpp:107-121`). Here everything lives in one dataclass tree
with per-dataset presets, and the CLI flag names/semantics of the reference
apps (`--input --results --voxel-size --trunc --scan-type --data-type …`)
map 1:1 onto these fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Block-sparse voxel grid geometry + capacity.

    Replacement for the reference's pointer-stable voxel hash map
    (`MapGradPixelSdf.h:65-68`): voxels live in 8x8x8 blocks stored as dense
    SoA arrays in device memory; a dense block *directory* (dir_dim^3 int32)
    maps block coordinates to block slots by arithmetic + one gather — no
    hashing or probing (rationale: ops/voxel_grid.py module docstring).
    """

    voxel_size: float = 0.01          # --voxel-size default, main_scan_3d.cpp:75
    block_shape: int = 8              # voxels per block edge (8^3 = 512 voxels)
    num_blocks: int = 2 ** 14         # block capacity (16384 blocks = 8.4M voxels)
    dir_dim: int = 128                # directory edge; block coords in
    # [-dir_dim/2, dir_dim/2) -> world range +-(dir_dim/2 * 8 * voxel_size),
    # i.e. +-5.1 m at 1 cm voxels; memory dir_dim^3 * 4 B (8 MB at 128)

    @property
    def voxels_per_block(self) -> int:
        return self.block_shape ** 3


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """TSDF+gradient fusion (reference Sdf.h + MapGradPixelSdf.cpp)."""

    trunc_voxels: float = 5.0         # --trunc: T = trunc_voxels * voxel_size (main_scan_3d.cpp:76,231)
    z_min: float = 0.5                # Sdf.h:67
    z_max: float = 3.5                # Sdf.h:68 (--zmax overridable, main_scan_3d.cpp:77)
    normal_sq_min: float = 0.1        # reject ||n||^2 < 0.1 (MapGradPixelSdf.cpp:95)
    view_angle_cos_sq: float = 0.25   # reject (n.h)^2/||h||^2 < .25 (MapGradPixelSdf.cpp:98)
    grad_scale: float = 1.2           # projective-SDF correction heuristic (MapGradPixelSdf.h:111-114)
    normal_window: int = 11           # FALS window (main_scan_3d.cpp:183: 2*5+1)
    median_blur_depth: bool = False   # 5x5 median-filter the depth before
    # sampling. The reference computes `med_depth` (MapGradPixelSdf.cpp:53)
    # but never reads it (the pixel loop uses raw `depth_`, :85-89), so
    # parity default is OFF; ON gives the denoised variant the reference
    # apparently intended.
    compact_chunk_rays: int = 16 * 1024  # fusion processes valid pixels in
    # compacted chunks of this many rays (adaptive work: cost scales with
    # the frame's valid-pixel count instead of H*W). 0 = disabled
    # (single full-frame pass). Exact semantics either way. The chunk size
    # trades last-chunk padding against per-chunk fixed cost; not yet
    # measured on the H100.
    dedup_lookup: bool = False        # gather block slots only where the
    # key CHANGES along each ray's walk (consecutive samples share their
    # block ~4-5x; vg.lookup_keys_dedup: nonzero-compacted change
    # positions + log-shift forward fill). Bit-identical slots; not yet
    # measured on the H100.
    acc_rows8: bool = False           # per-frame accumulators as ONE
    # [nvox, 8]-row array updated by a single [N, 8]-row scatter-add
    # (payload w, wd, wn_x, wn_y, wn_z + 3 pad columns) instead of 5
    # separate [N] scatter-adds. Identical sums (same adds, same slot
    # order; equality-tested). Kept off: the earlier accelerator measured
    # it slower at the full-capacity destination; not yet measured on the
    # H100.
    fusion_stride: int = 1            # integrate every s-th pixel's ray walk
    # (rows and columns). The reference fuses every pixel (parity default 1);
    # stride 2 quarters the scatter traffic while the ~2-4 mm pixel
    # footprint at VGA still covers every 1 cm band voxel — per-voxel
    # weights scale by ~1/s^2, means stay unbiased. Normals/gates still
    # evaluate on the full image.
    cosine_correction: bool = False   # scale each sample's projective
    # camera-z distance by the FALS-normal incidence cosine -> stores the
    # point-to-plane distance (classic TSDF correction; floored at 0.1).
    # NON-parity, default off: the reference stores the raw projective
    # distance (MapGradPixelSdf.cpp:95-101), whose 1/cos(theta) grazing
    # bias is the measured root cause of both implementations' tracking
    # failure on the all-planar box scene (PARITY.md box stage; scan3d
    # --cosine-fusion + tests/test_box_world.py for the measured rescue).


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Frame-to-model Gauss-Newton tracking (RigidOptimizer.h:70-76)."""

    num_iterations: int = 25
    conv_threshold: float = 1e-3      # converged when ||xi|| < conv_threshold
    damping: float = 1.0
    sampling: int = 1                 # pixel stride
    packed_row_gather: bool = True    # gather (dist, weight, grad) per GN
    # iteration as ONE [*, 8]-row gather from a per-frame packed field
    # array instead of 5 element gathers. Identical math (bit-equal
    # linearization, tests/test_tracker.py); not yet measured on the H100.
    compact_cap_frac: float = 0.5     # depth-valid pixels are compacted once
    # before the GN loop (z-gating is pose-independent) into a buffer of
    # this fraction of the strided pixel count; frames with more valid
    # pixels fall back to the full-width loop (lax.cond). Every GN
    # iteration's 6 random-access passes then scale with the frame's valid
    # count. 0 disables. Exact semantics either way.


@dataclasses.dataclass(frozen=True)
class PhotoBAConfig:
    """Photometric bundle adjustment (PhotometricOptimizer.h:50-67)."""

    max_iterations: int = 25
    conv_threshold: float = 5e-4      # relative energy decrease (PhotometricOptimizer.cpp:649)
    damping: float = 1.0
    lambda_: float = 0.5
    reg_weight: float = 10.0
    loss: str = "cauchy"              # default loss enum (PhotometricOptimizer.h:66);
    # only "trunc_l2" changes solver behavior (intensity gate, cpp:364-365);
    # every other value — including the default — acts as plain L2.
    max_keyframes: int = 30           # --key-frame default (main_photo_ba.cpp:79)
    max_recorded_keyframes: int = 128  # visibility-bitfield slot capacity;
    # the reference records per-frame visibility unboundedly (vis_,
    # MapGradPixelSdf.h:70) — we record only keyframes, capped here
    # (4 uint32 words/voxel); selection stops once the cap is reached
    keyframe_gap: int = 5             # dist_to_last_keyframe > 5 (main_photo_ba.cpp:246)
    sharpness_threshold: float = 0.026  # tum/printed; redwood: 0.033 (main_photo_ba.cpp:109-120)
    channel_mix_parity: bool = False  # replicate the reference's
    # channel-REVERSED image gradients (computeImageGradient returns
    # Vec3f(v[2],v[1],v[0]) against native-order residuals,
    # PhotometricOptimizer.cpp:102-126). OFF = residual-consistent
    # gradients (our default); ON makes per-iteration BA steps directly
    # gateable against the reference binary on colored data.


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    width: int = 640
    height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5

    def K(self):
        import numpy as np

        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh axes: rays sharded intra-host, voxel blocks cross-host."""

    ray_axis: str = "rays"
    block_axis: str = "blocks"
    num_devices: Optional[int] = None  # None -> all local devices


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    photo_ba: PhotoBAConfig = dataclasses.field(default_factory=PhotoBAConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    @property
    def truncation(self) -> float:
        return self.fusion.trunc_voxels * self.grid.voxel_size


def preset(data_type: str, **overrides) -> PipelineConfig:
    """Per-dataset presets mirroring the reference apps' dispatch
    (`main_scan_3d.cpp:117-159`, `main_photo_ba.cpp:107-121`)."""
    data_type = data_type.lower()
    cfg = PipelineConfig()
    if data_type in ("tum", "tumrgbd"):
        pass  # defaults
    elif data_type in ("synth", "synthetic"):
        cfg = dataclasses.replace(
            cfg,
            fusion=dataclasses.replace(cfg.fusion, trunc_voxels=10.0),
            camera=CameraConfig(fx=525.0, fy=525.0, cx=319.5, cy=239.5),
            # synth never overrides the reference's sharp_threshold
            # declaration default 1e-4 (main_photo_ba.cpp:78,111-113), so
            # effectively every tracked frame is keyframe-eligible — caught
            # by the golden parity harness (keyframe sets differed)
            photo_ba=dataclasses.replace(cfg.photo_ba,
                                         sharpness_threshold=1e-4),
        )
    elif data_type in ("rw", "redwood"):
        cfg = dataclasses.replace(
            cfg,
            photo_ba=dataclasses.replace(cfg.photo_ba, sharpness_threshold=0.033),
        )
    elif data_type in ("printed", "printed3d"):
        pass
    else:
        raise ValueError(f"unknown data type: {data_type}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
