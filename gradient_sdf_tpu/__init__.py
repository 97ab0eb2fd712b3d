"""gradient_sdf_tpu — a JAX Gradient-SDF 3D-reconstruction framework.

A from-scratch JAX/XLA re-design of the capabilities of
c-sommer/gradient-sdf ("Gradient-SDF: A Semi-Implicit Surface Representation
for 3D Reconstruction", CVPR 2022): voxel-hashed truncated signed distance
fields that store a per-voxel spatial gradient, frame-to-model Gauss-Newton
camera tracking, TSDF+gradient fusion, photometric bundle adjustment, and
marching-cubes surface extraction — built on a block-sparse voxel grid
resident in accelerator memory, updated by gathers and scatter-adds instead
of a pointer-based CPU hash map. Its accelerator is an NVIDIA GPU
(`chip_smoke.py` runs the main path on one).

Layer map (mirrors reference layers, see SURVEY.md §1):
  utils/     core math: SE(3)/SO(3), timers, PLY + TUM trajectory IO
  ops/       voxel grid, fusion, queries, normals, filters, raycast, MC
  models/    GradSdfMap / PixelSdfMap, rigid tracker, PhotoBA, upsampler
  data/      dataset loaders (TUM / Redwood / Synth / Printed3D), synth world
  parallel/  device-mesh sharding (rays intra-host, voxel blocks cross-host)
  apps/      scan3d / photoba CLIs (flag-compatible with the reference apps)
"""

__version__ = "0.1.0"
