"""End-to-end PhotoBA app test: track+fuse, keyframes, BA, HR color export.

Runs at 320x240 (the minimum resolution where the GN tracker reliably meets
the reference's ||xi|| < 1e-3 convergence gate on synthetic data) — this is
the slowest test in the suite (~2-4 min on the CI host).
"""

import os

import numpy as np
import pytest

from gradient_sdf_tpu.apps import make_synth, photoba
from gradient_sdf_tpu.utils.ply import load_ply


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("photoba_data"))
    make_synth.generate(out, frames=14, seed=2, width=320, height=240,
                        noise=False, arc_deg=10.0)
    return out


def test_photoba_end_to_end(synth_dir, tmp_path):
    results = str(tmp_path / "out")
    args = photoba.build_parser().parse_args([
        "--input", synth_dir, "--results", results,
        "--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5",
        "--key-frame", "5",
        "--metrics-json", os.path.join(str(tmp_path), "m.json"),
    ])
    metrics = photoba.run_photoba(args)

    assert metrics["keyframes"] >= 2
    assert len(metrics["invalid_frames"]) <= 2  # occasional GN non-convergence at this scale
    # energies recorded and finite; BA must not blow up
    es = metrics["ba_energies"]
    assert len(es) >= 3
    assert all(np.isfinite(e) for e in es)
    assert es[-1] <= es[0] * 1.05

    # all artifacts written
    for f in ["_poses.txt", "mesh_lr.ply", "cloud_lr.ply",
              "selected_frame_poses_before_optimization.txt",
              "coarse_BA_poses_optimized.txt",
              "coarse_BA_mesh_after_upsample.ply",
              "coarse_BA_cloud_after_upsample.ply"]:
        assert os.path.isfile(os.path.join(results, f)), f

    # HR colored outputs parse and carry color
    mesh = load_ply(os.path.join(results, "coarse_BA_mesh_after_upsample.ply"))
    assert len(mesh["vertex"]) > 100
    assert "red" in mesh["vertex"].dtype.names
    cloud = load_ply(os.path.join(results, "coarse_BA_cloud_after_upsample.ply"))
    assert len(cloud["vertex"]) > 50
    # albedo should be non-trivial (synthetic spheres are colored)
    reds = cloud["vertex"]["red"].astype(float)
    assert reds.max() > 20


def test_photoba_long_sequence_slot_cap_and_lazy_images(synth_dir, tmp_path,
                                                        capsys):
    """fr1/desk-scale behavior in miniature: with
    --keyframe-gap 0 every converged frame is keyframe-eligible, so a
    small --max-recorded-keyframes exercises the visibility slot cap
    (suppression counted + warned, run completes) while images are decoded
    lazily only for the <= --key-frame SAMPLED keyframes — host memory is
    O(key_frame) images regardless of sequence length (the reference keeps
    every candidate image in RAM, main_photo_ba.cpp:228-231)."""
    results = str(tmp_path / "out_cap")
    args = photoba.build_parser().parse_args([
        "--input", synth_dir, "--results", results,
        "--data-type", "synth", "--voxel-size", "0.02", "--trunc", "5",
        "--key-frame", "4", "--keyframe-gap", "0",
        "--max-recorded-keyframes", "8",
        "--metrics-json", os.path.join(str(tmp_path), "m_cap.json"),
    ])
    metrics = photoba.run_photoba(args)
    out = capsys.readouterr().out
    # 14 frames, every converged frame eligible, cap 8 -> suppression fires
    assert metrics["suppressed_keyframes"] >= 2
    assert "keyframe slot cap" in out
    assert metrics["keyframes"] == 4  # sampled down to --key-frame
    assert all(np.isfinite(e) for e in metrics["ba_energies"])
    for f in ["coarse_BA_poses_optimized.txt",
              "coarse_BA_mesh_after_upsample.ply"]:
        assert os.path.isfile(os.path.join(results, f)), f
