"""chip_smoke.py on the CPU: its entry point refuses a non-GPU device, and
its phase functions and comparison helpers run at a tiny size (160x120, a
few frames). The chip itself runs the real sizes (`python chip_smoke.py`)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

from gradient_sdf_tpu.config import FusionConfig, GridConfig  # noqa: E402
from gradient_sdf_tpu.ops import fusion  # noqa: E402
from gradient_sdf_tpu.utils import ply, tumio  # noqa: E402

VOXEL = 0.02


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Noise-free 160x120 data, 4 frames, and one scan3d run on it."""
    root = tmp_path_factory.mktemp("chip_smoke")
    data = cs.make_data(str(root / "data"), 160, 120, frames=4, seed=2,
                        arc_deg=2.0, noise=False)
    out = str(root / "scan3d")
    metrics, sdf_map = cs.run_scan3d(data, out, VOXEL)
    return data, out, metrics, sdf_map


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu(argv, capsys):
    """No GPU: non-zero exit and no result line."""
    assert cs.main(argv) != 0
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU" in captured.err


def test_scan3d_phase_outputs(tiny):
    data, out, metrics, sdf_map = tiny
    assert metrics["frames"] == 4
    assert len(metrics["frame_wall_s"]) == 4
    assert np.isfinite(cs.steady_ms_per_frame(metrics))
    assert int(sdf_map.grid.num_active) == metrics["num_blocks_active"]
    # every gate but convergence holds even at this size: below 320x240 the
    # 1e-3 Gauss-Newton gate sits on the noise floor (frames rejected)
    fails = cs.scan_failures(metrics, out, VOXEL)
    assert all("frames rejected" in f for f in fails), fails


def test_scan_failures_flags_each_gate(tmp_path):
    good = {"overflow": False, "num_blocks_active": 5, "invalid_frames": [],
            "frames": 30, "ate_rmse": 0.5 * VOXEL}
    for name in ("gradient_sdf_mesh_final.ply",
                 "gradient_sdf_cloud_final.ply"):
        ply.save_point_cloud_ply(str(tmp_path / name),
                                 np.zeros((3, 3), np.float32))
    assert cs.scan_failures(good, str(tmp_path), VOXEL) == []
    bad = dict(good, overflow=True, num_blocks_active=0,
               invalid_frames=list(range(4)), ate_rmse=2 * VOXEL)
    fails = cs.scan_failures(bad, str(tmp_path / "missing"), VOXEL)
    assert len(fails) == 6, fails
    assert cs.scan_failures(dict(good, invalid_frames=[1, 2, 3]),
                            str(tmp_path), VOXEL) == []


def test_field_failures_compare_grids(tiny):
    """Identical grids pass; a perturbed field or block count fails."""
    data, _, _, _ = tiny
    depths, poses, K = cs.load_frames(data, 2)
    gcfg, fcfg = GridConfig(voxel_size=VOXEL), FusionConfig(trunc_voxels=5)
    fuse = jax.jit(lambda g, d, c, R, t: fusion.fuse_frame(
        g, d, c, R, t, gcfg, fcfg))
    g, _ = cs.fuse_on(jax.devices()[0], depths, poses, K, gcfg, fcfg, fuse)
    fails, stats = cs.field_failures(g, g)
    assert fails == [] and stats["voxels_seen"] > 0
    w = g.weight.at[0, 0].add(1e-2 + 1e-2 * g.weight[0, 0])
    assert any("weight" in f for f in cs.field_failures(
        g._replace(weight=w), g)[0])
    d = g.dist + jnp.where(g.weight > 0, 1e-4, 0.0)
    assert any("dist" in f for f in cs.field_failures(
        g._replace(dist=d), g)[0])
    assert "num_active" in cs.field_failures(
        g._replace(num_active=g.num_active + 1), g)[0][0]
    # end to end: a few voxels may differ wholesale, most may not
    assert cs.fusion_e2e_failures(g, g)[0] == []
    seen = np.flatnonzero(np.asarray(g.weight).reshape(-1) > 0)
    flat = np.asarray(g.weight).reshape(-1).copy()
    flat[seen[:3]] += 1.0
    few = g._replace(weight=jnp.asarray(flat.reshape(g.weight.shape)))
    fails, stats = cs.fusion_e2e_failures(few, g)
    assert fails == [] and stats["voxels_flipped"] == 3
    assert cs.fusion_e2e_failures(g._replace(weight=g.weight + 1.0), g)[0]


def test_numerics_phase_cpu_against_cpu(tiny):
    """Phase 4 end to end with the CPU on both sides: every comparison runs
    and agrees exactly."""
    data, out, metrics, sdf_map = tiny
    cpu = jax.devices("cpu")[0]
    est = tumio.read_trajectory(os.path.join(out, "_poses.txt"))
    res = cs.numerics_phase(
        data, (sdf_map, est, set(metrics["invalid_frames"])), "cpu",
        n_fuse=2, ba_F=3, ba_V=2048, voxel=VOXEL, cpu=cpu, dev=cpu)
    assert res["track"]["dR"] == 0.0 and res["track"]["dt"] == 0.0
    assert res["ba"]["e_pose"][0] == res["ba"]["e_pose"][1]
    assert res["raycast"]["pixels_both_hit"] > 0


def test_photoba_phase(tiny, tmp_path):
    data = tiny[0]
    m = cs.photoba_phase(data, str(tmp_path), VOXEL)
    assert m["keyframes"] >= 1
    assert m["ba_energies"][-1] <= m["ba_energies"][0]


def test_sharded_vs_single_on_virtual_devices(tiny):
    """The --four-cards comparisons on 4 of the test suite's virtual CPU
    devices: sharded fusion, render and BA match one device (tracking at
    this size runs its 25 iterations without converging, so only its
    numbers are checked)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    out, fails = cs.sharded_vs_single(tiny[0], n_fuse=2, ba_F=3, ba_V=2048,
                                      voxel=VOXEL)
    assert out["fusion"]["num_active"][0] == out["fusion"]["num_active"][1]
    assert out["fusion"]["max_abs_dist"] < cs.SHARDED_FIELD_ATOL
    assert out["render_hits"] > 0
    assert np.isfinite([out["track"]["dR"], out["track"]["dt"]]).all()
    assert all("tracking" in f for f in fails), fails


def test_phases_report_failures(capsys):
    ph = cs.Phases()
    assert ph.run("good", lambda: 7) == 7
    assert ph.run("bad", cs.check, ["a gate"]) is None
    assert ph.failed == ["bad"]
    out = capsys.readouterr().out
    assert "phase good: ok" in out and "phase bad: FAILED" in out
    assert cs.rel_diff(1.0005, 1.0) < cs.ENERGY_RTOL
    assert cs.pose_diff(np.eye(3), np.zeros(3), np.eye(3),
                        np.ones(3)) == (0.0, 1.0)
