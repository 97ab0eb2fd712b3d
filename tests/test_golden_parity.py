"""Golden parity vs the COMPILED C++ reference (opt-in).

Skipped unless the reference binary has been built with
`parity/build_reference.sh` (out-of-tree; /root/reference stays read-only).
The harness (`parity/run_golden_parity.py`) runs both implementations on
one VGA synthetic dataset and gates:
  * GT-pose fusion: identical SDF bounding box, >=99% shared observed-voxel
    set, <=10% voxels with a differing sample multiset (fp boundary ties),
    dist equal to <=1e-3 m where multisets agree;
  * tracking: per-frame trajectory within 2 mm / 2e-3 quaternion;
  * PhotoBA (when its binary is built): identical selected-keyframe sets
    and pre-BA keyframe poses within 2 mm (BA step magnitudes are NOT
    gated — the reference channel-order inconsistency documented in
    PARITY.md makes them incomparable by design).
Observed values are ~2-10x inside these gates (PARITY.md "Golden parity").
"""

import os
import subprocess
import sys

import pytest

BIN = "/tmp/depth_scanning/bin/Scan3D"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(not os.path.isfile(BIN),
                    reason="reference binary not built "
                           "(run parity/build_reference.sh)")
def test_golden_parity_scan3d():
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "parity", "run_golden_parity.py"),
         "--binary", BIN],
        capture_output=True, text=True, timeout=1700,
    )
    assert r.returncode == 0, f"golden parity failed:\n{r.stdout[-3000:]}\n{r.stderr[-2000:]}"
    assert "PARITY OK" in r.stdout


def test_build_reference_configures():
    """The strongest gate in the repo (the golden harness) must not rot
    silently: the reference build script has to at least CONFIGURE in the
    default suite even when nobody has built the binary. CONFIGURE_ONLY=1
    stops before compilation (~seconds). Without the reference source tree
    there is nothing to configure, and the script says so with exit 3."""
    import shutil

    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    r = subprocess.run(
        ["sh", os.path.join(REPO, "parity", "build_reference.sh"),
         "/tmp/refconf_smoke"],
        env=dict(os.environ, CONFIGURE_ONLY="1"),
        capture_output=True, text=True, timeout=300,
    )
    if r.returncode == 3 and "no reference source tree" in r.stdout:
        pytest.skip(r.stdout.strip())
    assert r.returncode == 0, (
        f"reference configure failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    assert "configure OK" in r.stdout
