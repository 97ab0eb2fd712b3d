#!/bin/sh
# Build the golden C++ reference (read-only at /root/reference) out-of-tree
# for parity testing. The reference vendors eigen/Sophus/CLI11/phmap as git
# submodules that are NOT checked out in this container, so we inject:
#   * Eigen from tensorflow's bundled headers (full upstream Eigen),
#   * thin standard-semantics shims for Sophus / CLI11 / phmap
#     (parity/refshim/ — see each header for the exact surface covered).
# Usage: parity/build_reference.sh [build_dir]   (default /tmp/refbuild)
#   OMP=1 parity/build_reference.sh              builds the OpenMP variant
#     (the reference's comment-toggled source swap, cpp/CMakeLists.txt:45-58;
#     README.md:46 claims paper-comparable runtimes only for OMP builds) —
#     source tree is copied to /tmp and the toggle applied there; binaries
#     land under /tmp/refomp/depth_scanning/bin etc.
#   CONFIGURE_ONLY=1                             stop after cmake configure
#     (the CI smoke test: catches shim/toolchain rot without the full build)
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
REF="${REFERENCE_DIR:-/root/reference/cpp}"
# exit 3: nothing to build here (callers such as the test suite skip on it)
[ -d "$REF" ] || { echo "no reference source tree at $REF"; exit 3; }
if [ "${OMP:-0}" = "1" ]; then
    SRC=/tmp/refomp/cpp
    BUILD="${1:-/tmp/refomp/build/b}"
    rm -rf "$SRC"; mkdir -p "$SRC"
    cp -r "$REF/." "$SRC/"
    # flip the comment toggle: non-OMP sources out, Omp sources in
    sed -i \
        -e 's,^    include/sdf_tracker/\(MapGradPixelSdf\|MapPixelSdf\|RigidPointOptimizer\)\.cpp,    # include/sdf_tracker/\1.cpp,' \
        -e 's,^    # include/sdf_tracker/\(MapGradPixelSdfOmp\|MapPixelSdfOmp\|RigidPointOptimizerOmp\)\.cpp,    include/sdf_tracker/\1.cpp,' \
        "$SRC/CMakeLists.txt"
    grep -q "include/sdf_tracker/MapGradPixelSdfOmp.cpp" "$SRC/CMakeLists.txt"
    REF="$SRC"
else
    BUILD="${1:-/tmp/refbuild}"
fi
EIGEN="$(python -c 'import tensorflow, os; print(os.path.join(os.path.dirname(tensorflow.__file__), "include"))' 2>/dev/null)"
[ -d "$EIGEN/Eigen" ] || { echo "no Eigen found"; exit 1; }
cmake -S "$REF" -B "$BUILD" -DCMAKE_BUILD_TYPE=Release \
    -DCMAKE_CXX_FLAGS="-isystem $HERE/refshim -isystem $EIGEN" >/dev/null
[ "${CONFIGURE_ONLY:-0}" = "1" ] && { echo "configure OK"; exit 0; }
cmake --build "$BUILD" -j"$(nproc)"
echo "binaries:"
find "$BUILD" -maxdepth 3 -type f -executable
