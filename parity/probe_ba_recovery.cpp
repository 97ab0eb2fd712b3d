// BA-recovery probe: does the reference's OWN
// PhotometricOptimizer demonstrably IMPROVE a reconstruction?
//
// The reference app has no way to start BA from known-bad poses (it always
// tracks), so golden-parity stage 3b could only show both implementations
// sharing the diverge-abort endpoint. This probe links the reference's own
// libraries and builds the cleanest possible improvement fixture:
//   1. fuse ALL frames at GROUND-TRUTH poses (map is right),
//   2. select keyframes with the reference's own sharpness/gap policy and
//      sampleKeyFrame subsampling (main_photo_ba.cpp:246-259, :319-347),
//   3. hand the optimizer PERTURBED keyframe poses from a file,
//   4. run optimize() — post poses land in coarse_BA_poses_optimized.txt
//      (savePoses), energies print; the python stage computes pre/post
//      pose errors vs GT and gates recovery.
// The same fixture runs on our side via
//   photoba --pose-file gt_poses.txt --ba-init-pose-file <perturbed>.
//
// Build/run (same include paths as probe_energy.cpp):
//   g++ -O2 -std=c++17 parity/probe_ba_recovery.cpp -isystem parity/refshim \
//       -isystem $TF_EIGEN -I /root/reference/cpp/include \
//       -I /root/reference/cpp/third $(pkg-config --cflags --libs opencv4) \
//       /tmp/refbuild/libsdf_tracker_lib.a /tmp/refbuild/libcolor_lib.a \
//       -o /tmp/probe_ba_recovery
//   /tmp/probe_ba_recovery <data_dir>/ <out_dir>/ <pert_poses.txt> [kf_max]
#include <cstdio>
#include <memory>
#include <string>
#include <vector>
#include <Eigen/Dense>
#include <opencv2/core/core.hpp>
#include "normals/NormalEstimator.h"
#include "sdf_tracker/MapGradPixelSdf.h"
#include "img_loader/img_loader.h"
#include "ps_optimizer/PhotometricOptimizer.h"
#include "ps_optimizer/SharpDetector.h"
#include "mat.h"

// exact mirror of main_photo_ba.cpp:319-347 (float32-accumulated stride)
template <typename V>
static void subsample(V& v, int max_num) {
    if ((int)v.size() < max_num) return;
    int n = max_num - 1;
    float step = float(v.size()) / float(n);
    V out;
    float f = 0.f;
    for (int i = 0; i < n; ++i) out.push_back(v[int(f)]), f += step;
    out.push_back(v.back());
    v = out;
}

int main(int argc, char** argv) {
    std::string input = argc > 1 ? argv[1] : "/tmp/ba_fix/data/";
    std::string outdir = argc > 2 ? argv[2] : "/tmp/ba_fix/ref/";
    std::string pert_file = argc > 3 ? argv[3] : input + "pert_poses.txt";
    int kf_max = argc > 4 ? std::atoi(argv[4]) : 8;
    float voxel_size = argc > 5 ? std::atof(argv[5]) : 0.02f;
    float trunc = 5 * voxel_size;
    float sharp_threshold = 1e-4f;  // main_photo_ba.cpp declaration default

    SynthLoader loader(input);
    if (!loader.load_intrinsics("intrinsics.txt")) { puts("no K"); return 1; }
    Mat3f K = loader.K();
    std::vector<Mat4f, Eigen::aligned_allocator<Mat4f>> gt, pert;
    if (!loader.load_pose(input + "gt_poses.txt", gt)) { puts("no gt"); return 1; }
    if (!loader.load_pose(pert_file, pert)) { puts("no pert"); return 1; }

    auto* NEst = new cv::NormalEstimator<float>(640, 480, K, cv::Size(11, 11));
    MapGradPixelSdf* tSDF = nullptr;

    std::vector<int> keyframes;
    std::vector<std::string> key_stamps;
    std::vector<std::shared_ptr<cv::Mat>> key_images;
    std::vector<Mat4f, Eigen::aligned_allocator<Mat4f>> key_pert;
    int dist_to_last_keyframe = 0;

    cv::Mat color, depth;
    for (int i = 0; loader.load_next(color, depth); ++i) {
        if (i == 0) tSDF = new MapGradPixelSdf(voxel_size, trunc);
        tSDF->update(color, depth, K, SE3(gt[i]), NEst);
        bool kf = (i == 0) || sharpDetector(color, sharp_threshold)
                  || dist_to_last_keyframe > 5;
        if (kf) {
            dist_to_last_keyframe = 0;
            keyframes.push_back(i);
            key_stamps.push_back(loader.rgb_timestamp());
            cv::Mat c2; color.copyTo(c2);
            key_images.push_back(std::make_shared<cv::Mat>(c2));
            key_pert.push_back(pert[i]);
        } else {
            ++dist_to_last_keyframe;
        }
    }
    subsample(keyframes, kf_max);
    subsample(key_stamps, kf_max);
    subsample(key_images, kf_max);
    subsample(key_pert, kf_max);
    printf("KEYFRAMES");
    for (size_t k = 0; k < keyframes.size(); ++k)
        printf(" %d", keyframes[k]);
    printf("\n");

    PhotometricOptimizer opt(tSDF, voxel_size, K, outdir);
    opt.setImages(key_images);
    opt.setKeyframes(keyframes);
    opt.setPoses(key_pert);
    opt.setKeytimestamps(key_stamps);
    bool conv = opt.optimize();
    printf("OPT_RETURN %d\n", int(conv));
    return 0;
}
