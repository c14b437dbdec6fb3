// Native point-cloud post-processing for depth-map fusion (a copy of
// mvsnet_tpu/native/pointcloud.cpp).
//
// The reference pipeline delegated all point-cloud consolidation to the
// external CUDA `fusibile` binary (reference: depthfusion.py:194-214).
// mvsnet_tpu_torch runs the reprojection-consistency check on the GPU
// (fusion.py); this library provides the host-side consolidation stage —
// voxel-grid merging and density-based outlier removal over 10^7..10^9
// points — as multithreaded C++ with a plain C ABI (loaded via ctypes; no
// pybind11).
//
// Build (native/__init__.py does it at first use, into mvsnet_tpu_torch/_build/):
//   g++ -O3 -fopenmp -shared -fPIC pointcloud.cpp -o libpointcloud.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct VoxelKey {
    int64_t x, y, z;
    bool operator==(const VoxelKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct VoxelKeyHash {
    size_t operator()(const VoxelKey& k) const {
        // large-prime mixing; fine for spatial hashing
        uint64_t h = static_cast<uint64_t>(k.x) * 73856093ULL;
        h ^= static_cast<uint64_t>(k.y) * 19349663ULL;
        h ^= static_cast<uint64_t>(k.z) * 83492791ULL;
        return static_cast<size_t>(h);
    }
};

struct VoxelAccum {
    double px = 0, py = 0, pz = 0;
    double cr = 0, cg = 0, cb = 0;
    int64_t count = 0;
};

inline VoxelKey key_of(const float* p, double inv_voxel) {
    return VoxelKey{
        static_cast<int64_t>(std::floor(p[0] * inv_voxel)),
        static_cast<int64_t>(std::floor(p[1] * inv_voxel)),
        static_cast<int64_t>(std::floor(p[2] * inv_voxel)),
    };
}

}  // namespace

extern "C" {

// Merge points into a voxel grid, averaging positions/colors per occupied
// voxel. Returns the number of output points (<= capacity). colors may be
// null. Two-call protocol: first call with out_* null to get the count.
int64_t voxel_downsample(const float* points, const uint8_t* colors,
                         int64_t n, double voxel_size,
                         float* out_points, uint8_t* out_colors) {
    if (n <= 0 || voxel_size <= 0) return 0;
    const double inv_voxel = 1.0 / voxel_size;

    std::unordered_map<VoxelKey, VoxelAccum, VoxelKeyHash> grid;
    grid.reserve(static_cast<size_t>(n / 4 + 16));
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + 3 * i;
        VoxelAccum& a = grid[key_of(p, inv_voxel)];
        a.px += p[0]; a.py += p[1]; a.pz += p[2];
        if (colors) {
            const uint8_t* c = colors + 3 * i;
            a.cr += c[0]; a.cg += c[1]; a.cb += c[2];
        }
        a.count += 1;
    }

    const int64_t m = static_cast<int64_t>(grid.size());
    if (!out_points) return m;

    int64_t j = 0;
    for (const auto& kv : grid) {
        const VoxelAccum& a = kv.second;
        const double inv = 1.0 / static_cast<double>(a.count);
        out_points[3 * j + 0] = static_cast<float>(a.px * inv);
        out_points[3 * j + 1] = static_cast<float>(a.py * inv);
        out_points[3 * j + 2] = static_cast<float>(a.pz * inv);
        if (out_colors && colors) {
            out_colors[3 * j + 0] = static_cast<uint8_t>(a.cr * inv + 0.5);
            out_colors[3 * j + 1] = static_cast<uint8_t>(a.cg * inv + 0.5);
            out_colors[3 * j + 2] = static_cast<uint8_t>(a.cb * inv + 0.5);
        }
        ++j;
    }
    return m;
}

// Density-based outlier removal: keep point i iff the 27-voxel neighborhood
// of its cell contains >= min_neighbors points (itself included). Writes a
// 0/1 mask. Returns number kept.
int64_t radius_outlier_mask(const float* points, int64_t n, double radius,
                            int64_t min_neighbors, uint8_t* mask) {
    if (n <= 0 || radius <= 0) return 0;
    const double inv_voxel = 1.0 / radius;

    std::unordered_map<VoxelKey, int32_t, VoxelKeyHash> counts;
    counts.reserve(static_cast<size_t>(n / 4 + 16));
    std::vector<VoxelKey> keys(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
        keys[static_cast<size_t>(i)] = key_of(points + 3 * i, inv_voxel);
        counts[keys[static_cast<size_t>(i)]] += 1;
    }

    int64_t kept = 0;
#if defined(_OPENMP)
#pragma omp parallel for reduction(+ : kept) schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const VoxelKey& k = keys[static_cast<size_t>(i)];
        int64_t neighbors = 0;
        for (int dx = -1; dx <= 1; ++dx)
            for (int dy = -1; dy <= 1; ++dy)
                for (int dz = -1; dz <= 1; ++dz) {
                    auto it = counts.find(VoxelKey{k.x + dx, k.y + dy, k.z + dz});
                    if (it != counts.end()) neighbors += it->second;
                }
        const uint8_t keep = neighbors >= min_neighbors ? 1 : 0;
        mask[i] = keep;
        kept += keep;
    }
    return kept;
}

int native_pointcloud_abi_version() { return 1; }

}  // extern "C"
