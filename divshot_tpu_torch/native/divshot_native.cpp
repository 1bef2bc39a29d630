// divshot_tpu_torch native host runtime pieces (C ABI, loaded via ctypes):
// a copy of the JAX package's native/divshot_native.cpp.
//
// The reference keeps its host-side data path in C++ (tinygsplat codec,
// thread-pooled packing — external/tinygsplat/tiny_gsplat.hpp:64-222,
// COLMAP ingestion inside the closed trainer). These are the equivalent
// host-native hot loops: COLMAP sparse-model binary parsing
// (variable-length records defeat numpy vectorization) and multithreaded
// Morton coding for the compressed splat formats. The JPEG decoder
// (jpeg_decode.cpp) is linked into the same library.
//
// Build: g++ -O3 -shared -fPIC -std=c++20 -pthread, into
// build/divshot_tpu_torch/ (divshot_tpu_torch/_build.py, build_native).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// COLMAP points3D.bin: u64 count, then per point:
//   u64 id, 3×f64 xyz, 3×u8 rgb, f64 error, u64 track_len, track_len×(2×i32)

// First pass: number of points (for caller-side allocation).
int64_t colmap_points3d_count(const uint8_t* buf, int64_t size) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, buf, 8);
    return static_cast<int64_t>(n);
}

// Parse into caller-allocated xyz (n*3 f64) and rgb (n*3 u8).
// Returns number parsed, or -1 on truncation.
int64_t colmap_points3d_parse(const uint8_t* buf, int64_t size,
                              double* xyz, uint8_t* rgb) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, buf, 8);
    const uint8_t* p = buf + 8;
    const uint8_t* end = buf + size;
    for (uint64_t i = 0; i < n; i++) {
        // fixed part: 8 + 24 + 3 + 8 + 8 = 51 bytes
        if (p + 51 > end) return -1;
        std::memcpy(xyz + i * 3, p + 8, 24);
        std::memcpy(rgb + i * 3, p + 32, 3);
        uint64_t track_len;
        std::memcpy(&track_len, p + 43, 8);
        p += 51 + track_len * 8;
        if (p > end) return -1;
    }
    return static_cast<int64_t>(n);
}

// COLMAP images.bin: u64 count, then per image:
//   i32 id, 4×f64 qvec, 3×f64 tvec, i32 camera_id, name\0,
//   u64 npts, npts×(2×f64 + i64)
int64_t colmap_images_count(const uint8_t* buf, int64_t size) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, buf, 8);
    return static_cast<int64_t>(n);
}

// Parse ids (n i32), qvecs (n*4 f64), tvecs (n*3 f64), camera_ids (n i32),
// names (n*max_name char, zero-padded). Returns parsed count or -1.
int64_t colmap_images_parse(const uint8_t* buf, int64_t size,
                            int32_t* ids, double* qvecs, double* tvecs,
                            int32_t* camera_ids, char* names,
                            int64_t max_name) {
    if (size < 8) return -1;
    uint64_t n;
    std::memcpy(&n, buf, 8);
    const uint8_t* p = buf + 8;
    const uint8_t* end = buf + size;
    for (uint64_t i = 0; i < n; i++) {
        if (p + 4 + 32 + 24 + 4 > end) return -1;
        std::memcpy(ids + i, p, 4); p += 4;
        std::memcpy(qvecs + i * 4, p, 32); p += 32;
        std::memcpy(tvecs + i * 3, p, 24); p += 24;
        std::memcpy(camera_ids + i, p, 4); p += 4;
        int64_t j = 0;
        while (p < end && *p != 0) {
            if (j < max_name - 1) names[i * max_name + j++] = (char)*p;
            p++;
        }
        if (p >= end) return -1;
        names[i * max_name + j] = 0;
        p++;  // skip nul
        if (p + 8 > end) return -1;
        uint64_t npts;
        std::memcpy(&npts, p, 8); p += 8;
        p += npts * 24;
        if (p > end) return -1;
    }
    return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// Morton codes (21 bits per axis), multithreaded — tiny_gsplat.cpp:306-328.

static inline uint64_t expand_bits_21(uint64_t v) {
    v &= 0x1fffff;
    v = (v | (v << 32)) & 0x1f00000000ffffULL;
    v = (v | (v << 16)) & 0x1f0000ff0000ffULL;
    v = (v | (v << 8))  & 0x100f00f00f00f00fULL;
    v = (v | (v << 4))  & 0x10c30c30c30c30c3ULL;
    v = (v | (v << 2))  & 0x1249249249249249ULL;
    return v;
}

void morton_codes(const float* pos, int64_t n, uint64_t* codes) {
    if (n <= 0) return;
    float mn[3] = {pos[0], pos[1], pos[2]};
    float mx[3] = {pos[0], pos[1], pos[2]};
    for (int64_t i = 0; i < n; i++) {
        for (int k = 0; k < 3; k++) {
            float v = pos[i * 3 + k];
            mn[k] = std::min(mn[k], v);
            mx[k] = std::max(mx[k], v);
        }
    }
    float rangev[3];
    for (int k = 0; k < 3; k++) rangev[k] = mx[k] - mn[k];
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned workers = std::min<unsigned>(hw, 16);
    std::vector<std::thread> pool;
    int64_t chunk = (n + workers - 1) / workers;
    for (unsigned w = 0; w < workers; w++) {
        int64_t s = (int64_t)w * chunk;
        int64_t e = std::min<int64_t>(n, s + chunk);
        if (s >= e) break;
        pool.emplace_back([=]() {
            // two-step rel-then-scale matches tiny_gsplat.cpp:309-311 and
            // the numpy fallback bit-for-bit
            const float scale = (float)((1 << 21) - 1);
            for (int64_t i = s; i < e; i++) {
                uint64_t v[3];
                for (int k = 0; k < 3; k++) {
                    float rel = rangev[k] > 0
                        ? (pos[i * 3 + k] - mn[k]) / rangev[k] : 0.0f;
                    v[k] = (uint64_t)(scale * rel);
                }
                codes[i] = expand_bits_21(v[0]) | (expand_bits_21(v[1]) << 1)
                         | (expand_bits_21(v[2]) << 2);
            }
        });
    }
    for (auto& t : pool) t.join();
}

// PLY f_rest channel-major <-> coefficient-major transpose + record packing
// (59-float records), multithreaded — the tinygsplat save_ply hot loop.
void pack_ply_records(const float* means, const float* sh0,
                      const float* shN,   // (n, k, 3) coefficient-major
                      const float* opacity, const float* scales,
                      const float* quats, int64_t n, int64_t k,
                      float* out /* n*59 */) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned workers = std::min<unsigned>(hw, 16);
    std::vector<std::thread> pool;
    int64_t chunk = (n + workers - 1) / workers;
    for (unsigned w = 0; w < workers; w++) {
        int64_t s = (int64_t)w * chunk;
        int64_t e = std::min<int64_t>(n, s + chunk);
        if (s >= e) break;
        pool.emplace_back([=]() {
            for (int64_t i = s; i < e; i++) {
                float* r = out + i * 59;
                std::memcpy(r, means + i * 3, 12);
                std::memcpy(r + 3, sh0 + i * 3, 12);
                for (int64_t c = 0; c < 3; c++)
                    for (int64_t j = 0; j < 15; j++)
                        r[6 + c * 15 + j] =
                            (j < k) ? shN[(i * k + j) * 3 + c] : 0.0f;
                r[51] = opacity[i];
                std::memcpy(r + 52, scales + i * 3, 12);
                std::memcpy(r + 55, quats + i * 4, 16);
            }
        });
    }
    for (auto& t : pool) t.join();
}

}  // extern "C"
