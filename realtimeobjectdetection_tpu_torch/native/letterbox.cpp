// Native host-side letterbox: fixed-point bicubic resize (OpenCV
// INTER_CUBIC-compatible) + gray canvas placement + optional BGR->RGB,
// multi-threaded over images.
//
// Replaces the OpenCV dependency on the detector/stream hot path
// (SURVEY §2.9: "OpenCV ... must be replaced, not wrapped"; reference
// use: src/util.py:349-372).  The algorithm mirrors
// OpenCV's 8-bit resize pipeline so the parity goldens keep holding:
//   - source coordinate: fx = (dx + 0.5) * scale - 0.5
//   - Catmull-Rom-style cubic with A = -0.75
//   - coefficients quantized to short via round-half-even * 2048
//     (INTER_RESIZE_COEF_BITS = 11)
//   - horizontal pass accumulates src*alpha into int32 rows,
//     vertical pass (S0*b0+..+S3*b3 + (1<<21)) >> 22, saturated to u8
//   - out-of-range taps clamp to the edge (BORDER_REPLICATE)
//
// Built on demand by native/__init__.py (g++ -O3 -shared -fPIC) into
// build/torch_kernels/ at the root of the checkout.
// Exactness vs cv2.resize(INTER_CUBIC) is asserted by
// tests/test_torch_detector.py on random images.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfenv>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int COEF_BITS = 11;
constexpr int COEF_SCALE = 1 << COEF_BITS;          // 2048
constexpr float A = -0.75f;

inline short sat_short(float v) {
    // cvRound = round half to even (x87/SSE default rounding)
    float r = std::nearbyintf(v);
    if (r > 32767.f) return 32767;
    if (r < -32768.f) return -32768;
    return (short)r;
}

inline uint8_t sat_u8(int v) {
    return (uint8_t)std::min(std::max(v, 0), 255);
}

void cubic_coeffs(float fx, short* c) {
    float w0 = ((A * (fx + 1) - 5 * A) * (fx + 1) + 8 * A) * (fx + 1) - 4 * A;
    float w1 = ((A + 2) * fx - (A + 3)) * fx * fx + 1;
    float w2 = ((A + 2) * (1 - fx) - (A + 3)) * (1 - fx) * (1 - fx) + 1;
    float w3 = 1.f - w0 - w1 - w2;
    c[0] = sat_short(w0 * COEF_SCALE);
    c[1] = sat_short(w1 * COEF_SCALE);
    c[2] = sat_short(w2 * COEF_SCALE);
    c[3] = sat_short(w3 * COEF_SCALE);
}

struct Axis {
    std::vector<int> ofs;       // leftmost tap index (unclamped - 1)
    std::vector<short> coef;    // 4 per output element
};

Axis make_axis(int src, int dst) {
    Axis a;
    a.ofs.resize(dst);
    a.coef.resize(dst * 4);
    double scale = (double)src / dst;
    for (int d = 0; d < dst; ++d) {
        float f = (float)((d + 0.5) * scale - 0.5);
        int s = (int)std::floor(f);
        f -= s;
        a.ofs[d] = s - 1;
        cubic_coeffs(f, &a.coef[d * 4]);
    }
    return a;
}

// Resize one interleaved-u8 image plane-group (c channels) to
// (dw, dh) using the two-pass fixed-point pipeline.
void resize_cubic_u8(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw) {
    Axis ax = make_axis(sw, dw);
    Axis ay = make_axis(sh, dh);
    const int row_elems = dw * c;
    // four reusable H-pass rows (ring by source row index)
    std::vector<int> rows(4 * row_elems);
    int cached[4] = {-9, -9, -9, -9};  // which source row each slot holds

    auto hrow = [&](int sy, int slot) {
        sy = std::min(std::max(sy, 0), sh - 1);
        if (cached[slot] == sy) return;
        cached[slot] = sy;
        const uint8_t* sp = src + (size_t)sy * sw * c;
        int* rp = rows.data() + slot * row_elems;
        for (int d = 0; d < dw; ++d) {
            const short* cf = &ax.coef[d * 4];
            int o = ax.ofs[d];
            for (int ch = 0; ch < c; ++ch) {
                int acc = 0;
                for (int k = 0; k < 4; ++k) {
                    int x = std::min(std::max(o + k, 0), sw - 1);
                    acc += sp[x * c + ch] * cf[k];
                }
                rp[d * c + ch] = acc;
            }
        }
    };

    for (int dy = 0; dy < dh; ++dy) {
        const short* bf = &ay.coef[dy * 4];
        int o = ay.ofs[dy];
        // map the 4 source rows into slots keyed by clamped row index
        int slots[4];
        for (int k = 0; k < 4; ++k) {
            int sy = std::min(std::max(o + k, 0), sh - 1);
            int slot = -1;
            for (int s = 0; s < 4; ++s)
                if (cached[s] == sy) { slot = s; break; }
            if (slot < 0) {
                // evict a slot not needed for this output row
                for (int s = 0; s < 4; ++s) {
                    bool needed = false;
                    for (int kk = 0; kk < k; ++kk)
                        if (slots[kk] == s) { needed = true; break; }
                    for (int kk = k + 1; kk < 4 && !needed; ++kk) {
                        int syk = std::min(std::max(o + kk, 0), sh - 1);
                        if (cached[s] == syk) needed = true;
                    }
                    if (!needed) { slot = s; break; }
                }
                hrow(sy, slot);
            }
            slots[k] = slot;
        }
        const int* S0 = rows.data() + slots[0] * row_elems;
        const int* S1 = rows.data() + slots[1] * row_elems;
        const int* S2 = rows.data() + slots[2] * row_elems;
        const int* S3 = rows.data() + slots[3] * row_elems;
        uint8_t* dp = dst + (size_t)dy * row_elems;
        // fixed-point V-pass: platform-deterministic (no FMA/SIMD
        // variance).  Within +-1 LSB of any cv2 build's INTER_CUBIC;
        // the golden-parity pipelines keep using cv2 itself.
        const int b0 = bf[0], b1 = bf[1], b2 = bf[2], b3 = bf[3];
        for (int i = 0; i < row_elems; ++i) {
            long long acc = (long long)S0[i] * b0 + (long long)S1[i] * b1
                          + (long long)S2[i] * b2 + (long long)S3[i] * b3;
            dp[i] = sat_u8((int)((acc + (1 << (2 * COEF_BITS - 1)))
                                 >> (2 * COEF_BITS)));
        }
    }
}

struct Job {
    const uint8_t* src;
    int sh, sw;
};

}  // namespace

extern "C" {

// Letterbox one u8 HWC image (c=3) onto a size x size canvas filled
// with pad_value; new extents = int(truncate) per the Darknet reference
// (src/util.py:362-363) or round() when round_extents != 0 (AutoShape).
// swap_rb flips BGR->RGB during placement.  dst: [size, size, 3] u8.
void letterbox_u8(const uint8_t* src, int sh, int sw,
                  uint8_t* dst, int size, int pad_value,
                  int swap_rb, int round_extents) {
    double scale = std::min((double)size / sw, (double)size / sh);
    int nw = round_extents ? (int)std::lround(sw * scale)
                           : (int)(sw * scale);
    int nh = round_extents ? (int)std::lround(sh * scale)
                           : (int)(sh * scale);
    nw = std::max(nw, 1);
    nh = std::max(nh, 1);
    int ox = (size - nw) / 2, oy = (size - nh) / 2;
    std::vector<uint8_t> tmp((size_t)nw * nh * 3);
    resize_cubic_u8(src, sh, sw, 3, tmp.data(), nh, nw);
    std::memset(dst, pad_value, (size_t)size * size * 3);
    for (int y = 0; y < nh; ++y) {
        const uint8_t* sp = tmp.data() + (size_t)y * nw * 3;
        uint8_t* dp = dst + ((size_t)(oy + y) * size + ox) * 3;
        if (swap_rb) {
            for (int x = 0; x < nw; ++x) {
                dp[x * 3 + 0] = sp[x * 3 + 2];
                dp[x * 3 + 1] = sp[x * 3 + 1];
                dp[x * 3 + 2] = sp[x * 3 + 0];
            }
        } else {
            std::memcpy(dp, sp, (size_t)nw * 3);
        }
    }
}

// Batched letterbox: n images (pointers + dims arrays) -> contiguous
// [n, size, size, 3] u8, parallel over images with nthreads workers.
void letterbox_u8_batch(const uint8_t** srcs, const int* shs,
                        const int* sws, int n, uint8_t* dst, int size,
                        int pad_value, int swap_rb, int round_extents,
                        int nthreads) {
    size_t stride = (size_t)size * size * 3;
    auto work = [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i)
            letterbox_u8(srcs[i], shs[i], sws[i], dst + i * stride,
                         size, pad_value, swap_rb, round_extents);
    };
    nthreads = std::max(1, std::min(nthreads, n));
    if (nthreads == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    int per = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int lo = t * per, hi = std::min(n, lo + per);
        if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

// Plain resize (for tests / geometry other than square letterbox).
void resize_cubic_u8_c(const uint8_t* src, int sh, int sw, int c,
                       uint8_t* dst, int dh, int dw) {
    resize_cubic_u8(src, sh, sw, c, dst, dh, dw);
}

}  // extern "C"
