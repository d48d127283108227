// Greedy same-class NMS suppression for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/nms_kernel.py:nms_suppress_pallas of
// the JAX package.  Same function: K candidates in objectness-descending
// order; start from keep = valid; for i = 0..K-1, a box i that is still
// kept clears every later box j of the same class whose IoU with it is
// >= thresh (> thresh when ge == 0).  plus_one adds the Darknet +1 to
// widths and heights.
//
// Design: one block per image, K <= 1024.
//   Phase 1 (parallel): every warp takes (row i, 64-column word w) items
//     and builds the bit word "box i suppresses box j" for j in
//     [64w, 64w+64): same class, j > i, IoU hit.  Two ballots per item;
//     the [K, ceil(K/64)] uint64 mask (128 KB at K = 1024) stays in
//     dynamic shared memory with the boxes.
//   Phase 2 (sequential): warp 0 sweeps i = 0..n-1.  Lane l holds word l
//     of the "removed" bitset; box i is alive iff valid and its bit is
//     clear (one shuffle), and an alive box ORs its mask row into the
//     bitset.  This is exact greedy.
// Only rows and columns below the last valid candidate are built and
// swept: candidates arrive score-sorted, so the valid ones form a prefix.
//
// Bound on this card: the input is about 21 bytes per candidate (4 f32
// corners, an int32 class, a bool) and the IoU work is under K^2/2 pairs
// per image, so neither bytes nor operations bound it.  The K-long
// sequential sweep of phase 2 does: one dependent shuffle and shared
// memory load per candidate.
//
// Exactness: the IoU is the fp32 expression of nms_kernel.py:55-62, in the
// same order, with round-to-nearest intrinsics so that nothing contracts
// into an FMA (the library is also built with -fmad=false, never with
// --use_fast_math).  max/min propagate NaN as jnp.maximum does.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing.  The C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
    return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
    return (isnan(a) || isnan(b)) ? __fadd_rn(a, b) : fminf(a, b);
}

__device__ __forceinline__ float extent(float lo, float hi, float e) {
    return __fadd_rn(__fsub_rn(hi, lo), e);
}

__device__ __forceinline__ bool iou_hit(float4 bi, float area_i, float4 bj,
                                        float area_j, float e, float thresh,
                                        int ge) {
    float ix1 = nan_max(bj.x, bi.x);
    float iy1 = nan_max(bj.y, bi.y);
    float ix2 = nan_min(bj.z, bi.z);
    float iy2 = nan_min(bj.w, bi.w);
    float inter = __fmul_rn(nan_max(extent(ix1, ix2, e), 0.0f),
                            nan_max(extent(iy1, iy2, e), 0.0f));
    float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_j, area_i), inter));
    return ge ? (iou >= thresh) : (iou > thresh);
}

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ corners,
                    const int* __restrict__ cls,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep,
                    int k, float thresh, int plus_one, int ge) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int words = (k + 63) / 64;
    float4* box = reinterpret_cast<float4*>(smem);
    unsigned long long* mask = reinterpret_cast<unsigned long long*>(box + k);
    unsigned long long* removed = mask + (size_t)k * words;  // 32 words
    float* area = reinterpret_cast<float*>(removed + 32);
    int* cl = reinterpret_cast<int*>(area + k);
    uint8_t* ok = reinterpret_cast<uint8_t*>(cl + k);
    __shared__ int n_end;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float e = plus_one ? 1.0f : 0.0f;
    corners += (size_t)b * k;
    cls += (size_t)b * k;
    valid += (size_t)b * k;
    keep += (size_t)b * k;

    if (tid == 0) n_end = 0;
    __syncthreads();
    int last = 0;
    for (int j = tid; j < k; j += kThreads) {
        const float4 c = corners[j];
        box[j] = c;
        area[j] = __fmul_rn(extent(c.x, c.z, e), extent(c.y, c.w, e));
        cl[j] = cls[j];
        ok[j] = valid[j];
        if (valid[j]) last = j + 1;
    }
    if (last) atomicMax(&n_end, last);
    __syncthreads();
    const int n = n_end;  // candidates at or past n are all invalid
    const int n_words = (n + 63) / 64;

    // Phase 1: suppression words for rows i < n, columns j < n.
    for (int item = warp; item < n * n_words; item += kThreads / 32) {
        const int i = item / n_words;
        const int w = item - i * n_words;
        unsigned long long bits = 0;
        if (64 * w + 63 > i) {  // else every column j <= i: word stays 0
            const float4 bi = box[i];
            const float area_i = area[i];
            const int ci = cl[i];
            #pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = 64 * w + 32 * half + lane;
                bool hit = false;
                if (j > i && j < n && cl[j] == ci)
                    hit = iou_hit(bi, area_i, box[j], area[j], e, thresh, ge);
                const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
                bits |= (unsigned long long)ballot << (32 * half);
            }
        }
        if (lane == 0) mask[(size_t)i * words + w] = bits;
    }
    __syncthreads();

    // Phase 2: the sequential greedy sweep, one warp.  Lane l holds word l
    // of the removed bitset, which starts as the invalid candidates: they
    // are never kept and never suppress.
    if (warp == 0) {
        unsigned long long rem = 0;
        for (int w = 0; w < n_words; ++w) {
            #pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int j = 64 * w + 32 * half + lane;
                const unsigned int gone =
                    __ballot_sync(0xffffffffu, j >= n || !ok[j]);
                if (lane == w) rem |= (unsigned long long)gone << (32 * half);
            }
        }
        for (int i = 0; i < n; ++i) {
            const unsigned long long row =
                lane < n_words ? mask[(size_t)i * words + lane] : 0ull;
            const unsigned long long wi = __shfl_sync(0xffffffffu, rem, i >> 6);
            if (!((wi >> (i & 63)) & 1ull)) rem |= row;
        }
        if (lane < n_words) removed[lane] = rem;
    }
    __syncthreads();

    for (int j = tid; j < k; j += kThreads)
        keep[j] = j < n && !((removed[j >> 6] >> (j & 63)) & 1ull);
}

size_t smem_bytes(int k) {
    const size_t words = (size_t)(k + 63) / 64;
    return (size_t)k * 16 + (size_t)k * words * 8 + 32 * 8 + (size_t)k * 9;
}

}  // namespace

extern "C" {

int nms_suppress_max_k() { return kMaxK; }

// corners [B, K, 4] f32, cls [B, K] int32, valid [B, K] bool as uint8
// -> keep [B, K] uint8.  Returns a cudaError_t (0 on success).
int nms_suppress_launch(const float* corners, const int* cls,
                        const uint8_t* valid, uint8_t* keep, int batch, int k,
                        float thresh, int plus_one, int ge, void* stream) {
    if (k < 1 || k > kMaxK || batch < 1) return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
        cudaError_t err = cudaFuncSetAttribute(
            nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes(kMaxK));
        if (err != cudaSuccess) return (int)err;
        attr_set = true;
    }
    nms_suppress_kernel<<<batch, kThreads, smem_bytes(k),
                          (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(corners), cls, valid, keep, k,
        thresh, plus_one, ge);
    return (int)cudaGetLastError();
}

}  // extern "C"
