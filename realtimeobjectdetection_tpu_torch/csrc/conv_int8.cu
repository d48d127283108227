// w8a8 stride-1 tap-matmul convolution over the flat padded row layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel ops/pallas/conv_int8.py:conv_flat_int8 of the JAX
// package (bodies _kernel3, _kernel1, _quantize, _epilogue).  Same function,
// for row block i = rows [i*tm, (i+1)*tm) of the [R, C_in] input:
//   amax_i = max(max|x| over the block and, for k = 3, a gr-row halo each
//            side clamped to [0, R), 1e-6)
//   q      = clip(rint(x * (127 / amax_i)), -127, 127) as int8, the halo
//            rows quantized with this block's scale
//   acc[r] = sum over taps t of q[r + o_t] . W_t in int32,
//            o_t = dy*(W+2) + dx
//   y      = float(acc) * (amax_i / 127) * s_w[c] + b[c], then leaky 0.1,
//            then + skip; non-content rows 0; cast to the output type.
// The fp32 epilogue is a chain of separate round-to-nearest operations in
// the order of the JAX package's bit-matched emulation
// conv_flat_int8_reference (which divides amax by 127; the TPU kernel
// multiplies by f32(1/127) and its interpret mode contracts into FMAs, so
// those two differ from the emulation by about 1 ulp).  The library is
// built with -fmad=false, so the kernel matches the plain PyTorch version
// (ops/conv_int8.conv_flat_int8_plain) bit for bit.
//
// Design: two kernels.
//   1. chunk_absmax: one block per gr-row chunk writes max|x| of the chunk.
//      tm is a multiple of gr and the halo is one chunk each side, so
//      block i's amax is the max over chunks [i*tm/gr - 1, (i+1)*tm/gr]
//      (clamped), which the main kernel combines as it starts.  Every row
//      is read once instead of once per overlapping halo.
//   2. conv_int8: one block of 256 threads per 128-row x 128-channel output
//      tile.  tm is a multiple of 128, so a tile lies in one row block and
//      has one activation scale.  For each tap and each 64-channel slice of
//      C_in, the block loads the 128 shifted input rows (bf16 or fp32),
//      quantizes them with the block's scale into shared memory as int8,
//      loads the matching int8 weights ([k*k, C_out, C_in], C_in contiguous)
//      and runs mma.sync.m16n8k32 s8 x s8 -> s32: eight warps, each a 64x32
//      sub-tile.  The epilogue is applied from the accumulator registers.
//      The two guard blocks of the layout hold no content row: their tiles
//      are written as zeros without reading anything, and every tap read of
//      the other tiles stays inside [0, R).
// Integer sums are exact, so the tiling and the order of the products do
// not change acc.
//
// Bound on this card: at yolov3 shapes the int8 work (2*k*k*C_in*C_out
// operations per content row) over the dense int8 tensor rate against the
// bf16 activations read once and written once over the memory rate; the
// 1x1 convs with few channels are bound by bytes, the 3x3 ones by
// operations.  This first kernel is far from either: it has no pipelining
// (global loads, quantization and mma alternate behind __syncthreads), it
// re-reads and re-quantizes each input row once per tap and per output
// tile, and it stores the output one element at a time.  TMA, wgmma and a
// persistent schedule are the next steps.
//
// The launch goes on the caller's stream, does not synchronise and
// allocates nothing.  The C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;             // output rows per block
constexpr int kBN = 128;             // output channels per block
constexpr int kBK = 64;              // input channels per stage
constexpr int kThreads = 256;        // 8 warps: 2 (rows) x 4 (channels)
constexpr int kStride = kBK + 16;    // shared row stride in bytes: 80 keeps
                                     // the fragment loads free of bank
                                     // conflicts and 16-byte aligned

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Eight consecutive elements as floats: one or two 16-byte loads when
// ``vec`` (aligned, all eight inside the row), else element by element
// with the channels at or past ``n_valid`` read as 0.
__device__ __forceinline__ void load8(const float* p, int n_valid, bool vec,
                                      float (&v)[8]) {
    if (vec) {
        const float4 a = reinterpret_cast<const float4*>(p)[0];
        const float4 b = reinterpret_cast<const float4*>(p)[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
        #pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = j < n_valid ? p[j] : 0.0f;
    }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n_valid,
                                      bool vec, float (&v)[8]) {
    if (vec) {
        const uint4 a = reinterpret_cast<const uint4*>(p)[0];
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
        #pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
    } else {
        #pragma unroll
        for (int j = 0; j < 8; ++j)
            v[j] = j < n_valid ? __bfloat162float(p[j]) : 0.0f;
    }
}

__device__ __forceinline__ uint32_t quant4(const float* v, float inv) {
    uint32_t out = 0;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
        float r = rintf(__fmul_rn(v[j], inv));       // half to even
        r = fminf(fmaxf(r, -127.0f), 127.0f);
        out |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(r) << (8 * j);
    }
    return out;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename TIn>
__global__ void __launch_bounds__(kThreads)
chunk_absmax_kernel(const TIn* __restrict__ x, float* __restrict__ chunk_max,
                    int64_t chunk_elems, int vec) {
    const TIn* base = x + (int64_t)blockIdx.x * chunk_elems;
    float m = 0.0f;
    if (vec) {
        for (int64_t e = 8 * (int64_t)threadIdx.x; e < chunk_elems;
             e += 8 * kThreads) {
            float v[8];
            load8(base + e, 8, true, v);
            #pragma unroll
            for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
        }
    } else {
        for (int64_t e = threadIdx.x; e < chunk_elems; e += kThreads)
            m = fmaxf(m, fabsf(to_f32(base[e])));
    }
    #pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    __shared__ float warp_max[kThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        float r = warp_max[0];
        for (int i = 1; i < kThreads / 32; ++i) r = fmaxf(r, warp_max[i]);
        chunk_max[blockIdx.x] = r;
    }
}

struct Shape {
    int rows, cin, cout, k, leaky;
    int b, h, w, tm, gr;
    int vec_x, vec_w;
};

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wq,
                 const float* __restrict__ s_w,
                 const float* __restrict__ bias,
                 const TIn* __restrict__ skip,
                 const float* __restrict__ chunk_max,
                 TOut* __restrict__ y, Shape s) {
    __shared__ __align__(16) int8_t a_s[kBM * kStride];
    __shared__ __align__(16) int8_t b_s[kBN * kStride];

    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * kBM;
    const int n0 = blockIdx.y * kBN;
    const int nb = s.rows / s.tm;
    const int blk = row0 / s.tm;
    const int n_end = min(n0 + kBN, s.cout);

    if (blk == 0 || blk == nb - 1) {  // guard blocks: no content row
        for (int e = tid; e < kBM * (n_end - n0); e += kThreads) {
            const int r = e / (n_end - n0);
            const int n = n0 + e - r * (n_end - n0);
            store_out(y + (int64_t)(row0 + r) * s.cout + n, 0.0f);
        }
        return;
    }

    // this block's scale: the chunks of the block and of its halos
    const int tmb = s.tm / s.gr;
    const int c_lo = s.k == 3 ? max(blk * tmb - 1, 0) : blk * tmb;
    const int c_hi = s.k == 3 ? min((blk + 1) * tmb, s.rows / s.gr - 1)
                              : (blk + 1) * tmb - 1;
    float amax = 0.0f;
    for (int c = c_lo; c <= c_hi; ++c) amax = fmaxf(amax, chunk_max[c]);
    amax = fmaxf(amax, 1e-6f);
    const float inv = __fdiv_rn(127.0f, amax);
    const float sx = __fdiv_rn(amax, 127.0f);

    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = (warp >> 2) * 64;   // warp's first row in the tile
    const int wn = (warp & 3) * 32;    // warp's first channel in the tile
    const int g = lane >> 2;
    const int tig = lane & 3;

    int acc[4][4][4];
    #pragma unroll
    for (int mi = 0; mi < 4; ++mi)
        #pragma unroll
        for (int ni = 0; ni < 4; ++ni)
            #pragma unroll
            for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

    const int taps = s.k * s.k;
    const int wp = s.w + 2;
    for (int t = 0; t < taps; ++t) {
        const int off = s.k == 3 ? (t / 3 - 1) * wp + (t % 3 - 1) : 0;
        for (int c0 = 0; c0 < s.cin; c0 += kBK) {
            // A: 128 shifted rows x 64 channels, quantized into shared
            // memory; 8 threads per row, 8 channels each
            #pragma unroll
            for (int pass = 0; pass < kBM / 32; ++pass) {
                const int r = tid / 8 + 32 * pass;
                const int c = c0 + (tid % 8) * 8;
                int src = row0 + r + off;
                src = min(max(src, 0), s.rows - 1);
                float v[8];
                if (c < s.cin) {
                    load8(x + (int64_t)src * s.cin + c, s.cin - c,
                          s.vec_x && c + 8 <= s.cin, v);
                } else {
                    #pragma unroll
                    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
                }
                uint2 packed;
                packed.x = quant4(v, inv);
                packed.y = quant4(v + 4, inv);
                *reinterpret_cast<uint2*>(a_s + r * kStride
                                          + (tid % 8) * 8) = packed;
            }
            // B: 128 output channels x 64 input channels of tap t;
            // 4 threads per channel, 16 bytes each
            #pragma unroll
            for (int pass = 0; pass < kBN / 64; ++pass) {
                const int nn = tid / 4 + 64 * pass;
                const int n = n0 + nn;
                const int c = c0 + (tid % 4) * 16;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (n < s.cout && c < s.cin) {
                    const int8_t* p = wq + ((int64_t)t * s.cout + n) * s.cin
                                      + c;
                    if (s.vec_w && c + 16 <= s.cin) {
                        val = *reinterpret_cast<const uint4*>(p);
                    } else {
                        int8_t* d = reinterpret_cast<int8_t*>(&val);
                        for (int j = 0; j < 16 && c + j < s.cin; ++j)
                            d[j] = p[j];
                    }
                }
                *reinterpret_cast<uint4*>(b_s + nn * kStride
                                          + (tid % 4) * 16) = val;
            }
            __syncthreads();
            #pragma unroll
            for (int kk = 0; kk < kBK; kk += 32) {
                uint32_t bf[4][2];
                #pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    const int8_t* p = b_s + (wn + ni * 8 + g) * kStride + kk
                                      + tig * 4;
                    bf[ni][0] = *reinterpret_cast<const uint32_t*>(p);
                    bf[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
                }
                #pragma unroll
                for (int mi = 0; mi < 4; ++mi) {
                    const int8_t* p = a_s + (wm + mi * 16 + g) * kStride + kk
                                      + tig * 4;
                    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(p);
                    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(
                        p + 8 * kStride);
                    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(
                        p + 16);
                    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(
                        p + 8 * kStride + 16);
                    #pragma unroll
                    for (int ni = 0; ni < 4; ++ni)
                        mma_s8(acc[mi][ni], a0, a1, a2, a3, bf[ni][0],
                               bf[ni][1]);
                }
            }
            __syncthreads();
        }
    }

    // epilogue from the accumulators: rows g and g + 8 of each 16-row
    // fragment, channels 2*tig and 2*tig + 1 of each 8-channel fragment
    const int wpad = s.w + 2, hpad = s.h + 2;
    const int p_rows = s.b * hpad * wpad;
    #pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        #pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = row0 + wm + mi * 16 + g + 8 * half;
            const int q = r - s.tm;
            const int wi = q % wpad;
            const int hi = (q / wpad) % hpad;
            const bool valid = q >= 0 && q < p_rows && wi >= 1 && wi <= s.w
                               && hi >= 1 && hi <= s.h;
            #pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                #pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int n = n0 + wn + ni * 8 + tig * 2 + j;
                    if (n >= s.cout) continue;
                    float v = 0.0f;
                    if (valid) {
                        v = __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + j]),
                                      sx);
                        v = __fmul_rn(v, s_w[n]);
                        v = __fadd_rn(v, bias[n]);
                        if (s.leaky && !(v > 0.0f)) v = __fmul_rn(0.1f, v);
                        if (skip != nullptr)
                            v = __fadd_rn(
                                v, to_f32(skip[(int64_t)r * s.cout + n]));
                    }
                    store_out(y + (int64_t)r * s.cout + n, v);
                }
            }
        }
    }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* wq, const float* s_w,
           const float* bias, const void* skip, float* chunk_max, void* y,
           const Shape& s, cudaStream_t stream) {
    const TIn* xt = static_cast<const TIn*>(x);
    const int n_chunks = s.rows / s.gr;
    chunk_absmax_kernel<TIn><<<n_chunks, kThreads, 0, stream>>>(
        xt, chunk_max, (int64_t)s.gr * s.cin, s.vec_x);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(s.rows / kBM, (s.cout + kBN - 1) / kBN);
    conv_int8_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
        xt, static_cast<const int8_t*>(wq), s_w, bias,
        static_cast<const TIn*>(skip), chunk_max, static_cast<TOut*>(y), s);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tile of the kernel: tm and gr must be multiples of it.
int conv_int8_row_tile() { return kBM; }

// x [rows, cin] (bf16 if x_bf16 else f32), wq [k*k, cout, cin] int8,
// s_w and bias [cout] f32, skip [rows, cout] of x's type or null,
// chunk_max [rows / gr] f32 scratch -> y [rows, cout] (bf16 if y_bf16
// else f32; bf16 only from bf16).  Returns a cudaError_t (0 on success).
int conv_int8_launch(const void* x, const void* wq, const float* s_w,
                     const float* bias, const void* skip, float* chunk_max,
                     void* y, int rows, int cin, int cout, int k, int leaky,
                     int b, int h, int w, int tm, int gr, int x_bf16,
                     int y_bf16, void* stream) {
    if ((k != 1 && k != 3) || cin < 1 || cout < 1 || gr < 1 || tm < kBM
        || tm % kBM || tm % gr || rows % tm || rows / tm < 2)
        return (int)cudaErrorInvalidValue;
    Shape s{rows, cin, cout, k, leaky, b, h, w, tm, gr, 0, 0};
    const size_t x_elem = x_bf16 ? 2 : 4;
    s.vec_x = (reinterpret_cast<uintptr_t>(x) % 16 == 0)
              && (cin * x_elem) % 16 == 0 && (gr * cin * x_elem) % 16 == 0;
    s.vec_w = (reinterpret_cast<uintptr_t>(wq) % 16 == 0) && cin % 16 == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_bf16 && y_bf16)
        return launch<__nv_bfloat16, __nv_bfloat16>(x, wq, s_w, bias, skip,
                                                    chunk_max, y, s, st);
    if (x_bf16)
        return launch<__nv_bfloat16, float>(x, wq, s_w, bias, skip,
                                            chunk_max, y, s, st);
    if (y_bf16)  // fp32 in, bf16 out: not a combination the port runs
        return (int)cudaErrorInvalidValue;
    return launch<float, float>(x, wq, s_w, bias, skip, chunk_max, y, s, st);
}

}  // extern "C"
