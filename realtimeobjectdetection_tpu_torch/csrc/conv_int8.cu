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
// What bounds it on this card: at yolov3 shapes the 3x3 convs at 13^2-52^2
// are bound by operations (2*k*k*C_in*C_out per content row at the dense
// int8 tensor rate), the 1x1 convs and the convs at 104^2 by bytes (the
// bf16 activations read once, the output written once).  This design is
// held elsewhere: the 3x3 products by how fast L2 feeds a 128 x 128 tile
// (32 KB for every 4.2 M operations; on an H100 they reach 18-27% of the
// int8 rate in chip_smoke.py), the 1x1 convs by the two passes over the
// input and by each tile's epilogue.
//
// Design: three kernels on the caller's stream.
//   1. chunk_absmax: max|x| of each gr-row chunk (in up to 8 parts where
//      the chunks are few).  tm is a multiple of gr and a halo is one
//      chunk, so block i's amax is the max over chunks [i*tm/gr - 1,
//      (i+1)*tm/gr] (k = 1: the block's own chunks).  Every row is read
//      once for the scales.
//   2. conv_int8_quantize: quantizes every input element once per conv into
//      Q, int8 with C_in rounded up to 16 (zeros past C_in), one window per
//      content block i (1 .. nb-2): the rows [i*tm - h, (i+1)*tm + h),
//      h = gr for k = 3 and 0 for k = 1, at block i's scale.  A content
//      block's halos never need the clamp, and the guard blocks' output is
//      0, so they have no window.  It also writes each block's amax and
//      clears the split counters of kernel 3.
//   3. conv_int8_kernel: an int8 implicit GEMM over 128-row x 128-channel
//      output tiles, one persistent block of three warpgroups on each SM.
//      Warpgroup 0 is the producer: one thread walks the block's tiles and
//      their (tap, C_in slice) steps and starts two TMA loads a step into a
//      ring of mbarrier-guarded stages, as deep as shared memory allows
//      beside the epilogue's tiles (3-5 steps of 128-byte slices, 6-10 of
//      64-byte slices where C_in <= 64): the A box is 128 rows of Q at the
//      tile's window row plus the tap's offset o_t (TMA takes any start
//      row, so the shifted window needs no copy), the B box 128 output
//      channels of the tap's int8 weights [k*k, C_out, C_in], zero-filled
//      past C_out, both swizzled by TMA at the slice width.  It runs ahead
//      into the next tile while the consumers finish this one, and brings
//      each tile's skip rows into shared memory by TMA as soon as the last
//      epilogue is done with them.  Its warps 1-3 write the tiles with no
//      content row (the guard blocks, past the last image) as zeros.
//      Warpgroups 1 and 2 each own 64 rows and run wgmma.mma_async
//      m64n128k32 s32.s8.s8 straight from shared-memory descriptors, one
//      wgmma group in flight while the next stage is waited for; a stage
//      goes back to the producer when its group has completed.
//      Where the tiles with content are fewer than the SMs (the 1x1 convs
//      at 13^2), each tile's (tap, slice) steps are split into parts that
//      run on other SMs: each part stores its int32 sums to a workspace,
//      and the last part to finish a tile (an atomic counter per tile) adds
//      the others' to its own and runs the one epilogue.  The split is
//      chosen from the shapes in Python (ops/cuda/conv_int8.plan).  Integer
//      sums are exact, so tiling, split and product order leave acc as it
//      is.
//      Epilogue, from the accumulator registers: each output's fp32 chain
//      in the order above, the skip read from the skip tile, the results
//      written in the output type to a 128-byte-swizzled tile in shared
//      memory (no bank conflicts), which one thread stores with TMA.  TMA
//      cannot address rows that are not whole 16-byte units (C_out = 255:
//      rows of 510 or 1020 bytes); there each warp copies whole rows of the
//      tile, 32 consecutive elements a store.
// What this does about the first kernel's five faults: loads overlap the
// tensor cores (TMA ring, producer warpgroup); each element is quantized
// once per conv, not once per tap and output tile; the products use wgmma;
// the output leaves by TMA stores of whole tiles; the split and the
// persistent schedule fill the SMs.  Tried and slower on this card: two
// consumer warpgroups taking whole tiles in turn (ping-pong, 128
// accumulators each after setmaxnreg), and one cluster pass for the max and
// the quantization.
//
// No launch synchronises or allocates: the wrapper passes one scratch
// buffer (chunk maxima, block amax, split counters, Q, split workspace).
// The C entry point returns a cudaError_t (or CUresult of the tensor map
// encoding), 0 on success.

#include <algorithm>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;             // output rows per tile
constexpr int kBN = 128;             // output channels per tile
constexpr int kThreads = 384;        // warpgroup 0 producer, 1-2 consumers
constexpr int kConsumers = 256;
constexpr int kMaxStages = 10;
constexpr int kSmemLimit = 232448;     // a block's shared memory on Hopper
constexpr int kSmemExtra = 1024 + 1536;  // alignment, s_w and bias,
                                         // barriers, flag
constexpr int kAuxThreads = 256;       // chunk max and quantize passes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// Eight consecutive elements as floats: one or two 16-byte loads when
// ``vec`` (aligned, all eight inside the row), else element by element
// with the elements at or past ``n_valid`` read as 0.
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

// Eight consecutive outputs: 16-byte stores when ``vec``, else the first
// ``n_valid`` one by one.
__device__ __forceinline__ void store8(float* p, int n_valid, bool vec,
                                       const float (&v)[8]) {
    if (vec) {
        reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
        #pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < n_valid) p[j] = v[j];
    }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int n_valid,
                                       bool vec, const float (&v)[8]) {
    if (vec) {
        uint4 a;
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
        #pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(v[j]);
        *reinterpret_cast<uint4*>(p) = a;
    } else {
        #pragma unroll
        for (int j = 0; j < 8; ++j)
            if (j < n_valid) p[j] = __float2bfloat16_rn(v[j]);
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

// ---- mbarrier, TMA and wgmma (PTX) ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity ``parity`` to complete.  A wait of more
// than 2^32 clocks (seconds: every real wait here is microseconds) traps,
// so a pipeline fault ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    long long start = 0;
    for (;;) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (start == 0) start = clock64();
        else if (clock64() - start > (1ll << 32)) __trap();
    }
}

// Whether the phase of parity ``parity`` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
           "r"(c0), "r"(c1)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the bulk stores started by this thread have read their
// shared memory.
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a K-major operand whose rows are
// ``row_bytes`` (64 or 128) long, swizzled by TMA at that width: 8-row
// groups ``8 * row_bytes`` apart; the leading offset is unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int row_bytes) {
    const uint64_t layout = row_bytes == 128 ? 1 : 2;  // 128B / 64B swizzle
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)1 << 16)
           | ((uint64_t)((8 * row_bytes) >> 4) << 32)
           | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmma instructions that read and write them.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
    #pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D[64 x 128] += A[64 x 32] . B[128 x 32]^T, s8 x s8 -> s32, both operands
// K-major in shared memory.  d[4j .. 4j+3] of lane l in warp w of the
// warpgroup are rows 16w + l/4 (+ 8 for the last two), columns
// 8j + 2(l%4) (+ 1).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// Named barrier of the two consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- kernels ----------------------------------------------------------------

// blockIdx.x = chunk, blockIdx.y = part: max|x| over the part's elements
// [part * per, (part + 1) * per) of the chunk (per a multiple of 8), into
// chunk_max[chunk * parts + part].  More parts than one per chunk keep the
// SMs busy where the chunks are few.
template <typename TIn>
__global__ void __launch_bounds__(kAuxThreads)
chunk_absmax_kernel(const TIn* __restrict__ x, float* __restrict__ chunk_max,
                    int64_t chunk_elems, int64_t per, int vec) {
    const int64_t e0 = blockIdx.y * per;
    const int64_t e1 = min(e0 + per, chunk_elems);
    const TIn* base = x + (int64_t)blockIdx.x * chunk_elems;
    float m = 0.0f;
    if (vec) {  // four 16-byte loads in flight a thread
        constexpr int kStep = 8 * kAuxThreads;
        int64_t e = e0 + 8 * (int64_t)threadIdx.x;
        for (; e + 3 * kStep < e1; e += 4 * kStep) {
            float v[4][8];
            #pragma unroll
            for (int i = 0; i < 4; ++i) load8(base + e + i * kStep, 8, true,
                                              v[i]);
            #pragma unroll
            for (int i = 0; i < 4; ++i)
                #pragma unroll
                for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[i][j]));
        }
        for (; e < e1; e += kStep) {
            float v[8];
            load8(base + e, 8, true, v);
            #pragma unroll
            for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
        }
    } else {
        for (int64_t e = e0 + threadIdx.x; e < e1; e += kAuxThreads)
            m = fmaxf(m, fabsf(to_f32(base[e])));
    }
    #pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    __shared__ float warp_max[kAuxThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        float r = warp_max[0];
        for (int i = 1; i < kAuxThreads / 32; ++i) r = fmaxf(r, warp_max[i]);
        chunk_max[(int64_t)blockIdx.x * gridDim.y + blockIdx.y] = r;
    }
}

// blockIdx.y = content block i - 1; 16 channels of one Q row a thread.
template <typename TIn>
__global__ void __launch_bounds__(kAuxThreads)
conv_int8_quantize_kernel(const TIn* __restrict__ x,
                          const float* __restrict__ chunk_max, int parts,
                          int8_t* __restrict__ q, float* __restrict__ blk_amax,
                          int* __restrict__ counters, int n_counters, int cin,
                          int cq, int tm, int gr, int halo, int vec) {
    const int blk = blockIdx.y + 1;
    const int qb = tm + 2 * halo;
    __shared__ float s_inv;
    if (threadIdx.x == 0) {
        const int tmb = tm / gr;
        const int c_lo = blk * tmb - (halo ? 1 : 0);
        const int c_hi = (blk + 1) * tmb - 1 + (halo ? 1 : 0);
        float amax = 0.0f;
        for (int c = c_lo * parts; c < (c_hi + 1) * parts; ++c)
            amax = fmaxf(amax, chunk_max[c]);
        amax = fmaxf(amax, 1e-6f);
        s_inv = __fdiv_rn(127.0f, amax);
        if (blockIdx.x == 0) blk_amax[blockIdx.y] = amax;
    }
    if (blockIdx.y == 0)
        for (int i = blockIdx.x * kAuxThreads + threadIdx.x; i < n_counters;
             i += gridDim.x * kAuxThreads)
            counters[i] = 0;
    __syncthreads();
    const float inv = s_inv;
    const int groups = cq / 16;
    const int total = qb * groups;  // (row, 16-channel group) items
    const TIn* src = x + ((int64_t)blk * tm - halo) * cin;
    int8_t* dst = q + (int64_t)blockIdx.y * qb * cq;
    for (int e = blockIdx.x * kAuxThreads + threadIdx.x; e < total;
         e += gridDim.x * kAuxThreads) {
        const int j = e / groups;
        const int c = (e - j * groups) * 16;
        float v[16];
        float (&lo)[8] = *reinterpret_cast<float(*)[8]>(v);
        float (&hi)[8] = *reinterpret_cast<float(*)[8]>(v + 8);
        load8(src + (int64_t)j * cin + c, cin - c, vec, lo);
        load8(src + (int64_t)j * cin + c + 8, cin - c - 8, vec, hi);
        uint4 out;
        out.x = quant4(v, inv);
        out.y = quant4(v + 4, inv);
        out.z = quant4(v + 8, inv);
        out.w = quant4(v + 12, inv);
        *reinterpret_cast<uint4*>(dst + (int64_t)j * cq + c) = out;
    }
}

struct Params {
    int rows, cin, cout, k, leaky;
    int b, h, w, tm, halo;
    int bk, slices, splits, vec_out;
    int row_tiles, col_tiles, first_tile, content_tiles;
    const float* blk_amax;
    const float* s_w;
    const float* bias;
    const void* skip;
    void* y;
    int* ws;
    int* counters;
};

// One unit of work: a (content row tile, column tile, split).  Column tile
// outermost, split innermost: the blocks in flight share weights and
// neighbouring rows of Q.
struct Unit {
    int row0, n0, split, tile;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
    const int split = u % p.splits;
    const int rc = u / p.splits;
    const int ct = rc / p.content_tiles;
    const int rt = p.first_tile + rc - ct * p.content_tiles;
    return {rt * kBM, ct * kBN, split, rt * p.col_tiles + ct};
}

// Zeros over one tile with no content row, ``n`` threads from ``tid``.
template <typename TOut>
__device__ void zero_tile(const Params& p, int row0, int n0, int tid, int n) {
    const int ncol = min(kBN, p.cout - n0);
    const float z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    TOut* y = static_cast<TOut*>(p.y) + (int64_t)row0 * p.cout + n0;
    const int groups = (ncol + 7) / 8;
    for (int e = tid; e < kBM * groups; e += n) {
        const int r = e / groups, c = (e - r * groups) * 8;
        store8(y + (int64_t)r * p.cout + c, ncol - c, p.vec_out, z);
    }
}

__device__ __forceinline__ float epi(int acc, float sx, float sw, float b,
                                     bool leaky) {
    float t = __fmul_rn(__int2float_rn(acc), sx);
    t = __fmul_rn(t, sw);
    t = __fadd_rn(t, b);
    if (leaky && !(t > 0.0f)) t = __fmul_rn(0.1f, t);
    return t;
}

__device__ __forceinline__ bool content_row(const Params& p, int row) {
    const int wpad = p.w + 2, hpad = p.h + 2;
    const int q = row - p.tm;
    const int wi = q % wpad;
    const int hi = (q / wpad) % hpad;
    return q >= 0 && q < p.b * hpad * wpad && wi >= 1 && wi <= p.w
           && hi >= 1 && hi <= p.h;
}

// Byte offset of byte ``byte`` of row ``r`` in a 128-row tile kept as boxes
// 128 bytes wide, each swizzled as TMA's 128-byte swizzle lays it out: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int byte) {
    return (byte >> 7) * (kBM * 128) + r * 128
           + ((((byte & 127) >> 4) ^ (r & 7)) << 4) + (byte & 15);
}

__device__ __forceinline__ void put2(uint8_t* t, float a, float b,
                                     __nv_bfloat16*) {
    *reinterpret_cast<__nv_bfloat162*>(t) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(uint8_t* t, float a, float b, float*) {
    *reinterpret_cast<float2*>(t) = make_float2(a, b);
}
__device__ __forceinline__ float2 get2(const uint8_t* t, __nv_bfloat16*) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t));
}
__device__ __forceinline__ float2 get2(const uint8_t* t, float*) {
    return *reinterpret_cast<const float2*>(t);
}

// Shared memory of the conv kernel for a pair of types: the output tile and
// the skip tile (128 x 128 each, in 128-byte swizzled boxes), and a ring of
// as many 32 KB steps as the rest of the 227 KB holds.
template <typename TIn, typename TOut>
struct Smem {
    static constexpr int kOut = kBM * kBN * (int)sizeof(TOut);
    static constexpr int kSkip = kBM * kBN * (int)sizeof(TIn);
    static constexpr int kRing =
        (kSmemLimit - kSmemExtra - kOut - kSkip) / (32 * 1024) * (32 * 1024);
    static constexpr int kBytes = kRing + kOut + kSkip + kSmemExtra;
};

// The epilogue of one tile, from the accumulators of this thread (rows fr
// and fr + 8 of the tile, columns 8j + fc and 8j + fc + 1): the fp32 chain
// of each output in the operation order of the note, written in the output
// type to the swizzled output tile.  The skip comes from the skip tile
// ``skip_s`` where TMA brought it, else from device memory.
template <typename TIn, typename TOut>
__device__ void epilogue(const Params& p, const int (&acc)[64], uint8_t* out,
                         const uint8_t* skip_s, const float* sw_s,
                         const float* b_s, float sx, const bool (&valid)[2],
                         int row0, int n0, int fr, int fc) {
    const int ncol = min(kBN, p.cout - n0);
    const TIn* skip = static_cast<const TIn*>(p.skip);
    #pragma unroll
    for (int j = 0; j < 16; ++j) {
        if (8 * j >= ncol) break;
        const int c = 8 * j + fc;
        const int n = n0 + c;
        const float2 sw = *reinterpret_cast<const float2*>(sw_s + c);
        const float2 bb = *reinterpret_cast<const float2*>(b_s + c);
        const float sw0 = sw.x, sw1 = sw.y, b0 = bb.x, b1 = bb.y;
        #pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = fr + 8 * h;
            float v0 = 0.0f, v1 = 0.0f;
            if (valid[h]) {
                v0 = epi(acc[4 * j + 2 * h], sx, sw0, b0, p.leaky);
                v1 = epi(acc[4 * j + 2 * h + 1], sx, sw1, b1, p.leaky);
                if (skip_s != nullptr) {
                    const float2 s = get2(
                        skip_s + sw128(r, c * (int)sizeof(TIn)), (TIn*)0);
                    v0 = __fadd_rn(v0, s.x);
                    v1 = __fadd_rn(v1, s.y);
                } else if (skip != nullptr) {
                    const TIn* sp = skip + (int64_t)(row0 + r) * p.cout + n;
                    if (c < ncol) v0 = __fadd_rn(v0, to_f32(sp[0]));
                    if (c + 1 < ncol) v1 = __fadd_rn(v1, to_f32(sp[1]));
                }
            }
            put2(out + sw128(r, c * (int)sizeof(TOut)), v0, v1, (TOut*)0);
        }
    }
}

// Persistent: block b takes units b, b + gridDim.x, ...; the producer
// thread runs ahead through them as far as the ring allows, so the next
// unit's loads overlap this unit's epilogue, and loads each unit's skip
// tile as soon as the last epilogue is done with the skip buffer.  Warps
// 1-3 of the producer warpgroup write the tiles with no content row
// meanwhile.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
conv_int8_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_y,
                 const __grid_constant__ CUtensorMap map_skip,
                 const Params p) {
    using S = Smem<TIn, TOut>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint8_t* out = smem + S::kRing;
    uint8_t* skip_s = out + S::kOut;
    uint64_t* full = reinterpret_cast<uint64_t*>(skip_s + S::kSkip);
    uint64_t* empty = full + kMaxStages;
    uint64_t* skip_full = empty + kMaxStages;
    uint64_t* skip_empty = skip_full + 1;
    int* last_flag = reinterpret_cast<int*>(skip_empty + 1);
    float* sx_s = reinterpret_cast<float*>(last_flag + 1);
    float* sw_s = reinterpret_cast<float*>(smem + S::kBytes - 1024 - 1024);
    float* b_s = sw_s + kBN;

    const int stage_bytes = (kBM + kBN) * p.bk;
    const int stages = S::kRing / stage_bytes;
    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], kConsumers);
        }
        mbar_init(skip_full, 1);
        mbar_init(skip_empty, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int iters = p.k * p.k * p.slices;
    const int n_units = p.content_tiles * p.col_tiles * p.splits;
    // the skip tile comes by TMA where the rows allow it and no split
    const bool tma_skip = p.skip != nullptr && p.vec_out && p.splits == 1;
    constexpr int kSkipBox = 128 / (int)sizeof(TIn);  // columns a box
    constexpr int kOutBox = 128 / (int)sizeof(TOut);
    if (threadIdx.x < 128) {  // producer warpgroup
        if (threadIdx.x == 0) {  // one thread starts every TMA load
            int s = 0;
            uint32_t phase = 0, skip_phase = 0;
            for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
                const Unit w = unit_of(p, u);
                const int blk = w.row0 / p.tm;
                // the tile's first row in Q: the window starts h rows early
                const int qrow0 = (blk - 1) * (p.tm + 2 * p.halo) + p.halo
                                  + (w.row0 - blk * p.tm);
                const int it1 = (int)((int64_t)iters * (w.split + 1)
                                      / p.splits);
                bool need_skip = tma_skip;
                auto load_skip = [&]() {
                    const int boxes = min(kBN / kSkipBox,
                                          (p.cout - w.n0 + kSkipBox - 1)
                                          / kSkipBox);
                    mbar_expect_tx(skip_full, boxes * kBM * 128);
                    for (int b = 0; b < boxes; ++b)
                        tma_load_2d(skip_s + b * kBM * 128, &map_skip,
                                    w.n0 + b * kSkipBox, w.row0, skip_full);
                    skip_phase ^= 1;
                    need_skip = false;
                };
                for (int it = (int)((int64_t)iters * w.split / p.splits);
                     it < it1; ++it) {
                    const int t = it / p.slices;
                    const int c0 = (it - t * p.slices) * p.bk;
                    const int off = p.k == 3 ? (t / 3 - 1) * (p.w + 2)
                                               + (t % 3 - 1) : 0;
                    mbar_wait(&empty[s], phase ^ 1);
                    uint8_t* a = smem + s * stage_bytes;
                    mbar_expect_tx(&full[s], stage_bytes);
                    tma_load_2d(a, &map_a, c0, qrow0 + off, &full[s]);
                    tma_load_3d(a + kBM * p.bk, &map_b, c0, w.n0, t,
                                &full[s]);
                    if (++s == stages) { s = 0; phase ^= 1; }
                    if (need_skip && mbar_test(skip_empty, skip_phase ^ 1))
                        load_skip();
                }
                if (need_skip) {
                    mbar_wait(skip_empty, skip_phase ^ 1);
                    load_skip();
                }
            }
        } else if (threadIdx.x >= 32) {
            const int n_zero = (p.row_tiles - p.content_tiles) * p.col_tiles;
            for (int z = blockIdx.x; z < n_zero; z += gridDim.x) {
                int rt = z / p.col_tiles;
                const int ct = z - rt * p.col_tiles;
                if (rt >= p.first_tile) rt += p.content_tiles;
                zero_tile<TOut>(p, rt * kBM, ct * kBN, threadIdx.x - 32, 96);
            }
        }
        return;
    }

    const int ctid = threadIdx.x - 128;  // 0..255
    const int wg = ctid / 128;           // rows [64 wg, 64 wg + 64)
    const int lane = ctid % 32;
    const int fr = wg * 64 + ((ctid / 32) % 4) * 16 + lane / 4;
    const int fc = (lane % 4) * 2;
    int s = 0;
    uint32_t phase = 0, skip_phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const Unit w = unit_of(p, u);
        // the epilogue's constants, on their way while the sums run
        const float amax = p.blk_amax[w.row0 / p.tm - 1];
        const bool valid[2] = {content_row(p, w.row0 + fr),
                               content_row(p, w.row0 + fr + 8)};
        const int n_sb = w.n0 + ctid % kBN;  // ctid < kBN: s_w, else bias
        const float sb = n_sb < p.cout ? (ctid < kBN ? p.s_w : p.bias)[n_sb]
                                       : 0.0f;
        int acc[64];
        #pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        const int it0 = (int)((int64_t)iters * w.split / p.splits);
        const int it1 = (int)((int64_t)iters * (w.split + 1) / p.splits);
        int prev = -1;
        for (int it = it0; it < it1; ++it) {
            mbar_wait(&full[s], phase);
            const uint32_t a = smem_u32(smem + s * stage_bytes);
            const uint64_t da = smem_desc(a + wg * 64 * p.bk, p.bk);
            const uint64_t db = smem_desc(a + kBM * p.bk, p.bk);
            wgmma_fence();
            if (p.bk == 128) {  // k32 steps of 32 bytes: +2 address units
                #pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
            } else {
                #pragma unroll
                for (int kk = 0; kk < 2; ++kk)
                    wgmma_m64n128k32(acc, da + 2 * kk, db + 2 * kk);
            }
            wgmma_commit();
            fence_acc(acc);
            wgmma_wait<1>();
            fence_acc(acc);
            if (prev >= 0) mbar_arrive(&empty[prev]);
            prev = s;
            if (++s == stages) { s = 0; phase ^= 1; }
        }
        wgmma_wait<0>();
        fence_acc(acc);
        mbar_arrive(&empty[prev]);

        if (p.splits > 1) {
            const int64_t tile_vecs = kBM * kBN / 4;
            const int n_tiles = p.row_tiles * p.col_tiles;
            int4* ws = reinterpret_cast<int4*>(p.ws);
            int4* mine = ws + ((int64_t)w.split * n_tiles + w.tile)
                              * tile_vecs;
            #pragma unroll
            for (int j = 0; j < 16; ++j)
                __stcg(mine + j * kConsumers + ctid,
                       make_int4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                 acc[4 * j + 3]));
            __threadfence();
            consumer_sync();
            if (ctid == 0)
                *last_flag = atomicAdd(p.counters + w.tile, 1)
                             == p.splits - 1;
            consumer_sync();
            if (!*last_flag) continue;
            __threadfence();
            for (int o = 0; o < p.splits; ++o) {
                if (o == w.split) continue;
                const int4* other = ws + ((int64_t)o * n_tiles + w.tile)
                                         * tile_vecs;
                #pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const int4 v = __ldcg(other + j * kConsumers + ctid);
                    acc[4 * j] += v.x;
                    acc[4 * j + 1] += v.y;
                    acc[4 * j + 2] += v.z;
                    acc[4 * j + 3] += v.w;
                }
            }
        }

        if (tma_skip) {
            mbar_wait(skip_full, skip_phase);
            skip_phase ^= 1;
        }
        sw_s[ctid] = sb;  // this tile's s_w, then bias (b_s = sw_s + kBN)
        if (ctid == 0) {
            *sx_s = __fdiv_rn(amax, 127.0f);  // the block's scale
            bulk_wait_read();  // the last tile has left `out`
        }
        consumer_sync();  // and every thread is past it
        epilogue<TIn, TOut>(p, acc, out, tma_skip ? skip_s : nullptr, sw_s,
                            b_s, *sx_s, valid, w.row0, w.n0, fr, fc);
        fence_proxy_async();
        consumer_sync();
        const int ncol = min(kBN, p.cout - w.n0);
        if (p.vec_out) {  // rows are whole 16-byte units: TMA stores it
            if (ctid == 0) {
                if (tma_skip) mbar_arrive(skip_empty);
                for (int b = 0; b * kOutBox < ncol; ++b)
                    tma_store_2d(&map_y, out + b * kBM * 128,
                                 w.n0 + b * kOutBox, w.row0);
            }
        } else {  // each warp copies whole rows, 32 consecutive elements
            TOut* y = static_cast<TOut*>(p.y);
            for (int r = ctid / 32; r < kBM; r += kConsumers / 32)
                for (int c = lane; c < ncol; c += 32)
                    y[(int64_t)(w.row0 + r) * p.cout + w.n0 + c] =
                        *reinterpret_cast<const TOut*>(
                            out + sw128(r, c * (int)sizeof(TOut)));
        }
    }
    if (ctid == 0) bulk_wait_read();  // before the block's memory goes
}

// ---- host -------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
            &status);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
        if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// A tensor map of ``rank`` dims (innermost first) with a box of ``box``.
int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
             int rank, const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint32_t elem[3] = {1, 1, 1};
    CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides,
                    box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)r;
}

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

struct Launch {
    const void* x;
    const void* wq;
    float* chunk_max;
    int parts;     // chunk max parts per gr-row chunk
    int8_t* q;
    int q_rows, cq, gr;
    int blocks;    // persistent blocks of the conv kernel
};

template <typename TIn, typename TOut>
int launch(const Launch& l, const Params& p, cudaStream_t stream) {
    const TIn* xt = static_cast<const TIn*>(l.x);
    const int64_t chunk_elems = (int64_t)l.gr * p.cin;
    const int64_t per = (chunk_elems + 8 * l.parts - 1) / (8 * l.parts) * 8;
    chunk_absmax_kernel<TIn>
        <<<dim3(p.rows / l.gr, l.parts), kAuxThreads, 0, stream>>>(
            xt, l.chunk_max, chunk_elems, per,
            aligned16(l.x) && (p.cin * sizeof(TIn)) % 16 == 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int nbq = p.rows / p.tm - 2;
    const int qb = p.tm + 2 * p.halo;
    const int work = qb * (l.cq / 16);
    const int gx = std::min(64, std::max(1, (work + 4 * kAuxThreads - 1)
                                            / (4 * kAuxThreads)));
    conv_int8_quantize_kernel<TIn><<<dim3(gx, nbq), kAuxThreads, 0, stream>>>(
        xt, l.chunk_max, l.parts, l.q, const_cast<float*>(p.blk_amax),
        p.counters, p.splits > 1 ? p.row_tiles * p.col_tiles : 0, p.cin,
        l.cq, p.tm, l.gr, p.halo, aligned16(l.x) && p.cin % 16 == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // A: Q as [q_rows, cq]; B: the weights as [k*k, cout, cq]; boxes of
    // bk bytes by 128 rows, swizzled at bk bytes.  Y: the output as
    // [rows, cout], a 128 x 128 box (only where its rows are whole
    // multiples of 16 bytes).
    CUtensorMap map_a, map_b, map_y = {}, map_skip = {};
    const CUtensorMapSwizzle sw = p.bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
    const cuuint32_t box[3] = {(cuuint32_t)p.bk, kBM, 1};
    const cuuint64_t dims_a[2] = {(cuuint64_t)l.cq, (cuuint64_t)l.q_rows};
    const cuuint64_t strides_a[1] = {(cuuint64_t)l.cq};
    int r = make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, l.q, 2, dims_a,
                     strides_a, box, sw);
    if (r != 0) return r;
    const cuuint64_t dims_b[3] = {(cuuint64_t)l.cq, (cuuint64_t)p.cout,
                                  (cuuint64_t)(p.k * p.k)};
    const cuuint64_t strides_b[2] = {(cuuint64_t)l.cq,
                                     (cuuint64_t)l.cq * p.cout};
    r = make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, l.wq, 3, dims_b,
                 strides_b, box, sw);
    if (r != 0) return r;
    if (p.vec_out) {  // output and skip rows are whole 16-byte units
        const cuuint64_t dims_y[2] = {(cuuint64_t)p.cout,
                                      (cuuint64_t)p.rows};
        const cuuint64_t strides_y[1] = {(cuuint64_t)p.cout * sizeof(TOut)};
        const cuuint32_t box_y[2] = {128 / sizeof(TOut), kBM};
        r = make_map(&map_y, sizeof(TOut) == 2
                             ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                     p.y, 2, dims_y, strides_y, box_y,
                     CU_TENSOR_MAP_SWIZZLE_128B);
        if (r != 0) return r;
        if (p.skip != nullptr) {
            const cuuint64_t strides_s[1] = {(cuuint64_t)p.cout
                                             * sizeof(TIn)};
            const cuuint32_t box_s[2] = {128 / sizeof(TIn), kBM};
            r = make_map(&map_skip, sizeof(TIn) == 2
                                    ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         p.skip, 2, dims_y, strides_s, box_s,
                         CU_TENSOR_MAP_SWIZZLE_128B);
            if (r != 0) return r;
        }
    }

    static uint64_t attr_set = 0;  // a bit per device, per instantiation
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !(attr_set >> dev & 1)) {
        err = cudaFuncSetAttribute(conv_int8_kernel<TIn, TOut>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Smem<TIn, TOut>::kBytes);
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) attr_set |= (uint64_t)1 << dev;
    }
    conv_int8_kernel<TIn, TOut>
        <<<l.blocks, kThreads, Smem<TIn, TOut>::kBytes, stream>>>(
        map_a, map_b, map_y, map_skip, p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's geometry, which the wrapper's plan mirrors: 0 and 1 the
// output row and channel tile; 2-4 the ring's bytes and 5-7 the dynamic
// shared memory for bf16 -> bf16, bf16 -> fp32, fp32 -> fp32.
int conv_int8_geometry(int what) {
    using B = __nv_bfloat16;
    const int g[8] = {kBM, kBN, Smem<B, B>::kRing, Smem<B, float>::kRing,
                      Smem<float, float>::kRing, Smem<B, B>::kBytes,
                      Smem<B, float>::kBytes, Smem<float, float>::kBytes};
    return what >= 0 && what < 8 ? g[what] : -1;
}

// x [rows, cin] (bf16 if x_bf16 else f32); wq [k*k, cout, cq] int8 (cq =
// cin rounded up to 16, zeros past cin); s_w and bias [cout] f32; skip
// [rows, cout] of x's type or null; scratch: chunk_max [rows / gr, parts]
// f32, blk_amax [nb - 2] f32, counters [n_tiles] i32 (splits > 1),
// q [(nb - 2) * (tm + 2h), cq] int8, ws [splits, n_tiles, 128 * 128] i32
// (splits > 1), n_tiles = (rows / 128) * ceil(cout / 128) -> y [rows,
// cout] (bf16 if y_bf16 else f32; bf16 only from bf16).  bk is 64 or 128
// bytes of C_in per stage, splits the number of parts of the (tap, slice)
// loop, parts the chunk max's parts per chunk, blocks the conv kernel's
// grid.  Returns 0 on success.
int conv_int8_launch(const void* x, const void* wq, const float* s_w,
                     const float* bias, const void* skip, float* chunk_max,
                     float* blk_amax, int* counters, void* q, int* ws,
                     void* y, int rows, int cin, int cout, int k, int leaky,
                     int b, int h, int w, int tm, int gr, int x_bf16,
                     int y_bf16, int cq, int bk, int splits, int parts,
                     int blocks, void* stream) {
    const int slices = (cq + bk - 1) / bk;
    if ((k != 1 && k != 3) || cin < 1 || cout < 1 || gr < 1 || tm < kBM
        || tm % kBM || tm % gr || rows % tm || rows / tm < 3
        || (k == 3 && gr < w + 3) || cq < cin || cq % 16
        || (bk != 64 && bk != 128) || splits < 1
        || splits > k * k * slices || parts < 1 || blocks < 1
        || (int64_t)(tm + 2 * gr) * cq >= (int64_t)1 << 31
        || !aligned16(q) || !aligned16(wq))
        return (int)cudaErrorInvalidValue;
    Params p{};
    p.rows = rows; p.cin = cin; p.cout = cout; p.k = k; p.leaky = leaky;
    p.b = b; p.h = h; p.w = w; p.tm = tm; p.halo = k == 3 ? gr : 0;
    p.bk = bk; p.slices = slices;
    p.splits = splits;
    p.vec_out = cout % 8 == 0 && aligned16(y)
                && (skip == nullptr || aligned16(skip));
    p.row_tiles = rows / kBM;
    p.col_tiles = (cout + kBN - 1) / kBN;
    p.first_tile = tm / kBM;
    p.content_tiles = (tm + b * (h + 2) * (w + 2) + kBM - 1) / kBM
                      - p.first_tile;
    p.blk_amax = blk_amax; p.s_w = s_w; p.bias = bias; p.skip = skip;
    p.y = y; p.ws = ws; p.counters = counters;
    Launch l{x, wq, chunk_max, parts, static_cast<int8_t*>(q),
             (rows / tm - 2) * (tm + 2 * p.halo), cq, gr, blocks};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_bf16 && y_bf16)
        return launch<__nv_bfloat16, __nv_bfloat16>(l, p, st);
    if (x_bf16) return launch<__nv_bfloat16, float>(l, p, st);
    if (y_bf16)  // fp32 in, bf16 out: not a combination the port runs
        return (int)cudaErrorInvalidValue;
    return launch<float, float>(l, p, st);
}

}  // extern "C"
