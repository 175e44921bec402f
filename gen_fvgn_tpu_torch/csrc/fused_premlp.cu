// K5f: the Transolver block's pre-LN MLP branch with its residual, forward,
// for sm_90a:
//
//   u   = bf16(LN(x) * gamma + beta)
//   h   = bf16(gelu(u * W1 + b1))                    W1 [128, 256]
//   out = bf16((h * W2 + b2) + x)                    W2 [256, 128]
//
// Replaces the Pallas TPU kernel _premlp_fwd_kernel of
// gen_fvgn_tpu/ops/fused_mlp.py (core :691-711, called at :747).
//
// What bounds it on the H100: bytes. A row costs 2*(128*256 + 256*128) =
// 131 k FLOP against 512 bytes moved (x read once, out written once), 256
// FLOP/byte, under the card's ~295 FLOP/byte bf16 ridge.
//
// Design. Rows are independent: [B, N, 128] is flattened to [M, 128] and the
// ragged last 64-row tile is masked, so M needs no padding. A block stages
// W1 and W2 in shared memory as bf16 once (135 KB with row padding against
// bank conflicts) and walks over 64-row tiles (grid = min(tiles, SMs)). The
// LayerNorm runs a row per warp (4 columns a lane, statistics by warp
// shuffles); the lane keeps its raw x values in registers for the residual.
// The two products run on the tensor cores through wmma (bf16 operands,
// float32 accumulators); the 256-wide hidden layer is produced in two
// 128-column halves through one float32 staging tile, so u, h1pre, h and y
// never reach device memory. Shared memory: 222 KB, one block per SM. This
// first form stages every accumulator through shared memory; its times stand
// in PERF.md beside its bound.
//
// Rounding points (the TPU kernel's): LayerNorm statistics in float32 (fast
// variance clamped at 0, eps 1e-6); u rounded to bf16 before W1; h1pre, GELU
// (tanh form) in float32, h rounded to bf16 before W2; the residual x is
// added in float32 BEFORE the one final bf16 rounding (unlike K2's epilogue,
// which rounds first and adds in bf16).
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 128;          // stream width = LayerNorm width
constexpr int HD = 256;         // hidden width (mlp_ratio 2)
constexpr int TM = 64;          // rows per tile
constexpr int THREADS = 256;    // 8 warps: 4 row blocks x 2 column halves
constexpr int ROWS_PER_WARP = TM / (THREADS / 32);
constexpr int LDW1 = HD + 8;    // bf16 leading dim of staged W1 [C][LDW1]
constexpr int LDW2 = C + 8;     // bf16 leading dim of staged W2 [HD][LDW2]
constexpr int LDU = C + 8;      // bf16 leading dim of u [TM][LDU]
constexpr int LDH = HD + 8;     // bf16 leading dim of h [TM][LDH]
constexpr int LDC = C + 4;      // f32 leading dim of the staging tile
constexpr float kLnEps = 1e-6f;

constexpr size_t kSmemBytes =
    (size_t)C * LDW1 * sizeof(bf16) + (size_t)HD * LDW2 * sizeof(bf16) +
    (size_t)TM * LDU * sizeof(bf16) + (size_t)TM * LDH * sizeof(bf16) +
    (size_t)TM * LDC * sizeof(float);

struct Params {
    const bf16* x;        // [M, C]
    const float* gamma;   // [C]
    const float* beta;    // [C]
    const bf16* w1;       // [C, HD]
    const float* b1;      // [HD]
    const bf16* w2;       // [HD, C]
    const float* b2;      // [C]
    bf16* out;            // [M, C]
    int M;
};

__device__ __forceinline__ float gelu_tanh(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(u));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// sC[16 rows of block rb, columns c0..c0+63] = A[16 x K] * B[K x (b0+c0 ..)]
template <int K>
__device__ __forceinline__ void warp_gemm(const bf16* sA, int lda,
                                          const bf16* sB, int ldb, int b0,
                                          float* sC, int rb, int c0) {
    FragC acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll 4
    for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, sA + rb * 16 * lda + k0, lda);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, sB + k0 * ldb + b0 + c0 + t * 16, ldb);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
        wmma::store_matrix_sync(sC + rb * 16 * LDC + c0 + t * 16, acc[t], LDC,
                                wmma::mem_row_major);
}

__device__ __forceinline__ void unpack_bf16x4(uint2 raw, float v[4]) {
    float2 fa = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

__device__ __forceinline__ void store_bf16x4(bf16* p, const float v[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void load_f32x4(const float* p, float v[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__global__ void __launch_bounds__(THREADS, 1) premlp_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sW1 = reinterpret_cast<bf16*>(smem);
    bf16* sW2 = sW1 + (size_t)C * LDW1;
    bf16* sU = sW2 + (size_t)HD * LDW2;
    bf16* sH = sU + (size_t)TM * LDU;
    float* sC = reinterpret_cast<float*>(sH + (size_t)TM * LDH);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int rb = warp >> 1;          // 16-row block of the tile
    const int c0 = (warp & 1) * 64;    // first column of this warp's strip
    const int c4 = lane * 4;           // this lane's 4 columns of a row

    // ---- stage the weights once per block ----
    for (int idx = threadIdx.x; idx < C * (HD / 8); idx += THREADS) {
        const int row = idx / (HD / 8), ch = idx % (HD / 8);
        *reinterpret_cast<uint4*>(sW1 + row * LDW1 + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w1 + (size_t)row * HD + ch * 8);
    }
    for (int idx = threadIdx.x; idx < HD * (C / 8); idx += THREADS) {
        const int row = idx / (C / 8), ch = idx % (C / 8);
        *reinterpret_cast<uint4*>(sW2 + row * LDW2 + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w2 + (size_t)row * C + ch * 8);
    }
    float gam[4], bet[4], bias2[4];
    load_f32x4(p.gamma + c4, gam);
    load_f32x4(p.beta + c4, bet);
    load_f32x4(p.b2 + c4, bias2);
    __syncthreads();

    const int n_tiles = (p.M + TM - 1) / TM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * TM;

        // ---- LayerNorm, a row per warp: u = bf16(LN(x)*gamma + beta) ----
        uint2 xr[ROWS_PER_WARP];   // raw x, kept for the residual
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int row = warp + i * (THREADS / 32);
            const int g = r0 + row;
            xr[i] = make_uint2(0u, 0u);
            if (g < p.M)
                xr[i] = *reinterpret_cast<const uint2*>(p.x + (size_t)g * C + c4);
            float v[4];
            unpack_bf16x4(xr[i], v);
            float s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s += v[j];
                ss += v[j] * v[j];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, off);
                ss += __shfl_xor_sync(0xffffffffu, ss, off);
            }
            const float mu = s * (1.0f / C);
            const float var = fmaxf(ss * (1.0f / C) - mu * mu, 0.0f);
            const float rstd = 1.0f / sqrtf(var + kLnEps);
            float u[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                u[j] = (v[j] - mu) * rstd * gam[j] + bet[j];
            store_bf16x4(sU + row * LDU + c4, u);
        }
        __syncthreads();

        // ---- layer 1, in two 128-column halves of the hidden layer ----
        for (int half = 0; half < 2; ++half) {
            warp_gemm<C>(sU, LDU, sW1, LDW1, half * 128, sC, rb, c0);
            __syncthreads();
            for (int idx = threadIdx.x; idx < TM * 32; idx += THREADS) {
                const int row = idx >> 5;
                const int cc = (idx & 31) * 4;
                float bb[4], v[4];
                load_f32x4(p.b1 + half * 128 + cc, bb);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    v[j] = gelu_tanh(sC[row * LDC + cc + j] + bb[j]);
                store_bf16x4(sH + row * LDH + half * 128 + cc, v);
            }
            __syncthreads();
        }

        // ---- layer 2 + residual in float32, one rounding ----
        warp_gemm<HD>(sH, LDH, sW2, LDW2, 0, sC, rb, c0);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
            const int row = warp + i * (THREADS / 32);
            const int g = r0 + row;
            if (g < p.M) {
                float xv[4], y[4];
                unpack_bf16x4(xr[i], xv);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    y[j] = (sC[row * LDC + c4 + j] + bias2[j]) + xv[j];
                store_bf16x4(p.out + (size_t)g * C + c4, y);
            }
        }
        __syncthreads();   // sU / sC are rewritten by the next tile
    }
}

}  // namespace

extern "C" int gfvgn_fused_premlp(const void* x, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int M, int n_sm,
                                  void* stream) {
    if (M < 0 || n_sm < 1) return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    Params p;
    p.x = static_cast<const bf16*>(x);
    p.gamma = static_cast<const float*>(gamma);
    p.beta = static_cast<const float*>(beta);
    p.w1 = static_cast<const bf16*>(w1);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.out = static_cast<bf16*>(out);
    p.M = M;
    cudaError_t err = cudaFuncSetAttribute(
        premlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    const int n_tiles = (M + TM - 1) / TM;
    const int grid = n_tiles < n_sm ? n_tiles : n_sm;
    premlp_kernel<<<grid, THREADS, kSmemBytes,
                    reinterpret_cast<cudaStream_t>(stream)>>>(p);
    return (int)cudaGetLastError();
}
