// K6: the per-node half of physics attention (slice-attention pooling),
// forward, for sm_90a. For every node n of batch lane b and head h:
//
//   fx[n]     = bf16(x[n] * Wfx + bfx)                         [C]
//   xm[n]     = bf16(x[n] * Wx + bx)                           [C]
//   l[n,h,:]  = bf16(xm[n, hD:(h+1)D] * Wsl + bsl)             [G]
//   w[n,h,:]  = softmax_G(l[n,h,:] * inv_temp[h])              float32
//   slice_w[n, hG+g]  = bf16(w[n,h,g])
//   tokens[h,g,:]    += w[n,h,g] * mask[n] * fx[n, hD:(h+1)D]  float32
//   norm[h,g]        += w[n,h,g] * mask[n]                     float32
//
// with C = 128, H = 8 heads, D = 16, G = 32 slices and the [D, G] slice
// kernel shared by the heads.
//
// Replaces the Pallas TPU kernel _make_fwd_kernel of
// gen_fvgn_tpu/ops/fused_slice_attn.py (core _slice_core :117-140, kernel
// :143-167, called at :274). The TPU kernel takes the slice kernel as a
// block-diagonal [C, H*G] embed and pools the FULL cross-head [H*G, C]
// product, whose off-diagonal blocks are thrown away outside; this kernel
// computes only the per-head diagonal blocks [H, G, D] (8x less pooling
// work) and takes the shared [D, G] kernel itself.
//
// What bounds it on the H100: bytes. A node costs 2*(2*128*128 + 8*16*32 +
// 8*32*16) = 82 k FLOP against 256 bytes of x read and 512 bytes of slice
// weights written (plus 4 of mask), ~107 FLOP/byte, under the ~295 FLOP/byte
// bf16 ridge.
//
// Design. The TPU carries the token and norm sums in scratch across a
// sequential grid; on the H100 the row tiles run in parallel, so the rows of
// each batch lane are cut into chunks, one block per (chunk, batch lane), and
// each block writes its partial sums; a second kernel of this file sums the
// partials over chunks in a fixed order, so two runs give the same bits (no
// atomics). Inside a block: Wfx and Wx are staged in shared memory as bf16
// once; per 64-row tile the two projections run on the tensor cores (wmma,
// float32 accumulators staged through shared memory for the bias and the
// bf16 rounding). Then warp h owns head h and lane g owns slice g (G = 32 is
// one warp): the lane computes its logit from the tile's xm (a broadcast
// read) and its column of the slice kernel (registers), the softmax takes the
// EXACT max and the sum over G by warp shuffles (a mean shift overflowed
// exp() at within-head logit spreads > ~88 on the TPU), and the lane carries
// tokens[h, g, 0:D] and norm[h, g] in registers across all rows of its
// chunk. Four rows are processed together so that their shuffle chains
// overlap. Shared memory: 152 KB, one block per SM.
//
// Rounding points (the TPU kernel's): fx, xm and the logits rounded to bf16
// after a float32-accumulated product plus bias; logits*inv_temp, exp and
// the normalisation in float32; slice_w stored bf16; the pooling uses the
// float32 w*mask and float32 fx.
//
// Every other shape the JAX package fuses (C % 128 == 0, H*G % 128 == 0)
// runs on the block row tiles of slice_pool_tiles.cuh, shared with the
// backward K7 (fused_slice_pool_bwd.cu); gfvgn_slice_pool_workspace sizes
// the partials and refuses what no tile takes.
//
// Plain C interface, no allocation (the caller passes a workspace of the
// size gfvgn_slice_pool_workspace gives), launches on the caller's stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"
#include "slice_pool_tiles.cuh"

using namespace nvcuda;

namespace {

constexpr int C = 128;          // stream width
constexpr int H = 8;            // heads
constexpr int D = 16;           // head width
constexpr int G = 32;           // slices (one warp)
constexpr int HG = H * G;
constexpr int PART = H * G * D + H * G;   // floats of one partial: tok, norm
constexpr int TM = 64;          // rows per tile
constexpr int THREADS = 256;    // 8 warps = 8 heads (and 4x2 GEMM strips)
constexpr int ILP = 4;          // rows processed together by a warp
constexpr int LDW = C + 8;      // bf16 leading dim of staged Wfx, Wx
constexpr int LDX = C + 8;      // bf16 leading dim of x, fx, xm tiles
constexpr int LDC = C + 4;      // f32 leading dim of the staging tile

constexpr size_t kSmemBytes =
    2 * (size_t)C * LDW * sizeof(bf16) + 3 * (size_t)TM * LDX * sizeof(bf16) +
    (size_t)TM * LDC * sizeof(float);

struct Params {
    const bf16* x;          // [B, N, C]
    const float* mask;      // [B, N] (mask_bstride N) or [N] (stride 0)
    const bf16* wfx;        // [C, C]
    const float* bfx;       // [C]
    const bf16* wx;         // [C, C]
    const float* bx;        // [C]
    const bf16* wsl;        // [D, G]
    const float* bsl;       // [G]
    const float* inv_temp;  // [H]
    bf16* slice_w;          // [B, N, H*G]
    float* part;            // [B, n_chunks, PART]
    int N;
    int mask_bstride;
    int rows_per_chunk;     // a multiple of TM
    int n_chunks;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// sC[16 rows of block rb, columns c0..c0+63] = A[16 x C] * B[C x (c0 ..)]
__device__ __forceinline__ void warp_gemm(const bf16* sA, const bf16* sB,
                                          float* sC, int rb, int c0) {
    FragC acc[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, sA + rb * 16 * LDX + k0, LDX);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, sB + k0 * LDW + c0 + t * 16, LDW);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
        wmma::store_matrix_sync(sC + rb * 16 * LDC + c0 + t * 16, acc[t], LDC,
                                wmma::mem_row_major);
}

// dst[row][c] = bf16(sC[row][c] + bias[c]) for the whole tile
__device__ __forceinline__ void bias_round(const float* sC,
                                           const float* __restrict__ bias,
                                           bf16* dst) {
    for (int idx = threadIdx.x; idx < TM * 32; idx += THREADS) {
        const int row = idx >> 5;
        const int c4 = (idx & 31) * 4;
        const float4 bb = *reinterpret_cast<const float4*>(bias + c4);
        const float v[4] = {sC[row * LDC + c4] + bb.x,
                            sC[row * LDC + c4 + 1] + bb.y,
                            sC[row * LDC + c4 + 2] + bb.z,
                            sC[row * LDC + c4 + 3] + bb.w};
        store_bf16x4(dst + row * LDX + c4, v);
    }
}

// 8 bf16 at p (16-byte aligned) into v[0..7]
__device__ __forceinline__ void load_bf16x8(const bf16* p, float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__global__ void __launch_bounds__(THREADS, 1) slice_pool_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sWfx = reinterpret_cast<bf16*>(smem);
    bf16* sWx = sWfx + (size_t)C * LDW;
    bf16* sX = sWx + (size_t)C * LDW;
    bf16* sFX = sX + (size_t)TM * LDX;
    bf16* sXM = sFX + (size_t)TM * LDX;
    float* sC = reinterpret_cast<float*>(sXM + (size_t)TM * LDX);

    const int chunk = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x >> 5;      // = head h
    const int lane = threadIdx.x & 31;      // = slice g
    const int h = warp;
    const int rb = warp >> 1;               // GEMM strip of this warp
    const int c0 = (warp & 1) * 64;

    for (int idx = threadIdx.x; idx < C * (C / 8); idx += THREADS) {
        const int row = idx >> 4, ch = idx & 15;
        *reinterpret_cast<uint4*>(sWfx + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.wfx + (size_t)row * C + ch * 8);
        *reinterpret_cast<uint4*>(sWx + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.wx + (size_t)row * C + ch * 8);
    }
    float wcol[D];                          // column g of the slice kernel
#pragma unroll
    for (int d = 0; d < D; ++d) wcol[d] = __bfloat162float(p.wsl[d * G + lane]);
    const float bsl = p.bsl[lane];
    const float it = p.inv_temp[h];
    float tok[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tok[d] = 0.0f;
    float norm = 0.0f;

    const bf16* xb = p.x + (size_t)b * p.N * C;
    const float* mb = p.mask + (size_t)b * p.mask_bstride;
    bf16* wb = p.slice_w + (size_t)b * p.N * HG;
    const int row_begin = chunk * p.rows_per_chunk;
    const int row_end = min(p.N, row_begin + p.rows_per_chunk);
    __syncthreads();

    for (int r0 = row_begin; r0 < row_end; r0 += TM) {
        // ---- x tile (rows past the chunk read as zero) ----
        for (int idx = threadIdx.x; idx < TM * (C / 8); idx += THREADS) {
            const int row = idx >> 4, ch = idx & 15;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + row < row_end)
                v = *reinterpret_cast<const uint4*>(
                    xb + (size_t)(r0 + row) * C + ch * 8);
            *reinterpret_cast<uint4*>(sX + row * LDX + ch * 8) = v;
        }
        __syncthreads();
        // ---- the two projections, each rounded to bf16 after its bias ----
        warp_gemm(sX, sWfx, sC, rb, c0);
        __syncthreads();
        bias_round(sC, p.bfx, sFX);
        __syncthreads();
        warp_gemm(sX, sWx, sC, rb, c0);
        __syncthreads();
        bias_round(sC, p.bx, sXM);
        __syncthreads();

        // ---- per-head softmax over G and pooling: warp h, lane g ----
        const int n_rows = min(TM, row_end - r0);
        for (int rr = 0; rr < n_rows; rr += ILP) {
            float s[ILP], m[ILP];
#pragma unroll
            for (int k = 0; k < ILP; ++k) {
                // rows past n_rows compute on the zero rows of the tile and
                // are dropped below
                float xm[D];
                load_bf16x8(sXM + (rr + k) * LDX + h * D, xm);
                load_bf16x8(sXM + (rr + k) * LDX + h * D + 8, xm + 8);
                float l = 0.0f;
#pragma unroll
                for (int d = 0; d < D; ++d) l = fmaf(xm[d], wcol[d], l);
                l = __bfloat162float(__float2bfloat16(l + bsl));
                s[k] = l * it;
                m[k] = s[k];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
#pragma unroll
                for (int k = 0; k < ILP; ++k)
                    m[k] = fmaxf(m[k], __shfl_xor_sync(0xffffffffu, m[k], off));
            float e[ILP], z[ILP];
#pragma unroll
            for (int k = 0; k < ILP; ++k) {
                e[k] = expf(s[k] - m[k]);
                z[k] = e[k];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
#pragma unroll
                for (int k = 0; k < ILP; ++k)
                    z[k] += __shfl_xor_sync(0xffffffffu, z[k], off);
#pragma unroll
            for (int k = 0; k < ILP; ++k) {
                if (rr + k < n_rows) {
                    const int n = r0 + rr + k;
                    const float w = e[k] / z[k];
                    wb[(size_t)n * HG + h * G + lane] = __float2bfloat16(w);
                    const float wm = w * mb[n];
                    norm += wm;
                    float fx[D];
                    load_bf16x8(sFX + (rr + k) * LDX + h * D, fx);
                    load_bf16x8(sFX + (rr + k) * LDX + h * D + 8, fx + 8);
#pragma unroll
                    for (int d = 0; d < D; ++d) tok[d] += wm * fx[d];
                }
            }
        }
        __syncthreads();   // sX, sFX, sXM are rewritten by the next tile
    }

    // ---- this block's partial sums: tok [H][G][D] then norm [H][G] ----
    float* dst = p.part + ((size_t)b * p.n_chunks + chunk) * PART;
#pragma unroll
    for (int d = 0; d < D; d += 4)
        *reinterpret_cast<float4*>(dst + (h * G + lane) * D + d) =
            make_float4(tok[d], tok[d + 1], tok[d + 2], tok[d + 3]);
    dst[H * G * D + h * G + lane] = norm;
}


// out0[b] | out1[b] = sum over chunks, in chunk order, of the partials
// [B, n_chunks, len], split after `split` elements
__global__ void chunk_reduce(const float* __restrict__ part,
                             float* __restrict__ out0,
                             float* __restrict__ out1, int len, int split,
                             int n_chunks) {
    const int b = blockIdx.y;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= len) return;
    const float* src = part + (size_t)b * n_chunks * len + e;
    float s = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) s += src[(size_t)ch * len];
    if (e < split) out0[(size_t)b * split + e] = s;
    else out1[(size_t)b * (len - split) + (e - split)] = s;
}

}  // namespace

// Bytes of workspace K6 (backward = 0) or K7 needs for x [B, N, C] with H
// heads and G slices; -1 where no kernel takes the shape (the slot rules of
// pool_shape, or no tile that fits a block's shared memory).
extern "C" long long gfvgn_slice_pool_workspace(int c, int h, int g, int B,
                                                int N, int backward) {
    PoolRun P;
    if (pool_run(c, h, g, B, N, backward != 0, P) != 0) return -1;
    return (long long)P.bytes;
}

extern "C" int gfvgn_fused_slice_pool(const void* x, const void* mask,
                                      int mask_bstride, const void* wfx,
                                      const void* bfx, const void* wx,
                                      const void* bx, const void* wsl,
                                      const void* bsl, const void* inv_temp,
                                      void* slice_w, void* tokens, void* norm,
                                      int c, int h, int g, int B, int N,
                                      void* workspace, void* stream) {
    PoolRun P;
    int err = pool_run(c, h, g, B, N, false, P);
    if (err != 0) return err;
    if (mask_bstride != 0 && mask_bstride != N)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    float* part = reinterpret_cast<float*>(ws + P.o_part);
    if (default_shape(c, h, g)) {
        Params p;
        p.x = static_cast<const bf16*>(x);
        p.mask = static_cast<const float*>(mask);
        p.wfx = static_cast<const bf16*>(wfx);
        p.bfx = static_cast<const float*>(bfx);
        p.wx = static_cast<const bf16*>(wx);
        p.bx = static_cast<const float*>(bx);
        p.wsl = static_cast<const bf16*>(wsl);
        p.bsl = static_cast<const float*>(bsl);
        p.inv_temp = static_cast<const float*>(inv_temp);
        p.slice_w = static_cast<bf16*>(slice_w);
        p.part = part;
        p.N = N;
        p.mask_bstride = mask_bstride;
        p.rows_per_chunk = P.rows_per_chunk;
        p.n_chunks = P.n_chunks;
        cudaError_t e = cudaFuncSetAttribute(
            slice_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSmemBytes);
        if (e != cudaSuccess) return (int)e;
        slice_pool_kernel<<<dim3(P.n_chunks, B), THREADS, kSmemBytes, st>>>(p);
        err = (int)cudaGetLastError();
    } else {
        PoolParams p{};
        fill_pool(p, P, x, mask, mask_bstride, wfx, bfx, wx, bx, wsl, bsl,
                  inv_temp, N, ws);
        p.slice_w = static_cast<bf16*>(slice_w);
        err = launch_pool<false>(P, p, B, st);
    }
    if (err != 0) return err;
    const int hgd = P.s.hg * P.s.d;
    chunk_reduce<<<dim3((P.part_len + 255) / 256, B), 256, 0, st>>>(
        part, static_cast<float*>(tokens), static_cast<float*>(norm),
        P.part_len, hgd, P.n_chunks);
    return (int)cudaGetLastError();
}

