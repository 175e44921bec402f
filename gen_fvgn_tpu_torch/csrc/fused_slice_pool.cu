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
// Plain C interface, no allocation (the caller passes the partial-sum
// buffer), launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "lane_reduce.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ void store_bf16x4(bf16* p, const float v[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
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

// tokens[b] / norm[b] = sum over chunks, in chunk order, of the partials
__global__ void slice_pool_reduce(const float* __restrict__ part,
                                  float* __restrict__ tokens,
                                  float* __restrict__ norm, int n_chunks) {
    const int b = blockIdx.y;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= PART) return;
    const float* src = part + (size_t)b * n_chunks * PART + e;
    float s = 0.0f;
    for (int c = 0; c < n_chunks; ++c) s += src[(size_t)c * PART];
    if (e < H * G * D)
        tokens[(size_t)b * H * G * D + e] = s;
    else
        norm[(size_t)b * HG + (e - H * G * D)] = s;
}

// ===================== K7: the backward, for sm_90a =====================
//
// Replaces the Pallas TPU kernel _make_bwd_kernel of
// gen_fvgn_tpu/ops/fused_slice_attn.py (:170-236, called at :297). Inputs:
// the forward's operands and the cotangents dslice_w [B, N, H*G] (bf16),
// dtokens [B, H, G, D] (the per-head diagonal blocks; the TPU kernel's
// off-diagonal blocks are zero) and dnorm [B, H, G]. For every node n and
// head h, slice g (warp h, lane g):
//
//   fx, xm, l recomputed as in the forward; w = softmax_G(l*inv_temp) in
//   float32 from x (the stored bf16 slice_w is never read); wm = w*mask[n]
//   dw_m   = sum_d fx[n,h,d]*dtok[h,g,d] + dnorm[h,g]
//   dw_all = dslice_w[n,h,g] + dw_m*mask[n]
//   ds     = w*(dw_all - sum_g w*dw_all)
//   dinv_temp[h] += ds*l;  dl = ds*inv_temp;  dbsl[g] += dl;  dl16 = bf16(dl)
//   dfx[n,h,d] = sum_g wm*dtok[h,g,d]            (float32)
//   dxm[n,h,:] = dl16[n,h,:] Wsl^T               (tensor cores)
//   dWsl_h += xm_h^T dl16_h;  dbfx += dfx;  dbx += dxm
//   dWfx += x^T bf16(dfx);  dWx += x^T bf16(dxm)
//   dx = bf16(bf16(dfx) Wfx^T + bf16(dxm) Wx^T)
//
// What bounds it on the H100: bytes (x and dslice_w in, dx out: 768 bytes a
// node against ~5 products of 128x128 a node). Design: as K6, one block per
// (chunk of rows, batch lane), here with 32-row tiles so that the tile's
// float32 w*mask [32 x 256] fits the shared memory beside the other tiles;
// the per-(row, head) softmax is K6's warp-and-lane loop; the products run
// on the tensor cores except the two float32 contractions with dtokens
// (dw_m and dfx, float32 as in the TPU kernel). dWsl (a [16 x 32] block a
// head: two fragments a warp) is carried in registers over the chunk; dWfx
// and dWx are accumulated in the block's float32 slab in device memory. A
// second kernel sums the blocks' slabs in order, rounding the weight
// gradients to bf16 per batch lane (the JAX package rounds per vmap lane),
// so two runs give the same bits.

constexpr int TB = 32;                    // rows per backward tile
constexpr int LDDL = HG + 8;              // bf16 leading dim of the dl tile
constexpr int LDWM = HG + 4;              // f32 leading dim of the w*mask tile
constexpr int BWD_PART = 2 * C * C + H * D * G + 2 * HG + 2 * C;
constexpr int BWD_NW = 2 * C * C + H * D * G;   // weight elements of a slab

constexpr size_t kBwdSmemBytes =
    3 * (size_t)TB * LDX * sizeof(bf16) + (size_t)TB * LDDL * sizeof(bf16) +
    (size_t)TB * LDWM * sizeof(float) + (size_t)TB * LDC * sizeof(float) +
    (size_t)H * G * D * sizeof(float);

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

struct BwdParams {
    const bf16* x;
    const float* mask;
    const bf16* wfx;
    const float* bfx;
    const bf16* wx;
    const float* bx;
    const bf16* wsl;
    const float* bsl;
    const float* inv_temp;
    const bf16* dslice_w;     // [B, N, H*G]
    const float* dtok;        // [B, H, G, D]
    const float* dnorm;       // [B, H, G]
    bf16* dx;                 // [B, N, C]
    float* part;              // [B * n_chunks, BWD_PART]
    int N;
    int mask_bstride;
    int rows_per_chunk;       // a multiple of TB
};

// acc[t] = A[16 rows of block rb, C] * B[C, c0 + 16t ..], B row-major [C][C]
// in device memory
__device__ __forceinline__ void proj2(const bf16* A, const bf16* B, FragC* acc,
                                      int rb, int c0) {
#pragma unroll
    for (int t = 0; t < 2; ++t) wmma::fill_fragment(acc[t], 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, A + rb * 16 * LDX + k0, LDX);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, B + k0 * C + c0 + t * 16, C);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
}

// acc[t] += A[16 rows rb, C] * W^T[C, c0 + 16t ..], W row-major [C][C]
__device__ __forceinline__ void proj2_bt(const bf16* A, const bf16* W,
                                         FragC* acc, int rb, int c0) {
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, A + rb * 16 * LDX + k0, LDX);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
            FragBc b;
            wmma::load_matrix_sync(b, W + (c0 + t * 16) * C + k0, C);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
}

// W[m0.., 16t ..] += A^T B over the tile's TB rows (A, B [TB, C] row-major
// in shared memory; W a [C][C] float32 slab region of this block)
__device__ __forceinline__ void wgrad_cc(const bf16* A, const bf16* B,
                                         float* W, int m0) {
    FragC acc[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
        wmma::load_matrix_sync(acc[t], W + m0 * C + t * 16, C,
                               wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < TB; k0 += 16) {
        FragAc a;
        wmma::load_matrix_sync(a, A + k0 * LDX + m0, LDX);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, B + k0 * LDX + t * 16, LDX);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
        wmma::store_matrix_sync(W + m0 * C + t * 16, acc[t], C,
                                wmma::mem_row_major);
}

// dst[row][c] = bf16(sC[row][c] + bias[c]) over the TB-row tile
__device__ __forceinline__ void bias_round_tb(const float* sC,
                                              const float* __restrict__ bias,
                                              bf16* dst) {
    for (int idx = threadIdx.x; idx < TB * 32; idx += THREADS) {
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

__global__ void __launch_bounds__(THREADS, 1)
slice_pool_bwd_kernel(BwdParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sX = reinterpret_cast<bf16*>(smem);
    bf16* sFX = sX + (size_t)TB * LDX;
    bf16* sXM = sFX + (size_t)TB * LDX;
    bf16* sDL = sXM + (size_t)TB * LDX;
    float* sWM = reinterpret_cast<float*>(sDL + (size_t)TB * LDDL);
    float* sC = sWM + (size_t)TB * LDWM;
    float* sTok = sC + (size_t)TB * LDC;

    const int chunk = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int h = warp, g = lane;
    const int prb = warp >> 2;              // projection strip: 2 row blocks
    const int pc0 = (warp & 3) * 32;        //   x 4 column quarters

    float* slab = p.part + ((size_t)b * gridDim.x + chunk) * BWD_PART;
    float* s_wfx = slab;
    float* s_wx = slab + C * C;
    for (int i = threadIdx.x; i < 2 * C * C; i += THREADS) slab[i] = 0.0f;
    const float* dtok_b = p.dtok + (size_t)b * HG * D;
    for (int i = threadIdx.x; i < HG * D; i += THREADS) sTok[i] = dtok_b[i];
    float wcol[D], dtk[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        wcol[d] = __bfloat162float(p.wsl[d * G + g]);
        dtk[d] = dtok_b[(h * G + g) * D + d];
    }
    const float dnrm = p.dnorm[(size_t)b * HG + h * G + g];
    const float bsl = p.bsl[g];
    const float it = p.inv_temp[h];
    float dit_acc = 0.0f, dbsl_acc = 0.0f, db_acc = 0.0f;
    FragC wsl_acc[2];
    wmma::fill_fragment(wsl_acc[0], 0.0f);
    wmma::fill_fragment(wsl_acc[1], 0.0f);

    const bf16* xb = p.x + (size_t)b * p.N * C;
    const float* mb = p.mask + (size_t)b * p.mask_bstride;
    const bf16* dswb = p.dslice_w + (size_t)b * p.N * HG;
    bf16* dxb = p.dx + (size_t)b * p.N * C;
    const int row_begin = chunk * p.rows_per_chunk;
    const int row_end = min(p.N, row_begin + p.rows_per_chunk);
    __syncthreads();

    for (int r0 = row_begin; r0 < row_end; r0 += TB) {
        const int nrow = min(TB, row_end - r0);
        for (int idx = threadIdx.x; idx < TB * (C / 8); idx += THREADS) {
            const int row = idx >> 4, ch = idx & 15;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (row < nrow)
                v = *reinterpret_cast<const uint4*>(
                    xb + (size_t)(r0 + row) * C + ch * 8);
            *reinterpret_cast<uint4*>(sX + row * LDX + ch * 8) = v;
        }
        __syncthreads();
        // ---- the two projections (as K6), each rounded after its bias ----
        FragC acc[2];
        proj2(sX, p.wfx, acc, prb, pc0);
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(sC + prb * 16 * LDC + pc0 + t * 16, acc[t],
                                    LDC, wmma::mem_row_major);
        __syncthreads();
        bias_round_tb(sC, p.bfx, sFX);
        __syncthreads();
        proj2(sX, p.wx, acc, prb, pc0);
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(sC + prb * 16 * LDC + pc0 + t * 16, acc[t],
                                    LDC, wmma::mem_row_major);
        __syncthreads();
        bias_round_tb(sC, p.bx, sXM);
        __syncthreads();

        // ---- softmax and its backward: warp h, lane g, a row at a time ----
        for (int row = 0; row < TB; ++row) {
            const bool valid = row < nrow;
            const int n = r0 + row;
            float xm[D], fx[D];
            load_bf16x8(sXM + row * LDX + h * D, xm);
            load_bf16x8(sXM + row * LDX + h * D + 8, xm + 8);
            float l = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) l = fmaf(xm[d], wcol[d], l);
            l = __bfloat162float(__float2bfloat16(l + bsl));
            const float sv = l * it;
            float m = sv;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            const float e = expf(sv - m);
            float z = e;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                z += __shfl_xor_sync(0xffffffffu, z, off);
            const float w = e / z;
            const float mk = valid ? mb[n] : 0.0f;
            sWM[row * LDWM + h * G + g] = w * mk;
            load_bf16x8(sFX + row * LDX + h * D, fx);
            load_bf16x8(sFX + row * LDX + h * D + 8, fx + 8);
            float dwm = 0.0f;
#pragma unroll
            for (int d = 0; d < D; ++d) dwm += fx[d] * dtk[d];
            dwm += dnrm;
            const float dsw = valid
                ? __bfloat162float(dswb[(size_t)n * HG + h * G + g]) : 0.0f;
            const float dwa = dsw + dwm * mk;
            float inner = w * dwa;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                inner += __shfl_xor_sync(0xffffffffu, inner, off);
            const float ds = w * (dwa - inner);
            dit_acc += ds * l;
            const float dl = ds * it;
            dbsl_acc += dl;
            sDL[row * LDDL + h * G + g] = __float2bfloat16(dl);
        }
        __syncthreads();

        // ---- dWsl_h += xm_h^T dl16_h (registers, over the chunk) ----
#pragma unroll
        for (int k0 = 0; k0 < TB; k0 += 16) {
            FragAc a;
            wmma::load_matrix_sync(a, sXM + k0 * LDX + h * D, LDX);
#pragma unroll
            for (int gh = 0; gh < 2; ++gh) {
                FragB bb;
                wmma::load_matrix_sync(bb, sDL + k0 * LDDL + h * G + gh * 16,
                                       LDDL);
                wmma::mma_sync(wsl_acc[gh], a, bb, wsl_acc[gh]);
            }
        }
        // ---- dfx = w*mask . dtokens (float32) ----
        for (int idx = threadIdx.x; idx < TB * C; idx += THREADS) {
            const int row = idx >> 7, c = idx & 127;
            const int hh = c >> 4, d = c & 15;
            float a = 0.0f;
#pragma unroll 8
            for (int gg = 0; gg < G; ++gg)
                a += sWM[row * LDWM + hh * G + gg] * sTok[(hh * G + gg) * D + d];
            sC[row * LDC + c] = a;
        }
        __syncthreads();
        if (threadIdx.x < C) {
            for (int row = 0; row < TB; ++row)
                db_acc += sC[row * LDC + threadIdx.x];
        }
        for (int idx = threadIdx.x; idx < TB * 32; idx += THREADS) {
            const int row = idx >> 5, c4 = (idx & 31) * 4;
            const float v[4] = {sC[row * LDC + c4], sC[row * LDC + c4 + 1],
                                sC[row * LDC + c4 + 2], sC[row * LDC + c4 + 3]};
            store_bf16x4(sFX + row * LDX + c4, v);     // dfx16
        }
        __syncthreads();
        // ---- dxm = dl16 Wsl^T per head (tensor cores); warp h ----
#pragma unroll
        for (int rbb = 0; rbb < TB / 16; ++rbb) {
            FragC a1;
            wmma::fill_fragment(a1, 0.0f);
#pragma unroll
            for (int k0 = 0; k0 < G; k0 += 16) {
                FragA a;
                wmma::load_matrix_sync(a, sDL + rbb * 16 * LDDL + h * G + k0,
                                       LDDL);
                FragBc bb;      // B(k = g, n = d) = wsl[d][g]
                wmma::load_matrix_sync(bb, p.wsl + k0, G);
                wmma::mma_sync(a1, a, bb, a1);
            }
            wmma::store_matrix_sync(sC + rbb * 16 * LDC + h * D, a1, LDC,
                                    wmma::mem_row_major);
        }
        __syncthreads();
        if (threadIdx.x >= C) {
            for (int row = 0; row < TB; ++row)
                db_acc += sC[row * LDC + threadIdx.x - C];
        }
        for (int idx = threadIdx.x; idx < TB * 32; idx += THREADS) {
            const int row = idx >> 5, c4 = (idx & 31) * 4;
            const float v[4] = {sC[row * LDC + c4], sC[row * LDC + c4 + 1],
                                sC[row * LDC + c4 + 2], sC[row * LDC + c4 + 3]};
            store_bf16x4(sXM + row * LDX + c4, v);     // dxm16
        }
        __syncthreads();
        // ---- dWfx += x^T dfx16, dWx += x^T dxm16 (the block's slab) ----
        wgrad_cc(sX, sFX, s_wfx, warp * 16);
        wgrad_cc(sX, sXM, s_wx, warp * 16);
        // ---- dx = dfx16 Wfx^T + dxm16 Wx^T ----
        wmma::fill_fragment(acc[0], 0.0f);
        wmma::fill_fragment(acc[1], 0.0f);
        proj2_bt(sFX, p.wfx, acc, prb, pc0);
        proj2_bt(sXM, p.wx, acc, prb, pc0);
#pragma unroll
        for (int t = 0; t < 2; ++t)
            wmma::store_matrix_sync(sC + prb * 16 * LDC + pc0 + t * 16, acc[t],
                                    LDC, wmma::mem_row_major);
        __syncthreads();
        for (int idx = threadIdx.x; idx < nrow * 32; idx += THREADS) {
            const int row = idx >> 5, c4 = (idx & 31) * 4;
            const float v[4] = {sC[row * LDC + c4], sC[row * LDC + c4 + 1],
                                sC[row * LDC + c4 + 2], sC[row * LDC + c4 + 3]};
            store_bf16x4(dxb + (size_t)(r0 + row) * C + c4, v);
        }
        __syncthreads();   // every tile buffer is rewritten by the next tile
    }

    // ---- the block's remaining partials ----
    float* s_wsl = slab + 2 * C * C;
    float* s_bsl = s_wsl + H * D * G;
    float* s_it = s_bsl + HG;
    float* s_bfx = s_it + HG;
    float* s_bx = s_bfx + C;
#pragma unroll
    for (int gh = 0; gh < 2; ++gh)
        wmma::store_matrix_sync(s_wsl + h * D * G + gh * 16, wsl_acc[gh], G,
                                wmma::mem_row_major);
    s_bsl[h * G + g] = dbsl_acc;
    s_it[h * G + g] = dit_acc;
    if (threadIdx.x < C) s_bfx[threadIdx.x] = db_acc;
    else s_bx[threadIdx.x - C] = db_acc;
}

}  // namespace

extern "C" int gfvgn_fused_slice_pool_bwd(
        const void* x, const void* mask, int mask_bstride, const void* wfx,
        const void* bfx, const void* wx, const void* bx, const void* wsl,
        const void* bsl, const void* inv_temp, const void* dslice_w,
        const void* dtokens, const void* dnorm, void* dx, void* part,
        void* total, int B, int N, int rows_per_chunk, int n_chunks,
        void* stream) {
    if (B < 1 || B > 65535 || N < 1 || rows_per_chunk < TB ||
        rows_per_chunk % TB != 0 || n_chunks < 1 ||
        (long long)rows_per_chunk * n_chunks < N ||
        (long long)rows_per_chunk * (n_chunks - 1) >= N ||
        (mask_bstride != 0 && mask_bstride != N))
        return (int)cudaErrorInvalidValue;
    BwdParams p;
    p.x = static_cast<const bf16*>(x);
    p.mask = static_cast<const float*>(mask);
    p.wfx = static_cast<const bf16*>(wfx);
    p.bfx = static_cast<const float*>(bfx);
    p.wx = static_cast<const bf16*>(wx);
    p.bx = static_cast<const float*>(bx);
    p.wsl = static_cast<const bf16*>(wsl);
    p.bsl = static_cast<const float*>(bsl);
    p.inv_temp = static_cast<const float*>(inv_temp);
    p.dslice_w = static_cast<const bf16*>(dslice_w);
    p.dtok = static_cast<const float*>(dtokens);
    p.dnorm = static_cast<const float*>(dnorm);
    p.dx = static_cast<bf16*>(dx);
    p.part = static_cast<float*>(part);
    p.N = N;
    p.mask_bstride = mask_bstride;
    p.rows_per_chunk = rows_per_chunk;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        slice_pool_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kBwdSmemBytes);
    if (err != cudaSuccess) return (int)err;
    slice_pool_bwd_kernel<<<dim3(n_chunks, B), THREADS, kBwdSmemBytes, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lane_reduce<<<(BWD_PART + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(total),
        BWD_PART, BWD_NW, B, n_chunks);
    return (int)cudaGetLastError();
}

extern "C" int gfvgn_fused_slice_pool(const void* x, const void* mask,
                                      int mask_bstride, const void* wfx,
                                      const void* bfx, const void* wx,
                                      const void* bx, const void* wsl,
                                      const void* bsl, const void* inv_temp,
                                      void* slice_w, void* part, void* tokens,
                                      void* norm, int B, int N,
                                      int rows_per_chunk, int n_chunks,
                                      void* stream) {
    if (B < 1 || B > 65535 || N < 1 || rows_per_chunk < TM ||
        rows_per_chunk % TM != 0 || n_chunks < 1 ||
        (long long)rows_per_chunk * n_chunks < N ||
        (long long)rows_per_chunk * (n_chunks - 1) >= N ||
        (mask_bstride != 0 && mask_bstride != N))
        return (int)cudaErrorInvalidValue;
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
    p.part = static_cast<float*>(part);
    p.N = N;
    p.mask_bstride = mask_bstride;
    p.rows_per_chunk = rows_per_chunk;
    p.n_chunks = n_chunks;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(
        slice_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    slice_pool_kernel<<<dim3(n_chunks, B), THREADS, kSmemBytes, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int red_threads = 256;
    slice_pool_reduce<<<dim3((PART + red_threads - 1) / red_threads, B),
                        red_threads, 0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(tokens),
        static_cast<float*>(norm), n_chunks);
    return (int)cudaGetLastError();
}
