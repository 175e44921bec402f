// K2 / K4f: fused 2-hidden-layer GELU MLP chain, forward, for sm_90a.
//
//   LN = true  (K2, fused_mlp_ln):
//     out = LN(W3*gelu(W2*gelu(sum_i x_i*W1_i + pre + b1) + b2) + b3)*gamma + beta
//     with an optional residual epilogue (res_idx, res_dual)
//   LN = false (K4f, fused_mlp_noln):
//     out = W3*gelu(W2*gelu(x*W1 + b1) + b2) + b3, d_out <= 16 real columns
//
// Replaces the Pallas TPU kernels _make_fwd_kernel and _noln_fwd_kernel of
// gen_fvgn_tpu/ops/fused_mlp.py. Rows are independent. A block stages W1 (up
// to 256x128), W2 and W3 in shared memory as bf16 once and then walks over
// 64-row tiles (grid = min(tiles, SMs)). Each product runs on the tensor
// cores through wmma (bf16 operands, float32 accumulators); accumulators are
// staged through shared memory for the elementwise steps, so h1, h2 and y
// never reach device memory. The ragged last tile is masked, not padded.
//
// Rounding points (the same as the TPU kernel's): float32 accumulation in
// each product; h1, h2 rounded to bf16 before the next product; biases, pre,
// GELU (tanh form) and LayerNorm statistics (fast variance clamped at 0,
// eps 1e-6) in float32; out rounded to bf16 before the residual add, which
// is a bf16 add.
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "lane_reduce.cuh"

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int H = 128;        // hidden width = part width = LayerNorm width
constexpr int TM = 64;        // rows per tile
constexpr int THREADS = 256;  // 8 warps: 4 row blocks x 2 column halves
constexpr int LDW = H + 8;    // bf16 leading dim of the staged weights
constexpr int LDH = H + 8;    // bf16 leading dim of the h1/h2 buffer
constexpr int LDC = H + 4;    // f32 leading dim of the accumulator staging
constexpr float kLnEps = 1e-6f;

struct Params {
    const bf16* part[2];
    int width[2];       // part widths, multiples of 16, each <= H
    int n_parts;
    const bf16* w1;     // [width[0]+width[1], H]
    const bf16* pre;    // [M, H] or null
    const float* b1;
    const bf16* w2;     // [H, H]
    const float* b2;
    const bf16* w3;     // [H, d_out]
    const float* b3;
    const float* gamma;
    const float* beta;
    bf16* out0;
    bf16* out1;
    int M;
    int res_idx;        // -1: no residual
    int res_dual;
    int d_out;
};

__device__ __forceinline__ float gelu_tanh(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(u));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// C[16 x NT*16] (this warp's strip) = A[16 x K] * B[K x NT*16]; result to sC.
template <int NT>
__device__ __forceinline__ void warp_gemm(const bf16* sA, int lda,
                                          const bf16* sB, int K,
                                          float* sC, int rb, int c0) {
    FragC acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, sA + rb * 16 * lda + k0, lda);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, sB + k0 * LDW + c0 + t * 16, LDW);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
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

__device__ __forceinline__ void load_bf16x4(const bf16* p, float v[4]) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 fa = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

// h = gelu(acc + bias (+ pre)) rounded to bf16 into sH. `acc` may be absent
// (the pres-only form has no first product).
__device__ __forceinline__ void hidden_epilogue(const float* sC, bool has_acc,
                                                const float* bias,
                                                const bf16* pre, int r0, int M,
                                                bf16* sH) {
    for (int idx = threadIdx.x; idx < TM * 32; idx += THREADS) {
        const int row = idx >> 5;
        const int c4 = (idx & 31) * 4;
        const int g = r0 + row;
        float v[4];
        const float4 bb = *reinterpret_cast<const float4*>(bias + c4);
        v[0] = bb.x; v[1] = bb.y; v[2] = bb.z; v[3] = bb.w;
        if (pre != nullptr && g < M) {
            float pv[4];
            load_bf16x4(pre + (size_t)g * H + c4, pv);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += pv[i];
        }
        if (has_acc) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += sC[row * LDC + c4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = gelu_tanh(v[i]);
        store_bf16x4(sH + row * LDH + c4, v);
    }
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int K1 = p.width[0] + p.width[1];
    const int LDX = K1 + 8;
    bf16* sW1 = reinterpret_cast<bf16*>(smem);
    bf16* sW2 = sW1 + (size_t)K1 * LDW;
    bf16* sW3 = sW2 + (size_t)H * LDW;
    bf16* sX = sW3 + (size_t)H * LDW;
    bf16* sH = sX + (size_t)(K1 > 0 ? TM * LDX : 0);
    float* sC = reinterpret_cast<float*>(sH + (size_t)TM * LDH);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int rb = warp >> 1;          // 16-row block of the tile
    const int c0 = (warp & 1) * 64;    // first column of this warp's strip

    // ---- stage the weights once per block ----
    for (int idx = threadIdx.x; idx < K1 * 16; idx += THREADS) {
        const int row = idx >> 4, ch = idx & 15;
        *reinterpret_cast<uint4*>(sW1 + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w1 + (size_t)row * H + ch * 8);
    }
    for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
        const int row = idx >> 4, ch = idx & 15;
        *reinterpret_cast<uint4*>(sW2 + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w2 + (size_t)row * H + ch * 8);
    }
    if (LN) {
        for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
            const int row = idx >> 4, ch = idx & 15;
            *reinterpret_cast<uint4*>(sW3 + row * LDW + ch * 8) =
                *reinterpret_cast<const uint4*>(p.w3 + (size_t)row * H + ch * 8);
        }
    } else {
        // narrow head: d_out real columns, zero up to one 16-column tile
        for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
            const int row = idx >> 4, c = idx & 15;
            sW3[row * LDW + c] = c < p.d_out
                ? p.w3[(size_t)row * p.d_out + c] : __float2bfloat16(0.0f);
        }
    }
    __syncthreads();

    const int n_tiles = (p.M + TM - 1) / TM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * TM;

        // ---- input parts -> sX (rows past M read as zero) ----
        for (int pi = 0; pi < p.n_parts; ++pi) {
            const bf16* src = p.part[pi];
            const int w = p.width[pi];
            const int cpr = w >> 3;                  // 16-byte chunks a row
            const int off = pi == 0 ? 0 : p.width[0];
            for (int idx = threadIdx.x; idx < TM * cpr; idx += THREADS) {
                const int row = idx / cpr, ch = idx % cpr;
                const int g = r0 + row;
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (g < p.M)
                    v = *reinterpret_cast<const uint4*>(
                        src + (size_t)g * w + ch * 8);
                *reinterpret_cast<uint4*>(sX + row * LDX + off + ch * 8) = v;
            }
        }
        __syncthreads();

        // ---- layer 1 ----
        if (K1 > 0) {
            warp_gemm<4>(sX, LDX, sW1, K1, sC, rb, c0);
            __syncthreads();
        }
        hidden_epilogue(sC, K1 > 0, p.b1, p.pre, r0, p.M, sH);
        __syncthreads();

        // ---- layer 2 ----
        warp_gemm<4>(sH, LDH, sW2, H, sC, rb, c0);
        __syncthreads();
        hidden_epilogue(sC, true, p.b2, nullptr, r0, p.M, sH);
        __syncthreads();

        // ---- layer 3 + epilogue ----
        if (LN) {
            warp_gemm<4>(sH, LDH, sW3, H, sC, rb, c0);
            __syncthreads();
            const int c4 = lane * 4;
            const float4 b3 = *reinterpret_cast<const float4*>(p.b3 + c4);
            const float4 ga = *reinterpret_cast<const float4*>(p.gamma + c4);
            const float4 be = *reinterpret_cast<const float4*>(p.beta + c4);
            const float b3v[4] = {b3.x, b3.y, b3.z, b3.w};
            const float gav[4] = {ga.x, ga.y, ga.z, ga.w};
            const float bev[4] = {be.x, be.y, be.z, be.w};
            for (int row = warp; row < TM; row += THREADS / 32) {
                const int g = r0 + row;
                float y[4];
                float s = 0.0f, ss = 0.0f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    y[i] = sC[row * LDC + c4 + i] + b3v[i];
                    s += y[i];
                    ss += y[i] * y[i];
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                    ss += __shfl_xor_sync(0xffffffffu, ss, off);
                }
                const float mu = s * (1.0f / H);
                const float var = fmaxf(ss * (1.0f / H) - mu * mu, 0.0f);
                const float rstd = 1.0f / sqrtf(var + kLnEps);
                float o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    o[i] = (y[i] - mu) * rstd * gav[i] + bev[i];
                    // round to bf16 BEFORE the residual add
                    o[i] = __bfloat162float(__float2bfloat16(o[i]));
                }
                if (g < p.M) {
                    if (p.res_idx < 0) {
                        store_bf16x4(p.out0 + (size_t)g * H + c4, o);
                    } else {
                        float r[4], sum[4];
                        const int roff = p.res_idx == 0 ? 0 : p.width[0];
                        load_bf16x4(sX + row * LDX + roff + c4, r);
#pragma unroll
                        for (int i = 0; i < 4; ++i) sum[i] = o[i] + r[i];
                        if (p.res_dual) {
                            store_bf16x4(p.out0 + (size_t)g * H + c4, o);
                            store_bf16x4(p.out1 + (size_t)g * H + c4, sum);
                        } else {
                            store_bf16x4(p.out0 + (size_t)g * H + c4, sum);
                        }
                    }
                }
            }
        } else {
            if ((warp & 1) == 0) warp_gemm<1>(sH, LDH, sW3, H, sC, rb, 0);
            __syncthreads();
            for (int idx = threadIdx.x; idx < TM * p.d_out; idx += THREADS) {
                const int row = idx / p.d_out, c = idx % p.d_out;
                const int g = r0 + row;
                if (g < p.M)
                    p.out0[(size_t)g * p.d_out + c] =
                        __float2bfloat16(sC[row * LDC + c] + p.b3[c]);
            }
        }
        __syncthreads();   // sX / sC are rewritten by the next tile
    }
}

// ===================== K3 / K4b: the backward, for sm_90a =====================
//
// Replaces the Pallas TPU kernels _make_bwd_kernel (K3, :129-228, called at
// :421) and _noln_bwd_kernel (K4b, :924-952, called at :980) of
// gen_fvgn_tpu/ops/fused_mlp.py. Per 64-row tile the forward is recomputed
// from the saved inputs (remat), then
//
//   LN:   g = dout0 (+ dout1 with res_dual); dgamma += g*xhat; dbeta += g;
//         dy = rstd*(g*gamma - mean(g*gamma) - xhat*mean(g*gamma*xhat))
//   noLN: dy = dout (the d_out <= 16 real columns)
//   dW3 += h2^T dy16;        db3 += dy;        dh2pre = (dy16 W3^T) gelu'(h2pre)
//   dW2 += h1^T dh2pre16;    db2 += dh2pre;    dh1pre = (dh2pre16 W2^T) gelu'(h1pre)
//   dW1_i += x_i^T dh1pre16; db1 += dh1pre;    dpre = bf16(dh1pre)
//   dx_i = bf16(dh1pre16 W1_i^T (+ the residual part's cotangent))
//
// with the TPU kernel's rounding points: dy, dh2pre, dh1pre rounded to bf16
// before the products that take them; LayerNorm statistics and backward,
// GELU and its derivative in float32. h1pre and h2pre are recomputed a
// second time where their derivative is needed instead of being kept (one
// float32 staging tile fits the shared memory); the recomputation is the
// same code on the same inputs, so the same bits.
//
// What bounds it on the H100: bytes for the row streams (x parts, pre, the
// cotangents in; dx, dpre out) at about 7 products of [64 x 128 x 128] a
// tile, under the bf16 ridge. This first form reads W1, W2, W3 through the
// L1/L2 caches with wmma loads (the shared memory holds the tile's
// activations), and its weight gradients are the slow part: each block owns
// a float32 slab of partial sums in device memory (L2-resident) and every
// tile adds its [K1+256, 128] contribution by wmma load/mma/store.
//
// Determinism and the per-lane rounding. The rows are `lanes` batch lanes of
// M / lanes rows (one graph of the batch each); grid = (blocks_per_lane,
// lanes), a block walks over tiles of its own lane only and owns one slab.
// A second kernel sums each lane's slabs in block order, rounds the weight
// gradients to bf16 per lane (the JAX package's kernels run under a
// per-sample vmap and round per lane), and sums the lanes in lane order. No
// atomics: two runs give the same bits.

constexpr int BT = 256;            // 8 warps
constexpr int LDT = H + 8;         // bf16 leading dim of the 128-wide tiles
constexpr int LDW3N = 24;          // staged, zero-padded noLN W3 [H][LDW3N]

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAc;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

struct BwdParams {
    const bf16* part[2];
    int width[2];
    int n_parts;
    const bf16* w1;      // [K1, H] (device memory)
    const bf16* pre;     // [M, H] or null
    const float* b1;
    const bf16* w2;      // [H, H]
    const float* b2;
    const bf16* w3;      // [H, d_out]
    const float* b3;
    const float* gamma;
    const bf16* dout0;   // [M, d_out]
    const bf16* dout1;   // [M, H] with res_dual, else null
    bf16* dx[2];
    bf16* dpre;
    float* part_acc;     // [lanes * blocks_per_lane, slab]
    int rows_per_lane;
    int res_idx;
    int res_dual;
    int d_out;
    int slab;
};

// acc[t] = A[16 rows of block rb, K] * B[K, c0 + 16t ..], B row-major
template <int NT>
__device__ __forceinline__ void mma_rows(const bf16* A, int lda, int K,
                                         const bf16* B, int ldb, FragC* acc,
                                         int rb, int c0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, A + rb * 16 * lda + k0, lda);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, B + k0 * ldb + c0 + t * 16, ldb);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
}

// acc[t] = A[16 rows of block rb, K] * W^T[K, c0 + 16t ..], W row-major
// [n, K] (so W^T is W read column-major)
template <int NT>
__device__ __forceinline__ void mma_rows_bt(const bf16* A, int lda, int K,
                                            const bf16* W, int ldw,
                                            FragC* acc, int rb, int c0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, A + rb * 16 * lda + k0, lda);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            FragBc b;
            wmma::load_matrix_sync(b, W + (c0 + t * 16) * ldw + k0, ldw);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
}

template <int NT>
__device__ __forceinline__ void store_rows(float* sC, const FragC* acc, int rb,
                                           int c0) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
        wmma::store_matrix_sync(sC + rb * 16 * LDC + c0 + t * 16, acc[t], LDC,
                                wmma::mem_row_major);
}

// sC[block] = acc * sC[block], element by element. An accumulator fragment
// loaded from memory holds the same (row, column) in the same register as
// one produced by mma_sync, so the product is of matching elements.
template <int NT>
__device__ __forceinline__ void mul_store_rows(float* sC, FragC* acc, int rb,
                                               int c0) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        FragC m;
        float* p = sC + rb * 16 * LDC + c0 + t * 16;
        wmma::load_matrix_sync(m, p, LDC, wmma::mem_row_major);
#pragma unroll
        for (int i = 0; i < m.num_elements; ++i) acc[t].x[i] *= m.x[i];
        wmma::store_matrix_sync(p, acc[t], LDC, wmma::mem_row_major);
    }
}

// W[m0.., n0 + 16t ..] += A^T B over the tile's TM rows: A [TM, *] and B
// [TM, *] row-major in shared memory, W a float32 row-major slab (device
// memory) read and written by this warp only.
template <int NT>
__device__ __forceinline__ void wgrad_rmw(const bf16* A, int lda,
                                          const bf16* B, int ldb, float* W,
                                          int ldw, int m0, int n0) {
    FragC acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t)
        wmma::load_matrix_sync(acc[t], W + (size_t)m0 * ldw + n0 + t * 16, ldw,
                               wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < TM; k0 += 16) {
        FragAc a;
        wmma::load_matrix_sync(a, A + k0 * lda + m0, lda);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, B + k0 * ldb + n0 + t * 16, ldb);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
        wmma::store_matrix_sync(W + (size_t)m0 * ldw + n0 + t * 16, acc[t], ldw,
                                wmma::mem_row_major);
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    const float t = tanhf(u);
    const float du = 0.7978845608028654f * (1.0f + (float)(3.0 * 0.044715) * x * x);
    return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

// v = bias (+ pre) (+ sC) for the tile, in the forward epilogue's order;
// `grad` stores gelu'(v) in place in sC, otherwise bf16(gelu(v)) into sH.
__device__ __forceinline__ void hidden_pass(float* sC, bool has_acc,
                                            const float* bias, const bf16* pre,
                                            int r0, int nrow, bf16* sH,
                                            bool grad) {
    for (int idx = threadIdx.x; idx < TM * 32; idx += BT) {
        const int row = idx >> 5;
        const int c4 = (idx & 31) * 4;
        float v[4];
        const float4 bb = *reinterpret_cast<const float4*>(bias + c4);
        v[0] = bb.x; v[1] = bb.y; v[2] = bb.z; v[3] = bb.w;
        if (pre != nullptr && row < nrow) {
            float pv[4];
            load_bf16x4(pre + (size_t)(r0 + row) * H + c4, pv);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += pv[i];
        }
        if (has_acc) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += sC[row * LDC + c4 + i];
        }
        if (grad) {
#pragma unroll
            for (int i = 0; i < 4; ++i) sC[row * LDC + c4 + i] = gelu_tanh_grad(v[i]);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] = gelu_tanh(v[i]);
            store_bf16x4(sH + row * LDT + c4, v);
        }
    }
}

// sH = bf16(sC) for the tile; column sums of sC (rows in order) added to
// slab_b[0..H) by threads 0..H-1; optionally dpre = bf16(sC) for real rows
__device__ __forceinline__ void grad_epilogue(const float* sC, bf16* sH,
                                              float* slab_b, bf16* dpre,
                                              int r0, int nrow) {
    for (int idx = threadIdx.x; idx < TM * 32; idx += BT) {
        const int row = idx >> 5;
        const int c4 = (idx & 31) * 4;
        const float v[4] = {sC[row * LDC + c4], sC[row * LDC + c4 + 1],
                            sC[row * LDC + c4 + 2], sC[row * LDC + c4 + 3]};
        store_bf16x4(sH + row * LDT + c4, v);
        if (dpre != nullptr && row < nrow)
            store_bf16x4(dpre + (size_t)(r0 + row) * H + c4, v);
    }
    if (threadIdx.x < H) {
        float s = 0.0f;
        for (int row = 0; row < TM; ++row) s += sC[row * LDC + threadIdx.x];
        slab_b[threadIdx.x] += s;
    }
}

size_t bwd_smem_bytes(int k1) {
    size_t bytes = 0;
    if (k1 > 0) bytes += (size_t)TM * (k1 + 8) * sizeof(bf16);   // sX
    bytes += 3 * (size_t)TM * LDT * sizeof(bf16);                 // sH1 sH2 sDY
    bytes += (size_t)TM * LDC * sizeof(float);                    // sC
    bytes += (size_t)(BT / 32) * 3 * H * sizeof(float);           // sRed
    bytes += (size_t)H * LDW3N * sizeof(bf16);                    // sW3n
    return bytes;
}

template <bool LN>
__global__ void __launch_bounds__(BT, 1) fused_mlp_bwd_kernel(BwdParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int K1 = p.width[0] + p.width[1];
    const int LDX = K1 + 8;
    bf16* sX = reinterpret_cast<bf16*>(smem);
    bf16* sH1 = sX + (size_t)(K1 > 0 ? TM * LDX : 0);
    bf16* sH2 = sH1 + (size_t)TM * LDT;
    bf16* sDY = sH2 + (size_t)TM * LDT;
    float* sC = reinterpret_cast<float*>(sDY + (size_t)TM * LDT);
    float* sRed = sC + (size_t)TM * LDC;
    bf16* sW3n = reinterpret_cast<bf16*>(sRed + (BT / 32) * 3 * H);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int rb = warp >> 1;
    const int c0 = (warp & 1) * 64;
    const int DP = LN ? H : 16;               // padded width of dy / W3 columns

    // slab: dW1 [K1][H] | dW2 [H][H] | dW3 [H][DP] | db1 | db2 | db3 [DP] |
    // dgamma | dbeta
    float* slab = p.part_acc +
        (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * p.slab;
    float* sw1 = slab;
    float* sw2 = sw1 + (size_t)K1 * H;
    float* sw3 = sw2 + H * H;
    float* sb1 = sw3 + H * DP;
    float* sb2 = sb1 + H;
    float* sb3 = sb2 + H;
    float* sg = sb3 + DP;
    float* sbe = sg + H;
    for (int i = threadIdx.x; i < p.slab; i += BT) slab[i] = 0.0f;
    if (!LN) {
        for (int idx = threadIdx.x; idx < H * LDW3N; idx += BT) {
            const int row = idx / LDW3N, c = idx % LDW3N;
            sW3n[idx] = c < p.d_out ? p.w3[(size_t)row * p.d_out + c]
                                    : __float2bfloat16(0.0f);
        }
    }
    const bf16* W3 = LN ? p.w3 : sW3n;
    const int ldw3 = LN ? H : LDW3N;
    __syncthreads();

    const int lane_begin = blockIdx.y * p.rows_per_lane;
    const int lane_end = lane_begin + p.rows_per_lane;
    const int n_tiles = (p.rows_per_lane + TM - 1) / TM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = lane_begin + tile * TM;
        const int nrow = min(TM, lane_end - r0);

        // ---- x parts -> sX (rows past the lane read as zero) ----
        for (int pi = 0; pi < p.n_parts; ++pi) {
            const bf16* src = p.part[pi];
            const int w = p.width[pi];
            const int cpr = w >> 3;
            const int off = pi == 0 ? 0 : p.width[0];
            for (int idx = threadIdx.x; idx < TM * cpr; idx += BT) {
                const int row = idx / cpr, ch = idx % cpr;
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (row < nrow)
                    v = *reinterpret_cast<const uint4*>(
                        src + (size_t)(r0 + row) * w + ch * 8);
                *reinterpret_cast<uint4*>(sX + row * LDX + off + ch * 8) = v;
            }
        }
        __syncthreads();

        FragC acc[4];
        // ---- 1. h1 = bf16(gelu(x W1 + b1 + pre)) ----
        if (K1 > 0) {
            mma_rows<4>(sX, LDX, K1, p.w1, H, acc, rb, c0);
            store_rows<4>(sC, acc, rb, c0);
            __syncthreads();
        }
        hidden_pass(sC, K1 > 0, p.b1, p.pre, r0, nrow, sH1, false);
        __syncthreads();
        // ---- 2. h2 = bf16(gelu(h1 W2 + b2)) ----
        mma_rows<4>(sH1, LDT, H, p.w2, H, acc, rb, c0);
        store_rows<4>(sC, acc, rb, c0);
        __syncthreads();
        hidden_pass(sC, true, p.b2, nullptr, r0, nrow, sH2, false);
        __syncthreads();

        // ---- 3. dy ----
        if (LN) {
            mma_rows<4>(sH2, LDT, H, p.w3, H, acc, rb, c0);
            store_rows<4>(sC, acc, rb, c0);
            __syncthreads();
            const int c4 = lane * 4;
            float b3v[4], gav[4], pg[4], pb[4], pd[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                b3v[i] = p.b3[c4 + i];
                gav[i] = p.gamma[c4 + i];
                pg[i] = pb[i] = pd[i] = 0.0f;
            }
            for (int row = warp; row < TM; row += BT / 32) {
                float y[4], s = 0.0f, ss = 0.0f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    y[i] = sC[row * LDC + c4 + i] + b3v[i];
                    s += y[i];
                    ss += y[i] * y[i];
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                    ss += __shfl_xor_sync(0xffffffffu, ss, off);
                }
                const float mu = s * (1.0f / H);
                const float var = fmaxf(ss * (1.0f / H) - mu * mu, 0.0f);
                const float rstd = 1.0f / sqrtf(var + kLnEps);
                float g[4] = {0.0f, 0.0f, 0.0f, 0.0f}, xh[4], gx[4];
                if (row < nrow) {
                    load_bf16x4(p.dout0 + (size_t)(r0 + row) * H + c4, g);
                    if (p.res_idx >= 0 && p.res_dual) {
                        float g1[4];
                        load_bf16x4(p.dout1 + (size_t)(r0 + row) * H + c4, g1);
#pragma unroll
                        for (int i = 0; i < 4; ++i) g[i] += g1[i];
                    }
                }
                float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    xh[i] = (y[i] - mu) * rstd;
                    pg[i] += g[i] * xh[i];
                    pb[i] += g[i];
                    gx[i] = g[i] * gav[i];
                    s1 += gx[i];
                    s2 += gx[i] * xh[i];
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
                    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
                }
                const float m1 = s1 * (1.0f / H), m2 = s2 * (1.0f / H);
                float dy[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    dy[i] = rstd * ((gx[i] - m1) - xh[i] * m2);
                    pd[i] += dy[i];
                }
                store_bf16x4(sDY + row * LDT + c4, dy);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                sRed[(warp * 3 + 0) * H + c4 + i] = pg[i];
                sRed[(warp * 3 + 1) * H + c4 + i] = pb[i];
                sRed[(warp * 3 + 2) * H + c4 + i] = pd[i];
            }
            __syncthreads();
            if (threadIdx.x < H) {
                float a = 0.0f, b = 0.0f, d = 0.0f;
                for (int w = 0; w < BT / 32; ++w) {
                    a += sRed[(w * 3 + 0) * H + threadIdx.x];
                    b += sRed[(w * 3 + 1) * H + threadIdx.x];
                    d += sRed[(w * 3 + 2) * H + threadIdx.x];
                }
                sg[threadIdx.x] += a;
                sbe[threadIdx.x] += b;
                sb3[threadIdx.x] += d;
            }
        } else {
            // dy = dout: d_out real columns, zero up to one 16-column tile
            for (int idx = threadIdx.x; idx < TM * 16; idx += BT) {
                const int row = idx >> 4, c = idx & 15;
                sDY[row * LDT + c] = (row < nrow && c < p.d_out)
                    ? p.dout0[(size_t)(r0 + row) * p.d_out + c]
                    : __float2bfloat16(0.0f);
            }
            __syncthreads();
            if (threadIdx.x < 16) {
                float d = 0.0f;
                for (int row = 0; row < TM; ++row)
                    d += __bfloat162float(sDY[row * LDT + threadIdx.x]);
                sb3[threadIdx.x] += d;
            }
        }
        // ---- 4. dW3 += h2^T dy16 ----
        if (LN) wgrad_rmw<8>(sH2, LDT, sDY, LDT, sw3, H, warp * 16, 0);
        else wgrad_rmw<1>(sH2, LDT, sDY, LDT, sw3, 16, warp * 16, 0);
        __syncthreads();

        // ---- 5. dh2pre = (dy16 W3^T) * gelu'(h2pre) ----
        mma_rows<4>(sH1, LDT, H, p.w2, H, acc, rb, c0);       // h2pre - b2
        store_rows<4>(sC, acc, rb, c0);
        __syncthreads();
        hidden_pass(sC, true, p.b2, nullptr, r0, nrow, nullptr, true);
        __syncthreads();
        mma_rows_bt<4>(sDY, LDT, DP, W3, ldw3, acc, rb, c0);
        mul_store_rows<4>(sC, acc, rb, c0);
        __syncthreads();
        grad_epilogue(sC, sH2, sb2, nullptr, r0, nrow);      // sH2 = dh2pre16
        __syncthreads();
        // ---- 6. dW2 += h1^T dh2pre16 ----
        wgrad_rmw<8>(sH1, LDT, sH2, LDT, sw2, H, warp * 16, 0);
        __syncthreads();

        // ---- 7. dh1pre = (dh2pre16 W2^T) * gelu'(h1pre); dpre ----
        if (K1 > 0) {
            mma_rows<4>(sX, LDX, K1, p.w1, H, acc, rb, c0);
            store_rows<4>(sC, acc, rb, c0);
            __syncthreads();
        }
        hidden_pass(sC, K1 > 0, p.b1, p.pre, r0, nrow, nullptr, true);
        __syncthreads();
        mma_rows_bt<4>(sH2, LDT, H, p.w2, H, acc, rb, c0);
        mul_store_rows<4>(sC, acc, rb, c0);
        __syncthreads();
        grad_epilogue(sC, sH1, sb1, p.dpre, r0, nrow);        // sH1 = dh1pre16
        __syncthreads();

        if (K1 > 0) {
            // ---- 8. dW1 += x^T dh1pre16 ----
            for (int m0 = warp * 16; m0 < K1; m0 += BT / 2)
                wgrad_rmw<8>(sX, LDX, sH1, LDT, sw1, H, m0, 0);
            // ---- 9. dx_i = dh1pre16 W1_i^T (+ the residual cotangent) ----
            int off = 0;
            for (int pi = 0; pi < p.n_parts; ++pi) {
                const int w = p.width[pi];
                const int n_ct = w / 16;
                for (int f = warp; f < 4 * n_ct; f += BT / 32) {
                    const int frb = f & 3, fc = (f >> 2) * 16;
                    FragC a1[1];
                    mma_rows_bt<1>(sH1, LDT, H, p.w1 + (size_t)off * H, H, a1,
                                   frb, fc);
                    store_rows<1>(sC, a1, frb, fc);
                }
                __syncthreads();
                const bf16* dres = nullptr;
                if (pi == p.res_idx) dres = p.res_dual ? p.dout1 : p.dout0;
                const int cpr = w / 4;
                for (int idx = threadIdx.x; idx < nrow * cpr; idx += BT) {
                    const int row = idx / cpr, c4 = (idx % cpr) * 4;
                    float v[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) v[i] = sC[row * LDC + c4 + i];
                    if (dres != nullptr) {
                        float r[4];
                        load_bf16x4(dres + (size_t)(r0 + row) * H + c4, r);
#pragma unroll
                        for (int i = 0; i < 4; ++i) v[i] += r[i];
                    }
                    store_bf16x4(p.dx[pi] + (size_t)(r0 + row) * w + c4, v);
                }
                __syncthreads();
                off += w;
            }
        }
        __syncthreads();   // every tile buffer is rewritten by the next tile
    }
}

size_t smem_bytes(int k1) {
    const size_t K1 = (size_t)k1;
    size_t bytes = (K1 + 2 * H) * LDW * sizeof(bf16);
    if (K1 > 0) bytes += (size_t)TM * (K1 + 8) * sizeof(bf16);
    bytes += (size_t)TM * LDH * sizeof(bf16);
    bytes += (size_t)TM * LDC * sizeof(float);
    return bytes;
}

}  // namespace

extern "C" int gfvgn_fused_mlp(const void* part0, const void* part1,
                               int width0, int width1,
                               const void* w1, const void* pre,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3,
                               const void* gamma, const void* beta,
                               void* out0, void* out1, int M, int res_idx,
                               int res_dual, int layer_norm, int d_out,
                               int n_sm, void* stream) {
    // width1 > 0 needs width0 > 0; widths are multiples of 16 up to H
    const int n_parts = (width0 > 0) + (width1 > 0);
    if (width0 < 0 || width1 < 0 || width0 > H || width1 > H ||
        width0 % 16 != 0 || width1 % 16 != 0 || (width1 > 0 && width0 == 0) ||
        (n_parts == 0 && pre == nullptr) || res_idx >= n_parts || M < 0 ||
        n_sm < 1)
        return (int)cudaErrorInvalidValue;
    if (res_idx >= 0 && (res_idx == 0 ? width0 : width1) != H)
        return (int)cudaErrorInvalidValue;
    if (layer_norm ? (d_out != H) : (d_out < 1 || d_out > 16 || res_idx >= 0))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    Params p;
    p.part[0] = static_cast<const bf16*>(part0);
    p.part[1] = static_cast<const bf16*>(part1);
    p.width[0] = width0;
    p.width[1] = width1;
    p.n_parts = n_parts;
    p.w1 = static_cast<const bf16*>(w1);
    p.pre = static_cast<const bf16*>(pre);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.w3 = static_cast<const bf16*>(w3);
    p.b3 = static_cast<const float*>(b3);
    p.gamma = static_cast<const float*>(gamma);
    p.beta = static_cast<const float*>(beta);
    p.out0 = static_cast<bf16*>(out0);
    p.out1 = static_cast<bf16*>(out1);
    p.M = M;
    p.res_idx = res_idx;
    p.res_dual = res_dual;
    p.d_out = d_out;

    const size_t smem = smem_bytes(width0 + width1);
    const int n_tiles = (M + TM - 1) / TM;
    const int grid = n_tiles < n_sm ? n_tiles : n_sm;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (layer_norm) {
        err = cudaFuncSetAttribute(fused_mlp_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_kernel<true><<<grid, THREADS, smem, s>>>(p);
    } else {
        err = cudaFuncSetAttribute(fused_mlp_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_kernel<false><<<grid, THREADS, smem, s>>>(p);
    }
    return (int)cudaGetLastError();
}

extern "C" int gfvgn_fused_mlp_bwd(const void* part0, const void* part1,
                                   int width0, int width1, const void* w1,
                                   const void* pre, const void* b1,
                                   const void* w2, const void* b2,
                                   const void* w3, const void* b3,
                                   const void* gamma, const void* dout0,
                                   const void* dout1, void* dx0, void* dx1,
                                   void* dpre, void* partials, void* total,
                                   int M, int res_idx, int res_dual,
                                   int layer_norm, int d_out, int lanes,
                                   int blocks_per_lane, void* stream) {
    const int n_parts = (width0 > 0) + (width1 > 0);
    if (width0 < 0 || width1 < 0 || width0 > H || width1 > H ||
        width0 % 16 != 0 || width1 % 16 != 0 || (width1 > 0 && width0 == 0) ||
        (n_parts == 0 && pre == nullptr) || res_idx >= n_parts || M < 0 ||
        lanes < 1 || blocks_per_lane < 1 || lanes > 65535 || M % lanes != 0)
        return (int)cudaErrorInvalidValue;
    if (res_idx >= 0 && (res_idx == 0 ? width0 : width1) != H)
        return (int)cudaErrorInvalidValue;
    if (layer_norm ? (d_out != H) : (d_out < 1 || d_out > 16 || res_idx >= 0))
        return (int)cudaErrorInvalidValue;
    if (res_idx >= 0 && res_dual && dout1 == nullptr)
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    const int k1 = width0 + width1;
    const int dp = layer_norm ? H : 16;
    BwdParams p;
    p.part[0] = static_cast<const bf16*>(part0);
    p.part[1] = static_cast<const bf16*>(part1);
    p.width[0] = width0;
    p.width[1] = width1;
    p.n_parts = n_parts;
    p.w1 = static_cast<const bf16*>(w1);
    p.pre = static_cast<const bf16*>(pre);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.w3 = static_cast<const bf16*>(w3);
    p.b3 = static_cast<const float*>(b3);
    p.gamma = static_cast<const float*>(gamma);
    p.dout0 = static_cast<const bf16*>(dout0);
    p.dout1 = static_cast<const bf16*>(dout1);
    p.dx[0] = static_cast<bf16*>(dx0);
    p.dx[1] = static_cast<bf16*>(dx1);
    p.dpre = static_cast<bf16*>(dpre);
    p.part_acc = static_cast<float*>(partials);
    p.rows_per_lane = M / lanes;
    p.res_idx = res_idx;
    p.res_dual = res_dual;
    p.d_out = d_out;
    p.slab = k1 * H + H * H + H * dp + 4 * H + dp;
    const int n_w = k1 * H + H * H + H * dp;

    const size_t smem = bwd_smem_bytes(k1);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const dim3 grid(blocks_per_lane, lanes);
    cudaError_t err;
    if (layer_norm) {
        err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_bwd_kernel<true><<<grid, BT, smem, s>>>(p);
    } else {
        err = cudaFuncSetAttribute(fused_mlp_bwd_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_bwd_kernel<false><<<grid, BT, smem, s>>>(p);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lane_reduce<<<(p.slab + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(partials), static_cast<float*>(total),
        p.slab, n_w, lanes, blocks_per_lane);
    return (int)cudaGetLastError();
}
