// K5f and K5b: the Transolver block's pre-LN MLP branch with its residual,
// forward and backward, for sm_90a, at any width C % 128 == 0 up to 1024
// with the hidden width 2C (mlp_ratio 2):
//
//   u   = bf16(LN(x) * gamma + beta)
//   h   = bf16(gelu(u * W1 + b1))                    W1 [C, 2C]
//   out = bf16((h * W2 + b2) + x)                    W2 [2C, C]
//
// K5f replaces the Pallas TPU kernel _premlp_fwd_kernel of
// gen_fvgn_tpu/ops/fused_mlp.py (core :691-711, called at :747).
//
// What bounds it on the H100: bytes. A row costs 2*(128*256 + 256*128) =
// 131 k FLOP at C = 128 against 512 bytes moved (x read once, out written
// once), 256 FLOP/byte, under the card's ~295 FLOP/byte bf16 ridge.
//
// Design at C = 128 (premlp_kernel). Rows are independent: [B, N, 128] is
// flattened to [M, 128] and the ragged last 64-row tile is masked, so M needs
// no padding. A block stages W1 and W2 in shared memory as bf16 once (135 KB
// with row padding against bank conflicts) and walks over 64-row tiles (grid
// = min(tiles, SMs)). The LayerNorm runs a row per warp (4 columns a lane,
// statistics by warp shuffles); the lane keeps its raw x values in registers
// for the residual. The two products run on the tensor cores through wmma
// (bf16 operands, float32 accumulators); the 256-wide hidden layer is
// produced in two 128-column halves through one float32 staging tile, so u,
// h1pre, h and y never reach device memory. Shared memory: 222 KB, one block
// per SM. This first form stages every accumulator through shared memory; its
// times stand in PERF.md beside its bound. Wider C (the 222 KB tile does not
// scale) and the backward run on the block row tiles below.
//
// Rounding points (the TPU kernel's): LayerNorm statistics in float32 (fast
// variance clamped at 0, eps 1e-6); u rounded to bf16 before W1; h1pre, GELU
// (tanh form, evaluated as x * sigmoid(2u) on a fast exp: mma_sm90.cuh) in
// float32, h rounded to bf16 before W2; the residual x is added in float32
// BEFORE the one final bf16 rounding (unlike K2's epilogue, which rounds
// first and adds in bf16).
//
// Plain C interface, no allocation (the backward takes a workspace of the
// size gfvgn_premlp_workspace gives), launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"

using namespace nvcuda;

namespace {

// ===================== K5f at C = 128: wmma row tiles ======================

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


// ============== K5f (C >= 256) and K5b (every C): block row tiles ===========
//
// Any C % 128 == 0 up to 1024 with the hidden width 2C, the tile's rows
// shared by the block's 8 warps (mma_sm90.cuh: Blk, block_product). Weights
// resident in shared memory where they fit (C = 128: 32-row tiles),
// otherwise streamed through the ring (the largest of 64, 32, 16 rows that
// fits). Above C = 512 the backward's tile no longer holds the whole hidden
// row: it takes the hidden width in chunks of one pass (512 columns, 16-row
// tiles), adds each chunk's dh1pre16 W1^T into float32 du accumulators kept
// in registers, and stages du where the ring was once the chunks are done;
// the rounding points do not move. The tile's rows of x and, in the backward, of dout come in by
// cp.async, the next tile's while this one computes where there is room for
// two buffers (tile_plan).
//
// K5b replaces the Pallas TPU kernel _premlp_bwd_kernel of
// gen_fvgn_tpu/ops/fused_mlp.py (:714-740, called at :766). With g = dout:
//
//   dW2 = h16^T g16;  dh1pre = (g16 W2^T) * gelu'(h1pre);  db1 = sum dh1pre
//   dW1 = u16^T dh1pre16;  du = dh1pre16 W1^T;  db2 = sum g
//   dgamma = sum du*xhat;  dbeta = sum du
//   dx = bf16(rstd*(du*gamma - mean(du*gamma) - xhat*mean(du*gamma*xhat)) + g)
//
// with the TPU kernel's rounding points: g and dh1pre rounded to bf16 before
// their products (g arrives bf16), the LayerNorm backward in float32, and the
// residual cotangent joining dx in float32 before the one rounding.
//
// What bounds it on the H100: bytes (x and dout in, dx out: 768 bytes a row
// at C = 128 against 5 products of 128 x 256 a row). It runs as two passes
// and a fixed-order reduction, as K3 does:
//   the row pass (premlp_tiles<CPL, true>): per tile the LayerNorm and
//     u16 W1 + b1 are recomputed once; for each pass of hidden columns the
//     warp forms gelu and gelu' from one exp (registers), then g16 W2^T for
//     the same columns, so gelu' never leaves the registers; dh1pre16 stays
//     in shared memory as the A operand of du = dh1pre16 W1^T; the LayerNorm
//     backward runs a row a warp. It writes u16, h16 and dh1pre16 as bf16
//     rows (the TPU kernel rounds all of them to bf16 before its weight
//     products, so storing them moves no rounding point) and keeps the
//     float32 column sums db1 (shared memory), db2, dgamma, dbeta (each
//     lane's columns, registers) over all its tiles, written once a block;
//   the weight-gradient pass (fused_mlp_wgrad through gfvgn_wgrad): per batch
//     lane dW1 = u16^T dh1pre16 and dW2 = h16^T g16;
//   lane_reduce: each lane's weight gradients rounded to bf16, lanes and
//     blocks summed in a fixed order (no atomics: the same bits every run).
//
// The forward at C >= 256 (premlp_tiles<CPL, false>) is the same tile: the
// LayerNorm, h16 = bf16(gelu(u16 W1 + b1)) into shared memory, then
// out = bf16((h16 W2 + b2) + x).

struct TilePlan {
    int tm, nbuf, resident, grid;
    size_t smem;
    int o_w, o_x, o_u, o_h, o_g, o_du, o_stat, o_red, o_acc;
};

struct TileParams {
    const bf16* x;        // [M, C]
    const float* gamma;
    const float* beta;
    const bf16* w1;       // [C, 2C]
    const float* b1;
    const bf16* w2;       // [2C, C]
    const float* b2;
    bf16* out;            // forward [M, C]
    const bf16* dout;     // backward [M, C]
    bf16* dx;             // [M, C]
    bf16* us;             // [M, C]   u16 rows for the weight-gradient pass
    bf16* hs;             // [M, 2C]  h16 rows
    bf16* dhs;            // [M, 2C]  dh1pre16 rows
    float* colsum;        // [grid][5C]: db1 (2C) | db2 | dgamma | dbeta
    int M;
    TilePlan L;           // the tile and its shared-memory layout
};

// the backward above C = 512 takes the hidden width in chunks of a pass
// (CHUNK_MIN_C): 16-row tiles, streamed weights, the float32 du accumulated
// in registers over the chunks and staged where the ring was
constexpr int CHUNK_MIN_C = 640;

// shared-memory layout of a tile of tm rows; returns the total bytes
size_t tile_layout(int c, int tm, int resident, int nbuf, bool bwd,
                   TilePlan& L) {
    const int hd = 2 * c, wr = tm / 16, pw = (8 / wr) * 64;
    const bool chunk = bwd && c >= CHUNK_MIN_C;
    size_t o = 0;
    L.o_w = (int)o;
    size_t w = resident ? ((size_t)c * (hd + 8) + (size_t)hd * (c + 8)) * 2
                        : (size_t)2 * ring_slot(pw) * 2;
    if (chunk && w < (size_t)tm * (c + 4) * 4) w = (size_t)tm * (c + 4) * 4;
    o += align128(w);
    L.o_x = (int)o;
    o += align128((size_t)nbuf * tm * (c + 8) * 2);
    L.o_u = (int)o;
    o += align128((size_t)tm * (c + 8) * 2);
    L.o_h = (int)o;
    o += align128((size_t)tm * ((chunk ? pw : hd) + 8) * 2);
    L.o_g = (int)o;
    o += align128(bwd ? (size_t)nbuf * tm * (c + 8) * 2 : 0);
    L.o_du = chunk ? L.o_w : (int)o;
    o += align128(bwd && !chunk ? (size_t)tm * (c + 4) * 4 : 0);
    L.o_stat = (int)o;
    o += align128(bwd ? (size_t)tm * 2 * 4 : 0);
    L.o_red = (int)o;
    o += align128(bwd ? (size_t)wr * hd * 4 : 0);
    L.o_acc = (int)o;
    o += align128(bwd ? (size_t)hd * 4 : 0);
    // the end of the backward reuses the start for [8 warps][3][C] floats
    const size_t fin = bwd ? (size_t)8 * 3 * c * 4 : 0;
    return o > fin ? o : fin;
}

template <int CPL, bool BWD>
__global__ void __launch_bounds__(BK_THREADS, 1) premlp_tiles(TileParams p) {
    constexpr int CC = 128 * CPL, HDD = 2 * CC;
    constexpr bool CHUNK = BWD && CC >= CHUNK_MIN_C;
    constexpr int LDC_ = CC + 8, LDH_ = HDD + 8, LDU_ = CC + 4;
    extern __shared__ __align__(128) unsigned char smem[];
    const bool res = p.L.resident != 0;
    bf16* sW1 = reinterpret_cast<bf16*>(smem + p.L.o_w);
    bf16* sW2 = sW1 + (size_t)CC * LDH_;
    const Blk b = make_blk(p.L.tm, sW1);
    // W1 [C][2C] is [k][n] for u W1 and [n][k] for dh W1^T; W2 [2C][C] is
    // [k][n] for h W2 and [n][k] for g W2^T: one source each
    const WSrc W1{p.w1, HDD, res ? sW1 : nullptr, LDH_};
    const WSrc W2{p.w2, CC, res ? sW2 : nullptr, LDC_};
    bf16* sX = reinterpret_cast<bf16*>(smem + p.L.o_x);
    bf16* sU = reinterpret_cast<bf16*>(smem + p.L.o_u);
    bf16* sH = reinterpret_cast<bf16*>(smem + p.L.o_h);   // h16, or dh1pre16
    bf16* sG = reinterpret_cast<bf16*>(smem + p.L.o_g);
    float* sDU = reinterpret_cast<float*>(smem + p.L.o_du);
    float* sStat = reinterpret_cast<float*>(smem + p.L.o_stat);
    float* sRed = reinterpret_cast<float*>(smem + p.L.o_red);
    float* sAcc = reinterpret_cast<float*>(smem + p.L.o_acc);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tm = p.L.tm;

    if (res) {
        stage_matrix(sW1, LDH_, p.w1, CC, HDD);
        stage_matrix(sW2, LDC_, p.w2, HDD, CC);
    }
    if (BWD)
        for (int i = threadIdx.x; i < HDD; i += BK_THREADS) sAcc[i] = 0.0f;
    const int n_tiles = (p.M + tm - 1) / tm;
    auto load_rows = [&](int tile, int buf) {
        const int r0 = tile * tm, nrow = min(tm, p.M - r0);
        load_tile_rows(sX + (size_t)buf * tm * LDC_, LDC_, p.x, CC, r0, nrow,
                       tm);
        if (BWD)
            load_tile_rows(sG + (size_t)buf * tm * LDC_, LDC_, p.dout, CC, r0,
                           nrow, tm);
    };
    if ((int)blockIdx.x < n_tiles) load_rows(blockIdx.x, 0);
    cp_async_commit();

    // this lane's columns of the row-a-warp stages: 128 k + 4 lane + j
    float pg[CPL][4], pb[CPL][4], pd[CPL][4];
#pragma unroll
    for (int k = 0; k < CPL; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) pg[k][j] = pb[k][j] = pd[k][j] = 0.0f;

    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
        const int r0 = tile * tm, nrow = min(tm, p.M - r0);
        const int buf = p.L.nbuf == 2 ? (it & 1) : 0;
        const bf16* xb = sX + (size_t)buf * tm * LDC_;
        const bf16* gb = sG + (size_t)buf * tm * LDC_;
        if (p.L.nbuf == 1 && it > 0) {
            __syncthreads();                 // the last tile is done with them
            load_rows(tile, 0);
            cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();
        if (p.L.nbuf == 2) {
            // the next tile's rows, into the buffers the last tile used
            if (tile + (int)gridDim.x < n_tiles)
                load_rows(tile + gridDim.x, buf ^ 1);
            cp_async_commit();
        }

        // ---- LayerNorm, a row a warp: u = bf16(LN(x) gamma + beta) ----
        for (int row = warp; row < tm; row += 8) {
            float v[CPL][4], s = 0.0f, ss = 0.0f;
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                load_bf16x4(xb + row * LDC_ + 128 * k + 4 * lane, v[k]);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s += v[k][j];
                    ss += v[k][j] * v[k][j];
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, off);
                ss += __shfl_xor_sync(0xffffffffu, ss, off);
            }
            const float mu = s / (float)CC;
            const float var = fmaxf(ss / (float)CC - mu * mu, 0.0f);
            const float rstd = 1.0f / sqrtf(var + kLnEps);
            if (BWD && lane == 0) {
                sStat[2 * row] = mu;
                sStat[2 * row + 1] = rstd;
            }
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                const int col = 128 * k + 4 * lane;
                const float4 ga = *reinterpret_cast<const float4*>(p.gamma + col);
                const float4 be = *reinterpret_cast<const float4*>(p.beta + col);
                const float u[4] = {(v[k][0] - mu) * rstd * ga.x + be.x,
                                    (v[k][1] - mu) * rstd * ga.y + be.y,
                                    (v[k][2] - mu) * rstd * ga.z + be.z,
                                    (v[k][3] - mu) * rstd * ga.w + be.w};
                store_bf16x4(sU + row * LDC_ + col, u);
                if (BWD && row < nrow)
                    store_bf16x4(p.us + (size_t)(r0 + row) * CC + col, u);
            }
        }
        __syncthreads();

        float acc[8][4];
        if (!BWD) {
            // ---- h16 = bf16(gelu(u16 W1 + b1)) ----
            for (int n0 = 0; n0 < HDD; n0 += b.pw) {
                const int nv = block_product<false>(b, acc, sU, LDC_, CC, W1,
                                                    n0, HDD);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
                        const float2 bb = *reinterpret_cast<const float2*>(p.b1 + col);
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = b.wrow * 16 + b.g + 8 * hf;
                            store_bf16x2(sH + row * LDH_ + col,
                                         gelu_tanh(acc[nt][2 * hf] + bb.x),
                                         gelu_tanh(acc[nt][2 * hf + 1] + bb.y));
                        }
                    }
                }
            }
            __syncthreads();
            // ---- out = bf16((h16 W2 + b2) + x) ----
            for (int n0 = 0; n0 < CC; n0 += b.pw) {
                const int nv = block_product<false>(b, acc, sH, LDH_, HDD, W2,
                                                    n0, CC);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
                        const float2 bb = *reinterpret_cast<const float2*>(p.b2 + col);
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = b.wrow * 16 + b.g + 8 * hf;
                            if (row < nrow) {
                                const float2 xv = load_bf16x2(xb + row * LDC_ + col);
                                store_bf16x2(
                                    p.out + (size_t)(r0 + row) * CC + col,
                                    (acc[nt][2 * hf] + bb.x) + xv.x,
                                    (acc[nt][2 * hf + 1] + bb.y) + xv.y);
                            }
                        }
                    }
                }
            }
            continue;
        }

        // ---- per pass of hidden columns: h16 and gelu'(h1pre), then
        //      dh1pre = (g16 W2^T) gelu' for the same columns; above C =
        //      512 also du += dh1pre16 W1^T of those columns (CHUNK: sH
        //      holds one pass, du two passes of accumulators) ----
        float gk[8][4];
        float adu[CHUNK ? 2 : 1][8][4];
        if (CHUNK) {
            zero_acc(adu[0]);
            zero_acc(adu[CHUNK ? 1 : 0]);
        }
        const int ldh = CHUNK ? b.pw + 8 : LDH_;
        for (int n0 = 0; n0 < HDD; n0 += b.pw) {
            const int h0 = CHUNK ? n0 : 0;      // first hidden column of sH
            const int nv = block_product<false>(b, acc, sU, LDC_, CC, W1, n0,
                                                HDD);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
                    const float2 bb = *reinterpret_cast<const float2*>(p.b1 + col);
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = b.wrow * 16 + b.g + 8 * hf;
                        const float h0 = gelu_and_grad(acc[nt][2 * hf] + bb.x,
                                                       gk[nt][2 * hf]);
                        const float h1 = gelu_and_grad(
                            acc[nt][2 * hf + 1] + bb.y, gk[nt][2 * hf + 1]);
                        if (row < nrow)
                            store_bf16x2(p.hs + (size_t)(r0 + row) * HDD + col,
                                         h0, h1);
                    }
                }
            }
            block_product<true>(b, acc, gb, LDC_, CC, W2, n0, HDD);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
                    float ps[2] = {0.0f, 0.0f};
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = b.wrow * 16 + b.g + 8 * hf;
                        const float d0 = acc[nt][2 * hf] * gk[nt][2 * hf];
                        const float d1 = acc[nt][2 * hf + 1] * gk[nt][2 * hf + 1];
                        ps[0] += d0;
                        ps[1] += d1;
                        const uint32_t dv = pack_bf16(d0, d1);
                        *reinterpret_cast<uint32_t*>(sH + row * ldh + col - h0) =
                            dv;
                        if (row < nrow)
                            *reinterpret_cast<uint32_t*>(
                                p.dhs + (size_t)(r0 + row) * HDD + col) = dv;
                    }
                    col_sum_store(ps[0], ps[1], b.g, sRed + b.wrow * HDD + col);
                }
            }
            if (CHUNK) {
                // W1 [C][2C] read as [n][k] from hidden column n0 on
                const WSrc W1c{p.w1 + n0, HDD, nullptr, 0};
                const int kc = min(b.pw, HDD - n0);
#pragma unroll
                for (int q = 0; q < (CHUNK ? 2 : 1); ++q)
                    if (q * b.pw < CC)
                        block_product<true>(b, adu[q], sH, ldh, kc, W1c,
                                            q * b.pw, CC, true);
            }
        }
        __syncthreads();
        // the tile's db1, row warps in order
        for (int i = threadIdx.x; i < HDD; i += BK_THREADS) {
            float s = 0.0f;
            for (int w = 0; w < b.wr; ++w) s += sRed[w * HDD + i];
            sAcc[i] += s;
        }
        // ---- du = dh1pre16 W1^T ----
        for (int n0 = 0; n0 < CC; n0 += b.pw) {
            const int nv = CHUNK ? max(0, min(8, (CC - n0 - b.wcol * 64) / 8))
                                 : block_product<true>(b, acc, sH, LDH_, HDD,
                                                       W1, n0, CC);
            if (CHUNK) {
                const bool first = n0 == 0;
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[nt][e] = first ? adu[0][nt][e]
                                           : adu[CHUNK ? 1 : 0][nt][e];
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = b.wrow * 16 + b.g + 8 * hf;
                        *reinterpret_cast<float2*>(sDU + row * LDU_ + col) =
                            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
                    }
                }
            }
        }
        __syncthreads();
        // ---- the LayerNorm backward and dx, a row a warp ----
        for (int row = warp; row < nrow; row += 8) {
            const float mu = sStat[2 * row], rstd = sStat[2 * row + 1];
            float xh[CPL][4], dxh[CPL][4], gv[CPL][4];
            float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                const int col = 128 * k + 4 * lane;
                float xv[4];
                load_bf16x4(xb + row * LDC_ + col, xv);
                load_bf16x4(gb + row * LDC_ + col, gv[k]);
                const float4 du = *reinterpret_cast<const float4*>(sDU + row * LDU_ + col);
                const float4 ga = *reinterpret_cast<const float4*>(p.gamma + col);
                const float d[4] = {du.x, du.y, du.z, du.w};
                const float gm[4] = {ga.x, ga.y, ga.z, ga.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    xh[k][j] = (xv[j] - mu) * rstd;
                    dxh[k][j] = d[j] * gm[j];
                    s1 += dxh[k][j];
                    s2 += dxh[k][j] * xh[k][j];
                    pg[k][j] += d[j] * xh[k][j];
                    pb[k][j] += d[j];
                    pd[k][j] += gv[k][j];
                }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s1 += __shfl_xor_sync(0xffffffffu, s1, off);
                s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            }
            const float m1 = s1 / (float)CC, m2 = s2 / (float)CC;
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                float dx[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    dx[j] = rstd * ((dxh[k][j] - m1) - xh[k][j] * m2) + gv[k][j];
                store_bf16x4(p.dx + (size_t)(r0 + row) * CC + 128 * k + 4 * lane,
                             dx);
            }
        }
    }
    cp_async_wait<0>();
    if (!BWD) return;
    __syncthreads();
    float* cs = p.colsum + (size_t)blockIdx.x * 5 * CC;
    for (int i = threadIdx.x; i < HDD; i += BK_THREADS) cs[i] = sAcc[i];
    __syncthreads();
    // db2 | dgamma | dbeta: the warps' lane columns, warps in order
    float* fin = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int k = 0; k < CPL; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = 128 * k + 4 * lane + j;
            fin[(warp * 3 + 0) * CC + col] = pd[k][j];
            fin[(warp * 3 + 1) * CC + col] = pg[k][j];
            fin[(warp * 3 + 2) * CC + col] = pb[k][j];
        }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * CC; i += BK_THREADS) {
        const int kind = i / CC, col = i - kind * CC;
        float s = 0.0f;
        for (int w = 0; w < 8; ++w) s += fin[(w * 3 + kind) * CC + col];
        cs[HDD + i] = s;
    }
}

constexpr int MAX_CPL = 8;              // C up to 1024

// the tile plan of the block kernels for width c, or cudaErrorInvalidValue:
// weights resident before streamed, larger tiles first, two row buffers
// before one
int tile_plan(int c, int m, bool bwd, TilePlan& P) {
    int max_smem = 0, n_sm = 0;
    const int err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    if (c < 128 || c % 128 != 0 || c / 128 > MAX_CPL || m < 0)
        return (int)cudaErrorInvalidValue;
    for (int res = 1; res >= 0; --res)
        for (int tm = 64; tm >= 16; tm >>= 1)
            for (int nbuf = 2; nbuf >= 1; --nbuf) {
                // the chunked backward keeps two passes of du: 16-row tiles
                if (bwd && c >= CHUNK_MIN_C && (tm != 16 || res)) continue;
                const size_t total = tile_layout(c, tm, res, nbuf, bwd, P);
                if (total <= (size_t)max_smem) {
                    P.tm = tm;
                    P.nbuf = nbuf;
                    P.resident = res;
                    P.smem = total;
                    const int tiles = (m + tm - 1) / tm;
                    P.grid = tiles < n_sm ? tiles : n_sm;
                    if (P.grid < 1) P.grid = 1;
                    return 0;
                }
            }
    return (int)cudaErrorInvalidValue;
}

// the backward's workspace: u16, h16, dh1pre16 rows, the blocks' column
// sums and the weight-gradient pass's partials
struct BwdWs {
    size_t o_us, o_hs, o_dhs, o_colsum, o_part, bytes;
    gfvgn::WgParams q;
};

void bwd_workspace(int c, int m, int lanes, int grid, int n_sm, BwdWs& W) {
    const int hd = 2 * c;
    size_t o = 0;
    W.o_us = o; o += align128((size_t)m * c * 2);
    W.o_hs = o; o += align128((size_t)m * hd * 2);
    W.o_dhs = o; o += align128((size_t)m * hd * 2);
    W.o_colsum = o; o += align128((size_t)grid * 5 * c * 4);
    gfvgn::WgParams& q = W.q;
    q.n_jobs = 2;
    q.job[0] = gfvgn::WgJob{nullptr, c, c, nullptr, hd, hd, 0, hd};
    q.job[1] = gfvgn::WgJob{nullptr, hd, hd, nullptr, c, c, c * hd, c};
    q.rows_per_lane = m / lanes;
    q.n_w = 2 * c * hd;
    gfvgn::wg_chunking(gfvgn::wg_tiles(q), q.rows_per_lane, lanes, n_sm,
                       q.chunk_rows, q.n_chunks);
    W.o_part = o; o += align128((size_t)lanes * q.n_chunks * q.n_w * 4);
    W.bytes = o;
}

template <int CPL, bool BWD>
int launch_tiles(const TilePlan& P, TileParams& p, cudaStream_t st) {
    p.L = P;
    cudaError_t e = cudaFuncSetAttribute(
        premlp_tiles<CPL, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P.smem);
    if (e != cudaSuccess) return (int)e;
    premlp_tiles<CPL, BWD><<<P.grid, BK_THREADS, P.smem, st>>>(p);
    return (int)cudaGetLastError();
}

template <bool BWD>
int launch_tiles_c(int c, const TilePlan& P, TileParams& p, cudaStream_t st) {
    switch (c / 128) {
        case 1: return launch_tiles<1, BWD>(P, p, st);
        case 2: return launch_tiles<2, BWD>(P, p, st);
        case 3: return launch_tiles<3, BWD>(P, p, st);
        case 4: return launch_tiles<4, BWD>(P, p, st);
        case 5: return launch_tiles<5, BWD>(P, p, st);
        case 6: return launch_tiles<6, BWD>(P, p, st);
        case 7: return launch_tiles<7, BWD>(P, p, st);
        case 8: return launch_tiles<8, BWD>(P, p, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of workspace K5f (backward = 0) or K5b needs for x [M, C], hidden
// width 2C, M rows in `lanes` equal batch lanes; -1 where no kernel takes
// the shape (C not a multiple of 128, C above 1024, or no tile that fits a
// block's shared memory).
extern "C" long long gfvgn_premlp_workspace(int c, int m, int lanes,
                                            int backward) {
    TilePlan P;
    if (tile_plan(c, m, backward != 0, P) != 0) return -1;
    if (!backward) return 0;
    if (lanes < 1 || lanes > 65535 || m % lanes != 0) return -1;
    int max_smem = 0, n_sm = 0;
    if (device_limits(max_smem, n_sm) != 0) return -1;
    BwdWs W;
    bwd_workspace(c, m, lanes, P.grid, n_sm, W);
    return (long long)W.bytes;
}

extern "C" int gfvgn_fused_premlp(const void* x, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int c, int m,
                                  void* stream) {
    TilePlan P;
    int err = tile_plan(c, m, false, P);
    if (err != 0) return err;
    if (m == 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (c == C) {
        // the C = 128 kernel: weights staged once, wmma row tiles
        Params p;
        p.x = static_cast<const bf16*>(x);
        p.gamma = static_cast<const float*>(gamma);
        p.beta = static_cast<const float*>(beta);
        p.w1 = static_cast<const bf16*>(w1);
        p.b1 = static_cast<const float*>(b1);
        p.w2 = static_cast<const bf16*>(w2);
        p.b2 = static_cast<const float*>(b2);
        p.out = static_cast<bf16*>(out);
        p.M = m;
        cudaError_t e = cudaFuncSetAttribute(
            premlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSmemBytes);
        if (e != cudaSuccess) return (int)e;
        int max_smem = 0, n_sm = 0;
        err = device_limits(max_smem, n_sm);
        if (err != 0) return err;
        const int n_tiles = (m + TM - 1) / TM;
        premlp_kernel<<<n_tiles < n_sm ? n_tiles : n_sm, THREADS, kSmemBytes,
                        st>>>(p);
        return (int)cudaGetLastError();
    }
    TileParams p{};
    p.x = static_cast<const bf16*>(x);
    p.gamma = static_cast<const float*>(gamma);
    p.beta = static_cast<const float*>(beta);
    p.w1 = static_cast<const bf16*>(w1);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.out = static_cast<bf16*>(out);
    p.M = m;
    return launch_tiles_c<false>(c, P, p, st);
}

// total: the float32 slab [dW1 (C x 2C) | dW2 (2C x C) | db1 (2C) | db2 |
// dgamma | dbeta (C each)], the weight gradients summed per lane, each
// lane's sum rounded to bf16, the lanes summed in order
extern "C" int gfvgn_fused_premlp_bwd(const void* x, const void* gamma,
                                      const void* beta, const void* w1,
                                      const void* b1, const void* w2,
                                      const void* b2, const void* dout,
                                      void* dx, void* total, int c, int m,
                                      int lanes, void* workspace,
                                      void* stream) {
    TilePlan P;
    int err = tile_plan(c, m, true, P);
    if (err != 0) return err;
    if (lanes < 1 || lanes > 65535 || m % lanes != 0)
        return (int)cudaErrorInvalidValue;
    int max_smem = 0, n_sm = 0;
    err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int hd = 2 * c;
    if (m == 0)
        return (int)cudaMemsetAsync(total, 0,
                                    (size_t)(2 * c * hd + 5 * c) * 4, st);
    BwdWs W;
    bwd_workspace(c, m, lanes, P.grid, n_sm, W);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    TileParams p{};
    p.x = static_cast<const bf16*>(x);
    p.gamma = static_cast<const float*>(gamma);
    p.beta = static_cast<const float*>(beta);
    p.w1 = static_cast<const bf16*>(w1);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.dout = static_cast<const bf16*>(dout);
    p.dx = static_cast<bf16*>(dx);
    p.us = reinterpret_cast<bf16*>(ws + W.o_us);
    p.hs = reinterpret_cast<bf16*>(ws + W.o_hs);
    p.dhs = reinterpret_cast<bf16*>(ws + W.o_dhs);
    p.colsum = reinterpret_cast<float*>(ws + W.o_colsum);
    p.M = m;
    err = launch_tiles_c<true>(c, P, p, st);
    if (err != 0) return err;
    // dW1 = u16^T dh1pre16, dW2 = h16^T g16, per lane
    gfvgn::WgParams& q = W.q;
    q.job[0].a = p.us;
    q.job[0].b = p.dhs;
    q.job[1].a = p.hs;
    q.job[1].b = p.dout;
    q.part = reinterpret_cast<float*>(ws + W.o_part);
    float* tot = static_cast<float*>(total);
    err = gfvgn_wgrad(&q, lanes, tot, st);
    if (err != 0) return err;
    lane_reduce<<<(5 * c + 255) / 256, 256, 0, st>>>(
        p.colsum, tot + q.n_w, 5 * c, 0, 1, P.grid);
    return (int)cudaGetLastError();
}
