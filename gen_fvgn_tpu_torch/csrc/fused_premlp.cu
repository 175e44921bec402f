// K5f and K5b: the Transolver block's pre-LN MLP branch with its residual,
// forward and backward, for sm_90a, at any width C % 128 == 0 with the
// hidden width 2C (mlp_ratio 2):
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
// Design at C = 128 (premlp_rows): K2's H = 128 row design, one warp a
// 16-row strip with every intermediate in registers (below). The C = 128
// backward runs on block row tiles further down, every wider C, forward
// and backward, as passes through device memory (the last section).
//
// Rounding points (the TPU kernel's): LayerNorm statistics in float32 (fast
// variance clamped at 0, eps 1e-6); u rounded to bf16 before W1; h1pre, GELU
// (tanh form, evaluated as x * sigmoid(2u) on a fast exp: mma_sm90.cuh) in
// float32, h rounded to bf16 before W2; the residual x is added in float32
// BEFORE the one final bf16 rounding (unlike K2's epilogue, which rounds
// first and adds in bf16).
//
// Plain C interface, no allocation (the backward, and the forward's passes,
// take a workspace of the size gfvgn_premlp_workspace gives), launches on
// the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"

namespace {

// ================ K5f at C = 128: one warp a 16-row strip ==================
//
// K2's row design (fused_mlp.cu, fused_mlp_fwd_rows) for the pre-LN branch.
// The block stages W1 [128][256 + 8] and W2 [256][128 + 8] as bf16 once
// (137 KB) and the vectors gamma, beta, b1, b2; after that its 8 warps share
// nothing and meet at no barrier. Each warp walks over its own 16-row
// strips (grid = min(blocks, SMs), strips s, s + 8 grid, ...):
//
//   * x: the strip's rows come in by cp.async into one of the warp's two
//     buffers, two strips ahead; ldmatrix moves them into A fragments xa
//     (16 x 128 bf16, 32 registers), which frees the buffer for the strip
//     after next, so two strips (8 KB) are in flight a warp while it works;
//   * LayerNorm on the fragments: a thread holds 32 values of each of rows
//     g and g + 8, the quad (4 lanes) a whole row: statistics by two quad
//     shuffles; u = bf16(xhat gamma + beta) is formed in the A-fragment
//     layout (ua, 32 registers): the A operand of u W1;
//   * the hidden layer in 4 chunks of 64 columns: h1pre = u W1[:, chunk]
//     (16 x 64 float32, 32 registers), + b1, GELU, rounded to bf16; the C
//     fragments of n-tiles 2s and 2s + 1 are exactly the A fragment of
//     k-slice s of the next product, so h goes into h W2[chunk, :] from the
//     registers and never touches shared memory;
//   * y (16 x 128 float32, 64 registers) accumulates over the chunks; the
//     epilogue adds b2, then x from xa (the C fragments of n-tiles 2s, 2s + 1
//     cover the pairs of k-slice s of the A fragment), rounds once, and
//     writes whole 32-byte sectors after a quad exchange (store_frag_rows).
//
// The last strip is masked (its rows past M zero-filled, not stored), so M
// needs no padding.

constexpr int C = 128;          // stream width = LayerNorm width
constexpr int HD = 256;         // hidden width (mlp_ratio 2)
constexpr int RW = 8;           // warps a block
constexpr int HC = 64;          // hidden columns a chunk
constexpr int LDW1 = HD + 8;    // staged W1 [C][LDW1]
constexpr int LDW2 = C + 8;     // staged W2 [HD][LDW2]
constexpr int LDX = C + 8;      // a warp's x buffer [16][LDX]
constexpr float kLnEps = 1e-6f;

// shared memory of premlp_rows: W1, W2, the vectors gamma | beta | b1 | b2
// (float32), two x buffers a warp
constexpr size_t kRowsSmem =
    (size_t)C * LDW1 * 2 + (size_t)HD * LDW2 * 2 + (size_t)(3 * C + HD) * 4 +
    (size_t)RW * 2 * 16 * LDX * 2;

struct RowParams {
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

// acc[NT][4] += A * B[k][n] (row-major in shared memory, row stride ldb)
// over NT 8-column tiles, A in registers: a[ks] the fragment of contraction
// columns 16 ks .. 16 ks + 15
template <int KS, int NT>
__device__ __forceinline__ void mma_a_regs(float acc[NT][4],
                                           const uint32_t a[KS][4],
                                           const bf16* b, int ldb) {
    const int lane = threadIdx.x & 31;
    const bf16* bp =
        b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + ((lane >> 4) << 3);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int q = 0; q < NT / 2; ++q) {
            uint32_t bfr[4];
            ldsm_x4_t(bfr, bp + ks * 16 * ldb + q * 16);
            mma16816(acc[2 * q], a[ks], bfr[0], bfr[1]);
            mma16816(acc[2 * q + 1], a[ks], bfr[2], bfr[3]);
        }
}

__global__ void __launch_bounds__(RW * 32, 1) premlp_rows(RowParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sW1 = reinterpret_cast<bf16*>(smem);
    bf16* sW2 = sW1 + (size_t)C * LDW1;
    float* sGam = reinterpret_cast<float*>(sW2 + (size_t)HD * LDW2);
    float* sBet = sGam + C;
    float* sB1 = sBet + C;
    float* sB2 = sB1 + HD;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = lane & 3;
    bf16* sX = reinterpret_cast<bf16*>(sB2 + C) + (size_t)warp * 2 * 16 * LDX;

    // ---- the weights and vectors, once; the warp's first two strips ----
    for (int i = threadIdx.x; i < C * (HD / 8); i += RW * 32) {
        const int r = i / (HD / 8), ch = i - r * (HD / 8);
        cp_async16(sW1 + r * LDW1 + ch * 8, p.w1 + (size_t)r * HD + ch * 8,
                   true);
    }
    for (int i = threadIdx.x; i < HD * (C / 8); i += RW * 32) {
        const int r = i / (C / 8), ch = i - r * (C / 8);
        cp_async16(sW2 + r * LDW2 + ch * 8, p.w2 + (size_t)r * C + ch * 8,
                   true);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < C; i += RW * 32) {
        sGam[i] = p.gamma[i];
        sBet[i] = p.beta[i];
        sB2[i] = p.b2[i];
    }
    for (int i = threadIdx.x; i < HD; i += RW * 32) sB1[i] = p.b1[i];
    const int n_strips = (p.M + 15) / 16;
    const int stride = gridDim.x * RW;
    int s = blockIdx.x * RW + warp;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int sk = s + k * stride;
        if (sk < n_strips)
            warp_load_rows(sX + k * 16 * LDX, LDX, p.x, C, sk * 16,
                           min(16, p.M - sk * 16));
        cp_async_commit();
    }
    cp_async_wait<2>();              // the weights (this thread's copies)
    __syncthreads();

    for (int it = 0; s < n_strips; s += stride, ++it) {
        const int r0 = s * 16, nrow = min(16, p.M - r0);
        bf16* xb = sX + (it & 1) * 16 * LDX;
        cp_async_wait<1>();          // this strip's rows
        __syncwarp();
        uint32_t xa[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
            ldsm_x4(xa[ks], xb + (lane & 15) * LDX + ((lane >> 4) << 3) +
                                ks * 16);
        __syncwarp();
        if (s + 2 * stride < n_strips)
            warp_load_rows(xb, LDX, p.x, C, r0 + 2 * stride * 16,
                           min(16, p.M - r0 - 2 * stride * 16));
        cp_async_commit();

        // ---- LayerNorm: u = bf16(LN(x) gamma + beta), as A fragments ----
        // xa[ks][e]: row g + 8 (e & 1), columns 16 ks + 8 (e >> 1) + 2t, +1
        float sm[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 v = unpack_bf16(xa[ks][e]);
                sm[e & 1] += v.x + v.y;
                ss[e & 1] += v.x * v.x + v.y * v.y;
            }
        float mu[2], rstd[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            mu[hf] = quad_sum(sm[hf]) / (float)C;
            const float var =
                fmaxf(quad_sum(ss[hf]) / (float)C - mu[hf] * mu[hf], 0.0f);
            rstd[hf] = 1.0f / sqrtf(var + kLnEps);
        }
        uint32_t ua[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 16 * ks + 8 * (e >> 1) + 2 * t;
                const int hf = e & 1;
                const float2 v = unpack_bf16(xa[ks][e]);
                const float2 ga = *reinterpret_cast<const float2*>(sGam + col);
                const float2 be = *reinterpret_cast<const float2*>(sBet + col);
                ua[ks][e] = pack_bf16((v.x - mu[hf]) * rstd[hf] * ga.x + be.x,
                                      (v.y - mu[hf]) * rstd[hf] * ga.y + be.y);
            }

        // ---- y = h W2 over 4 chunks of 64 hidden columns ----
        float y[16][4];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) y[nt][e] = 0.0f;
#pragma unroll 1
        for (int h0 = 0; h0 < HD; h0 += HC) {
            float hacc[HC / 8][4];
#pragma unroll
            for (int nt = 0; nt < HC / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.0f;
            mma_a_regs<C / 16, HC / 8>(hacc, ua, sW1 + h0, LDW1);
            // h = bf16(gelu(h1pre + b1)): C fragments of n-tiles 2s, 2s + 1
            // -> the A fragment of k-slice s
            uint32_t ha[HC / 16][4];
#pragma unroll
            for (int nt = 0; nt < HC / 8; ++nt) {
                const float2 bb = *reinterpret_cast<const float2*>(
                    sB1 + h0 + nt * 8 + 2 * t);
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    ha[nt >> 1][((nt & 1) << 1) + hf] =
                        pack_bf16(gelu_tanh(hacc[nt][2 * hf] + bb.x),
                                  gelu_tanh(hacc[nt][2 * hf + 1] + bb.y));
            }
            mma_a_regs<HC / 16, C / 8>(y, ha, sW2 + (size_t)h0 * LDW2, LDW2);
        }

        // ---- out = bf16((y + b2) + x): b2, then x, in float32 ----
        uint32_t oa[8][4];
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
            const float2 bb =
                *reinterpret_cast<const float2*>(sB2 + nt * 8 + 2 * t);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const float2 xv =
                    unpack_bf16(xa[nt >> 1][((nt & 1) << 1) + hf]);
                put_a(oa, nt, hf,
                      pack_bf16((y[nt][2 * hf] + bb.x) + xv.x,
                                (y[nt][2 * hf + 1] + bb.y) + xv.y));
            }
        }
        store_frag_rows(p.out, C, r0, nrow, oa, 8);
    }
    cp_async_wait<0>();
}


// ================== K5b at C = 128: block row tiles ========================
//
// The tile's rows shared by the block's 8 warps (mma_sm90.cuh: Blk,
// block_product), the weights resident in shared memory where they fit
// (32-row tiles on the H100), otherwise streamed through the ring; the
// tile's rows of x and dout come in by cp.async, the next tile's while this
// one computes where there is room for two buffers (tile_plan). Wider C
// runs as passes (the last section), which the H100 runs faster from C =
// 256 on in both directions.
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
//   the row pass (premlp_tiles): per tile the LayerNorm and u16 W1 + b1 are
//     recomputed once; for each pass of hidden columns the warp forms gelu
//     and gelu' from one exp (registers), then g16 W2^T for the same
//     columns, so gelu' never leaves the registers; dh1pre16 stays in shared
//     memory as the A operand of du = dh1pre16 W1^T; the LayerNorm backward
//     runs a row a warp. It writes u16, h16 and dh1pre16 as bf16 rows (the
//     TPU kernel rounds all of them to bf16 before its weight products, so
//     storing them moves no rounding point) and keeps the float32 column
//     sums db1 (shared memory), db2, dgamma, dbeta (each lane's columns,
//     registers) over all its tiles, written once a block;
//   the weight-gradient pass (fused_mlp_wgrad through gfvgn_wgrad): per batch
//     lane dW1 = u16^T dh1pre16 and dW2 = h16^T g16;
//   lane_reduce: each lane's weight gradients rounded to bf16, lanes and
//     blocks summed in a fixed order (no atomics: the same bits every run).

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
    const bf16* dout;     // [M, C]
    bf16* dx;             // [M, C]
    bf16* us;             // [M, C]   u16 rows for the weight-gradient pass
    bf16* hs;             // [M, 2C]  h16 rows
    bf16* dhs;            // [M, 2C]  dh1pre16 rows
    float* colsum;        // [grid][5C]: db1 (2C) | db2 | dgamma | dbeta
    int M;
    TilePlan L;           // the tile and its shared-memory layout
};

// shared-memory layout of a tile of tm rows; returns the total bytes
size_t tile_layout(int tm, int resident, int nbuf, TilePlan& L) {
    const int wr = tm / 16;
    size_t o = 0;
    L.o_w = (int)o;
    o += align128(resident ? ((size_t)C * (HD + 8) + (size_t)HD * (C + 8)) * 2
                           : (size_t)2 * ring_slot((8 / wr) * 64) * 2);
    L.o_x = (int)o;
    o += align128((size_t)nbuf * tm * (C + 8) * 2);
    L.o_u = (int)o;
    o += align128((size_t)tm * (C + 8) * 2);
    L.o_h = (int)o;
    o += align128((size_t)tm * (HD + 8) * 2);
    L.o_g = (int)o;
    o += align128((size_t)nbuf * tm * (C + 8) * 2);
    L.o_du = (int)o;
    o += align128((size_t)tm * (C + 4) * 4);
    L.o_stat = (int)o;
    o += align128((size_t)tm * 2 * 4);
    L.o_red = (int)o;
    o += align128((size_t)wr * HD * 4);
    L.o_acc = (int)o;
    o += align128((size_t)HD * 4);
    // the end reuses the start for [8 warps][3][C] floats
    const size_t fin = (size_t)8 * 3 * C * 4;
    return o > fin ? o : fin;
}

__global__ void __launch_bounds__(BK_THREADS, 1) premlp_tiles(TileParams p) {
    constexpr int LDC_ = C + 8, LDH_ = HD + 8, LDU_ = C + 4;
    extern __shared__ __align__(128) unsigned char smem[];
    const bool res = p.L.resident != 0;
    bf16* sW1 = reinterpret_cast<bf16*>(smem + p.L.o_w);
    bf16* sW2 = sW1 + (size_t)C * LDH_;
    const Blk b = make_blk(p.L.tm, sW1);
    // W1 [C][2C] is [k][n] for u W1 and [n][k] for dh W1^T; W2 [2C][C] is
    // [n][k] for g W2^T: one source each
    const WSrc W1{p.w1, HD, res ? sW1 : nullptr, LDH_};
    const WSrc W2{p.w2, C, res ? sW2 : nullptr, LDC_};
    bf16* sX = reinterpret_cast<bf16*>(smem + p.L.o_x);
    bf16* sU = reinterpret_cast<bf16*>(smem + p.L.o_u);
    bf16* sH = reinterpret_cast<bf16*>(smem + p.L.o_h);   // dh1pre16
    bf16* sG = reinterpret_cast<bf16*>(smem + p.L.o_g);
    float* sDU = reinterpret_cast<float*>(smem + p.L.o_du);
    float* sStat = reinterpret_cast<float*>(smem + p.L.o_stat);
    float* sRed = reinterpret_cast<float*>(smem + p.L.o_red);
    float* sAcc = reinterpret_cast<float*>(smem + p.L.o_acc);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tm = p.L.tm;

    if (res) {
        stage_matrix(sW1, LDH_, p.w1, C, HD);
        stage_matrix(sW2, LDC_, p.w2, HD, C);
    }
    for (int i = threadIdx.x; i < HD; i += BK_THREADS) sAcc[i] = 0.0f;
    const int n_tiles = (p.M + tm - 1) / tm;
    auto load_rows = [&](int tile, int buf) {
        const int r0 = tile * tm, nrow = min(tm, p.M - r0);
        load_tile_rows(sX + (size_t)buf * tm * LDC_, LDC_, p.x, C, r0, nrow,
                       tm);
        load_tile_rows(sG + (size_t)buf * tm * LDC_, LDC_, p.dout, C, r0,
                       nrow, tm);
    };
    if ((int)blockIdx.x < n_tiles) load_rows(blockIdx.x, 0);
    cp_async_commit();

    // this lane's columns of the row-a-warp stages: 4 lane + j
    float pg[4], pb[4], pd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pg[j] = pb[j] = pd[j] = 0.0f;

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
            float v[4], s = 0.0f, ss = 0.0f;
            load_bf16x4(xb + row * LDC_ + 4 * lane, v);
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
            const float mu = s / (float)C;
            const float var = fmaxf(ss / (float)C - mu * mu, 0.0f);
            const float rstd = 1.0f / sqrtf(var + kLnEps);
            if (lane == 0) {
                sStat[2 * row] = mu;
                sStat[2 * row + 1] = rstd;
            }
            const int col = 4 * lane;
            const float4 ga = *reinterpret_cast<const float4*>(p.gamma + col);
            const float4 be = *reinterpret_cast<const float4*>(p.beta + col);
            const float u[4] = {(v[0] - mu) * rstd * ga.x + be.x,
                                (v[1] - mu) * rstd * ga.y + be.y,
                                (v[2] - mu) * rstd * ga.z + be.z,
                                (v[3] - mu) * rstd * ga.w + be.w};
            store_bf16x4(sU + row * LDC_ + col, u);
            if (row < nrow)
                store_bf16x4(p.us + (size_t)(r0 + row) * C + col, u);
        }
        __syncthreads();

        // ---- per pass of hidden columns: h16 and gelu'(h1pre), then
        //      dh1pre = (g16 W2^T) gelu' for the same columns ----
        float acc[8][4], gk[8][4];
        for (int n0 = 0; n0 < HD; n0 += b.pw) {
            const int nv = block_product<false>(b, acc, sU, LDC_, C, W1, n0,
                                                HD);
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
                            store_bf16x2(p.hs + (size_t)(r0 + row) * HD + col,
                                         h0, h1);
                    }
                }
            }
            block_product<true>(b, acc, gb, LDC_, C, W2, n0, HD);
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
                        *reinterpret_cast<uint32_t*>(sH + row * LDH_ + col) =
                            dv;
                        if (row < nrow)
                            *reinterpret_cast<uint32_t*>(
                                p.dhs + (size_t)(r0 + row) * HD + col) = dv;
                    }
                    col_sum_store(ps[0], ps[1], b.g, sRed + b.wrow * HD + col);
                }
            }
        }
        __syncthreads();
        // the tile's db1, row warps in order
        for (int i = threadIdx.x; i < HD; i += BK_THREADS) {
            float s = 0.0f;
            for (int w = 0; w < b.wr; ++w) s += sRed[w * HD + i];
            sAcc[i] += s;
        }
        // ---- du = dh1pre16 W1^T ----
        for (int n0 = 0; n0 < C; n0 += b.pw) {
            const int nv = block_product<true>(b, acc, sH, LDH_, HD, W1, n0,
                                               C);
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
            const int col = 4 * lane;
            float xv[4], gv[4], xh[4], dxh[4];
            float s1 = 0.0f, s2 = 0.0f;
            load_bf16x4(xb + row * LDC_ + col, xv);
            load_bf16x4(gb + row * LDC_ + col, gv);
            const float4 du = *reinterpret_cast<const float4*>(sDU + row * LDU_ + col);
            const float4 ga = *reinterpret_cast<const float4*>(p.gamma + col);
            const float d[4] = {du.x, du.y, du.z, du.w};
            const float gm[4] = {ga.x, ga.y, ga.z, ga.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                xh[j] = (xv[j] - mu) * rstd;
                dxh[j] = d[j] * gm[j];
                s1 += dxh[j];
                s2 += dxh[j] * xh[j];
                pg[j] += d[j] * xh[j];
                pb[j] += d[j];
                pd[j] += gv[j];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                s1 += __shfl_xor_sync(0xffffffffu, s1, off);
                s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            }
            const float m1 = s1 / (float)C, m2 = s2 / (float)C;
            float dx[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                dx[j] = rstd * ((dxh[j] - m1) - xh[j] * m2) + gv[j];
            store_bf16x4(p.dx + (size_t)(r0 + row) * C + col, dx);
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* cs = p.colsum + (size_t)blockIdx.x * 5 * C;
    for (int i = threadIdx.x; i < HD; i += BK_THREADS) cs[i] = sAcc[i];
    __syncthreads();
    // db2 | dgamma | dbeta: the warps' lane columns, warps in order
    float* fin = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int col = 4 * lane + j;
        fin[(warp * 3 + 0) * C + col] = pd[j];
        fin[(warp * 3 + 1) * C + col] = pg[j];
        fin[(warp * 3 + 2) * C + col] = pb[j];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * C; i += BK_THREADS) {
        const int kind = i / C, col = i - kind * C;
        float s = 0.0f;
        for (int w = 0; w < 8; ++w) s += fin[(w * 3 + kind) * C + col];
        cs[HD + i] = s;
    }
}

// the tile plan of the C = 128 backward, or cudaErrorInvalidValue: weights
// resident before streamed, larger tiles first, two row buffers before one
int tile_plan(int m, TilePlan& P) {
    int max_smem = 0, n_sm = 0;
    const int err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    for (int res = 1; res >= 0; --res)
        for (int tm = 64; tm >= 16; tm >>= 1)
            for (int nbuf = 2; nbuf >= 1; --nbuf) {
                const size_t total = tile_layout(tm, res, nbuf, P);
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
// sums and the weight-gradient pass's partials; the passes also keep du
// (float32) and the rows' LayerNorm statistics
struct BwdWs {
    size_t o_us, o_hs, o_dhs, o_colsum, o_du, o_stat, o_part, bytes;
    gfvgn::WgParams q;
};

void bwd_workspace(int c, int m, int lanes, int grid, int n_sm, bool passes,
                   BwdWs& W) {
    const int hd = 2 * c;
    size_t o = 0;
    W.o_us = o; o += align128((size_t)m * c * 2);
    W.o_hs = o; o += align128((size_t)m * hd * 2);
    W.o_dhs = o; o += align128((size_t)m * hd * 2);
    W.o_colsum = o; o += align128((size_t)grid * 5 * c * 4);
    W.o_du = o; o += passes ? align128((size_t)m * c * 4) : 0;
    W.o_stat = o; o += passes ? align128((size_t)m * 2 * 4) : 0;
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

// ==================== K5f and K5b from C = 256 on: passes ==================
//
// From C = 256 on, every width C % 128 == 0, the branch runs as passes
// through device memory, with the TPU kernel's rounding points:
//   1. premlp_ln_rows: u16 = bf16(LN(x) gamma + beta), a warp a row,
//      statistics in float32 (kept for the backward);
//   2. premlp_pass<PASS_H>: h16 = bf16(gelu(u16 W1 + b1)); the backward's
//      premlp_pass<PASS_HB> also forms dh1pre = (g16 W2^T) gelu'(h1pre)
//      for the same columns (gelu' from the same exp, in registers),
//      writes dh1pre16 and keeps the tile's float32 column sums (db1);
//   3. forward premlp_pass<PASS_Y>: out = bf16((h16 W2 + b2) + x), float32
//      accumulation and one rounding; backward premlp_pass<PASS_DU>: du =
//      dh1pre16 W1^T kept in float32 in device memory, then
//      premlp_ln_bwd_rows (dx, a warp a row), premlp_col_sums (db2,
//      dgamma, dbeta per 64-row tile), the weight-gradient pass and the
//      fixed-order reductions as on the tiles.
// Each product is a block's 64 x 128 output tile with both operands
// streamed through the ring in chunks of 32 contraction columns
// (mma_sm90.cuh, pass_product): 32 KB of shared memory at any C, so every
// width the JAX package fuses runs. On the H100 (20,480 and 81,920 rows)
// the passes beat the block row tiles that ran C 256 to 1024 before, in
// both directions and at every width: 0.47 against 0.60 ms forward and
// 1.28 against 1.41 backward at C 256 on 81,920 rows, 1.43 against 3.22
// and 3.74 against 7.08 at C 1024 on 20,480; the tiles keep the C = 128
// backward (0.39 against 0.58 as passes).

constexpr int PASS_TM = 64;                 // rows of a pass tile (pw 128)
constexpr int PASS_PW = 128;

enum PassMode { PASS_H = 0, PASS_HB = 1, PASS_Y = 2, PASS_DU = 3 };

// the pass kernels' shared memory: the ring, the row warps' column sums
inline size_t pass_smem() {
    return (size_t)2 * pass_slot(PASS_TM, PASS_PW) * 2 +
           (size_t)(PASS_TM / 16) * PASS_PW * 4;
}

struct PassParams {
    const bf16* x;        // [M, C]
    const bf16* w1;       // [C, 2C]
    const float* b1;
    const bf16* w2;       // [2C, C]
    const float* b2;
    const bf16* dout;     // backward [M, C]
    bf16* out;            // forward [M, C]
    const bf16* us;       // [M, C]   u16
    bf16* hs;             // [M, 2C]  h16
    bf16* dhs;            // [M, 2C]  dh1pre16
    float* du;            // [M, C]   du, float32
    float* colsum;        // [row tiles][5C]: db1 (2C) | db2 | dgamma | dbeta
    int M, c;
};

// u16 = bf16(LN(x) gamma + beta), a warp a row (lane columns 128 k + 4 lane
// + j, as the tiles'); mean and rstd into stat [M][2] where given
__global__ void __launch_bounds__(BK_THREADS) premlp_ln_rows(
        const bf16* __restrict__ x, const float* __restrict__ gamma,
        const float* __restrict__ beta, bf16* __restrict__ us,
        float* __restrict__ stat, int M, int c) {
    const int row = blockIdx.x * (BK_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const bf16* xr = x + (size_t)row * c;
    float s = 0.0f, ss = 0.0f;
    for (int k = 4 * lane; k < c; k += 128) {
        float v[4];
        load_bf16x4(xr + k, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s += v[j];
            ss += v[j] * v[j];
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float mu = s / (float)c;
    const float var = fmaxf(ss / (float)c - mu * mu, 0.0f);
    const float rstd = 1.0f / sqrtf(var + kLnEps);
    if (stat != nullptr && lane == 0) {
        stat[2 * row] = mu;
        stat[2 * row + 1] = rstd;
    }
    for (int k = 4 * lane; k < c; k += 128) {
        float v[4];
        load_bf16x4(xr + k, v);
        const float4 ga = *reinterpret_cast<const float4*>(gamma + k);
        const float4 be = *reinterpret_cast<const float4*>(beta + k);
        const float u[4] = {(v[0] - mu) * rstd * ga.x + be.x,
                            (v[1] - mu) * rstd * ga.y + be.y,
                            (v[2] - mu) * rstd * ga.z + be.z,
                            (v[3] - mu) * rstd * ga.w + be.w};
        store_bf16x4(us + (size_t)row * c + k, u);
    }
}

// one 64 x 128 output tile of a pass (grid: row tiles, column passes)
template <int MODE>
__global__ void __launch_bounds__(BK_THREADS, 2) premlp_pass(PassParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Blk b = make_blk(PASS_TM, reinterpret_cast<bf16*>(smem));
    float* sRed = reinterpret_cast<float*>(
        smem + (size_t)2 * pass_slot(PASS_TM, PASS_PW) * 2);
    const int c = p.c, hd = 2 * c;
    const int r0 = blockIdx.x * PASS_TM, nrow = min(PASS_TM, p.M - r0);
    const int n0 = blockIdx.y * b.pw;
    float acc[8][4];
    // the thread's (row, column) of element (nt, hf) of the warp's block
    auto row_of = [&](int hf) { return b.wrow * 16 + b.g + 8 * hf; };
    auto col_of = [&](int nt) { return n0 + b.wcol * 64 + nt * 8 + 2 * b.t; };

    if constexpr (MODE == PASS_Y) {
        // out = bf16((h16 W2 + b2) + x)
        const WSrc W2{p.w2, c, nullptr, 0};
        const int nv = pass_product<false>(b, acc, p.hs, hd, r0, nrow, hd,
                                           W2, n0, c);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nv) continue;
            const int col = col_of(nt);
            const float2 bb = *reinterpret_cast<const float2*>(p.b2 + col);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = row_of(hf);
                if (row >= nrow) continue;
                const size_t at = (size_t)(r0 + row) * c + col;
                const float2 xv = load_bf16x2(p.x + at);
                store_bf16x2(p.out + at, (acc[nt][2 * hf] + bb.x) + xv.x,
                             (acc[nt][2 * hf + 1] + bb.y) + xv.y);
            }
        }
    } else if constexpr (MODE == PASS_DU) {
        // du = dh1pre16 W1^T, W1 [C][2C] read as [n][k]
        const WSrc W1t{p.w1, hd, nullptr, 0};
        const int nv = pass_product<true>(b, acc, p.dhs, hd, r0, nrow, hd,
                                          W1t, n0, c);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nv) continue;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = row_of(hf);
                if (row < nrow)
                    *reinterpret_cast<float2*>(
                        p.du + (size_t)(r0 + row) * c + col_of(nt)) =
                        make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
            }
        }
    } else {
        // h16 = bf16(gelu(u16 W1 + b1))
        const WSrc W1{p.w1, hd, nullptr, 0};
        const int nv = pass_product<false>(b, acc, p.us, c, r0, nrow, c, W1,
                                           n0, hd);
        float gk[MODE == PASS_HB ? 8 : 1][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (nt >= nv) continue;
            const int col = col_of(nt);
            const float2 bb = *reinterpret_cast<const float2*>(p.b1 + col);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = row_of(hf);
                float h0, h1;
                if constexpr (MODE == PASS_HB) {
                    h0 = gelu_and_grad(acc[nt][2 * hf] + bb.x, gk[nt][2 * hf]);
                    h1 = gelu_and_grad(acc[nt][2 * hf + 1] + bb.y,
                                       gk[nt][2 * hf + 1]);
                } else {
                    h0 = gelu_tanh(acc[nt][2 * hf] + bb.x);
                    h1 = gelu_tanh(acc[nt][2 * hf + 1] + bb.y);
                }
                if (row < nrow)
                    store_bf16x2(p.hs + (size_t)(r0 + row) * hd + col, h0, h1);
            }
        }
        if constexpr (MODE == PASS_HB) {
            // dh1pre = (g16 W2^T) gelu'(h1pre), W2 [2C][C] read as [n][k]
            const WSrc W2t{p.w2, c, nullptr, 0};
            pass_product<true>(b, acc, p.dout, c, r0, nrow, c, W2t, n0, hd);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt >= nv) continue;
                const int col = col_of(nt);
                float ps[2] = {0.0f, 0.0f};
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int row = row_of(hf);
                    if (row >= nrow) continue;
                    const float d0 = acc[nt][2 * hf] * gk[nt][2 * hf];
                    const float d1 = acc[nt][2 * hf + 1] * gk[nt][2 * hf + 1];
                    ps[0] += d0;
                    ps[1] += d1;
                    *reinterpret_cast<uint32_t*>(
                        p.dhs + (size_t)(r0 + row) * hd + col) =
                        pack_bf16(d0, d1);
                }
                col_sum_store(ps[0], ps[1], b.g,
                              sRed + b.wrow * PASS_PW + col - n0);
            }
            __syncthreads();
            // the tile's db1, row warps in order
            for (int i = threadIdx.x; i < b.pw; i += BK_THREADS) {
                if (n0 + i >= hd) break;
                float sum = 0.0f;
                for (int w = 0; w < b.wr; ++w) sum += sRed[w * PASS_PW + i];
                p.colsum[(size_t)blockIdx.x * 5 * c + n0 + i] = sum;
            }
        }
    }
    cp_async_wait<0>();
}

// dx = bf16(rstd ((du gamma - mean(du gamma)) - xhat mean(du gamma xhat))
// + g), a warp a row, du float32 from device memory
__global__ void __launch_bounds__(BK_THREADS) premlp_ln_bwd_rows(
        const bf16* __restrict__ x, const float* __restrict__ gamma,
        const bf16* __restrict__ dout, const float* __restrict__ du,
        const float* __restrict__ stat, bf16* __restrict__ dx, int M,
        int c) {
    const int row = blockIdx.x * (BK_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= M) return;
    const float mu = stat[2 * row], rstd = stat[2 * row + 1];
    const size_t r0 = (size_t)row * c;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = 4 * lane; k < c; k += 128) {
        float xv[4];
        load_bf16x4(x + r0 + k, xv);
        const float4 d = *reinterpret_cast<const float4*>(du + r0 + k);
        const float4 ga = *reinterpret_cast<const float4*>(gamma + k);
        const float dd[4] = {d.x, d.y, d.z, d.w}, gm[4] = {ga.x, ga.y, ga.z, ga.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float xh = (xv[j] - mu) * rstd, dxh = dd[j] * gm[j];
            s1 += dxh;
            s2 += dxh * xh;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = s1 / (float)c, m2 = s2 / (float)c;
    for (int k = 4 * lane; k < c; k += 128) {
        float xv[4], gv[4], out[4];
        load_bf16x4(x + r0 + k, xv);
        load_bf16x4(dout + r0 + k, gv);
        const float4 d = *reinterpret_cast<const float4*>(du + r0 + k);
        const float4 ga = *reinterpret_cast<const float4*>(gamma + k);
        const float dd[4] = {d.x, d.y, d.z, d.w}, gm[4] = {ga.x, ga.y, ga.z, ga.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float xh = (xv[j] - mu) * rstd, dxh = dd[j] * gm[j];
            out[j] = rstd * ((dxh - m1) - xh * m2) + gv[j];
        }
        store_bf16x4(dx + r0 + k, out);
    }
}

// a 64-row tile's float32 column sums, rows in order: db2 = sum g, dgamma
// = sum du xhat, dbeta = sum du -> colsum[tile][2C ..]
__global__ void __launch_bounds__(BK_THREADS) premlp_col_sums(
        const bf16* __restrict__ x, const bf16* __restrict__ dout,
        const float* __restrict__ du, const float* __restrict__ stat,
        float* __restrict__ colsum, int M, int c) {
    const int r0 = blockIdx.x * PASS_TM, nrow = min(PASS_TM, M - r0);
    float* cs = colsum + (size_t)blockIdx.x * 5 * c + 2 * c;
    for (int col = threadIdx.x; col < c; col += BK_THREADS) {
        float pd = 0.0f, pg = 0.0f, pb = 0.0f;
        for (int r = 0; r < nrow; ++r) {
            const size_t at = (size_t)(r0 + r) * c + col;
            const float xh = (__bfloat162float(x[at]) - stat[2 * (r0 + r)]) *
                             stat[2 * (r0 + r) + 1];
            const float d = du[at];
            pd += __bfloat162float(dout[at]);
            pg += d * xh;
            pb += d;
        }
        cs[col] = pd;
        cs[c + col] = pg;
        cs[2 * c + col] = pb;
    }
}

template <int MODE>
int launch_pass(const PassParams& p, int n, cudaStream_t st) {
    const dim3 grid((p.M + PASS_TM - 1) / PASS_TM, n / PASS_PW);
    premlp_pass<MODE><<<grid, BK_THREADS, pass_smem(), st>>>(p);
    return (int)cudaGetLastError();
}

// How a call runs: at C = 128 the forward on the strip kernel and the
// backward on the block row tiles (P), every wider C as passes;
// cudaErrorInvalidValue where C is not a multiple of 128.
enum PremlpForm { FORM_ROWS = 0, FORM_TILES = 1, FORM_PASSES = 2 };

int premlp_form(int c, int m, bool bwd, TilePlan& P, int& form) {
    int max_smem = 0, n_sm = 0;
    const int err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    if (c < 128 || c % 128 != 0 || m < 0) return (int)cudaErrorInvalidValue;
    if (c == C) {
        form = bwd ? FORM_TILES : FORM_ROWS;
        if (bwd) return tile_plan(m, P);
        return kRowsSmem <= (size_t)max_smem ? 0
                                             : (int)cudaErrorInvalidValue;
    }
    form = FORM_PASSES;
    P.grid = (m + PASS_TM - 1) / PASS_TM;    // the column sums' row tiles
    if (P.grid < 1) P.grid = 1;
    return pass_smem() <= (size_t)max_smem ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of workspace K5f (backward = 0) or K5b needs for x [M, C], hidden
// width 2C, M rows in `lanes` equal batch lanes; -1 where no kernel takes
// the shape (C not a multiple of 128). The forward needs none on the strip
// kernel; its passes keep u16 and h16.
extern "C" long long gfvgn_premlp_workspace(int c, int m, int lanes,
                                            int backward) {
    TilePlan P;
    int form = 0;
    if (premlp_form(c, m, backward != 0, P, form) != 0) return -1;
    if (!backward)
        return form == FORM_PASSES
            ? (long long)(align128((size_t)m * c * 2) +
                          align128((size_t)m * 2 * c * 2))
            : 0;
    if (lanes < 1 || lanes > 65535 || m % lanes != 0) return -1;
    int max_smem = 0, n_sm = 0;
    if (device_limits(max_smem, n_sm) != 0) return -1;
    BwdWs W;
    bwd_workspace(c, m, lanes, P.grid, n_sm, form == FORM_PASSES, W);
    return (long long)W.bytes;
}

extern "C" int gfvgn_fused_premlp(const void* x, const void* gamma,
                                  const void* beta, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int c, int m,
                                  void* workspace, void* stream) {
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    TilePlan P;
    int form = 0;
    int err = premlp_form(c, m, false, P, form);
    if (err != 0) return err;
    if (m == 0) return 0;
    if (form == FORM_ROWS) {
        // the C = 128 strip kernel
        int max_smem = 0, n_sm = 0;
        err = device_limits(max_smem, n_sm);
        if (err != 0) return err;
        RowParams p;
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
            premlp_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kRowsSmem);
        if (e != cudaSuccess) return (int)e;
        const int blocks = ((m + 15) / 16 + RW - 1) / RW;
        premlp_rows<<<blocks < n_sm ? blocks : n_sm, RW * 32, kRowsSmem,
                      st>>>(p);
        return (int)cudaGetLastError();
    }
    // the passes: u16 and h16 in the workspace
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    PassParams p{};
    p.x = static_cast<const bf16*>(x);
    p.w1 = static_cast<const bf16*>(w1);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.out = static_cast<bf16*>(out);
    bf16* us = reinterpret_cast<bf16*>(ws);
    p.us = us;
    p.hs = reinterpret_cast<bf16*>(ws + align128((size_t)m * c * 2));
    p.M = m;
    p.c = c;
    premlp_ln_rows<<<(m + 7) / 8, BK_THREADS, 0, st>>>(
        p.x, static_cast<const float*>(gamma),
        static_cast<const float*>(beta), us, nullptr, m, c);
    err = (int)cudaGetLastError();
    if (err == 0) err = launch_pass<PASS_H>(p, 2 * c, st);
    if (err == 0) err = launch_pass<PASS_Y>(p, c, st);
    return err;
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
    int form = 0;
    int err = premlp_form(c, m, true, P, form);
    if (err != 0) return err;
    if (lanes < 1 || lanes > 65535 || m % lanes != 0)
        return (int)cudaErrorInvalidValue;
    int max_smem = 0, n_sm = 0;
    err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int hd = 2 * c;
    if (m == 0)
        return (int)cudaMemsetAsync(
            total, 0, ((size_t)2 * c * hd + (size_t)5 * c) * 4, st);
    BwdWs W;
    bwd_workspace(c, m, lanes, P.grid, n_sm, form == FORM_PASSES, W);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    bf16* us = reinterpret_cast<bf16*>(ws + W.o_us);
    bf16* hs = reinterpret_cast<bf16*>(ws + W.o_hs);
    bf16* dhs = reinterpret_cast<bf16*>(ws + W.o_dhs);
    float* colsum = reinterpret_cast<float*>(ws + W.o_colsum);
    if (form == FORM_PASSES) {
        float* stat = reinterpret_cast<float*>(ws + W.o_stat);
        PassParams p{};
        p.x = static_cast<const bf16*>(x);
        p.w1 = static_cast<const bf16*>(w1);
        p.b1 = static_cast<const float*>(b1);
        p.w2 = static_cast<const bf16*>(w2);
        p.dout = static_cast<const bf16*>(dout);
        p.us = us;
        p.hs = hs;
        p.dhs = dhs;
        p.du = reinterpret_cast<float*>(ws + W.o_du);
        p.colsum = colsum;
        p.M = m;
        p.c = c;
        const int row_blocks = (m + 7) / 8;
        premlp_ln_rows<<<row_blocks, BK_THREADS, 0, st>>>(
            p.x, static_cast<const float*>(gamma),
            static_cast<const float*>(beta), us, stat, m, c);
        err = (int)cudaGetLastError();
        if (err == 0) err = launch_pass<PASS_HB>(p, hd, st);
        if (err == 0) err = launch_pass<PASS_DU>(p, c, st);
        if (err != 0) return err;
        premlp_ln_bwd_rows<<<row_blocks, BK_THREADS, 0, st>>>(
            p.x, static_cast<const float*>(gamma), p.dout, p.du, stat,
            static_cast<bf16*>(dx), m, c);
        premlp_col_sums<<<P.grid, BK_THREADS, 0, st>>>(
            p.x, p.dout, p.du, stat, colsum, m, c);
    } else {
        TileParams p{};
        p.x = static_cast<const bf16*>(x);
        p.gamma = static_cast<const float*>(gamma);
        p.beta = static_cast<const float*>(beta);
        p.w1 = static_cast<const bf16*>(w1);
        p.b1 = static_cast<const float*>(b1);
        p.w2 = static_cast<const bf16*>(w2);
        p.dout = static_cast<const bf16*>(dout);
        p.dx = static_cast<bf16*>(dx);
        p.us = us;
        p.hs = hs;
        p.dhs = dhs;
        p.colsum = colsum;
        p.M = m;
        p.L = P;
        cudaError_t e = cudaFuncSetAttribute(
            premlp_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)P.smem);
        if (e != cudaSuccess) return (int)e;
        premlp_tiles<<<P.grid, BK_THREADS, P.smem, st>>>(p);
        err = (int)cudaGetLastError();
    }
    if (err != 0) return err;
    // dW1 = u16^T dh1pre16, dW2 = h16^T g16, per lane
    gfvgn::WgParams& q = W.q;
    q.job[0].a = us;
    q.job[0].b = dhs;
    q.job[1].a = hs;
    q.job[1].b = static_cast<const bf16*>(dout);
    q.part = reinterpret_cast<float*>(ws + W.o_part);
    float* tot = static_cast<float*>(total);
    err = gfvgn_wgrad(&q, lanes, tot, st);
    if (err != 0) return err;
    lane_reduce<<<(5 * c + 255) / 256, 256, 0, st>>>(
        colsum, tot + q.n_w, 5 * c, 0, 1, P.grid);
    return (int)cudaGetLastError();
}
