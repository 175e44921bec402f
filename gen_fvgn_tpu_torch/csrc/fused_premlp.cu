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
// Design at C = 128 (premlp_rows): K2's H = 128 row design, one warp a
// 16-row strip with every intermediate in registers (below). Wider C and
// the backward run on the block row tiles further down.
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
        case 1:     // the forward at C = 128 runs on premlp_rows
            if constexpr (BWD) return launch_tiles<1, true>(P, p, st);
            break;
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
    if (!backward && c == C) {
        // premlp_rows
        int max_smem = 0, n_sm = 0;
        if (device_limits(max_smem, n_sm) != 0 || m < 0 ||
            kRowsSmem > (size_t)max_smem)
            return -1;
        return 0;
    }
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
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (c == C) {
        // the C = 128 strip kernel
        int max_smem = 0, n_sm = 0;
        int err = device_limits(max_smem, n_sm);
        if (err != 0) return err;
        if (m < 0 || kRowsSmem > (size_t)max_smem)
            return (int)cudaErrorInvalidValue;
        if (m == 0) return 0;
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
    TilePlan P;
    int err = tile_plan(c, m, false, P);
    if (err != 0) return err;
    if (m == 0) return 0;
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
