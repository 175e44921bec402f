// K2 / K4f (forward) and K3 / K4b (backward): the fused 2-hidden-layer GELU
// MLP chain for sm_90a, at any hidden width H that is a multiple of 128.
//
//   LN = true  (K2, fused_mlp_ln):
//     out = LN(W3*gelu(W2*gelu(sum_i x_i*W1_i + pre + b1) + b2) + b3)*gamma + beta
//     with an optional residual epilogue (res_idx, res_dual)
//   LN = false (K4f, fused_mlp_noln):
//     out = W3*gelu(W2*gelu(x*W1 + b1) + b2) + b3, d_out <= 16 real columns
//
// Replaces the Pallas TPU kernels _make_fwd_kernel (K2, called at :385),
// _noln_fwd_kernel (K4f, :960), _make_bwd_kernel (K3, :421) and
// _noln_bwd_kernel (K4b, :980) of gen_fvgn_tpu/ops/fused_mlp.py.
//
// What bounds them on the H100: bytes. A row of the edge MLP costs about
// 100 k FLOP forward and 200 k backward against 0.5 to 3 KB of row streams,
// under the card's ~295 FLOP/byte bf16 ridge. Products run on the tensor
// cores (mma.sync m16n8k16, bf16 operands, float32 accumulators in
// registers; operands from shared memory by ldmatrix, a weight read as its
// transpose by the other ldmatrix form from the same staged copy). Every
// intermediate of a row stays on the SM. Three designs (make_plan picks
// one by the rule above it):
//
// * H = 128 (fused_mlp_fwd_rows, fused_mlp_bwd_rows), the nets' width: a
//   block stages W1, W2, W3 once; after that each of its 8 warps walks over its
//   own 16-row strips with a 16 x 128 accumulator and no block barrier. The C
//   fragments of two neighbouring 8-column tiles are the A fragment of the next
//   product's 16-deep slice, so h1, h2, dy16, dh2pre16 and dh1pre16 pass from
//   one product to the next as bf16 registers; LayerNorm rows are reduced by
//   quad shuffles; the next strip's x (and pre) rows come in by cp.async into
//   the warp's own buffers while it computes. Row outputs are written as whole
//   32-byte sectors (the four lanes of a quad trade their column pairs first:
//   4-byte pieces leave half sectors that the memory completes by a
//   read-modify-write).
// * H = 128 with LayerNorm, the forward where the rows' layout does not fit
//   (the segment engine's edge MLP, one 384-wide part: fused_mlp_fwd_wg),
//   the backward of every form with a first layer (fused_mlp_bwd_wg): the
//   same strips and epilogues, the products on warpgroups (wgmma, sm_90a)
//   that read the weights from one unpadded swizzled copy in shared
//   memory; x streamed in 64-column pieces. See the section of these
//   kernels below.
// * Wider H (fused_mlp_fwd_tiles, fused_mlp_bwd_tiles): tiles of TM rows (64;
//   32 or 16 where H leaves no room) shared by the block's 8 warps, WR = TM/16
//   warps over the rows and WC = 8/WR over the columns, each warp owning a 16 x
//   64 block of a pass of PW = WC*64 output columns; h1, h2 and dy16 in shared
//   memory; weights staged while they fit, otherwise streamed in chunks of KC
//   contraction rows through a STAGES-deep cp.async ring that runs across
//   products and tiles; LayerNorm rows through one exchange between the column
//   warps. Persistent blocks, grid = min(tiles, SMs).
//
// The backward is two hand-written passes and a fixed-order reduction:
//   pass 1 (fused_mlp_bwd_rows / fused_mlp_bwd_tiles): per tile the forward
//     is recomputed once; gelu' of h1pre and h2pre comes from that one
//     recomputation (registers and shared memory; for the wide tiles' later
//     column passes a per-block spill in device memory); then
//       LN:   g = dout0 (+ dout1 with res_dual); dgamma += g*xhat; dbeta += g;
//             dy = rstd*((g*gamma - mean(g*gamma)) - xhat*mean(g*gamma*xhat))
//       noLN: dy = dout (the d_out <= 16 real columns)
//       dh2pre = (dy16 W3^T) gelu'(h2pre); dh1pre = (dh2pre16 W2^T) gelu'(h1pre)
//       dpre = bf16(dh1pre); dx_i = bf16(dh1pre16 W1_i^T (+ the residual's
//       cotangent in float32))
//     It writes h1, h2, dy16, dh2pre16 and dh1pre16 as bf16 rows (the TPU
//     kernel rounds these five to bf16 before its weight-gradient products,
//     so storing them moves no rounding point), and keeps the float32 column
//     sums db1, db2, db3, dgamma, dbeta in shared memory over all its tiles,
//     written once per block.
//   pass 2 (fused_mlp_wgrad): per batch lane the weight gradients as products
//     dW1_i = x_i^T dh1pre16, dW2 = h1^T dh2pre16, dW3 = h2^T dy16; grid =
//     output tiles x row chunks x lanes, each block keeps its 128 x 128
//     float32 tile in registers over its whole chunk of rows and writes one
//     partial.
//   lane_reduce (lane_reduce.cuh) sums the partials in a fixed order and
//     rounds each lane's weight gradients to bf16 (the JAX package's kernels
//     run under a per-sample vmap and round per lane). No float atomics: two
//     runs give the same bits.
//
// Rounding points (the same as the TPU kernels'): float32 accumulation in
// each product; h1, h2 rounded to bf16 before the next product; biases,
// pre, GELU (tanh form, evaluated as x * sigmoid(2u)) and LayerNorm
// statistics (fast variance clamped at 0, eps 1e-6) in float32; out
// rounded to bf16 before the residual add, which is a bf16 add; dy, dh2pre,
// dh1pre rounded to bf16 before the products that take them.
//
// Plain C interface, no allocation (the caller passes a workspace of the
// size gfvgn_fused_mlp_workspace gives), launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int THREADS = 256;      // 8 warps
constexpr int KC = 32;            // contraction rows of a streamed weight chunk
constexpr int STAGES = 3;         // chunks in flight in the weight ring
constexpr int LDN = 24;           // staged, zero-padded noLN W3 [H][LDN]
constexpr int KR = gfvgn::WG_KR;  // rows of a pass-2 stage
constexpr int STAGES2 = 4;        // stages of the pass-2 ring
constexpr int LD2 = 136;          // pass-2 tile leading dim (128 + 8)
constexpr float kLnEps = 1e-6f;

// A weight operand of the tile's products. trans 0: W is [k][n] row-major
// (out = A*W); trans 1: W is [n][k] (out = A*W^T).
struct Prod {
    const bf16* w;    // first row of W in device memory
    int ldw;          // row stride of W (elements)
    int k;            // contraction length
    int n;            // output width
    int trans;
    int res_row;      // first row of W in the staged copy (resident mode)
};

constexpr int MAX_PROD = 7;

struct Common {
    const bf16* part[2];
    int width[2];
    int n_parts;
    int k1;              // width[0] + width[1]
    const bf16* pre;     // [M, H] or null
    const bf16* w1;      // [k1, H]
    const bf16* w2;      // [H, H]
    const bf16* w3;      // [H, d_out]
    const float* b1;
    const float* b2;
    const float* b3;
    const float* gamma;
    const float* beta;
    Prod prod[MAX_PROD];
    int n_prod;
    int cpt;             // streamed chunks a tile
    int M, H, d_out, dp; // dp: width of dy (H, or 16 without LayerNorm)
    int res_idx, res_dual;
    int tm, wr, pw, np;  // tile rows, row warps, pass width, passes over H
    float* spill;        // [grid][3][np-1][32][THREADS] or null
};

struct FwdParams {
    Common c;
    bf16* out0;
    bf16* out1;
};

struct BwdParams {
    Common c;
    const bf16* dout0;   // [M, d_out]
    const bf16* dout1;   // [M, H] with res_dual, else null
    bf16* dx[2];
    bf16* dpre;
    bf16* h1s;           // [M, H]: rows for pass 2
    bf16* h2s;
    bf16* dys;           // [M, dp]
    bf16* dh2s;
    bf16* dh1s;
    float* colsum;       // [grid][4H + dp]
};

__host__ __device__ inline int slot_elems(int pw) {
    const int a = KC * (pw + 8), b = pw * (KC + 8);
    return a > b ? a : b;
}

// byte offsets of the shared-memory regions
struct Smem {
    size_t w, x, p, h1, h2, dy, w3n, stat, red, acc, total;
};

__host__ __device__ inline Smem smem_layout(int tm, int pw, int k1, int h,
                                            int dp, bool pre, bool ln,
                                            bool stream, bool bwd) {
    const int wr = tm / 16, wc = 8 / wr;
    Smem L;
    size_t o = 0;
    const size_t res_rows = (size_t)k1 + h + (ln ? h : 0);
    L.w = o;
    o += align128(stream ? (size_t)STAGES * slot_elems(pw) * 2
                         : res_rows * (h + 8) * 2);
    L.x = o;
    o += align128(k1 > 0 ? (size_t)tm * (k1 + 8) * 2 : 0);
    L.p = o;
    o += align128(pre ? (size_t)tm * (h + 8) * 2 : 0);
    L.h1 = o;
    o += align128((size_t)tm * (h + 8) * 2);
    L.h2 = o;
    o += align128((size_t)tm * (h + 8) * 2);
    L.dy = o;
    o += align128(bwd ? (size_t)tm * (dp + 8) * 2 : 0);
    L.w3n = o;
    o += align128(ln ? 0 : (size_t)h * LDN * 2);
    L.stat = o;
    o += align128((size_t)2 * wc * tm * 2 * 4);
    L.red = o;
    o += align128(bwd ? (size_t)5 * wr * h * 4 : 0);
    L.acc = o;
    o += align128(bwd ? (size_t)(4 * h + dp) * 4 : 0);
    L.total = o;
    return L;
}

// Per-thread view of a block: shared memory, the warp's place, the ring.
struct Ctx {
    bf16* sW;        // resident weights or the ring
    bf16* sX;
    bf16* sP;
    bf16* sH1;
    bf16* sH2;
    bf16* sDY;
    bf16* sW3n;
    float* sStat;
    float* sRed;
    float* sAcc;
    int ldx, ldh, ldw, lddy;
    int wrow, wcol, g, t;
    int q, q_end;    // next ring chunk to consume; chunks of this block
    float* spill;    // this block's spill
};

// chunk q of the per-tile sequence -> (product, pass, chunk of k)
__device__ __forceinline__ void decode_chunk(const Common& c, int q, int& pi,
                                             int& j, int& kc) {
    for (pi = 0; pi < c.n_prod; ++pi) {
        const Prod& P = c.prod[pi];
        const int nk = (P.k + KC - 1) / KC;
        const int cnt = nk * ((P.n + c.pw - 1) / c.pw);
        if (q < cnt) {
            j = q / nk;
            kc = q - j * nk;
            return;
        }
        q -= cnt;
    }
    pi = j = kc = 0;
}

// start the copies of ring chunk q (block-global count) into its slot
__device__ __forceinline__ void fetch_chunk(const Common& c, Ctx& cx,
                                            int q) {
    if (q >= cx.q_end) return;
    int pi, j, kc;
    decode_chunk(c, q % c.cpt, pi, j, kc);
    const Prod& P = c.prod[pi];
    bf16* slot = cx.sW + (size_t)(q % STAGES) * slot_elems(c.pw);
    const int k0 = kc * KC, n0 = j * c.pw;
    const int nk = min(KC, P.k - k0), nn = min(c.pw, P.n - n0);
    if (P.trans == 0) {
        // rows k, columns n: slot [KC][pw + 8]
        const int cpr = nn >> 3;
        for (int i = threadIdx.x; i < nk * cpr; i += THREADS) {
            const int r = i / cpr, ch = i - r * cpr;
            cp_async16(slot + r * (c.pw + 8) + ch * 8,
                       P.w + (size_t)(k0 + r) * P.ldw + n0 + ch * 8, true);
        }
    } else {
        // rows n, columns k: slot [pw][KC + 8]
        const int cpr = nk >> 3;
        for (int i = threadIdx.x; i < nn * cpr; i += THREADS) {
            const int r = i / cpr, ch = i - r * cpr;
            cp_async16(slot + r * (KC + 8) + ch * 8,
                       P.w + (size_t)(n0 + r) * P.ldw + k0 + ch * 8, true);
        }
    }
}

// acc = A[tile rows of this warp, 0..P.k) * op(W)[:, pass j], A in shared
// memory (row stride lda). Every thread of the block calls it the same
// number of times (the ring's barriers); warps without valid columns only
// take part in those.
template <bool STREAM>
__device__ __forceinline__ void product(const Common& c, Ctx& cx, int pi,
                                        int j, float acc[8][4],
                                        const bf16* sA, int lda) {
    zero_acc(acc);
    const Prod& P = c.prod[pi];
    const int n0 = j * c.pw + cx.wcol * 64;
    const int nv = max(0, min(8, (P.n - n0) / 8));
    const int nk = (P.k + KC - 1) / KC;
    const bf16* a = sA + cx.wrow * 16 * lda;
    for (int kc = 0; kc < nk; ++kc) {
        const int ks = min(KC, P.k - kc * KC) / 16;
        const bf16* b;
        int ldb;
        if (STREAM) {
            cp_async_wait<STAGES - 2>();
            __syncthreads();
            fetch_chunk(c, cx, cx.q + STAGES - 1);
            cp_async_commit();
            const bf16* slot = cx.sW + (size_t)(cx.q % STAGES) * slot_elems(c.pw);
            ++cx.q;
            b = P.trans ? slot + cx.wcol * 64 * (KC + 8) : slot + cx.wcol * 64;
            ldb = P.trans ? KC + 8 : c.pw + 8;
        } else {
            const bf16* base = cx.sW + (size_t)P.res_row * cx.ldw;
            b = P.trans ? base + (size_t)n0 * cx.ldw + kc * KC
                        : base + (size_t)kc * KC * cx.ldw + n0;
            ldb = cx.ldw;
        }
        if (nv > 0) {
            if (P.trans) warp_mma<true>(acc, a + kc * KC, lda, b, ldb, ks, nv);
            else warp_mma<false>(acc, a + kc * KC, lda, b, ldb, ks, nv);
        }
    }
}

// rows r0 .. r0 + tm of a [M, w] bf16 array -> dst (row stride ldd), rows
// past nrow zero-filled
__device__ __forceinline__ void load_rows(bf16* dst, int ldd, const bf16* src,
                                          int w, int r0, int nrow, int tm) {
    const int cpr = w >> 3;
    for (int i = threadIdx.x; i < tm * cpr; i += THREADS) {
        const int r = i / cpr, ch = i - r * cpr;
        const bool ok = r < nrow;
        cp_async16(dst + r * ldd + ch * 8,
                   src + (size_t)(ok ? r0 + r : r0) * w + ch * 8, ok);
    }
}

__device__ __forceinline__ void load_tile(const Common& c, Ctx& cx, int r0,
                                          int nrow) {
    int off = 0;
    for (int pi = 0; pi < c.n_parts; ++pi) {
        load_rows(cx.sX + off, cx.ldx, c.part[pi], c.width[pi], r0, nrow,
                  c.tm);
        off += c.width[pi];
    }
    if (c.pre != nullptr) load_rows(cx.sP, cx.ldh, c.pre, c.H, r0, nrow, c.tm);
}

// the resident weights [W1 | W2 | W3] as [rows][H + 8]; the noLN head W3
// zero-padded to [H][LDN] (plain loads: its rows are d_out * 2 bytes)
__device__ __forceinline__ void stage_weights(const Common& c, Ctx& cx,
                                              bool ln, bool stream) {
    const int cpr = c.H >> 3;
    if (!stream) {
        const bf16* src[3] = {c.w1, c.w2, c.w3};
        const int rows[3] = {c.k1, c.H, ln ? c.H : 0};
        int r0 = 0;
        for (int m = 0; m < 3; ++m) {
            for (int i = threadIdx.x; i < rows[m] * cpr; i += THREADS) {
                const int r = i / cpr, ch = i - r * cpr;
                cp_async16(cx.sW + (size_t)(r0 + r) * cx.ldw + ch * 8,
                           src[m] + (size_t)r * c.H + ch * 8, true);
            }
            r0 += rows[m];
        }
    }
    if (!ln) {
        for (int i = threadIdx.x; i < c.H * LDN; i += THREADS) {
            const int r = i / LDN, col = i - r * LDN;
            cx.sW3n[i] = col < c.d_out ? c.w3[(size_t)r * c.d_out + col]
                                       : __float2bfloat16(0.0f);
        }
    }
}

__device__ __forceinline__ void init_ctx(const Common& c, Ctx& cx, bool ln,
                                         bool stream, bool bwd) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout(c.tm, c.pw, c.k1, c.H, c.dp, c.pre != nullptr,
                               ln, stream, bwd);
    cx.sW = reinterpret_cast<bf16*>(smem + L.w);
    cx.sX = reinterpret_cast<bf16*>(smem + L.x);
    cx.sP = reinterpret_cast<bf16*>(smem + L.p);
    cx.sH1 = reinterpret_cast<bf16*>(smem + L.h1);
    cx.sH2 = reinterpret_cast<bf16*>(smem + L.h2);
    cx.sDY = reinterpret_cast<bf16*>(smem + L.dy);
    cx.sW3n = reinterpret_cast<bf16*>(smem + L.w3n);
    cx.sStat = reinterpret_cast<float*>(smem + L.stat);
    cx.sRed = reinterpret_cast<float*>(smem + L.red);
    cx.sAcc = reinterpret_cast<float*>(smem + L.acc);
    cx.ldx = c.k1 + 8;
    cx.ldh = c.H + 8;
    cx.ldw = c.H + 8;
    cx.lddy = c.dp + 8;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    cx.wrow = warp % c.wr;
    cx.wcol = warp / c.wr;
    cx.g = lane >> 2;
    cx.t = lane & 3;
    const int n_tiles = (c.M + c.tm - 1) / c.tm;
    const int mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
    cx.q = 0;
    cx.q_end = stream ? mine * c.cpt : 0;
    cx.spill = c.spill == nullptr ? nullptr
        : c.spill + (size_t)blockIdx.x * 3 * (c.np - 1) * 32 * THREADS;
}

// element e (0..31) of pass j >= 1 of spilled array `which` (0: gelu'(h1pre),
// 1: gelu'(h2pre), 2: y), this thread's own slot
__device__ __forceinline__ float& spill_at(const Common& c, Ctx& cx,
                                           int which, int j, int e) {
    return cx.spill[((size_t)(which * (c.np - 1) + (j - 1)) * 32 + e) *
                    THREADS + threadIdx.x];
}

// value of pass j, tile nt, element e: registers for pass 0, else the spill
#define KEEP(reg, which, j, nt, e, v)                                       \
    do {                                                                     \
        if ((j) == 0) reg[nt][e] = (v);                                      \
        else spill_at(c, cx, which, j, (nt) * 4 + (e)) = (v);                \
    } while (0)
#define FETCH(reg, which, j, nt, e)                                          \
    ((j) == 0 ? reg[nt][e] : spill_at(c, cx, which, j, (nt) * 4 + (e)))

// h = bf16(gelu(bias (+ pre) (+ acc))) of pass j into sH; with `grad`, also
// keep gelu'(.) of the same value (array `which`); with `gout`, also write
// h as rows r0.. of gout (real rows only)
template <bool GRAD>
__device__ __forceinline__ void hidden_epilogue(
    const Common& c, Ctx& cx, const float acc[8][4], bool has_acc,
    const float* bias, const bf16* sP, bf16* sH, int j, float keep[8][4],
    int which, bf16* gout, int r0, int nrow) {
    const int n0 = j * c.pw + cx.wcol * 64;
    const int nv = max(0, min(8, (c.H - n0) / 8));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        if (nt < nv) {
            const int col = n0 + nt * 8 + 2 * cx.t;
            const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = cx.wrow * 16 + cx.g + 8 * hf;
                float v0 = bb.x, v1 = bb.y;
                if (sP != nullptr) {
                    const float2 pv = load_bf16x2(sP + row * cx.ldh + col);
                    v0 += pv.x;
                    v1 += pv.y;
                }
                if (has_acc) {
                    v0 += acc[nt][2 * hf];
                    v1 += acc[nt][2 * hf + 1];
                }
                float h0, h1;
                if (GRAD) {
                    float d0, d1;
                    h0 = gelu_and_grad(v0, d0);
                    h1 = gelu_and_grad(v1, d1);
                    KEEP(keep, which, j, nt, 2 * hf, d0);
                    KEEP(keep, which, j, nt, 2 * hf + 1, d1);
                } else {
                    h0 = gelu_tanh(v0);
                    h1 = gelu_tanh(v1);
                }
                const uint32_t hv = pack_bf16(h0, h1);
                *reinterpret_cast<uint32_t*>(sH + row * cx.ldh + col) = hv;
                if (gout != nullptr && row < nrow)
                    *reinterpret_cast<uint32_t*>(
                        gout + (size_t)(r0 + row) * c.H + col) = hv;
            }
        }
    }
}

// this thread's two rows (g, g + 8 of its warp): quad-reduce a, b, write
// them for the column warps' exchange, sync, and return the full-row sums
__device__ __forceinline__ void row_exchange(const Common& c, Ctx& cx,
                                             float a[2], float b[2],
                                             float* stat) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            a[hf] += __shfl_xor_sync(0xffffffffu, a[hf], o);
            b[hf] += __shfl_xor_sync(0xffffffffu, b[hf], o);
        }
        if (cx.t == 0) {
            const int row = cx.wrow * 16 + cx.g + 8 * hf;
            stat[(cx.wcol * c.tm + row) * 2] = a[hf];
            stat[(cx.wcol * c.tm + row) * 2 + 1] = b[hf];
        }
    }
    __syncthreads();
    const int wc = 8 / c.wr;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int row = cx.wrow * 16 + cx.g + 8 * hf;
        float sa = 0.0f, sb = 0.0f;
        for (int w = 0; w < wc; ++w) {
            sa += stat[(w * c.tm + row) * 2];
            sb += stat[(w * c.tm + row) * 2 + 1];
        }
        a[hf] = sa;
        b[hf] = sb;
    }
}

// ================================ forward ==================================

template <bool LN, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_fwd_tiles(FwdParams p) {
    const Common& c = p.c;
    Ctx cx;
    init_ctx(c, cx, LN, STREAM, false);
    const int n_tiles = (c.M + c.tm - 1) / c.tm;
    const int id_w1 = 0, id_w2 = c.k1 > 0 ? 1 : 0, id_w3 = id_w2 + 1;

    // ---- prologue: weights, the first tile's rows, the ring's first chunks
    stage_weights(c, cx, LN, STREAM);
    if ((int)blockIdx.x < n_tiles) {
        const int r0 = blockIdx.x * c.tm;
        load_tile(c, cx, r0, min(c.tm, c.M - r0));
    }
    cp_async_commit();
    if (STREAM) {
        for (int s = 0; s < STAGES - 1; ++s) {
            fetch_chunk(c, cx, s);
            cp_async_commit();
        }
    }

    float keep_unused[8][4];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * c.tm;
        const int nrow = min(c.tm, c.M - r0);
        cp_async_wait<0>();
        __syncthreads();

        float acc[8][4];
        // ---- layer 1: h1 = bf16(gelu(x W1 + b1 + pre)) ----
        for (int j = 0; j < c.np; ++j) {
            if (c.k1 > 0) product<STREAM>(c, cx, id_w1, j, acc, cx.sX, cx.ldx);
            hidden_epilogue<false>(c, cx, acc, c.k1 > 0, c.b1,
                                   c.pre != nullptr ? cx.sP : nullptr, cx.sH1,
                                   j, keep_unused, 0, nullptr, r0, nrow);
        }
        __syncthreads();
        // the next tile's rows, while this one computes
        {
            const int nt_ = tile + gridDim.x;
            if (nt_ < n_tiles) {
                const int nr0 = nt_ * c.tm;
                load_tile(c, cx, nr0, min(c.tm, c.M - nr0));
            }
            cp_async_commit();
        }
        // ---- layer 2: h2 = bf16(gelu(h1 W2 + b2)) ----
        for (int j = 0; j < c.np; ++j) {
            product<STREAM>(c, cx, id_w2, j, acc, cx.sH1, cx.ldh);
            hidden_epilogue<false>(c, cx, acc, true, c.b2, nullptr, cx.sH2, j,
                                   keep_unused, 0, nullptr, r0, nrow);
        }
        __syncthreads();

        // ---- layer 3 + epilogue ----
        if (LN) {
            float yr[8][4];
            float s[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
            for (int j = 0; j < c.np; ++j) {
                product<STREAM>(c, cx, id_w3, j, acc, cx.sH2, cx.ldh);
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (c.H - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
                        const float2 bb =
                            *reinterpret_cast<const float2*>(c.b3 + col);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float y = acc[nt][e] + (e & 1 ? bb.y : bb.x);
                            s[e >> 1] += y;
                            ss[e >> 1] += y * y;
                            KEEP(yr, 2, j, nt, e, y);
                        }
                    }
                }
            }
            row_exchange(c, cx, s, ss, cx.sStat);
            float mu[2], rstd[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                mu[hf] = s[hf] / (float)c.H;
                const float var = fmaxf(ss[hf] / (float)c.H - mu[hf] * mu[hf],
                                        0.0f);
                rstd[hf] = 1.0f / sqrtf(var + kLnEps);
            }
            const bf16* res = c.res_idx >= 0 ? c.part[c.res_idx] : nullptr;
            for (int j = 0; j < c.np; ++j) {
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (c.H - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
                        const float2 ga =
                            *reinterpret_cast<const float2*>(c.gamma + col);
                        const float2 be =
                            *reinterpret_cast<const float2*>(c.beta + col);
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = cx.wrow * 16 + cx.g + 8 * hf;
                            if (row >= nrow) continue;
                            float o0 = FETCH(yr, 2, j, nt, 2 * hf);
                            float o1 = FETCH(yr, 2, j, nt, 2 * hf + 1);
                            // round to bf16 BEFORE the residual add
                            o0 = round_bf16((o0 - mu[hf]) * rstd[hf] * ga.x + be.x);
                            o1 = round_bf16((o1 - mu[hf]) * rstd[hf] * ga.y + be.y);
                            const size_t at = (size_t)(r0 + row) * c.H + col;
                            if (res == nullptr) {
                                store_bf16x2(p.out0 + at, o0, o1);
                            } else {
                                const float2 rv = load_bf16x2(res + at);
                                if (c.res_dual) {
                                    store_bf16x2(p.out0 + at, o0, o1);
                                    store_bf16x2(p.out1 + at, o0 + rv.x,
                                                 o1 + rv.y);
                                } else {
                                    store_bf16x2(p.out0 + at, o0 + rv.x,
                                                 o1 + rv.y);
                                }
                            }
                        }
                    }
                }
            }
        } else {
            // narrow head: 16 zero-padded columns, the column-0 warps
            zero_acc(acc);
            if (cx.wcol == 0)
                warp_mma<false>(acc, cx.sH2 + cx.wrow * 16 * cx.ldh, cx.ldh,
                                cx.sW3n, LDN, c.H / 16, 2);
            if (cx.wcol == 0) {
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int row = cx.wrow * 16 + cx.g + 8 * (e >> 1);
                        const int col = nt * 8 + 2 * cx.t + (e & 1);
                        if (row < nrow && col < c.d_out)
                            p.out0[(size_t)(r0 + row) * c.d_out + col] =
                                __float2bfloat16(acc[nt][e] + c.b3[col]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
}

// =============================== backward ==================================

enum { RED_DB1 = 0, RED_DB2, RED_DB3, RED_DG, RED_DBE };

template <bool LN, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_bwd_tiles(BwdParams p) {
    const Common& c = p.c;
    Ctx cx;
    init_ctx(c, cx, LN, STREAM, true);
    const int n_tiles = (c.M + c.tm - 1) / c.tm;
    const int H = c.H;
    // product ids: W1, W2, [W3], [W3^T], W2^T, W1_0^T, [W1_1^T]
    int nid = 0;
    const int id_w1 = c.k1 > 0 ? nid++ : -1;
    const int id_w2 = nid++;
    const int id_w3 = LN ? nid++ : -1;
    const int id_w3t = LN ? nid++ : -1;
    const int id_w2t = nid++;
    const int id_w1t = nid;
    const int n_bias = 4 * H + c.dp;
    const int acc_off[5] = {0, H, 2 * H, 2 * H + c.dp, 3 * H + c.dp};

    // ---- prologue ----
    for (int i = threadIdx.x; i < n_bias; i += THREADS) cx.sAcc[i] = 0.0f;
    for (int i = threadIdx.x; i < 5 * c.wr * H; i += THREADS) cx.sRed[i] = 0.0f;
    stage_weights(c, cx, LN, STREAM);
    if ((int)blockIdx.x < n_tiles) {
        const int r0 = blockIdx.x * c.tm;
        load_tile(c, cx, r0, min(c.tm, c.M - r0));
    }
    cp_async_commit();
    if (STREAM) {
        for (int s = 0; s < STAGES - 1; ++s) {
            fetch_chunk(c, cx, s);
            cp_async_commit();
        }
    }

    float g1r[8][4], g2r[8][4];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * c.tm;
        const int nrow = min(c.tm, c.M - r0);
        cp_async_wait<0>();
        __syncthreads();

        float acc[8][4];
        // ---- 1. h1 = bf16(gelu(x W1 + b1 + pre)), gelu'(h1pre) ----
        for (int j = 0; j < c.np; ++j) {
            if (c.k1 > 0) product<STREAM>(c, cx, id_w1, j, acc, cx.sX, cx.ldx);
            hidden_epilogue<true>(c, cx, acc, c.k1 > 0, c.b1,
                                  c.pre != nullptr ? cx.sP : nullptr, cx.sH1,
                                  j, g1r, 0, p.h1s, r0, nrow);
        }
        __syncthreads();
        {
            const int nt_ = tile + gridDim.x;
            if (nt_ < n_tiles) {
                const int nr0 = nt_ * c.tm;
                load_tile(c, cx, nr0, min(c.tm, c.M - nr0));
            }
            cp_async_commit();
        }
        // ---- 2. h2 = bf16(gelu(h1 W2 + b2)), gelu'(h2pre) ----
        for (int j = 0; j < c.np; ++j) {
            product<STREAM>(c, cx, id_w2, j, acc, cx.sH1, cx.ldh);
            hidden_epilogue<true>(c, cx, acc, true, c.b2, nullptr, cx.sH2, j,
                                  g2r, 1, p.h2s, r0, nrow);
        }
        __syncthreads();

        // ---- 3. dy ----
        if (LN) {
            float yr[8][4];
            float s[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
            for (int j = 0; j < c.np; ++j) {
                product<STREAM>(c, cx, id_w3, j, acc, cx.sH2, cx.ldh);
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (H - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
                        const float2 bb =
                            *reinterpret_cast<const float2*>(c.b3 + col);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float y = acc[nt][e] + (e & 1 ? bb.y : bb.x);
                            s[e >> 1] += y;
                            ss[e >> 1] += y * y;
                            KEEP(yr, 2, j, nt, e, y);
                        }
                    }
                }
            }
            row_exchange(c, cx, s, ss, cx.sStat);
            float mu[2], rstd[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                mu[hf] = s[hf] / (float)H;
                const float var =
                    fmaxf(ss[hf] / (float)H - mu[hf] * mu[hf], 0.0f);
                rstd[hf] = 1.0f / sqrtf(var + kLnEps);
            }
            const bool dual = c.res_idx >= 0 && c.res_dual;
            // g = dout0 (+ dout1) at (row, col), zero past the tile's rows
            auto load_g = [&](int row, int col, float& g0, float& g1) {
                g0 = g1 = 0.0f;
                if (row < nrow) {
                    const size_t at = (size_t)(r0 + row) * H + col;
                    const float2 a = load_bf16x2(p.dout0 + at);
                    g0 = a.x;
                    g1 = a.y;
                    if (dual) {
                        const float2 b = load_bf16x2(p.dout1 + at);
                        g0 += b.x;
                        g1 += b.y;
                    }
                }
            };
            float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
            for (int j = 0; j < c.np; ++j) {
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (H - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
                        const float2 ga =
                            *reinterpret_cast<const float2*>(c.gamma + col);
                        float pg[2] = {0.0f, 0.0f}, pb[2] = {0.0f, 0.0f};
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = cx.wrow * 16 + cx.g + 8 * hf;
                            float g[2];
                            load_g(row, col, g[0], g[1]);
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const float y = FETCH(yr, 2, j, nt, 2 * hf + e);
                                const float xh = (y - mu[hf]) * rstd[hf];
                                const float gx = g[e] * (e ? ga.y : ga.x);
                                m1[hf] += gx;
                                m2[hf] += gx * xh;
                                pg[e] += g[e] * xh;
                                pb[e] += g[e];
                            }
                        }
                        col_sum_store(pg[0], pg[1], cx.g,
                                      cx.sRed + (RED_DG * c.wr + cx.wrow) * H +
                                          n0 + nt * 8 + 2 * cx.t);
                        col_sum_store(pb[0], pb[1], cx.g,
                                      cx.sRed + (RED_DBE * c.wr + cx.wrow) * H +
                                          n0 + nt * 8 + 2 * cx.t);
                    }
                }
            }
            row_exchange(c, cx, m1, m2, cx.sStat + 2 * (8 / c.wr) * c.tm);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                m1[hf] = m1[hf] / (float)H;
                m2[hf] = m2[hf] / (float)H;
            }
            for (int j = 0; j < c.np; ++j) {
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (H - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
                        const float2 ga =
                            *reinterpret_cast<const float2*>(c.gamma + col);
                        float pd[2] = {0.0f, 0.0f};
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = cx.wrow * 16 + cx.g + 8 * hf;
                            float g[2], dy[2];
                            load_g(row, col, g[0], g[1]);
#pragma unroll
                            for (int e = 0; e < 2; ++e) {
                                const float y = FETCH(yr, 2, j, nt, 2 * hf + e);
                                const float xh = (y - mu[hf]) * rstd[hf];
                                const float gx = g[e] * (e ? ga.y : ga.x);
                                dy[e] = rstd[hf] * ((gx - m1[hf]) - xh * m2[hf]);
                                pd[e] += dy[e];
                            }
                            const uint32_t dv = pack_bf16(dy[0], dy[1]);
                            *reinterpret_cast<uint32_t*>(
                                cx.sDY + row * cx.lddy + col) = dv;
                            if (row < nrow)
                                *reinterpret_cast<uint32_t*>(
                                    p.dys + (size_t)(r0 + row) * H + col) = dv;
                        }
                        col_sum_store(pd[0], pd[1], cx.g,
                                      cx.sRed + (RED_DB3 * c.wr + cx.wrow) * H +
                                          n0 + nt * 8 + 2 * cx.t);
                    }
                }
            }
        } else {
            // dy = dout: d_out real columns, zero up to 16
            for (int i = threadIdx.x; i < c.tm * 16; i += THREADS) {
                const int row = i >> 4, col = i & 15;
                const bf16 v = (row < nrow && col < c.d_out)
                    ? p.dout0[(size_t)(r0 + row) * c.d_out + col]
                    : __float2bfloat16(0.0f);
                cx.sDY[row * cx.lddy + col] = v;
                if (row < nrow) p.dys[(size_t)(r0 + row) * 16 + col] = v;
            }
            __syncthreads();
            if (threadIdx.x < 16) {
                float d = 0.0f;
                for (int row = 0; row < c.tm; ++row)
                    d += __bfloat162float(cx.sDY[row * cx.lddy + threadIdx.x]);
                cx.sRed[(RED_DB3 * c.wr) * H + threadIdx.x] = d;
            }
        }
        __syncthreads();

        // ---- 4. dh2pre = (dy16 W3^T) * gelu'(h2pre) -> sH2, db2 ----
        for (int j = 0; j < c.np; ++j) {
            if (LN) {
                product<STREAM>(c, cx, id_w3t, j, acc, cx.sDY, cx.lddy);
            } else {
                // the staged head read as its transpose: contraction 16
                zero_acc(acc);
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (H - n0) / 8));
                if (nv > 0)
                    warp_mma<true>(acc, cx.sDY + cx.wrow * 16 * cx.lddy,
                                   cx.lddy, cx.sW3n + (size_t)n0 * LDN, LDN, 1,
                                   nv);
            }
            const int n0 = j * c.pw + cx.wcol * 64;
            const int nv = max(0, min(8, (H - n0) / 8));
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + nt * 8 + 2 * cx.t;
                    float ps[2] = {0.0f, 0.0f};
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = cx.wrow * 16 + cx.g + 8 * hf;
                        const float v0 = acc[nt][2 * hf] *
                                         FETCH(g2r, 1, j, nt, 2 * hf);
                        const float v1 = acc[nt][2 * hf + 1] *
                                         FETCH(g2r, 1, j, nt, 2 * hf + 1);
                        ps[0] += v0;
                        ps[1] += v1;
                        const uint32_t dv = pack_bf16(v0, v1);
                        *reinterpret_cast<uint32_t*>(
                            cx.sH2 + row * cx.ldh + col) = dv;
                        if (row < nrow)
                            *reinterpret_cast<uint32_t*>(
                                p.dh2s + (size_t)(r0 + row) * H + col) = dv;
                    }
                    col_sum_store(ps[0], ps[1], cx.g,
                                  cx.sRed + (RED_DB2 * c.wr + cx.wrow) * H +
                                      col);
                }
            }
        }
        __syncthreads();

        // ---- 5. dh1pre = (dh2pre16 W2^T) * gelu'(h1pre) -> sH1, db1, dpre --
        for (int j = 0; j < c.np; ++j) {
            product<STREAM>(c, cx, id_w2t, j, acc, cx.sH2, cx.ldh);
            const int n0 = j * c.pw + cx.wcol * 64;
            const int nv = max(0, min(8, (H - n0) / 8));
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + nt * 8 + 2 * cx.t;
                    float ps[2] = {0.0f, 0.0f};
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = cx.wrow * 16 + cx.g + 8 * hf;
                        const float v0 = acc[nt][2 * hf] *
                                         FETCH(g1r, 0, j, nt, 2 * hf);
                        const float v1 = acc[nt][2 * hf + 1] *
                                         FETCH(g1r, 0, j, nt, 2 * hf + 1);
                        ps[0] += v0;
                        ps[1] += v1;
                        const uint32_t dv = pack_bf16(v0, v1);
                        *reinterpret_cast<uint32_t*>(
                            cx.sH1 + row * cx.ldh + col) = dv;
                        if (row < nrow) {
                            const size_t at = (size_t)(r0 + row) * H + col;
                            *reinterpret_cast<uint32_t*>(p.dh1s + at) = dv;
                            if (p.dpre != nullptr)
                                *reinterpret_cast<uint32_t*>(p.dpre + at) = dv;
                        }
                    }
                    col_sum_store(ps[0], ps[1], cx.g,
                                  cx.sRed + (RED_DB1 * c.wr + cx.wrow) * H +
                                      col);
                }
            }
        }
        __syncthreads();

        // the tile's column sums into the block's, row warps in order
        for (int i = threadIdx.x; i < n_bias; i += THREADS) {
            int kind = 0;
            while (kind < 4 && i >= acc_off[kind + 1]) ++kind;
            const int col = i - acc_off[kind];
            float s = 0.0f;
            for (int w = 0; w < c.wr; ++w) s += cx.sRed[(kind * c.wr + w) * H + col];
            cx.sAcc[i] += s;
        }

        // ---- 6. dx_i = dh1pre16 W1_i^T (+ the residual's cotangent) ----
        for (int pi = 0; pi < c.n_parts; ++pi) {
            const int w = c.width[pi];
            const bf16* dres = nullptr;
            if (pi == c.res_idx) dres = c.res_dual ? p.dout1 : p.dout0;
            const int passes = (w + c.pw - 1) / c.pw;
            for (int j = 0; j < passes; ++j) {
                product<STREAM>(c, cx, id_w1t + pi, j, acc, cx.sH1, cx.ldh);
                const int n0 = j * c.pw + cx.wcol * 64;
                const int nv = max(0, min(8, (w - n0) / 8));
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        const int col = n0 + nt * 8 + 2 * cx.t;
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = cx.wrow * 16 + cx.g + 8 * hf;
                            if (row >= nrow) continue;
                            float v0 = acc[nt][2 * hf], v1 = acc[nt][2 * hf + 1];
                            if (dres != nullptr) {
                                const float2 r = load_bf16x2(
                                    dres + (size_t)(r0 + row) * H + col);
                                v0 += r.x;
                                v1 += r.y;
                            }
                            store_bf16x2(p.dx[pi] + (size_t)(r0 + row) * w + col,
                                         v0, v1);
                        }
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int i = threadIdx.x; i < n_bias; i += THREADS)
        p.colsum[(size_t)blockIdx.x * n_bias + i] = cx.sAcc[i];
}

// ====================== H = 128: one warp a 16-row strip ===================
//
// At H = 128 a warp owns whole rows: a 16 x 128 accumulator (16 tiles of 8
// columns, 64 floats a thread). The C fragment of m16n8k16 holds, for two
// neighbouring 8-column tiles, exactly the A fragment of a 16-deep slice of
// the next product, so h1, h2 (and the backward's dy16, dh2pre16,
// dh1pre16) go from one product's epilogue to the next product as bf16
// registers, never through shared memory; LayerNorm statistics are quad
// shuffles. The block stages the weights once; after that its warps share
// nothing and need no barrier: each walks over its own strips, its x and
// pre rows coming in by cp.async into its own buffers while it computes.

constexpr int RW = 8;                 // warps of a rows block
constexpr int LDR = 136;              // staged weights' leading dim (128 + 8)

struct RowsSmem {
    size_t w, w3n, bias, x, p, col, total;
};

// bytes of a warp's x region: its x rows [16][k1 + 8]; in the backward
// also gelu'(h1pre) [64][32] float32 while x is not needed
__host__ __device__ inline size_t rows_x_bytes(int k1, bool bwd) {
    const size_t x = k1 > 0 ? (size_t)16 * (k1 + 8) * 2 : 0;
    return bwd && x < 8192 ? 8192 : x;
}

// x and pre rows staged per warp (in the backward the x region holds
// gelu'(h1pre) between layer 1 and step 5)
__host__ __device__ inline RowsSmem rows_layout(int k1, int dp, bool pre,
                                                bool ln, bool bwd) {
    RowsSmem L;
    size_t o = 0;
    L.w = o;
    o += align128((size_t)(k1 + 128 + (ln ? 128 : 0)) * LDR * 2);
    L.w3n = o;
    o += align128(ln ? 0 : (size_t)128 * LDN * 2);
    L.bias = o;
    o += align128((size_t)5 * 128 * 4);
    L.x = o;
    o += align128((size_t)RW * rows_x_bytes(k1, bwd));
    L.p = o;
    o += align128(pre ? (size_t)RW * 16 * LDR * 2 : 0);
    L.col = o;
    o += align128(bwd ? (size_t)RW * (4 * 128 + dp) * 4 : 0);
    L.total = o;
    return L;
}

// acc[16][4] += A * B over 16 columns tiles (nv valid, even); A [16 x
// 16*ksteps] in shared memory (a at the first row, stride lda)
template <bool BT>
__device__ __forceinline__ void rows_mma_smem(float acc[16][4], const bf16* a,
                                              int lda, const bf16* b,
                                              int ldb, int ksteps, int nv) {
    const int lane = threadIdx.x & 31;
    const bf16* ap = a + (lane & 15) * lda + ((lane >> 4) << 3);
    const bf16* bp = BT
        ? b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + (((lane >> 3) & 1) << 3)
        : b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + ((lane >> 4) << 3);
    for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, ap + ks * 16);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            if (2 * q < nv) {
                uint32_t bfr[4];
                if (BT) ldsm_x4(bfr, bp + q * 16 * ldb + ks * 16);
                else ldsm_x4_t(bfr, bp + ks * 16 * ldb + q * 16);
                mma16816(acc[2 * q], af, bfr[0], bfr[1]);
                mma16816(acc[2 * q + 1], af, bfr[2], bfr[3]);
            }
        }
    }
}

// the same with A in registers: a[kk] is the fragment of contraction
// columns 16kk .. 16kk + 15 (ksteps <= 8)
template <bool BT>
__device__ __forceinline__ void rows_mma_reg(float acc[16][4],
                                             const uint32_t a[8][4],
                                             const bf16* b, int ldb,
                                             int ksteps, int nv) {
    const int lane = threadIdx.x & 31;
    const bf16* bp = BT
        ? b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + (((lane >> 3) & 1) << 3)
        : b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + ((lane >> 4) << 3);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
        if (ks < ksteps) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                if (2 * q < nv) {
                    uint32_t bfr[4];
                    if (BT) ldsm_x4(bfr, bp + q * 16 * ldb + ks * 16);
                    else ldsm_x4_t(bfr, bp + ks * 16 * ldb + q * 16);
                    mma16816(acc[2 * q], a[ks], bfr[0], bfr[1]);
                    mma16816(acc[2 * q + 1], a[ks], bfr[2], bfr[3]);
                }
            }
        }
    }
}

__device__ __forceinline__ void zero_acc16(float acc[16][4]) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

__device__ __forceinline__ void warp_load_strip(const Common& c, bf16* sx,
                                                bf16* sp, int r0, int nrow) {
    int off = 0;
    for (int pi = 0; pi < c.n_parts; ++pi) {
        warp_load_rows(sx + off, c.k1 + 8, c.part[pi], c.width[pi], r0, nrow);
        off += c.width[pi];
    }
    if (c.pre != nullptr && sp != nullptr)
        warp_load_rows(sp, LDR, c.pre, 128, r0, nrow);
}

struct RowsCtx {
    bf16* sW;        // [W1 | W2 | W3] as [rows][LDR]
    bf16* sW3n;
    float* sB;       // b1 | b2 | b3 | gamma | beta, 128 each
    bf16* sx;        // this warp's x rows [16][k1 + 8]
    bf16* sp;        // this warp's pre rows [16][LDR]
    float* sCol;     // this warp's column sums [4 * 128 + dp]
};

// staging of weights and vectors, then one barrier; this warp's buffers
__device__ __forceinline__ RowsCtx rows_init(const Common& c, bool ln,
                                             bool bwd) {
    extern __shared__ __align__(128) unsigned char smem[];
    const RowsSmem L = rows_layout(c.k1, c.dp, c.pre != nullptr, ln, bwd);
    RowsCtx r;
    r.sW = reinterpret_cast<bf16*>(smem + L.w);
    r.sW3n = reinterpret_cast<bf16*>(smem + L.w3n);
    r.sB = reinterpret_cast<float*>(smem + L.bias);
    const int warp = threadIdx.x >> 5;
    r.sx = reinterpret_cast<bf16*>(smem + L.x + warp * rows_x_bytes(c.k1, bwd));
    r.sp = reinterpret_cast<bf16*>(smem + L.p) + warp * 16 * LDR;
    r.sCol = reinterpret_cast<float*>(smem + L.col) + warp * (4 * 128 + c.dp);
    const bf16* src[3] = {c.w1, c.w2, c.w3};
    const int rows[3] = {c.k1, 128, ln ? 128 : 0};
    int r0 = 0;
    for (int m = 0; m < 3; ++m) {
        for (int i = threadIdx.x; i < rows[m] * 16; i += RW * 32) {
            const int rr = i >> 4, ch = i & 15;
            cp_async16(r.sW + (size_t)(r0 + rr) * LDR + ch * 8,
                       src[m] + (size_t)rr * 128 + ch * 8, true);
        }
        r0 += rows[m];
    }
    cp_async_commit();
    if (!ln) {
        for (int i = threadIdx.x; i < 128 * LDN; i += RW * 32) {
            const int rr = i / LDN, col = i - rr * LDN;
            r.sW3n[i] = col < c.d_out ? c.w3[(size_t)rr * c.d_out + col]
                                      : __float2bfloat16(0.0f);
        }
    }
    for (int i = threadIdx.x; i < 5 * 128; i += RW * 32) {
        const int k = i >> 7, col = i & 127;
        float v = 0.0f;
        if (k == 0) v = c.b1[col];
        else if (k == 1) v = c.b2[col];
        else if (k == 2) v = col < c.d_out ? c.b3[col] : 0.0f;
        else if (ln && k == 3) v = c.gamma[col];
        else if (ln && k == 4 && c.beta != nullptr) v = c.beta[col];
        r.sB[i] = v;
    }
    cp_async_wait<0>();
    __syncthreads();
    return r;
}

// h = bf16(gelu(bias (+ pre) (+ acc))) for the warp's 16 rows, as the next
// product's A fragments; the pre rows from the warp's buffer sp, or as
// column pairs pv (load_pairs); with GRAD, gelu'(.) into gk, or with
// TO_SLOT straight into a [16][32] float4 slot, gk[nt][0..3] of this lane
// at gs[nt * 32 + lane] (no registers held for it; one 16-byte store a
// tile); with `gout`, h also into rows r0.. of gout (real rows)
template <bool GRAD, bool TO_SLOT = false>
__device__ __forceinline__ void rows_hidden(const float acc[16][4],
                                            bool has_acc, const float* bias,
                                            const bf16* sp,
                                            const uint32_t (*pv)[2],
                                            uint32_t a[8][4],
                                            float gk[16][4], bf16* gout,
                                            int r0, int nrow,
                                            float4* gs = nullptr) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
        float d[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int row = g + 8 * hf;
            float v0 = bb.x, v1 = bb.y;
            if (sp != nullptr) {
                const float2 q = load_bf16x2(sp + row * LDR + col);
                v0 += q.x;
                v1 += q.y;
            } else if (pv != nullptr) {
                const float2 q = unpack_bf16(pv[nt][hf]);
                v0 += q.x;
                v1 += q.y;
            }
            if (has_acc) {
                v0 += acc[nt][2 * hf];
                v1 += acc[nt][2 * hf + 1];
            }
            float h0, h1;
            if (GRAD && TO_SLOT) {
                h0 = gelu_and_grad(v0, d[2 * hf]);
                h1 = gelu_and_grad(v1, d[2 * hf + 1]);
            } else if (GRAD) {
                h0 = gelu_and_grad(v0, gk[nt][2 * hf]);
                h1 = gelu_and_grad(v1, gk[nt][2 * hf + 1]);
            } else {
                h0 = gelu_tanh(v0);
                h1 = gelu_tanh(v1);
            }
            put_a(a, nt, hf, pack_bf16(h0, h1));
        }
        if (GRAD && TO_SLOT)
            __stcg(gs + nt * 32 + lane, make_float4(d[0], d[1], d[2], d[3]));
    }
    if (gout != nullptr) store_frag_rows(gout, 128, r0, nrow, a, 8);
}

// this warp's column sums of v (tile nt: columns 2t, 2t + 1, each the sum
// of this thread's two rows) added to col[0..1] by lanes 0..3
__device__ __forceinline__ void rows_col_add(float v0, float v1, float* col) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, o);
        v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if ((threadIdx.x & 31) < 4) {
        col[0] += v0;
        col[1] += v1;
    }
}

// The warp's column sums of 8 tiles (v[i][e]: column 2t + e of tile base +
// i, this thread's two rows) added into col[], by a reduce-scatter over the
// 8 lanes that share t: each step keeps half the tiles and hands the other
// half to the partner lane (14 shuffles instead of 48); the last holder of
// a column adds it. The order of the sums is fixed: the same bits every run.
__device__ __forceinline__ void col_add8(const float v[8][2], int base,
                                         float* col) {
    const int lane = threadIdx.x & 31;
    const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1,
               b2 = (lane >> 2) & 1;
    float a[4][2], b[2][2], r[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float keep = b4 ? v[i + 4][e] : v[i][e];
            const float send = b4 ? v[i][e] : v[i + 4][e];
            a[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const float keep = b3 ? a[i + 2][e] : a[i][e];
            const float send = b3 ? a[i][e] : a[i + 2][e];
            b[i][e] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const float keep = b2 ? b[1][e] : b[0][e];
        const float send = b2 ? b[0][e] : b[1][e];
        r[e] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
    const int tile = base + (b4 ? 4 : 0) + (b3 ? 2 : 0) + (b2 ? 1 : 0);
    float* c = col + tile * 8 + 2 * (lane & 3);
    c[0] += r[0];
    c[1] += r[1];
}

// ---- the epilogues of a warp's 16-row strip at H = 128 (load_pairs and
// strip_ln_out also the row kernels'; bias, gamma, beta in shared or device
// memory) ----

// rows r0 + g + 8 hf (clamped to the strip's real rows; row r0 where it
// has none) of a [*, 128] bf16 array as this thread's column pairs:
// v[nt][hf] = columns nt*8 + 2t, +1
__device__ __forceinline__ void load_pairs(uint32_t v[16][2], const bf16* src,
                                           int r0, int nrow) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int row = max(0, min(g + 8 * hf, nrow - 1));
            v[nt][hf] = *reinterpret_cast<const uint32_t*>(
                src + (size_t)(r0 + row) * 128 + nt * 8 + 2 * t);
        }
}

// y = acc + b3, its LayerNorm and the outputs: out = bf16(LN(y) gamma +
// beta) into out0; with a residual (its rows in rv) out + res into out0, or
// with res_dual into out1 beside out in out0
__device__ __forceinline__ void strip_ln_out(float acc[16][4], const float* b3,
                                             const float* gamma,
                                             const float* beta,
                                             const uint32_t rv[16][2],
                                             bool has_res, bool res_dual,
                                             bf16* out0, bf16* out1, int r0,
                                             int nrow) {
    const int t = threadIdx.x & 3;
    float sm[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(b3 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float y = acc[nt][e] + (e & 1 ? bb.y : bb.x);
            acc[nt][e] = y;
            sm[e >> 1] += y;
            ss[e >> 1] += y * y;
        }
    }
    float mu[2], rstd[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        mu[hf] = quad_sum(sm[hf]) / 128.0f;
        const float var =
            fmaxf(quad_sum(ss[hf]) / 128.0f - mu[hf] * mu[hf], 0.0f);
        rstd[hf] = 1.0f / sqrtf(var + kLnEps);
    }
    uint32_t o0a[8][4], o1a[8][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        const int col = nt * 8 + 2 * t;
        const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
        const float2 be = *reinterpret_cast<const float2*>(beta + col);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            // round to bf16 BEFORE the residual add
            const float o0 = round_bf16(
                (acc[nt][2 * hf] - mu[hf]) * rstd[hf] * ga.x + be.x);
            const float o1 = round_bf16(
                (acc[nt][2 * hf + 1] - mu[hf]) * rstd[hf] * ga.y + be.y);
            float s0 = o0, s1 = o1;
            if (has_res) {
                const float2 r2 = unpack_bf16(rv[nt][hf]);
                s0 = o0 + r2.x;
                s1 = o1 + r2.y;
            }
            put_a(o0a, nt, hf, pack_bf16(o0, o1));
            put_a(o1a, nt, hf, pack_bf16(s0, s1));
        }
    }
    if (!has_res || res_dual) store_frag_rows(out0, 128, r0, nrow, o0a, 8);
    if (has_res)
        store_frag_rows(res_dual ? out1 : out0, 128, r0, nrow, o1a, 8);
}

// the LayerNorm backward of the strip: y = acc + b3 recomputed, g = dout0
// (+ dout1 with dual), their rows given as column pairs (load_pairs), zero
// past the strip; dy = rstd ((g gamma - mean) - xhat mean(g gamma xhat))
// as the A fragments of dy16 in ha; the column sums of g xhat, g and dy
// added to cdg, cdbe, cdb3
__device__ __forceinline__ void strip_ln_bwd(float acc[16][4],
                                             uint32_t ha[8][4],
                                             const float* b3,
                                             const float* gamma,
                                             const uint32_t d0[16][2],
                                             const uint32_t d1[16][2],
                                             bool dual, int nrow, float* cdg,
                                             float* cdbe, float* cdb3) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float sm[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(b3 + nt * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float y = acc[nt][e] + (e & 1 ? bb.y : bb.x);
            acc[nt][e] = y;
            sm[e >> 1] += y;
            ss[e >> 1] += y * y;
        }
    }
    float mu[2], rstd[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        mu[hf] = quad_sum(sm[hf]) * (1.0f / 128.0f);
        const float var = fmaxf(
            quad_sum(ss[hf]) * (1.0f / 128.0f) - mu[hf] * mu[hf], 0.0f);
        rstd[hf] = 1.0f / sqrtf(var + kLnEps);
    }
    auto load_g = [&](int nt, int hf, float& g0, float& g1) {
        g0 = g1 = 0.0f;
        if (g + 8 * hf < nrow) {
            const float2 a = unpack_bf16(d0[nt][hf]);
            g0 = a.x;
            g1 = a.y;
            if (dual) {
                const float2 b = unpack_bf16(d1[nt][hf]);
                g0 += b.x;
                g1 += b.y;
            }
        }
    };
    float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
        float pg[8][2], pb[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int nt = ch * 8 + i, col = nt * 8 + 2 * t;
            const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
            pg[i][0] = pg[i][1] = pb[i][0] = pb[i][1] = 0.0f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                float gv[2];
                load_g(nt, hf, gv[0], gv[1]);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float xh = (acc[nt][2 * hf + e] - mu[hf]) * rstd[hf];
                    const float gx = gv[e] * (e ? ga.y : ga.x);
                    m1[hf] += gx;
                    m2[hf] += gx * xh;
                    pg[i][e] += gv[e] * xh;
                    pb[i][e] += gv[e];
                }
            }
        }
        col_add8(pg, ch * 8, cdg);
        col_add8(pb, ch * 8, cdbe);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        m1[hf] = quad_sum(m1[hf]) * (1.0f / 128.0f);
        m2[hf] = quad_sum(m2[hf]) * (1.0f / 128.0f);
    }
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
        float pd[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int nt = ch * 8 + i, col = nt * 8 + 2 * t;
            const float2 ga = *reinterpret_cast<const float2*>(gamma + col);
            pd[i][0] = pd[i][1] = 0.0f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                float gv[2], dy[2];
                load_g(nt, hf, gv[0], gv[1]);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float xh = (acc[nt][2 * hf + e] - mu[hf]) * rstd[hf];
                    const float gx = gv[e] * (e ? ga.y : ga.x);
                    dy[e] = rstd[hf] * ((gx - m1[hf]) - xh * m2[hf]);
                    pd[i][e] += dy[e];
                }
                put_a(ha, nt, hf, pack_bf16(dy[0], dy[1]));
            }
        }
        col_add8(pd, ch * 8, cdb3);
    }
}

// d = acc * gate (gelu'(.) of the layer): its bf16 A fragments into ha,
// its column sums added to col
__device__ __forceinline__ void strip_gate(const float acc[16][4],
                                           const float gk[16][4],
                                           uint32_t ha[8][4], float* col) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
        float ps[8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int nt = ch * 8 + i;
            ps[i][0] = ps[i][1] = 0.0f;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const float v0 = acc[nt][2 * hf] * gk[nt][2 * hf];
                const float v1 = acc[nt][2 * hf + 1] * gk[nt][2 * hf + 1];
                ps[i][0] += v0;
                ps[i][1] += v1;
                put_a(ha, nt, hf, pack_bf16(v0, v1));
            }
        }
        col_add8(ps, ch * 8, col);
    }
}

// dx = bf16(acc (+ the residual's cotangent rr, in float32)) into the
// strip's rows of dst (row stride ld), its first 16 npairs columns
__device__ __forceinline__ void strip_dx(const float acc[16][4],
                                         const uint32_t rr[16][2],
                                         bool has_res, bf16* dst, int ld,
                                         int r0, int nrow, int npairs) {
    uint32_t dxa[8][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float v0 = acc[nt][2 * hf], v1 = acc[nt][2 * hf + 1];
            if (has_res) {
                const float2 r = unpack_bf16(rr[nt][hf]);
                v0 += r.x;
                v1 += r.y;
            }
            put_a(dxa, nt, hf, pack_bf16(v0, v1));
        }
    }
    store_frag_rows(dst, ld, r0, nrow, dxa, npairs);
}

template <bool LN>
__global__ void __launch_bounds__(RW * 32, 1) fused_mlp_fwd_rows(FwdParams p) {
    const Common& c = p.c;
    const RowsCtx rc = rows_init(c, LN, false);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_strips = (c.M + 15) / 16;
    const int stride = gridDim.x * RW;
    const bf16* sW1 = rc.sW;
    const bf16* sW2 = rc.sW + (size_t)c.k1 * LDR;
    const bf16* sW3 = sW2 + (size_t)128 * LDR;
    const bf16* res = c.res_idx >= 0 ? c.part[c.res_idx] : nullptr;

    int s = blockIdx.x * RW + warp;
    if (s < n_strips)
        warp_load_strip(c, rc.sx, rc.sp, s * 16, min(16, c.M - s * 16));
    cp_async_commit();
    for (; s < n_strips; s += stride) {
        const int r0 = s * 16, nrow = min(16, c.M - r0);
        cp_async_wait<0>();
        __syncwarp();
        float acc[16][4];
        uint32_t ha[8][4];
        float unused[16][4];
        // ---- layer 1 ----
        zero_acc16(acc);
        if (c.k1 > 0)
            rows_mma_smem<false>(acc, rc.sx, c.k1 + 8, sW1, LDR, c.k1 / 16, 16);
        rows_hidden<false>(acc, c.k1 > 0, rc.sB,
                           c.pre != nullptr ? rc.sp : nullptr, nullptr, ha,
                           unused, nullptr, r0, nrow);
        __syncwarp();
        if (s + stride < n_strips)
            warp_load_strip(c, rc.sx, rc.sp, (s + stride) * 16,
                            min(16, c.M - (s + stride) * 16));
        cp_async_commit();
        // ---- layer 2 ----
        zero_acc16(acc);
        rows_mma_reg<false>(acc, ha, sW2, LDR, 8, 16);
        rows_hidden<false>(acc, true, rc.sB + 128, nullptr, nullptr, ha,
                           unused, nullptr, r0, nrow);
        // ---- layer 3 ----
        if (LN) {
            // the residual's rows, loaded ahead of the product
            uint32_t rv[16][2];
            if (res != nullptr) load_pairs(rv, res, r0, nrow);
            zero_acc16(acc);
            rows_mma_reg<false>(acc, ha, sW3, LDR, 8, 16);
            strip_ln_out(acc, rc.sB + 256, rc.sB + 384, rc.sB + 512, rv,
                         res != nullptr, c.res_dual != 0, p.out0, p.out1, r0,
                         nrow);
        } else {
            // narrow head: 16 zero-padded columns
            zero_acc16(acc);
            rows_mma_reg<false>(acc, ha, rc.sW3n, LDN, 8, 2);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int row = g + 8 * (e >> 1);
                    const int col = nt * 8 + 2 * t + (e & 1);
                    if (row < nrow && col < c.d_out)
                        p.out0[(size_t)(r0 + row) * c.d_out + col] =
                            __float2bfloat16(acc[nt][e] + rc.sB[256 + col]);
                }
            }
        }
    }
    cp_async_wait<0>();
}

template <bool LN>
__global__ void __launch_bounds__(RW * 32, 1) fused_mlp_bwd_rows(BwdParams p) {
    const Common& c = p.c;
    const RowsCtx rc = rows_init(c, LN, true);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int n_strips = (c.M + 15) / 16;
    const int stride = gridDim.x * RW;
    const int n_bias = 4 * 128 + c.dp;
    const bf16* sW1 = rc.sW;
    const bf16* sW2 = rc.sW + (size_t)c.k1 * LDR;
    const bf16* sW3 = sW2 + (size_t)128 * LDR;
    // column sums: db1 | db2 | db3 (dp) | dgamma | dbeta
    float* cdb1 = rc.sCol;
    float* cdb2 = rc.sCol + 128;
    float* cdb3 = rc.sCol + 256;
    float* cdg = rc.sCol + 256 + c.dp;
    float* cdbe = cdg + 128;
    for (int i = lane; i < n_bias; i += 32) rc.sCol[i] = 0.0f;
    // gelu'(h1pre) waits in this warp's x region between layer 1 and step 5
    // ([64][32] float32, this lane's column: no bank conflicts)
    float* g1s = reinterpret_cast<float*>(rc.sx) + lane;
    const bool dual = c.res_idx >= 0 && c.res_dual;

    int s = blockIdx.x * RW + warp;
    if (s < n_strips)
        warp_load_strip(c, rc.sx, rc.sp, s * 16, min(16, c.M - s * 16));
    cp_async_commit();
    for (; s < n_strips; s += stride) {
        const int r0 = s * 16, nrow = min(16, c.M - r0);
        cp_async_wait<0>();
        __syncwarp();
        float acc[16][4], gk[16][4];
        uint32_t ha[8][4];
        // ---- 1. h1, gelu'(h1pre) -> the x region ----
        zero_acc16(acc);
        if (c.k1 > 0)
            rows_mma_smem<false>(acc, rc.sx, c.k1 + 8, sW1, LDR, c.k1 / 16,
                                 16);
        rows_hidden<true>(acc, c.k1 > 0, rc.sB,
                          c.pre != nullptr ? rc.sp : nullptr, nullptr, ha, gk,
                          p.h1s, r0, nrow);
        __syncwarp();                 // every lane is past its x reads
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) g1s[(nt * 4 + e) * 32] = gk[nt][e];
        // ---- 2. h2, gelu'(h2pre) in registers ----
        zero_acc16(acc);
        rows_mma_reg<false>(acc, ha, sW2, LDR, 8, 16);
        rows_hidden<true>(acc, true, rc.sB + 128, nullptr, nullptr, ha, gk,
                          p.h2s, r0, nrow);
        // ---- 3. dy -> ha (the A fragments of dy16) ----
        if (LN) {
            zero_acc16(acc);
            rows_mma_reg<false>(acc, ha, sW3, LDR, 8, 16);
            float sm[2] = {0.0f, 0.0f}, ss[2] = {0.0f, 0.0f};
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
                const float2 bb =
                    *reinterpret_cast<const float2*>(rc.sB + 256 + nt * 8 + 2 * t);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float y = acc[nt][e] + (e & 1 ? bb.y : bb.x);
                    acc[nt][e] = y;
                    sm[e >> 1] += y;
                    ss[e >> 1] += y * y;
                }
            }
            float mu[2], rstd[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                mu[hf] = quad_sum(sm[hf]) * (1.0f / 128.0f);
                const float var = fmaxf(
                    quad_sum(ss[hf]) * (1.0f / 128.0f) - mu[hf] * mu[hf], 0.0f);
                rstd[hf] = 1.0f / sqrtf(var + kLnEps);
            }
            // g = dout0 (+ dout1) of 8 tiles, loaded as each sweep needs
            // them (twice: held across both sweeps they would not fit the
            // registers beside y and gelu'(h2pre)); zero past the strip
            uint32_t d0[8][2], d1[8][2];
            auto load_chunk = [&](int ch) {
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = min(g + 8 * hf, nrow - 1);
                        const size_t at = (size_t)(r0 + row) * 128 +
                                          (ch * 8 + i) * 8 + 2 * t;
                        d0[i][hf] = *reinterpret_cast<const uint32_t*>(
                            p.dout0 + at);
                        if (dual)
                            d1[i][hf] = *reinterpret_cast<const uint32_t*>(
                                p.dout1 + at);
                    }
            };
            auto load_g = [&](int i, int hf, float& g0, float& g1) {
                g0 = g1 = 0.0f;
                if (g + 8 * hf < nrow) {
                    const float2 a = unpack_bf16(d0[i][hf]);
                    g0 = a.x;
                    g1 = a.y;
                    if (dual) {
                        const float2 b = unpack_bf16(d1[i][hf]);
                        g0 += b.x;
                        g1 += b.y;
                    }
                }
            };
            float m1[2] = {0.0f, 0.0f}, m2[2] = {0.0f, 0.0f};
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
                float pg[8][2], pb[8][2];
                load_chunk(ch);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int nt = ch * 8 + i, col = nt * 8 + 2 * t;
                    const float2 ga =
                        *reinterpret_cast<const float2*>(rc.sB + 384 + col);
                    pg[i][0] = pg[i][1] = pb[i][0] = pb[i][1] = 0.0f;
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        float gv[2];
                        load_g(i, hf, gv[0], gv[1]);
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float xh =
                                (acc[nt][2 * hf + e] - mu[hf]) * rstd[hf];
                            const float gx = gv[e] * (e ? ga.y : ga.x);
                            m1[hf] += gx;
                            m2[hf] += gx * xh;
                            pg[i][e] += gv[e] * xh;
                            pb[i][e] += gv[e];
                        }
                    }
                }
                col_add8(pg, ch * 8, cdg);
                col_add8(pb, ch * 8, cdbe);
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                m1[hf] = quad_sum(m1[hf]) * (1.0f / 128.0f);
                m2[hf] = quad_sum(m2[hf]) * (1.0f / 128.0f);
            }
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
                float pd[8][2];
                load_chunk(ch);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int nt = ch * 8 + i, col = nt * 8 + 2 * t;
                    const float2 ga =
                        *reinterpret_cast<const float2*>(rc.sB + 384 + col);
                    pd[i][0] = pd[i][1] = 0.0f;
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        float gv[2], dy[2];
                        load_g(i, hf, gv[0], gv[1]);
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const float xh =
                                (acc[nt][2 * hf + e] - mu[hf]) * rstd[hf];
                            const float gx = gv[e] * (e ? ga.y : ga.x);
                            dy[e] = rstd[hf] * ((gx - m1[hf]) - xh * m2[hf]);
                            pd[i][e] += dy[e];
                        }
                        put_a(ha, nt, hf, pack_bf16(dy[0], dy[1]));
                    }
                }
                col_add8(pd, ch * 8, cdb3);
            }
            store_frag_rows(p.dys, 128, r0, nrow, ha, 8);
        } else {
            // dy = dout: d_out real columns, zero up to 16 (one 16-deep slice)
            float v[2][2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = g + 8 * hf, col = nt * 8 + 2 * t + e;
                        v[nt][hf][e] = (row < nrow && col < c.d_out)
                            ? __bfloat162float(
                                  p.dout0[(size_t)(r0 + row) * c.d_out + col])
                            : 0.0f;
                    }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int col = nt * 8 + 2 * t;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    put_a(ha, nt, hf, pack_bf16(v[nt][hf][0], v[nt][hf][1]));
                rows_col_add(v[nt][0][0] + v[nt][1][0],
                             v[nt][0][1] + v[nt][1][1], cdb3 + col);
            }
            store_frag_rows(p.dys, 16, r0, nrow, ha, 1);
        }
        // ---- 4. dh2pre = (dy16 W3^T) * gelu'(h2pre), db2 ----
        zero_acc16(acc);
        if (LN) rows_mma_reg<true>(acc, ha, sW3, LDR, 8, 16);
        else rows_mma_reg<true>(acc, ha, rc.sW3n, LDN, 1, 16);
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
            float ps[8][2];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int nt = ch * 8 + i;
                ps[i][0] = ps[i][1] = 0.0f;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const float v0 = acc[nt][2 * hf] * gk[nt][2 * hf];
                    const float v1 = acc[nt][2 * hf + 1] * gk[nt][2 * hf + 1];
                    ps[i][0] += v0;
                    ps[i][1] += v1;
                    put_a(ha, nt, hf, pack_bf16(v0, v1));
                }
            }
            col_add8(ps, ch * 8, cdb2);
        }
        store_frag_rows(p.dh2s, 128, r0, nrow, ha, 8);
        // ---- 5. dh1pre = (dh2pre16 W2^T) * gelu'(h1pre), db1, dpre ----
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)          // back from the x region,
#pragma unroll                                   // ahead of the product
            for (int e = 0; e < 4; ++e) gk[nt][e] = g1s[(nt * 4 + e) * 32];
        zero_acc16(acc);
        rows_mma_reg<true>(acc, ha, sW2, LDR, 8, 16);
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
            float ps[8][2];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int nt = ch * 8 + i;
                ps[i][0] = ps[i][1] = 0.0f;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const float v0 = acc[nt][2 * hf] * gk[nt][2 * hf];
                    const float v1 = acc[nt][2 * hf + 1] * gk[nt][2 * hf + 1];
                    ps[i][0] += v0;
                    ps[i][1] += v1;
                    put_a(ha, nt, hf, pack_bf16(v0, v1));
                }
            }
            col_add8(ps, ch * 8, cdb1);
        }
        store_frag_rows(p.dh1s, 128, r0, nrow, ha, 8);
        if (p.dpre != nullptr) store_frag_rows(p.dpre, 128, r0, nrow, ha, 8);
        // the x region is free again: the next strip's x rows come in
        // while this one's dx is computed
        __syncwarp();
        if (s + stride < n_strips)
            warp_load_strip(c, rc.sx, rc.sp, (s + stride) * 16,
                            min(16, c.M - (s + stride) * 16));
        cp_async_commit();
        // ---- 6. dx_i = dh1pre16 W1_i^T (+ the residual's cotangent), in
        // pieces of at most 128 columns (the accumulator's width): a part
        // wider than 128 (the segment engine's one 256-wide node part)
        // takes two ----
        int off = 0;
        for (int pi = 0; pi < c.n_parts; ++pi) {
            const int w = c.width[pi];
            const bool has_res = pi == c.res_idx;   // then w == 128
            uint32_t rr[16][2];          // the residual's cotangent rows
            if (has_res) load_pairs(rr, c.res_dual ? p.dout1 : p.dout0, r0,
                                    nrow);
            for (int c0 = 0; c0 < w; c0 += 128) {
                const int wc = min(128, w - c0);
                zero_acc16(acc);
                rows_mma_reg<true>(acc, ha, sW1 + (size_t)(off + c0) * LDR,
                                   LDR, 8, wc / 8);
                uint32_t dxa[8][4];
#pragma unroll
                for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        float v0 = acc[nt][2 * hf], v1 = acc[nt][2 * hf + 1];
                        if (has_res) {
                            const float2 r = unpack_bf16(rr[nt][hf]);
                            v0 += r.x;
                            v1 += r.y;
                        }
                        put_a(dxa, nt, hf, pack_bf16(v0, v1));
                    }
                }
                store_frag_rows(p.dx[pi] + c0, w, r0, nrow, dxa, wc / 16);
            }
            off += w;
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    // the block's column sums: its warps' in order
    extern __shared__ __align__(128) unsigned char smem[];
    const RowsSmem L = rows_layout(c.k1, c.dp, c.pre != nullptr, LN, true);
    const float* cols = reinterpret_cast<const float*>(smem + L.col);
    for (int i = threadIdx.x; i < n_bias; i += RW * 32) {
        float v = 0.0f;
        for (int w = 0; w < RW; ++w) v += cols[w * n_bias + i];
        p.colsum[(size_t)blockIdx.x * n_bias + i] = v;
    }
}

// ============ H = 128, a first layer too wide for the rows: wgmma ==========
//
// The segment engine's edge MLP feeds the chain one 384-wide part. Resident
// at leading dimension 136, W1 | W2 | W3 and the rows kernels' x strips
// take more shared memory than a block has, and the tiles that stream the
// weights pull all of them from L2 again for every 64 rows. Here a block
// holds the weights once, unpadded, in the 128-byte-swizzled panel layout
// of the warpgroup products (384 x 128, 128 x 128, 128 x 128 bf16: 160 KB
// at k1 = 384), read MN-major by x W and K-major by dh W^T from the same
// copy. Two warpgroups a block each own a 64-row tile, a warp its 16-row
// strip; every product is one wgmma m64n128k16 a 16-deep slice, A from the
// warp's registers (the strip's bf16 fragments, exactly as in the row
// kernels: h1, h2, dy16, dh2pre16, dh1pre16 never touch shared memory), B
// from the resident panels, the tensor cores reading each weight once per 64
// rows instead of each warp loading it into registers. x comes in 64-column
// pieces ([16][64] bf16 a warp, swizzled, no padding) through a ring of
// slots by cp.async, the next pieces in flight while a piece is multiplied;
// the pre and residual rows go to registers ahead of their products. The
// epilogues are the row kernels' (strip_*). The backward keeps
// gelu'(h1pre) and gelu'(h2pre) in a per-warp slot of the workspace from
// their layer to the step that takes them (device memory, L2-resident; each
// load overlaps that step's product), so that the LayerNorm backward has
// their registers, and its column sums per warp in shared memory, written
// once a block. Code size matters as much as registers here: each strip
// epilogue unrolls to thousands of instructions, and a loop body holding
// every one of them runs out of the instruction cache (per-phase clock
// counters on an H100 showed the backward's GELU epilogues 7x slower than
// the same code in the forward); so the backward's two hidden layers, and
// its two gate steps, run through one loop body each (K3 at the 384-wide
// part 1.13 -> 0.66 ms; the forward, a third of the code, stays unrolled:
// rolled it took 4% longer).
//
// The plan takes them for every backward at H = 128 with LayerNorm and a
// first layer (the rows' backward keeps the encoders' pre-only form), and
// for the forward where the rows' layout does not fit: on an H100 the
// backward here took 0.49 ms at the block edge form against the rows'
// 1.01, 0.31 at the segment node form against 0.57, while the rows'
// forward stays faster (0.134 against 0.173 at the block edge form). Persistent blocks, grid = min(SMs, tile pairs). Bound: bytes (the
// row streams); the products are a few % of the tensor cores' time.

constexpr int WG_SLOT = 16 * 128;     // bytes of an x piece: 16 rows x 64 bf16
constexpr int WG_SLOTS_FWD = 4;       // the forward's ring, pieces a warp
constexpr int WG_SLOTS_BWD = 2;       // the backward's

struct WgSmem {
    size_t w2, w3, x, col, vec, total;     // W1 panels at 0
};

// the weights' panels, each warp's ring, the backward's column sums and
// its vectors b1 | b2 | b3 | gamma (read by every epilogue; from device
// memory they would miss an L1 that the backward's row streams keep
// evicting); and 1024 bytes to align the panels
__host__ __device__ inline WgSmem wg_layout(int k1, bool bwd) {
    WgSmem L;
    size_t o = (size_t)k1 * 256;
    L.w2 = o;
    o += 128 * 256;
    L.w3 = o;
    o += 128 * 256;
    L.x = o;
    o += (size_t)RW * (bwd ? WG_SLOTS_BWD : WG_SLOTS_FWD) * WG_SLOT;
    L.col = o;
    o += bwd ? (size_t)RW * (4 * 128 + 128) * 4 : 0;
    L.vec = o;
    o += bwd ? (size_t)4 * 128 * 4 : 0;
    L.total = o + 1024;
    return L;
}

struct WgCtx {
    unsigned char* sm;   // 1024-aligned: W1 panels
    unsigned char* w2;
    unsigned char* w3;
    bf16* sx;            // this warp's ring
    float* col;          // this warp's column sums (backward)
    float* vec;          // b1 | b2 | b3 | gamma (backward)
    int warp, wi, lane;  // wi: the warp's strip in its warpgroup's tile
    int tile0, tstride, n_tiles, npc;   // npc: x pieces a strip
};

// x piece p of a strip: columns c0 .. c0 + w (w <= 64) of part pi; kr: the
// W1 row of its first column
__device__ __forceinline__ void wg_piece(const Common& c, int p, int& pi,
                                         int& c0, int& w, int& kr) {
    kr = 0;
    for (pi = 0; pi < c.n_parts; ++pi) {
        const int n = (c.width[pi] + 63) >> 6;
        if (p < n) {
            c0 = p * 64;
            w = min(64, c.width[pi] - c0);
            kr += c0;
            return;
        }
        p -= n;
        kr += c.width[pi];
    }
    pi = c0 = w = 0;
}

// this warp's rows of a tile: r0, nrow (0 past M, and then r0 = 0, so that
// the clamped loads stay inside the arrays)
__device__ __forceinline__ void wg_rows(const Common& c, int tile, int wi,
                                        int& r0, int& nrow) {
    r0 = tile * 64 + wi * 16;
    nrow = min(16, c.M - r0);
    if (nrow <= 0) {
        r0 = 0;
        nrow = 0;
    }
}

// piece q of this warp's walk (its k-th tile, k = q / npc) into slot q % NS,
// rows past the strip zero-filled; one commit group, empty past the walk
template <int NS>
__device__ __forceinline__ void wg_fetch(const Common& c, const WgCtx& w,
                                         int q) {
    const int k = q / w.npc, p = q - k * w.npc;
    const int tile = w.tile0 + k * w.tstride;
    if (tile < w.n_tiles) {
        int r0, nrow, pi, c0, wd, kr;
        wg_rows(c, tile, w.wi, r0, nrow);
        wg_piece(c, p, pi, c0, wd, kr);
        unsigned char* slot =
            reinterpret_cast<unsigned char*>(w.sx) + (q % NS) * WG_SLOT;
        const int cw = wd >> 3;
        const bf16* src = c.part[pi];
        const int ld = c.width[pi];
        for (int i = w.lane; i < 16 * cw; i += 32) {
            const int r = i / cw, ch = i - r * cw;
            const bool ok = r < nrow;
            cp_async16(slot + r * 128 + ((ch ^ (r & 7)) << 4),
                       src + (size_t)(ok ? r0 + r : 0) * ld + c0 + ch * 8, ok);
        }
    }
    cp_async_commit();
}

// the weights staged, the ring's first pieces in flight, one barrier
template <int NS>
__device__ __forceinline__ void wg_init(const Common& c, WgCtx& w,
                                        unsigned char* raw, bool bwd) {
    unsigned char* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    const WgSmem L = wg_layout(c.k1, bwd);
    w.sm = sm;
    w.w2 = sm + L.w2;
    w.w3 = sm + L.w3;
    w.warp = threadIdx.x >> 5;
    w.wi = w.warp & 3;
    w.lane = threadIdx.x & 31;
    w.sx = reinterpret_cast<bf16*>(sm + L.x + (size_t)w.warp * NS * WG_SLOT);
    w.col = bwd ? reinterpret_cast<float*>(sm + L.col) +
                      w.warp * (4 * 128 + 128)
                : nullptr;
    w.vec = reinterpret_cast<float*>(sm + L.vec);
    if (bwd) {
        const float* src[4] = {c.b1, c.b2, c.b3, c.gamma};
        for (int i = threadIdx.x; i < 4 * 128; i += THREADS)
            w.vec[i] = src[i >> 7][i & 127];
    }
    w.tile0 = blockIdx.x * 2 + (w.warp >> 2);
    w.tstride = gridDim.x * 2;
    w.n_tiles = (c.M + 63) / 64;
    w.npc = 0;
    for (int pi = 0; pi < c.n_parts; ++pi) w.npc += (c.width[pi] + 63) >> 6;
    stage_panels(sm, c.w1, c.k1, THREADS);
    stage_panels(w.w2, c.w2, 128, THREADS);
    stage_panels(w.w3, c.w3, 128, THREADS);
    cp_async_commit();
    for (int q = 0; q < NS; ++q) wg_fetch<NS>(c, w, q);
    cp_async_wait<NS>();             // the weights
    fence_proxy_async();
    __syncthreads();
}

// acc = x W1 for this warp's strip of its warpgroup's tile: pieces q0 ..
// q0 + npc of the walk from the ring, each slot refilled with the piece NS
// further on as soon as its fragments are in registers
template <int NS>
__device__ __forceinline__ void wg_layer1(const Common& c, const WgCtx& w,
                                          int q0, float acc[16][4]) {
    zero_acc16(acc);
    const int row = w.lane & 15;
    for (int p = 0; p < w.npc; ++p) {
        const int q = q0 + p;
        int pi, c0, wd, kr;
        wg_piece(c, p, pi, c0, wd, kr);
        const int ks = wd >> 4;
        cp_async_wait<NS - 1>();
        __syncwarp();
        const bf16* slot = w.sx + (q % NS) * (WG_SLOT / 2);
        uint32_t a[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < ks) {
                const int ch = 2 * j + (w.lane >> 4);
                ldsm_x4(a[j], slot + row * 64 + ((ch ^ (row & 7)) << 3));
            }
        }
        __syncwarp();
        wg_fetch<NS>(c, w, q + NS);
        wg_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j < ks)
                wgmma_128<1>(acc, a[j],
                             wg_desc(w.sm + (size_t)(kr + 16 * j) * 128,
                                     c.k1 * 128, 1024));
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < 4; ++j) wg_keep(a[j]);
    }
    wg_fence_acc(acc);
}

// acc = A W (MN-major, W 128 x 128 at w) over 8 slices of A's fragments a;
// wg_done completes it
__device__ __forceinline__ void wg_mma_mn(float acc[16][4],
                                          const uint32_t a[8][4],
                                          const unsigned char* w) {
    zero_acc16(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
        wgmma_128<1>(acc, a[s], wg_desc(w + s * 2048, 16384, 1024));
    wg_commit();
}

// acc = A W[n0 .. n0 + 128, :]^T (K-major: a W of `rows` rows at w)
__device__ __forceinline__ void wg_mma_k(float acc[16][4],
                                         const uint32_t a[8][4],
                                         const unsigned char* w, int rows,
                                         int n0) {
    zero_acc16(acc);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 8; ++s)
        wgmma_128<0>(acc, a[s],
                     wg_desc(w + (size_t)(s >> 2) * rows * 128 +
                                 (size_t)n0 * 128 + (s & 3) * 32,
                             16, 1024));
    wg_commit();
}

__device__ __forceinline__ void wg_done(float acc[16][4],
                                        const uint32_t a[8][4]) {
    wg_wait<0>();
#pragma unroll
    for (int s = 0; s < 8; ++s) wg_keep(a[s]);
    wg_fence_acc(acc);
}

__global__ void __launch_bounds__(THREADS, 1) fused_mlp_fwd_wg(FwdParams p) {
    const Common& c = p.c;
    extern __shared__ __align__(1024) unsigned char wg_smem[];
    WgCtx w;
    wg_init<WG_SLOTS_FWD>(c, w, wg_smem, false);
    const bf16* res = c.res_idx >= 0 ? c.part[c.res_idx] : nullptr;
    for (int k = 0;; ++k) {
        const int tile = w.tile0 + k * w.tstride;
        if (tile >= w.n_tiles) break;
        int r0, nrow;
        wg_rows(c, tile, w.wi, r0, nrow);
        float acc[16][4], unused[16][4];
        uint32_t ha[8][4], pv[16][2], rv[16][2];
        if (c.pre != nullptr) load_pairs(pv, c.pre, r0, nrow);
        // ---- layer 1 ----
        wg_layer1<WG_SLOTS_FWD>(c, w, k * w.npc, acc);
        rows_hidden<false>(acc, true, c.b1, nullptr,
                           c.pre != nullptr ? pv : nullptr, ha, unused,
                           nullptr, r0, nrow);
        // ---- layer 2 ----
        wg_mma_mn(acc, ha, w.w2);
        wg_done(acc, ha);
        rows_hidden<false>(acc, true, c.b2, nullptr, nullptr, ha, unused,
                           nullptr, r0, nrow);
        // ---- layer 3, the residual's rows loaded while it runs ----
        wg_mma_mn(acc, ha, w.w3);
        if (res != nullptr) load_pairs(rv, res, r0, nrow);
        wg_done(acc, ha);
        strip_ln_out(acc, c.b3, c.gamma, c.beta, rv, res != nullptr,
                     c.res_dual != 0, p.out0, p.out1, r0, nrow);
    }
    cp_async_wait<0>();
}

// DUAL: the residual's two output cotangents (res_dual), a compile-time
// choice so that the single-cotangent form holds no registers for a second
template <bool DUAL>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_bwd_wg(BwdParams p) {
    const Common& c = p.c;
    extern __shared__ __align__(1024) unsigned char wg_smem[];
    WgCtx w;
    wg_init<WG_SLOTS_BWD>(c, w, wg_smem, true);
    const int n_bias = 4 * 128 + c.dp;
    // column sums: db1 | db2 | db3 | dgamma | dbeta
    float* cdb1 = w.col;
    float* cdb2 = w.col + 128;
    float* cdb3 = w.col + 256;
    float* cdg = w.col + 256 + c.dp;
    float* cdbe = cdg + 128;
    for (int i = w.lane; i < n_bias; i += 32) w.col[i] = 0.0f;
    __syncwarp();
    // gelu'(h1pre) between layer 1 and step 5, gelu'(h2pre) between layer 2
    // and step 4 (so that the LayerNorm backward has their registers): this
    // warp's two [16][32] float4 slots of the workspace
    float4* g1s = reinterpret_cast<float4*>(c.spill) +
                  ((size_t)blockIdx.x * RW + w.warp) * 2 * 16 * 32;
    float4* g2s = g1s + 16 * 32;
    // gk from a slot, 16 bytes a tile
    auto reload = [&](float gk[16][4], const float4* gs) {
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
            const float4 v = __ldcg(gs + nt * 32 + w.lane);
            gk[nt][0] = v.x;
            gk[nt][1] = v.y;
            gk[nt][2] = v.z;
            gk[nt][3] = v.w;
        }
    };
    for (int k = 0;; ++k) {
        const int tile = w.tile0 + k * w.tstride;
        if (tile >= w.n_tiles) break;
        int r0, nrow;
        wg_rows(c, tile, w.wi, r0, nrow);
        float acc[16][4], gk[16][4];
        uint32_t ha[8][4], pv[16][2];
        if (c.pre != nullptr) load_pairs(pv, c.pre, r0, nrow);
        // ---- 1, 2. h1 and h2; gelu'(h1pre), gelu'(h2pre) -> the
        // workspace (one loop body for both layers: see below) ----
        wg_layer1<WG_SLOTS_BWD>(c, w, k * w.npc, acc);
#pragma unroll 1
        for (int l = 0; l < 2; ++l) {
            if (l == 1) {
                wg_mma_mn(acc, ha, w.w2);
                wg_done(acc, ha);
            }
            rows_hidden<true, true>(
                acc, true, w.vec + 128 * l, nullptr,
                l == 0 && c.pre != nullptr ? pv : nullptr, ha, gk,
                l ? p.h2s : p.h1s, r0, nrow, l ? g2s : g1s);
        }
        // ---- 3. dy -> ha (the A fragments of dy16); the output
        // cotangent's rows come in while the product runs ----
        wg_mma_mn(acc, ha, w.w3);
        uint32_t d0[16][2], d1[16][2];
        load_pairs(d0, p.dout0, r0, nrow);
        if (DUAL) load_pairs(d1, p.dout1, r0, nrow);
        wg_done(acc, ha);
        strip_ln_bwd(acc, ha, w.vec + 256, w.vec + 384, d0, d1, DUAL, nrow,
                     cdg, cdbe, cdb3);
        store_frag_rows(p.dys, 128, r0, nrow, ha, 8);
        // ---- 4, 5. dh2pre = (dy16 W3^T) * gelu'(h2pre), db2; dh1pre =
        // (dh2pre16 W2^T) * gelu'(h1pre), db1, dpre; each gelu' comes back
        // while its product runs ----
#pragma unroll 1
        for (int l = 0; l < 2; ++l) {
            wg_mma_k(acc, ha, l ? w.w2 : w.w3, 128, 0);
            reload(gk, l ? g1s : g2s);
            wg_done(acc, ha);
            strip_gate(acc, gk, ha, l ? cdb1 : cdb2);
            store_frag_rows(l ? p.dh1s : p.dh2s, 128, r0, nrow, ha, 8);
        }
        if (p.dpre != nullptr) store_frag_rows(p.dpre, 128, r0, nrow, ha, 8);
        // ---- 6. dx_i = dh1pre16 W1_i^T (+ the residual's cotangent), 128
        // columns (W1 rows) a product ----
        int off = 0;
        for (int pi = 0; pi < c.n_parts; ++pi) {
            const int wd = c.width[pi];
            const bool has_res = pi == c.res_idx;   // then wd == 128
            uint32_t rr[16][2];
            for (int c0 = 0; c0 < wd; c0 += 128) {
                wg_mma_k(acc, ha, w.sm, c.k1, off + c0);
                if (has_res)
                    load_pairs(rr, c.res_dual ? p.dout1 : p.dout0, r0, nrow);
                wg_done(acc, ha);
                strip_dx(acc, rr, has_res, p.dx[pi] + c0, wd, r0, nrow,
                         min(128, wd - c0) / 16);
            }
            off += wd;
        }
    }
    cp_async_wait<0>();
    __syncthreads();
    // the block's column sums: its warps' in order
    const float* cols = w.col - w.warp * (4 * 128 + 128);
    for (int i = threadIdx.x; i < n_bias; i += THREADS) {
        float v = 0.0f;
        for (int u = 0; u < RW; ++u) v += cols[u * (4 * 128 + 128) + i];
        p.colsum[(size_t)blockIdx.x * n_bias + i] = v;
    }
}

// ============================ weight gradients =============================

// grid (output tiles of all jobs, row chunks, lanes); 128 x 128 tile, warps
// 4 (32 rows each) x 2 (64 columns each)
__global__ void __launch_bounds__(THREADS) fused_mlp_wgrad(gfvgn::WgParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* sbuf = reinterpret_cast<bf16*>(smem);   // STAGES2 x [A | B]
    const int stage_elems = 2 * KR * LD2;

    // this block's job and tile
    int tile = blockIdx.x, ji = 0;
    int mt = 0, ntl = 0;
    for (ji = 0; ji < p.n_jobs; ++ji) {
        const int tm_ = (p.job[ji].m + 127) / 128;
        const int tn_ = (p.job[ji].n + 127) / 128;
        if (tile < tm_ * tn_) {
            mt = tile / tn_;
            ntl = tile - mt * tn_;
            break;
        }
        tile -= tm_ * tn_;
    }
    const gfvgn::WgJob J = p.job[ji];
    const int mv = min(128, J.m - mt * 128);
    const int nvv = min(128, J.n - ntl * 128);
    const int lane_id = blockIdx.z;
    const int row_begin = lane_id * p.rows_per_lane + blockIdx.y * p.chunk_rows;
    const int row_end = min(row_begin + p.chunk_rows,
                            (lane_id + 1) * p.rows_per_lane);
    const int nsteps = (row_end - row_begin + KR - 1) / KR;
    const bf16* A = J.a + mt * 128;
    const bf16* B = J.b + ntl * 128;
    const int a_cpr = mv >> 3, b_cpr = nvv >> 3;

    auto load_stage = [&](int s) {
        bf16* sa = sbuf + (size_t)(s % STAGES2) * stage_elems;
        bf16* sb = sa + KR * LD2;
        const int rb = row_begin + s * KR;
        for (int i = threadIdx.x; i < KR * a_cpr; i += THREADS) {
            const int r = i / a_cpr, ch = i - r * a_cpr;
            const bool ok = rb + r < row_end;
            cp_async16(sa + r * LD2 + ch * 8,
                       A + (size_t)(ok ? rb + r : row_begin) * J.lda + ch * 8,
                       ok);
        }
        for (int i = threadIdx.x; i < KR * b_cpr; i += THREADS) {
            const int r = i / b_cpr, ch = i - r * b_cpr;
            const bool ok = rb + r < row_end;
            cp_async16(sb + r * LD2 + ch * 8,
                       B + (size_t)(ok ? rb + r : row_begin) * J.ldb + ch * 8,
                       ok);
        }
    };

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 64;
    const int nv = max(0, min(8, (nvv - n0) / 8));
    float acc[2][8][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) zero_acc(acc[mb]);

    for (int s = 0; s < STAGES2 - 1; ++s) {
        if (s < nsteps) load_stage(s);
        cp_async_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        cp_async_wait<STAGES2 - 2>();
        __syncthreads();
        if (s + STAGES2 - 1 < nsteps) load_stage(s + STAGES2 - 1);
        cp_async_commit();
        const bf16* sa = sbuf + (size_t)(s % STAGES2) * stage_elems;
        const bf16* sb = sa + KR * LD2;
#pragma unroll
        for (int ks = 0; ks < KR / 16; ++ks) {
            // A^T fragments: A stored [k][m]
            uint32_t af[2][4];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
                ldsm_x4_t(af[mb], sa + (ks * 16 + (lane & 7) +
                                        ((lane >> 4) << 3)) * LD2 +
                                       m0 + mb * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (2 * q < nv) {
                    uint32_t bfr[4];
                    ldsm_x4_t(bfr, sb + (ks * 16 + (lane & 7) +
                                         (((lane >> 3) & 1) << 3)) * LD2 +
                                        n0 + q * 16 + ((lane >> 4) << 3));
#pragma unroll
                    for (int mb = 0; mb < 2; ++mb) {
                        mma16816(acc[mb][2 * q], af[mb], bfr[0], bfr[1]);
                        mma16816(acc[mb][2 * q + 1], af[mb], bfr[2], bfr[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

    float* out = p.part +
        ((size_t)lane_id * gridDim.y + blockIdx.y) * p.n_w + J.out;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if (nt < nv) {
                const int col = ntl * 128 + n0 + nt * 8 + 2 * t;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int rl = m0 + mb * 16 + g + 8 * hf;
                    if (rl < mv) {
                        float2 v;
                        v.x = acc[mb][nt][2 * hf];
                        v.y = acc[mb][nt][2 * hf + 1];
                        *reinterpret_cast<float2*>(
                            out + (size_t)(mt * 128 + rl) * J.ldo + col) = v;
                    }
                }
            }
        }
    }
}

// ================================ host side ================================

// The kernels of a shape, in the order make_plan tries them: the row
// kernels (H = 128 where their layout fits a block), the warpgroup kernels
// (H = 128 with LayerNorm where it does not, and first for every such
// backward with a first layer), the tiles (any other shape).
enum Form { FORM_ROWS = 0, FORM_WG = 1, FORM_TILES = 2 };

struct Shape {
    int w0, w1, h, has_pre, ln, d_out, M, lanes, bwd;
};

struct Plan {
    int form;
    int tm, pw, np;
    bool stream;
    size_t smem;
    int grid;
    int k1, dp;
    // backward
    int tiles2, chunk_rows, n_chunks, n_w, n_bias;
    // workspace byte offsets
    size_t o_spill, o_h1, o_h2, o_dy, o_dh2, o_dh1, o_colsum, o_part, bytes;
};

bool width_ok(int w) {
    return w > 0 && ((w < 128 && w % 16 == 0) || w % 128 == 0);
}

// 0 and the plan, or cudaErrorInvalidValue for a shape no kernel takes
int make_plan(const Shape& s, Plan& P) {
    int max_smem = 0, n_sm = 0;
    const int err = device_limits(max_smem, n_sm);
    if (err != 0) return err;
    if (s.h < 128 || s.h % 128 != 0 || s.w0 < 0 || s.w1 < 0 ||
        (s.w0 > 0 && !width_ok(s.w0)) || (s.w1 > 0 && !width_ok(s.w1)) ||
        (s.w1 > 0 && s.w0 == 0) || (s.w0 == 0 && !s.has_pre) || s.M < 0 ||
        s.lanes < 1 || s.lanes > 65535)
        return (int)cudaErrorInvalidValue;
    if (s.ln ? s.d_out != s.h : (s.d_out < 1 || s.d_out > 16))
        return (int)cudaErrorInvalidValue;
    P.k1 = s.w0 + s.w1;
    P.dp = s.ln ? s.h : 16;
    bool found = false;
    P.form = FORM_TILES;
    P.tm = 16;
    P.pw = 128;
    P.np = 1;
    P.stream = false;
    const bool wg_ok = s.h == 128 && s.ln && P.k1 > 0 &&
                       wg_layout(P.k1, s.bwd != 0).total <= (size_t)max_smem;
    const RowsSmem R = rows_layout(P.k1, P.dp, s.has_pre != 0, s.ln != 0,
                                   s.bwd != 0);
    const bool rows_ok = s.h == 128 && R.total <= (size_t)max_smem;
    if (wg_ok && (!rows_ok || s.bwd)) {
        P.form = FORM_WG;
        P.tm = 64;
        P.smem = wg_layout(P.k1, s.bwd != 0).total;
        found = true;
    } else if (rows_ok) {
        P.form = FORM_ROWS;
        P.smem = R.total;
        found = true;
    }
    for (int tm = 64; tm >= 16 && !found; tm >>= 1) {
        for (int st = 0; st < 2 && !found; ++st) {
            const int pw = (8 / (tm / 16)) * 64;
            const Smem L = smem_layout(tm, pw, P.k1, s.h, P.dp, s.has_pre != 0,
                                       s.ln != 0, st == 1, s.bwd != 0);
            if (L.total <= (size_t)max_smem) {
                P.tm = tm;
                P.pw = pw;
                P.np = (s.h + pw - 1) / pw;
                P.stream = st == 1;
                P.smem = L.total;
                found = true;
            }
        }
    }
    if (!found) return (int)cudaErrorInvalidValue;
    // a rows block takes 8 strips of 16 rows, a warpgroup block two tiles
    // of 64
    const int n_tiles = P.form == FORM_ROWS ? (s.M + 16 * RW - 1) / (16 * RW)
                      : P.form == FORM_WG ? (s.M + 127) / 128
                                          : (s.M + P.tm - 1) / P.tm;
    P.grid = n_tiles < n_sm ? n_tiles : n_sm;
    if (P.grid < 1) P.grid = 1;
    size_t o = 0;
    P.o_spill = o;
    if (P.form == FORM_TILES && P.np > 1)
        o += align128((size_t)P.grid * 3 * (P.np - 1) * 32 * THREADS * 4);
    if (P.form == FORM_WG && s.bwd)     // gelu': [2][64][32] a warp
        o += align128((size_t)P.grid * RW * 2 * 64 * 32 * 4);
    P.n_w = P.k1 * s.h + s.h * s.h + s.h * P.dp;
    P.n_bias = 4 * s.h + P.dp;
    if (s.bwd) {
        if (s.M % s.lanes != 0) return (int)cudaErrorInvalidValue;
        const size_t row = (size_t)s.M * s.h * 2;
        P.o_h1 = o; o += align128(row);
        P.o_h2 = o; o += align128(row);
        P.o_dy = o; o += align128((size_t)s.M * P.dp * 2);
        P.o_dh2 = o; o += align128(row);
        P.o_dh1 = o; o += align128(row);
        P.o_colsum = o; o += align128((size_t)P.grid * P.n_bias * 4);
        // pass 2: tiles of the jobs, then chunks for about 2 blocks an SM
        const int ht = (s.h + 127) / 128;
        P.tiles2 = ((s.w0 + 127) / 128) * ht + ((s.w1 + 127) / 128) * ht +
                   ht * ht + ht * ((P.dp + 127) / 128);
        gfvgn::wg_chunking(P.tiles2, s.M / s.lanes, s.lanes, n_sm,
                           P.chunk_rows, P.n_chunks);
        P.o_part = o;
        o += align128((size_t)s.lanes * P.n_chunks * P.n_w * 4);
    }
    P.bytes = o;
    return 0;
}

void fill_common(Common& c, const Shape& s, const Plan& P, const void* part0,
                 const void* part1, const void* w1, const void* pre,
                 const void* b1, const void* w2, const void* b2,
                 const void* w3, const void* b3, const void* gamma,
                 const void* beta, int res_idx, int res_dual,
                 unsigned char* ws) {
    c.part[0] = static_cast<const bf16*>(part0);
    c.part[1] = static_cast<const bf16*>(part1);
    c.width[0] = s.w0;
    c.width[1] = s.w1;
    c.n_parts = (s.w0 > 0) + (s.w1 > 0);
    c.k1 = P.k1;
    c.pre = static_cast<const bf16*>(pre);
    c.w1 = static_cast<const bf16*>(w1);
    c.w2 = static_cast<const bf16*>(w2);
    c.w3 = static_cast<const bf16*>(w3);
    c.b1 = static_cast<const float*>(b1);
    c.b2 = static_cast<const float*>(b2);
    c.b3 = static_cast<const float*>(b3);
    c.gamma = static_cast<const float*>(gamma);
    c.beta = static_cast<const float*>(beta);
    c.M = s.M;
    c.H = s.h;
    c.d_out = s.d_out;
    c.dp = P.dp;
    c.res_idx = res_idx;
    c.res_dual = res_dual;
    c.tm = P.tm;
    c.wr = P.tm / 16;
    c.pw = P.pw;
    c.np = P.np;
    c.spill = (P.form == FORM_TILES && P.np > 1) ||
                      (P.form == FORM_WG && s.bwd)
        ? reinterpret_cast<float*>(ws + P.o_spill) : nullptr;
    // the weight products of a tile, in the order the kernels take them
    const int h = s.h;
    int n = 0;
    auto add = [&](const void* w, int ldw, int k, int nn, int trans,
                   int res_row) {
        Prod& q = c.prod[n++];
        q.w = static_cast<const bf16*>(w);
        q.ldw = ldw;
        q.k = k;
        q.n = nn;
        q.trans = trans;
        q.res_row = res_row;
    };
    const bf16* w1p = static_cast<const bf16*>(w1);
    if (P.k1 > 0) add(w1, h, P.k1, h, 0, 0);
    add(w2, h, h, h, 0, P.k1);
    if (s.ln) add(w3, h, h, h, 0, P.k1 + h);
    if (s.bwd) {
        if (s.ln) add(w3, h, h, h, 1, P.k1 + h);
        add(w2, h, h, h, 1, P.k1);
        if (s.w0 > 0) add(w1p, h, h, s.w0, 1, 0);
        if (s.w1 > 0) add(w1p + (size_t)s.w0 * h, h, h, s.w1, 1, s.w0);
    }
    c.n_prod = n;
    int cpt = 0;
    for (int i = 0; i < n; ++i)
        cpt += ((c.prod[i].k + KC - 1) / KC) *
               ((c.prod[i].n + P.pw - 1) / P.pw);
    c.cpt = cpt;
}

template <typename K, typename Pa>
int launch(K kernel, int grid, size_t smem, cudaStream_t st, const Pa& p) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
}

static_assert(RW * 32 == THREADS, "rows blocks launch with THREADS threads");

}  // namespace

// The weight-gradient pass of every backward kernel (see mma_sm90.cuh):
// grid (output tiles of all jobs, row chunks, lanes), then the fixed-order
// reduction of the partials into total[0 .. n_w).
extern "C" int gfvgn_wgrad(const gfvgn::WgParams* q, int lanes, float* total,
                           cudaStream_t st) {
    const size_t smem = (size_t)STAGES2 * 2 * KR * LD2 * 2;
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(gfvgn::wg_tiles(*q), q->n_chunks, lanes);
    fused_mlp_wgrad<<<grid, THREADS, smem, st>>>(*q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    lane_reduce<<<(q->n_w + 255) / 256, 256, 0, st>>>(
        q->part, total, q->n_w, q->n_w, lanes, q->n_chunks);
    return (int)cudaGetLastError();
}

// Bytes of workspace the forward (backward = 0) or the backward needs for
// this shape, or -1 when no kernel takes it (widths, or shared memory).
// The same plan's kernels go to *form (where not null): FORM_ROWS (0),
// FORM_WG (1) or FORM_TILES (2), and a block's shared-memory bytes to
// *smem (where not null).
extern "C" long long gfvgn_fused_mlp_workspace(int width0, int width1, int h,
                                               int has_pre, int layer_norm,
                                               int d_out, int M, int lanes,
                                               int backward, int* form,
                                               long long* smem) {
    const Shape s{width0, width1, h, has_pre, layer_norm, d_out, M, lanes,
                  backward};
    Plan P;
    if (make_plan(s, P) != 0) return -1;
    if (form != nullptr) *form = P.form;
    if (smem != nullptr) *smem = (long long)P.smem;
    return (long long)P.bytes;
}

extern "C" int gfvgn_fused_mlp(const void* part0, const void* part1,
                               int width0, int width1, int h,
                               const void* w1, const void* pre,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3,
                               const void* gamma, const void* beta,
                               void* out0, void* out1, int M, int res_idx,
                               int res_dual, int layer_norm, int d_out,
                               void* workspace, void* stream) {
    const Shape s{width0, width1, h, pre != nullptr, layer_norm, d_out, M, 1,
                  0};
    Plan P;
    int err = make_plan(s, P);
    if (err != 0) return err;
    const int n_parts = (width0 > 0) + (width1 > 0);
    if (res_idx >= n_parts || (res_idx >= 0 && !layer_norm) ||
        (res_idx >= 0 && (res_idx == 0 ? width0 : width1) != h))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    FwdParams p;
    fill_common(p.c, s, P, part0, part1, w1, pre, b1, w2, b2, w3, b3, gamma,
                beta, res_idx, res_dual,
                static_cast<unsigned char*>(workspace));
    p.out0 = static_cast<bf16*>(out0);
    p.out1 = static_cast<bf16*>(out1);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (P.form == FORM_ROWS)
        return layer_norm ? launch(fused_mlp_fwd_rows<true>, P.grid, P.smem, st, p)
                          : launch(fused_mlp_fwd_rows<false>, P.grid, P.smem, st, p);
    if (P.form == FORM_WG) return launch(fused_mlp_fwd_wg, P.grid, P.smem, st, p);
    if (layer_norm)
        return P.stream ? launch(fused_mlp_fwd_tiles<true, true>, P.grid, P.smem, st, p)
                        : launch(fused_mlp_fwd_tiles<true, false>, P.grid, P.smem, st, p);
    return P.stream ? launch(fused_mlp_fwd_tiles<false, true>, P.grid, P.smem, st, p)
                    : launch(fused_mlp_fwd_tiles<false, false>, P.grid, P.smem, st, p);
}

// total: the float32 slab [dW1 (k1 x h) | dW2 (h x h) | dW3 (h x dp) | db1 |
// db2 | db3 (dp) | dgamma | dbeta], weights summed per lane, each lane's sum
// rounded to bf16, the lanes summed in order
extern "C" int gfvgn_fused_mlp_bwd(const void* part0, const void* part1,
                                   int width0, int width1, int h,
                                   const void* w1, const void* pre,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* w3,
                                   const void* b3, const void* gamma,
                                   const void* dout0, const void* dout1,
                                   void* dx0, void* dx1, void* dpre,
                                   void* total, int M, int res_idx,
                                   int res_dual, int layer_norm, int d_out,
                                   int lanes, void* workspace,
                                   void* stream) {
    const Shape s{width0, width1, h, pre != nullptr, layer_norm, d_out, M,
                  lanes, 1};
    Plan P;
    int err = make_plan(s, P);
    if (err != 0) return err;
    const int n_parts = (width0 > 0) + (width1 > 0);
    if (res_idx >= n_parts || (res_idx >= 0 && !layer_norm) ||
        (res_idx >= 0 && (res_idx == 0 ? width0 : width1) != h) ||
        (res_idx >= 0 && res_dual && dout1 == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    if (M == 0) {
        cudaError_t e = cudaMemsetAsync(total, 0,
                                        (size_t)(P.n_w + P.n_bias) * 4, st);
        return (int)e;
    }
    BwdParams p;
    fill_common(p.c, s, P, part0, part1, w1, pre, b1, w2, b2, w3, b3, gamma,
                nullptr, res_idx, res_dual, ws);
    p.dout0 = static_cast<const bf16*>(dout0);
    p.dout1 = static_cast<const bf16*>(dout1);
    p.dx[0] = static_cast<bf16*>(dx0);
    p.dx[1] = static_cast<bf16*>(dx1);
    p.dpre = static_cast<bf16*>(dpre);
    p.h1s = reinterpret_cast<bf16*>(ws + P.o_h1);
    p.h2s = reinterpret_cast<bf16*>(ws + P.o_h2);
    p.dys = reinterpret_cast<bf16*>(ws + P.o_dy);
    p.dh2s = reinterpret_cast<bf16*>(ws + P.o_dh2);
    p.dh1s = reinterpret_cast<bf16*>(ws + P.o_dh1);
    p.colsum = reinterpret_cast<float*>(ws + P.o_colsum);
    if (P.form == FORM_ROWS)
        err = layer_norm ? launch(fused_mlp_bwd_rows<true>, P.grid, P.smem, st, p)
                         : launch(fused_mlp_bwd_rows<false>, P.grid, P.smem, st, p);
    else if (P.form == FORM_WG)
        err = res_idx >= 0 && res_dual
            ? launch(fused_mlp_bwd_wg<true>, P.grid, P.smem, st, p)
            : launch(fused_mlp_bwd_wg<false>, P.grid, P.smem, st, p);
    else if (layer_norm)
        err = P.stream ? launch(fused_mlp_bwd_tiles<true, true>, P.grid, P.smem, st, p)
                       : launch(fused_mlp_bwd_tiles<true, false>, P.grid, P.smem, st, p);
    else
        err = P.stream ? launch(fused_mlp_bwd_tiles<false, true>, P.grid, P.smem, st, p)
                       : launch(fused_mlp_bwd_tiles<false, false>, P.grid, P.smem, st, p);
    if (err != 0) return err;

    // pass 2: the weight gradients per lane, summed in a fixed order
    gfvgn::WgParams q;
    const bf16* x0 = static_cast<const bf16*>(part0);
    const bf16* x1 = static_cast<const bf16*>(part1);
    int nj = 0;
    auto job = [&](const bf16* a, int lda, int m, const bf16* b, int ldb,
                   int n, int out, int ldo) {
        q.job[nj++] = gfvgn::WgJob{a, lda, m, b, ldb, n, out, ldo};
    };
    if (width0 > 0) job(x0, width0, width0, p.dh1s, h, h, 0, h);
    if (width1 > 0) job(x1, width1, width1, p.dh1s, h, h, width0 * h, h);
    job(p.h1s, h, h, p.dh2s, h, h, P.k1 * h, h);
    job(p.h2s, h, h, p.dys, P.dp, P.dp, P.k1 * h + h * h, P.dp);
    q.n_jobs = nj;
    q.rows_per_lane = M / lanes;
    q.chunk_rows = P.chunk_rows;
    q.n_chunks = P.n_chunks;
    q.part = reinterpret_cast<float*>(ws + P.o_part);
    q.n_w = P.n_w;
    float* tot = static_cast<float*>(total);
    err = gfvgn_wgrad(&q, lanes, tot, st);
    if (err != 0) return err;
    lane_reduce<<<(P.n_bias + 255) / 256, 256, 0, st>>>(
        p.colsum, tot + P.n_w, P.n_bias, 0, 1, P.grid);
    return (int)cudaGetLastError();
}
