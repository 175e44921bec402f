// K7's block row tiles (instantiated by fused_slice_pool_bwd.cu) and the
// plans of K6 and K7 (pool_run), shared by fused_slice_pool.cu (the forward)
// and fused_slice_pool_bwd.cu (the backward), which compile in parallel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"

namespace {

// ========================== K7: block row tiles ==========================
//
// Any C % 128 == 0 up to 512 with H heads of D = C / H and G slices, H*G %
// 128 == 0 (the JAX package's condition), H and G powers of two (G from 8 to
// 128), where a tile fits a block's shared memory and a thread's slots and
// columns are an instantiated variant (pool_shape); every other shape runs
// K7's run-time path (fused_slice_pool_bwd.cu). The projections fx = x Wfx,
// xm = x Wx and dx = dfx16 Wfx^T + dxm16 Wx^T run on the tensor cores as
// block products of a row tile (mma_sm90.cuh): Wfx, Wx resident in shared
// memory where they fit (C = 128), otherwise streamed through the ring. The
// shapes the nets use have their head width D and slices G compiled in
// (slice_pool_tiles<NS, DPT, DC, GC>), so the per-slot loops unroll and a
// slot's operands stay in registers; any other shape runs the same code
// with D and G at run time.
//
// Slots. A (head, slice) pair is a slot. The L = min(G, 32) lanes of a lane
// group own one head's slices (SPT = G / L each: g = lane + L j), so a
// head's softmax reduces over one group by shuffles; the 256 / L groups of a
// block take HPG = H / groups heads each (h = group + groups k) or, where
// there are fewer heads than groups, DS = groups / H groups share a head and
// split its rows (the softmax) and its D columns (the pooling). A thread's
// NS = HPG * SPT slots and its DPT = D / DS columns are fixed over all its
// tiles, so its pooled sums (dWsl) stay in registers.
//
// K7 replaces the Pallas TPU kernel _make_bwd_kernel of
// gen_fvgn_tpu/ops/fused_slice_attn.py (:170-236, called at :297). Inputs:
// the forward's operands and the cotangents dslice_w [B, N, H*G] (bf16),
// dtokens [B, H, G, D] (the per-head diagonal blocks; the TPU kernel's
// off-diagonal blocks are zero) and dnorm [B, H, G]. For every node n, head
// h, slice g:
//
//   fx, xm, l recomputed as in the forward; w = softmax_G(l*inv_temp) in
//   float32 from x (the stored bf16 slice_w is never read); wm = w*mask[n]
//   dw_m   = sum_d fx[n,h,d]*dtok[h,g,d] + dnorm[h,g]
//   dw_all = dslice_w[n,h,g] + dw_m*mask[n]
//   ds     = w*(dw_all - sum_g w*dw_all)
//   dinv_temp[h] += ds*l;  dl = ds*inv_temp;  dbsl[g] += dl;  dl16 = bf16(dl)
//   dfx[n,h,d] = sum_g wm*dtok[h,g,d];  dxm[n,h,d] = sum_g dl16*Wsl[d,g]
//   dWsl_h += xm_h^T dl16_h;  dbfx += dfx;  dbx += dxm
//   dWfx = x^T bf16(dfx);  dWx = x^T bf16(dxm)
//   dx = bf16(bf16(dfx) Wfx^T + bf16(dxm) Wx^T)
//
// What bounds it on the H100: bytes (x and dslice_w in, dx out: 768 bytes a
// node at C = 128 against ~4 products of 128 x 128 a node). Two passes and a
// fixed-order reduction, as K3 and K5b:
//   the row pass (slice_pool_tiles<..., true>), per tile of tm rows (x and
//     dslice_w in by cp.async, the next tile's while this one computes where
//     two buffers fit):
//     - the projections (tensor cores); the logits l = bf16(xm_h Wsl + bsl)
//       on the tensor cores (a head's [tm x D] x [D x G] product);
//     - the row stage: each lane group one head, RI rows at once, the exact
//       max, the exp on __expf and the float32 normalisation by shuffles
//       over the group, dw_m from the slot's dtokens row in registers, the
//       softmax backward; it writes w*mask and dl16 transposed ([slot][row])
//       and keeps dinv_temp and dbsl per slot in registers;
//     - dWsl_h += xm_h^T dl16_h into the thread's registers;
//     - the column stage: dfx and dxm in float32 on the CUDA cores, each
//       thread a 4-row by 4-column block of a head, so one 16-byte load of
//       w*mask, dl16, dtokens and Wsl feeds 32 products; written as bf16
//       rows for the weight-gradient pass and as the A operands of dx;
//   the weight-gradient pass (fused_mlp_wgrad through gfvgn_wgrad): per batch
//     lane dWfx = x^T dfx16 and dWx = x^T dxm16;
//   lane_reduce: the blocks' partials of dWsl, dbsl, dinv_temp, dbfx, dbx
//     and the weight gradients, each lane's weight gradients rounded to bf16,
//     summed in a fixed order (no atomics: the same bits every run).
// Rounding points as K6 (the TPU kernel's), and dl, dfx, dxm rounded to bf16
// before the products that take them.

struct PoolShape {
    int c, h, g, d, hg, L, spt, groups, hpg, ds, ns, dpt;
};

constexpr int RI = 4;       // rows of a row-stage pass
constexpr int CS_ITEMS = 4; // column-stage items a thread (tm * C / 16 <= 1024)

bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// the slot mapping of a shape, false where no kernel takes it
bool pool_shape(int c, int h, int g, PoolShape& s) {
    if (c < 128 || c % 128 != 0 || c > 512 || h < 1 || c % h != 0 ||
        (h * g) % 128 != 0 || !is_pow2(g) || g < 8 || g > 128 || !is_pow2(h))
        return false;
    s.c = c; s.h = h; s.g = g; s.d = c / h; s.hg = h * g;
    s.L = g < 32 ? g : 32;
    s.spt = g / s.L;
    s.groups = 256 / s.L;
    if (h >= s.groups) { s.hpg = h / s.groups; s.ds = 1; }
    else { s.hpg = 1; s.ds = s.groups / h; }
    s.ns = s.hpg * s.spt;
    if (s.d % s.ds != 0) return false;
    s.dpt = s.d / s.ds;
    // the instantiated slice_pool_tiles<NS, DPT, ...>
    return (s.ns == 1 || s.ns == 2 || s.ns == 4) &&
           (s.dpt == 8 || s.dpt == 16 || s.dpt == 32 || s.dpt == 48 ||
            s.dpt == 64) &&
           s.ns * s.dpt <= 64;
}

struct PoolPlan {
    int tm, nbuf, resident, tok_smem;
    size_t smem;
    int o_w, o_x, o_fx, o_xm, o_wm, o_dl, o_wsl, o_tok, o_dsw;
};

struct PoolParams {
    const bf16* x;          // [B, N, C]
    const float* mask;      // [B, N] (mask_bstride N) or [N] (stride 0)
    const bf16* wfx;        // [C, C]
    const float* bfx;
    const bf16* wx;
    const float* bx;
    const bf16* wsl;        // [D, G]
    const float* bsl;       // [G]
    const float* inv_temp;  // [H]
    const bf16* dslice_w;   // [B, N, H*G]
    const float* dtok;      // [B, H, G, D]
    const float* dnorm;     // [B, H, G]
    bf16* dx;               // [B, N, C]
    bf16* dfxs;             // [B, N, C] dfx16 rows for the weight-gradient pass
    bf16* dxms;             // [B, N, C] dxm16 rows
    float* part;            // [B, n_chunks, part_len]
    PoolShape s;
    int N, mask_bstride, rows_per_chunk, n_chunks, part_len;
    PoolPlan L;             // the tile and its shared-memory layout
};


size_t pool_layout(const PoolShape& s, int tm, int resident, int nbuf,
                   int tok_smem, PoolPlan& L) {
    const int c = s.c, wr = tm / 16, pw = (8 / wr) * 64;
    size_t o = 0;
    L.o_w = (int)o;
    o += align128(resident ? (size_t)2 * c * (c + 8) * 2
                           : (size_t)2 * ring_slot(pw) * 2);
    L.o_x = (int)o;
    o += align128((size_t)nbuf * tm * (c + 8) * 2);
    L.o_fx = (int)o;
    o += align128((size_t)tm * (c + 8) * 2);
    L.o_xm = (int)o;
    o += align128((size_t)tm * (c + 8) * 2);
    // w*mask and dl16 transposed, [hg][tm + 4] float and [hg][tm + 8] bf16
    // (the column stage reads four rows of a slice at once)
    L.o_wm = (int)o;
    o += align128((size_t)s.hg * (tm + 4) * 4);
    L.o_dl = (int)o;
    o += align128((size_t)s.hg * (tm + 8) * 2);
    // Wsl as [D][G + 1] float, [G][D + 4] float and [D][G + 8] bf16
    L.o_wsl = (int)o;
    o += align128((size_t)s.d * (s.g + 1) * 4 + (size_t)s.g * (s.d + 4) * 4 +
                  (size_t)s.d * (s.g + 8) * 2);
    L.o_tok = (int)o;
    o += align128(tok_smem ? (size_t)s.hg * (s.d + 4) * 4 : 0);
    L.o_dsw = (int)o;
    o += align128((size_t)nbuf * tm * (s.hg + 8) * 2);
    // the end reuses the start: [ds][2][hg] and [tm / 4][2][c] floats
    const size_t fin = (size_t)(2 * s.ds * s.hg + 2 * (tm / 4) * c) * 4;
    return o > fin ? o : fin;
}

// this thread's slot i: head, slice, and its group's part (rows, columns)
struct Slot {
    int h, g;
};

__device__ __forceinline__ Slot slot_of(const PoolShape& s, int i, int& q) {
    const int gid = threadIdx.x / s.L, li = threadIdx.x % s.L;
    const int k = i / s.spt, j = i - k * s.spt;
    Slot r;
    if (s.ds == 1) {
        r.h = gid + s.groups * k;
        q = 0;
    } else {
        r.h = gid % s.h;
        q = gid / s.h;
    }
    r.g = li + s.L * j;
    return r;
}

// v[i] = the reduction of v over the slots of the same head (a lane group
// and the thread's slices of that head: i / spt alike; the rows of the
// row stage are consecutive blocks of NS values)
template <int N, bool MAX>
__device__ __forceinline__ void head_reduce(float v[N], int spt, int L) {
    float gr[N];
#pragma unroll
    for (int i = 0; i < N; ++i) gr[i] = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        if (off < L) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const float o = __shfl_xor_sync(0xffffffffu, gr[i], off);
                gr[i] = MAX ? fmaxf(gr[i], o) : gr[i] + o;
            }
        }
    }
    if (spt == 1) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = gr[i];
        return;
    }
    const int sh = spt == 2 ? 1 : 2;         // spt is 1, 2 or 4
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float r = MAX ? -INFINITY : 0.0f;
#pragma unroll
        for (int i2 = 0; i2 < N; ++i2)
            if ((i2 >> sh) == (i >> sh))
                r = MAX ? fmaxf(r, gr[i2]) : r + gr[i2];
        v[i] = r;
    }
}

// 8 bf16 at p (16-byte aligned) into v[0..7]
__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(w[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

// sum_d row[d] * col[d * ldc] over d < D (row bf16 in shared memory, 16-byte
// aligned; col float)
template <int DC>
__device__ __forceinline__ float dot_bf16_f32(const bf16* row, const float* col,
                                              int ldc, int d_rt) {
    const int d = DC ? DC : d_rt;
    float a = 0.0f;
#pragma unroll
    for (int d0 = 0; d0 < d; d0 += 8) {
        float v[8];
        load8(row + d0, v);
#pragma unroll
        for (int t = 0; t < 8; ++t) a = fmaf(v[t], col[(d0 + t) * ldc], a);
    }
    return a;
}

// sum_d row[d] * col[d] over d < DC, col in registers
template <int DC>
__device__ __forceinline__ float dot_bf16_reg(const bf16* row,
                                              const float* col) {
    float a = 0.0f;
#pragma unroll
    for (int d0 = 0; d0 < DC; d0 += 8) {
        float v[8];
        load8(row + d0, v);
#pragma unroll
        for (int t = 0; t < 8; ++t) a = fmaf(v[t], col[d0 + t], a);
    }
    return a;
}

// the tile's projections: fx = bf16(x Wfx + bfx) -> sFX, xm = bf16(x Wx +
// bx) -> sXM
__device__ __forceinline__ void pool_projections(const Blk& b,
                                                 const PoolParams& p,
                                                 const WSrc& Wfx,
                                                 const WSrc& Wx,
                                                 const bf16* xb, bf16* sFX,
                                                 bf16* sXM) {
    const int c = p.s.c, ld = c + 8;
    float acc[8][4];
#pragma unroll
    for (int which = 0; which < 2; ++which) {
        const WSrc W = which ? Wx : Wfx;
        const float* bias = which ? p.bx : p.bfx;
        bf16* dst = which ? sXM : sFX;
        for (int n0 = 0; n0 < c; n0 += b.pw) {
            const int nv = block_product<false>(b, acc, xb, ld, c, W, n0, c);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
                    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = b.wrow * 16 + b.g + 8 * hf;
                        store_bf16x2(dst + row * ld + col, acc[nt][2 * hf] + bb.x,
                                     acc[nt][2 * hf + 1] + bb.y);
                    }
                }
            }
        }
    }
}

// logits of this thread's slots for tile row r: l[i] = bf16(xm_h Wsl[:, g]
// + bsl[g]), s[i] = l[i] * inv_temp[h]
template <int NS, int DC>
__device__ __forceinline__ void slot_logits(int ldx, int d, int g,
                                            const Slot sl[NS],
                                            const float bsl[NS],
                                            const float it[NS],
                                            const bf16* sXM, const float* sWsl,
                                            int r, float* l, float* s) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const float a = dot_bf16_f32<DC>(sXM + r * ldx + sl[i].h * d,
                                         sWsl + sl[i].g, g + 1, d);
        l[i] = round_bf16(a + bsl[i]);
        s[i] = l[i] * it[i];
    }
}

// the block's tiles: rows of batch lane blockIdx.y in chunk blockIdx.x
struct Rows {
    int b, begin, end, n_tiles;
};

__device__ __forceinline__ Rows block_rows(const PoolParams& p) {
    Rows r;
    r.b = blockIdx.y;
    r.begin = blockIdx.x * p.rows_per_chunk;
    r.end = min(p.N, r.begin + p.rows_per_chunk);
    r.n_tiles = (r.end - r.begin + p.L.tm - 1) / p.L.tm;
    return r;
}

// DC, GC: the head width and the slices as compile-time constants (the
// shapes the nets use), or 0 for the runtime ones of p.s
template <int NS, int DPT, int DC, int GC>
__global__ void __launch_bounds__(BK_THREADS, 1)
slice_pool_tiles(PoolParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const PoolShape& S = p.s;
    const int D_ = DC ? DC : S.d, G_ = GC ? GC : S.g;
    const int L_ = GC ? (GC < 32 ? GC : 32) : S.L;
    const int SPT_ = GC ? G_ / L_ : S.spt;
    const int c = S.c, ldx = c + 8;
    const int ldwt = p.L.tm + 4, lddt = p.L.tm + 8, ldwst = S.d + 4;
    const bool res = p.L.resident != 0;
    bf16* sW = reinterpret_cast<bf16*>(smem + p.L.o_w);
    const Blk b = make_blk(p.L.tm, sW);
    const WSrc Wfx{p.wfx, c, res ? sW : nullptr, ldx};
    const WSrc Wx{p.wx, c, res ? sW + (size_t)c * ldx : nullptr, ldx};
    bf16* sX = reinterpret_cast<bf16*>(smem + p.L.o_x);
    bf16* sFX = reinterpret_cast<bf16*>(smem + p.L.o_fx);
    bf16* sXM = reinterpret_cast<bf16*>(smem + p.L.o_xm);
    bf16* sDF = sFX;       // dfx16 and dxm16, once fx and xm are done with
    bf16* sDX = sXM;
    float* sWMT = reinterpret_cast<float*>(smem + p.L.o_wm);
    bf16* sDLT = reinterpret_cast<bf16*>(smem + p.L.o_dl);
    float* sWsl = reinterpret_cast<float*>(smem + p.L.o_wsl);
    float* sWslT = sWsl + S.d * (S.g + 1);
    bf16* sWslB = reinterpret_cast<bf16*>(sWslT + S.g * ldwst);
    const int ldwb = S.g + 8;
    float* sTok = reinterpret_cast<float*>(smem + p.L.o_tok);
    bf16* sDSW = reinterpret_cast<bf16*>(smem + p.L.o_dsw);
    const int lddsw = S.hg + 8;
    const Rows R = block_rows(p);
    const int tm = p.L.tm;
    const bf16* xlane = p.x + (size_t)R.b * p.N * c;
    const float* mlane = p.mask + (size_t)R.b * p.mask_bstride;

    if (res) {
        stage_matrix(sW, ldx, p.wfx, c, c);
        stage_matrix(sW + (size_t)c * ldx, ldx, p.wx, c, c);
    }
    for (int i = threadIdx.x; i < S.d * S.g; i += BK_THREADS) {
        const int dd = i / S.g, gg = i - dd * S.g;
        const float v = __bfloat162float(p.wsl[i]);
        sWsl[dd * (S.g + 1) + gg] = v;
        sWslT[gg * ldwst + dd] = v;
        sWslB[dd * ldwb + gg] = p.wsl[i];
    }
    // dtokens of this lane as [H*G][D + 1] (shared memory) or [H*G][D]
    const float* tok_l = p.dtok + (size_t)R.b * S.hg * S.d;
    const int ldt = p.L.tok_smem ? S.d + 4 : S.d;
    if (p.L.tok_smem)
        for (int i = threadIdx.x; i < S.hg * S.d; i += BK_THREADS) {
            const int sl = i / S.d, dd = i - sl * S.d;
            sTok[sl * (S.d + 4) + dd] = tok_l[i];
        }
    const float* tok = p.L.tok_smem ? sTok : tok_l;
    auto load_rows = [&](int t, int buf) {
        const int r0 = R.begin + t * tm, nrow = min(tm, R.end - r0);
        load_tile_rows(sX + (size_t)buf * tm * ldx, ldx, xlane, c, r0, nrow,
                       tm);
        load_tile_rows(sDSW + (size_t)buf * tm * lddsw, lddsw,
                           p.dslice_w + (size_t)R.b * p.N * S.hg, S.hg, r0,
                           nrow, tm);
    };
    if (R.n_tiles > 0) load_rows(0, 0);
    cp_async_commit();

    Slot sl[NS];
    int q = 0, so[NS];
    float bsl_s[NS], it_s[NS], dn_s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        sl[i] = slot_of(S, i, q);
        so[i] = sl[i].h * S.g + sl[i].g;
        bsl_s[i] = p.bsl[sl[i].g];
        it_s[i] = p.inv_temp[sl[i].h];
        dn_s[i] = p.dnorm[(size_t)R.b * S.hg + so[i]];
    }
    // pooled sums of this thread's slots and columns q*DPT ..: dWsl; and
    // per slot dinv_temp and dbsl
    float pool[NS][DPT], acc1[NS], acc2[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        acc1[i] = acc2[i] = 0.0f;
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) pool[i][dd] = 0.0f;
    }
    // K7's column stage: this thread's columns and rows of a tile
    const int dq = D_ / 4, rq = tm / 4, n_items = rq * dq * S.h;
    float cs1[CS_ITEMS][4], cs2[CS_ITEMS][4];
#pragma unroll
    for (int k = 0; k < CS_ITEMS; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) cs1[k][j] = cs2[k][j] = 0.0f;

    for (int t = 0; t < R.n_tiles; ++t) {
        const int r0 = R.begin + t * tm, nrow = min(tm, R.end - r0);
        const int buf = p.L.nbuf == 2 ? (t & 1) : 0;
        const bf16* xb = sX + (size_t)buf * tm * ldx;
        if (p.L.nbuf == 1 && t > 0) {
            __syncthreads();
            load_rows(t, 0);
            cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();
        if (p.L.nbuf == 2) {
            if (t + 1 < R.n_tiles) load_rows(t + 1, buf ^ 1);
            cp_async_commit();
        }
        pool_projections(b, p, Wfx, Wx, xb, sFX, sXM);
        __syncthreads();
        // the logits on the tensor cores, l = bf16(xm_h Wsl + bsl), into
        // the transposed w*mask tile, which the row stage reads and then
        // overwrites with w*mask, element by element
        const bool mma_logits = D_ % 16 == 0;
        if (mma_logits) {
            const int rbs = tm / 16, items = S.h * rbs;
            for (int itm = threadIdx.x >> 5; itm < items; itm += 8) {
                const int hh = itm / rbs, rb = itm - hh * rbs;
                for (int n0 = 0; n0 < G_; n0 += 64) {
                    float acc[8][4];
                    zero_acc(acc);
                    const int nv = min(8, (G_ - n0) / 8);
                    warp_mma<false>(acc, sXM + rb * 16 * ldx + hh * D_, ldx,
                                    sWslB + n0, ldwb, D_ / 16, nv);
#pragma unroll
                    for (int nt = 0; nt < 8; ++nt) {
                        if (nt < nv) {
                            const int col = n0 + nt * 8 + 2 * b.t;
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const int row = rb * 16 + b.g + 8 * (e >> 1);
                                const int gg = col + (e & 1);
                                sWMT[(hh * G_ + gg) * ldwt + row] =
                                    round_bf16(acc[nt][e] + p.bsl[gg]);
                            }
                        }
                    }
                }
            }
            __syncthreads();
        }

        // ---- the row stage: softmax over each head's slices, RI rows at
        //      once (their dot, shuffle and exp chains overlap) ----
        const bf16* dswb = sDSW + (size_t)buf * tm * lddsw;
        // the listed shapes keep each slot's Wsl column and dtokens row in
        // registers over the stage (the dots then read only xm and fx)
        constexpr bool RC = DC > 0 && NS * DC <= 32;
        float wcol[NS][RC ? DC : 1], dtr[NS][RC ? DC : 1];
        if constexpr (RC) {
#pragma unroll
            for (int i = 0; i < NS; ++i)
#pragma unroll
                for (int d = 0; d < DC; ++d) {
                    wcol[i][d] = sWsl[d * (GC + 1) + sl[i].g];
                    dtr[i][d] = tok[so[i] * ldt + d];
                }
        }
        for (int ra = q; ra < tm; ra += RI * S.ds) {
            constexpr int N = RI * NS;
            float l[N], sv[N], m[N], e[N], z[N], w[N], mk[RI];
#pragma unroll
            for (int u = 0; u < RI; ++u) {
                const int r = ra + u * S.ds;
                mk[u] = r < nrow ? mlane[r0 + r] : 0.0f;
                if (mma_logits) {
#pragma unroll
                    for (int i = 0; i < NS; ++i) {
                        l[u * NS + i] = sWMT[so[i] * ldwt + r];
                        sv[u * NS + i] = l[u * NS + i] * it_s[i];
                    }
                } else if constexpr (RC) {
#pragma unroll
                    for (int i = 0; i < NS; ++i) {
                        const float a = dot_bf16_reg<DC>(
                            sXM + r * ldx + sl[i].h * DC, wcol[i]);
                        l[u * NS + i] = round_bf16(a + bsl_s[i]);
                        sv[u * NS + i] = l[u * NS + i] * it_s[i];
                    }
                } else {
                    slot_logits<NS, DC>(ldx, D_, G_, sl, bsl_s, it_s, sXM,
                                        sWsl, r, l + u * NS, sv + u * NS);
                }
            }
#pragma unroll
            for (int i = 0; i < N; ++i) m[i] = sv[i];
            head_reduce<N, true>(m, SPT_, L_);
#pragma unroll
            for (int i = 0; i < N; ++i) {
                e[i] = __expf(sv[i] - m[i]);
                z[i] = e[i];
            }
            head_reduce<N, false>(z, SPT_, L_);
#pragma unroll
            for (int i = 0; i < N; ++i) w[i] = e[i] / z[i];
            float dwa[N], inner[N];
#pragma unroll
            for (int u = 0; u < RI; ++u) {
                const int r = ra + u * S.ds;
#pragma unroll
                for (int i = 0; i < NS; ++i) {
                    const int k = u * NS + i;
                    float dwm;
                    if constexpr (RC)
                        dwm = dot_bf16_reg<DC>(sFX + r * ldx + sl[i].h * DC,
                                               dtr[i]);
                    else
                        dwm = dot_bf16_f32<DC>(sFX + r * ldx + sl[i].h * D_,
                                               tok + so[i] * ldt, 1, D_);
                    dwm += dn_s[i];
                    // rows past the tile's were zero-filled
                    const float dsw = __bfloat162float(dswb[r * lddsw + so[i]]);
                    dwa[k] = dsw + dwm * mk[u];
                    inner[k] = w[k] * dwa[k];
                    sWMT[so[i] * ldwt + r] = w[k] * mk[u];
                }
            }
            head_reduce<N, false>(inner, SPT_, L_);
#pragma unroll
            for (int u = 0; u < RI; ++u) {
                const int r = ra + u * S.ds;
#pragma unroll
                for (int i = 0; i < NS; ++i) {
                    const int k = u * NS + i;
                    const float ds = w[k] * (dwa[k] - inner[k]);
                    acc1[i] += ds * l[k];
                    const float dl = ds * it_s[i];
                    acc2[i] += dl;
                    sDLT[so[i] * lddt + r] = __float2bfloat16(dl);
                }
            }
        }
        __syncthreads();

        // ---- pooled sums over the tile's rows (registers) ----
        for (int r = 0; r < nrow; ++r) {
#pragma unroll
            for (int i = 0; i < NS; ++i) {
                const int so = sl[i].h * S.g + sl[i].g;
                const float a = __bfloat162float(sDLT[so * lddt + r]);
                const bf16* brow = sXM + r * ldx + sl[i].h * D_ + q * DPT;
#pragma unroll
                for (int d0 = 0; d0 < DPT; d0 += 8) {
                    float v[8];
                    load8(brow + d0, v);
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        pool[i][d0 + u] = fmaf(a, v[u], pool[i][d0 + u]);
                }
            }
        }
        __syncthreads();    // dfx16 and dxm16 overwrite fx and xm

        // ---- the column stage: dfx = wm dtokens and dxm = dl16 Wsl^T
        //      (float32, CUDA cores), an item a 4-row by 4-column block of
        //      one head: per slice one 16-byte load of each operand feeds
        //      32 products; then the bf16 rows ----
#pragma unroll
        for (int k = 0; k < CS_ITEMS; ++k) {
            const int it = threadIdx.x + BK_THREADS * k;
            if (it >= n_items) break;
            const int db = it % dq, rb = (it / dq) % rq, hh = it / (dq * rq);
            const int d0 = db * 4, ra = rb * 4;
            float a1[4][4], a2[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) a1[i][j] = a2[i][j] = 0.0f;
            const float* wmp = sWMT + (size_t)hh * G_ * ldwt + ra;
            const bf16* dlp = sDLT + (size_t)hh * G_ * lddt + ra;
            const float* tkp = tok + (size_t)hh * G_ * ldt + d0;
            const float* wsp = sWslT + d0;
#pragma unroll 4
            for (int gg = 0; gg < G_; ++gg) {
                const float4 wv = *reinterpret_cast<const float4*>(wmp + gg * ldwt);
                float dv[4];
                load_bf16x4(dlp + gg * lddt, dv);
                const float4 tv = *reinterpret_cast<const float4*>(tkp + gg * ldt);
                const float4 sv = *reinterpret_cast<const float4*>(wsp + gg * ldwst);
                const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
                const float t4[4] = {tv.x, tv.y, tv.z, tv.w};
                const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        a1[i][j] = fmaf(w4[i], t4[j], a1[i][j]);
                        a2[i][j] = fmaf(dv[i], s4[j], a2[i][j]);
                    }
            }
            const int col = hh * D_ + d0;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ra + i;
                store_bf16x4(sDF + r * ldx + col, a1[i]);
                store_bf16x4(sDX + r * ldx + col, a2[i]);
                if (r < nrow) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        cs1[k][j] += a1[i][j];
                        cs2[k][j] += a2[i][j];
                    }
                    const size_t at = ((size_t)R.b * p.N + r0 + r) * c + col;
                    store_bf16x4(p.dfxs + at, a1[i]);
                    store_bf16x4(p.dxms + at, a2[i]);
                }
            }
        }
        __syncthreads();

        // ---- dx = dfx16 Wfx^T + dxm16 Wx^T ----
        for (int n0 = 0; n0 < c; n0 += b.pw) {
            float acc[8][4];
            const int nv = block_product<true>(b, acc, sDF, ldx, c, Wfx, n0, c);
            block_product<true>(b, acc, sDX, ldx, c, Wx, n0, c, true);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                if (nt < nv) {
                    const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int row = b.wrow * 16 + b.g + 8 * hf;
                        if (row < nrow)
                            store_bf16x2(p.dx + ((size_t)R.b * p.N + r0 + row) * c +
                                             col,
                                         acc[nt][2 * hf], acc[nt][2 * hf + 1]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- this block's partials ----
    float* part = p.part + ((size_t)R.b * p.n_chunks + blockIdx.x) * p.part_len;
    const int hgd = S.hg * S.d;
    // pooled sums: dWsl [H][D][G]
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int dd = 0; dd < DPT; ++dd) {
            const int d_ = q * DPT + dd;
            part[((size_t)sl[i].h * S.d + d_) * S.g + sl[i].g] = pool[i][dd];
        }
    }
    // per-slot sums over the groups that split a head's rows, in order
    float* fin = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int so = sl[i].h * S.g + sl[i].g;
        fin[(q * 2 + 0) * S.hg + so] = acc1[i];
        fin[(q * 2 + 1) * S.hg + so] = acc2[i];
    }
    float* fin2 = fin + 2 * S.ds * S.hg;
#pragma unroll
    for (int k = 0; k < CS_ITEMS; ++k) {
        const int it = threadIdx.x + BK_THREADS * k;
        if (it < n_items) {
            const int db = it % dq, rb = (it / dq) % rq, hh = it / (dq * rq);
            const int col = hh * D_ + db * 4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                fin2[(rb * 2 + 0) * c + col + j] = cs1[k][j];
                fin2[(rb * 2 + 1) * c + col + j] = cs2[k][j];
            }
        }
    }
    __syncthreads();
    // dWsl | dbsl per slot | dinv_temp per slot | dbfx | dbx
    for (int i = threadIdx.x; i < S.hg; i += BK_THREADS) {
        float a = 0.0f, bb = 0.0f;
        for (int qq = 0; qq < S.ds; ++qq) {
            a += fin[(qq * 2 + 0) * S.hg + i];
            bb += fin[(qq * 2 + 1) * S.hg + i];
        }
        part[hgd + i] = bb;
        part[hgd + S.hg + i] = a;
    }
    for (int i = threadIdx.x; i < c; i += BK_THREADS) {
        float a = 0.0f, bb = 0.0f;
        for (int rb = 0; rb < rq; ++rb) {
            a += fin2[(rb * 2 + 0) * c + i];
            bb += fin2[(rb * 2 + 1) * c + i];
        }
        part[hgd + 2 * S.hg + i] = a;
        part[hgd + 2 * S.hg + c + i] = bb;
    }
}

// ===================== the plans of K6 and K7 =====================
//
// Every shape the JAX package fuses (jax_pool_shape). K6
// runs its row kernel (fused_slice_pool.cu, pool_fwd_rows) where the head
// width and slices are compiled in (rows_variant: the nets' 8 heads of 16,
// 32 or 64 with 32 slices), K7 the block row tiles above where pool_shape
// takes the shape; every other shape runs the run-time path of either
// direction (a block a head, its head width, slices and row tile at run
// time: fused_slice_pool.cu pool_fwd_generic, fused_slice_pool_bwd.cu
// pool_bwd_generic and pool_dx). Right, not fast.

// the JAX package's fusing condition (C % 128 == 0, H*G % 128 == 0, H*D ==
// C)
bool jax_pool_shape(int c, int h, int g) {
    return c >= 128 && c % 128 == 0 && h >= 1 && c % h == 0 && g >= 1 &&
           (h * g) % 128 == 0;
}

// K6's row kernel: 8 heads (a warp each) of 16, 32 or 64 columns, 32
// slices
bool rows_variant(int c, int h, int g) {
    return h == 8 && g == 32 && (c == 128 || c == 256 || c == 512);
}

// K6's row kernel with tiles of tm rows: weights resident ([C][2C + 8], Wfx
// then Wx) or the ring, two x buffers, fx and xm, two mask buffers
size_t rows_smem(int c, int tm, int resident) {
    const int pw = (8 / (tm / 16)) * 64;
    return align128(resident ? (size_t)c * (2 * c + 8) * 2
                             : (size_t)2 * ring_slot(pw) * 2) +
           align128((size_t)2 * tm * (c + 8) * 2) +
           2 * align128((size_t)tm * (c + 8) * 2) +
           align128((size_t)2 * tm * 4);
}

// the run-time path of K6 (bwd false) or K7 with tiles of tm rows: x, fx
// and xm of the block's head (float), w (K7 also l and ds), the mask
size_t generic_smem(int c, int h, int g, int tm, bool bwd) {
    const int d = c / h;
    return align128((size_t)tm * c * 2) + 2 * align128((size_t)tm * d * 4) +
           (bwd ? 3 : 1) * align128((size_t)tm * g * 4) +
           align128((size_t)tm * 4);
}

// K7's run-time dx pass (pool_dx): a block a tile of DX_TM rows by 128
// output columns, both operands streamed through the ring, so its shared
// memory does not grow with C
constexpr int DX_TM = 64;

inline size_t dx_smem() {
    return (size_t)2 * pass_slot(DX_TM, (8 / (DX_TM / 16)) * 64) * 2;
}

// The run-time paths' start of a tile (K6 and K7 alike): rows r0 .. r0 +
// nrow of x into sX [tm][C] and the mask into sMk (zero past nrow), then
// the head's fx16 and xm16 columns col0 .. col0 + D into sF, sM [nrow][D]
// as floats (float32 sums over C in order, the bias, one bf16 rounding).
// Starts and ends with a block barrier.
__device__ __forceinline__ void generic_tile(
        const bf16* xlane, const float* mlane, const bf16* wfx,
        const float* bfx, const bf16* wx, const float* bx, int c, int d,
        int col0, int tm, int r0, int nrow, bf16* sX, float* sMk, float* sF,
        float* sM) {
    __syncthreads();                            // the last tile is read
    for (int i = threadIdx.x; i < tm * (c / 8); i += BK_THREADS) {
        const int r = i / (c / 8), ch = i - r * (c / 8);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrow)
            v = *reinterpret_cast<const uint4*>(xlane + (size_t)(r0 + r) * c +
                                                ch * 8);
        *reinterpret_cast<uint4*>(sX + (size_t)r * c + ch * 8) = v;
    }
    for (int i = threadIdx.x; i < tm; i += BK_THREADS)
        sMk[i] = i < nrow ? mlane[r0 + i] : 0.0f;
    __syncthreads();
    for (int i = threadIdx.x; i < nrow * d; i += BK_THREADS) {
        const int r = i / d, dd = i - r * d, col = col0 + dd;
        float a = 0.0f, q = 0.0f;
        for (int k = 0; k < c; ++k) {
            const float xv = __bfloat162float(sX[(size_t)r * c + k]);
            a = fmaf(xv, __bfloat162float(wfx[(size_t)k * c + col]), a);
            q = fmaf(xv, __bfloat162float(wx[(size_t)k * c + col]), q);
        }
        sF[i] = round_bf16(a + bfx[col]);
        sM[i] = round_bf16(q + bx[col]);
    }
    __syncthreads();
}

enum PoolPath { POOL_ROWS = 0, POOL_TILES = 1, POOL_GENERIC = 2 };

struct PoolRun {
    PoolShape s;
    PoolPlan L;             // POOL_TILES: the tile and its layout
    int path, tm, resident, blocks_per_sm;
    size_t smem;            // POOL_ROWS / POOL_GENERIC
    int rows_per_chunk, n_chunks, part_len, n_sm;
    size_t o_part, o_dfx, o_dxm, o_wg, bytes;
    gfvgn::WgParams q;
};

// path, plan, chunks and workspace of a call; cudaErrorInvalidValue where
// no kernel takes the shape
int pool_run(int c, int h, int g, int B, int N, bool bwd, PoolRun& P) {
    int max_smem = 0, sm_smem = 0;
    int err = device_limits(max_smem, P.n_sm, &sm_smem);
    if (err != 0) return err;
    if (B < 1 || B > 65535 || N < 1 || !jax_pool_shape(c, h, g))
        return (int)cudaErrorInvalidValue;
    P.s.c = c; P.s.h = h; P.s.g = g; P.s.d = c / h; P.s.hg = h * g;
    bool found = false;
    if (!bwd && rows_variant(c, h, g)) {
        // two blocks an SM (16 warps) before one, resident weights before
        // streamed, then larger tiles (at C = 256 two blocks of 32-row
        // tiles beat one of 64-row tiles, which read the streamed weights
        // half as often: 0.28 against 0.35-0.40 ms on the H100)
        for (int k = 0; k < 12 && !found; ++k) {
            const int per_sm = 2 - k / 6, res = 1 - (k / 3) % 2;
            const int t = 64 >> (k % 3);
            const size_t total = rows_smem(c, t, res);
            if (total <= (size_t)max_smem &&
                (total + 1024) * per_sm <= (size_t)sm_smem) {
                P.path = POOL_ROWS; P.tm = t; P.resident = res;
                P.blocks_per_sm = per_sm; P.smem = total;
                found = true;
            }
        }
    }
    if (!found && bwd && pool_shape(c, h, g, P.s))
        for (int res = 1; res >= 0 && !found; --res)
            for (int t = 64; t >= 16 && !found; t >>= 1)
                for (int tok = 1; tok >= 0 && !found; --tok)
                    for (int nbuf = 2; nbuf >= 1 && !found; --nbuf) {
                        // the column stage's items a thread (CS_ITEMS)
                        if (t * c / 16 > BK_THREADS * CS_ITEMS) continue;
                        const size_t total =
                            pool_layout(P.s, t, res, nbuf, tok, P.L);
                        if (total <= (size_t)max_smem) {
                            P.L.tm = t; P.L.nbuf = nbuf; P.L.resident = res;
                            P.L.tok_smem = tok; P.L.smem = total;
                            P.path = POOL_TILES; P.tm = t;
                            found = true;
                        }
                    }
    if (!found) {
        for (int t = 32; t >= 1 && !found; t >>= 1) {
            const size_t total = generic_smem(c, h, g, t, bwd);
            if (total <= (size_t)max_smem) {
                P.path = POOL_GENERIC; P.tm = t; P.smem = total;
                found = true;
            }
        }
        found = found && (!bwd || dx_smem() <= (size_t)max_smem);
    }
    if (!found) return (int)cudaErrorInvalidValue;
    // row chunks: the row kernel's resident blocks over the batch; one
    // block an SM for K7's tiles; about two blocks an SM over the batch and
    // the heads for the run-time path
    const int tiles = (N + P.tm - 1) / P.tm;
    int want = P.path == POOL_ROWS ? P.blocks_per_sm * P.n_sm / B
             : P.path == POOL_TILES ? P.n_sm / B
                                    : 2 * P.n_sm / (B * h);
    if (want > tiles) want = tiles;
    if (want < 1) want = 1;
    P.rows_per_chunk = ((tiles + want - 1) / want) * P.tm;
    P.n_chunks = (N + P.rows_per_chunk - 1) / P.rows_per_chunk;
    const int hgd = P.s.hg * P.s.d;
    P.part_len = bwd ? hgd + 2 * P.s.hg + 2 * c : hgd + P.s.hg;
    size_t o = 0;
    P.o_part = o; o += align128((size_t)B * P.n_chunks * P.part_len * 4);
    if (bwd) {
        P.o_dfx = o; o += align128((size_t)B * N * c * 2);
        P.o_dxm = o; o += align128((size_t)B * N * c * 2);
        gfvgn::WgParams& q = P.q;
        q.n_jobs = 2;
        q.job[0] = gfvgn::WgJob{nullptr, c, c, nullptr, c, c, 0, c};
        q.job[1] = gfvgn::WgJob{nullptr, c, c, nullptr, c, c, c * c, c};
        q.rows_per_lane = N;
        q.n_w = 2 * c * c;
        gfvgn::wg_chunking(gfvgn::wg_tiles(q), N, B, P.n_sm, q.chunk_rows,
                           q.n_chunks);
        P.o_wg = o; o += align128((size_t)B * q.n_chunks * q.n_w * 4);
    }
    P.bytes = o;
    return 0;
}

void fill_pool(PoolParams& p, const PoolRun& P, const void* x,
               const void* mask, int mask_bstride, const void* wfx,
               const void* bfx, const void* wx, const void* bx,
               const void* wsl, const void* bsl, const void* inv_temp, int N,
               unsigned char* ws) {
    p.x = static_cast<const bf16*>(x);
    p.mask = static_cast<const float*>(mask);
    p.wfx = static_cast<const bf16*>(wfx);
    p.bfx = static_cast<const float*>(bfx);
    p.wx = static_cast<const bf16*>(wx);
    p.bx = static_cast<const float*>(bx);
    p.wsl = static_cast<const bf16*>(wsl);
    p.bsl = static_cast<const float*>(bsl);
    p.inv_temp = static_cast<const float*>(inv_temp);
    p.part = reinterpret_cast<float*>(ws + P.o_part);
    p.s = P.s;
    p.N = N;
    p.mask_bstride = mask_bstride;
    p.rows_per_chunk = P.rows_per_chunk;
    p.n_chunks = P.n_chunks;
    p.part_len = P.part_len;
    p.L = P.L;
}

template <int NS, int DPT, int DC, int GC>
int launch_pool_t(const PoolRun& P, const PoolParams& p, int B,
                  cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(
        slice_pool_tiles<NS, DPT, DC, GC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.L.smem);
    if (e != cudaSuccess) return (int)e;
    slice_pool_tiles<NS, DPT, DC, GC><<<dim3(P.n_chunks, B), BK_THREADS,
                                         P.L.smem, st>>>(p);
    return (int)cudaGetLastError();
}

int launch_pool(const PoolRun& P, const PoolParams& p, int B,
                cudaStream_t st) {
    const int ns = P.s.ns, dpt = P.s.dpt, d = P.s.d, g = P.s.g;
    // the listed shapes with their head width and slices compiled in
#define GFVGN_POOL_C(NS_, DPT_, D_, G_) \
    if (ns == NS_ && dpt == DPT_ && d == D_ && g == G_) \
        return launch_pool_t<NS_, DPT_, D_, G_>(P, p, B, st);
    GFVGN_POOL_C(1, 16, 16, 32) GFVGN_POOL_C(1, 32, 32, 32)
    GFVGN_POOL_C(1, 64, 64, 32) GFVGN_POOL_C(1, 48, 48, 32)
    GFVGN_POOL_C(1, 16, 32, 32) GFVGN_POOL_C(1, 8, 16, 16)
    GFVGN_POOL_C(2, 16, 16, 64) GFVGN_POOL_C(2, 16, 64, 64)
    GFVGN_POOL_C(2, 16, 16, 32)
#undef GFVGN_POOL_C
#define GFVGN_POOL(NS_, DPT_) \
    if (ns == NS_ && dpt == DPT_) \
        return launch_pool_t<NS_, DPT_, 0, 0>(P, p, B, st);
    GFVGN_POOL(1, 8) GFVGN_POOL(1, 16) GFVGN_POOL(1, 32) GFVGN_POOL(1, 48)
    GFVGN_POOL(1, 64)
    GFVGN_POOL(2, 8) GFVGN_POOL(2, 16) GFVGN_POOL(2, 32)
    GFVGN_POOL(4, 8) GFVGN_POOL(4, 16)
#undef GFVGN_POOL
    return (int)cudaErrorInvalidValue;
}

}  // namespace
