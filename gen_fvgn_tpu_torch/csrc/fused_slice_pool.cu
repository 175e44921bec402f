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
// with H heads of D = C / H and the [D, G] slice kernel shared by the heads.
//
// Replaces the Pallas TPU kernel _make_fwd_kernel of
// gen_fvgn_tpu/ops/fused_slice_attn.py (core _slice_core :117-140, kernel
// :143-167, called at :274). The TPU kernel takes the slice kernel as a
// block-diagonal [C, H*G] embed and pools the FULL cross-head [H*G, C]
// product, whose off-diagonal blocks are thrown away outside; this kernel
// computes only the per-head diagonal blocks [H, G, D] and takes the shared
// [D, G] kernel itself.
//
// What bounds it on the H100: bytes. A node costs 2*(2*C*C + C*G) FLOP on
// the tensor cores and 2*C*G in float32 against 2C bytes of x read and 2HG
// bytes of slice weights written (at C = 128: 82 k FLOP against 772 bytes,
// ~107 FLOP/byte, under the ~295 FLOP/byte bf16 ridge).
//
// Design of the row kernel (pool_fwd_rows<D>, the nets' shapes: 8 heads of
// D = 16, 32 or 64, 32 slices). The TPU carries the token and norm sums in
// scratch across a sequential grid; on the H100 the rows of each batch lane
// are cut into chunks, one block per (chunk, batch lane), the grid one wave
// of two blocks an SM (16 warps) where their shared memory fits; each block
// writes its partial sums and chunk_reduce sums them over chunks in a fixed
// order, so two runs give the same bits (no atomics). Inside a block:
//   * x and the mask come in by cp.async, the next tile's while this one
//     computes (two buffers);
//   * the projections run on the tensor cores as block products of the
//     tile (mma_sm90.cuh), Wfx | Wx staged once per block as one [C][2C]
//     matrix where it fits (C = 128: all 8 warps in one pass), otherwise
//     streamed through the ring; the float32 accumulators take their bias
//     and bf16 rounding in registers and land in shared memory as bf16 fx
//     and xm (no float32 staging tile);
//   * warp h owns head h over 16-row strips: the logits are an mma of the
//     strip's xm_h (ldmatrix, A) against Wsl held as B fragments in
//     registers (exact bf16 products, as the TPU's), so each thread holds 8
//     of the 32 slices of two rows; the exact max and the sum of the
//     float32 softmax come from two quad shuffles each;
//   * slice_w leaves as whole 16-byte rows: a quad trades its words so that
//     each thread holds 8 consecutive slices of a row;
//   * pooling on the tensor cores: w*mask (float32) is split into bf16 hi +
//     lo (the rest is below 2^-16 of it), the fragments are transposed in
//     registers (movmatrix) into the B operand, and tokens_h^T [D x G] +=
//     fx_h^T (ldmatrix.trans, exact bf16) x (hi + lo) accumulates in float32
//     registers over all the warp's strips; norm is a float32 sum in
//     registers, reduced over the rows' lanes once at the end.
//
// Rounding points (the TPU kernel's): fx, xm and the logits rounded to bf16
// after a float32-accumulated product plus bias; logits*inv_temp, exp and
// the normalisation in float32; slice_w stored bf16; the pooling of float32
// w*mask and the bf16-exact fx (here in two exact bf16 products).
//
// Every other shape up to C = 1024 runs the run-time path (pool_fwd_generic:
// a block a (chunk, batch lane, head), the projections of the head's
// columns, the softmax a warp a row and the pooling on the CUDA cores).
// gfvgn_slice_pool_workspace sizes the partials and refuses what no path
// takes (slice_pool_tiles.cuh, pool_run).
//
// Plain C interface, no allocation (the caller passes a workspace of the
// size gfvgn_slice_pool_workspace gives), launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lane_reduce.cuh"
#include "mma_sm90.cuh"
#include "slice_pool_tiles.cuh"

namespace {

struct RowsParams {
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
    float* part;            // [B, n_chunks, part_len]
    int N, mask_bstride, rows_per_chunk, n_chunks, part_len;
    int tm, resident;
    int o_x, o_fx, o_xm, o_mask;    // shared-memory offsets (o_w = 0)
};

__device__ __forceinline__ uint32_t pick4(const uint32_t v[4], int i) {
    return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

template <int D>
__global__ void __launch_bounds__(BK_THREADS, 2) pool_fwd_rows(RowsParams p) {
    constexpr int H = 8, G = 32, C = H * D, HG = H * G, LDX = C + 8;
    constexpr int NT = G / 8, KS = D / 16;
    extern __shared__ __align__(128) unsigned char smem[];
    const int tm = p.tm;
    bf16* sW = reinterpret_cast<bf16*>(smem);
    const Blk b = make_blk(tm, sW);
    bf16* sX = reinterpret_cast<bf16*>(smem + p.o_x);
    bf16* sFX = reinterpret_cast<bf16*>(smem + p.o_fx);
    bf16* sXM = reinterpret_cast<bf16*>(smem + p.o_xm);
    float* sMask = reinterpret_cast<float*>(smem + p.o_mask);
    const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
    const int qr = lane >> 2, qt = lane & 3;
    const int bl = blockIdx.y;
    const int begin = blockIdx.x * p.rows_per_chunk;
    const int end = min(p.N, begin + p.rows_per_chunk);
    const int n_tiles = (end - begin + tm - 1) / tm;
    const bf16* xlane = p.x + (size_t)bl * p.N * C;
    const float* mlane = p.mask + (size_t)bl * p.mask_bstride;
    bf16* wlane = p.slice_w + (size_t)bl * p.N * HG;

    if (p.resident) {
        stage_matrix(sW, 2 * C + 8, p.wfx, C, C);
        stage_matrix(sW + C, 2 * C + 8, p.wx, C, C);
    }
    auto load = [&](int t, int buf) {
        const int r0 = begin + t * tm, nrow = min(tm, end - r0);
        load_tile_rows(sX + (size_t)buf * tm * LDX, LDX, xlane, C, r0, nrow,
                       tm);
        for (int i = threadIdx.x; i < tm; i += BK_THREADS)
            cp_async4(sMask + buf * tm + i, mlane + r0 + (i < nrow ? i : 0),
                      i < nrow);
    };
    if (n_tiles > 0) load(0, 0);
    cp_async_commit();

    // Wsl as the logits' B fragments (k = head column, n = slice), the
    // thread's slices 8j + 2qt (+1): bias; this head's inverse temperature
    uint32_t bw[KS][NT][2];
    float bias[NT][2];
    const unsigned short* wraw = reinterpret_cast<const unsigned short*>(p.wsl);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + qr;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int k = 16 * ks + 8 * hf + 2 * qt;
                bw[ks][j][hf] = (uint32_t)wraw[k * G + n] |
                                ((uint32_t)wraw[(k + 1) * G + n] << 16);
            }
        bias[j][0] = p.bsl[8 * j + 2 * qt];
        bias[j][1] = p.bsl[8 * j + 2 * qt + 1];
    }
    const float it = p.inv_temp[h];
    // tokens_h^T [D x G] (m = column, n = slice) and the norm of the
    // thread's slices over its rows
    float tok[KS][NT][4], nacc[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
        nacc[j][0] = nacc[j][1] = 0.0f;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) tok[mt][j][e] = 0.0f;
    }

    for (int t = 0; t < n_tiles; ++t) {
        const int r0 = begin + t * tm, nrow = min(tm, end - r0);
        const int buf = t & 1;
        cp_async_wait<0>();
        __syncthreads();
        if (t + 1 < n_tiles) load(t + 1, buf ^ 1);
        cp_async_commit();
        const bf16* xb = sX + (size_t)buf * tm * LDX;

        // ---- fx = bf16(x Wfx + bfx), xm = bf16(x Wx + bx) ----
        float acc[8][4];
        const int passes = p.resident ? 1 : 2;
        for (int which = 0; which < passes; ++which) {
            const WSrc W = p.resident
                ? WSrc{nullptr, 0, sW, 2 * C + 8}
                : WSrc{which ? p.wx : p.wfx, C, nullptr, 0};
            const int n = p.resident ? 2 * C : C;
            for (int n0 = 0; n0 < n; n0 += b.pw) {
                const int nv = block_product<false>(b, acc, xb, LDX, C, W, n0,
                                                    n);
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt < nv) {
                        int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t +
                                  which * C;
                        const bool is_xm = col >= C;
                        col -= is_xm ? C : 0;
                        const float2 bb = *reinterpret_cast<const float2*>(
                            (is_xm ? p.bx : p.bfx) + col);
                        bf16* dst = is_xm ? sXM : sFX;
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const int row = b.wrow * 16 + b.g + 8 * hf;
                            store_bf16x2(dst + row * LDX + col,
                                         acc[nt][2 * hf] + bb.x,
                                         acc[nt][2 * hf + 1] + bb.y);
                        }
                    }
                }
            }
        }
        __syncthreads();

        // ---- warp h: head h, 16-row strips ----
        const float* mk = sMask + buf * tm;
        for (int s0 = 0; s0 < nrow; s0 += 16) {
            // logits l = bf16(xm_h Wsl + bsl), s = l * inv_temp: rows qr
            // (e = 0, 1) and qr + 8 (e = 2, 3), slices 8j + 2qt (+1)
            float v[NT][4];
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) v[j][e] = 0.0f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t af[4];
                ldsm_x4(af, sXM + (s0 + (lane & 15)) * LDX + h * D + 16 * ks +
                                ((lane >> 4) << 3));
#pragma unroll
                for (int j = 0; j < NT; ++j)
                    mma16816(v[j], af, bw[ks][j][0], bw[ks][j][1]);
            }
            float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f};
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[j][e] = round_bf16(v[j][e] + bias[j][e & 1]) * it;
                    m[e >> 1] = fmaxf(m[e >> 1], v[j][e]);
                }
#pragma unroll
            for (int o = 1; o < 4; o <<= 1)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    m[hf] = fmaxf(m[hf], __shfl_xor_sync(0xffffffffu, m[hf], o));
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    v[j][e] = __expf(v[j][e] - m[e >> 1]);
                    z[e >> 1] += v[j][e];
                }
#pragma unroll
            for (int o = 1; o < 4; o <<= 1)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf)
                    z[hf] += __shfl_xor_sync(0xffffffffu, z[hf], o);
            const float rz[2] = {1.0f / z[0], 1.0f / z[1]};
            const float mrow[2] = {mk[s0 + qr], mk[s0 + qr + 8]};
            uint32_t whi[NT][2], wlo[NT][2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                // slice_w: the quad trades words so that thread qt holds
                // slices 8qt .. 8qt + 7 of its row (32 = 4 x 8)
                uint32_t wd[4], rcv[4];
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const float w0 = v[j][2 * hf] * rz[hf];
                    const float w1 = v[j][2 * hf + 1] * rz[hf];
                    wd[j] = pack_bf16(w0, w1);
                    // w * mask, split into bf16 hi + lo; norm in float32
                    const float a0 = w0 * mrow[hf], a1 = w1 * mrow[hf];
                    nacc[j][0] += a0;
                    nacc[j][1] += a1;
                    whi[j][hf] = pack_bf16(a0, a1);
                    const float2 hv = unpack_bf16(whi[j][hf]);
                    wlo[j][hf] = pack_bf16(a0 - hv.x, a1 - hv.y);
                }
                rcv[0] = pick4(wd, qt);
#pragma unroll
                for (int k = 1; k < 4; ++k)
                    rcv[k] = __shfl_xor_sync(0xffffffffu, pick4(wd, qt ^ k), k);
                const int row = s0 + qr + 8 * hf;
                if (row < nrow)
                    *reinterpret_cast<uint4*>(
                        wlane + (size_t)(r0 + row) * HG + h * G + 8 * qt) =
                        make_uint4(pick4(rcv, qt), pick4(rcv, qt ^ 1),
                                   pick4(rcv, qt ^ 2), pick4(rcv, qt ^ 3));
            }
            // tokens_h^T += fx_h^T (hi + lo): A = fx_h^T by ldmatrix.trans,
            // B = (w * mask) with k = row, n = slice: the transposed
            // fragments (rows qr / qr + 8 are k 0-7 / 8-15)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const uint32_t bh0 = movm_trans(whi[j][0]);
                const uint32_t bh1 = movm_trans(whi[j][1]);
                const uint32_t bl0 = movm_trans(wlo[j][0]);
                const uint32_t bl1 = movm_trans(wlo[j][1]);
                whi[j][0] = bh0; whi[j][1] = bh1;
                wlo[j][0] = bl0; wlo[j][1] = bl1;
            }
#pragma unroll
            for (int mt = 0; mt < KS; ++mt) {
                uint32_t af[4];
                ldsm_x4_t(af, sFX + (s0 + (lane & 7) + (((lane >> 4) & 1) << 3)) *
                                        LDX + h * D + 16 * mt +
                                  (((lane >> 3) & 1) << 3));
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    mma16816(tok[mt][j], af, whi[j][0], whi[j][1]);
                    mma16816(tok[mt][j], af, wlo[j][0], wlo[j][1]);
                }
            }
        }
    }
    cp_async_wait<0>();

    // ---- this block's partials: tokens [H][G][D], then norm [H][G] ----
    float* part = p.part + ((size_t)bl * p.n_chunks + blockIdx.x) * p.part_len;
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = 16 * mt + qr + 8 * (e >> 1);
                const int gg = 8 * j + 2 * qt + (e & 1);
                part[(h * G + gg) * D + d] = tok[mt][j][e];
            }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float s = nacc[j][e];
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
                s += __shfl_xor_sync(0xffffffffu, s, o);
            if (qr == 0) part[HG * D + h * G + 8 * j + 2 * qt + e] = s;
        }
}


// ==================== K6 at every other shape (run time) ====================
//
// A block a (chunk, batch lane, head): per tile of tm rows the head's fx and
// xm columns (float32 sums over C on the CUDA cores, rounded to bf16 after
// the bias), the logits and the softmax a warp a row (the G slices over the
// lanes), slice_w, then the pooled sums of the head, each thread owning
// tokens/norm elements and adding the tile's rows in order into the block's
// partial (the first tile writes it).

struct GenParams {
    const bf16* x;
    const float* mask;
    const bf16* wfx;
    const float* bfx;
    const bf16* wx;
    const float* bx;
    const bf16* wsl;
    const float* bsl;
    const float* inv_temp;
    bf16* slice_w;
    float* part;
    int N, mask_bstride, rows_per_chunk, n_chunks, part_len;
    int c, h, g, d, tm;
};

__global__ void __launch_bounds__(BK_THREADS) pool_fwd_generic(GenParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int c = p.c, d = p.d, G = p.g, hg = p.h * p.g, tm = p.tm;
    const int hh = blockIdx.z, bl = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    size_t o = 0;
    bf16* sX = reinterpret_cast<bf16*>(smem);
    o += align128((size_t)tm * c * 2);
    float* sF = reinterpret_cast<float*>(smem + o);
    o += align128((size_t)tm * d * 4);
    float* sM = reinterpret_cast<float*>(smem + o);
    o += align128((size_t)tm * d * 4);
    float* sW = reinterpret_cast<float*>(smem + o);
    o += align128((size_t)tm * G * 4);
    float* sMk = reinterpret_cast<float*>(smem + o);
    const int begin = blockIdx.x * p.rows_per_chunk;
    const int end = min(p.N, begin + p.rows_per_chunk);
    const float* mlane = p.mask + (size_t)bl * p.mask_bstride;
    float* part = p.part + ((size_t)bl * p.n_chunks + blockIdx.x) * p.part_len;
    const float it = p.inv_temp[hh];
    const int hgd = hg * d, col0 = hh * d;

    for (int r0 = begin, t = 0; r0 < end; r0 += tm, ++t) {
        const int nrow = min(tm, end - r0);
        generic_tile(p.x + (size_t)bl * p.N * c, mlane, p.wfx, p.bfx, p.wx,
                     p.bx, c, d, col0, tm, r0, nrow, sX, sMk, sF, sM);
        for (int r = warp; r < nrow; r += BK_THREADS / 32) {
            float m = -INFINITY;
            for (int gg = lane; gg < G; gg += 32) {
                float a = 0.0f;
                for (int dd = 0; dd < d; ++dd)
                    a = fmaf(sM[r * d + dd],
                             __bfloat162float(p.wsl[(size_t)dd * G + gg]), a);
                const float s = round_bf16(a + p.bsl[gg]) * it;
                sW[r * G + gg] = s;
                m = fmaxf(m, s);
            }
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            float z = 0.0f;
            for (int gg = lane; gg < G; gg += 32) {
                const float e = __expf(sW[r * G + gg] - m);
                sW[r * G + gg] = e;
                z += e;
            }
            for (int off = 16; off > 0; off >>= 1)
                z += __shfl_xor_sync(0xffffffffu, z, off);
            const float rz = 1.0f / z;
            for (int gg = lane; gg < G; gg += 32) {
                const float w = sW[r * G + gg] * rz;
                sW[r * G + gg] = w;
                p.slice_w[((size_t)bl * p.N + r0 + r) * hg + hh * G + gg] =
                    __float2bfloat16(w);
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < G * d + G; e += BK_THREADS) {
            float s = 0.0f;
            size_t at;
            if (e < G * d) {
                const int gg = e / d, dd = e - gg * d;
                for (int r = 0; r < nrow; ++r)
                    s = fmaf(sW[r * G + gg] * sMk[r], sF[r * d + dd], s);
                at = (size_t)(hh * G + gg) * d + dd;
            } else {
                const int gg = e - G * d;
                for (int r = 0; r < nrow; ++r) s += sW[r * G + gg] * sMk[r];
                at = (size_t)hgd + hh * G + gg;
            }
            part[at] = t == 0 ? s : part[at] + s;
        }
    }
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

template <int D>
int launch_rows(const PoolRun& P, const RowsParams& p, int B,
                cudaStream_t st) {
    cudaError_t e = cudaFuncSetAttribute(
        pool_fwd_rows<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P.smem);
    if (e != cudaSuccess) return (int)e;
    pool_fwd_rows<D><<<dim3(P.n_chunks, B), BK_THREADS, P.smem, st>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

// Bytes of workspace K6 (backward = 0) or K7 needs for x [B, N, C] with H
// heads and G slices; -1 where no kernel takes the shape (outside the JAX
// package's fusing condition, C above 1024, or no tile that fits a block's
// shared memory).
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
    if (P.path == POOL_ROWS) {
        RowsParams p;
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
        p.part_len = P.part_len;
        p.tm = P.tm;
        p.resident = P.resident;
        const int tm = P.tm, pw = (8 / (tm / 16)) * 64;
        size_t o = align128(P.resident ? (size_t)c * (2 * c + 8) * 2
                                       : (size_t)2 * ring_slot(pw) * 2);
        p.o_x = (int)o; o += align128((size_t)2 * tm * (c + 8) * 2);
        p.o_fx = (int)o; o += align128((size_t)tm * (c + 8) * 2);
        p.o_xm = (int)o; o += align128((size_t)tm * (c + 8) * 2);
        p.o_mask = (int)o;
        switch (c / h) {
            case 16: err = launch_rows<16>(P, p, B, st); break;
            case 32: err = launch_rows<32>(P, p, B, st); break;
            case 64: err = launch_rows<64>(P, p, B, st); break;
            default: return (int)cudaErrorInvalidValue;
        }
    } else {
        GenParams p;
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
        p.part_len = P.part_len;
        p.c = c; p.h = h; p.g = g; p.d = c / h; p.tm = P.tm;
        cudaError_t e = cudaFuncSetAttribute(
            pool_fwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)P.smem);
        if (e != cudaSuccess) return (int)e;
        pool_fwd_generic<<<dim3(P.n_chunks, B, h), BK_THREADS, P.smem, st>>>(
            p);
        err = (int)cudaGetLastError();
    }
    if (err != 0) return err;
    const int hgd = P.s.hg * P.s.d;
    chunk_reduce<<<dim3((P.part_len + 255) / 256, B), 256, 0, st>>>(
        part, static_cast<float*>(tokens), static_cast<float*>(norm),
        P.part_len, hgd, P.n_chunks);
    return (int)cudaGetLastError();
}
