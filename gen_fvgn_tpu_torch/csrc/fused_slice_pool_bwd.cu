// K7: the slice-pool backward for sm_90a, the row pass on the block row
// tiles of slice_pool_tiles.cuh (its design note is there), then the
// weight-gradient pass and the fixed-order reductions.
//
// Every shape the tiles do not take runs the run-time path:
// pool_bwd_generic, a block a (chunk, batch lane, head), recomputes the
// head's fx, xm, logits and softmax (float32 sums over C on the CUDA cores,
// the forward's rounding points), takes the softmax backward a warp a row,
// writes the head's dfx16 and dxm16 columns, and adds its tile's rows in
// order into the block's partials of dWsl, dbsl, dinv_temp, dbfx and dbx;
// then pool_dx forms dx = bf16(dfx16 Wfx^T + dxm16 Wx^T) on the tensor cores
// (pass products: the rows and the weights streamed, so that its shared
// memory does not grow with C). Right, not fast.
//
// Plain C interface, no allocation (the caller passes a workspace of the
// size gfvgn_slice_pool_workspace gives), launches on the caller's stream and
// returns cudaGetLastError().

#include "slice_pool_tiles.cuh"

namespace {

struct GenBwdParams {
    const bf16* x;
    const float* mask;
    const bf16* wfx;
    const float* bfx;
    const bf16* wx;
    const float* bx;
    const bf16* wsl;        // [D, G]
    const float* bsl;
    const float* inv_temp;
    const bf16* dslice_w;   // [B, N, H*G]
    const float* dtok;      // [B, H, G, D]
    const float* dnorm;     // [B, H, G]
    bf16* dfxs;             // [B, N, C]
    bf16* dxms;             // [B, N, C]
    float* part;            // [B, n_chunks, part_len]
    int N, mask_bstride, rows_per_chunk, n_chunks, part_len;
    int c, h, g, d, tm;
};

__global__ void __launch_bounds__(BK_THREADS) pool_bwd_generic(GenBwdParams p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int c = p.c, d = p.d, G = p.g, hg = p.h * p.g, tm = p.tm;
    const int hh = blockIdx.z, bl = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    size_t o = 0;
    bf16* sX = reinterpret_cast<bf16*>(smem);
    o += align128((size_t)tm * c * 2);
    float* sF = reinterpret_cast<float*>(smem + o);   // fx16, then dfx
    o += align128((size_t)tm * d * 4);
    float* sM = reinterpret_cast<float*>(smem + o);   // xm16, then dxm
    o += align128((size_t)tm * d * 4);
    float* sW = reinterpret_cast<float*>(smem + o);   // w
    o += align128((size_t)tm * G * 4);
    float* sL = reinterpret_cast<float*>(smem + o);   // l
    o += align128((size_t)tm * G * 4);
    float* sDS = reinterpret_cast<float*>(smem + o);  // ds
    o += align128((size_t)tm * G * 4);
    float* sMk = reinterpret_cast<float*>(smem + o);
    const int begin = blockIdx.x * p.rows_per_chunk;
    const int end = min(p.N, begin + p.rows_per_chunk);
    const float* mlane = p.mask + (size_t)bl * p.mask_bstride;
    const float* dtok = p.dtok + ((size_t)bl * p.h + hh) * G * d;
    const float* dnorm = p.dnorm + ((size_t)bl * p.h + hh) * G;
    float* part = p.part + ((size_t)bl * p.n_chunks + blockIdx.x) * p.part_len;
    const float it = p.inv_temp[hh];
    const int hgd = hg * d, col0 = hh * d;

    for (int r0 = begin, t = 0; r0 < end; r0 += tm, ++t) {
        const int nrow = min(tm, end - r0);
        generic_tile(p.x + (size_t)bl * p.N * c, mlane, p.wfx, p.bfx, p.wx,
                     p.bx, c, d, col0, tm, r0, nrow, sX, sMk, sF, sM);
        // ---- a warp a row: l, w, dw_m, dw_all, the softmax backward ----
        for (int r = warp; r < nrow; r += BK_THREADS / 32) {
            const size_t n = (size_t)bl * p.N + r0 + r;
            float m = -INFINITY;
            for (int gg = lane; gg < G; gg += 32) {
                float a = 0.0f;
                for (int dd = 0; dd < d; ++dd)
                    a = fmaf(sM[r * d + dd],
                             __bfloat162float(p.wsl[(size_t)dd * G + gg]), a);
                const float l = round_bf16(a + p.bsl[gg]);
                sL[r * G + gg] = l;
                m = fmaxf(m, l * it);
            }
            for (int off = 16; off > 0; off >>= 1)
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
            float z = 0.0f;
            for (int gg = lane; gg < G; gg += 32) {
                const float e = __expf(sL[r * G + gg] * it - m);
                sW[r * G + gg] = e;
                z += e;
            }
            for (int off = 16; off > 0; off >>= 1)
                z += __shfl_xor_sync(0xffffffffu, z, off);
            const float rz = 1.0f / z, mk = sMk[r];
            float inner = 0.0f;
            for (int gg = lane; gg < G; gg += 32) {
                const float w = sW[r * G + gg] * rz;
                sW[r * G + gg] = w;
                float dwm = 0.0f;
                for (int dd = 0; dd < d; ++dd)
                    dwm = fmaf(sF[r * d + dd], dtok[(size_t)gg * d + dd], dwm);
                dwm += dnorm[gg];
                const float dwa =
                    __bfloat162float(p.dslice_w[n * hg + hh * G + gg]) +
                    dwm * mk;
                sDS[r * G + gg] = dwa;
                inner += w * dwa;
            }
            for (int off = 16; off > 0; off >>= 1)
                inner += __shfl_xor_sync(0xffffffffu, inner, off);
            for (int gg = lane; gg < G; gg += 32) {
                const float w = sW[r * G + gg];
                sDS[r * G + gg] = w * (sDS[r * G + gg] - inner);
            }
        }
        __syncthreads();
        // ---- dWsl_h += xm16^T dl16; per slot dbsl += dl, dinv_temp +=
        //      ds * l ----
        for (int e = threadIdx.x; e < d * G + G; e += BK_THREADS) {
            if (e < d * G) {
                const int dd = e / G, gg = e - dd * G;
                float s = 0.0f;
                for (int r = 0; r < nrow; ++r)
                    s = fmaf(sM[r * d + dd], round_bf16(sDS[r * G + gg] * it), s);
                const size_t at = ((size_t)hh * d + dd) * G + gg;
                part[at] = t == 0 ? s : part[at] + s;
            } else {
                const int gg = e - d * G;
                float a = 0.0f, bb = 0.0f;
                for (int r = 0; r < nrow; ++r) {
                    const float ds = sDS[r * G + gg];
                    a += ds * sL[r * G + gg];
                    bb += ds * it;
                }
                const size_t at = (size_t)hgd + hh * G + gg;
                part[at] = t == 0 ? bb : part[at] + bb;
                part[at + hg] = t == 0 ? a : part[at + hg] + a;
            }
        }
        __syncthreads();
        // ---- dfx = (w mask) dtok_h, dxm = dl16 Wsl^T: the bf16 rows ----
        for (int i = threadIdx.x; i < nrow * d; i += BK_THREADS) {
            const int r = i / d, dd = i - r * d;
            float a = 0.0f, q = 0.0f;
            for (int gg = 0; gg < G; ++gg) {
                a = fmaf(sW[r * G + gg] * sMk[r], dtok[(size_t)gg * d + dd], a);
                q = fmaf(round_bf16(sDS[r * G + gg] * it),
                         __bfloat162float(p.wsl[(size_t)dd * G + gg]), q);
            }
            sF[i] = a;
            sM[i] = q;
            const size_t at = ((size_t)bl * p.N + r0 + r) * c + col0 + dd;
            p.dfxs[at] = __float2bfloat16(a);
            p.dxms[at] = __float2bfloat16(q);
        }
        __syncthreads();
        // ---- dbfx, dbx: the head's columns over the tile's rows ----
        for (int dd = threadIdx.x; dd < d; dd += BK_THREADS) {
            float a = 0.0f, q = 0.0f;
            for (int r = 0; r < nrow; ++r) {
                a += sF[r * d + dd];
                q += sM[r * d + dd];
            }
            const size_t at = (size_t)hgd + 2 * hg + col0 + dd;
            part[at] = t == 0 ? a : part[at] + a;
            part[at + c] = t == 0 ? q : part[at + c] + q;
        }
    }
}

// dx = bf16(dfx16 Wfx^T + dxm16 Wx^T) over all B*N rows: a block a tile of
// DX_TM rows by one pass of output columns (grid: row tiles, passes), the
// rows and the weights streamed through the ring (pass_product), so the
// shared memory does not grow with C
__global__ void __launch_bounds__(BK_THREADS) pool_dx(
        const bf16* __restrict__ dfxs, const bf16* __restrict__ dxms,
        const bf16* __restrict__ wfx, const bf16* __restrict__ wx,
        bf16* __restrict__ dx, int M, int c) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Blk b = make_blk(DX_TM, reinterpret_cast<bf16*>(smem));
    const WSrc Wf{wfx, c, nullptr, 0}, Wm{wx, c, nullptr, 0};
    const int r0 = blockIdx.x * DX_TM, nrow = min(DX_TM, M - r0);
    const int n0 = blockIdx.y * b.pw;
    float acc[8][4];
    const int nv = pass_product<true>(b, acc, dfxs, c, r0, nrow, c, Wf, n0, c);
    pass_product<true>(b, acc, dxms, c, r0, nrow, c, Wm, n0, c, true);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        if (nt < nv) {
            const int col = n0 + b.wcol * 64 + nt * 8 + 2 * b.t;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = b.wrow * 16 + b.g + 8 * hf;
                if (row < nrow)
                    store_bf16x2(dx + (size_t)(r0 + row) * c + col,
                                 acc[nt][2 * hf], acc[nt][2 * hf + 1]);
            }
        }
    }
    cp_async_wait<0>();
}

}  // namespace

// total: the float32 slab [dWfx | dWx (C x C) | dWsl per head [H][D][G] |
// dbsl per slot [H*G] | dinv_temp per slot [H*G] | dbfx | dbx (C)], the
// weight gradients summed per batch lane, each lane's sum rounded to bf16,
// the lanes summed in order
extern "C" int gfvgn_fused_slice_pool_bwd(
        const void* x, const void* mask, int mask_bstride, const void* wfx,
        const void* bfx, const void* wx, const void* bx, const void* wsl,
        const void* bsl, const void* inv_temp, const void* dslice_w,
        const void* dtokens, const void* dnorm, void* dx, void* total, int c,
        int h, int g, int B, int N, void* workspace, void* stream) {
    PoolRun P;
    int err = pool_run(c, h, g, B, N, true, P);
    if (err != 0) return err;
    if (mask_bstride != 0 && mask_bstride != N)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    bf16* dfxs = reinterpret_cast<bf16*>(ws + P.o_dfx);
    bf16* dxms = reinterpret_cast<bf16*>(ws + P.o_dxm);
    float* part = reinterpret_cast<float*>(ws + P.o_part);
    if (P.path == POOL_TILES) {
        PoolParams p{};
        fill_pool(p, P, x, mask, mask_bstride, wfx, bfx, wx, bx, wsl, bsl,
                  inv_temp, N, ws);
        p.dslice_w = static_cast<const bf16*>(dslice_w);
        p.dtok = static_cast<const float*>(dtokens);
        p.dnorm = static_cast<const float*>(dnorm);
        p.dx = static_cast<bf16*>(dx);
        p.dfxs = dfxs;
        p.dxms = dxms;
        err = launch_pool(P, p, B, st);
    } else {
        GenBwdParams p;
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
        p.dfxs = dfxs;
        p.dxms = dxms;
        p.part = part;
        p.N = N;
        p.mask_bstride = mask_bstride;
        p.rows_per_chunk = P.rows_per_chunk;
        p.n_chunks = P.n_chunks;
        p.part_len = P.part_len;
        p.c = c; p.h = h; p.g = g; p.d = c / h; p.tm = P.tm;
        cudaError_t e = cudaFuncSetAttribute(
            pool_bwd_generic, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)P.smem);
        if (e != cudaSuccess) return (int)e;
        pool_bwd_generic<<<dim3(P.n_chunks, B, h), BK_THREADS, P.smem, st>>>(
            p);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
        const int m = B * N;
        const int pw = (8 / (DX_TM / 16)) * 64;
        pool_dx<<<dim3((m + DX_TM - 1) / DX_TM, c / pw), BK_THREADS,
                  dx_smem(), st>>>(dfxs, dxms, static_cast<const bf16*>(wfx),
                                   static_cast<const bf16*>(wx),
                                   static_cast<bf16*>(dx), m, c);
        err = (int)cudaGetLastError();
    }
    if (err != 0) return err;
    // dWfx = x^T dfx16, dWx = x^T dxm16, per batch lane
    gfvgn::WgParams& q = P.q;
    q.job[0].a = static_cast<const bf16*>(x);
    q.job[0].b = dfxs;
    q.job[1].a = static_cast<const bf16*>(x);
    q.job[1].b = dxms;
    q.part = reinterpret_cast<float*>(ws + P.o_wg);
    float* tot = static_cast<float*>(total);
    err = gfvgn_wgrad(&q, B, tot, st);
    if (err != 0) return err;
    lane_reduce<<<(P.part_len + 255) / 256, 256, 0, st>>>(
        part, tot + q.n_w, P.part_len, P.s.hg * P.s.d, B, P.n_chunks);
    return (int)cudaGetLastError();
}
