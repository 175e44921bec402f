// What the kernels of fused_mlp.cu, fused_premlp.cu and fused_slice_pool.cu
// share: the sm_90 primitives (ldmatrix, mma.sync m16n8k16, cp.async), bf16
// packing, the GELU of the MLP chains and its derivative, the block product
// of the row tiles (weights resident in shared memory or streamed through a
// two-slot cp.async ring), and the weight-gradient pass of the backward
// kernels (one kernel, `fused_mlp_wgrad` in fused_mlp.cu, reached by every
// backward through the C entry `gfvgn_wgrad`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace gfvgn {

typedef __nv_bfloat16 bf16;

// One weight gradient of a batch lane: out[m][n] = A^T B over the lane's
// rows, A [rows, lda] (m columns from a), B [rows, ldb] (n columns from b).
struct WgJob {
    const bf16* a;
    int lda;
    int m;
    const bf16* b;
    int ldb;
    int n;
    int out;          // offset of out[0][0] in the weight slab
    int ldo;          // row stride of out in the slab
};

constexpr int MAX_WG_JOBS = 4;

struct WgParams {
    WgJob job[MAX_WG_JOBS];
    int n_jobs;
    int rows_per_lane;
    int chunk_rows;   // rows of a chunk (a multiple of WG_KR)
    int n_chunks;
    float* part;      // [lanes][n_chunks][n_w]
    int n_w;
};

constexpr int WG_KR = 32;         // rows of a weight-gradient stage

// output tiles (128 x 128) of the jobs
inline int wg_tiles(const WgParams& q) {
    int t = 0;
    for (int i = 0; i < q.n_jobs; ++i)
        t += ((q.job[i].m + 127) / 128) * ((q.job[i].n + 127) / 128);
    return t;
}

// chunks of a lane's rows for about two blocks an SM over tiles x lanes
inline void wg_chunking(int tiles, int rows_per_lane, int lanes, int n_sm,
                        int& chunk_rows, int& n_chunks) {
    const int steps = rows_per_lane > 0
        ? (rows_per_lane + WG_KR - 1) / WG_KR : 1;
    int want = (2 * n_sm + tiles * lanes - 1) / (tiles * lanes);
    if (want < 1) want = 1;
    if (want > steps) want = steps;
    chunk_rows = ((steps + want - 1) / want) * WG_KR;
    n_chunks = rows_per_lane > 0
        ? (rows_per_lane + chunk_rows - 1) / chunk_rows : 1;
}

}  // namespace gfvgn

// The weight-gradient pass and its fixed-order reduction: per lane and row
// chunk the jobs' products into q->part, then total[e] = sum over lanes (in
// order) of the lane's chunks (in order), each lane's sum rounded to bf16
// (e < q->n_w). Defined in fused_mlp.cu.
extern "C" int gfvgn_wgrad(const gfvgn::WgParams* q, int lanes, float* total,
                           cudaStream_t stream);

namespace {

using gfvgn::bf16;

// ===== sm_90 primitives =====
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// d += a * b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes device memory -> shared memory, asynchronous; zero-fills the
// destination instead when !pred (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0)
                 : "memory");
}

// 4 bytes device memory -> shared memory, asynchronous (through L1);
// zero-fills the destination instead when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 4 : 0)
                 : "memory");
}

// the 8x8 b16 matrix of a warp's fragments (a thread's register: row
// lane / 4, columns 2 (lane % 4) and + 1), transposed
__device__ __forceinline__ uint32_t movm_trans(uint32_t a) {
    uint32_t d;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
                 : "=r"(d) : "r"(a));
    return d;
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// ===== end of sm_90 primitives =====

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
    return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// 4 bf16 at p (8-byte aligned) <-> v[0..3]
__device__ __forceinline__ void load_bf16x4(const bf16* p, float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack_bf16(raw.x), b = unpack_bf16(raw.y);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store_bf16x4(bf16* p, const float v[4]) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16(x));
}

// GELU, tanh form: 0.5 x (1 + tanh(u)), u = sqrt(2/pi) (x + 0.044715 x^3),
// evaluated as x * s with s = sigmoid(2u) = 1 / (1 + e^(-2u)): the same
// function with one exp and one fast reciprocal (each within 2 ulps),
// where tanhf and an IEEE division cost more than the products of the
// chain. It differs from the plain version's tanh form in the last bits of
// float32, as tanhf did.
__device__ __forceinline__ float gelu_u(float x) {
    return 0.7978845608028654f * (x + 0.044715f * x * x * x);
}

__device__ __forceinline__ float gelu_tanh(float x) {
    return x * __fdividef(1.0f, 1.0f + __expf(-2.0f * gelu_u(x)));
}

// gelu(x) and its derivative from the same exp: with s = sigmoid(2u),
// 1 + tanh = 2s and 1 - tanh^2 = 4 s (1 - s), so the derivative 0.5 (1 +
// tanh) + 0.5 x (1 - tanh^2) u' = s + 2 x s (1 - s) u', and 1 - s = e s
// (no cancellation; 1 where e overflows and s is 0)
__device__ __forceinline__ float gelu_and_grad(float x, float& grad) {
    const float e = __expf(-2.0f * gelu_u(x));
    const float s = __fdividef(1.0f, 1.0f + e);
    const float sm = e < 3.0e38f ? e * s : 1.0f;
    const float du =
        0.7978845608028654f * (1.0f + (float)(3.0 * 0.044715) * x * x);
    grad = s + 2.0f * x * (s * sm) * du;
    return x * s;
}

// acc[8][4] += A[16 x 16*ksteps] * B over a warp's 64 output columns.
// `a` points at the warp's first row and first contraction column (row
// stride lda); B is [k][n] row-major (BT false: `b` at (k0, n0)) or [n][k]
// (BT true, a weight read as its transpose: `b` at (n0, k0)). `nv` (even,
// 0..8) is the number of valid 8-column tiles; the rest are left alone.
template <bool BT>
__device__ __forceinline__ void warp_mma(float acc[8][4], const bf16* a,
                                         int lda, const bf16* b, int ldb,
                                         int ksteps, int nv) {
    const int lane = threadIdx.x & 31;
    const bf16* ap = a + (lane & 15) * lda + ((lane >> 4) << 3);
    const bf16* bp = BT
        ? b + ((lane & 7) + ((lane >> 4) << 3)) * ldb + (((lane >> 3) & 1) << 3)
        : b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + ((lane >> 4) << 3);
    for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t af[4];
        ldsm_x4(af, ap + ks * 16);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
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

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
}

// the current device's shared memory a block can opt into, its SMs and
// (when asked for) the shared memory of an SM
inline int device_limits(int& max_smem, int& n_sm, int* sm_smem = nullptr) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    if (sm_smem != nullptr) {
        e = cudaDeviceGetAttribute(
            sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                       dev);
}

// ===== block products of a row tile =====
//
// A block of 8 warps owns a tile of tm rows: wr = tm / 16 warps over the
// rows, wc = 8 / wr over the columns, each warp a 16 x 64 block of a pass of
// pw = wc * 64 output columns. A weight is resident (a copy in shared memory
// staged once by the block) or streamed: chunks of BK_KC contraction rows
// through two ring slots by cp.async, the next chunk in flight while the
// warps multiply the current one. Every thread of the block takes part in
// every streamed product (the ring's barriers).

constexpr int BK_THREADS = 256;
constexpr int BK_KC = 32;

struct Blk {
    int tm, wr, wc, pw;
    int wrow, wcol, g, t;
    bf16* ring;          // two slots of ring_slot elements (streamed mode)
};

// elements of a ring slot: [BK_KC][pw + 8] or, transposed, [pw][BK_KC + 8]
__host__ __device__ inline int ring_slot(int pw) {
    const int a = BK_KC * (pw + 8), b = pw * (BK_KC + 8);
    return a > b ? a : b;
}

__host__ __device__ inline size_t align128(size_t x) {
    return (x + 127) & ~(size_t)127;
}

__device__ __forceinline__ Blk make_blk(int tm, bf16* ring) {
    Blk b;
    b.tm = tm;
    b.wr = tm / 16;
    b.wc = 8 / b.wr;
    b.pw = b.wc * 64;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    b.wrow = warp % b.wr;
    b.wcol = warp / b.wr;
    b.g = lane >> 2;
    b.t = lane & 3;
    b.ring = ring;
    return b;
}

// A weight: device memory (row stride ldg) and, when resident, its staged
// copy (row stride lds). BT false: W [k][n]; BT true: W [n][k].
struct WSrc {
    const bf16* g;
    int ldg;
    const bf16* s;
    int lds;
};

// the resident copy of W [rows][cols] (cols % 8 == 0), by cp.async; the
// caller commits and waits
__device__ __forceinline__ void stage_matrix(bf16* dst, int ldd,
                                             const bf16* src, int rows,
                                             int cols) {
    const int cpr = cols >> 3;
    for (int i = threadIdx.x; i < rows * cpr; i += BK_THREADS) {
        const int r = i / cpr, ch = i - r * cpr;
        cp_async16(dst + (size_t)r * ldd + ch * 8, src + (size_t)r * cols + ch * 8,
                   true);
    }
}

// rows r0 .. r0 + tm of a [*, w] array -> dst (row stride ldd), rows past
// nrow zero-filled; by cp.async, the caller commits
__device__ __forceinline__ void load_tile_rows(bf16* dst, int ldd,
                                               const bf16* src, int w, int r0,
                                               int nrow, int tm) {
    const int cpr = w >> 3;
    for (int i = threadIdx.x; i < tm * cpr; i += BK_THREADS) {
        const int r = i / cpr, ch = i - r * cpr;
        const bool ok = r < nrow;
        cp_async16(dst + r * ldd + ch * 8,
                   src + (size_t)(ok ? r0 + r : r0) * w + ch * 8, ok);
    }
}

// chunk kc of a streamed product (columns n0 .. n0 + pw) into a ring slot
template <bool BT>
__device__ __forceinline__ void fetch_wchunk(const Blk& b, bf16* slot,
                                             const WSrc& w, int k, int kc,
                                             int n0, int n) {
    const int k0 = kc * BK_KC;
    const int nk = min(BK_KC, k - k0), nn = min(b.pw, n - n0);
    if (!BT) {
        const int cpr = nn >> 3;
        for (int i = threadIdx.x; i < nk * cpr; i += BK_THREADS) {
            const int r = i / cpr, ch = i - r * cpr;
            cp_async16(slot + r * (b.pw + 8) + ch * 8,
                       w.g + (size_t)(k0 + r) * w.ldg + n0 + ch * 8, true);
        }
    } else {
        const int cpr = nk >> 3;
        for (int i = threadIdx.x; i < nn * cpr; i += BK_THREADS) {
            const int r = i / cpr, ch = i - r * cpr;
            cp_async16(slot + r * (BK_KC + 8) + ch * 8,
                       w.g + (size_t)(n0 + r) * w.ldg + k0 + ch * 8, true);
        }
    }
}

// acc (+)= A[this warp's 16 rows of the tile, 0..k) * op(W)[:, pass
// columns n0 .. n0 + pw) (n columns in all); A in shared memory (the tile's
// first row at sA, row stride lda); `keep` adds to acc. Returns the warp's
// valid 8-column tiles.
template <bool BT>
__device__ __forceinline__ int block_product(const Blk& b, float acc[8][4],
                                             const bf16* sA, int lda, int k,
                                             const WSrc& w, int n0, int n,
                                             bool keep = false) {
    if (!keep) zero_acc(acc);
    const int nw0 = n0 + b.wcol * 64;
    const int nv = max(0, min(8, (n - nw0) / 8));
    const bf16* a = sA + b.wrow * 16 * lda;
    if (w.s != nullptr) {
        if (nv > 0) {
            const bf16* bp = BT ? w.s + (size_t)nw0 * w.lds
                                : w.s + nw0;
            warp_mma<BT>(acc, a, lda, bp, w.lds, k / 16, nv);
        }
        return nv;
    }
    const int slot = ring_slot(b.pw);
    const int nk = (k + BK_KC - 1) / BK_KC;
    __syncthreads();                 // the slots are free
    fetch_wchunk<BT>(b, b.ring, w, k, 0, n0, n);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<0>();
        __syncthreads();
        if (kc + 1 < nk)
            fetch_wchunk<BT>(b, b.ring + ((kc + 1) & 1) * slot, w, k, kc + 1,
                             n0, n);
        cp_async_commit();
        const bf16* s = b.ring + (kc & 1) * slot;
        const int ks = min(BK_KC, k - kc * BK_KC) / 16;
        if (nv > 0) {
            if (BT) warp_mma<true>(acc, a + kc * BK_KC, lda,
                                   s + b.wcol * 64 * (BK_KC + 8), BK_KC + 8,
                                   ks, nv);
            else warp_mma<false>(acc, a + kc * BK_KC, lda, s + b.wcol * 64,
                                 b.pw + 8, ks, nv);
        }
    }
    return nv;
}

// column sums of a warp's 16 rows for one 8-column tile (v0: column 2t, v1:
// 2t + 1, each already the sum of this thread's two rows) -> red[0..1]
__device__ __forceinline__ void col_sum_store(float v0, float v1, int g,
                                              float* red) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, o);
        v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (g == 0) {
        red[0] = v0;
        red[1] = v1;
    }
}

}  // namespace
