// What the kernels of fused_mlp.cu, fused_premlp.cu and fused_slice_pool.cu
// share: the sm_90 primitives (ldmatrix, mma.sync m16n8k16, cp.async), bf16
// packing, the GELU of the MLP chains and its derivative, a warp's 16-row
// strip (K2/K3 at H = 128, K5f at C = 128: A fragments, their rows loaded
// and stored, quad sums), the warpgroup product (wgmma m64n128k16 with A
// from a strip's registers and B from a weight's swizzled panels: K2/K3's
// warpgroup kernels), the block product
// of the row tiles (weights resident in shared memory or streamed through a
// two-slot cp.async ring), the pass product (both operands streamed), and
// the weight-gradient pass of the backward
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

// ===== a warp's 16-row strip (the row kernels: K2/K3 at H = 128, K5f at
// C = 128) =====

// the packed bf16 pair (row g + 8 hf, columns 2t, 2t + 1 of tile nt) into
// its place in the A fragments of the next product
__device__ __forceinline__ void put_a(uint32_t a[8][4], int nt, int hf,
                                      uint32_t v) {
    a[nt >> 1][((nt & 1) << 1) + hf] = v;
}

// rows r0 .. r0 + 16 of a [M, w] array -> this warp's buffer, rows past
// nrow zero-filled
__device__ __forceinline__ void warp_load_rows(bf16* dst, int ldd,
                                               const bf16* src, int w, int r0,
                                               int nrow) {
    const int lane = threadIdx.x & 31;
    const int cpr = w >> 3;
    for (int i = lane; i < 16 * cpr; i += 32) {
        const int r = i / cpr, ch = i - r * cpr;
        const bool ok = r < nrow;
        cp_async16(dst + r * ldd + ch * 8,
                   src + (size_t)(ok ? r0 + r : r0) * w + ch * 8, ok);
    }
}

// Rows r0 .. r0 + 16 (real rows < nrow) of a bf16 [*, ld] array from A
// fragments a[p] (columns 16p .. 16p + 15, p < npairs): the four lanes of a
// quad trade their pairs so that lane t holds columns 16p + 4t .. + 3 and
// each store writes whole 32-byte sectors of a row (4-byte stores leave
// half sectors that the memory completes by read-modify-write)
__device__ __forceinline__ void store_frag_rows(bf16* base, int ld, int r0,
                                                int nrow,
                                                const uint32_t a[8][4],
                                                int npairs) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int q0 = lane & ~3;
    const int s1 = q0 + ((2 * t) & 3), s2 = q0 + ((2 * t + 1) & 3);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
        if (p < npairs) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const uint32_t x = a[p][hf], y = a[p][2 + hf];
                const uint32_t x1 = __shfl_sync(0xffffffffu, x, s1);
                const uint32_t y1 = __shfl_sync(0xffffffffu, y, s1);
                const uint32_t x2 = __shfl_sync(0xffffffffu, x, s2);
                const uint32_t y2 = __shfl_sync(0xffffffffu, y, s2);
                const int row = g + 8 * hf;
                if (row < nrow) {
                    uint2 v;
                    v.x = t < 2 ? x1 : y1;
                    v.y = t < 2 ? x2 : y2;
                    *reinterpret_cast<uint2*>(
                        base + (size_t)(r0 + row) * ld + 16 * p + 4 * t) = v;
                }
            }
        }
    }
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
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

// ===== the pass product: both operands streamed =====
//
// The same block product with A streamed from device memory too, so that
// a block's shared memory does not grow with the contraction width (the
// passes of K5f/K5b from C = 256 on, K7's run-time dx pass): each ring slot
// holds A's chunk of BK_KC contraction columns for the tile's rows, then
// W's chunk, and the next slot is in flight while the warps multiply.

// elements of a pass-product ring slot for a tile of tm rows
__host__ __device__ inline int pass_slot(int tm, int pw) {
    return tm * (BK_KC + 8) + ring_slot(pw);
}

// contraction chunk kc of rows r0 .. r0 + tm of A [*, lda] (device
// memory; rows past nrow zero-filled) -> dst [tm][BK_KC + 8]
__device__ __forceinline__ void fetch_achunk(bf16* dst, const bf16* a,
                                             int lda, int r0, int nrow,
                                             int tm, int k, int kc) {
    const int k0 = kc * BK_KC, cpr = min(BK_KC, k - k0) >> 3;
    for (int i = threadIdx.x; i < tm * cpr; i += BK_THREADS) {
        const int r = i / cpr, ch = i - r * cpr;
        const bool ok = r < nrow;
        cp_async16(dst + r * (BK_KC + 8) + ch * 8,
                   a + (size_t)(ok ? r0 + r : r0) * lda + k0 + ch * 8, ok);
    }
}

// acc (+)= A[rows r0 .. r0 + tm (real rows < nrow), 0..k) * op(W)[:, pass
// columns n0 .. n0 + pw) (n columns in all), A [*, lda] in device memory;
// the ring (b.ring) holds two pass_slot(b.tm, b.pw) slots. k % 16 == 0.
// Returns the warp's valid 8-column tiles.
template <bool BT>
__device__ __forceinline__ int pass_product(const Blk& b, float acc[8][4],
                                            const bf16* a, int lda, int r0,
                                            int nrow, int k, const WSrc& w,
                                            int n0, int n,
                                            bool keep = false) {
    if (!keep) zero_acc(acc);
    const int nw0 = n0 + b.wcol * 64;
    const int nv = max(0, min(8, (n - nw0) / 8));
    const int slot = pass_slot(b.tm, b.pw), aw = b.tm * (BK_KC + 8);
    const int nk = (k + BK_KC - 1) / BK_KC;
    __syncthreads();                 // the slots are free
    fetch_achunk(b.ring, a, lda, r0, nrow, b.tm, k, 0);
    fetch_wchunk<BT>(b, b.ring + aw, w, k, 0, n0, n);
    cp_async_commit();
    for (int kc = 0; kc < nk; ++kc) {
        cp_async_wait<0>();
        __syncthreads();
        if (kc + 1 < nk) {
            bf16* nxt = b.ring + ((kc + 1) & 1) * slot;
            fetch_achunk(nxt, a, lda, r0, nrow, b.tm, k, kc + 1);
            fetch_wchunk<BT>(b, nxt + aw, w, k, kc + 1, n0, n);
        }
        cp_async_commit();
        const bf16* s = b.ring + (kc & 1) * slot;
        const bf16* sa = s + b.wrow * 16 * (BK_KC + 8);
        const int ks = min(BK_KC, k - kc * BK_KC) / 16;
        if (nv > 0) {
            if (BT) warp_mma<true>(acc, sa, BK_KC + 8,
                                   s + aw + b.wcol * 64 * (BK_KC + 8),
                                   BK_KC + 8, ks, nv);
            else warp_mma<false>(acc, sa, BK_KC + 8, s + aw + b.wcol * 64,
                                 b.pw + 8, ks, nv);
        }
    }
    return nv;
}

// ===== warpgroup products (wgmma, sm_90a) =====
//
// A weight W [rows][128] bf16 resident in the canonical 128-byte-swizzled
// layout, without padding: two panels of 64 columns, each [rows][64] with
// 128-byte rows, the 16-byte chunk c of row r stored at chunk c ^ (r % 8),
// every panel 1024-byte aligned (rows a multiple of 8). One staged copy
// serves both products: x W reads it MN-major (the 64 columns of a panel
// contiguous; LBO = the panel stride, SBO = 8 rows), h W^T K-major (a W row
// is the contraction; SBO = 8 rows, a k-step 32 bytes further in the row).

// byte offset of 16-byte chunk ch (0..15) of row r in the panel layout
__host__ __device__ inline size_t panel_at(int rows, int r, int ch) {
    return (size_t)(ch >> 3) * rows * 128 + (size_t)r * 128 +
           (((ch & 7) ^ (r & 7)) << 4);
}

// W [rows][128] (device memory) -> its panel layout at dst, by cp.async
// over `threads` threads; the caller commits and waits
__device__ __forceinline__ void stage_panels(void* dst, const bf16* src,
                                             int rows, int threads) {
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (int i = threadIdx.x; i < rows * 16; i += threads) {
        const int r = i >> 4, ch = i & 15;
        cp_async16(d + panel_at(rows, r, ch), src + (size_t)r * 128 + ch * 8,
                   true);
    }
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
    const uint32_t a = smem_addr(p);
    return (uint64_t)((a & 0x3FFFF) >> 4) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// after wg_wait: the accumulators are read only from here on
__device__ __forceinline__ void wg_fence_acc(float d[16][4]) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// after wg_wait: the A fragments stay in their registers until here (the
// compiler does not see the asynchronous reads of the products)
__device__ __forceinline__ void wg_keep(const uint32_t a[4]) {
    asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]) : "memory");
}

#define GFVGN_ACC16(i)                                                         \
    "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])

// d[64 x 128] += A[64 x 16] B[16 x 128] over the warpgroup: A from
// registers (this warp's 16 rows as an m16n8k16 A fragment), B by
// descriptor, K-major (TB 0) or MN-major (TB 1); d[nt][e] is the m16n8
// accumulator layout of this warp's rows, column tile nt. Asynchronous:
// wg_fence before, wg_commit and wg_wait after.
template <int TB>
__device__ __forceinline__ void wgmma_128(float d[16][4], const uint32_t a[4],
                                          uint64_t desc) {
    const int accumulate = 1;
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n}\n"
        : GFVGN_ACC16(0), GFVGN_ACC16(1), GFVGN_ACC16(2), GFVGN_ACC16(3),
          GFVGN_ACC16(4), GFVGN_ACC16(5), GFVGN_ACC16(6), GFVGN_ACC16(7),
          GFVGN_ACC16(8), GFVGN_ACC16(9), GFVGN_ACC16(10), GFVGN_ACC16(11),
          GFVGN_ACC16(12), GFVGN_ACC16(13), GFVGN_ACC16(14), GFVGN_ACC16(15)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
          "r"(accumulate));
}

#undef GFVGN_ACC16

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
