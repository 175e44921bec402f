// The segment engine's GraphNet transfers between nodes and faces, each one
// pass over per-sample CSR incidence lists (ops/segment_csr.py builds them),
// summed in a fixed order, for sm_90a.
//
// Replaces no TPU kernel: the JAX package's GraphNet blocks
// (gen_fvgn_tpu/models/gn.py) move these rows with jax.ops.segment_sum and
// row takes, which XLA lowers to its scatter and gather. The port's plain
// version (ops/segment.py) gathers node rows into [B, E, h] face tensors,
// masks them and index_adds them back onto nodes with atomics; each such
// intermediate is written and read again only to be summed.
//
// Three kernels, rows flattened over the batch (node row b*N + n, face row
// b*E + f; the lists hold those rows, so each batch lane reads its own
// sample's lists and a mixed-case batch is served like a single-case one):
//   * seg_nbr_sum (N <- N): out[n] = sum over the faces f where n receives of
//     x[s(f)] + sum over the faces where n sends of x[r(f)];
//   * seg_inc_sum (N <- E): out[n] = sum over the faces where n receives of
//     e[f, col_r : col_r + w] + sum over those where n sends of
//     e[f, col_s : col_s + w];
//   * seg_collect (E <- N): up to three column windows of each face row,
//     each a node row gathered by the face's sender or receiver, or the
//     face's own row of another tensor; rows of masked faces zero where a
//     mask is given. A gather rounds nothing.
//
// Rounding, the plain version's: a list sums in the data's type in its
// order (ascending face order), rounding after every add, as the CPU
// index_add and JAX's segment_sum do; the two lists' results are added and
// rounded once. Two runs give the same bits.
//
// What bounds them here: bytes. A node has a few faces, so a row is a short
// gather-accumulate with one add per element read. G threads own a row (G
// the power of two that covers its 16-byte vectors, at most 32; 16 at
// h = 128 in bf16), each a vector. A row's time is the latency of its
// dependent loads (row pointers, entries, rows), so the first kFirst rows
// of both lists are in flight together (every list of a quadrilateral
// mesh), further entries kAhead at a time, and they are added in order
// after they arrive. The gathered rows stay in L2 where neighbours are
// near in the node order.
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFirst = 2;   // a list's entries loaded with the other list's
constexpr int kAhead = 4;   // a list's further entries loaded before they add

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// N consecutive elements as they lie in memory: one 16-byte vector, or one
// element (N == 1)
template <typename T, int N> struct Raw { using type = uint4; };
template <typename T> struct Raw<T, 1> { using type = T; };

template <typename T, int N>
__device__ __forceinline__ typename Raw<T, N>::type load_raw(const T* p) {
    if constexpr (N == 1) {
        return p[0];
    } else {
        static_assert(N * sizeof(T) == 16, "a vector is 16 bytes");
        return __ldg(reinterpret_cast<const uint4*>(p));
    }
}

// acc += v, each element's add rounded to T (acc holds T's values)
template <typename T, int N>
__device__ __forceinline__ void add_raw(float (&acc)[N],
                                        const typename Raw<T, N>::type& v) {
    if constexpr (N == 1) {
        acc[0] = to_f(from_f<T>(acc[0] + to_f(v)));
    } else {
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int i = 0; i < N; ++i)
            acc[i] = to_f(from_f<T>(acc[i] + to_f(e[i])));
    }
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&v)[N]) {
    if constexpr (N == 1) {
        p[0] = from_f<T>(v[0]);
    } else {
        uint4 u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int i = 0; i < N; ++i) e[i] = from_f<T>(v[i]);
        *reinterpret_cast<uint4*>(p) = u;
    }
}

template <typename T, int N>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
    if constexpr (N == 1) {
        dst[0] = src[0];
    } else {
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(src));
    }
}

template <typename T, int N>
__device__ __forceinline__ void zero_vec(T* dst) {
    if constexpr (N == 1) {
        dst[0] = from_f<T>(0.0f);
    } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
}

struct SumArgs {
    const int* ptr_r;   // receiver lists: row pointers [rows + 1]
    const int* idx_r;   // their entries: the source row of each
    const int* ptr_s;   // sender lists
    const int* idx_s;
    const void* src;    // the source rows
    long long src_stride;   // elements between source rows
    int col_r, col_s;   // the column each list reads from
    void* out;
    long long out_stride;
    int rows, width, lg;    // lg: log2 of the threads a row
};

// acc += src[idx[k]] for k in [k0, k1), in that order, each add rounded to
// T; kAhead rows in flight before they are added
template <typename T, int N>
__device__ __forceinline__ void sum_list(float (&acc)[N],
                                         const int* __restrict__ idx, int k0,
                                         int k1, const T* src,
                                         long long stride) {
    for (int k = k0; k < k1; k += kAhead) {
        typename Raw<T, N>::type v[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
            if (k + j < k1)
                v[j] = load_raw<T, N>(src + (long long)__ldg(idx + k + j)
                                                * stride);
        }
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
            if (k + j < k1) add_raw<T, N>(acc, v[j]);
        }
    }
}

template <typename T, int N>
__device__ __forceinline__ void list_sum_rows(const SumArgs& a) {
    const int row = blockIdx.x * (kThreads >> a.lg) + (threadIdx.x >> a.lg);
    if (row >= a.rows) return;
    const int lane = threadIdx.x & ((1 << a.lg) - 1);
    const int r0 = __ldg(a.ptr_r + row), r1 = __ldg(a.ptr_r + row + 1);
    const int s0 = __ldg(a.ptr_s + row), s1 = __ldg(a.ptr_s + row + 1);
    // both lists' first kFirst entries, then their rows, are loaded before
    // either list adds: a node's short lists cost one round of loads
    const int nr = min(r1 - r0, kFirst), ns = min(s1 - s0, kFirst);
    int ir[kFirst], is[kFirst];
#pragma unroll
    for (int j = 0; j < kFirst; ++j) {
        if (j < nr) ir[j] = __ldg(a.idx_r + r0 + j);
        if (j < ns) is[j] = __ldg(a.idx_s + s0 + j);
    }
    const T* src = static_cast<const T*>(a.src);
    T* out = static_cast<T*>(a.out) + (long long)row * a.out_stride;
    for (int c = lane * N; c < a.width; c += N << a.lg) {
        const T* src_r = src + a.col_r + c;
        const T* src_s = src + a.col_s + c;
        typename Raw<T, N>::type hr[kFirst], hs[kFirst];
#pragma unroll
        for (int j = 0; j < kFirst; ++j) {
            const long long st = a.src_stride;
            if (j < nr) hr[j] = load_raw<T, N>(src_r + (long long)ir[j] * st);
            if (j < ns) hs[j] = load_raw<T, N>(src_s + (long long)is[j] * st);
        }
        float ar[N], as[N], o[N];
#pragma unroll
        for (int i = 0; i < N; ++i) ar[i] = as[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < kFirst; ++j) {
            if (j < nr) add_raw<T, N>(ar, hr[j]);
        }
        sum_list<T, N>(ar, a.idx_r, r0 + nr, r1, src_r, a.src_stride);
#pragma unroll
        for (int j = 0; j < kFirst; ++j) {
            if (j < ns) add_raw<T, N>(as, hs[j]);
        }
        sum_list<T, N>(as, a.idx_s, s0 + ns, s1, src_s, a.src_stride);
#pragma unroll
        for (int i = 0; i < N; ++i) o[i] = ar[i] + as[i];
        store_f<T, N>(out + c, o);
    }
}

// two names for the breakdown of a profile: the lists' neighbour rows
// (x is node rows) and their face rows (e is face rows)
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) seg_nbr_sum(SumArgs a) {
    list_sum_rows<T, N>(a);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) seg_inc_sum(SumArgs a) {
    list_sum_rows<T, N>(a);
}

struct GatherArgs {
    const int* idx[3];      // a window's source row of each output row, or
                            // null: the output row itself
    const void* src[3];
    long long src_stride[3];
    int col[3];             // the window's first output column
    int n_win;
    const unsigned char* mask;  // null, or 0 where the output row is zero
    void* out;
    long long out_stride;
    int rows, width, lg;
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) seg_collect(GatherArgs a) {
    const int row = blockIdx.x * (kThreads >> a.lg) + (threadIdx.x >> a.lg);
    if (row >= a.rows) return;
    const int lane = threadIdx.x & ((1 << a.lg) - 1);
    const bool live = a.mask == nullptr || a.mask[row] != 0;
    T* out = static_cast<T*>(a.out) + (long long)row * a.out_stride;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
        if (w >= a.n_win) break;
        T* dst = out + a.col[w];
        if (!live) {
            for (int c = lane * N; c < a.width; c += N << a.lg)
                zero_vec<T, N>(dst + c);
            continue;
        }
        const int sr = a.idx[w] ? __ldg(a.idx[w] + row) : row;
        const T* src = static_cast<const T*>(a.src[w])
                       + (long long)sr * a.src_stride[w];
        for (int c = lane * N; c < a.width; c += N << a.lg)
            copy_vec<T, N>(dst + c, src + c);
    }
}

// log2 of the threads a row: the power of two that covers its vectors, at
// most a warp
int row_lg(int width, int n) {
    const int nvec = (width + n - 1) / n;
    int lg = 0;
    while ((1 << lg) < nvec && lg < 5) ++lg;
    return lg;
}

dim3 row_grid(int rows, int lg) {
    const int per_block = kThreads >> lg;
    return dim3((rows + per_block - 1) / per_block);
}

template <typename T, int N>
void launch_sum(int faces, const SumArgs& a, cudaStream_t s) {
    if (faces)
        seg_inc_sum<T, N><<<row_grid(a.rows, a.lg), kThreads, 0, s>>>(a);
    else
        seg_nbr_sum<T, N><<<row_grid(a.rows, a.lg), kThreads, 0, s>>>(a);
}

template <typename T, int N>
void launch_gather(const GatherArgs& a, cudaStream_t s) {
    seg_collect<T, N><<<row_grid(a.rows, a.lg), kThreads, 0, s>>>(a);
}

}  // namespace

// faces: 0 for seg_nbr_sum (the lists' entries are node rows), 1 for
// seg_inc_sum (face rows); vec: every row, window and pointer 16-byte aligned
extern "C" int gfvgn_seg_list_sum(
    int faces, const int* ptr_r, const int* idx_r, const int* ptr_s,
    const int* idx_s, const void* src, long long src_stride, int col_r,
    int col_s, void* out, long long out_stride, int rows, int width,
    int is_bf16, int vec, void* stream) {
    if (rows <= 0 || width <= 0) return 0;
    const int n = vec ? (is_bf16 ? 8 : 4) : 1;
    const SumArgs a{ptr_r, idx_r, ptr_s, idx_s, src, src_stride, col_r,
                    col_s, out, out_stride, rows, width, row_lg(width, n)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        if (vec) launch_sum<__nv_bfloat16, 8>(faces, a, s);
        else launch_sum<__nv_bfloat16, 1>(faces, a, s);
    } else {
        if (vec) launch_sum<float, 4>(faces, a, s);
        else launch_sum<float, 1>(faces, a, s);
    }
    return static_cast<int>(cudaGetLastError());
}

// n_win windows of `width` columns; window k reads src_k's row idx_k[row]
// (idx_k null: row) into columns col_k of the output row
extern "C" int gfvgn_seg_collect(
    int n_win, const int* idx0, const void* src0, long long stride0, int col0,
    const int* idx1, const void* src1, long long stride1, int col1,
    const int* idx2, const void* src2, long long stride2, int col2,
    const unsigned char* mask, void* out, long long out_stride, int rows,
    int width, int is_bf16, int vec, void* stream) {
    if (rows <= 0 || width <= 0 || n_win <= 0) return 0;
    if (n_win > 3) return static_cast<int>(cudaErrorInvalidValue);
    const int n = vec ? (is_bf16 ? 8 : 4) : 1;
    const GatherArgs a{{idx0, idx1, idx2},
                       {src0, src1, src2},
                       {stride0, stride1, stride2},
                       {col0, col1, col2},
                       n_win, mask, out, out_stride, rows, width,
                       row_lg(width, n)};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        if (vec) launch_gather<__nv_bfloat16, 8>(a, s);
        else launch_gather<__nv_bfloat16, 1>(a, s);
    } else {
        if (vec) launch_gather<float, 4>(a, s);
        else launch_gather<float, 1>(a, s);
    }
    return static_cast<int>(cudaGetLastError());
}
