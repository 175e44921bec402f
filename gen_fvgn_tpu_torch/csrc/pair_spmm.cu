// K8 and K9: the paired sparse applies for sm_90a.
//
//   K8 pair_sum        out[b] = A * y[b][:, :H] + B * y[b][:, H:]
//   K9 pair_transpose  out[b] = [A * g[b] | B * g[b]]
//
// Replace the Pallas TPU kernels of gen_fvgn_tpu/ops/pallas_spmm.py:
// pallas_gather_pair (K8) and pallas_pair_transpose (K9), which stream the
// 256x256 dense tiles of two operators through the matrix unit over one
// union window of the operand. Here both operators are CSR with the same
// n_out, and the work is a gather-accumulate bounded by bytes, as in K1.
//
// K8 (pair_sum_kernel) is K1's design (csr_row in spmm_rows.cuh): a warp
// owns an output row for all B batch lanes; the indices of A's row and of
// B's row are loaded once, lane-parallel, as ONE list (A's non-zeros, then
// B's, B's reading the operand at column offset H) and broadcast by
// shuffles, so the gather pair's two one-hot rows put eight independent
// operand loads in flight a lane; 16-byte vectors where H and the
// addresses allow it, else 8, 4 or 2 bytes. Both operators' products go
// into ONE float32 accumulator per output element, in ascending order, A's
// non-zeros then B's, rounded once; stores are whole vectors, streamed
// past L2. A row's indices cost two dependent memory latencies before its
// first operand load, so the warps stay resident and walk over rows,
// loading the next row's indices while this row's operand loads are in
// flight (csr_rows_ahead): 0.043 / 0.038 ms for the gather / node pair at
// the paired path's shapes against 0.050 / 0.044 without (H100).
//
// K9 (pair_transpose_kernel) is still the first design: one warp per
// (output row, batch lane), each lane owning VEC contiguous features of
// every (32 * VEC)-feature chunk of the H-wide half (VEC 4 for H % 128 ==
// 0, 2 for H % 64 == 0, else 1); it writes both halves of its 2H-wide
// output row, each half from its own float32 accumulator and its own
// single rounding.
//
// A row with no non-zeros in either operator comes out exactly zero (the
// padding).
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                                float v[1]) {
        v[0] = __bfloat162float(*p);
    }
    static __device__ __forceinline__ void load(const float* p, float v[1]) {
        v[0] = *p;
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float v[1]) {
        *p = __float2bfloat16_rn(v[0]);
    }
    static __device__ __forceinline__ void store(float* p, const float v[1]) {
        *p = v[0];
    }
};

template <>
struct Vec<2> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                                float v[2]) {
        float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p));
        v[0] = f.x; v[1] = f.y;
    }
    static __device__ __forceinline__ void load(const float* p, float v[2]) {
        float2 f = *reinterpret_cast<const float2*>(p);
        v[0] = f.x; v[1] = f.y;
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float v[2]) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(v[0], v[1]);
    }
    static __device__ __forceinline__ void store(float* p, const float v[2]) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
};

template <>
struct Vec<4> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                                float v[4]) {
        uint2 raw = *reinterpret_cast<const uint2*>(p);
        float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
    static __device__ __forceinline__ void load(const float* p, float v[4]) {
        float4 f = *reinterpret_cast<const float4*>(p);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                                 const float v[4]) {
        __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
        uint2 raw;
        raw.x = *reinterpret_cast<uint32_t*>(&a);
        raw.y = *reinterpret_cast<uint32_t*>(&b);
        *reinterpret_cast<uint2*>(p) = raw;
    }
    static __device__ __forceinline__ void store(float* p, const float v[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    }
};

// acc += sum over the CSR row [start, end) of val * x[col * stride + f0 ...]
template <int VEC, typename XT>
__device__ __forceinline__ void accumulate(const int* __restrict__ col,
                                           const float* __restrict__ val,
                                           int start, int end,
                                           const XT* __restrict__ x,
                                           size_t stride, int f0,
                                           float acc[VEC]) {
    for (int j = start; j < end; ++j) {
        const float w = val[j];
        float v[VEC];
        Vec<VEC>::load(x + (size_t)col[j] * stride + f0, v);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = fmaf(w, v[k], acc[k]);
    }
}

// K9: g [B, n_in, H] -> out [B, n_out, 2H]
template <int VEC, typename XT, typename OT>
__global__ void pair_transpose_kernel(const int* __restrict__ a_crow,
                                      const int* __restrict__ a_col,
                                      const float* __restrict__ a_val,
                                      const int* __restrict__ b_crow,
                                      const int* __restrict__ b_col,
                                      const float* __restrict__ b_val,
                                      const XT* __restrict__ g,
                                      OT* __restrict__ out,
                                      int n_in, int n_out, int H) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + warp;
    if (row >= n_out) return;
    const int b = blockIdx.y;
    const int a0 = a_crow[row], a1 = a_crow[row + 1];
    const int b0 = b_crow[row], b1 = b_crow[row + 1];
    const XT* gb = g + (size_t)b * n_in * H;
    OT* ob = out + ((size_t)b * n_out + row) * 2 * (size_t)H;
    for (int f0 = lane * VEC; f0 < H; f0 += 32 * VEC) {
        float acc_a[VEC], acc_b[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc_a[k] = acc_b[k] = 0.f;
        accumulate<VEC>(a_col, a_val, a0, a1, gb, (size_t)H, f0, acc_a);
        accumulate<VEC>(b_col, b_val, b0, b1, gb, (size_t)H, f0, acc_b);
        Vec<VEC>::store(ob + f0, acc_a);
        Vec<VEC>::store(ob + H + f0, acc_b);
    }
}

struct Csr {
    const int* crow;
    const int* col;
    const float* val;
};

// K8: y [B, n_in, 2H] -> out [B, n_out, H]: a warp a row at a time over
// rows warp, warp + all warps, ..., each row's indices loaded while the
// row before it computes (csr_rows_ahead, spmm_rows.cuh). Registers capped
// at 128 (two blocks an SM): at IPL 2 the cap of three blocks spilled the
// prefetched indices and ran 4% slower on the node pair.
template <typename XT, typename OT, int VEC, int IPL>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
pair_sum_kernel(RowArgs a) {
    csr_rows_ahead<XT, OT, VEC, IPL, 2>(
        a, blockIdx.x * kRowWarps + (threadIdx.x >> 5),
        gridDim.x * kRowWarps);
}

// as many blocks as are resident on the card at once, at most a row a warp
template <typename XT, typename OT, int VEC, int IPL>
int launch_pair_sum_rows(const RowArgs& a, cudaStream_t s) {
    static int per_sm = 0;       // blocks of this kernel an SM holds
    int dev = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && per_sm == 0)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pair_sum_kernel<XT, OT, VEC, IPL>, kRowWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    const int rows = (a.n_out + kRowWarps - 1) / kRowWarps;
    const int resident = n_sm * (per_sm > 0 ? per_sm : 1);
    pair_sum_kernel<XT, OT, VEC, IPL>
        <<<rows < resident ? rows : resident, kRowWarps * 32, 0, s>>>(a);
    return (int)cudaGetLastError();
}

template <typename XT, typename OT, int VEC>
int launch_pair_sum(const RowArgs& a, cudaStream_t s) {
    const int ipl = row_ipl(a.B, a.F, VEC);
    if (ipl == 4) return launch_pair_sum_rows<XT, OT, VEC, 4>(a, s);
    if (ipl == 2) return launch_pair_sum_rows<XT, OT, VEC, 2>(a, s);
    return launch_pair_sum_rows<XT, OT, VEC, 1>(a, s);
}

bool aligned_to(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

// the widest vector (at most 16 bytes of the operand) that the width H and
// the operand's and the output's addresses allow
template <typename XT, typename OT>
int pair_sum_vec(const RowArgs& a, cudaStream_t s) {
    auto fits = [&](int vec) {
        return a.F % vec == 0 && aligned_to(a.x, vec * (int)sizeof(XT)) &&
               aligned_to(a.out, vec * (int)sizeof(OT));
    };
    if constexpr (sizeof(XT) == 2) {
        if (fits(8)) return launch_pair_sum<XT, OT, 8>(a, s);
    }
    if (fits(4)) return launch_pair_sum<XT, OT, 4>(a, s);
    if (fits(2)) return launch_pair_sum<XT, OT, 2>(a, s);
    return launch_pair_sum<XT, OT, 1>(a, s);
}

int pair_sum(const Csr& a, const Csr& b, const void* y, void* out, int B,
             int n_in, int n_out, int H, int y_is_bf16, int out_is_bf16,
             cudaStream_t s) {
    RowArgs r{};
    r.op[0] = RowOp{a.crow, a.col, a.val, 0};
    r.op[1] = RowOp{b.crow, b.col, b.val, H};
    r.x = y;
    r.out = out;
    r.B = B;
    r.n_out = n_out;
    r.F = H;
    r.x_ld = 2 * (long long)H;
    r.x_bs = (long long)n_in * 2 * H;
    r.o_ld = H;
    r.o_bs = (long long)n_out * H;
    if (y_is_bf16 && out_is_bf16)
        return pair_sum_vec<__nv_bfloat16, __nv_bfloat16>(r, s);
    if (y_is_bf16) return pair_sum_vec<__nv_bfloat16, float>(r, s);
    if (out_is_bf16) return pair_sum_vec<float, __nv_bfloat16>(r, s);
    return pair_sum_vec<float, float>(r, s);
}

template <int VEC, typename XT, typename OT>
void launch_pair_transpose(const Csr& a, const Csr& b, const void* x,
                           void* out, int B, int n_in, int n_out, int H,
                           cudaStream_t s) {
    dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
    dim3 block(kWarpsPerBlock * 32);
    pair_transpose_kernel<VEC, XT, OT><<<grid, block, 0, s>>>(
        a.crow, a.col, a.val, b.crow, b.col, b.val,
        static_cast<const XT*>(x), static_cast<OT*>(out), n_in, n_out, H);
}

template <int VEC>
int pair_transpose_types(const Csr& a, const Csr& b, const void* x,
                         void* out, int B, int n_in, int n_out, int H,
                         int x_is_bf16, int out_is_bf16, cudaStream_t s) {
    if (x_is_bf16 && out_is_bf16) {
        launch_pair_transpose<VEC, __nv_bfloat16, __nv_bfloat16>(
            a, b, x, out, B, n_in, n_out, H, s);
    } else if (x_is_bf16) {
        launch_pair_transpose<VEC, __nv_bfloat16, float>(a, b, x, out, B,
                                                         n_in, n_out, H, s);
    } else if (out_is_bf16) {
        launch_pair_transpose<VEC, float, __nv_bfloat16>(a, b, x, out, B,
                                                         n_in, n_out, H, s);
    } else {
        launch_pair_transpose<VEC, float, float>(a, b, x, out, B, n_in,
                                                 n_out, H, s);
    }
    return (int)cudaGetLastError();
}

template <bool TRANSPOSE>
int dispatch(const void* a_crow, const void* a_col, const void* a_val,
             const void* b_crow, const void* b_col, const void* b_val,
             const void* x, void* out, int B, int n_in, int n_out, int H,
             int x_is_bf16, int out_is_bf16, void* stream) {
    if (H < 1 || B < 1 || B > 65535 || n_out < 0 || n_in < 0)
        return (int)cudaErrorInvalidValue;
    if (n_out == 0) return (int)cudaSuccess;
    Csr a{static_cast<const int*>(a_crow), static_cast<const int*>(a_col),
          static_cast<const float*>(a_val)};
    Csr b{static_cast<const int*>(b_crow), static_cast<const int*>(b_col),
          static_cast<const float*>(b_val)};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (!TRANSPOSE)
        return pair_sum(a, b, x, out, B, n_in, n_out, H, x_is_bf16,
                        out_is_bf16, s);
    if (H % 128 == 0)
        return pair_transpose_types<4>(a, b, x, out, B, n_in, n_out, H,
                                       x_is_bf16, out_is_bf16, s);
    if (H % 64 == 0)
        return pair_transpose_types<2>(a, b, x, out, B, n_in, n_out, H,
                                       x_is_bf16, out_is_bf16, s);
    return pair_transpose_types<1>(a, b, x, out, B, n_in, n_out, H,
                                   x_is_bf16, out_is_bf16, s);
}

}  // namespace

// K8: y [B, n_in, 2H] (bf16 or f32) -> out [B, n_out, H] (bf16 or f32)
extern "C" int gfvgn_pair_sum(const void* a_crow, const void* a_col,
                              const void* a_val, const void* b_crow,
                              const void* b_col, const void* b_val,
                              const void* y, void* out, int B, int n_in,
                              int n_out, int H, int y_is_bf16,
                              int out_is_bf16, void* stream) {
    return dispatch<false>(a_crow, a_col, a_val, b_crow, b_col, b_val, y, out,
                           B, n_in, n_out, H, y_is_bf16, out_is_bf16, stream);
}

// K9: g [B, n_in, H] (bf16 or f32) -> out [B, n_out, 2H] (bf16 or f32)
extern "C" int gfvgn_pair_transpose(const void* a_crow, const void* a_col,
                                    const void* a_val, const void* b_crow,
                                    const void* b_col, const void* b_val,
                                    const void* g, void* out, int B,
                                    int n_in, int n_out, int H, int g_is_bf16,
                                    int out_is_bf16, void* stream) {
    return dispatch<true>(a_crow, a_col, a_val, b_crow, b_col, b_val, g, out,
                          B, n_in, n_out, H, g_is_bf16, out_is_bf16, stream);
}
