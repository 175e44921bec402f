// K1: batched CSR sparse apply  out[b] = A * x[b]  for sm_90a.
//
// Replaces the Pallas TPU kernels of gen_fvgn_tpu/ops/pallas_spmm.py
// (pallas_block_spmm_window and its three grid variants), which stream
// 256x256 dense operator tiles through the matrix unit. Here the operator is
// CSR and the work is a gather-accumulate.
//
// What bounds it on the H100: bytes. The operators carry a few to a few tens
// of non-zeros a row; each operand row is read once if the gathered rows stay
// in L2 (the mesh is RCM-ordered), the output is written once, and the
// float32 FMA count (2 * nnz * B * F) is far below the card's rate.
//
// Design, for that bound:
//   * A warp owns an output row for ALL B batch lanes. It loads the row's
//     col/val once, lane-parallel (up to 32 non-zeros in one coalesced load),
//     and broadcasts them with __shfl_sync, so no operand load waits on an
//     index load and the indices are read once per row, not once per lane.
//   * The row's B x F outputs are cut into 16-byte vectors (8 bf16 or 4
//     float32); lane l owns vectors l, l + 32, ... (IPL of them; with F = 128
//     bf16 and B = 8 each half-warp reads 256 contiguous bytes of one batch
//     lane). Non-zeros are unrolled so that a lane issues IPL * U = 8
//     independent 16-byte loads before its first FMA.
//   * The non-zeros are summed in ascending order into float32 accumulators
//     (explicit fmaf), so two runs give the same bits; rows without non-zeros
//     (the padding) come out exactly zero. Stores are whole 16-byte vectors.
//   * A column window: the operand and the output are given by pointer, row
//     stride and batch stride, so the kernel reads and writes F columns of
//     wider tensors (the composed node aggregation's two halves, half the
//     bytes of the full-width applies). F is any multiple of 64; every
//     pointer and stride is 16-byte aligned.
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;      // rows (warps) a block

struct SpmmArgs {
    const int* crow;
    const int* col;
    const float* val;
    const void* x;             // operand window: row stride x_ld, batch x_bs
    void* out;                 // output window: row stride o_ld, batch o_bs
    int B, n_out, F;
    long long x_ld, x_bs, o_ld, o_bs;   // in elements
};

__device__ __forceinline__ void unpack(const uint4& r, float v[8],
                                       const __nv_bfloat16*) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void unpack(const uint4& r, float v[4],
                                       const float*) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float v[VEC]) {
    static_assert(VEC == 8, "bf16 output takes a bf16 operand");
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float v[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(p + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// IPL: 16-byte vectors a lane owns; U: non-zeros unrolled (IPL * U loads in
// flight a lane)
template <typename XT, typename OT, int IPL>
__global__ void __launch_bounds__(kWarps * 32)
spmm_csr_kernel(SpmmArgs a) {
    constexpr int VEC = 16 / sizeof(XT);
    constexpr int U = 8 / IPL;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= a.n_out) return;
    const XT* __restrict__ x = static_cast<const XT*>(a.x);
    OT* __restrict__ out = static_cast<OT*>(a.out);
    const int start = a.crow[row], end = a.crow[row + 1];
    const int cpr = a.F / VEC, items = a.B * cpr;
    for (int base = 0; base < items; base += 32 * IPL) {
        long long xo[IPL], oo[IPL];
        bool ok[IPL];
        float acc[IPL][VEC];
#pragma unroll
        for (int k = 0; k < IPL; ++k) {
            const int it = base + lane + 32 * k;
            ok[k] = it < items;
            const int b = ok[k] ? it / cpr : 0, c = it - b * cpr;
            xo[k] = b * a.x_bs + (long long)c * VEC;
            oo[k] = b * a.o_bs + row * a.o_ld + (long long)c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[k][e] = 0.0f;
        }
        for (int j0 = start; j0 < end; j0 += 32) {
            const int nj = min(32, end - j0);
            int cl = 0;
            float vl = 0.0f;
            if (lane < nj) {
                cl = a.col[j0 + lane];
                vl = a.val[j0 + lane];
            }
            int j = 0;
            for (; j + U <= nj; j += U) {
                uint4 raw[U][IPL];
                float w[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const long long c = __shfl_sync(0xffffffffu, cl, j + u);
                    w[u] = __shfl_sync(0xffffffffu, vl, j + u);
#pragma unroll
                    for (int k = 0; k < IPL; ++k)
                        raw[u][k] = ok[k]
                            ? __ldg(reinterpret_cast<const uint4*>(
                                  x + c * a.x_ld + xo[k]))
                            : make_uint4(0u, 0u, 0u, 0u);
                }
#pragma unroll
                for (int u = 0; u < U; ++u)
#pragma unroll
                    for (int k = 0; k < IPL; ++k) {
                        float v[VEC];
                        unpack(raw[u][k], v, x);
#pragma unroll
                        for (int e = 0; e < VEC; ++e)
                            acc[k][e] = fmaf(w[u], v[e], acc[k][e]);
                    }
            }
            for (; j < nj; ++j) {
                const long long c = __shfl_sync(0xffffffffu, cl, j);
                const float w = __shfl_sync(0xffffffffu, vl, j);
#pragma unroll
                for (int k = 0; k < IPL; ++k) {
                    if (!ok[k]) continue;
                    float v[VEC];
                    unpack(__ldg(reinterpret_cast<const uint4*>(
                               x + c * a.x_ld + xo[k])), v, x);
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[k][e] = fmaf(w, v[e], acc[k][e]);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < IPL; ++k)
            if (ok[k]) store_vec<VEC>(out + oo[k], acc[k]);
    }
}

template <typename XT, typename OT>
int launch(const SpmmArgs& a, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(XT);
    const int per_lane = (a.B * (a.F / VEC) + 31) / 32;
    const dim3 grid((a.n_out + kWarps - 1) / kWarps), block(kWarps * 32);
    if (per_lane >= 4)
        spmm_csr_kernel<XT, OT, 4><<<grid, block, 0, s>>>(a);
    else if (per_lane >= 2)
        spmm_csr_kernel<XT, OT, 2><<<grid, block, 0, s>>>(a);
    else
        spmm_csr_kernel<XT, OT, 1><<<grid, block, 0, s>>>(a);
    return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// out[b, r, 0:F] = sum_j val[j] * x[b, col[j], 0:F] over row r's non-zeros,
// for windows given by pointer, row stride and batch stride (elements).
// F % 64 == 0; pointers and strides 16-byte aligned.
extern "C" int gfvgn_spmm_csr(const void* crow, const void* col,
                              const void* val, const void* x, void* out,
                              int B, int n_in, int n_out, int F,
                              long long x_ld, long long x_bs, long long o_ld,
                              long long o_bs, int x_is_bf16, int out_is_bf16,
                              void* stream) {
    const int sx = x_is_bf16 ? 2 : 4, so = out_is_bf16 ? 2 : 4;
    if (F < 64 || F % 64 != 0 || B < 1 || n_in < 0 || n_out < 0 ||
        x_ld < F || o_ld < F || (out_is_bf16 && !x_is_bf16) ||
        !aligned16(x) || !aligned16(out) || (x_ld * sx) % 16 != 0 ||
        (x_bs * sx) % 16 != 0 || (o_ld * so) % 16 != 0 ||
        (o_bs * so) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    if (n_out == 0) return 0;
    SpmmArgs a;
    a.crow = static_cast<const int*>(crow);
    a.col = static_cast<const int*>(col);
    a.val = static_cast<const float*>(val);
    a.x = x;
    a.out = out;
    a.B = B;
    a.n_out = n_out;
    a.F = F;
    a.x_ld = x_ld;
    a.x_bs = x_bs;
    a.o_ld = o_ld;
    a.o_bs = o_bs;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (x_is_bf16 && out_is_bf16)
        return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
    if (x_is_bf16) return launch<__nv_bfloat16, float>(a, s);
    return launch<float, float>(a, s);
}
