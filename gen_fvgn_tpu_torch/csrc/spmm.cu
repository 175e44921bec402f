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
// Design, for that bound (the row machinery, csr_row in spmm_rows.cuh,
// is shared with K8):
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

#include "spmm_rows.cuh"

namespace {

// a warp a row (spmm_rows.cuh); IPL: 16-byte vectors a lane owns
template <typename XT, typename OT, int IPL>
__global__ void __launch_bounds__(kRowWarps * 32)
spmm_csr_kernel(RowArgs a) {
    const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
    if (row >= a.n_out) return;
    int start[1], len[1];
    const int total = row_extents<1>(a, row, start, len);
    csr_row<XT, OT, 16 / sizeof(XT), IPL, 1>(a, row, start, len, total);
}

template <typename XT, typename OT>
int launch(const RowArgs& a, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(XT);
    const int ipl = row_ipl(a.B, a.F, VEC);
    const dim3 grid((a.n_out + kRowWarps - 1) / kRowWarps),
        block(kRowWarps * 32);
    if (ipl == 4)
        spmm_csr_kernel<XT, OT, 4><<<grid, block, 0, s>>>(a);
    else if (ipl == 2)
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
    RowArgs a{};
    a.op[0] = RowOp{static_cast<const int*>(crow),
                    static_cast<const int*>(col),
                    static_cast<const float*>(val), 0};
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
