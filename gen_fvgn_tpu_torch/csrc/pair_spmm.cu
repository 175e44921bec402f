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
// K9 (pair_transpose_kernel) is the same row machinery in its split form
// (csr_row_split): a warp owns an output row [A row | B row] for all B
// batch lanes; A's and B's indices are loaded once as one list and
// broadcast, both operators read g[b] from column 0, and each operator's
// products go into ITS OWN float32 accumulators, rounded once and stored
// at its own half of the output row (RowOp::o_off = 0 and H). Each
// operator's share of a row goes in groups of up to eight loads a lane
// (the last group masked); the warps are persistent with the next row's
// indices loaded ahead (csr_rows_ahead), and the written-once output is
// streamed past L2. Vectors of 16 bytes where H and the addresses allow
// it, else 8, 4 or 2 bytes. At the paired path's shapes (four non-zeros a
// row in each operator) it takes 0.042 ms against its byte bound of 0.016
// on the H100, and about as long on random columns or with every row
// reading the same eight rows of g (tools/pair_probe.py): neither L2
// bandwidth nor g's locality bounds it, but a warp's row waiting on its
// two groups of loads in turn, at 16 warps an SM (the registers of two
// accumulator sets).
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
        gridDim.x * kRowWarps, a.n_out);
}

// K9: g [B, n_in, H] -> out [B, n_out, 2H], the split form; registers
// capped as K8's (its two accumulator sets at IPL 2 are K8's one at IPL
// 4). A block walks one contiguous range of rows, its warps on
// neighbouring rows, so each warp's rows lie together in crow, col and
// val: 0.042 ms at the paired path's shapes against 0.045 in K8's order
// (rows warp, warp + all warps, ...) on the H100.
template <typename XT, typename OT, int VEC, int IPL>
__global__ void __launch_bounds__(kRowWarps * 32, 2)
pair_transpose_kernel(RowArgs a) {
    const int per = (a.n_out + gridDim.x - 1) / gridDim.x;
    const int r0 = blockIdx.x * per;
    csr_rows_ahead<XT, OT, VEC, IPL, 2, true>(
        a, r0 + (threadIdx.x >> 5), kRowWarps, min(a.n_out, r0 + per));
}

// as many blocks as are resident on the card at once, at most a row a warp
template <bool TRANSPOSE, typename XT, typename OT, int VEC, int IPL>
int launch_pair_rows(const RowArgs& a, cudaStream_t s) {
    static int per_sm = 0;       // blocks of this kernel an SM holds
    void (*kernel)(RowArgs);
    if constexpr (TRANSPOSE) kernel = pair_transpose_kernel<XT, OT, VEC, IPL>;
    else kernel = pair_sum_kernel<XT, OT, VEC, IPL>;
    int dev = 0, n_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && per_sm == 0)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kRowWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    const int rows = (a.n_out + kRowWarps - 1) / kRowWarps;
    const int resident = n_sm * (per_sm > 0 ? per_sm : 1);
    kernel<<<rows < resident ? rows : resident, kRowWarps * 32, 0, s>>>(a);
    return (int)cudaGetLastError();
}

// K9 keeps two accumulator sets: at most 2 vectors a lane (4 spilled at 16
// bytes under the cap of 128 registers), more items walking the row again
template <bool TRANSPOSE, typename XT, typename OT, int VEC>
int launch_pair(const RowArgs& a, cudaStream_t s) {
    const int ipl = row_ipl(a.B, a.F, VEC);
    if constexpr (!TRANSPOSE) {
        if (ipl == 4) return launch_pair_rows<false, XT, OT, VEC, 4>(a, s);
    }
    if (ipl == 2) return launch_pair_rows<TRANSPOSE, XT, OT, VEC, 2>(a, s);
    return launch_pair_rows<TRANSPOSE, XT, OT, VEC, 1>(a, s);
}

bool aligned_to(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

// the widest vector (at most 16 bytes of the operand) that the width F and
// the operand's and the output's addresses allow
template <bool TRANSPOSE, typename XT, typename OT>
int pair_vec(const RowArgs& a, cudaStream_t s) {
    auto fits = [&](int vec) {
        return a.F % vec == 0 && aligned_to(a.x, vec * (int)sizeof(XT)) &&
               aligned_to(a.out, vec * (int)sizeof(OT));
    };
    if constexpr (sizeof(XT) == 2) {
        if (fits(8)) return launch_pair<TRANSPOSE, XT, OT, 8>(a, s);
    }
    if (fits(4)) return launch_pair<TRANSPOSE, XT, OT, 4>(a, s);
    if (fits(2)) return launch_pair<TRANSPOSE, XT, OT, 2>(a, s);
    return launch_pair<TRANSPOSE, XT, OT, 1>(a, s);
}

template <bool TRANSPOSE>
int pair_types(const RowArgs& r, int x_is_bf16, int out_is_bf16,
               cudaStream_t s) {
    if (x_is_bf16 && out_is_bf16)
        return pair_vec<TRANSPOSE, __nv_bfloat16, __nv_bfloat16>(r, s);
    if (x_is_bf16) return pair_vec<TRANSPOSE, __nv_bfloat16, float>(r, s);
    if (out_is_bf16) return pair_vec<TRANSPOSE, float, __nv_bfloat16>(r, s);
    return pair_vec<TRANSPOSE, float, float>(r, s);
}

// K8 (TRANSPOSE false): A's row and B's row summed, B reading the operand
// [B, n_in, 2H] at column H, into out [B, n_out, H]; K9: each operator
// into its own half of out [B, n_out, 2H] from g [B, n_in, H]
template <bool TRANSPOSE>
int dispatch(const void* a_crow, const void* a_col, const void* a_val,
             const void* b_crow, const void* b_col, const void* b_val,
             const void* x, void* out, int B, int n_in, int n_out, int H,
             int x_is_bf16, int out_is_bf16, void* stream) {
    if (H < 1 || B < 1 || B > 65535 || n_out < 0 || n_in < 0)
        return (int)cudaErrorInvalidValue;
    if (n_out == 0) return (int)cudaSuccess;
    RowArgs r{};
    r.op[0] = RowOp{static_cast<const int*>(a_crow),
                    static_cast<const int*>(a_col),
                    static_cast<const float*>(a_val), 0, 0};
    r.op[1] = RowOp{static_cast<const int*>(b_crow),
                    static_cast<const int*>(b_col),
                    static_cast<const float*>(b_val), TRANSPOSE ? 0 : H,
                    TRANSPOSE ? H : 0};
    r.x = x;
    r.out = out;
    r.B = B;
    r.n_out = n_out;
    r.F = H;
    r.x_ld = (TRANSPOSE ? 1 : 2) * (long long)H;
    r.x_bs = (long long)n_in * r.x_ld;
    r.o_ld = (TRANSPOSE ? 2 : 1) * (long long)H;
    r.o_bs = (long long)n_out * r.o_ld;
    return pair_types<TRANSPOSE>(r, x_is_bf16, out_is_bf16,
                                 reinterpret_cast<cudaStream_t>(stream));
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
