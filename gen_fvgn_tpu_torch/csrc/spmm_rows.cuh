// The row machinery of the CSR sparse applies K1 (spmm.cu) and K8
// (pair_spmm.cu): a warp owns an output row for ALL batch lanes.
//
//   * The row's indices and values are loaded once, lane-parallel (up to 32
//     non-zeros in one coalesced load), and broadcast with __shfl_sync, so
//     no operand load waits on an index load and the indices are read once
//     per row, not once per batch lane. A row may be the concatenation of
//     NOPS operators' rows (K8: A's non-zeros, then B's, each operator
//     reading its own column offset of the operand): one index list, so
//     the operand loads of both operators are in flight together.
//   * The row's B x F outputs are cut into vectors of VEC elements (16
//     bytes of the operand where the widths and addresses allow it, else 8,
//     4 or 2); lane l owns vectors l, l + 32, ... (IPL of them). Non-zeros
//     are unrolled so that a lane has IPL * U = 8 independent loads in
//     flight before its first FMA.
//   * The non-zeros are summed in ascending order (operator by operator)
//     into float32 accumulators (explicit fmaf), so two runs give the same
//     bits; rows without non-zeros come out exactly zero. Each vector is
//     stored whole.
//   * Two forms of a row over two operators: a sum (K8: both operators'
//     products into one accumulator, each operator reading its own column
//     offset of the operand) and a split (K9: each operator's products into
//     its own accumulators, rounded once and stored at its own column
//     offset of the output row, both reading the operand from column 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kRowWarps = 8;       // rows (warps) a block

// One operator of a row: CSR arrays, the column offset (elements) at which
// it reads the operand in a sum (0 for a sum over one operator) and the one
// at which it writes the output row in a split.
struct RowOp {
    const int* crow;
    const int* col;
    const float* val;
    int x_off;
    int o_off;
};

// A row sum over NOPS operators: out[b, r, 0:F] = sum over the operators,
// in order, of sum_j val[j] * x[b, col[j], x_off + 0:F], for windows given
// by pointer, row stride and batch stride (elements).
struct RowArgs {
    RowOp op[2];
    const void* x;
    void* out;
    int B, n_out, F;
    long long x_ld, x_bs, o_ld, o_bs;
};

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { typedef uint4 T; };
template <> struct RawOf<8> { typedef uint2 T; };
template <> struct RawOf<4> { typedef unsigned int T; };
template <> struct RawOf<2> { typedef unsigned short T; };

// VEC elements of T as one load
template <typename T, int VEC>
using Raw = typename RawOf<VEC * (int)sizeof(T)>::T;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p) {
    return __ldg(reinterpret_cast<const Raw<T, VEC>*>(p));
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r, float v[VEC]) {
    if constexpr (std::is_same<T, float>::value) {
        const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = f[e];
    } else if constexpr (VEC == 1) {
        v[0] = __bfloat162float(__ushort_as_bfloat16(r));
    } else {
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&r);
#pragma unroll
        for (int i = 0; i < VEC / 2; ++i) {
            const float2 f = bf16x2_to_float2(w[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&h);
}

// CS: a 16-byte vector is stored with the streaming hint (st.global.cs),
// so that an output written once does not push the operand rows that other
// warps still gather out of L2
template <int VEC, bool CS = false>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float v[VEC]) {
    if constexpr (VEC == 8) {
        const uint4 w =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
        if constexpr (CS) __stcs(reinterpret_cast<uint4*>(p), w);
        else *reinterpret_cast<uint4*>(p) = w;
    } else if constexpr (VEC == 4) {
        *reinterpret_cast<uint2*>(p) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(v[0], v[1]);
    } else {
        *p = __float2bfloat16_rn(v[0]);
    }
}

template <int VEC, bool CS = false>
__device__ __forceinline__ void store_vec(float* p, const float v[VEC]) {
    if constexpr (VEC >= 4) {
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
            const float4 w = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
            if constexpr (CS) __stcs(reinterpret_cast<float4*>(p + i), w);
            else *reinterpret_cast<float4*>(p + i) = w;
        }
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        *p = v[0];
    }
}

// the extents of row `row` in each operator, and their total
template <int NOPS>
__device__ __forceinline__ int row_extents(const RowArgs& a, int row,
                                           int start[NOPS], int len[NOPS]) {
    int total = 0;
#pragma unroll
    for (int o = 0; o < NOPS; ++o) {
        start[o] = a.op[o].crow[row];
        len[o] = a.op[o].crow[row + 1] - start[o];
        total += len[o];
    }
    return total;
}

// this lane's non-zero of the row's index chunk j0 .. j0 + nj: its operand
// row cl, the column offset ol of its operator, its value vl; zeros past
// nj. One operator: j0 is the position in col/val; two: the position in
// the operators' lists one after the other (A's, then B's).
template <int NOPS>
__device__ __forceinline__ void lane_index(const RowArgs& a,
                                           const int start[NOPS],
                                           const int len[NOPS], int j0,
                                           int nj, int& cl, int& ol,
                                           float& vl) {
    const int lane = threadIdx.x & 31;
    cl = 0;
    ol = 0;
    vl = 0.0f;
    if (lane < nj) {
        if constexpr (NOPS == 1) {
            cl = a.op[0].col[j0 + lane];
            vl = a.op[0].val[j0 + lane];
        } else {
            int j = j0 + lane, s = start[0];
            const int* col = a.op[0].col;
            const float* val = a.op[0].val;
            ol = a.op[0].x_off;
            if (j >= len[0]) {
                j -= len[0];
                s = start[1];
                col = a.op[1].col;
                val = a.op[1].val;
                ol = a.op[1].x_off;
            }
            cl = col[s + j];
            vl = val[s + j];
        }
    }
}

// acc += the chunk's nj non-zeros (lane j's index in cl, ol, vl), in
// order, U at a time: IPL * U independent loads in flight a lane
template <typename XT, int VEC, int IPL, int NOPS>
__device__ __forceinline__ void chunk_sum(const RowArgs& a, int cl, int ol,
                                          float vl, int nj,
                                          const long long xo[IPL],
                                          const bool ok[IPL],
                                          float acc[IPL][VEC]) {
    constexpr int U = 8 / IPL;
    const XT* __restrict__ x = static_cast<const XT*>(a.x);
    // the operand row of lane jj's non-zero, and where this lane's vector
    // k of it starts (a single operator reads from the first column)
    auto row_of = [&](int jj) -> long long {
        return __shfl_sync(0xffffffffu, cl, jj);
    };
    auto off_of = [&](int jj) -> int {
        if constexpr (NOPS > 1) return __shfl_sync(0xffffffffu, ol, jj);
        else return 0;
    };
    int j = 0;
    for (; j + U <= nj; j += U) {
        Raw<XT, VEC> raw[U][IPL];
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long c = row_of(j + u);
            const int o = off_of(j + u);
            w[u] = __shfl_sync(0xffffffffu, vl, j + u);
#pragma unroll
            for (int k = 0; k < IPL; ++k)
                raw[u][k] = ok[k]
                    ? load_raw<XT, VEC>(x + c * a.x_ld + o + xo[k])
                    : Raw<XT, VEC>{};
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int k = 0; k < IPL; ++k) {
                float v[VEC];
                unpack<XT, VEC>(raw[u][k], v);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[k][e] = fmaf(w[u], v[e], acc[k][e]);
            }
    }
    for (; j < nj; ++j) {
        const long long c = row_of(j);
        const int o = off_of(j);
        const float w = __shfl_sync(0xffffffffu, vl, j);
#pragma unroll
        for (int k = 0; k < IPL; ++k) {
            if (!ok[k]) continue;
            float v[VEC];
            unpack<XT, VEC>(load_raw<XT, VEC>(x + c * a.x_ld + o + xo[k]), v);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
                acc[k][e] = fmaf(w, v[e], acc[k][e]);
        }
    }
}

// The warp's output row `row` (all batch lanes): IPL vectors of VEC
// elements a lane. AHEAD (csr_rows_ahead): `first` holds the lane's index
// of the row's first chunk (cl, ol, vl's bits), loaded ahead by the
// caller, and 16-byte vectors are stored with the streaming hint.
template <typename XT, typename OT, int VEC, int IPL, int NOPS,
          bool AHEAD = false>
__device__ __forceinline__ void csr_row(const RowArgs& a, int row,
                                        const int start[NOPS],
                                        const int len[NOPS], int total,
                                        const int first[3] = nullptr) {
    const int lane = threadIdx.x & 31;
    OT* __restrict__ out = static_cast<OT*>(a.out);
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
        // positions of the row's non-zeros (NOPS == 1: in col/val)
        const int jb = NOPS == 1 ? start[0] : 0, je = jb + total;
        for (int j0 = jb; j0 < je; j0 += 32) {
            const int nj = min(32, je - j0);
            int cl, ol;
            float vl;
            if (AHEAD && j0 == jb) {
                cl = first[0];
                ol = first[1];
                vl = __int_as_float(first[2]);
            } else {
                lane_index<NOPS>(a, start, len, j0, nj, cl, ol, vl);
            }
            chunk_sum<XT, VEC, IPL, NOPS>(a, cl, ol, vl, nj, xo, ok, acc);
        }
#pragma unroll
        for (int k = 0; k < IPL; ++k)
            if (ok[k]) store_vec<VEC, AHEAD>(out + oo[k], acc[k]);
    }
}

// acc += the chunk's non-zeros j0 .. j1 (lane j's index in cl, vl), in
// order, U at a time, the last group masked: one operator's share of a
// chunk in the split form (K9), so that its FMAs have one fixed target
template <typename XT, int VEC, int IPL>
__device__ __forceinline__ void group_sum(const RowArgs& a, int cl, float vl,
                                          int j0, int j1,
                                          const long long xo[IPL],
                                          const bool ok[IPL],
                                          float acc[IPL][VEC]) {
    constexpr int U = 8 / IPL;
    const XT* __restrict__ x = static_cast<const XT*>(a.x);
    for (int j = j0; j < j1; j += U) {
        Raw<XT, VEC> raw[U][IPL];
        float w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const bool live = j + u < j1;
            const long long c = __shfl_sync(0xffffffffu, cl, (j + u) & 31);
            w[u] = __shfl_sync(0xffffffffu, vl, (j + u) & 31);
#pragma unroll
            for (int k = 0; k < IPL; ++k)
                raw[u][k] = live && ok[k]
                    ? load_raw<XT, VEC>(x + c * a.x_ld + xo[k])
                    : Raw<XT, VEC>{};
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (j + u >= j1) break;
#pragma unroll
            for (int k = 0; k < IPL; ++k) {
                float v[VEC];
                unpack<XT, VEC>(raw[u][k], v);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    acc[k][e] = fmaf(w[u], v[e], acc[k][e]);
            }
        }
    }
}

// The warp's output row `row` in the split form: [A row | B row] at the
// operators' output offsets, each half its own float32 sum rounded once.
// `first` as in csr_row (AHEAD: loaded by the caller, streaming stores).
template <typename XT, typename OT, int VEC, int IPL, bool AHEAD>
__device__ __forceinline__ void csr_row_split(const RowArgs& a, int row,
                                              const int start[2],
                                              const int len[2], int total,
                                              const int first[3]) {
    const int lane = threadIdx.x & 31;
    OT* __restrict__ out = static_cast<OT*>(a.out);
    const int cpr = a.F / VEC, items = a.B * cpr;
    for (int base = 0; base < items; base += 32 * IPL) {
        long long xo[IPL], oo[IPL];
        bool ok[IPL];
        float acc[2][IPL][VEC];
#pragma unroll
        for (int k = 0; k < IPL; ++k) {
            const int it = base + lane + 32 * k;
            ok[k] = it < items;
            const int b = ok[k] ? it / cpr : 0, c = it - b * cpr;
            xo[k] = b * a.x_bs + (long long)c * VEC;
            oo[k] = b * a.o_bs + row * a.o_ld + (long long)c * VEC;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[0][k][e] = acc[1][k][e] = 0.0f;
        }
        for (int j0 = 0; j0 < total; j0 += 32) {
            const int nj = min(32, total - j0);
            int cl, ol;
            float vl;
            if (AHEAD && j0 == 0) {
                cl = first[0];
                vl = __int_as_float(first[2]);
            } else {
                lane_index<2>(a, start, len, j0, nj, cl, ol, vl);
            }
            // lanes below sp hold A's non-zeros, the rest B's
            const int sp = min(max(len[0] - j0, 0), nj);
            group_sum<XT, VEC, IPL>(a, cl, vl, 0, sp, xo, ok, acc[0]);
            group_sum<XT, VEC, IPL>(a, cl, vl, sp, nj, xo, ok, acc[1]);
        }
#pragma unroll
        for (int o = 0; o < 2; ++o)
#pragma unroll
            for (int k = 0; k < IPL; ++k)
                if (ok[k])
                    store_vec<VEC, AHEAD>(out + oo[k] + a.op[o].o_off,
                                          acc[o][k]);
    }
}

// The warp's rows row, row + step, ... below end, each as csr_row (or,
// SPLIT, csr_row_split), with the index loads taken out of the rows'
// latency chain: while a row's operand loads are in flight, the next row's
// first index chunk and the extents of the row after it are already being
// loaded.
template <typename XT, typename OT, int VEC, int IPL, int NOPS,
          bool SPLIT = false>
__device__ __forceinline__ void csr_rows_ahead(const RowArgs& a, int row,
                                               int step, int end) {
    if (row >= end) return;
    int st[NOPS], ln[NOPS], st1[NOPS], ln1[NOPS];
    int tot = row_extents<NOPS>(a, row, st, ln), tot1 = 0;
    int cur[3];
    float v0;
    lane_index<NOPS>(a, st, ln, NOPS == 1 ? st[0] : 0, min(32, tot), cur[0],
                     cur[1], v0);
    cur[2] = __float_as_int(v0);
    if (row + step < end)
        tot1 = row_extents<NOPS>(a, row + step, st1, ln1);
    for (; row < end; row += step) {
        const int r1 = row + step, r2 = row + 2 * step;
        int nxt[3] = {0, 0, 0};
        if (r1 < end) {
            float v1;
            lane_index<NOPS>(a, st1, ln1, NOPS == 1 ? st1[0] : 0,
                             min(32, tot1), nxt[0], nxt[1], v1);
            nxt[2] = __float_as_int(v1);
        }
        int st2[NOPS], ln2[NOPS], tot2 = 0;
        if (r2 < end) tot2 = row_extents<NOPS>(a, r2, st2, ln2);
        if constexpr (SPLIT)
            csr_row_split<XT, OT, VEC, IPL, true>(a, row, st, ln, tot, cur);
        else
            csr_row<XT, OT, VEC, IPL, NOPS, true>(a, row, st, ln, tot, cur);
#pragma unroll
        for (int o = 0; o < NOPS; ++o) {
            st[o] = st1[o];
            ln[o] = ln1[o];
            st1[o] = r2 < end ? st2[o] : 0;
            ln1[o] = r2 < end ? ln2[o] : 0;
        }
        tot = tot1;
        tot1 = tot2;
#pragma unroll
        for (int i = 0; i < 3; ++i) cur[i] = nxt[i];
    }
}

// vectors a lane owns for B x F outputs of VEC elements: 4, 2 or 1
inline int row_ipl(int B, int F, int vec) {
    const int per_lane = (B * (F / vec) + 31) / 32;
    return per_lane >= 4 ? 4 : per_lane >= 2 ? 2 : 1;
}

}  // namespace
