// K2 / K4f: fused 2-hidden-layer GELU MLP chain, forward, for sm_90a.
//
//   LN = true  (K2, fused_mlp_ln):
//     out = LN(W3*gelu(W2*gelu(sum_i x_i*W1_i + pre + b1) + b2) + b3)*gamma + beta
//     with an optional residual epilogue (res_idx, res_dual)
//   LN = false (K4f, fused_mlp_noln):
//     out = W3*gelu(W2*gelu(x*W1 + b1) + b2) + b3, d_out <= 16 real columns
//
// Replaces the Pallas TPU kernels _make_fwd_kernel and _noln_fwd_kernel of
// gen_fvgn_tpu/ops/fused_mlp.py. Rows are independent. A block stages W1 (up
// to 256x128), W2 and W3 in shared memory as bf16 once and then walks over
// 64-row tiles (grid = min(tiles, SMs)). Each product runs on the tensor
// cores through wmma (bf16 operands, float32 accumulators); accumulators are
// staged through shared memory for the elementwise steps, so h1, h2 and y
// never reach device memory. The ragged last tile is masked, not padded.
//
// Rounding points (the same as the TPU kernel's): float32 accumulation in
// each product; h1, h2 rounded to bf16 before the next product; biases, pre,
// GELU (tanh form) and LayerNorm statistics (fast variance clamped at 0,
// eps 1e-6) in float32; out rounded to bf16 before the residual add, which
// is a bf16 add.
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int H = 128;        // hidden width = part width = LayerNorm width
constexpr int TM = 64;        // rows per tile
constexpr int THREADS = 256;  // 8 warps: 4 row blocks x 2 column halves
constexpr int LDW = H + 8;    // bf16 leading dim of the staged weights
constexpr int LDH = H + 8;    // bf16 leading dim of the h1/h2 buffer
constexpr int LDC = H + 4;    // f32 leading dim of the accumulator staging
constexpr float kLnEps = 1e-6f;

struct Params {
    const bf16* part[2];
    int width[2];       // part widths, multiples of 16, each <= H
    int n_parts;
    const bf16* w1;     // [width[0]+width[1], H]
    const bf16* pre;    // [M, H] or null
    const float* b1;
    const bf16* w2;     // [H, H]
    const float* b2;
    const bf16* w3;     // [H, d_out]
    const float* b3;
    const float* gamma;
    const float* beta;
    bf16* out0;
    bf16* out1;
    int M;
    int res_idx;        // -1: no residual
    int res_dual;
    int d_out;
};

__device__ __forceinline__ float gelu_tanh(float x) {
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(u));
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// C[16 x NT*16] (this warp's strip) = A[16 x K] * B[K x NT*16]; result to sC.
template <int NT>
__device__ __forceinline__ void warp_gemm(const bf16* sA, int lda,
                                          const bf16* sB, int K,
                                          float* sC, int rb, int c0) {
    FragC acc[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
        FragA a;
        wmma::load_matrix_sync(a, sA + rb * 16 * lda + k0, lda);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            FragB b;
            wmma::load_matrix_sync(b, sB + k0 * LDW + c0 + t * 16, LDW);
            wmma::mma_sync(acc[t], a, b, acc[t]);
        }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
        wmma::store_matrix_sync(sC + rb * 16 * LDC + c0 + t * 16, acc[t], LDC,
                                wmma::mem_row_major);
}

__device__ __forceinline__ void store_bf16x4(bf16* p, const float v[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void load_bf16x4(const bf16* p, float v[4]) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 fa = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

// h = gelu(acc + bias (+ pre)) rounded to bf16 into sH. `acc` may be absent
// (the pres-only form has no first product).
__device__ __forceinline__ void hidden_epilogue(const float* sC, bool has_acc,
                                                const float* bias,
                                                const bf16* pre, int r0, int M,
                                                bf16* sH) {
    for (int idx = threadIdx.x; idx < TM * 32; idx += THREADS) {
        const int row = idx >> 5;
        const int c4 = (idx & 31) * 4;
        const int g = r0 + row;
        float v[4];
        const float4 bb = *reinterpret_cast<const float4*>(bias + c4);
        v[0] = bb.x; v[1] = bb.y; v[2] = bb.z; v[3] = bb.w;
        if (pre != nullptr && g < M) {
            float pv[4];
            load_bf16x4(pre + (size_t)g * H + c4, pv);
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += pv[i];
        }
        if (has_acc) {
#pragma unroll
            for (int i = 0; i < 4; ++i) v[i] += sC[row * LDC + c4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = gelu_tanh(v[i]);
        store_bf16x4(sH + row * LDH + c4, v);
    }
}

template <bool LN>
__global__ void __launch_bounds__(THREADS, 1) fused_mlp_kernel(Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int K1 = p.width[0] + p.width[1];
    const int LDX = K1 + 8;
    bf16* sW1 = reinterpret_cast<bf16*>(smem);
    bf16* sW2 = sW1 + (size_t)K1 * LDW;
    bf16* sW3 = sW2 + (size_t)H * LDW;
    bf16* sX = sW3 + (size_t)H * LDW;
    bf16* sH = sX + (size_t)(K1 > 0 ? TM * LDX : 0);
    float* sC = reinterpret_cast<float*>(sH + (size_t)TM * LDH);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int rb = warp >> 1;          // 16-row block of the tile
    const int c0 = (warp & 1) * 64;    // first column of this warp's strip

    // ---- stage the weights once per block ----
    for (int idx = threadIdx.x; idx < K1 * 16; idx += THREADS) {
        const int row = idx >> 4, ch = idx & 15;
        *reinterpret_cast<uint4*>(sW1 + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w1 + (size_t)row * H + ch * 8);
    }
    for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
        const int row = idx >> 4, ch = idx & 15;
        *reinterpret_cast<uint4*>(sW2 + row * LDW + ch * 8) =
            *reinterpret_cast<const uint4*>(p.w2 + (size_t)row * H + ch * 8);
    }
    if (LN) {
        for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
            const int row = idx >> 4, ch = idx & 15;
            *reinterpret_cast<uint4*>(sW3 + row * LDW + ch * 8) =
                *reinterpret_cast<const uint4*>(p.w3 + (size_t)row * H + ch * 8);
        }
    } else {
        // narrow head: d_out real columns, zero up to one 16-column tile
        for (int idx = threadIdx.x; idx < H * 16; idx += THREADS) {
            const int row = idx >> 4, c = idx & 15;
            sW3[row * LDW + c] = c < p.d_out
                ? p.w3[(size_t)row * p.d_out + c] : __float2bfloat16(0.0f);
        }
    }
    __syncthreads();

    const int n_tiles = (p.M + TM - 1) / TM;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * TM;

        // ---- input parts -> sX (rows past M read as zero) ----
        for (int pi = 0; pi < p.n_parts; ++pi) {
            const bf16* src = p.part[pi];
            const int w = p.width[pi];
            const int cpr = w >> 3;                  // 16-byte chunks a row
            const int off = pi == 0 ? 0 : p.width[0];
            for (int idx = threadIdx.x; idx < TM * cpr; idx += THREADS) {
                const int row = idx / cpr, ch = idx % cpr;
                const int g = r0 + row;
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (g < p.M)
                    v = *reinterpret_cast<const uint4*>(
                        src + (size_t)g * w + ch * 8);
                *reinterpret_cast<uint4*>(sX + row * LDX + off + ch * 8) = v;
            }
        }
        __syncthreads();

        // ---- layer 1 ----
        if (K1 > 0) {
            warp_gemm<4>(sX, LDX, sW1, K1, sC, rb, c0);
            __syncthreads();
        }
        hidden_epilogue(sC, K1 > 0, p.b1, p.pre, r0, p.M, sH);
        __syncthreads();

        // ---- layer 2 ----
        warp_gemm<4>(sH, LDH, sW2, H, sC, rb, c0);
        __syncthreads();
        hidden_epilogue(sC, true, p.b2, nullptr, r0, p.M, sH);
        __syncthreads();

        // ---- layer 3 + epilogue ----
        if (LN) {
            warp_gemm<4>(sH, LDH, sW3, H, sC, rb, c0);
            __syncthreads();
            const int c4 = lane * 4;
            const float4 b3 = *reinterpret_cast<const float4*>(p.b3 + c4);
            const float4 ga = *reinterpret_cast<const float4*>(p.gamma + c4);
            const float4 be = *reinterpret_cast<const float4*>(p.beta + c4);
            const float b3v[4] = {b3.x, b3.y, b3.z, b3.w};
            const float gav[4] = {ga.x, ga.y, ga.z, ga.w};
            const float bev[4] = {be.x, be.y, be.z, be.w};
            for (int row = warp; row < TM; row += THREADS / 32) {
                const int g = r0 + row;
                float y[4];
                float s = 0.0f, ss = 0.0f;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    y[i] = sC[row * LDC + c4 + i] + b3v[i];
                    s += y[i];
                    ss += y[i] * y[i];
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    s += __shfl_xor_sync(0xffffffffu, s, off);
                    ss += __shfl_xor_sync(0xffffffffu, ss, off);
                }
                const float mu = s * (1.0f / H);
                const float var = fmaxf(ss * (1.0f / H) - mu * mu, 0.0f);
                const float rstd = 1.0f / sqrtf(var + kLnEps);
                float o[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    o[i] = (y[i] - mu) * rstd * gav[i] + bev[i];
                    // round to bf16 BEFORE the residual add
                    o[i] = __bfloat162float(__float2bfloat16(o[i]));
                }
                if (g < p.M) {
                    if (p.res_idx < 0) {
                        store_bf16x4(p.out0 + (size_t)g * H + c4, o);
                    } else {
                        float r[4], sum[4];
                        const int roff = p.res_idx == 0 ? 0 : p.width[0];
                        load_bf16x4(sX + row * LDX + roff + c4, r);
#pragma unroll
                        for (int i = 0; i < 4; ++i) sum[i] = o[i] + r[i];
                        if (p.res_dual) {
                            store_bf16x4(p.out0 + (size_t)g * H + c4, o);
                            store_bf16x4(p.out1 + (size_t)g * H + c4, sum);
                        } else {
                            store_bf16x4(p.out0 + (size_t)g * H + c4, sum);
                        }
                    }
                }
            }
        } else {
            if ((warp & 1) == 0) warp_gemm<1>(sH, LDH, sW3, H, sC, rb, 0);
            __syncthreads();
            for (int idx = threadIdx.x; idx < TM * p.d_out; idx += THREADS) {
                const int row = idx / p.d_out, c = idx % p.d_out;
                const int g = r0 + row;
                if (g < p.M)
                    p.out0[(size_t)g * p.d_out + c] =
                        __float2bfloat16(sC[row * LDC + c] + p.b3[c]);
            }
        }
        __syncthreads();   // sX / sC are rewritten by the next tile
    }
}

size_t smem_bytes(int k1) {
    const size_t K1 = (size_t)k1;
    size_t bytes = (K1 + 2 * H) * LDW * sizeof(bf16);
    if (K1 > 0) bytes += (size_t)TM * (K1 + 8) * sizeof(bf16);
    bytes += (size_t)TM * LDH * sizeof(bf16);
    bytes += (size_t)TM * LDC * sizeof(float);
    return bytes;
}

}  // namespace

extern "C" int gfvgn_fused_mlp(const void* part0, const void* part1,
                               int width0, int width1,
                               const void* w1, const void* pre,
                               const void* b1, const void* w2, const void* b2,
                               const void* w3, const void* b3,
                               const void* gamma, const void* beta,
                               void* out0, void* out1, int M, int res_idx,
                               int res_dual, int layer_norm, int d_out,
                               int n_sm, void* stream) {
    // width1 > 0 needs width0 > 0; widths are multiples of 16 up to H
    const int n_parts = (width0 > 0) + (width1 > 0);
    if (width0 < 0 || width1 < 0 || width0 > H || width1 > H ||
        width0 % 16 != 0 || width1 % 16 != 0 || (width1 > 0 && width0 == 0) ||
        (n_parts == 0 && pre == nullptr) || res_idx >= n_parts || M < 0 ||
        n_sm < 1)
        return (int)cudaErrorInvalidValue;
    if (res_idx >= 0 && (res_idx == 0 ? width0 : width1) != H)
        return (int)cudaErrorInvalidValue;
    if (layer_norm ? (d_out != H) : (d_out < 1 || d_out > 16 || res_idx >= 0))
        return (int)cudaErrorInvalidValue;
    if (M == 0) return 0;
    Params p;
    p.part[0] = static_cast<const bf16*>(part0);
    p.part[1] = static_cast<const bf16*>(part1);
    p.width[0] = width0;
    p.width[1] = width1;
    p.n_parts = n_parts;
    p.w1 = static_cast<const bf16*>(w1);
    p.pre = static_cast<const bf16*>(pre);
    p.b1 = static_cast<const float*>(b1);
    p.w2 = static_cast<const bf16*>(w2);
    p.b2 = static_cast<const float*>(b2);
    p.w3 = static_cast<const bf16*>(w3);
    p.b3 = static_cast<const float*>(b3);
    p.gamma = static_cast<const float*>(gamma);
    p.beta = static_cast<const float*>(beta);
    p.out0 = static_cast<bf16*>(out0);
    p.out1 = static_cast<bf16*>(out1);
    p.M = M;
    p.res_idx = res_idx;
    p.res_dual = res_dual;
    p.d_out = d_out;

    const size_t smem = smem_bytes(width0 + width1);
    const int n_tiles = (M + TM - 1) / TM;
    const int grid = n_tiles < n_sm ? n_tiles : n_sm;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (layer_norm) {
        err = cudaFuncSetAttribute(fused_mlp_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_kernel<true><<<grid, THREADS, smem, s>>>(p);
    } else {
        err = cudaFuncSetAttribute(fused_mlp_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        fused_mlp_kernel<false><<<grid, THREADS, smem, s>>>(p);
    }
    return (int)cudaGetLastError();
}
