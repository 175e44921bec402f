// K1: batched CSR sparse apply  out[b] = A * x[b]  for sm_90a.
//
// Replaces the Pallas TPU kernels of gen_fvgn_tpu/ops/pallas_spmm.py
// (pallas_block_spmm_window and its three grid variants), which stream
// 256x256 dense operator tiles through the matrix unit. Here the operator is
// CSR and the work is a gather-accumulate bounded by bytes: one warp per
// (output row, batch lane); within each 128-feature chunk a lane owns 4
// contiguous features (8-byte loads for bf16, 16-byte for f32) and
// accumulates over the row's non-zeros in float32. Rows without non-zeros
// (the padding) come out exactly zero.
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&raw.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&raw.y);
    float2 fa = __bfloat1622float2(a);
    float2 fb = __bfloat1622float2(b);
    v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <typename XT, typename OT>
__global__ void spmm_csr_kernel(const int* __restrict__ crow,
                                const int* __restrict__ col,
                                const float* __restrict__ val,
                                const XT* __restrict__ x,
                                OT* __restrict__ out,
                                int n_in, int n_out, int F) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + warp;
    if (row >= n_out) return;
    const int b = blockIdx.y;
    const int start = crow[row];
    const int end = crow[row + 1];
    const XT* xb = x + (size_t)b * n_in * F;
    OT* ob = out + ((size_t)b * n_out + row) * F;
    for (int f0 = lane * 4; f0 < F; f0 += 128) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = start; j < end; ++j) {
            const int c = col[j];
            const float w = val[j];
            float v[4];
            load4(xb + (size_t)c * F + f0, v);
            acc[0] = fmaf(w, v[0], acc[0]);
            acc[1] = fmaf(w, v[1], acc[1]);
            acc[2] = fmaf(w, v[2], acc[2]);
            acc[3] = fmaf(w, v[3], acc[3]);
        }
        store4(ob + f0, acc);
    }
}

}  // namespace

extern "C" int gfvgn_spmm_csr(const void* crow, const void* col,
                              const void* val, const void* x, void* out,
                              int B, int n_in, int n_out, int F,
                              int x_is_bf16, int out_is_bf16, void* stream) {
    if (F % 128 != 0 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((n_out + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
    dim3 block(kWarpsPerBlock * 32);
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* cr = static_cast<const int*>(crow);
    const int* cl = static_cast<const int*>(col);
    const float* vl = static_cast<const float*>(val);
    if (x_is_bf16 && out_is_bf16) {
        spmm_csr_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, block, 0, s>>>(
            cr, cl, vl, static_cast<const __nv_bfloat16*>(x),
            static_cast<__nv_bfloat16*>(out), n_in, n_out, F);
    } else if (x_is_bf16 && !out_is_bf16) {
        spmm_csr_kernel<__nv_bfloat16, float><<<grid, block, 0, s>>>(
            cr, cl, vl, static_cast<const __nv_bfloat16*>(x),
            static_cast<float*>(out), n_in, n_out, F);
    } else if (!x_is_bf16 && !out_is_bf16) {
        spmm_csr_kernel<float, float><<<grid, block, 0, s>>>(
            cr, cl, vl, static_cast<const float*>(x),
            static_cast<float*>(out), n_in, n_out, F);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
