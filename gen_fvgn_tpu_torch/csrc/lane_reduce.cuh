// The second pass of the backward kernels' weight gradients (fused_mlp.cu,
// fused_premlp.cu, fused_slice_pool.cu): each block of the first pass writes
// a float32 slab of partial sums, and this kernel adds them in a fixed order,
// so two runs give the same bits (no float atomics).
//
// The blocks are grouped into lanes (one per batch sample). A lane's sum is
// rounded to bf16 for the weight elements, as the JAX package rounds each
// sample's weight gradient to the weights' bf16 type before the batch sum.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace {

// total[e] = sum over lanes (in order) of [sum over the lane's blocks (in
// order) of part[lane * blocks_per_lane + block][e]], each lane's sum rounded
// to bf16 first for the weight elements e < n_w
__global__ void lane_reduce(const float* __restrict__ part,
                            float* __restrict__ total, int slab, int n_w,
                            int lanes, int blocks_per_lane) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= slab) return;
    float tot = 0.0f;
    for (int l = 0; l < lanes; ++l) {
        float s = 0.0f;
        for (int j = 0; j < blocks_per_lane; ++j)
            s += part[(size_t)(l * blocks_per_lane + j) * slab + e];
        if (e < n_w) s = __bfloat162float(__float2bfloat16(s));
        tot += s;
    }
    total[e] = tot;
}

}  // namespace
