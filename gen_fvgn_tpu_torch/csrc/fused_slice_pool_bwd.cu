// K7: the slice-pool backward for sm_90a, the row pass on the block row
// tiles of slice_pool_tiles.cuh (its design note is there), then the
// weight-gradient pass and the fixed-order reductions.
//
// Plain C interface, no allocation (the caller passes a workspace of the
// size gfvgn_slice_pool_workspace gives), launches on the caller's stream and
// returns cudaGetLastError().

#include "slice_pool_tiles.cuh"

// total: the float32 slab [dWfx | dWx (C x C) | dWsl per head [H][D][G] |
// dbsl per slot [H*G] | dinv_temp per slot [H*G] | dbfx | dbx (C)], the
// weight gradients summed per batch lane, each lane's sum rounded to bf16,
// the lanes summed in order
extern "C" int gfvgn_fused_slice_pool_bwd(
        const void* x, const void* mask, int mask_bstride, const void* wfx,
        const void* bfx, const void* wx, const void* bx, const void* wsl,
        const void* bsl, const void* inv_temp, const void* dslice_w,
        const void* dtokens, const void* dnorm, void* dx, void* total, int c,
        int h, int g, int B, int N, void* workspace, void* stream) {
    PoolRun P;
    int err = pool_run(c, h, g, B, N, true, P);
    if (err != 0) return err;
    if (mask_bstride != 0 && mask_bstride != N)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    unsigned char* ws = static_cast<unsigned char*>(workspace);
    PoolParams p{};
    fill_pool(p, P, x, mask, mask_bstride, wfx, bfx, wx, bx, wsl, bsl,
              inv_temp, N, ws);
    p.dslice_w = static_cast<const bf16*>(dslice_w);
    p.dtok = static_cast<const float*>(dtokens);
    p.dnorm = static_cast<const float*>(dnorm);
    p.dx = static_cast<bf16*>(dx);
    p.dfxs = reinterpret_cast<bf16*>(ws + P.o_dfx);
    p.dxms = reinterpret_cast<bf16*>(ws + P.o_dxm);
    err = launch_pool<true>(P, p, B, st);
    if (err != 0) return err;
    // dWfx = x^T dfx16, dWx = x^T dxm16, per batch lane
    gfvgn::WgParams& q = P.q;
    q.job[0].a = p.x;
    q.job[0].b = p.dfxs;
    q.job[1].a = p.x;
    q.job[1].b = p.dxms;
    q.part = reinterpret_cast<float*>(ws + P.o_wg);
    float* tot = static_cast<float*>(total);
    err = gfvgn_wgrad(&q, B, tot, st);
    if (err != 0) return err;
    lane_reduce<<<(P.part_len + 255) / 256, 256, 0, st>>>(
        p.part, tot + q.n_w, P.part_len, P.s.hg * P.s.d, B, P.n_chunks);
    return (int)cudaGetLastError();
}
