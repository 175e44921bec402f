// The segment engine's FV residual (fv/integrator.py::integrate_residuals at
// order "2nd", conserved form) as passes over per-entity lists
// (ops/fv_csr.py builds them and holds the passes' plain versions), for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package assembles the residual with XLA
// gathers, scatter-adds and a batched product. The port's plain version
// (ops/wlsq.py, ops/interp.py, ops/segment.py) writes [B, E, ...]
// intermediates, sums them onto nodes and cells with atomic index_adds, and
// runs the folded WLSQ solve as a batched float32 GEMV.
//
// Every pass writes each output row once, from one thread that gathers its
// inputs along the row's list in ascending entry order: no atomics on
// floats, and two runs give the same bits. Rows are flattened over the
// batch (node b*N + n, face b*E + f, cell b*C + c, slot b*K + i, stencil
// entry b*S + e); a lane reads its own sample's rows, so a mixed-case batch
// is served like a single-case one.
//
// The lists (gfvgn_fv_lists): a counting sort over five families of rows,
// in this order: cells (their slots), nodes (their slots), faces (their
// slots), nodes (their stencil entries, (b*S + e)*2 + side) and nodes
// (their faces, (b*E + f)*2 + side); side 0 where the node is the sender.
// Step 0 counts each row's entries with integer atomics into ptr[1:]; the
// caller scans ptr; step 1 places each entry by an integer atomic cursor,
// then sorts each row's few entries, so the lists are those of a stable
// sort, whatever order the atomics took.
//
// The passes (gfvgn_fv_pass), forward:
//   * fv_wlsq (node): the k x 7 sums of row * (phi[other] - phi[node]) over
//     the node's stencil entries (row: the entry's B row times the node's
//     column scale, times the parity signs where the node is the sender),
//     then the two gradient rows of the folded solve: grad [B*N, 7, 2];
//   * fv_face (face): both nodes Taylor-extrapolated to the face centre and
//     averaged, the gradients averaged, the boundary fix: a 16-float record
//     [uv_new 2, p, uv_hat 2, grad uv_new 4, grad uv_hat 4, 0 0 0];
//   * fv_cell (cell): node->cell of the new and old states, the slot
//     fluxes, the outflow traction, the unsteady and source terms:
//     uvp_cell [B*C, 3] and the squared residuals [B*C, 4];
//     fv_loss (a block a sample): their sums in a fixed order, the roots
//     and the four pooled losses [B];
//   * fv_smooth (node): the inverse-distance cell->node average.
// Backward:
//   * fv_cell_bwd (cell): the smoothing's transpose onto the cell, then the
//     cell pass's, into each slot's face cotangent (16 floats, slot-major)
//     and the cell's node->cell cotangent over its count (8 floats);
//   * fv_node_bwd (node): over the node's faces (each face's slot
//     cotangents summed in list order, the boundary fix applied) and its
//     slots: d phi [B*N, 7] and d grad [B*N, 7, 2];
//   * fv_wlsq_bwd (node): the WLSQ's transpose over the stencil entries,
//     each neighbour's gradient rows applied on the fly, plus d phi: the
//     three states' gradients.
//
// float32 throughout; built with -fmad=false, so each step rounds where
// the plain versions' operations round (the sums' order aside). What bounds
// the passes: bytes, and the latency of each row's dependent loads (list
// entry -> index -> row).
//
// Plain C interface, no allocation, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the C entries' arguments: outside the unnamed namespace, so that the
// entries keep external linkage
struct FvMesh {
    int B, N, E, C, K, S;   // per sample: nodes, faces, cells, slots, stencil
    const float* pos;           // [B*N, 2]
    const float* face_center;   // [B*E, 2]
    const float* face_area;     // [B*E]
    const int* face_node;       // [B, 2, E]
    const int* face_type;       // [B*E]
    const unsigned char* face_mask;
    const float* centroid;      // [B*C, 2]
    const float* cells_area;    // [B*C]
    const unsigned char* cell_mask;
    const int* cells_node;      // [B*K]
    const int* cells_face;
    const int* cells_index;
    const unsigned char* slot_mask;
    const float* slot_unv;      // [B*K, 2]
    const int* stencil;         // [B, 2, S]
    const unsigned char* stencil_mask;
    const float* wlsq_S;        // [B*N, 5, 5]
    const float* wlsq_B;        // [B*S, 5]
    const float* wlsq_scale;    // [B*N, 5]
    const float* target_uv;     // [B*N, 2]
    const float* theta;         // [B, 9]
    const float* sigma;         // [B, 3]
    const float* dt;            // [B]
    const int* ptr;             // the lists' row pointers
    const int* ids;             // their entries
    int inflow, wall, outflow;  // face types
};

struct FvData {
    const float* uvp_new;   // [B*N, 3]
    const float* uv_hat;    // [B*N, 2]
    const float* uv_old;    // [B*N, 2]
    float* grad;            // [B*N, 7, 2]
    float* face_rec;        // [B*E, 16]
    float* uvp_cell;        // [B*C, 3]
    float* cell_sq;         // [B*C, 4]
    float* roots;           // [4, B]
    float* loss[4];         // [B] each: cont, mom_x, mom_y, press
    float* rt;              // [B*N, 3]
    float* den;             // [B*N]
    const float* g_loss[4]; // [B] each, or null
    const float* g_cell;    // [B*C, 3] or null
    const float* g_rt;      // [B*N, 3] or null
    float* slot_buf;        // [B*K, 16]
    float* cell_buf;        // [B*C, 8]
    float* dphi;            // [B*N, 7]
    float* dgrad;           // [B*N, 7, 2]
    float* d_new;           // [B*N, 3]
    float* d_hat;           // [B*N, 2]
    float* d_old;           // [B*N, 2]
};

namespace {

constexpr int kThreads = 256;
constexpr int kLossThreads = 512;
constexpr int kK = 5;       // WLSQ columns at order "2nd"
constexpr int kRec = 16;    // a face record, a slot's cotangent
constexpr int kCellRec = 8; // a cell's node->cell cotangent

struct Rows {
    int cell, nslot, fslot, sten, nface, total;
};

__host__ __device__ inline Rows rows_of(const FvMesh& m) {
    Rows r;
    r.cell = 0;
    r.nslot = m.B * m.C;
    r.fslot = r.nslot + m.B * m.N;
    r.sten = r.fslot + m.B * m.E;
    r.nface = r.sten + m.B * m.N;
    r.total = r.nface + m.B * m.N;
    return r;
}

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ int ldi(const int* p) { return __ldg(p); }

__device__ __constant__ float kSigns[kK] = {-1.f, -1.f, 1.f, 1.f, 1.f};
// the channels a cell reads (conserved form): uvp_new 0-2, uv_old 5-6; a
// compile-time index after unrolling, so phi and grad stay in registers
__device__ __forceinline__ constexpr int cell_ch(int q) {
    return q < 3 ? q : q + 2;
}

__device__ __forceinline__ void load_phi(const FvData& d, int row,
                                         float (&phi)[7]) {
    phi[0] = ldf(d.uvp_new + 3 * (long long)row);
    phi[1] = ldf(d.uvp_new + 3 * (long long)row + 1);
    phi[2] = ldf(d.uvp_new + 3 * (long long)row + 2);
    phi[3] = ldf(d.uv_hat + 2 * (long long)row);
    phi[4] = ldf(d.uv_hat + 2 * (long long)row + 1);
    phi[5] = ldf(d.uv_old + 2 * (long long)row);
    phi[6] = ldf(d.uv_old + 2 * (long long)row + 1);
}

__device__ __forceinline__ void load_grad(const float* g, int row,
                                          float (&out)[7][2]) {
    const float2* p = reinterpret_cast<const float2*>(g + 14 * (long long)row);
#pragma unroll
    for (int c = 0; c < 7; ++c) {
        const float2 v = __ldg(p + c);
        out[c][0] = v.x;
        out[c][1] = v.y;
    }
}

__device__ __forceinline__ void load_rec(const float* base, long long row,
                                         float (&r)[kRec]) {
    const float4* p = reinterpret_cast<const float4*>(base + kRec * row);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = __ldg(p + q);
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
    }
}

__device__ __forceinline__ void store_rec(float* base, long long row,
                                          const float (&r)[kRec]) {
    float4* p = reinterpret_cast<float4*>(base + kRec * row);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        p[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                           r[4 * q + 3]);
}

// ---- the lists ----

// element p of the three families: a slot (3 rows), a stencil end, a face
// end; calls f(row, id) for each row the live element belongs to
template <typename F>
__device__ __forceinline__ void element_rows(const FvMesh& m, const Rows& o,
                                             long long p, F f) {
    const long long bk = (long long)m.B * m.K, bs = (long long)m.B * m.S;
    if (p < bk) {
        const int slot = (int)p, b = slot / m.K;
        if (!m.slot_mask[slot]) return;
        f(o.cell + b * m.C + m.cells_index[slot], slot);
        f(o.nslot + b * m.N + m.cells_node[slot], slot);
        f(o.fslot + b * m.E + m.cells_face[slot], slot);
    } else if (p < bk + 2 * bs) {
        const int id = (int)(p - bk), es = id >> 1, side = id & 1;
        const int b = es / m.S, e = es - b * m.S;
        if (!m.stencil_mask[es]) return;
        f(o.sten + b * m.N +
              m.stencil[(long long)b * 2 * m.S + (long long)side * m.S + e],
          id);
    } else {
        const int id = (int)(p - bk - 2 * bs), ef = id >> 1, side = id & 1;
        const int b = ef / m.E, f_ = ef - b * m.E;
        if (!m.face_mask[ef]) return;
        f(o.nface + b * m.N +
              m.face_node[(long long)b * 2 * m.E + (long long)side * m.E +
                          f_],
          id);
    }
}

__global__ void __launch_bounds__(kThreads)
    fv_list_count(FvMesh m, int* ptr, long long n_el) {
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (p >= n_el) return;
    const Rows o = rows_of(m);
    element_rows(m, o, p, [&](int row, int) { atomicAdd(ptr + row + 1, 1); });
}

__global__ void __launch_bounds__(kThreads)
    fv_list_fill(FvMesh m, const int* ptr, int* cursor, int* ids,
                 long long n_el) {
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (p >= n_el) return;
    const Rows o = rows_of(m);
    element_rows(m, o, p, [&](int row, int id) {
        ids[ptr[row] + atomicAdd(cursor + row, 1)] = id;
    });
}

// each row's entries in ascending order: an insertion sort (a row holds a
// few), in a local array where the row fits one
constexpr int kSortLocal = 32;

__global__ void __launch_bounds__(kThreads)
    fv_list_sort(const int* ptr, int* ids, int rows) {
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (r >= rows) return;
    const int a = ptr[r], n = ptr[r + 1] - a;
    if (n <= 1) return;
    if (n <= kSortLocal) {
        int v[kSortLocal];
        for (int i = 0; i < n; ++i) v[i] = ids[a + i];
        for (int i = 1; i < n; ++i) {
            const int x = v[i];
            int j = i - 1;
            while (j >= 0 && v[j] > x) {
                v[j + 1] = v[j];
                --j;
            }
            v[j + 1] = x;
        }
        for (int i = 0; i < n; ++i) ids[a + i] = v[i];
        return;
    }
    for (int i = a + 1; i < a + n; ++i) {
        const int x = ids[i];
        int j = i - 1;
        while (j >= a && ids[j] > x) {
            ids[j + 1] = ids[j];
            --j;
        }
        ids[j + 1] = x;
    }
}

// ---- forward ----

// a stencil entry seen from node row `row` of sample b: its B row, the other
// node's row, whether the node is the entry's sender
__device__ __forceinline__ void stencil_entry(const FvMesh& m, int b, int id,
                                              float (&brow)[kK], int& other,
                                              bool& sender) {
    const int side = id & 1, es = id >> 1, e = es - b * m.S;
    sender = side == 0;
    other = ldi(m.stencil + (long long)b * 2 * m.S +
                (long long)(1 - side) * m.S + e) +
            b * m.N;
#pragma unroll
    for (int k = 0; k < kK; ++k)
        brow[k] = ldf(m.wlsq_B + kK * (long long)es + k);
}

__global__ void __launch_bounds__(kThreads) fv_wlsq(FvMesh m, FvData d) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= m.B * m.N) return;
    const int b = row / m.N;
    const Rows o = rows_of(m);
    float phi[7], cs[kK], acc[kK][7];
    load_phi(d, row, phi);
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        cs[k] = ldf(m.wlsq_scale + kK * (long long)row + k);
#pragma unroll
        for (int c = 0; c < 7; ++c) acc[k][c] = 0.f;
    }
    const int t1 = ldi(m.ptr + o.sten + row + 1);
    for (int t = ldi(m.ptr + o.sten + row); t < t1; ++t) {
        float brow[kK], po[7];
        int other;
        bool sender;
        stencil_entry(m, b, ldi(m.ids + t), brow, other, sender);
        load_phi(d, other, po);
        float rw[kK], dp[7];
#pragma unroll
        for (int k = 0; k < kK; ++k)
            rw[k] = (sender ? brow[k] * kSigns[k] : brow[k]) * cs[k];
#pragma unroll
        for (int c = 0; c < 7; ++c) dp[c] = po[c] - phi[c];
#pragma unroll
        for (int k = 0; k < kK; ++k) {
#pragma unroll
            for (int c = 0; c < 7; ++c) acc[k][c] = acc[k][c] + rw[k] * dp[c];
        }
    }
    const float* S = m.wlsq_S + (long long)row * kK * kK;
    float2* out = reinterpret_cast<float2*>(d.grad + 14 * (long long)row);
#pragma unroll
    for (int c = 0; c < 7; ++c) {
        float g[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            g[j] = 0.f;
#pragma unroll
            for (int k = 0; k < kK; ++k)
                g[j] = g[j] + ldf(S + j * kK + k) * acc[k][c];
        }
        out[c] = make_float2(g[0], g[1]);
    }
}

__global__ void __launch_bounds__(kThreads) fv_face(FvMesh m, FvData d) {
    const int fr = blockIdx.x * kThreads + threadIdx.x;
    if (fr >= m.B * m.E) return;
    const int b = fr / m.E, f = fr - b * m.E;
    const long long base = (long long)b * 2 * m.E + f;
    const int na = ldi(m.face_node + base) + b * m.N;
    const int nc = ldi(m.face_node + base + m.E) + b * m.N;
    const float fx = ldf(m.face_center + 2 * (long long)fr);
    const float fy = ldf(m.face_center + 2 * (long long)fr + 1);
    float pa[7], pc[7], ga[7][2], gc[7][2];
    load_phi(d, na, pa);
    load_phi(d, nc, pc);
    load_grad(d.grad, na, ga);
    load_grad(d.grad, nc, gc);
    const float rax = fx - ldf(m.pos + 2 * (long long)na);
    const float ray = fy - ldf(m.pos + 2 * (long long)na + 1);
    const float rcx = fx - ldf(m.pos + 2 * (long long)nc);
    const float rcy = fy - ldf(m.pos + 2 * (long long)nc + 1);
    float val[5];
#pragma unroll
    for (int ch = 0; ch < 5; ++ch) {
        const float va = pa[ch] + (rax * ga[ch][0] + ray * ga[ch][1]);
        const float vc = pc[ch] + (rcx * gc[ch][0] + rcy * gc[ch][1]);
        val[ch] = 0.5f * (va + vc);
    }
    const int ft = ldi(m.face_type + fr);
    float y[2];
#pragma unroll
    for (int k = 0; k < 2; ++k)
        y[k] = 0.5f * (ldf(m.target_uv + 2 * (long long)na + k) +
                       ldf(m.target_uv + 2 * (long long)nc + k));
    auto fix = [&](float v, int k) {
        return ft == m.wall ? 0.f : (ft == m.inflow ? y[k] : v);
    };
    float rec[kRec];
    rec[0] = fix(val[0], 0);
    rec[1] = fix(val[1], 1);
    rec[2] = val[2];
    rec[3] = fix(val[3], 0);
    rec[4] = fix(val[4], 1);
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
        rec[5 + dd] = 0.5f * (ga[0][dd] + gc[0][dd]);
        rec[7 + dd] = 0.5f * (ga[1][dd] + gc[1][dd]);
        rec[9 + dd] = 0.5f * (ga[3][dd] + gc[3][dd]);
        rec[11 + dd] = 0.5f * (ga[4][dd] + gc[4][dd]);
    }
    rec[13] = rec[14] = rec[15] = 0.f;
    store_rec(d.face_rec, fr, rec);
}

struct Coefs {
    float unsteady, cont, conv, gradp, diff, source;
};

__device__ __forceinline__ Coefs coefs(const FvMesh& m, int b) {
    const float* t = m.theta + 9 * b;
    return Coefs{ldf(t), ldf(t + 1), ldf(t + 2), ldf(t + 3), ldf(t + 4),
                 ldf(t + 5)};
}

// a slot's surface vector, outflow flag and face record
__device__ __forceinline__ void slot_face(const FvMesh& m, const FvData& d,
                                          int b, int slot, float (&sv)[2],
                                          float& out, float (&rec)[kRec]) {
    const int face = ldi(m.cells_face + slot) + b * m.E;
    const float area = ldf(m.face_area + face);
    sv[0] = ldf(m.slot_unv + 2 * (long long)slot) * area;
    sv[1] = ldf(m.slot_unv + 2 * (long long)slot + 1) * area;
    out = ldi(m.face_type + face) == m.outflow ? 1.f : 0.f;
    load_rec(d.face_rec, face, rec);
}

// a slot's continuity, momentum flux and outflow residual
__device__ __forceinline__ void fluxes(const float (&r)[kRec],
                                       const float (&sv)[2], float out,
                                       const Coefs& co, float& div,
                                       float (&j)[2], float (&resid)[2]) {
    div = r[0] * sv[0] + r[1] * sv[1];
    const float p = r[2], uh[2] = {r[3], r[4]};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        float mm[2];
#pragma unroll
        for (int dd = 0; dd < 2; ++dd) {
            const float conv = (uh[c] * uh[dd]) * co.conv;
            const float eye = c == dd ? 1.f : 0.f;
            mm[dd] = (conv + (eye * p) * co.gradp) -
                     r[9 + 2 * c + dd] * co.diff;
        }
        j[c] = mm[0] * sv[0] + mm[1] * sv[1];
        const float visc =
            co.diff * (r[5 + 2 * c] * sv[0] + r[5 + 2 * c + 1] * sv[1]);
        resid[c] = (visc - p * sv[c]) * out;
    }
}

// the sums over a cell's slots
struct CellSums {
    float tot[5], cnt, div, rhs[2], psq;
};

__device__ __forceinline__ CellSums cell_walk(const FvMesh& m,
                                              const FvData& d, int b, int cr,
                                              int t0, int t1,
                                              const Coefs& co) {
    CellSums s;
#pragma unroll
    for (int q = 0; q < 5; ++q) s.tot[q] = 0.f;
    s.cnt = s.div = s.psq = 0.f;
    s.rhs[0] = s.rhs[1] = 0.f;
    const float cx = ldf(m.centroid + 2 * (long long)cr);
    const float cy = ldf(m.centroid + 2 * (long long)cr + 1);
    for (int t = t0; t < t1; ++t) {
        const int slot = ldi(m.ids + t);
        const int node = ldi(m.cells_node + slot) + b * m.N;
        const float rx = cx - ldf(m.pos + 2 * (long long)node);
        const float ry = cy - ldf(m.pos + 2 * (long long)node + 1);
        float phi[7], g[7][2];
        load_phi(d, node, phi);
        load_grad(d.grad, node, g);
#pragma unroll
        for (int q = 0; q < 5; ++q) {
            const int ch = cell_ch(q);
            s.tot[q] = s.tot[q] + (phi[ch] + (rx * g[ch][0] + ry * g[ch][1]));
        }
        s.cnt = s.cnt + 1.f;
        float sv[2], out, rec[kRec], dv, j[2], resid[2];
        slot_face(m, d, b, slot, sv, out, rec);
        fluxes(rec, sv, out, co, dv, j, resid);
        s.div = s.div + dv;
        s.rhs[0] = s.rhs[0] + j[0];
        s.rhs[1] = s.rhs[1] + j[1];
        s.psq = s.psq + (resid[0] * resid[0] + resid[1] * resid[1]);
    }
    return s;
}

// uvp_cell, the old state at the cell and the momentum residual
__device__ __forceinline__ void cell_state(const FvMesh& m, int b, int cr,
                                           const CellSums& s, const Coefs& co,
                                           float (&cell)[5], float (&mom)[2]) {
    const float cnt = fmaxf(s.cnt, 1.f);
#pragma unroll
    for (int q = 0; q < 5; ++q) cell[q] = s.tot[q] / cnt;
    const float area = ldf(m.cells_area + cr), dt = ldf(m.dt + b);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const float unsteady = ((cell[k] - cell[3 + k]) / dt) * area;
        mom[k] = co.unsteady * unsteady + (s.rhs[k] - co.source * area);
    }
}

__global__ void __launch_bounds__(kThreads) fv_cell(FvMesh m, FvData d) {
    const int cr = blockIdx.x * kThreads + threadIdx.x;
    if (cr >= m.B * m.C) return;
    const int b = cr / m.C;
    const Rows o = rows_of(m);
    const Coefs co = coefs(m, b);
    const CellSums s = cell_walk(m, d, b, cr, ldi(m.ptr + o.cell + cr),
                                 ldi(m.ptr + o.cell + cr + 1), co);
    float cell[5], mom[2];
    cell_state(m, b, cr, s, co, cell, mom);
    const float mk = m.cell_mask[cr] ? 1.f : 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q) d.uvp_cell[3 * (long long)cr + q] = cell[q];
    reinterpret_cast<float4*>(d.cell_sq)[cr] =
        make_float4(s.div * s.div * mk, mom[0] * mom[0] * mk,
                    mom[1] * mom[1] * mk, s.psq);
}

// a block a sample: each thread sums its cells in order, then a fixed tree
__global__ void __launch_bounds__(kLossThreads) fv_loss(FvMesh m, FvData d) {
    __shared__ float part[4][kLossThreads];
    const int b = blockIdx.x, tid = threadIdx.x;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* sq = reinterpret_cast<const float4*>(d.cell_sq) +
                       (long long)b * m.C;
    for (int c = tid; c < m.C; c += kLossThreads) {
        const float4 v = __ldg(sq + c);
        s[0] = s[0] + v.x;
        s[1] = s[1] + v.y;
        s[2] = s[2] + v.z;
        s[3] = s[3] + v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q][tid] = s[q];
    __syncthreads();
    for (int w = kLossThreads / 2; w > 0; w >>= 1) {
        if (tid < w) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                part[q][tid] = part[q][tid] + part[q][tid + w];
        }
        __syncthreads();
    }
    if (tid < 4) {
        const float tot = part[tid][0];
        const float root = tot > 0.f ? sqrtf(tot) : 0.f;
        const float coef = tid == 0   ? ldf(m.theta + 9 * b + 1)
                           : tid == 3 ? 1.f
                                      : ldf(m.sigma + 3 * b + tid - 1);
        d.roots[tid * m.B + b] = root;
        d.loss[tid][b] = root * coef;
    }
}

__device__ __forceinline__ float smooth_weight(const FvMesh& m, int node,
                                               int cell) {
    const float rx = ldf(m.pos + 2 * (long long)node) -
                     ldf(m.centroid + 2 * (long long)cell);
    const float ry = ldf(m.pos + 2 * (long long)node + 1) -
                     ldf(m.centroid + 2 * (long long)cell + 1);
    const float dist = sqrtf(rx * rx + ry * ry);
    return 1.f / (dist > 0.f ? dist : 1.f);
}

__global__ void __launch_bounds__(kThreads) fv_smooth(FvMesh m, FvData d) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= m.B * m.N) return;
    const int b = row / m.N;
    const Rows o = rows_of(m);
    float num[3] = {0.f, 0.f, 0.f}, den = 0.f;
    const int t1 = ldi(m.ptr + o.nslot + row + 1);
    for (int t = ldi(m.ptr + o.nslot + row); t < t1; ++t) {
        const int cell = ldi(m.cells_index + ldi(m.ids + t)) + b * m.C;
        const float w = smooth_weight(m, row, cell);
#pragma unroll
        for (int q = 0; q < 3; ++q)
            num[q] = num[q] + ldf(d.uvp_cell + 3 * (long long)cell + q) * w;
        den = den + w;
    }
    const float cl = fmaxf(den, 1e-12f);
#pragma unroll
    for (int q = 0; q < 3; ++q) d.rt[3 * (long long)row + q] = num[q] / cl;
    d.den[row] = den;
}

// ---- backward ----

__global__ void __launch_bounds__(kThreads) fv_cell_bwd(FvMesh m, FvData d) {
    const int cr = blockIdx.x * kThreads + threadIdx.x;
    if (cr >= m.B * m.C) return;
    const int b = cr / m.C;
    const Rows o = rows_of(m);
    const Coefs co = coefs(m, b);
    const int t0 = ldi(m.ptr + o.cell + cr), t1 = ldi(m.ptr + o.cell + cr + 1);
    const CellSums s = cell_walk(m, d, b, cr, t0, t1, co);
    float cell[5], mom[2];
    cell_state(m, b, cr, s, co, cell, mom);
    float dcell[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
        dcell[q] = d.g_cell ? ldf(d.g_cell + 3 * (long long)cr + q) : 0.f;
    if (d.g_rt) {
        for (int t = t0; t < t1; ++t) {
            const int node = ldi(m.cells_node + ldi(m.ids + t)) + b * m.N;
            const float w = smooth_weight(m, node, cr);
            const float cl = fmaxf(ldf(d.den + node), 1e-12f);
#pragma unroll
            for (int q = 0; q < 3; ++q)
                dcell[q] = dcell[q] +
                           w * (ldf(d.g_rt + 3 * (long long)node + q) / cl);
        }
    }
    float fac[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float root = ldf(d.roots + q * m.B + b);
        const float gl = d.g_loss[q] ? ldf(d.g_loss[q] + b) : 0.f;
        const float coef = q == 0   ? co.cont
                           : q == 3 ? 1.f
                                    : ldf(m.sigma + 3 * b + q - 1);
        fac[q] = root > 0.f ? (gl * coef) / root : 0.f;
    }
    const float mk = m.cell_mask[cr] ? 1.f : 0.f;
    const float ddiv = fac[0] * s.div * mk;
    const float dmom[2] = {fac[1] * mom[0] * mk, fac[2] * mom[1] * mk};
    const float area = ldf(m.cells_area + cr), dt = ldf(m.dt + b);
    const float uscale = (co.unsteady * area) / dt;
    const float du[2] = {dmom[0] * uscale, dmom[1] * uscale};
    const float inv = 1.f / fmaxf(s.cnt, 1.f);
    float4* crec =
        reinterpret_cast<float4*>(d.cell_buf + kCellRec * (long long)cr);
    crec[0] = make_float4((dcell[0] + du[0]) * inv, (dcell[1] + du[1]) * inv,
                          dcell[2] * inv, (-du[0]) * inv);
    crec[1] = make_float4((-du[1]) * inv, 0.f, 0.f, 0.f);
    for (int t = t0; t < t1; ++t) {
        const int slot = ldi(m.ids + t);
        float sv[2], out, r[kRec], dv, j[2], resid[2];
        slot_face(m, d, b, slot, sv, out, r);
        fluxes(r, sv, out, co, dv, j, resid);
        float dm[2][2], dres[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            dm[c][0] = dmom[c] * sv[0];
            dm[c][1] = dmom[c] * sv[1];
            dres[c] = (fac[3] * resid[c]) * out;
        }
        const float uh[2] = {r[3], r[4]};
        float w[kRec];
        w[0] = ddiv * sv[0];
        w[1] = ddiv * sv[1];
        w[2] = co.gradp * (dm[0][0] + dm[1][1]) -
               (dres[0] * sv[0] + dres[1] * sv[1]);
#pragma unroll
        for (int a = 0; a < 2; ++a)
            w[3 + a] = co.conv * ((dm[a][0] * uh[0] + dm[a][1] * uh[1]) +
                                  (dm[0][a] * uh[0] + dm[1][a] * uh[1]));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int dd = 0; dd < 2; ++dd) {
                w[5 + 2 * c + dd] = (co.diff * dres[c]) * sv[dd];
                w[9 + 2 * c + dd] = (-co.diff) * dm[c][dd];
            }
        }
        w[13] = w[14] = w[15] = 0.f;
        store_rec(d.slot_buf, slot, w);
    }
}

__global__ void __launch_bounds__(kThreads) fv_node_bwd(FvMesh m, FvData d) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= m.B * m.N) return;
    const int b = row / m.N;
    const Rows o = rows_of(m);
    const float px = ldf(m.pos + 2 * (long long)row);
    const float py = ldf(m.pos + 2 * (long long)row + 1);
    float dphi[7], dg[7][2];
#pragma unroll
    for (int c = 0; c < 7; ++c) dphi[c] = dg[c][0] = dg[c][1] = 0.f;
    const int f1 = ldi(m.ptr + o.nface + row + 1);
    for (int t = ldi(m.ptr + o.nface + row); t < f1; ++t) {
        const int face = ldi(m.ids + t) >> 1;
        float df[kRec];
#pragma unroll
        for (int q = 0; q < kRec; ++q) df[q] = 0.f;
        const int s1 = ldi(m.ptr + o.fslot + face + 1);
        for (int u = ldi(m.ptr + o.fslot + face); u < s1; ++u) {
            float sr[kRec];
            load_rec(d.slot_buf, ldi(m.ids + u), sr);
#pragma unroll
            for (int q = 0; q < kRec; ++q) df[q] = df[q] + sr[q];
        }
        const int ft = ldi(m.face_type + face);
        const float keep = (ft != m.inflow && ft != m.wall) ? 1.f : 0.f;
        const float dval[5] = {df[0] * keep, df[1] * keep, df[2],
                               df[3] * keep, df[4] * keep};
        const float dnab[5][2] = {{df[5], df[6]},
                                  {df[7], df[8]},
                                  {0.f, 0.f},
                                  {df[9], df[10]},
                                  {df[11], df[12]}};
        const float rx = ldf(m.face_center + 2 * (long long)face) - px;
        const float ry = ldf(m.face_center + 2 * (long long)face + 1) - py;
#pragma unroll
        for (int ch = 0; ch < 5; ++ch) {
            const float h = 0.5f * dval[ch];
            dphi[ch] = dphi[ch] + h;
            dg[ch][0] = dg[ch][0] + (h * rx + 0.5f * dnab[ch][0]);
            dg[ch][1] = dg[ch][1] + (h * ry + 0.5f * dnab[ch][1]);
        }
    }
    const int c1 = ldi(m.ptr + o.nslot + row + 1);
    for (int t = ldi(m.ptr + o.nslot + row); t < c1; ++t) {
        const int cell = ldi(m.cells_index + ldi(m.ids + t)) + b * m.C;
        const float rx = ldf(m.centroid + 2 * (long long)cell) - px;
        const float ry = ldf(m.centroid + 2 * (long long)cell + 1) - py;
        const float4* cp = reinterpret_cast<const float4*>(
            d.cell_buf + kCellRec * (long long)cell);
        const float4 v0 = __ldg(cp), v1 = __ldg(cp + 1);
        const float dc[5] = {v0.x, v0.y, v0.z, v0.w, v1.x};
#pragma unroll
        for (int q = 0; q < 5; ++q) {
            const int ch = cell_ch(q);
            dphi[ch] = dphi[ch] + dc[q];
            dg[ch][0] = dg[ch][0] + dc[q] * rx;
            dg[ch][1] = dg[ch][1] + dc[q] * ry;
        }
    }
#pragma unroll
    for (int c = 0; c < 7; ++c) d.dphi[7 * (long long)row + c] = dphi[c];
    float2* go = reinterpret_cast<float2*>(d.dgrad + 14 * (long long)row);
#pragma unroll
    for (int c = 0; c < 7; ++c) go[c] = make_float2(dg[c][0], dg[c][1]);
}

// a node's gradient rows of the folded solve and its column scale
struct NodeSolve {
    float S[2][kK], cs[kK];
};

__device__ __forceinline__ NodeSolve node_solve(const FvMesh& m, int node) {
    NodeSolve ns;
    const float* S = m.wlsq_S + (long long)node * kK * kK;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        ns.S[0][k] = ldf(S + k);
        ns.S[1][k] = ldf(S + kK + k);
        ns.cs[k] = ldf(m.wlsq_scale + kK * (long long)node + k);
    }
    return ns;
}

// t[c] = sum_j u[j] g[c][j], u[j] = sum_k S[j][k] row[k]: the WLSQ's
// transpose of one stencil entry at one of its ends
__device__ __forceinline__ void wlsq_t(const NodeSolve& ns,
                                       const float (&brow)[kK], bool sender,
                                       const float (&g)[7][2],
                                       float (&t)[7]) {
    float u[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const float rw = (sender ? brow[k] * kSigns[k] : brow[k]) * ns.cs[k];
        u[0] = u[0] + ns.S[0][k] * rw;
        u[1] = u[1] + ns.S[1][k] * rw;
    }
#pragma unroll
    for (int c = 0; c < 7; ++c) t[c] = u[0] * g[c][0] + u[1] * g[c][1];
}

__global__ void __launch_bounds__(kThreads) fv_wlsq_bwd(FvMesh m, FvData d) {
    const int row = blockIdx.x * kThreads + threadIdx.x;
    if (row >= m.B * m.N) return;
    const int b = row / m.N;
    const Rows o = rows_of(m);
    float out[7], gn[7][2];
#pragma unroll
    for (int c = 0; c < 7; ++c) out[c] = ldf(d.dphi + 7 * (long long)row + c);
    load_grad(d.dgrad, row, gn);
    const NodeSolve own = node_solve(m, row);
    const int t1 = ldi(m.ptr + o.sten + row + 1);
    for (int t = ldi(m.ptr + o.sten + row); t < t1; ++t) {
        float brow[kK], gm[7][2], tn[7], tm[7];
        int other;
        bool sender;
        stencil_entry(m, b, ldi(m.ids + t), brow, other, sender);
        load_grad(d.dgrad, other, gm);
        wlsq_t(own, brow, sender, gn, tn);
        wlsq_t(node_solve(m, other), brow, !sender, gm, tm);
#pragma unroll
        for (int c = 0; c < 7; ++c) out[c] = out[c] + (tm[c] - tn[c]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) d.d_new[3 * (long long)row + c] = out[c];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        d.d_hat[2 * (long long)row + c] = out[3 + c];
        d.d_old[2 * (long long)row + c] = out[5 + c];
    }
}

dim3 grid_of(long long rows, int threads) {
    return dim3((unsigned)((rows + threads - 1) / threads));
}

}  // namespace

// step 0: count each row's entries into ptr[1:] (ptr zeroed by the caller);
// step 1 (after the caller's inclusive scan of ptr[1:]): place the entries
// by the cursors (zeroed by the caller), then sort each row
extern "C" int gfvgn_fv_lists(int step, const FvMesh* mesh, int* ptr,
                              int* cursor, int* ids, void* stream) {
    const FvMesh m = *mesh;
    const Rows o = rows_of(m);
    const long long n_el = (long long)m.B * (m.K + 2LL * m.S + 2LL * m.E);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_el <= 0) return 0;
    if (step == 0) {
        fv_list_count<<<grid_of(n_el, kThreads), kThreads, 0, s>>>(m, ptr,
                                                                    n_el);
    } else {
        fv_list_fill<<<grid_of(n_el, kThreads), kThreads, 0, s>>>(
            m, ptr, cursor, ids, n_el);
        fv_list_sort<<<grid_of(o.total, kThreads), kThreads, 0, s>>>(
            ptr, ids, o.total);
    }
    return static_cast<int>(cudaGetLastError());
}

// pass: 0 fv_wlsq, 1 fv_face, 2 fv_cell + fv_loss, 3 fv_smooth,
// 4 fv_cell_bwd, 5 fv_node_bwd, 6 fv_wlsq_bwd
extern "C" int gfvgn_fv_pass(int pass, const FvMesh* mesh, const FvData* data,
                             void* stream) {
    const FvMesh m = *mesh;
    const FvData d = *data;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long nodes = (long long)m.B * m.N;
    const long long faces = (long long)m.B * m.E;
    const long long cells = (long long)m.B * m.C;
    switch (pass) {
        case 0:
            if (nodes > 0)
                fv_wlsq<<<grid_of(nodes, kThreads), kThreads, 0, s>>>(m, d);
            break;
        case 1:
            if (faces > 0)
                fv_face<<<grid_of(faces, kThreads), kThreads, 0, s>>>(m, d);
            break;
        case 2:
            if (cells > 0)
                fv_cell<<<grid_of(cells, kThreads), kThreads, 0, s>>>(m, d);
            if (m.B > 0) fv_loss<<<m.B, kLossThreads, 0, s>>>(m, d);
            break;
        case 3:
            if (nodes > 0)
                fv_smooth<<<grid_of(nodes, kThreads), kThreads, 0, s>>>(m, d);
            break;
        case 4:
            if (cells > 0)
                fv_cell_bwd<<<grid_of(cells, kThreads), kThreads, 0, s>>>(m,
                                                                         d);
            break;
        case 5:
            if (nodes > 0)
                fv_node_bwd<<<grid_of(nodes, kThreads), kThreads, 0, s>>>(m,
                                                                         d);
            break;
        case 6:
            if (nodes > 0)
                fv_wlsq_bwd<<<grid_of(nodes, kThreads), kThreads, 0, s>>>(m,
                                                                         d);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
