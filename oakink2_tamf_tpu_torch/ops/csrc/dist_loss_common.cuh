// The fused distance loss of the all-pairs kernel (dist_loss.cu, #8) and
// the region-culled one (dist_loss_cull.cu, #9): the per-point arithmetic
// (once a column's or a row's first minimum is known, its integrand and
// gradient row) and the one kernel body both instantiate, #9 with CULL set.
// The two agree bit for bit wherever they find the same minimum.
#pragma once

#include "bidir_common.cuh"

// Column j of the o2h phase: its first-min row bi (staged xs / ns, centred)
// at squared distance best, the GT signed distance g_o. Returns the dist_o
// integrand v_j and adds the column's gradient row into the frame's shared
// accumulator acc [P1 * 3]:
//   dist = sqrt(best), sign = sign(n_bi . (y - x_bi)), o = dist * sign
//   w = 1.5 if o < 0 else (1.0 if -0.005 < g_o < 0.01 else 0.1)
//   v = |o - g_o| w;  acc[bi] += w sgn(o - g_o) sign / max(dist, 1e-12) (x_bi - y)
// A column that is not valid (an invalid point, or one that found no row)
// gives 0 and no gradient.
__device__ __forceinline__ float dist_loss_o2h_column(
    const float4* xs, const float4* ns, float* acc, float4 y, float best, int bi,
    bool valid, float g_o) {
    if (!valid) return 0.f;
    const float4 xr = xs[bi];
    const float dist = sqrtf(fmaxf(best, 0.f));
    const float sgn = o2h_signf(o2h_sign_numer(xr, ns[bi], y));
    const float o = dist * sgn;
    float w = (g_o < 0.01f && g_o > -0.005f) ? 1.0f : 0.1f;
    if (o < 0.f) w = 1.5f;  // penetration
    const float diff = o - g_o;
    const float coef = w * o2h_signf(diff) * sgn / fmaxf(dist, 1e-12f);
    if (coef != 0.f) {
        float* a = acc + 3 * bi;
        atomicAdd(a + 0, coef * (xr.x - y.x));
        atomicAdd(a + 1, coef * (xr.y - y.y));
        atomicAdd(a + 2, coef * (xr.z - y.z));
    }
    return fabsf(diff) * w;
}

// Row o of the h2o phase (centred x0..x2, contact weight w, GT h2o hg):
// its min best at point best_j of the cloud yg. Writes
//   hd = sqrt(best), dh_o = |hd - |hg|| w,
//   gx_dh[o] = w sgn(hd - |hg|) / max(hd, 1e-12) (x - y_best_j).
// A row that searched no pair (done == false) writes zeros.
__device__ __forceinline__ void dist_loss_h2o_row(
    float* __restrict__ dh_out, float* __restrict__ gx_dh, size_t o,
    const float4* __restrict__ yg, float best, int best_j, bool done,
    float x0, float x1, float x2, float hg, float w) {
    if (!done) {
        dh_out[o] = 0.f;
        gx_dh[3 * o + 0] = gx_dh[3 * o + 1] = gx_dh[3 * o + 2] = 0.f;
        return;
    }
    const float hd = sqrtf(fmaxf(best, 0.f));
    const float hgv = fabsf(hg);
    dh_out[o] = fabsf(hd - hgv) * w;
    const float cfh = w * o2h_signf(hd - hgv) / fmaxf(hd, 1e-12f);
    const float4 ya = yg[best_j];
    gx_dh[3 * o + 0] = cfh * (x0 - ya.x);
    gx_dh[3 * o + 1] = cfh * (x1 - ya.y);
    gx_dh[3 * o + 2] = cfh * (x2 - ya.z);
}

// One pass of dist_loss_body over the columns [j0, min(j0 + BIDIR_PASS, j1)),
// searching the regions of `run`: the search, then each live column's
// integrand (v) and gradient row (into acc).
template <bool CULL>
__device__ __forceinline__ void dist_loss_pass(
    const float4* xs, const float4* ns, unsigned long long* key, float* acc,
    const float4* __restrict__ yg, const float* __restrict__ ogf, float* __restrict__ vf,
    int P1r, int j0, int j1, unsigned run) {
    float4 yv[BIDIR_COLS];
    bidir_load_cols(yg, j0, j1, yv);
    float best[BIDIR_COLS];
    int best_i[BIDIR_COLS];
    bidir_pass<CULL>(xs, key, P1r, j0, yv, best, best_i, run);
#pragma unroll
    for (int c = 0; c < BIDIR_COLS; ++c) {
        const int j = j0 + c * BIDIR_THREADS + threadIdx.x;
        if (j >= j1) continue;
        const bool valid = yv[c].x < O2H_INVALID_Y && (!CULL || best[c] < H2O_BIG);
        vf[j] = dist_loss_o2h_column(xs, ns, acc, yv[c], best[c], best_i[c], valid, ogf[j]);
    }
}

// The kernel body of #8 (CULL false) and #9 (CULL true): one block of
// BIDIR_THREADS threads per frame. Beside the staged rows, normals and row
// keys (bidir_common.cuh), the frame's gx_do accumulator [P1, 3] lives in
// shared memory: after each pass, its columns' integrands and gradient rows
// go through dist_loss_o2h_column (a shared atomic add per column); after
// the last pass, the accumulator is written once and each row's key goes
// through dist_loss_h2o_row.
//
// CULL: the mask m [F, R, T] (R = ceil(P1 / 128), T = ceil(P2 / tile))
// decides, per tile t, which 128-row regions the passes over t's columns
// search (m != 0: bidir_pass's `run` bits). The passes walk each tile
// separately and end at its last column (the dead columns past it hold an
// invalid point, as past P2), so a pass never straddles two tiles and the
// hot loop carries no per-column flag; at tile 2048 (the G main path) the
// passes are #8's. A column that searched no pair gives v = 0 and no
// gradient, a row that searched none dh = 0 and a zero gradient row.
// Frames with x_valid == 0 write zeros and search nothing, before any
// barrier.
template <bool CULL>
__device__ __forceinline__ void dist_loss_body(
    const float* __restrict__ x, const float* __restrict__ n, const float4* __restrict__ y,
    const float* __restrict__ ctr, const float* __restrict__ og, const float* __restrict__ hg,
    const float* __restrict__ vw, const unsigned char* __restrict__ x_valid,
    const int* __restrict__ mask, float* __restrict__ v_out, float* __restrict__ dh_out,
    float* __restrict__ gx_do, float* __restrict__ gx_dh, int P1, int P2, int y_group,
    int R, int T, int tile) {
    extern __shared__ float4 smem[];
    const int P1r = bidir_rows_padded(P1);
    float4* xs = smem;                                                                 // [P1r]
    float4* ns = smem + P1r;                                                           // [P1r]
    unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + 2 * P1r);  // [P1r]
    float* acc = reinterpret_cast<float*>(key + P1r);  // [P1 * 3]
    const int f = blockIdx.x;
    const int g = f / y_group;
    float* vf = v_out + (size_t)f * P2;
    float* gf = gx_do + (size_t)f * P1 * 3;
    if (!x_valid[f]) {  // uniform over the block, before any barrier
        for (int j = threadIdx.x; j < P2; j += blockDim.x) vf[j] = 0.f;
        for (int i = threadIdx.x; i < P1; i += blockDim.x) dh_out[(size_t)f * P1 + i] = 0.f;
        float* hf = gx_dh + (size_t)f * P1 * 3;
        for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gf[k] = hf[k] = 0.f;
        return;
    }
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) acc[k] = 0.f;
    bidir_init_rows(xs, key, P1);
    o2h_stage_rows(xs, ns, x, n, ctr, f, g, P1);  // ends with a barrier

    const float4* yg = y + (size_t)g * P2;
    const float* ogf = og + (size_t)f * P2;
    if constexpr (CULL) {
        const int* mf = mask + (size_t)f * R * T;
        for (int t = 0; t < T; ++t) {
            unsigned run = 0;  // bit r: region r runs against tile t
            for (int r = 0; r < R; ++r) run |= (unsigned)(mf[r * T + t] != 0) << r;
            const int j1 = min((t + 1) * tile, P2);
            for (int j0 = t * tile; j0 < j1; j0 += BIDIR_PASS)
                dist_loss_pass<CULL>(xs, ns, key, acc, yg, ogf, vf, P1r, j0, j1, run);
        }
    } else {
        for (int j0 = 0; j0 < P2; j0 += BIDIR_PASS)
            dist_loss_pass<CULL>(xs, ns, key, acc, yg, ogf, vf, P1r, j0, P2, ~0u);
    }
    __syncthreads();  // every pass's atomics on the keys and gx_do are done
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gf[k] = acc[k];
    for (int i = threadIdx.x; i < P1; i += blockDim.x) {
        float best;
        int best_j;
        bidir_row(key[i], best, best_j);
        const size_t o = (size_t)f * P1 + i;
        const float4 xr = xs[i];
        dist_loss_h2o_row(dh_out, gx_dh, o, yg, best, best_j, !CULL || best < H2O_BIG,
                          xr.x, xr.y, xr.z, hg[o], vw[i]);
    }
}

// Dynamic shared memory of a dist_loss_body block: rows, normals and keys
// for P1 rounded up to whole groups, and the gx_do accumulator.
inline size_t dist_loss_smem(int P1) {
    return (size_t)bidir_rows_padded(P1) * BIDIR_SMEM_ROW + (size_t)P1 * 3 * sizeof(float);
}
