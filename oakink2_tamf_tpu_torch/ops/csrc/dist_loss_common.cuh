// The per-point arithmetic of the fused distance loss, shared by the
// all-pairs kernel (dist_loss.cu) and the region-culled one
// (dist_loss_cull.cu): once a column's or a row's first minimum is known,
// both compute its integrand and gradient row with these functions, so the
// two kernels agree bit for bit wherever they find the same minimum.
#pragma once

#include "o2h_common.cuh"

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
