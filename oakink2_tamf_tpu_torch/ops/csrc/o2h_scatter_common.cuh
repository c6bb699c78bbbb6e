// The o2h scatter shared by kernels #7 (nn_signed_bwd.cu, its o2h side) and
// #13 (o2h_topk_bwd.cu): for one frame, with i* = o2h_i[j] and the
// cotangent yc_j,
//   acc_{i*} -= u_j,  u_j = yc_j (y_j - x_{i*})
// summed over the frame's points into a [P1, 3] accumulator in shared
// memory, and with GRAD_Y gy_j = u_j written for every point.
//
// What bounds it: bytes (each cotangent read once, the index and y row of
// each live point, the x rows they gather, gx written once). What held the
// first kernels far from that bound: each point issued three shared float
// atomicAdds on its row (a compare-and-swap loop each on this card), and
// the 32 lanes of a warp take 32 consecutive points of a spatially sorted
// cloud, whose nearest hand row they nearly always share, so each atomic
// retried up to 32 times.
//
// Design: a warp walks a contiguous chunk of the frame's points, 32 per
// step (O2H_UNROLL steps' operands loaded together), and adds to a hand row
// once per group of lanes on that row, not once per point.
// - The carried row (O2H_CARRY): the warp keeps one row; a lane whose point
//   falls on it adds u_j into its own three registers. When a step has no
//   point on that row, the warp sums the registers (xor shuffles), lane 0
//   adds the sum into the row, and the first live lane's row is carried
//   next. On the main paths' operands (~1.5 distinct rows per 32
//   consecutive points) most steps end there: no shuffle, no atomic.
// - The other rows of a step: __match_any_sync groups the lanes by row; a
//   segmented tree sums every group at once (log2 of the largest group's
//   size rounds of shuffles), and each group's first lane issues its row's
//   three atomicAdds, on distinct addresses.
// - A zero cotangent (invalid points, padded slots) and an index outside
//   [0, P1) issue nothing and give u_j = 0; their index and y row are not
//   read.
// scatter_variants.py times the macros' variants (numbers in PERF.md).
//
// The additions land in an order that depends on the warps' timing, so the
// accumulator is not bitwise reproducible: compare it within the float32
// sum bound. gy_j = u_j is one rounded product and is bit-equal to the
// plain version's.
#pragma once

#ifndef O2H_CARRY  // 1: the warp carries a row across steps, 0: every row goes to the tree
#define O2H_CARRY 1
#endif
#ifndef O2H_UNROLL  // steps whose operands are loaded before they are scattered
#define O2H_UNROLL 4
#endif
#ifndef O2H_THREADS  // threads per block (one block per frame)
#define O2H_THREADS 256
#endif

#define O2H_FULL 0xffffffffu

__device__ __forceinline__ float o2h_warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(O2H_FULL, v, o);
    return v;
}

// Subtract (s0, s1, s2) from row i of the accumulator.
__device__ __forceinline__ void o2h_add_row(float* acc, int i, float s0, float s1, float s2) {
    atomicAdd(&acc[3 * i + 0], -s0);
    atomicAdd(&acc[3 * i + 1], -s1);
    atomicAdd(&acc[3 * i + 2], -s2);
}

// Flush the carried row: the warp's registers summed, added by lane 0.
__device__ __forceinline__ void o2h_flush(float* acc, int carry, float& c0, float& c1, float& c2, int lane) {
    if (carry < 0) return;  // warp-uniform
    const float s0 = o2h_warp_sum(c0), s1 = o2h_warp_sum(c1), s2 = o2h_warp_sum(c2);
    if (lane == 0) o2h_add_row(acc, carry, s0, s1, s2);
    c0 = c1 = c2 = 0.f;
}

// The lanes with `mine` set, grouped by row i (peers: __match_any_sync
// over the rows, each group all mine), add their terms into their rows: a
// segmented tree sums every group at once (the lane of rank r adds its
// next remaining peer's partial sum; odd ranks drop out; log2 of the
// largest group's size rounds), then each group's first lane issues its
// row's three atomicAdds, on distinct addresses.
__device__ __forceinline__ void o2h_group_add(float* acc, bool mine, unsigned peers, int i, float s0,
                                              float s1, float s2, int lane) {
    unsigned above = mine ? peers & (0xfffffffeu << lane) : 0u;  // the peers after this lane
    const bool first = mine && (peers & ((1u << lane) - 1)) == 0;  // the group's first lane
    int rank = __popc(peers & ((1u << lane) - 1));
    while (__any_sync(O2H_FULL, above)) {
        const int next = (__ffs(above) - 1) & 31;  // lane 31 when there is none (unused)
        const float t0 = __shfl_sync(O2H_FULL, s0, next);
        const float t1 = __shfl_sync(O2H_FULL, s1, next);
        const float t2 = __shfl_sync(O2H_FULL, s2, next);
        if (above) {
            s0 += t0;
            s1 += t1;
            s2 += t2;
        }
        above &= ~__ballot_sync(O2H_FULL, rank & 1);
        rank >>= 1;
    }
    if (first) o2h_add_row(acc, i, s0, s1, s2);
}

// One step of 32 points: lane's point is live (ok) on row i with term u.
__device__ __forceinline__ void o2h_step(float* acc, bool ok, int i, float u0, float u1, float u2,
                                         int& carry, float& c0, float& c1, float& c2, int lane) {
    const unsigned live = __ballot_sync(O2H_FULL, ok);
    if (!live) return;
#if O2H_CARRY
    unsigned on = carry >= 0 ? __ballot_sync(O2H_FULL, ok && i == carry) : 0u;  // carry is warp-uniform
    if (!on) {  // the carried row has no point here: flush it, carry another
        o2h_flush(acc, carry, c0, c1, c2, lane);
        carry = __shfl_sync(O2H_FULL, i, __ffs(live) - 1);  // the first live lane's row
        on = __ballot_sync(O2H_FULL, ok && i == carry);
    }
    if ((on >> lane) & 1) {
        c0 += u0;
        c1 += u1;
        c2 += u2;
    }
    const unsigned rest = live & ~on;
#else
    const unsigned rest = live;
#endif
    if (!rest) return;
    // a rest lane's group holds rest lanes only: the carried row's lanes are not live & ~on
    o2h_group_add(acc, (rest >> lane) & 1, __match_any_sync(O2H_FULL, ok ? i : -1), i, u0, u1, u2, lane);
}

// The block's accumulator in dynamic shared memory, zeroed and synchronised
// before the scatter.
__device__ __forceinline__ void o2h_scatter_init(float* acc, int P1) {
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) acc[k] = 0.f;
    __syncthreads();
}

// The scatter of one frame's points (its rows xf, cloud yf, indices oi,
// cotangents yc, gy rows gyf) into the block's accumulator; the caller
// synchronises afterwards.
template <bool GRAD_Y>
__device__ __forceinline__ void o2h_scatter(float* acc, const float* __restrict__ xf,
                                            const float* __restrict__ yf, const int* __restrict__ oi,
                                            const float* __restrict__ yc, float* __restrict__ gyf,
                                            int P1, int P2) {
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    const int chunk = (P2 + 32 * n_warps - 1) / (32 * n_warps) * 32;
    const int begin = (threadIdx.x >> 5) * chunk, end = min(P2, begin + chunk);
    float c0 = 0.f, c1 = 0.f, c2 = 0.f;  // this lane's part of the carried row's sum
    int carry = -1;                      // the carried row (warp-uniform), -1: none
    for (int base = begin; base < end; base += 32 * O2H_UNROLL) {
        float c[O2H_UNROLL], y0[O2H_UNROLL], y1[O2H_UNROLL], y2[O2H_UNROLL];
        int i[O2H_UNROLL];
#pragma unroll
        for (int s = 0; s < O2H_UNROLL; ++s) {
            const int j = base + 32 * s + lane;
            c[s] = j < end ? yc[j] : 0.f;
        }
#pragma unroll
        for (int s = 0; s < O2H_UNROLL; ++s) {  // a dead point reads neither its index nor y
            const int j = base + 32 * s + lane;
            const bool live = c[s] != 0.f;
            i[s] = live ? oi[j] : -1;
            y0[s] = live ? yf[3 * j + 0] : 0.f;
            y1[s] = live ? yf[3 * j + 1] : 0.f;
            y2[s] = live ? yf[3 * j + 2] : 0.f;
        }
#pragma unroll
        for (int s = 0; s < O2H_UNROLL; ++s) {
            const int j = base + 32 * s + lane;
            const bool ok = (unsigned)i[s] < (unsigned)P1;
            float u0 = 0.f, u1 = 0.f, u2 = 0.f;
            if (ok) {  // one rounded difference and one rounded product, as the plain version
                u0 = __fmul_rn(c[s], y0[s] - xf[3 * i[s] + 0]);
                u1 = __fmul_rn(c[s], y1[s] - xf[3 * i[s] + 1]);
                u2 = __fmul_rn(c[s], y2[s] - xf[3 * i[s] + 2]);
            }
            if (GRAD_Y && j < end) {
                gyf[3 * j + 0] = u0;
                gyf[3 * j + 1] = u1;
                gyf[3 * j + 2] = u2;
            }
            o2h_step(acc, ok, i[s], u0, u1, u2, carry, c0, c1, c2, lane);
        }
    }
    o2h_flush(acc, carry, c0, c1, c2, lane);
}
