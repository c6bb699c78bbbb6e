// Cluster-pruned object->hand nearest neighbour (o2h) with the sign
// numerator: kernel #12 (the o2h half of the cluster route's signed pair;
// its h2o half is h2o_topk.cu).
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_cluster.py
// `_o2h_topk_kernel` (:801, pallas_call in `_signed_cluster_forward` at
// :920). For frame f, each object point y_j of 128-point cell c searches
// the hand tiles cidx_y[f, c, :] (128 rows each of the template-permuted
// hand, chosen by ops/chamfer_cluster.o2h_select; 0..T-1 in order when
// k_tiles is 0, the default) and returns
//   o2h_d: min over the candidate rows i of ||x_i - y_j||^2,
//   o2h_i: the first row i* reaching it (permuted row index; the wrapper
//          maps it back to the caller's order),
//   o2h_dot: the sign numerator n_{i*} . (y_j - x_{i*}),
// visiting tiles in candidate order with a strict < and each tile's rows in
// ascending order, as the TPU's per-tile argmin and `m < best_d` do. With
// k_tiles = 0 that is the first minimum over all rows in ascending order:
// the o2h half of nn_signed.cu, bit for bit (every pair through
// h2o_common.cuh's h2o_pair_d2, the numerator through o2h_common.cuh's
// o2h_sign_numer, rows centred with __fsub_rn as o2h_stage_rows centres
// them). A list id outside [0, T) is skipped. Rows past P1 (the last tile's
// pad) are never read and never win. A point that finds nothing (an
// invalid one, at 1e15) keeps (BIG, 0, n_0 . (y_j - x_0)), as the plain
// version writes it, and so does every point of a skipped cell.
//
// Bound: floating-point work, 8 flops per pair that can count: the valid
// points against the rows of their cells' candidate tiles. At the R shape
// (40960 frames x 778 rows x 8192 per-frame points, k_tiles 0; the frames
// of padded object slots hold no valid point) that is 2.20e8 points x 778
// rows = 1.71e11 pairs, 20.5 ms at the H100 SXM's 67 TFLOP/s FP32; it
// issues at least 7 instructions per pair (the pinned distance's 6 and a
// minimum), a floor of 35.8 ms at 33.45e12 lane-instructions/s.
//
// Design: one block of O2H_WARPS (8) warps per frame (or per O2H_CELLS
// cells of a frame). The block stages the frame's centred rows once, as
// float4 in shared memory (12.8 KB for 778 rows, padded to a whole segment
// with rows at +inf, which never win), and only where one of its cells
// holds a valid point (the wrapper's `live` flags, ops/chamfer_nn.
// cell_flags): a frame without one stages nothing and searches nothing,
// and its points get what finding nothing gives. The warps split the
// block's live cells by rank; a warp holds a cell's points in registers,
// O2H_PPL (4) per lane, and walks the cell's candidate list (the same for
// every lane): each broadcast row load feeds 4 pairs. The hot loop keeps
// only each point's fminf over a segment of O2H_SEG (32) rows, in steps of
// O2H_UNROLL (16) rows (the distance's 6 instructions and 1 per pair);
// after each segment a strict < against the running minimum records (list
// rank, segment). Then each lane re-scans its points' winning segments for
// the first row at that value, O2H_RESCAN (4) rows at a time, with the
// same pair function, so the value is found again bit for bit. The last
// tile (10 rows of MANO's 778) walks one segment, not four. The winner's
// normal is one global load per point.
//
// Measured with topk_variants.py --o2h on an NVIDIA H100 80GB HBM3 (power
// limit 700.00 W) at that shape: 48.6 ms (the previous design, one block
// of 128 threads per (frame, cell), one point per thread, every cell
// searched and the hand staged per cell, 101.6 ms in the same run; this
// one without the skip 73.2-73.7 ms), 7.391 SASS instructions per pair in
// the hot loop, 80% of the issue rate on the 1.76e11 pairs it searches.
// ptxas: 64 registers. A fully unrolled 32-row step (950 instructions, 15
// KB of code) took 54.1-54.3 ms with fewer instructions per pair than 2
// points per lane (49.1-49.7): the hot loop's code size mattered more than
// its count (the instruction cache, presumably; no counter shows it). 4 or
// 8 cells per block (the hand staged 16 or 8 times per frame) cost ~2%; 8
// points per lane (two half-warps splitting the list, since removed)
// spilled at 80 registers (57.9).

#include "o2h_common.cuh"

#define O2H_CELL 128  // points per cell (ops/chamfer_cluster.S_CELL), rows per tile
#ifndef O2H_PPL
#define O2H_PPL 4  // points per lane: 1, 2 or 4
#endif
#ifndef O2H_WARPS
#define O2H_WARPS 8  // warps per block
#endif
#ifndef O2H_CELLS
#define O2H_CELLS 0  // cells per block; 0: one block per frame
#endif
#ifndef O2H_SEG
#define O2H_SEG 32  // rows per segment: divides 128
#endif
#ifndef O2H_UNROLL
#define O2H_UNROLL 16  // rows per step of the hot loop: divides O2H_SEG
#endif
#ifndef O2H_RESCAN
#define O2H_RESCAN 4  // rows per step of the re-scan: divides O2H_SEG
#endif
#ifndef O2H_MIN_BLOCKS
#define O2H_MIN_BLOCKS 4  // __launch_bounds__' blocks per SM
#endif
#define O2H_THREADS (32 * O2H_WARPS)
#define O2H_NSEG (O2H_CELL / O2H_SEG)
#define O2H_CHUNK (32 * O2H_PPL)          // points a warp searches at once
#define O2H_CHUNKS (O2H_CELL / O2H_CHUNK)  // of a cell

// A cell without a valid point: (BIG, 0, numerator at row 0) for its points.
__device__ __forceinline__ void o2h_dead_cell(
    const float* __restrict__ x, const float* __restrict__ n, const float4* __restrict__ yf,
    const float* __restrict__ ctr, float* __restrict__ o2h_d, int* __restrict__ o2h_i,
    float* __restrict__ o2h_dot, int f, int c, int lane, int P1, int P2) {
    // centred row 0 and its normal: what a point that finds nothing reads
    const float* xp = x + (size_t)f * P1 * 3;
    const float* np_ = n + (size_t)f * P1 * 3;
    const float4 xr = make_float4(__fsub_rn(xp[0], ctr[3 * f + 0]), __fsub_rn(xp[1], ctr[3 * f + 1]),
                                  __fsub_rn(xp[2], ctr[3 * f + 2]), 0.f);
    const float4 nr = make_float4(np_[0], np_[1], np_[2], 0.f);
    for (int s = lane; s < O2H_CELL; s += 32) {
        const int j = c * O2H_CELL + s;
        if (j >= P2) break;
        const size_t o = (size_t)f * P2 + j;
        o2h_d[o] = H2O_BIG;
        o2h_i[o] = 0;
        o2h_dot[o] = o2h_sign_numer(xr, nr, yf[j]);
    }
}

// One warp's search of chunk h of live cell c over its list cl[0, Kx).
__device__ __forceinline__ void o2h_search_chunk(
    const float4* __restrict__ xs, const float* __restrict__ n, const float4* __restrict__ yf,
    const int* __restrict__ cl, float* __restrict__ o2h_d, int* __restrict__ o2h_i,
    float* __restrict__ o2h_dot, int f, int c, int h, int lane, int P1, int P2, int Kx) {
    const int j0 = c * O2H_CELL + h * O2H_CHUNK + lane;
    const int T = (P1 + O2H_CELL - 1) / O2H_CELL;
    float4 yq[O2H_PPL];
    float best[O2H_PPL];
    unsigned rank[O2H_PPL];
#pragma unroll
    for (int q = 0; q < O2H_PPL; ++q) {
        const int j = j0 + 32 * q;  // the last cell's pad: far away, never written
        yq[q] = j < P2 ? yf[j] : make_float4(1e15f, 1e15f, 1e15f, 0.f);
        best[q] = H2O_BIG;
        rank[q] = 0u;
    }
    for (int k = 0; k < Kx; ++k) {
        const int t = cl[k];
        if ((unsigned)t >= (unsigned)T) continue;  // never written by the selection
        // the tile's rows, rounded up to a segment (the pad rows sit at +inf)
        const int nseg = min(O2H_NSEG, (P1 - t * O2H_CELL + O2H_SEG - 1) / O2H_SEG);
        const float4* xt = xs + t * O2H_CELL;
        for (int seg = 0; seg < nseg; ++seg) {
            float m[O2H_PPL];
#pragma unroll
            for (int q = 0; q < O2H_PPL; ++q) m[q] = H2O_BIG;
#pragma unroll 1
            for (int r0 = seg * O2H_SEG; r0 < (seg + 1) * O2H_SEG; r0 += O2H_UNROLL) {
#pragma unroll
                for (int r = 0; r < O2H_UNROLL; ++r) {
                    const float4 xr = xt[r0 + r];
#pragma unroll
                    for (int q = 0; q < O2H_PPL; ++q)
                        m[q] = fminf(m[q], h2o_pair_d2(xr.x, xr.y, xr.z, yq[q]));
                }
            }
#pragma unroll
            for (int q = 0; q < O2H_PPL; ++q) {
                if (m[q] < best[q]) {  // strict: list order, then ascending segments
                    best[q] = m[q];
                    rank[q] = (unsigned)(k * O2H_NSEG + seg);
                }
            }
        }
    }
#pragma unroll
    for (int q = 0; q < O2H_PPL; ++q) {
        const int j = j0 + 32 * q;
        if (j >= P2) continue;
        int i = 0;
        if (best[q] < H2O_BIG) {  // the first row of the winning segment at that value
            const int r0 = cl[rank[q] / O2H_NSEG] * O2H_CELL + (int)(rank[q] % O2H_NSEG) * O2H_SEG;
            // O2H_RESCAN rows at a time, each step's last to first without a
            // branch (independent loads; the last hit is the step's first)
            for (int g = r0; g < r0 + O2H_SEG; g += O2H_RESCAN) {
                int hit = -1;
#pragma unroll
                for (int r = O2H_RESCAN - 1; r >= 0; --r) {
                    const float4 xr = xs[g + r];
                    if (h2o_pair_d2(xr.x, xr.y, xr.z, yq[q]) == best[q]) hit = g + r;
                }
                if (hit >= 0) {
                    i = hit;
                    break;
                }
            }
        }
        const size_t o = (size_t)f * P2 + j;
        const float* np_ = n + ((size_t)f * P1 + i) * 3;
        o2h_d[o] = best[q];
        o2h_i[o] = i;
        o2h_dot[o] = o2h_sign_numer(xs[i], make_float4(np_[0], np_[1], np_[2], 0.f), yq[q]);
    }
}

__global__ void __launch_bounds__(O2H_THREADS, O2H_MIN_BLOCKS)
o2h_topk_kernel(const float* __restrict__ x,      // [F, P1, 3] permuted rows
                const float* __restrict__ n,      // [F, P1, 3] permuted normals
                const float4* __restrict__ y,     // [F, P2] centred, invalid at FAR
                const float* __restrict__ ctr,    // [F, 3]
                const int* __restrict__ cidx_y,   // [F, C, Kx] candidate tiles
                const unsigned char* __restrict__ live,  // [F, C] the cell holds a valid point
                float* __restrict__ o2h_d,        // [F, P2]
                int* __restrict__ o2h_i,          // [F, P2]
                float* __restrict__ o2h_dot,      // [F, P2]
                int P1, int P2, int C, int Kx, int blocks_per_frame) {
    extern __shared__ float4 xs[];  // the frame's centred rows, padded to a whole segment
    const long long blk = blockIdx.x;
    const int f = (int)(blk / blocks_per_frame);
    const int b = (int)(blk - (long long)f * blocks_per_frame);
    const int c0 = O2H_CELLS > 0 ? b * O2H_CELLS : 0;
    const int c1 = O2H_CELLS > 0 ? min(C, c0 + O2H_CELLS) : C;
    const unsigned char* lv = live + (size_t)f * C;
    int any = 0;
    for (int c = c0 + threadIdx.x; c < c1; c += O2H_THREADS) any |= lv[c];
    if (__syncthreads_or(any)) {  // block-uniform: stage only for a cell to search
        const float k0 = ctr[3 * f + 0], k1 = ctr[3 * f + 1], k2 = ctr[3 * f + 2];
        const float inf = __int_as_float(0x7f800000);
        const int rows = (P1 + O2H_SEG - 1) / O2H_SEG * O2H_SEG;
        for (int i = threadIdx.x; i < rows; i += O2H_THREADS) {
            if (i < P1) {
                const float* xp = x + ((size_t)f * P1 + i) * 3;
                xs[i] = make_float4(__fsub_rn(xp[0], k0), __fsub_rn(xp[1], k1), __fsub_rn(xp[2], k2), 0.f);
            } else {
                xs[i] = make_float4(inf, inf, inf, 0.f);
            }
        }
        __syncthreads();
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float4* yf = y + (size_t)f * P2;
    // the block's cells 32 at a time: warp w takes the live chunks and the
    // dead cells whose rank is w modulo O2H_WARPS (the same for every lane)
    int live_rank = 0, dead_rank = 0;
    for (int cb = c0; cb < c1; cb += 32) {
        const int c = cb + lane;
        const bool in = c < c1;
        const bool l = in && lv[c];
        unsigned bl = __ballot_sync(0xffffffffu, l);
        unsigned bd = __ballot_sync(0xffffffffu, in && !l);
        while (bl) {
            const int cc = cb + __ffs(bl) - 1;
            bl &= bl - 1;
            for (int h = 0; h < O2H_CHUNKS; ++h, ++live_rank)
                if (live_rank % O2H_WARPS == warp)
                    o2h_search_chunk(xs, n, yf, cidx_y + ((size_t)f * C + cc) * Kx, o2h_d, o2h_i, o2h_dot,
                                     f, cc, h, lane, P1, P2, Kx);
        }
        while (bd) {
            const int cc = cb + __ffs(bd) - 1;
            bd &= bd - 1;
            if (dead_rank++ % O2H_WARPS == warp)
                o2h_dead_cell(x, n, yf, ctr, o2h_d, o2h_i, o2h_dot, f, cc, lane, P1, P2);
        }
    }
}

extern "C" int o2h_topk_launch(const float* x, const float* n, const float4* y, const float* ctr,
                               const int* cidx_y, const unsigned char* live, float* o2h_d, int* o2h_i,
                               float* o2h_dot, int F, int P1, int P2, int C, int Kx, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const int per_frame = O2H_CELLS > 0 ? (C + O2H_CELLS - 1) / O2H_CELLS : 1;
    const size_t smem = (size_t)((P1 + O2H_SEG - 1) / O2H_SEG * O2H_SEG) * sizeof(float4);
    o2h_topk_kernel<<<(unsigned)((long long)F * per_frame), O2H_THREADS, smem, stream>>>(
        x, n, y, ctr, cidx_y, live, o2h_d, o2h_i, o2h_dot, P1, P2, C, Kx, per_frame);
    return (int)cudaGetLastError();
}
