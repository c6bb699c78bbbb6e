// The hand->object (h2o) search of one block of 128 hand rows against a list
// of 128-point blocks of its object cloud ("cells"), in list order: each
// row's minimum of ||x_i - y_j||^2 over the listed cells' points and the
// first point reaching it, visiting the cells in list order with a strict <
// and each cell's points in ascending order. h2o_topk.cu (#10) runs it over
// a tile's K candidate cells; h2o_nn.cu (#1) and h2o_nn_dvec.cu (#4) run it
// over every cell of the cloud that holds a valid point, h2o_cull.cu (#2) and
// h2o_cull_dvec.cu (#3) over the cells the cull mask keeps for a 128-row
// region, each list ascending (h2o_cells_block below).
//
// Every pair goes through h2o_common.cuh's h2o_pair_d2, so the values are
// bit-identical to the other h2o kernels' on the pairs they share. A list
// entry that the caller's cell_start maps to -1 (an id out of range, or a
// cell without a valid point) is skipped: a cell of invalid points only
// (d ~ 3e30 > BIG) can never lower a row, so the skip is exact. A row that
// finds nothing keeps (BIG, 0).
//
// Layout: CELLS_THREADS threads, CELLS_SPLIT sets of warps. The warps of a
// set hold the block's 128 rows, CELLS_RPT rows per thread (lane l of a
// warp holds its rows l + 32 q, q < CELLS_RPT), and the sets split the
// list: set s takes the entries s, s + CELLS_SPLIT, ... Each warp stages
// its cell in its own 2 KB of shared memory (no block barrier), then walks
// the 128 points, one broadcast shared load per point feeding CELLS_RPT
// pairs. The fast path
// keeps only each row's fminf over a segment of CELLS_SEG points (the 6
// instructions of the distance and 1 per pair); after each segment a strict
// < against the running minimum records (value, list rank, segment). The
// sets' results merge per row in one 64-bit shared word, (value bits << 32
// | rank x segments + segment), by atomicMin: the lowest value wins, and on
// equal values the lowest rank and segment, which is what one sequential
// strict-< scan gives (d >= +0, so the u32 order of the bits is the float
// order). Then a warp per row re-scans the winning segment, one point per
// lane, for the first point at that value: the same pinned pair function,
// so the value is found again bit for bit.
#pragma once

#include "h2o_common.cuh"

#define CELL_PTS 128  // points per listed block (ops/chamfer_cluster.S_CELL); rows per search
#ifndef CELLS_RPT
#define CELLS_RPT 4  // rows per thread (1, 2 or 4)
#endif
#ifndef CELLS_SPLIT
#define CELLS_SPLIT 4  // sets of warps that split the list
#endif
#ifndef CELLS_SEG
#define CELLS_SEG 32  // points per segment: a multiple of 32 that divides 128
#endif
#ifndef CELLS_MIN_BLOCKS
#define CELLS_MIN_BLOCKS 8  // __launch_bounds__' blocks per SM of the kernels that run it
#endif
#define CELLS_SET_WARPS (CELL_PTS / (32 * CELLS_RPT))  // warps that hold the 128 rows
#define CELLS_WARPS (CELLS_SET_WARPS * CELLS_SPLIT)
#define CELLS_THREADS (32 * CELLS_WARPS)
#define CELLS_NSEG (CELL_PTS / CELLS_SEG)

// Shared memory of a search: the staged rows, each warp's cell, the rows'
// merge words.
struct CellsShared {
    float4 xs[CELL_PTS];  // centred rows
    float4 ys[CELLS_WARPS][CELL_PTS];
    unsigned long long key[CELL_PTS];
};

__device__ __forceinline__ unsigned long long cells_key(float d, unsigned rank) {
    return ((unsigned long long)__float_as_uint(d) << 32) | rank;
}

// One warp's walk over its share of the list (entries set, set +
// CELLS_SPLIT, ...) for its first NQ rows per lane: each live cell staged in
// the warp's ys, then per segment each row's fminf, and a strict < against
// its running minimum that records (rank x segments + segment).
template <int NQ, typename CellStart>
__device__ __forceinline__ void cells_walk(
    float4* ys, const float (&xr)[CELLS_RPT][3], float (&best)[CELLS_RPT], unsigned (&rank)[CELLS_RPT],
    const float4* __restrict__ yg, int P2, int K, int set, int lane, CellStart cell_start) {
    for (int k = set; k < K; k += CELLS_SPLIT) {
        const int c0 = cell_start(k);
        if (c0 < 0) continue;  // warp-uniform: the list and the flags alone decide
        __syncwarp();  // the previous cell's reads are done
        for (int s = lane; s < CELL_PTS; s += 32)
            ys[s] = c0 + s < P2 ? yg[c0 + s] : make_float4(1e15f, 1e15f, 1e15f, 0.f);
        __syncwarp();
#pragma unroll
        for (int seg = 0; seg < CELLS_NSEG; ++seg) {
            float m[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) m[q] = H2O_BIG;
#pragma unroll 8
            for (int s = seg * CELLS_SEG; s < (seg + 1) * CELLS_SEG; ++s) {
                const float4 yv = ys[s];
#pragma unroll
                for (int q = 0; q < NQ; ++q)
                    m[q] = fminf(m[q], h2o_pair_d2(xr[q][0], xr[q][1], xr[q][2], yv));
            }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                if (m[q] < best[q]) {  // strict: list order, then ascending segments
                    best[q] = m[q];
                    rank[q] = (unsigned)(k * CELLS_NSEG + seg);
                }
            }
        }
    }
}

// cells_walk<nq> for a warp-uniform nq in [0, N]; nq = 0 walks nothing.
template <int N, typename CellStart>
__device__ __forceinline__ void cells_walk_dispatch(
    int nq, float4* ys, const float (&xr)[CELLS_RPT][3], float (&best)[CELLS_RPT], unsigned (&rank)[CELLS_RPT],
    const float4* __restrict__ yg, int P2, int K, int set, int lane, CellStart cell_start) {
    if (nq == N) {
        cells_walk<N>(ys, xr, best, rank, yg, P2, K, set, lane, cell_start);
    } else if constexpr (N > 1) {
        cells_walk_dispatch<N - 1>(nq, ys, xr, best, rank, yg, P2, K, set, lane, cell_start);
    }
}

// The search of rows [row0, row0 + 128) of frame f (cloud g, centred on
// ctr[g]) against the K listed cells of the cloud yg [P2] (centred, invalid
// points at 1e15): cell_start(k) is the first point of the k-th listed cell
// (a multiple of 128), or -1 to skip it, the same for every thread.
// emit(row, d, j) is called once per row below P1, by lane 0 of a warp,
// with the minimum and the first point j reaching it ((BIG, 0) when none
// does). With FIRST_POINT = false no point is looked for: emit(row, d, 0)
// is called by thread row - row0, and the winning segment is not re-scanned.
// Called by all CELLS_THREADS threads of the block.
template <bool FIRST_POINT = true, typename CellStart, typename Emit>
__device__ __forceinline__ void h2o_cells_search(
    CellsShared& sh, const float* __restrict__ x, const float* __restrict__ ctr,
    int f, int g, int row0, int P1, const float4* __restrict__ yg, int P2, int K,
    CellStart cell_start, Emit emit) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = threadIdx.x; r < CELL_PTS; r += CELLS_THREADS) {
        float x0, x1, x2;  // rows past P1 load 0 and are never emitted
        h2o_load_row(x, ctr, f, g, row0 + r, P1, x0, x1, x2);
        sh.xs[r] = make_float4(x0, x1, x2, 0.f);
        sh.key[r] = cells_key(H2O_BIG, 0u);
    }
    __syncthreads();

    const int set = warp / CELLS_SET_WARPS;
    const int rbase = (warp % CELLS_SET_WARPS) * 32 * CELLS_RPT + lane;
    float xr[CELLS_RPT][3];
    float best[CELLS_RPT];
    unsigned rank[CELLS_RPT];
#pragma unroll
    for (int q = 0; q < CELLS_RPT; ++q) {
        const float4 v = sh.xs[rbase + 32 * q];
        xr[q][0] = v.x;
        xr[q][1] = v.y;
        xr[q][2] = v.z;
        best[q] = H2O_BIG;
        rank[q] = 0u;
    }
    // the warp's rows below P1 fill its first nq of CELLS_RPT rows per lane
    // (rows lane + 32 q): a ragged last block (10 of MANO's 778 rows) walks
    // its cells with the others left out
    const int nq = min(CELLS_RPT, max(0, P1 - row0 - (rbase - lane) + 31) / 32);
    cells_walk_dispatch<CELLS_RPT>(nq, sh.ys[warp], xr, best, rank, yg, P2, K, set, lane, cell_start);
#pragma unroll
    for (int q = 0; q < CELLS_RPT; ++q)
        if (best[q] < H2O_BIG) atomicMin(&sh.key[rbase + 32 * q], cells_key(best[q], rank[q]));
    __syncthreads();

    if constexpr (!FIRST_POINT) {
        for (int r = threadIdx.x; r < CELL_PTS; r += CELLS_THREADS)
            if (row0 + r < P1) emit(row0 + r, __uint_as_float((unsigned)(sh.key[r] >> 32)), 0);
        return;
    }
    for (int r = warp; r < CELL_PTS; r += CELLS_WARPS) {  // one warp per row
        if (row0 + r >= P1) continue;
        const unsigned long long kk = sh.key[r];
        const float d = __uint_as_float((unsigned)(kk >> 32));
        int j = 0;
        if (d < H2O_BIG) {  // the first point of the winning segment at d
            const unsigned rk = (unsigned)(kk & 0xffffffffull);
            const int s0 = cell_start((int)(rk / CELLS_NSEG)) + (int)(rk % CELLS_NSEG) * CELLS_SEG;
            const float4 v = sh.xs[r];
            for (int s = s0; s < s0 + CELLS_SEG; s += 32) {
                const int jj = s + lane;
                const bool hit = jj < P2 && h2o_pair_d2(v.x, v.y, v.z, yg[jj]) == d;
                const unsigned b = __ballot_sync(0xffffffffu, hit);
                if (b) {
                    j = s + __ffs(b) - 1;
                    break;
                }
            }
        }
        if (lane == 0) emit(row0 + r, d, j);
    }
}

// What a listed-cells block writes per row below P1: the minimum only (#2),
// the minimum and its first point (#1), or the minimum and dvec = x - y at
// its first point (#3, #4).
enum CellsOut { CELLS_MIN, CELLS_INDEX, CELLS_DVEC };

// The search of one (frame f, 128-row region r) block over the cells of the
// cloud that keep(f, r, g, c) lists, ascending: the body of #1 and #4 (every
// cell of cloud g holding a valid point, from the per-group cell flags) and
// of #2 and #3 (the cells of the tiles the cull mask row mask[f, r, :]
// keeps). Warp 0 lists the cells' first points in dynamic shared memory
// (kept[], C = ceil(P2 / CELL_PTS) ints at most) before the search, so the
// warp sets split the listed cells evenly and the walk has no skipped
// entries; the list rank orders the cells as their index does, so the
// search's first minimum is the first in ascending point order over the
// listed cells. A row with no listed cell (an all-invalid cloud, every cell
// culled) keeps (BIG, 0): CELLS_DVEC writes dvec = 0 there. Only the output
// pointers of OUT are read: i_out for CELLS_INDEX, dvec for CELLS_DVEC.
template <CellsOut OUT, typename Keep>
__device__ __forceinline__ void h2o_cells_block(
    const float* __restrict__ x, const float4* __restrict__ y, const float* __restrict__ ctr,
    float* __restrict__ d_out, int* __restrict__ i_out, float* __restrict__ dvec,
    int P1, int P2, int y_group, int R, Keep keep) {
    __shared__ CellsShared sh;
    __shared__ int n_kept;
    extern __shared__ int kept[];
    const long long blk = blockIdx.x;
    const int f = (int)(blk / R);
    const int r = (int)(blk - (long long)f * R);
    const int g = f / y_group;
    const int C = (P2 + CELL_PTS - 1) / CELL_PTS;
    const float4* yg = y + (size_t)g * P2;
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        int n = 0;
        for (int c0 = 0; c0 < C; c0 += 32) {
            const int c = c0 + lane;
            const bool listed = c < C && keep(f, r, g, c);
            const unsigned b = __ballot_sync(0xffffffffu, listed);
            if (listed) kept[n + __popc(b & ((1u << lane) - 1u))] = c * CELL_PTS;
            n += __popc(b);
        }
        if (lane == 0) n_kept = n;
    }
    __syncthreads();
    const int row0 = r * CELL_PTS;
    h2o_cells_search<OUT != CELLS_MIN>(
        sh, x, ctr, f, g, row0, P1, yg, P2, n_kept,
        [&](int k) { return kept[k]; },
        [&](int row, float d, int j) {
            const size_t o = (size_t)f * P1 + row;
            if constexpr (OUT == CELLS_DVEC) {
                const float4 v = sh.xs[row - row0];
                h2o_write_dvec(d_out, dvec, o, yg, d, j, v.x, v.y, v.z);
            } else {
                d_out[o] = d;
                if constexpr (OUT == CELLS_INDEX) i_out[o] = j;
            }
        });
}

// The dynamic shared memory of h2o_cells_block's kernel for a cloud of P2
// points (its cell list). Above the 48 KB a launch may take without asking
// (clouds of more than ~9500 cells) the kernel is allowed more here; past
// the card's 227 KB the launch fails and the wrapper raises.
template <typename Kernel>
__host__ size_t h2o_cells_smem(Kernel kernel, int P2) {
    const size_t smem = (size_t)((P2 + CELL_PTS - 1) / CELL_PTS) * sizeof(int);
    if (smem + sizeof(CellsShared) + sizeof(int) > 48 * 1024)
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return smem;
}
