// The single-pass bidirectional search of the signed kernels (nn_signed.cu,
// dist_loss.cu): for one frame, every (hand row i, object point j) pair's
// squared distance is computed once, by h2o_pair_d2, and that one value
// feeds both the column's running first minimum over the rows (o2h) and the
// row's running first minimum over the points (h2o).
//
// Layout: one block of BIDIR_THREADS threads per frame. The frame's centred
// rows and normals are staged in shared memory as float4 (o2h_stage_rows),
// beside one 64-bit word per row, its running first minimum
//   key = (float bits of d) << 32 | j.
// d >= +0, so the u32 order of the bits is the float order and the u64
// order is (value, index) order: the smallest key is the first minimum.
//
// A pass covers BIDIR_PASS columns. Each thread keeps BIDIR_COLS of them
// (strided by the block width, so neighbouring threads load and store
// neighbouring addresses) in registers and walks the rows in ascending
// groups of BIDIR_ROWS, each row read by one broadcast shared load:
//   column side: the group's minimum per column (fminf), a strict < against
//     the running one in registers, and after the pass the first row of the
//     winning group at that value: the first minimum over ascending i (a
//     strict < from BIG, so a column that no row beats keeps (BIG, 0));
//   row side: fminf over the thread's columns and a vote whether any lane's
//     minimum can reach the row's value (<=: a tie may still carry a
//     smaller index); only then a second vote whether (minimum, the lane's
//     first column) is below the whole key, and only then the warp's
//     minimum of the bits (redux.sync), the first j of the warp that holds
//     it (a second redux.sync) and a 64-bit shared atomicMin. The second
//     vote keeps frames whose pairs all tie (a padded object slot: zero
//     rows against a zero cloud) from merging on every row and pass. The
//     first vote's cost per (row, warp) is spread over 32 x BIDIR_COLS
//     pairs.
// A key is only ever lowered, so a stale read of it can only send a warp
// into the merge needlessly, never skip one. The row keys start at
// (BIG, 0): a pair below BIG takes the row, a row that finds none keeps
// (BIG, 0), as the h2o searches' strict < from BIG does. Dead columns past P2
// hold an invalid point (d ~ 3e30 > BIG): they win neither side.
//
// Shared memory of a block: rows, normals and keys for P1 rounded up to
// whole groups (bidir_smem_rows bytes per row).
#pragma once

#include "o2h_common.cuh"

#define BIDIR_THREADS 256
#define BIDIR_COLS 4
#define BIDIR_PASS (BIDIR_THREADS * BIDIR_COLS)  // columns per pass of a block
#define BIDIR_ROWS 8  // rows per group of the search
#define BIDIR_FULL 0xffffffffu

__device__ __forceinline__ unsigned long long bidir_key(unsigned d_bits, unsigned j) {
    return ((unsigned long long)d_bits << 32) | j;
}

// Every row's key to (BIG, 0). The caller's next barrier publishes them.
// P1 rounded up to whole row groups.
__host__ __device__ __forceinline__ int bidir_rows_padded(int P1) {
    return (P1 + BIDIR_ROWS - 1) / BIDIR_ROWS * BIDIR_ROWS;
}

// Shared bytes per padded row: its centred row, normal and key.
#define BIDIR_SMEM_ROW (2 * sizeof(float4) + sizeof(unsigned long long))

// Every row's key to (BIG, 0), and the rows past P1 of the last group
// staged at -1e15 per coordinate: their distance to any point, valid or
// invalid (+1e15), is above BIG (>= 3e30), so they win neither side. Call
// before o2h_stage_rows, whose barrier publishes them.
__device__ __forceinline__ void bidir_init_rows(float4* xs, unsigned long long* key, int P1) {
    const unsigned long long big = bidir_key(__float_as_uint(H2O_BIG), 0u);
    const int P1r = bidir_rows_padded(P1);
    for (int i = threadIdx.x; i < P1r; i += blockDim.x) key[i] = big;
    for (int i = P1 + threadIdx.x; i < P1r; i += blockDim.x) xs[i] = make_float4(-1e15f, -1e15f, -1e15f, 0.f);
}

// This thread's columns of the pass starting at j0 (dead ones: invalid).
__device__ __forceinline__ void bidir_load_cols(
    const float4* __restrict__ yg, int j0, int P2, float4 (&yv)[BIDIR_COLS]) {
#pragma unroll
    for (int c = 0; c < BIDIR_COLS; ++c) {
        const int j = j0 + c * BIDIR_THREADS + threadIdx.x;
        yv[c] = j < P2 ? yg[j] : make_float4(1e15f, 1e15f, 1e15f, 0.f);
    }
}

// One group of BIDIR_ROWS staged rows from i0 against the columns yv of the
// pass (j_lane: this lane's first column): the group's BIDIR_ROWS x
// BIDIR_COLS distances are reduced along both axes. The column side keeps
// only the first group whose minimum beats its running one (strict <,
// ascending groups: best_i is the group's first row until bidir_pass
// resolves it); the row side lowers the rows' keys.
__device__ __forceinline__ void bidir_group(
    const float4* xs, unsigned long long* key, int i0, unsigned j_lane,
    const float4 (&yv)[BIDIR_COLS], float (&best)[BIDIR_COLS], int (&best_i)[BIDIR_COLS]) {
    // the high (value) word of key[i] is key_d[2 i] (little-endian)
    const volatile unsigned* key_d = reinterpret_cast<const volatile unsigned*>(key) + 1;
    const volatile unsigned long long* key_v = key;
    float d[BIDIR_ROWS][BIDIR_COLS];
#pragma unroll
    for (int r = 0; r < BIDIR_ROWS; ++r) {
        const float4 xr = xs[i0 + r];
#pragma unroll
        for (int c = 0; c < BIDIR_COLS; ++c) d[r][c] = h2o_pair_d2(xr.x, xr.y, xr.z, yv[c]);
    }
#pragma unroll
    for (int c = 0; c < BIDIR_COLS; ++c) {  // column side: the group's minimum
        float m = d[0][c];
#pragma unroll
        for (int r = 1; r < BIDIR_ROWS; ++r) m = fminf(m, d[r][c]);
        if (m < best[c]) {  // strict over ascending groups: the first one wins
            best[c] = m;
            best_i[c] = i0;
        }
    }
#pragma unroll
    for (int r = 0; r < BIDIR_ROWS; ++r) {  // row side
        float m = d[r][0];
#pragma unroll
        for (int c = 1; c < BIDIR_COLS; ++c) m = fminf(m, d[r][c]);
        const unsigned mu = __float_as_uint(m);
        if (__any_sync(BIDIR_FULL, mu <= key_d[2 * (i0 + r)])  // warp-uniform
            && __any_sync(BIDIR_FULL, bidir_key(mu, j_lane) < key_v[i0 + r])) {
            const unsigned mb = __reduce_min_sync(BIDIR_FULL, mu);
            unsigned jb = 0xffffffffu;
#pragma unroll
            for (int c = BIDIR_COLS - 1; c >= 0; --c)  // this lane's first column at mb
                if (__float_as_uint(d[r][c]) == mb) jb = j_lane + c * BIDIR_THREADS;
            jb = __reduce_min_sync(BIDIR_FULL, jb);
            if ((threadIdx.x & 31) == 0) atomicMin(key + i0 + r, bidir_key(mb, jb));
        }
    }
}

// One pass over the staged rows for the columns yv of the pass at j0:
// returns each column's first minimum (best, best_i), and lowers the rows'
// keys with this pass's pairs. P1r is P1 rounded up to BIDIR_ROWS, the
// rows past P1 staged far away (bidir_init_rows). Called by every thread of
// the block, with warps whole (the redux and vote take all 32 lanes).
//
// The rows go in groups of BIDIR_ROWS (bidir_group), and after the pass the
// row inside a column's winning group is found again from the same pair
// values: the first row of the group whose distance equals the minimum.
// That is the first minimum over ascending rows, and the column side costs
// 3 instructions per group instead of per pair.
//
// CULL (the region-culled loss, dist_loss_cull.cu): only the 128-row
// regions r whose bit r of `run` is set are searched, in ascending order
// (at most 32 regions). A region is 16 whole groups, and `run` is the same
// for the whole block, so a skipped region costs no divergence. A column
// whose regions were all skipped keeps (BIG, 0), and so does a row of
// such a region.
template <bool CULL = false>
__device__ __forceinline__ void bidir_pass(
    const float4* xs, unsigned long long* key, int P1r, int j0,
    const float4 (&yv)[BIDIR_COLS], float (&best)[BIDIR_COLS], int (&best_i)[BIDIR_COLS],
    unsigned run = ~0u) {
#pragma unroll
    for (int c = 0; c < BIDIR_COLS; ++c) {
        best[c] = H2O_BIG;
        best_i[c] = 0;  // the first row of the winning group, until resolved
    }
    const unsigned j_lane = (unsigned)(j0 + threadIdx.x);
    if constexpr (CULL) {
        for (int r0 = 0; r0 < P1r; r0 += H2O_REGION_ROWS, run >>= 1) {
            if (!(run & 1u)) continue;  // block-uniform: the mask alone decides
            const int r1 = min(P1r, r0 + H2O_REGION_ROWS);
            for (int i0 = r0; i0 < r1; i0 += BIDIR_ROWS) bidir_group(xs, key, i0, j_lane, yv, best, best_i);
        }
    } else {
        for (int i0 = 0; i0 < P1r; i0 += BIDIR_ROWS) bidir_group(xs, key, i0, j_lane, yv, best, best_i);
    }
#pragma unroll
    for (int c = 0; c < BIDIR_COLS; ++c) {  // the first row of the group at the minimum
        if (best[c] < H2O_BIG) {  // a group won; else the column keeps (BIG, 0)
            int r = BIDIR_ROWS - 1;
#pragma unroll
            for (int q = BIDIR_ROWS - 2; q >= 0; --q) {
                const float4 xr = xs[best_i[c] + q];
                if (h2o_pair_d2(xr.x, xr.y, xr.z, yv[c]) == best[c]) r = q;
            }
            best_i[c] += r;
        }
    }
}

// A row's result from its final key.
__device__ __forceinline__ void bidir_row(unsigned long long k, float& d, int& j) {
    d = __uint_as_float((unsigned)(k >> 32));
    j = (int)(unsigned)(k & 0xffffffffull);
}

// Opts a kernel into `smem` bytes of dynamic shared memory where that is
// above the default 48 KB. Returns the CUDA error code.
template <typename K>
inline int bidir_smem_attr(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
