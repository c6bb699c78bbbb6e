// The h2o cull mask: the compute flags [F, R, T] that kernels #2 and #3
// (h2o_cull.cu, h2o_cull_dvec.cu) read, written straight from the region
// statistics of ops/chamfer_cull.region_stats.
//
// Replaces no TPU kernel: oakink2_tamf_tpu/ops/chamfer_cull.py `_cull_mask`
// (:84) is plain XLA, and the port's plain version (chamfer_cull.plain_mask)
// builds the whole [groups, L*R, P2] centroid-to-point field in device
// memory, about six full passes over it per call. Added for speed: the
// flags need only the centroids, the radii and the centred clouds read once
// and the flags written once. For frame f = g*L + l, hand region r with
// centroid c = cg[g, l*R + r] and radius rr[f, r], and object tile t of
// `tile` points (a multiple of 128):
//   d_t  = min over the valid points j of tile t of |c - y_j| (inf if none),
//   dmin = min_t d_t,
//   run  = (d_t - rr <= (dmin + rr) + 1e-3) & isfinite(d_t) & x_valid[f].
// Points past P2 and invalid points count as inf, so an all-invalid cloud
// (a padded object slot) culls every block, and x_valid=False frames are
// written 0 without a search.
//
// Bound: the centroid-point distances, 7 instructions per (live centroid,
// point) pair (the pinned difference's 6 and a minimum) on the FP32 pipes;
// the bytes (cg, rr, y, y_valid, x_valid read, the int32 flags written) are
// far below it. The distance is the direct difference (c - y)^2 of
// h2o_common.cuh, in full float32, not the expansion of
// chamfer_cull.centroid_d2: at least as exact, and the 1e-3 m slack covers
// both roundings, so a flag can differ from the plain version's only on a
// block whose margin lies within rounding of the threshold. The searches'
// values never depend on it (a culled block's pairs are strictly farther
// than each row's minimum).
//
// Design: one block of MASK_THREADS per (group, slice of MASK_CPB
// consecutive centroids of the group's L*R). A block whose group has no
// valid point, or whose centroids all belong to x_valid=False frames,
// writes its zeros and stops. Otherwise the block stages the group's points
// MASK_CHUNK at a time in shared memory as float4, an invalid point or one
// past P2 at +inf (so its squared distance is inf, never NaN); each thread
// holds MASK_CPT consecutive centroids in registers, so one broadcast
// shared load feeds MASK_CPT pairs, and keeps each tile's running minimum
// of the squared distance, walking the tile's 128-point cells. A thread
// whose centroids all belong to x_valid=False frames skips the search. At a
// tile's end the thread puts d_t into shared memory ([CPT][T][THREADS + 1]
// floats, so neither the search's stores nor the write-out's loads
// conflict), and keeps the min of the squared minima: dmin = sqrt of it,
// since a rounded sqrt is monotonic. Last, the block writes its centroids'
// flags row after row, T consecutive int32 per centroid, consecutive
// threads on consecutive addresses.
//
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at 40960 frames x 778 rows x
// 8192 points, y_group 160, tile 128: 0.935 ms with 85% of the frames live
// (issue floor 0.419 ms), 0.48 ms with a third live; the plain version
// 48.7 ms. ptxas: 48 registers, no spills; 7.66 SASS instructions per pair
// in the hot loop. Other shapes of the block (threads x centroids per
// thread x chunk) were within 4% or slower: 128x1x512 0.895 ms, 256x1x512
// 0.965, 64x2x1024 1.049, 64x4x512 1.208.

#include "h2o_common.cuh"

#ifndef MASK_THREADS
#define MASK_THREADS 64
#endif
#ifndef MASK_CPT
#define MASK_CPT 2  // centroids per thread
#endif
#ifndef MASK_CHUNK
#define MASK_CHUNK 512  // points staged per step, a multiple of 128
#endif
#define MASK_CPB (MASK_THREADS * MASK_CPT)  // centroids per block
#define MASK_CELL 128
#define MASK_SLACK 1e-3f  // chamfer_cull.plain_mask's slack, in metres

static_assert(MASK_CHUNK % MASK_CELL == 0, "MASK_CHUNK must be a multiple of 128 points");

__host__ __device__ inline size_t mask_smem(int T) {
    return (size_t)MASK_CHUNK * sizeof(float4)
         + (size_t)MASK_CPT * T * (MASK_THREADS + 1) * sizeof(float)
         + 2 * (size_t)MASK_CPB * sizeof(float);
}

__global__ void __launch_bounds__(MASK_THREADS)
h2o_cull_mask_kernel(const float* __restrict__ cg,               // [G, L*R, 3] centred centroids
                     const float* __restrict__ rr,               // [F, R] region radii
                     const float* __restrict__ y,                // [G, P2, 3] centred points
                     const unsigned char* __restrict__ y_valid,  // [G, P2] or null (all valid)
                     const unsigned char* __restrict__ x_valid,  // [F] or null (all live)
                     int* __restrict__ flags,                    // [F, R, T]
                     int P2, int R, int C, int T, int tile, int blocks_per_group) {
    extern __shared__ float4 mask_shared[];
    float4* ys = mask_shared;                                       // [MASK_CHUNK]
    float* sd = reinterpret_cast<float*>(ys + MASK_CHUNK);          // [CPT][T][THREADS + 1]
    float* s_thr = sd + (size_t)MASK_CPT * T * (MASK_THREADS + 1);  // [CPB] (dmin + rr) + slack, NaN if dead
    float* s_rr = s_thr + MASK_CPB;                                 // [CPB]

    const int tid = threadIdx.x;
    const int g = blockIdx.x / blocks_per_group;
    const int c0 = (blockIdx.x % blocks_per_group) * MASK_CPB;  // first centroid of the group's slice
    const int n_c = min(MASK_CPB, C - c0);
    const int k0 = g * C + c0;  // its flat index f*R + r

    // this thread's centroids: block slots tid*CPT + i
    float cx[MASK_CPT], cy[MASK_CPT], cz[MASK_CPT];
    bool live[MASK_CPT];
    bool any_live = false;
    for (int i = 0; i < MASK_CPT; ++i) {
        const int c = tid * MASK_CPT + i;
        const int k = k0 + c;
        live[i] = c < n_c && (x_valid == nullptr || x_valid[k / R] != 0);
        cx[i] = live[i] ? cg[3 * (size_t)k + 0] : 0.f;
        cy[i] = live[i] ? cg[3 * (size_t)k + 1] : 0.f;
        cz[i] = live[i] ? cg[3 * (size_t)k + 2] : 0.f;
        any_live |= live[i];
    }
    bool has_point = y_valid == nullptr;
    if (!has_point)
        for (int p = tid; p < P2; p += MASK_THREADS) has_point |= y_valid[(size_t)g * P2 + p] != 0;
    const bool block_live = __syncthreads_or(any_live) && __syncthreads_or(has_point);
    if (!block_live) {  // padded object slot or x_valid=False frames only: every block culled
        for (int idx = tid; idx < n_c * T; idx += MASK_THREADS) flags[(size_t)k0 * T + idx] = 0;
        return;
    }

    const float inf = __int_as_float(0x7f800000);
    const int cells = (P2 + MASK_CELL - 1) / MASK_CELL;
    const int cells_per_tile = tile / MASK_CELL;
    float m[MASK_CPT], m_all[MASK_CPT];
    for (int i = 0; i < MASK_CPT; ++i) m[i] = m_all[i] = inf;
    const float* yg = y + (size_t)g * P2 * 3;
    const unsigned char* vg = y_valid == nullptr ? nullptr : y_valid + (size_t)g * P2;
    for (int p0 = 0; p0 < cells * MASK_CELL; p0 += MASK_CHUNK) {
        __syncthreads();  // the previous chunk is read
        for (int j = tid; j < MASK_CHUNK; j += MASK_THREADS) {
            const int p = p0 + j;
            float4 v = make_float4(inf, inf, inf, 0.f);
            if (p < P2 && (vg == nullptr || vg[p] != 0))
                v = make_float4(yg[3 * p + 0], yg[3 * p + 1], yg[3 * p + 2], 0.f);
            ys[j] = v;
        }
        __syncthreads();
        if (!any_live) continue;
        const int chunk_cells = min(MASK_CHUNK, cells * MASK_CELL - p0) / MASK_CELL;
        for (int cc = 0; cc < chunk_cells; ++cc) {
            const float4* yc = ys + cc * MASK_CELL;
#pragma unroll 16
            for (int q = 0; q < MASK_CELL; ++q) {
                const float4 v = yc[q];
#pragma unroll
                for (int i = 0; i < MASK_CPT; ++i) m[i] = fminf(m[i], h2o_pair_d2(cx[i], cy[i], cz[i], v));
            }
            const int cell = p0 / MASK_CELL + cc;
            if ((cell + 1) % cells_per_tile == 0 || cell == cells - 1) {  // the tile's last cell
                const int t = cell / cells_per_tile;
#pragma unroll
                for (int i = 0; i < MASK_CPT; ++i) {
                    sd[((size_t)i * T + t) * (MASK_THREADS + 1) + tid] = __fsqrt_rn(m[i]);
                    m_all[i] = fminf(m_all[i], m[i]);
                    m[i] = inf;
                }
            }
        }
    }
    for (int i = 0; i < MASK_CPT; ++i) {
        const int c = tid * MASK_CPT + i;
        if (c >= n_c) continue;
        const float r = live[i] ? rr[k0 + c] : 0.f;
        s_rr[c] = r;
        // NaN compares false: a dead centroid's flags come out 0
        s_thr[c] = live[i] ? __fadd_rn(__fadd_rn(__fsqrt_rn(m_all[i]), r), MASK_SLACK) : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    for (int idx = tid; idx < n_c * T; idx += MASK_THREADS) {
        const int c = idx / T;
        const int t = idx - c * T;
        const float d = sd[((size_t)(c % MASK_CPT) * T + t) * (MASK_THREADS + 1) + c / MASK_CPT];
        flags[(size_t)k0 * T + idx] = (__fsub_rn(d, s_rr[c]) <= s_thr[c]) && isfinite(d);
    }
}

extern "C" int h2o_cull_mask_launch(const float* cg, const float* rr, const float* y,
                                    const unsigned char* y_valid, const unsigned char* x_valid,
                                    int* flags, int G, int P2, int R, int C, int T, int tile,
                                    cudaStream_t stream) {
    if (G <= 0 || C <= 0) return 0;
    if (tile <= 0 || tile % MASK_CELL != 0 || T != (P2 + tile - 1) / tile) return (int)cudaErrorInvalidValue;
    const size_t smem = mask_smem(T);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(h2o_cull_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int blocks_per_group = (C + MASK_CPB - 1) / MASK_CPB;
    h2o_cull_mask_kernel<<<(unsigned)((long long)G * blocks_per_group), MASK_THREADS, smem, stream>>>(
        cg, rr, y, y_valid, x_valid, flags, P2, R, C, T, tile, blocks_per_group);
    return (int)cudaGetLastError();
}
