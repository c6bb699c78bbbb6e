// Signed bidirectional hand/object nearest neighbour, forward.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_pallas.py `_nn_kernel`
// (:97, pallas_call in `_nn_forward` at :306). For frame f, its hand rows
// x_i with normals n_i and its object cloud y_j = y[f / y_group]:
//   h2o: min_j ||x_i - y_j||^2 and the first j reaching it      [F, P1] x 2
//   o2h: min_i ||x_i - y_j||^2, the first i* reaching it, and
//        the sign numerator n_{i*} . (y_j - x_{i*})                [F, P2] x 3
// Operands as ops/chamfer_nn.prepare makes them: y centred on its group's
// y-mean with invalid points at 1e15 (they never win a row; their own o2h
// outputs are (BIG, 0, .) and callers mask them), x centred as it loads.
// Every frame is searched: the TPU kernel's contract has no x_valid.
//
// Bound: floating-point work, 8 flops per (x, y) pair counted once; the
// bytes (x, n and y once, five [F, P] outputs) are far below it. At the G
// training shape (40960 frames x 778 rows x 8192 points, 2.61e11 pairs)
// that is 31.2 ms at the H100 SXM's 67 TFLOP/s FP32. The kernel is bound by
// the instructions it issues: 6 for the pinned distance (3 FADD, 1 FMUL,
// 2 FFMA) plus at least one minimum update per direction, 8 per pair, over
// the card's 132 SMs x 128 lanes x 1.98 GHz = 33.45e12 lane-instructions/s:
// an issue floor of 62.4 ms at that shape.
//
// Design: one block of 256 threads per frame running bidir_common.cuh's
// single-pass search, so each pair's distance is computed once and feeds
// both directions, as the TPU kernel gets both from one distance block. A
// thread holds 4 columns and walks the rows in groups of 8: per 32 pairs,
// the 192 instructions of the distances, 28 fminf and one compare-and-
// select of the group per column, 28 fminf and a vote per row.
// __launch_bounds__(256, 4) holds it at 64 registers, so 4 blocks (32
// warps) share an SM: of the variants tried (4 or 8 columns, groups of 2
// to 8 rows, 2 to 4 blocks per SM), occupancy moved the time most at a
// near-equal instruction count. Per pass, once its columns are final, the
// o2h epilogue reads the winning row's coordinates and normal from shared
// memory; after the last pass the rows' keys are the h2o outputs. Values
// and indices are bit-equal to h2o_nn.cu's h2o and o2h_topk.cu's o2h at
// k_tiles 0: the same pair value and the same first-minimum rule. Shared
// memory: 40 bytes per row, rows rounded up to the group (31.4 KB at 778
// rows, 60 KB at MAX_ROWS 1536, opted in above 48 KB).
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W) at the G training shape: 113.6-116.3 ms over four runs,
// 26.8-27.4% of the flop bound and 53.7-54.9% of the issue floor. ptxas: 64 registers,
// no spills, no static shared memory. SASS of the hot loop (cuobjdump):
// 302 instructions per 32 pairs without the row merge, 9.44 per pair.
// What holds it back is the issue rate reached: ~64% of the card's.

#include "bidir_common.cuh"

__global__ void __launch_bounds__(BIDIR_THREADS, 4)
nn_signed_kernel(const float* __restrict__ x,     // [F, P1, 3]
                 const float* __restrict__ n,     // [F, P1, 3] normals
                 const float4* __restrict__ y,    // [G, P2] centred
                 const float* __restrict__ ctr,   // [G, 3]
                 float* __restrict__ h2o_d,       // [F, P1]
                 int* __restrict__ h2o_i,         // [F, P1]
                 float* __restrict__ o2h_d,       // [F, P2]
                 int* __restrict__ o2h_i,         // [F, P2]
                 float* __restrict__ o2h_dot,     // [F, P2]
                 int P1, int P2, int y_group) {
    extern __shared__ float4 smem[];
    const int P1r = bidir_rows_padded(P1);
    float4* xs = smem;                                                                 // [P1r]
    float4* ns = smem + P1r;                                                           // [P1r]
    unsigned long long* key = reinterpret_cast<unsigned long long*>(smem + 2 * P1r);  // [P1r]
    const int f = blockIdx.x;
    const int g = f / y_group;
    bidir_init_rows(xs, key, P1);
    o2h_stage_rows(xs, ns, x, n, ctr, f, g, P1);  // ends with a barrier

    const float4* yg = y + (size_t)g * P2;
    for (int j0 = 0; j0 < P2; j0 += BIDIR_PASS) {
        float4 yv[BIDIR_COLS];
        bidir_load_cols(yg, j0, P2, yv);
        float best[BIDIR_COLS];
        int best_i[BIDIR_COLS];
        bidir_pass(xs, key, P1r, j0, yv, best, best_i);
#pragma unroll
        for (int c = 0; c < BIDIR_COLS; ++c) {
            const int j = j0 + c * BIDIR_THREADS + threadIdx.x;
            if (j < P2) {
                const size_t o = (size_t)f * P2 + j;
                o2h_d[o] = best[c];
                o2h_i[o] = best_i[c];
                o2h_dot[o] = o2h_sign_numer(xs[best_i[c]], ns[best_i[c]], yv[c]);
            }
        }
    }
    __syncthreads();  // every pass's atomics on the keys are done
    for (int i = threadIdx.x; i < P1; i += blockDim.x) {
        float d;
        int j;
        bidir_row(key[i], d, j);
        h2o_d[(size_t)f * P1 + i] = d;
        h2o_i[(size_t)f * P1 + i] = j;
    }
}

extern "C" int nn_signed_launch(const float* x, const float* n, const float4* y,
                                const float* ctr, float* h2o_d, int* h2o_i,
                                float* o2h_d, int* o2h_i, float* o2h_dot,
                                int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = (size_t)bidir_rows_padded(P1) * BIDIR_SMEM_ROW;
    const int e = bidir_smem_attr(nn_signed_kernel, smem);
    if (e != 0) return e;
    nn_signed_kernel<<<F, BIDIR_THREADS, smem, stream>>>(
        x, n, y, ctr, h2o_d, h2o_i, o2h_d, o2h_i, o2h_dot, P1, P2, y_group);
    return (int)cudaGetLastError();
}
