// Cluster-pruned object->hand nearest neighbour (o2h), backward with the
// argmin held constant: kernel #13.
//
// Replaces the TPU kernels oakink2_tamf_tpu/ops/chamfer_cluster.py
// `_o2h_topk_bwd_kernel` and `_o2h_topk_bwd_kernel_nogy` (:944 / :981,
// pallas_calls in `_signed_cluster_backward` at :1028 / :1045). With i* =
// o2h_i[j] the forward's first-min row (in the caller's row order) and yc_j
// the cotangent of y2x_j already multiplied by its sign and divided by
// max(y2x_j, 1e-12), for frame f (one cloud per frame):
//   gx_{i*} -= yc_j (y_j - x_{i*})   summed over the points j
// and, with GRAD_Y,
//   gy_j = yc_j (y_j - x_{i*}).
// The h2o side's terms (kernel #11, h2o_topk_bwd.cu) are added by the
// wrapper, as the TPU's `_signed_cluster_backward` adds its two kernels'.
//
// Bound: bytes. Each input is read once (o2h_i, yc, y, the gathered x
// rows) and gx (gy) written once. The TPU walks each cell's candidate
// tiles and gathers and scatters with one-hot products; here the index is a
// load and the scatter an atomic add, so the candidate lists are not
// needed. Design (nn_signed_bwd.cu's o2h side): one block of 256 threads
// per frame; the frame's gx accumulator [P1, 3] sits in shared memory (9.3
// KB at 778 rows); the threads stride over the points (coalesced index and
// cotangent loads), write gy directly (each point owns its row) and add
// -yc_j (y_j - x_{i*}) into the shared row i*; then the block writes gx
// once. A zero cotangent (invalid points, padded slots) issues no atomic.
//
// The atomic additions land in an order that changes from run to run, so
// gx is not bitwise reproducible: compare it at rtol.

#include "launch_common.cuh"

#define O2H_BWD_THREADS 256

template <bool GRAD_Y>
__global__ void __launch_bounds__(O2H_BWD_THREADS)
o2h_topk_bwd_kernel(const float* __restrict__ x,      // [F, P1, 3]
                    const float* __restrict__ y,      // [F, P2, 3]
                    const int* __restrict__ o2h_i,    // [F, P2]
                    const float* __restrict__ yc,     // [F, P2]
                    float* __restrict__ gx,           // [F, P1, 3]
                    float* __restrict__ gy,           // [F, P2, 3] (GRAD_Y)
                    int P1, int P2) {
    extern __shared__ float acc[];  // [P1 * 3]
    const int f = blockIdx.x;
    const float* xf = x + (size_t)f * P1 * 3;
    const float* yf = y + (size_t)f * P2 * 3;
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) acc[k] = 0.f;
    __syncthreads();
    for (int j = threadIdx.x; j < P2; j += blockDim.x) {
        const size_t o = (size_t)f * P2 + j;
        const float c = yc[o];
        const int i = o2h_i[o];
        float u0 = 0.f, u1 = 0.f, u2 = 0.f;
        if (c != 0.f && (unsigned)i < (unsigned)P1) {
            u0 = c * (yf[3 * j + 0] - xf[3 * i + 0]);
            u1 = c * (yf[3 * j + 1] - xf[3 * i + 1]);
            u2 = c * (yf[3 * j + 2] - xf[3 * i + 2]);
            atomicAdd(&acc[3 * i + 0], -u0);
            atomicAdd(&acc[3 * i + 1], -u1);
            atomicAdd(&acc[3 * i + 2], -u2);
        }
        if (GRAD_Y) {
            gy[3 * o + 0] = u0;
            gy[3 * o + 1] = u1;
            gy[3 * o + 2] = u2;
        }
    }
    __syncthreads();
    float* gxf = gx + (size_t)f * P1 * 3;
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gxf[k] = acc[k];
}

extern "C" int o2h_topk_bwd_launch(const float* x, const float* y, const int* o2h_i,
                                   const float* yc, float* gx, float* gy,
                                   int F, int P1, int P2, int grad_y, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const size_t smem = (size_t)P1 * 3 * sizeof(float);
    if (grad_y) {
        o2h_topk_bwd_kernel<true><<<F, O2H_BWD_THREADS, smem, stream>>>(
            x, y, o2h_i, yc, gx, gy, P1, P2);
    } else {
        o2h_topk_bwd_kernel<false><<<F, O2H_BWD_THREADS, smem, stream>>>(
            x, y, o2h_i, yc, gx, gy, P1, P2);
    }
    return (int)cudaGetLastError();
}
