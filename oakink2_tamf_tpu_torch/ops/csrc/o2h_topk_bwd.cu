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
// Bound: bytes. Each cotangent is read once, the index and y row of each
// point with a nonzero cotangent once, each gathered x row once, and gx
// (gy) written once: ~5.2 GB at the R training shape (40960 frames x 778
// rows x 8192 points, 37.5% of the points in padded slots), 1.6 ms at 3.35
// TB/s. The TPU walks each cell's candidate tiles and gathers and scatters
// with one-hot products; here the index is a load and the scatter an add
// into shared memory, so the candidate lists are not needed. Design: one
// block per frame running the warp-aggregated scatter of
// o2h_scatter_common.cuh (shared with #7's o2h side): the frame's gx
// accumulator [P1, 3] sits in shared memory; each warp walks a contiguous
// chunk of the points, writes gy_j directly (each point owns its row) and
// adds to a hand row once per group of lanes on that row (carried across
// steps in registers), not once per point; then the block writes gx once. A zero cotangent (invalid points,
// padded slots) reads nothing more and issues nothing.
//
// The additions land in an order that changes from run to run, so gx is
// not bitwise reproducible: compare it within the float32 sum bound. gy is
// one rounded product per element, bit-equal to the plain version's.

#include "launch_common.cuh"
#include "o2h_scatter_common.cuh"

template <bool GRAD_Y>
__global__ void __launch_bounds__(O2H_THREADS)
o2h_topk_bwd_kernel(const float* __restrict__ x,      // [F, P1, 3]
                    const float* __restrict__ y,      // [F, P2, 3]
                    const int* __restrict__ o2h_i,    // [F, P2]
                    const float* __restrict__ yc,     // [F, P2]
                    float* __restrict__ gx,           // [F, P1, 3]
                    float* __restrict__ gy,           // [F, P2, 3] (GRAD_Y)
                    int P1, int P2) {
    extern __shared__ float acc[];  // [P1, 3]
    const int f = blockIdx.x;
    const float* xf = x + (size_t)f * P1 * 3;
    o2h_scatter_init(acc, P1);
    o2h_scatter<GRAD_Y>(acc, xf, y + (size_t)f * P2 * 3, o2h_i + (size_t)f * P2,
                        yc + (size_t)f * P2, GRAD_Y ? gy + (size_t)f * P2 * 3 : nullptr, P1, P2);
    __syncthreads();
    float* gxf = gx + (size_t)f * P1 * 3;
    for (int k = threadIdx.x; k < P1 * 3; k += blockDim.x) gxf[k] = acc[k];
}

extern "C" int o2h_topk_bwd_launch(const float* x, const float* y, const int* o2h_i,
                                   const float* yc, float* gx, float* gy,
                                   int F, int P1, int P2, int grad_y, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const size_t smem = (size_t)P1 * 3 * sizeof(float);
    auto kernel = grad_y ? o2h_topk_bwd_kernel<true> : o2h_topk_bwd_kernel<false>;
    kernel<<<F, O2H_THREADS, smem, stream>>>(x, y, o2h_i, yc, gx, gy, P1, P2);
    return (int)cudaGetLastError();
}
