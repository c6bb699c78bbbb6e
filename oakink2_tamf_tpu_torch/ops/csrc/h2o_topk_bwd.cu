// Cluster-pruned hand->object nearest neighbour (h2o), backward with the
// argmin held constant: kernel #11.
//
// Replaces the TPU kernels oakink2_tamf_tpu/ops/chamfer_cluster.py
// `_h2o_topk_bwd_kernel` and `_h2o_topk_bwd_kernel_nogy` (:558 / :596,
// pallas_calls in `_h2o_cluster_backward` at :655 / :672), the backward of
// the cluster route whose forward is h2o_topk.cu. The TPU walks the
// forward's K candidate cells per 128-row tile and gathers y_{j*} with
// one-hot products, because it has no cheap gather; on this card the
// forward's global first-min index is one load, so the function is exactly
// the all-pairs backward's (kernel #5): gx_i = xr_i (x_i - y_{j*}) and,
// with grad_y (y_group == 1), gy_{j*} -= the same. Bound and design:
// h2o_bwd_common.cuh, the device code this file shares with h2o_nn_bwd.cu
// under its own launch symbol.

#include "h2o_bwd_common.cuh"

extern "C" int h2o_topk_bwd_launch(const float* x, const float* y, const int* idx,
                                   const float* xr, float* gx, float* gy,
                                   int F, int P1, int P2, int y_group, int grad_y,
                                   cudaStream_t stream) {
    return h2o_bwd_launch(x, y, idx, xr, gx, gy, F, P1, P2, y_group, grad_y, stream);
}
