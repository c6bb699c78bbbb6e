// Hand->object nearest neighbour (h2o), backward with the argmin held
// constant: kernel #5.
//
// Replaces the TPU kernels oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_h2o_bwd_kernel` and `_nn_h2o_bwd_kernel_nogy` (:502 / :530,
// pallas_calls in `_nn_h2o_backward` at :614 / :629), the backward of the
// all-pairs route whose forward is h2o_nn.cu. Function, bound and design:
// h2o_bwd_common.cuh, shared with the cluster route's backward
// (h2o_topk_bwd.cu).

#include "h2o_bwd_common.cuh"

extern "C" int h2o_nn_bwd_launch(const float* x, const float* y, const int* idx,
                                 const float* xr, float* gx, float* gy,
                                 int F, int P1, int P2, int y_group, int grad_y,
                                 cudaStream_t stream) {
    return h2o_bwd_launch(x, y, idx, xr, gx, gy, F, P1, P2, y_group, grad_y, stream);
}
