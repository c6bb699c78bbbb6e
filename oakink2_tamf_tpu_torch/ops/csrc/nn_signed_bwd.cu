// Signed bidirectional nearest neighbour, backward: kernel #7.
//
// Replaces the TPU kernels oakink2_tamf_tpu/ops/chamfer_pallas.py
// `_nn_bwd_kernel` and `_nn_bwd_kernel_nogy` (:731 / :788, pallas_calls in
// `_nn_backward` at :890 / :904). The argmins of the forward are constants
// of the backward (torch-parity convention); xr_i and yc_j are the
// cotangents of the two distance fields already divided by the distances.
// For frame f with cloud y = y[f / y_group]:
//   gx_i = xr_i (x_i - y_{h2o_i[i]}) - sum_{j : o2h_i[j] = i} yc_j (y_j - x_i)
// and, with GRAD_Y (y_group == 1 only),
//   gy_j = yc_j (y_j - x_{o2h_i[j]}) - sum_{i : h2o_i[i] = j} xr_i (x_i - y_j).
//
// Bound: bytes. Each input is read once (indices, cotangent rows, x, y) and
// gx (gy) written once: at the G training shape (40960 frames x 778 rows x
// 8192 points, y_group 160) ~3.7 GB, 1.1 ms at 3.35 TB/s. The TPU builds
// one-hot matrices and runs the select and scatter on its matrix unit; here
// an index is a load and the scatter an add into shared memory. Design:
// one block per frame. The o2h side is the warp-aggregated scatter of
// o2h_scatter_common.cuh (shared with #13): the frame's gx accumulator
// [P1, 3] sits in shared memory, and each warp walks a contiguous chunk of
// the points and adds to a hand row once per group of lanes on that row
// (carried across steps in registers), not once per point. Then the threads stride over the rows, add
// the direct h2o term and write gx once. With GRAD_Y the o2h side writes
// gy_j directly, and the h2o side's gy terms go to device memory with
// atomics after the block has written those.
//
// The additions land in an order that changes from run to run, so gx (and
// gy) are not bitwise reproducible: compare within the float32 sum bound.

#include "launch_common.cuh"
#include "o2h_scatter_common.cuh"

template <bool GRAD_Y>
__global__ void __launch_bounds__(O2H_THREADS)
nn_signed_bwd_kernel(const float* __restrict__ x,      // [F, P1, 3]
                     const float* __restrict__ y,      // [G, P2, 3]
                     const int* __restrict__ h2o_i,    // [F, P1]
                     const int* __restrict__ o2h_i,    // [F, P2]
                     const float* __restrict__ xr,     // [F, P1]
                     const float* __restrict__ yc,     // [F, P2]
                     float* __restrict__ gx,           // [F, P1, 3]
                     float* __restrict__ gy,           // [F, P2, 3] (GRAD_Y)
                     int P1, int P2, int y_group) {
    extern __shared__ float acc[];  // [P1, 3]
    const int f = blockIdx.x;
    const int g = f / y_group;
    const float* xf = x + (size_t)f * P1 * 3;
    const float* yg = y + (size_t)g * P2 * 3;
    o2h_scatter_init(acc, P1);

    // o2h side: column j pulls its nearest row i*
    o2h_scatter<GRAD_Y>(acc, xf, yg, o2h_i + (size_t)f * P2, yc + (size_t)f * P2,
                        GRAD_Y ? gy + (size_t)f * P2 * 3 : nullptr, P1, P2);
    __syncthreads();  // acc complete; the direct gy terms visible to the block

    // h2o side: row i pulls its nearest point j*
    for (int i = threadIdx.x; i < P1; i += blockDim.x) {
        const size_t o = (size_t)f * P1 + i;
        const float r = xr[o];
        const int j = h2o_i[o];
        float v0 = 0.f, v1 = 0.f, v2 = 0.f;
        if (r != 0.f && (unsigned)j < (unsigned)P2) {
            v0 = r * (xf[3 * i + 0] - yg[3 * j + 0]);
            v1 = r * (xf[3 * i + 1] - yg[3 * j + 1]);
            v2 = r * (xf[3 * i + 2] - yg[3 * j + 2]);
            if (GRAD_Y) {
                float* gyj = gy + ((size_t)f * P2 + j) * 3;
                atomicAdd(gyj + 0, -v0);
                atomicAdd(gyj + 1, -v1);
                atomicAdd(gyj + 2, -v2);
            }
        }
        gx[3 * o + 0] = acc[3 * i + 0] + v0;
        gx[3 * o + 1] = acc[3 * i + 1] + v1;
        gx[3 * o + 2] = acc[3 * i + 2] + v2;
    }
}

extern "C" int nn_signed_bwd_launch(const float* x, const float* y, const int* h2o_i,
                                    const int* o2h_i, const float* xr, const float* yc,
                                    float* gx, float* gy, int F, int P1, int P2,
                                    int y_group, int grad_y, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0) return 0;
    const size_t smem = (size_t)P1 * 3 * sizeof(float);
    auto kernel = grad_y ? nn_signed_bwd_kernel<true> : nn_signed_bwd_kernel<false>;
    kernel<<<F, O2H_THREADS, smem, stream>>>(x, y, h2o_i, o2h_i, xr, yc, gx, gy, P1, P2, y_group);
    return (int)cudaGetLastError();
}
