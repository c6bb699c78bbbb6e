// Fused distance loss of G's extra loss: per-point integrands of dist_o and
// dist_h and their gradients with respect to the hand rows, in one pass.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_loss.py
// `_dist_loss_kernel` (:129, body `_dist_loss_step` :185, pallas_call in
// `_dist_loss_forward` at :391). For frame f with rows x_i, normals n_i,
// cloud y_j = y[f / y_group] (centred, invalid points at 1e15), GT fields
// og_j (signed o2h) and hg_i (h2o), and contact weights vw_i:
//   o2h phase, per column j with first-min row i*:
//     dist = sqrt(d), sign = sign(n_{i*} . (y_j - x_{i*})), o = dist * sign
//     w = 1.5 if o < 0 else (1.0 if -0.005 < og_j < 0.01 else 0.1)
//     v_j = |o - og_j| w;  gx_do[i*] += w sgn(o - og_j) sign / max(dist, 1e-12) (x_{i*} - y_j)
//   h2o phase, per row i with first-min point j*:
//     hd = sqrt(d), dh_i = |hd - |hg_i|| vw_i
//     gx_dh[i] = vw_i sgn(hd - |hg_i|) / max(hd, 1e-12) (x_i - y_{j*})
// Invalid columns give v = 0 and no gradient. x_valid[f] == 0 frames
// (mask-padded frames, padded object slots) cost nothing and emit zeros.
//
// Bound: floating-point work, 8 flops per (x, y) pair of the live frames,
// counted once; bytes are far below. At the G training shape (35108 live
// of 40960 frames x 778 rows x 8192 points, 2.24e11 pairs) that is 26.7 ms
// at the H100 SXM's 67 TFLOP/s FP32. Like nn_signed.cu it is bound by the
// instructions it issues: at 8 per pair (the pinned distance's 6 and a
// minimum update per direction) over 33.45e12 lane-instructions/s, an
// issue floor of 53.5 ms there.
//
// Design: one block of 256 threads per frame running bidir_common.cuh's
// single-pass search (4 columns per thread, rows in groups of 8, 4 blocks
// per SM: see nn_signed.cu), each pair's distance computed once for both
// directions. Beside the staged rows, normals and row keys, the frame's
// gx_do accumulator [P1, 3] lives in shared memory (52 KB at 1024 rows,
// opted in above 48 KB): after each pass, its columns' integrands and
// gradient rows go through dist_loss_common.cuh's dist_loss_o2h_column (a
// shared atomic add per column); after the last pass, the accumulator is
// written once and each row's key goes through dist_loss_h2o_row. The
// kernel body is dist_loss_common.cuh's dist_loss_body, which the
// region-culled twin (dist_loss_cull.cu) instantiates with its region
// gate, so the two agree bit for bit wherever they find the same minimum.
// The shared atomic adds land in a run-dependent order: gx_do is not
// bitwise reproducible, compare at rtol.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W) at the G training shape: 101.8-102.6 ms over five runs,
// 26.0-26.3% of the flop bound and 52.1-52.6% of the issue floor. ptxas: 64
// registers, 4 bytes spilled (outside the hot loop). SASS of the hot loop:
// 301 instructions per 32 pairs without the row merge, 9.41 per pair. As
// for nn_signed.cu, the issue rate reached (~62%) holds it back.

#include "dist_loss_common.cuh"

__global__ void __launch_bounds__(BIDIR_THREADS, 4)
dist_loss_kernel(const float* __restrict__ x,      // [F, P1, 3]
                 const float* __restrict__ n,      // [F, P1, 3]
                 const float4* __restrict__ y,     // [G, P2] centred
                 const float* __restrict__ ctr,    // [G, 3]
                 const float* __restrict__ og,     // [F, P2] GT signed o2h
                 const float* __restrict__ hg,     // [F, P1] GT h2o
                 const float* __restrict__ vw,     // [P1] contact weights
                 const unsigned char* __restrict__ x_valid,  // [F]
                 float* __restrict__ v_out,        // [F, P2]
                 float* __restrict__ dh_out,       // [F, P1]
                 float* __restrict__ gx_do,        // [F, P1, 3]
                 float* __restrict__ gx_dh,        // [F, P1, 3]
                 int P1, int P2, int y_group) {
    dist_loss_body<false>(x, n, y, ctr, og, hg, vw, x_valid, nullptr, v_out, dh_out, gx_do, gx_dh,
                          P1, P2, y_group, 0, 0, 0);
}

extern "C" int dist_loss_launch(const float* x, const float* n, const float4* y,
                                const float* ctr, const float* og, const float* hg,
                                const float* vw, const unsigned char* x_valid,
                                float* v_out, float* dh_out, float* gx_do, float* gx_dh,
                                int F, int P1, int P2, int y_group, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = dist_loss_smem(P1);
    const int e = bidir_smem_attr(dist_loss_kernel, smem);
    if (e != 0) return e;
    dist_loss_kernel<<<F, BIDIR_THREADS, smem, stream>>>(
        x, n, y, ctr, og, hg, vw, x_valid, v_out, dh_out, gx_do, gx_dh, P1, P2, y_group);
    return (int)cudaGetLastError();
}
