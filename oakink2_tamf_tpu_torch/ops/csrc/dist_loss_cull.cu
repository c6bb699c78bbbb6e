// Region-culled fused distance loss of G's extra loss (dist_impl
// "fused_cull"): dist_loss.cu's per-point integrands and gradient rows,
// with only the [128-row region, tile] blocks that the region-cull mask
// keeps searched.
//
// Replaces the TPU kernel oakink2_tamf_tpu/ops/chamfer_loss.py
// `_dist_loss_cull_kernel` (:505; `_dist_loss_forward_cull` :656,
// pallas_call at :673). Operands are dist_loss.cu's (rows x and normals n
// of the template-permuted hand, the group's centred cloud, GT fields,
// contact weights, x_valid) plus the mask m [F, R, T] int32 of
// ops/chamfer_loss.region_cull_mask: 0 = skip the block, 1 = it may hold a
// row's minimum, 3 = it may also hold a column's first-min row; != 0 gates
// both directions, as on the TPU (:559). The per-point formulas are
// dist_loss_common.cuh's. What the cull changes:
//   o2h, per column j in tile t: the first minimum over the rows of the
//     regions r with m[r][t] != 0, in ascending row order with a strict <
//     (the TPU's strict < across regions, chamfer_loss.py:576-585). A
//     column that searched no pair gives v = 0 and no gradient.
//   h2o, per row in region r: the first minimum over the tiles t with
//     m[r][t] != 0. A row that searched no pair (every block skipped: an
//     x_valid == 0 frame, an all-invalid cloud) gives dh = 0 and a zero
//     gradient row (the TPU's `hdone`, :644-653).
// The mask only drops blocks that provably hold no minimum, so on live
// frames whose cloud has a valid point the outputs equal dist_loss.cu's on
// the same operands bit for bit (gx_do up to the order of its atomics).
//
// Bound: floating-point work, 8 flops per (row, point) pair of the blocks
// the mask keeps on live frames; bytes are far below. At chip_smoke.py's
// check shape (40960 frames x 778 rows x 8192 points, y_group 160, tile
// 2048, run share 0.9730) that is 2.18e11 pairs, 26.0 ms at the H100 SXM's
// 67 TFLOP/s FP32; at 8 instructions per pair, an issue floor of 52.1 ms.
//
// Design: #8's kernel body (dist_loss_common.cuh's dist_loss_body, here
// with CULL set), one launch and one block of 256 threads per frame on
// bidir_common.cuh's single-pass search, so each kept pair's distance is
// computed once for both directions. The passes walk each tile on its own
// and end at its last column, and before a tile's passes the block reads
// the tile's flags of its R regions into one word: a region's 16 row
// groups are searched only if its bit is set. The word depends on the mask
// alone, so a skipped region costs no divergence, and the hot loop is
// #8's, with no per-column flag. Where tile is not a multiple of the
// 1024-column pass (512, 640, 1536...), a tile's last pass runs partly on
// dead columns (an invalid point, as past P2), which win neither side.
//
// Measured with chip_smoke.py on an NVIDIA H100 80GB HBM3 (power limit
// 700.00 W) at that shape: 101.562 ms (the previous design, one o2h and one
// h2o kernel that each computed the kept pairs, 162.798-162.879 ms), #8 on
// the same operands 101.791 ms: the 2.7% of the blocks skipped pay for the
// gate and little more. 25.6% of the flop bound, 51.3% of the issue floor.
// ptxas: 64 registers, 36 bytes spilled (outside the hot loop); SASS of
// the hot loop: #8's 301 instructions per 32 pairs, 9.41 per pair.

#include "dist_loss_common.cuh"

__global__ void __launch_bounds__(BIDIR_THREADS, 4)
dist_loss_cull_kernel(const float* __restrict__ x,      // [F, P1, 3]
                      const float* __restrict__ n,      // [F, P1, 3]
                      const float4* __restrict__ y,     // [G, P2] centred
                      const float* __restrict__ ctr,    // [G, 3]
                      const float* __restrict__ og,     // [F, P2] GT signed o2h
                      const float* __restrict__ hg,     // [F, P1] GT h2o
                      const float* __restrict__ vw,     // [P1] contact weights
                      const unsigned char* __restrict__ x_valid,  // [F]
                      const int* __restrict__ mask,     // [F, R, T]
                      float* __restrict__ v_out,        // [F, P2]
                      float* __restrict__ dh_out,       // [F, P1]
                      float* __restrict__ gx_do,        // [F, P1, 3]
                      float* __restrict__ gx_dh,        // [F, P1, 3]
                      int P1, int P2, int y_group, int R, int T, int tile) {
    dist_loss_body<true>(x, n, y, ctr, og, hg, vw, x_valid, mask, v_out, dh_out, gx_do, gx_dh,
                         P1, P2, y_group, R, T, tile);
}

extern "C" int dist_loss_cull_launch(const float* x, const float* n, const float4* y,
                                     const float* ctr, const float* og, const float* hg,
                                     const float* vw, const unsigned char* x_valid,
                                     const int* mask, float* v_out, float* dh_out,
                                     float* gx_do, float* gx_dh, int F, int P1, int P2,
                                     int y_group, int R, int T, int tile, cudaStream_t stream) {
    if (F <= 0 || P1 <= 0 || P2 <= 0) return 0;
    const size_t smem = dist_loss_smem(P1);
    const int e = bidir_smem_attr(dist_loss_cull_kernel, smem);
    if (e != 0) return e;
    dist_loss_cull_kernel<<<F, BIDIR_THREADS, smem, stream>>>(
        x, n, y, ctr, og, hg, vw, x_valid, mask, v_out, dh_out, gx_do, gx_dh,
        P1, P2, y_group, R, T, tile);
    return (int)cudaGetLastError();
}
