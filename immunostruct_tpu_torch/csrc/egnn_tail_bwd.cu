// Backward of the EGNN edge chain for Hopper (sm_90a), from the residuals
// that csrc/egnn_mega_fwd.cu stores.
//
// Replaces immunostruct_tpu/ops/pallas_mega.py::_tail_bwd_kernel (launched
// by _tail_bwd_call; body _tail_bwd_core -> _chain_bwd, _accum_weight_grads).
// Per graph b, per edge e that is computed (valid), from a1 [H], xd [3], ef
// and the cotangent d_both = [d_m_in (H) ; d_msgx (3)] of [m ++ cw*x_hat]:
//
//   recompute  a1s = silu(a1); p2 = a1s@W2 + b2; m = silu(p2);
//              p3 = m@Wc1 + bc1; c1 = silu(p3); cw = c1 . wc2
//   back       d_cw = d_msgx . x_hat;  d_xhat = d_msgx * cw
//              d_p3 = wc2 * d_cw * silu'(p3);  d_m = d_m_in + Wc1 @ d_p3
//              d_p2 = d_m * silu'(p2);  d_a1 = (W2 @ d_p2) * silu'(a1)
//              d_rad = w1r . d_a1 + [radial > 0] d|x_hat|/d radial
//              d_xd = d_xhat / s + 2 xd d_rad;  d_ef = w1e . d_a1
//   out        d_cat[:, e] = [d_a1 ; d_xd]  [B,H+3,E];  d_ef [B,1,E]
//   sums (f32) dW2 += a1s (x) d_p2;  dWc1 += m (x) d_p3;
//              dsmall += [d_a1*radial, d_a1*ef, d_a1, d_p2, d_p3, c1*d_cw]
//
// A skipped edge (valid 0: padded, or an index outside [0, N)) and the
// ragged end of a tile are never read; they get d_cat = 0, d_ef = 0 and add
// nothing to a weight gradient.
//
// What bounds it on the H100. Per edge, six H x H products (two for the
// recompute, two back through W2/Wc1, two outer products for dW2/dWc1): at
// B=128, E=2560, H=64 that is 6*E*H*H = 63 M multiply-adds per graph, 8.1 G
// per launch, against ~0.15 MB of residuals and cotangents read per graph:
// bound by arithmetic on the CUDA cores, not by device memory (~60 MB per
// launch is ~18 us at 3.35 TB/s).
//
// What the design does about it (a first, simple form):
//   - one CTA of 256 threads per (graph, edge chunk), enough CTAs to give
//     every SM one; 64-edge tiles inside;
//   - W2 and Wc1, rounded to the compute dtype, sit in shared memory with a
//     padded row (H+1) so that both W @ v and W^T @ v read them with at
//     most 2-way bank conflicts; every product is a register-tiled FMA loop
//     (each thread 4 edges x H/16 columns), as in the forward kernel;
//   - the tile's operands (a1s, m, silu'(a1), d_p3, d_m_in -> d_p2) live in
//     shared memory; residuals, cotangents and d_cat move between device
//     memory and shared memory with neighbouring threads on neighbouring
//     edges (coalesced in the [B,C,E] layout);
//   - the weight gradients cross blocks. On the TPU the grid runs in order
//     and carries them in a revisited block; here blocks run in no order.
//     Each thread keeps its 4 x H/16 share of dW2 and dWc1 and its columns
//     of dsmall in registers over all its tiles; the CTA writes them to a
//     [blocks, 2H^2 + 6H] f32 scratch (dsmall reduced over the 16 edge
//     groups in a fixed order); a second kernel sums the scratch over
//     blocks in block order. No atomics: the gradients are the same from
//     run to run.
// Tensor cores (mma.sync / wgmma) for the six products are the next step.
//
// Rounding points under bf16 are the TPU kernel's (pallas_mega.py:400-479,
// pallas_edge.py:104-139): W2/Wc1 rounded; the chain recomputed from the
// rounded a1 with the forward's rounding points (a1s, m, c1, radial, and
// cw before it meets d_msgx); d_p3, d_p2, d_a1 rounded, d_xd and d_ef by
// their store in the compute dtype; d_m and W2 @ d_p2 are f32 sums; weight
// gradients are f32 sums of products of the rounded values.
//
// The body is csrc/egnn_common.cuh's tail_bwd_kernel<T, H, kOperand>,
// shared with the variants B5a and B5b.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

extern "C" {

// Shared memory one CTA of the main kernel needs for hidden width H.
long long egnn_tail_bwd_smem_bytes(int H) {
  return egnn::tail_smem_floats(H) * (long long)sizeof(float);
}

// One backward: B*chunks CTAs of 256 threads, then the reduction, both on
// `stream`. valid [B,E] bool; ef [B,E,1], a1 [B,H,E], xd [B,3,E],
// d_both [B,H+3,E] in the compute dtype (bf16 != 0: bfloat16, else
// float32); w2/wc1 [H,H], small [H,6] f32. Writes d_cat [B,H+3,E] and
// d_ef [B,1,E] in the compute dtype and grads = dW2 [H,H] | dWc1 [H,H] |
// dsmall [H,6] in f32; partial [B*chunks, 2H^2+6H] f32 is scratch.
// Returns the cudaError_t of the launches (0 on success).
int egnn_tail_bwd(const void* valid, const void* ef, const void* w2,
                  const void* wc1, const void* small, const void* a1,
                  const void* xd, const void* dboth, void* dcat, void* def,
                  void* partial, void* grads, int B, int E, int H, int chunks,
                  int bf16, void* stream) {
  if (B < 1 || E < 0 || H != egnn::kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // no indices and no node count: d_both arrives gathered
  if (bf16) {
    return egnn::launch_tail<__nv_bfloat16, egnn::kHidden, egnn::kOperand>(
        nullptr, nullptr, v, ef, pw2, pwc1, psm, a1, xd, dboth, dcat,
        nullptr, def, pp, pg, B, 0, E, chunks, st);
  }
  return egnn::launch_tail<float, egnn::kHidden, egnn::kOperand>(
      nullptr, nullptr, v, ef, pw2, pwc1, psm, a1, xd, dboth, dcat, nullptr,
      def, pp, pg, B, 0, E, chunks, st);
}

}  // extern "C"
