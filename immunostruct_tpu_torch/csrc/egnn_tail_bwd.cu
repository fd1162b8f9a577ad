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
// What bounds it on the H100: bytes. At B=128, E=2560, H=64 in bf16 a
// launch reads a1 (42 MB), d_both (44 MB), xd, ef and valid and writes
// d_cat (44 MB) and d_ef: 133 MB, 0.040 ms at 3.35 TB/s (the count
// chip_smoke.py uses). Its arithmetic, six H x H products per edge (2 *
// 6 * E * H^2 = 14.5 GFLOP a launch), is 0.015 ms at the tensor cores' bf16
// peak, but 0.22 ms at the CUDA cores' f32 rate: on the CUDA cores the
// products, not the bytes, set the pace.
//
// What the design does about it (csrc/egnn_tail.cuh has the details):
//   - bf16: the six products run on the tensor cores (mma.sync m16n8k16,
//     bf16 operands from bf16 tiles in shared memory, f32 accumulation), one
//     warpgroup of 128 threads a CTA, ~100 KB of shared memory, so two CTAs
//     share an SM; the element-wise steps work on the accumulator fragments;
//   - the next 64-edge tile's a1, xd, ef and d_both come in by cp.async
//     while this one computes (two stages), so the device-memory traffic
//     overlaps the arithmetic;
//   - one CTA per (graph, edge chunk), enough CTAs to give every SM one;
//   - the weight gradients cross CTAs. On the TPU the grid runs in order
//     and carries them in a revisited block; here CTAs run in no order. Each
//     CTA keeps its share in registers over all its tiles and writes it to a
//     [blocks, 2H^2 + 6H] f32 scratch; a second kernel sums the scratch over
//     CTAs in CTA order. No atomics: the gradients are the same from run to
//     run;
//   - f32 keeps the CUDA-core form (tail_bwd_kernel: register-tiled FMA
//     loops over f32 tiles, 256 threads a CTA), so its f32 bounds hold; TF32
//     would break them.
//
// Rounding points under bf16 are the TPU kernel's (pallas_mega.py:400-479,
// pallas_edge.py:104-139): W2/Wc1 rounded; the chain recomputed from the
// rounded a1 with the forward's rounding points (a1s, m, c1, radial, and
// cw before it meets d_msgx); d_p3, d_p2, d_a1 rounded, d_xd and d_ef by
// their store in the compute dtype; d_m and W2 @ d_p2 are f32 sums; weight
// gradients are f32 sums of products of the rounded values. W2, Wc1, a1s
// and m reach the tensor cores in bf16, so their rounding is the operand's
// type itself. The tensor cores sum in another order than the plain
// version, so an element whose value lies within a few f32 units of a bf16
// rounding boundary is recomputed on the CUDA cores in the plain version's
// order before it rounds (near_tie in csrc/egnn_tail.cuh).
//
// The body is csrc/egnn_tail.cuh (mode kOperand), shared with the variants
// B5a and B5b.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_tail.cuh"

extern "C" {

// Shared memory one CTA of the main kernel needs for hidden width H and
// the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_tail_bwd_smem_bytes(int H, int bf16) {
  return egnn::tail_smem_bytes<egnn::kOperand>(H, bf16 != 0);
}

// One backward: B*chunks CTAs, then the reduction, both on `stream`. valid
// [B,E] bool; ef [B,E,1], a1 [B,H,E], xd [B,3,E], d_both [B,H+3,E] in the
// compute dtype (bf16 != 0: bfloat16, else float32); w2/wc1 [H,H], small
// [H,6] f32. Writes d_cat [B,H+3,E] and d_ef [B,1,E] in the compute dtype
// and grads = dW2 [H,H] | dWc1 [H,H] | dsmall [H,6] in f32; partial
// [B*chunks, 2H^2+6H] f32 is scratch. Returns the cudaError_t of the
// launches (0 on success).
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
        nullptr, nullptr, def, pp, pg, B, 0, E, chunks, st);
  }
  return egnn::launch_tail<float, egnn::kHidden, egnn::kOperand>(
      nullptr, nullptr, v, ef, pw2, pwc1, psm, a1, xd, dboth, dcat, nullptr,
      nullptr, def, pp, pg, B, 0, E, chunks, st);
}

}  // extern "C"
