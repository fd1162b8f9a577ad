// B5a: backward of the EGNN edge chain with the aggregation's transpose in
// the kernel, for Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/pallas_mega.py::_tail_bwd_kernel_db
// (launched by _tail_bwd_call_db; JAX flag BWD_DBOTH_INKERNEL). It is B2
// (csrc/egnn_tail_bwd.cu) with the cotangent d_both = g[dst] formed in the
// kernel from g [B,N,H+3] (the compute dtype) and the raw dst indices,
// instead of read as a [B,H+3,E] operand that PyTorch gathered: the TPU
// kernel's one-hot dot is exact on a rounded g, so d_both is the same
// values, and with B2's block partition and fixed-order reduction the
// outputs are B2's bit for bit. The gather transposes (d_cat summed by src
// and by dst) stay PyTorch scatter-adds, as they stay XLA einsums in JAX.
//
// What bounds it on the H100: bytes, as B2. At B=128, E=2560, H=64 in bf16
// a launch reads a1 (42 MB), xd, ef, valid, dst and the rows g[dst] and
// writes d_cat (44 MB) and d_ef: 95 MB, against B2's 133 MB, since the
// [B,H+3,E] d_both tensor (44 MB) is neither written by a gather nor read.
// What the design does about it: B2's (csrc/egnn_tail.cuh, mode kGather,
// tensor cores in bf16). Each valid edge's row g[dst] (134 bytes, any
// alignment) comes in by cp.async as the 16-byte chunks that cover it, into
// the stage of the next tile while this one computes; the dst indices are
// read two tiles ahead so that those copies can start.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_tail.cuh"

extern "C" {

// Shared memory one CTA of the main kernel needs for hidden width H and
// the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_tail_bwd_db_smem_bytes(int H, int bf16) {
  return egnn::tail_smem_bytes<egnn::kGather>(H, bf16 != 0);
}

// One backward: B*chunks CTAs, then the reduction, both on `stream`. dst
// [B,E] int32, valid [B,E] bool; ef [B,E,1], a1 [B,H,E], xd [B,3,E], g
// [B,N,H+3] in the compute dtype (bf16 != 0: bfloat16, else float32);
// w2/wc1 [H,H], small [H,6] f32. Writes d_cat [B,H+3,E] and d_ef [B,1,E]
// in the compute dtype and grads = dW2 | dWc1 | dsmall in f32; partial
// [B*chunks, 2H^2+6H] f32 is scratch. Returns the cudaError_t of the
// launches (0 on success).
int egnn_tail_bwd_db(const void* dst, const void* valid, const void* ef,
                     const void* w2, const void* wc1, const void* small,
                     const void* a1, const void* xd, const void* g,
                     void* dcat, void* def, void* partial, void* grads,
                     int B, int N, int E, int H, int chunks, int bf16,
                     void* stream) {
  if (B < 1 || N < 1 || E < 0 || H != egnn::kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  const int* d = static_cast<const int*>(dst);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return egnn::launch_tail<__nv_bfloat16, egnn::kHidden, egnn::kGather>(
        nullptr, d, v, ef, pw2, pwc1, psm, a1, xd, g, dcat, nullptr, nullptr,
        def, pp, pg, B, N, E, chunks, st);
  }
  return egnn::launch_tail<float, egnn::kHidden, egnn::kGather>(
      nullptr, d, v, ef, pw2, pwc1, psm, a1, xd, g, dcat, nullptr, nullptr,
      def, pp, pg, B, N, E, chunks, st);
}

}  // extern "C"
