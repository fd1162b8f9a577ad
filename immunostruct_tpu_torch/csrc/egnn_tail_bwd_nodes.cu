// B5b: the whole backward of one EGNN edge half-layer up to node space, for
// Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/pallas_mega.py::_tail_bwd_kernel_v7
// (launched by _tail_bwd_call_v7; JAX flag BWD_INKERNEL_NODES). Per graph,
// from the residuals a1/xd, ef and the node cotangent g [B,N,H+3] (the
// compute dtype): d_both = g[dst] (B5a), B2's chain backward, and d_cat =
// [d_a1 ; d_xd] (rounded to the compute dtype) summed in f32 into node space
// by src and by dst: d_nodes [B,N,2(H+3)] = [d_src | d_dst]. No [B,C,E]
// cotangent reaches device memory. d_ef and the f32 weight gradients as B2.
// The node finish (d_pa, d_pb, d_h, dW1ab; JAX _finish_node_grads) stays in
// PyTorch.
//
// What bounds it on the H100: B2's six HxH products per edge on the CUDA
// cores. What the design does about the node sums. The TPU kernel contracts
// d_cat with two [N,T] one-hots; a GPU scatters instead, and the port keeps
// every gradient the same from run to run, so no atomics:
//   - one CTA per graph owns its graph's rows of d_nodes (a 154 KB f32 block
//     at N=288, H=64, in device memory, mostly L2-resident: B2's tile
//     buffers already take 121 KB of shared memory, so the block does not
//     fit beside them);
//   - each of the 2(H+3) (side, channel) columns is owned by one thread,
//     which adds the tile's edges in edge order; eight loads are issued at
//     once and repeats of a node among the eight are resolved in registers,
//     so the read-add-write chain waits on one load in eight;
//   - the weight gradients: B2's per-block partials, reduced in block order.
// One CTA per graph gives B CTAs (B=128 on 132 SMs); B2 splits a graph's
// edges over chunks to fill the card at small B, which this layout cannot
// without a second pass.
// The body is egnn_common.cuh's tail_bwd_kernel<T, H, kNodes>.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

extern "C" {

// Shared memory one CTA of the main kernel needs for hidden width H.
long long egnn_tail_bwd_nodes_smem_bytes(int H) {
  return egnn::tail_smem_floats(H) * (long long)sizeof(float);
}

// One backward: B CTAs of 256 threads, then the reduction, both on
// `stream`. src/dst [B,E] int32, valid [B,E] bool; ef [B,E,1], a1 [B,H,E],
// xd [B,3,E], g [B,N,H+3] in the compute dtype (bf16 != 0: bfloat16, else
// float32); w2/wc1 [H,H], small [H,6] f32. Writes d_nodes [B,N,2(H+3)] f32,
// d_ef [B,1,E] in the compute dtype and grads = dW2 | dWc1 | dsmall in f32;
// partial [B, 2H^2+6H] f32 is scratch. Returns the cudaError_t of the
// launches (0 on success).
int egnn_tail_bwd_nodes(const void* src, const void* dst, const void* valid,
                        const void* ef, const void* w2, const void* wc1,
                        const void* small, const void* a1, const void* xd,
                        const void* g, void* dnodes, void* def,
                        void* partial, void* grads, int B, int N, int E,
                        int H, int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || H != egnn::kHidden) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pn = static_cast<float*>(dnodes);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return egnn::launch_tail<__nv_bfloat16, egnn::kHidden, egnn::kNodes>(
        s, d, v, ef, pw2, pwc1, psm, a1, xd, g, nullptr, pn, def, pp, pg, B,
        N, E, 1, st);
  }
  return egnn::launch_tail<float, egnn::kHidden, egnn::kNodes>(
      s, d, v, ef, pw2, pwc1, psm, a1, xd, g, nullptr, pn, def, pp, pg, B, N,
      E, 1, st);
}

}  // extern "C"
