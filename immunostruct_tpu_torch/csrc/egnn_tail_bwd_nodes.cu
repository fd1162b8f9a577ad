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
// What bounds it on the H100: bytes. At B=128, N=288, E=2560, H=64 in bf16
// a launch reads a1 (42 MB), xd, ef, valid, src, dst and g and writes
// d_nodes (20 MB f32) and d_ef: 73 MB, 0.022 ms at 3.35 TB/s. What the
// design does about it: B2's (csrc/egnn_tail.cuh, mode kNodes: tensor cores
// in bf16, the next tile's a1, xd, ef and rows g[dst] by cp.async while
// this one computes), and for the node sums:
//   - B2's grid, one CTA per (graph, edge chunk), so that B < 132 graphs
//     still fill the card. The TPU kernel contracts d_cat with two [N, T]
//     one-hots into one revisited block; here each chunk sums into an f32
//     node block of its own ([N, 2(H+3)], 154 KB at N=288, in device memory
//     and mostly L2-resident: it does not fit in shared memory beside two
//     CTAs' tiles), and a second kernel sums a graph's chunks in chunk order;
//     with one chunk the CTA writes d_nodes itself;
//   - in a tile, each side's edges are ranked by node, edge order kept
//     within a node (a counting sort, one thread per (side, edge)); each of
//     the 2(H+3) (side, channel) columns is one thread's, which adds a
//     node's edges in registers and does one read-add-write per node, with
//     the reads of 16 nodes in flight (a tile's nodes never alias, so no
//     read waits on a write);
//   - no atomics: every sum is f32 over the rounded d_cat in a fixed order,
//     the same bits from run to run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_tail.cuh"

extern "C" {

// Shared memory one CTA of the main kernel needs for hidden width H and
// the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_tail_bwd_nodes_smem_bytes(int H, int bf16) {
  return egnn::tail_smem_bytes<egnn::kNodes>(H, bf16 != 0);
}

// One backward: B*chunks CTAs, then the reductions, all on `stream`.
// src/dst [B,E] int32, valid [B,E] bool; ef [B,E,1], a1 [B,H,E], xd
// [B,3,E], g [B,N,H+3] in the compute dtype (bf16 != 0: bfloat16, else
// float32); w2/wc1 [H,H], small [H,6] f32. Writes d_nodes [B,N,2(H+3)] f32,
// d_ef [B,1,E] in the compute dtype and grads = dW2 | dWc1 | dsmall in f32;
// partial [B*chunks, 2H^2+6H] f32 is scratch, and so is node_partial
// [B*chunks, N, 2(H+3)] f32 when chunks > 1 (not read otherwise). Returns
// the cudaError_t of the launches (0 on success).
int egnn_tail_bwd_nodes(const void* src, const void* dst, const void* valid,
                        const void* ef, const void* w2, const void* wc1,
                        const void* small, const void* a1, const void* xd,
                        const void* g, void* dnodes, void* node_partial,
                        void* def, void* partial, void* grads, int B, int N,
                        int E, int H, int chunks, int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || H != egnn::kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pn = static_cast<float*>(dnodes);
  float* pq = static_cast<float*>(node_partial);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return egnn::launch_tail<__nv_bfloat16, egnn::kHidden, egnn::kNodes>(
        s, d, v, ef, pw2, pwc1, psm, a1, xd, g, nullptr, pn, pq, def, pp, pg,
        B, N, E, chunks, st);
  }
  return egnn::launch_tail<float, egnn::kHidden, egnn::kNodes>(
      s, d, v, ef, pw2, pwc1, psm, a1, xd, g, nullptr, pn, pq, def, pp, pg,
      B, N, E, chunks, st);
}

}  // extern "C"
