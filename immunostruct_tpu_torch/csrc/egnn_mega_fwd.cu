// EGNN edge half-layer forward for Hopper (sm_90a), with the residuals the
// backward (csrc/egnn_tail_bwd.cu) reads.
//
// Replaces immunostruct_tpu/ops/pallas_mega.py::_mega_fwd_kernel (launched
// by _mega_fwd_call; public op edge_mega). Per graph b, per real edge s->d:
//
//   pa, pb  = h @ W1a, h @ W1b                  node-level projections
//   xd      = x[s] - x[d];  radial = |xd|^2;  x_hat = xd / (sqrt(radial)+1e-30)
//   a1      = pa[s] + pb[d] + w1r*radial + w1e*ef + b1
//   m       = silu(silu(a1) @ W2 + b2)
//   cw      = silu(m @ Wc1 + bc1) @ wc2
//   out[d] += [m ++ cw*x_hat]                   f32, [N, H+3]
//
// For training it also stores, per edge, a1 (after the f32 sum, before the
// silu, rounded to the compute dtype) into a1_out [B,H,E] and xd into
// xd_out [B,3,E], zeros for a skipped edge; null pointers skip both stores
// (inference).
//
// What bounds it on the H100. At the serving shapes (B=128, N=288, E=2560,
// H=64) one layer does 2*E*H*H = 21 M multiply-adds per graph in the two
// per-edge products, against ~0.2 MB of input per graph: it is bound by
// arithmetic and by the latency of the gathers and shared-memory atomics,
// not by device memory (~35 MB read per layer at 3.35 TB/s is ~10 us).
//
// What the design does about it. One CTA (256 threads) owns one graph, so
// the TPU kernel's one-hot gathers and one-hot aggregation matmul become
// indexed loads and shared-memory atomics, and no edge-space tensor ever
// reaches device memory:
//   phase 0  zero the [N, H+3] f32 accumulator in shared memory; stage W2,
//            Wc1 (rounded to the compute dtype) and the packed [H,6]
//            vectors in shared memory.
//   phase 1  pa/pb = h @ W1ab for the graph's N nodes (W1ab staged in the
//            edge-tile buffers), rounded to the compute dtype and written to
//            a per-graph [N, 2H] f32 scratch in device memory; it stays in
//            L1/L2 for the gathers.
//   phase 2  64-edge tiles: geometry per edge (mask and index bounds are
//            tested here: a padded edge is skipped, never read), a1 from the
//            gathered projections, then the two H x H products as a
//            register-tiled FMA GEMM over the tile (each thread 4 edges x
//            H/16 columns, operands in shared memory), m scattered into the
//            accumulator with shared-memory atomics, cw reduced across the
//            16 threads of a half-warp, cw*x_hat scattered likewise.
//            The a1 residual goes through an edge-tile buffer so that its
//            store in the [B,H,E] layout has neighbouring threads on
//            neighbouring edges (coalesced), as the xd store does.
//   end      the accumulator goes to device memory in one coalesced write.
// The products run on the CUDA cores in f32 (exact f32 arithmetic for the
// f32 path; bf16 values are held as f32 after rounding), a simple first
// form. Moving them to tensor cores (mma.sync / wgmma) and spreading one
// graph over several CTAs are the obvious next steps.
//
// Rounding points under bf16 are the TPU kernel's (pallas_mega.py:247-280,
// pallas_edge.py:104-139): weights rounded to bf16; pa/pb rounded, summed in
// f32; xd and radial rounded, radial > 0 guarded; silu(a1), m, the coord
// MLP's hidden layer and cw rounded; sigmoid/silu and all sums in f32.
//
// The phases' device code (stage_edge_weights, node_projections,
// geometry_tile, fwd_tile_chain) is in csrc/egnn_common.cuh, shared with the
// variants B4 and B6.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

namespace {

using namespace egnn;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_mega_fwd_kernel(const int* __restrict__ src,
                         const int* __restrict__ dst,
                         const uint8_t* __restrict__ mask,
                         const T* __restrict__ ef, const T* __restrict__ h,
                         const T* __restrict__ x,
                         const float* __restrict__ w1ab,
                         const float* __restrict__ w2,
                         const float* __restrict__ wc1,
                         const float* __restrict__ small,
                         float* __restrict__ out, float* proj,
                         T* __restrict__ a1_out, T* __restrict__ xd_out,
                         int N, int E, int F) {
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);

  extern __shared__ float smem[];
  float* acc = smem;                 // [N][C]
  float* w2s = acc + N * C;          // [H][H], row k = input unit k
  float* wc1s = w2s + H * H;         // [H][H]
  float* sms = wc1s + H * H;         // [6][H] (small transposed)
  float* bufA = sms + 6 * H;         // [kTile][LD]
  float* bufB = bufA + kTile * LD;   // [kTile][LD]
  const TileGeometry g = carve_geometry(bufB + kTile * LD);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* hb = h + (size_t)b * N * F;
  const T* xb = x + (size_t)b * N * 3;
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const T* efb = ef + (size_t)b * E;
  float* pab = proj + (size_t)b * N * 2 * H;  // [N][2H]: pa | pb
  T* a1b = a1_out == nullptr ? nullptr : a1_out + (size_t)b * H * E;
  T* xdb = xd_out == nullptr ? nullptr : xd_out + (size_t)b * 3 * E;

  // ---- phase 0: accumulator and weights ----
  for (int i = tid; i < N * C; i += kThreads) acc[i] = 0.0f;
  stage_edge_weights<T, H>(w2, wc1, small, w2s, wc1s, sms, tid);
  float* w1s = bufA;  // [2F][H]; fits: 2*F*H <= 2*kTile*LD for F <= kTile
  for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<T>(w1ab[i]);
  __syncthreads();

  // ---- phase 1: node projections ----
  node_projections<T, H>(nullptr, hb, F, w1s, N, F, pab, tid);
  __syncthreads();  // projections visible to the whole CTA; bufA free

  // ---- phase 2: 64-edge tiles ----
  for (int e0 = 0; e0 < E; e0 += kTile) {
    geometry_tile<T, T>(srcb, dstb, maskb, efb, xb, N, E, e0, xdb, g, tid);
    __syncthreads();
    fwd_tile_chain<T, H>(acc, w2s, wc1s, sms, bufA, bufB, g, pab, a1b, E,
                         tid);
  }

  float* ob = out + (size_t)b * N * C;
  for (int i = tid; i < N * C; i += kThreads) ob[i] = acc[i];
}

template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h, const void* x,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, float* out, float* proj, void* a1,
                   void* xd, int B, int N, int E, int F, cudaStream_t stream) {
  const size_t bytes = (size_t)fwd_smem_floats(N, H) * sizeof(float);
  auto kernel = egnn_mega_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h),
      static_cast<const T*>(x), w1ab, w2, wc1, small, out, proj,
      static_cast<T*>(a1), static_cast<T*>(xd), N, E, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes and hidden width H.
long long egnn_mega_fwd_smem_bytes(int N, int H) {
  return egnn::fwd_smem_floats(N, H) * (long long)sizeof(float);
}

// One launch: B CTAs of 256 threads on `stream`. src/dst [B,E] int32,
// mask [B,E] bool, ef [B,E,1], h [B,N,F], x [B,N,3] in the compute dtype
// (bf16 != 0: bfloat16, else float32); w1ab [2F,H], w2/wc1 [H,H],
// small [H,6] f32; out [B,N,H+3] f32; proj [B,N,2H] f32 scratch; a1
// [B,H,E] and xd [B,3,E] in the compute dtype, or both null (no residuals).
// Returns the cudaError_t of the launch (0 on success).
int egnn_mega_fwd(const void* src, const void* dst, const void* mask,
                  const void* ef, const void* h, const void* x,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, void* out, void* proj, void* a1,
                  void* xd, int B, int N, int E, int F, int H, int bf16,
                  void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > egnn::kTile ||
      H != egnn::kHidden || (a1 == nullptr) != (xd == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* pw1 = static_cast<const float*>(w1ab);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* po = static_cast<float*>(out);
  float* pp = static_cast<float*>(proj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2,
                                                pwc1, psm, po, pp, a1, xd, B,
                                                N, E, F, st);
  }
  return launch<float, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1, psm,
                                      po, pp, a1, xd, B, N, E, F, st);
}

}  // extern "C"
