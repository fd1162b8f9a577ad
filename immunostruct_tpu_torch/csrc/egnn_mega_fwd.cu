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
// What bounds it on the H100: bytes, and at small B the number of SMs a
// graph reaches. At B=128, N=288, E=2560, F=H=64 in bf16 a launch with the
// residuals moves 62.4 MB (the a1 residual, 42 MB, most of it): 0.019 ms at
// 3.35 TB/s; without them 18.5 MB, 0.006 ms. Its arithmetic, the two H x H
// products per edge and the node projections (5.4 GFLOP), is 0.005 ms at
// the tensor cores' bf16 peak but 0.08 ms at the CUDA cores' f32 rate. One
// CTA per graph, as the f32 form runs, leaves a B=1 request on one SM.
//
// What the design does about it (bf16):
//   - the node projections pa | pb = h @ W1ab run first, in their own
//     kernel (egnn_mega_proj_kernel: a CTA per 32 nodes of a graph), with
//     node_projections' f32 arithmetic and order in register tiles
//     (proj_block), so B4's residuals and B6's layers stay B1's bit for bit;
//     rounded to bf16 into the proj scratch;
//   - the edges run one CTA per (graph, edge chunk), as the TPU kernel's
//     grid runs (graph, edge tile) and revisits the output block: a B=1
//     request reaches 20 CTAs at E=2560 (ops/mega.py fwd_chunks). Each
//     chunk sums its edges into an f32 node block [N][H+3] of its own in
//     shared memory, without atomics: a tile's m and coordinate messages
//     wait in shared memory and one thread a column adds them slot by slot,
//     the chunk's tiles in order (the two warpgroups pass the turn), so
//     each (n, c) is an f32 sum from +0 in one fixed order and a forward
//     gives the same bits every run; with one chunk the block is the
//     output, with more a second kernel sums the chunks' blocks in chunk
//     order (reduce_node_chunks);
//   - the chunk's 64-edge tiles alternate between two warpgroups (256
//     threads a CTA, one CTA an SM); in each, warp w owns edges
//     16w..16w+15 of a tile. A warpgroup's next tile loads while the other
//     computes: its edge indices into registers, the rows pa[src] and
//     pb[dst] by cp.async, its geometry. a1 and silu(a1) are formed in
//     registers in the A-operand layout of the tensor cores, and both H x H
//     products are mma.sync m16n8k16 (bf16 operands, W2/Wc1 by ldmatrix from
//     shared memory, each product added in f32: csrc/egnn_hopper.cuh). m goes
//     from the accumulator of the first product to the A operand of the
//     second in registers; no edge tile passes through shared memory, and a
//     warp waits on no other warp within a tile. The sigmoids run on the
//     special-function unit (sigmoid_fast) and the products' k order is
//     the tensor cores', so a value about to round to bf16 lies some f32
//     units from the plain version's. a1 is summed op by op in the plain
//     version's order (no fused multiply-add), and an a1s, m or c1 within
//     kTieUlps of a bf16 rounding boundary is recomputed in the plain
//     version's order (csrc/egnn_hopper.cuh near_tie: the IEEE sigmoid;
//     for m the a1s row, which waits in its pa row, and for c1 the f32 m
//     row, each summed in k order): without it one B=1 graph of B6, which
//     runs this body, flipped three a1s roundings in one layer and read
//     its h column past the per-column mean bound (PERF.md §6);
//   - its shared memory (the node block, W2/Wc1 bf16, two stages, one
//     tile's geometry) stays within the f32 form's, which ops/mega.py's
//     admission rule (fwd_smem_bytes) reckons with.
// The f32 form keeps the CUDA cores (one CTA of 256 threads per graph, the
// products register-tiled FMA loops over f32 tiles, the sums at dst one
// thread a column in edge order), so its f32 bounds hold (TF32 would break
// them) and it too gives the same bits every run.
//
// Rounding points under bf16 are the TPU kernel's (pallas_mega.py:247-280,
// pallas_edge.py:104-139): weights rounded to bf16; pa/pb rounded, summed in
// f32; xd and radial rounded, radial > 0 guarded; silu(a1), m, the coord
// MLP's hidden layer and cw rounded; sigmoid/silu and all sums in f32. W2,
// Wc1 and silu(a1) reach only the tensor cores, as bf16 operands.
//
// The bf16 form (egnn_mega_proj_kernel, egnn_mega_fwd_mma_kernel and their
// launch) is in csrc/egnn_mega.cuh, shared with the variant B4 through the
// tile policy (EdgeTiles here) and with B6, whose layers run its chunk body
// (mma_edge_chunk). The device code of the f32 form and of the
// projections and geometry (stage_edge_weights, node_projections,
// geometry_tile, fwd_tile_chain) is in csrc/egnn_common.cuh, shared with
// the variants B4 and B6.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_mega.cuh"

namespace {

using namespace egnn;

// The f32 form: one CTA (256 threads) per graph, the products on the CUDA
// cores (egnn_common.cuh's phases, shared with B4 and B6).
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

// shared memory of one CTA of the edge kernel: the f32 or the bf16 form
inline long long smem_bytes(int n, int hid, bool bf16) {
  return bf16 ? mma_smem_bytes(n)
              : fwd_smem_floats(n, hid) * (long long)sizeof(float);
}

// f32: the CUDA-core kernel over B CTAs. bf16: the projections, the edge
// kernel over B*chunks CTAs and, with chunks > 1, the chunks' node blocks
// (node_partial [B*chunks][N][H+3] f32 scratch) summed into out.
template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h, const void* x,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, float* out, float* proj,
                   float* node_partial, void* a1, void* xd, int B, int N,
                   int E, int F, int chunks, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_mma<EdgeTiles, H>(
        src, dst, mask, static_cast<const bf*>(ef), static_cast<const bf*>(h),
        static_cast<const bf*>(x), w1ab, w2, wc1, small, out, proj,
        node_partial, static_cast<bf*>(a1), static_cast<bf*>(xd), B, N, E, F,
        chunks, stream);
  } else {
    auto kernel = egnn_mega_fwd_kernel<T, H>;
    const size_t bytes = (size_t)smem_bytes(N, H, false);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<B, kThreads, bytes, stream>>>(
        src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h),
        static_cast<const T*>(x), w1ab, w2, wc1, small, out, proj,
        static_cast<T*>(a1), static_cast<T*>(xd), N, E, F);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA of the edge kernel needs for N nodes, hidden width
// H and the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_mega_fwd_smem_bytes(int N, int H, int bf16) {
  return smem_bytes(N, H, bf16 != 0);
}

// CTAs of the edge kernel that fit on one SM at once for N nodes, hidden
// width H and the compute dtype (the occupancy calculator's count), or -1
// on a CUDA error.
int egnn_mega_fwd_ctas_per_sm(int N, int H, int bf16) {
  if (bf16) return mma_ctas_per_sm<EdgeTiles>(N);
  const int bytes = (int)smem_bytes(N, H, false);
  auto kernel = egnn_mega_fwd_kernel<float, egnn::kHidden>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        egnn::kThreads, bytes);
  }
  return err == cudaSuccess ? n : -1;
}

// One forward on `stream`. src/dst [B,E] int32, mask [B,E] bool, ef
// [B,E,1], h [B,N,F], x [B,N,3] in the compute dtype (bf16 != 0: bfloat16,
// else float32); w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32; out [B,N,H+3]
// f32; proj [B,N,2H] f32 scratch (bf16 keeps pa | pb there in bf16); a1
// [B,H,E] and xd [B,3,E] in the compute dtype, or both null (no
// residuals). bf16 runs chunks CTAs per graph (f32: one); with chunks > 1
// node_partial [B*chunks,N,H+3] f32 is scratch, else it may be null.
// Returns the cudaError_t of the launches (0 on success).
int egnn_mega_fwd(const void* src, const void* dst, const void* mask,
                  const void* ef, const void* h, const void* x,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, void* out, void* proj,
                  void* node_partial, void* a1, void* xd, int B, int N, int E,
                  int F, int H, int chunks, int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > egnn::kTile ||
      H != egnn::kHidden || (a1 == nullptr) != (xd == nullptr) ||
      chunks < 1 || (bf16 && chunks > 1 && node_partial == nullptr)) {
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
  float* pn = static_cast<float*>(node_partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2,
                                                pwc1, psm, po, pp, pn, a1, xd,
                                                B, N, E, F, chunks, st);
  }
  return launch<float, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1, psm,
                                      po, pp, pn, a1, xd, B, N, E, F, 1, st);
}

}  // extern "C"
