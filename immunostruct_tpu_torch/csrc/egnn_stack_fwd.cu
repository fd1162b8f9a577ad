// B6: the whole EGNN conv stack forward in one kernel, for Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/experimental/pallas_stack.py::
// _stack_fwd_kernel (launched by _stack_fwd_call; JAX flag STACK_ENABLE).
// One CTA per graph runs all L layers with h and x resident in shared
// memory. Per layer l (input width F = F0 for l = 0, else H):
//   edge half   B1 (csrc/egnn_mega_fwd.cu): pa | pb = h @ W1ab, then per
//               edge the chain of egnn_common.cuh fwd_tile_chain, summed in
//               f32 into agg [N][H+3] with shared-memory atomics;
//   agg         rounded to the compute dtype;
//   node MLP    p1 = [h ++ agg_h] @ nm0w + nm0b (f32 sum, f32 bias),
//               hmid = silu(p1) in f32, rounded;
//               h = hmid @ nm1w + nm1b (f32 sum, f32 bias), rounded;
//   coordinates x = x + agg_x in the compute dtype.
// These are the TPU kernel's rounding points (pallas_stack.py:148-175): one
// rounding fewer than the per-layer path's node update, which rounds p1
// before the silu. The weights are rounded to the compute dtype at use.
// For training it streams out, per layer, h and x after the layer
// (hs [B,L,N,H], xs [B,L,N,3]), agg (aggs [B,L,N,H+3]) and the edge half's
// residuals (a1s [B,L,H,E], xds [B,L,3,E]), all in the compute dtype; null
// pointers skip those stores (inference), and only the last layer's h and x
// are written (h_out [B,N,H], x_out [B,N,3]).
//
// What bounds it on the H100: the edge halves' HxH products per edge (B1's),
// plus the node MLP's [N,F+H]x[F+H,H] and [N,H]x[H,H] products per graph, all
// on the CUDA cores: bound by arithmetic. The edge sums use shared-memory
// atomics as B1's do, so agg (and what follows it) may differ in the last
// f32 bit from run to run.
//
// Design: B1's CTA (256 threads, 64-edge tiles), looped over the layers; no
// dependence between graphs, so B CTAs (B=128 on 132 SMs; one SM at B=1).
// Shared memory holds the f32 aggregate [N][H+3], h [N][H] and x [N][3] (the
// values in the compute dtype, held as f32), the layer's weights, two tile
// buffers and the tile's geometry: 224,768 B at N=288, H=64, checked against
// the card's per-block limit by the wrapper. pa/pb go to a per-graph f32
// scratch in device memory, as in B1. The node MLP runs in 64-row blocks:
// nm0w in the edge weights' place, nm1w in a tile buffer, hmid in the other.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

namespace {

using namespace egnn;

// floats of one layer's weights in the packed buffer, input width f:
// w1ab 2fH | w2 HH | wc1 HH | small 6H | nm0w (f+H)H | nm0b H | nm1w HH |
// nm1b H
__host__ __device__ inline long long layer_floats(int f, int hid) {
  return 2LL * f * hid + 3LL * hid * hid + 6LL * hid + (long long)(f + hid) *
         hid + 2LL * hid;
}

// shared-memory floats: acc N*(H+3) | h N*H | x N*3 | weights 2*H*H |
// small^T 6*H | node biases 2*H | two tile buffers 2*kTile*(H+1) | geometry
__host__ __device__ inline long long smem_floats(int n, int hid) {
  return (long long)n * (hid + 3) + (long long)n * hid + 3LL * n +
         2LL * hid * hid + 8LL * hid + 2LL * kTile * row_stride(hid) +
         geometry_floats();
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_stack_fwd_kernel(const int* __restrict__ src,
                          const int* __restrict__ dst,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ ef, const T* __restrict__ h0,
                          const T* __restrict__ x0,
                          const float* __restrict__ weights, float* proj,
                          T* __restrict__ h_out, T* __restrict__ x_out,
                          T* __restrict__ hs, T* __restrict__ xs,
                          T* __restrict__ aggs, T* __restrict__ a1s,
                          T* __restrict__ xds, int N, int E, int F0, int L) {
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;

  extern __shared__ float smem[];
  float* acc = smem;                 // [N][C] the layer's aggregate
  float* hsm = acc + N * C;          // [N][H] h (layer 0: F0 columns used)
  float* xsm = hsm + N * H;          // [N][3] x
  float* w2s = xsm + N * 3;          // [H][H]; node MLP: nm0w [F+H][H]
  float* wc1s = w2s + H * H;         // [H][H]
  float* sms = wc1s + H * H;         // [6][H] (small transposed)
  float* nbs = sms + 6 * H;          // [2][H] nm0b | nm1b
  float* bufA = nbs + 2 * H;         // [kTile][LD]; node MLP: hmid
  float* bufB = bufA + kTile * LD;   // [kTile][LD]; node MLP: nm1w [H][H]
  const TileGeometry g = carve_geometry(bufB + kTile * LD);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // row group: rows tg*4 .. tg*4+3 of a block
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const bool keep = hs != nullptr;  // residuals for the backward
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const T* efb = ef + (size_t)b * E;
  float* pab = proj + (size_t)b * N * 2 * H;  // [N][2H]: pa | pb

  for (int i = tid; i < N * F0; i += kThreads) {
    hsm[(i / F0) * H + i % F0] = to_f(h0[(size_t)b * N * F0 + i]);
  }
  for (int i = tid; i < N * 3; i += kThreads) {
    xsm[i] = to_f(x0[(size_t)b * N * 3 + i]);
  }

  const float* wl = weights;
  for (int l = 0; l < L; ++l) {
    const int F = l == 0 ? F0 : H;
    const float* w1ab = wl;
    const float* w2 = w1ab + 2 * F * H;
    const float* wc1 = w2 + H * H;
    const float* small = wc1 + H * H;
    const float* nm0w = small + 6 * H;
    const float* nm0b = nm0w + (F + H) * H;
    const float* nm1w = nm0b + H;
    const float* nm1b = nm1w + H * H;
    wl += layer_floats(F, H);
    const size_t bl = (size_t)b * L + l;

    // ---- edge half: accumulator, weights, node projections ----
    for (int i = tid; i < N * C; i += kThreads) acc[i] = 0.0f;
    stage_edge_weights<T, H>(w2, wc1, small, w2s, wc1s, sms, tid);
    float* w1s = bufA;  // [2F][H]; fits: 2*F*H <= 2*kTile*LD for F <= kTile
    for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<T>(w1ab[i]);
    __syncthreads();  // also: h and x of the layer are in place
    node_projections<T, H>(hsm, static_cast<const T*>(nullptr), H, w1s, N,
                           F, pab, tid);
    __syncthreads();

    T* a1l = keep ? a1s + bl * H * E : nullptr;
    T* xdl = keep ? xds + bl * 3 * E : nullptr;
    for (int e0 = 0; e0 < E; e0 += kTile) {
      geometry_tile<T, float>(srcb, dstb, maskb, efb, xsm, N, E, e0, xdl, g,
                              tid);
      __syncthreads();
      fwd_tile_chain<T, H>(acc, w2s, wc1s, sms, bufA, bufB, g, pab, a1l, E,
                           tid);
    }

    // ---- agg rounded; x += agg_x; the node MLP's weights ----
    for (int i = tid; i < N * C; i += kThreads) {
      const float v = rnd<T>(acc[i]);
      acc[i] = v;
      if (keep) aggs[bl * N * C + i] = from_f<T>(v);
    }
    __syncthreads();
    for (int i = tid; i < N * 3; i += kThreads) {
      const float v = rnd<T>(xsm[i] + acc[(i / 3) * C + H + i % 3]);
      xsm[i] = v;
      if (keep) xs[bl * N * 3 + i] = from_f<T>(v);
      if (l == L - 1) x_out[(size_t)b * N * 3 + i] = from_f<T>(v);
    }
    float* nm0s = w2s;   // [F+H][H]; fits: (F+H)*H <= 2*H*H for F <= H
    float* nm1s = bufB;  // [H][H]; fits: H*H <= kTile*LD for H <= kTile
    for (int i = tid; i < (F + H) * H; i += kThreads) nm0s[i] = rnd<T>(nm0w[i]);
    for (int i = tid; i < H * H; i += kThreads) nm1s[i] = rnd<T>(nm1w[i]);
    for (int i = tid; i < H; i += kThreads) {
      nbs[i] = nm0b[i];
      nbs[H + i] = nm1b[i];
    }
    __syncthreads();

    // ---- node MLP in blocks of kTile rows ----
    for (int r0 = 0; r0 < N; r0 += kTile) {
      float p[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) p[i][c] = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + tg * 4 + i;
        if (row >= N) continue;
        for (int k = 0; k < F; ++k) {
          const float hv = hsm[row * H + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            p[i][c] += hv * nm0s[k * H + cg * CPT + c];
          }
        }
        for (int k = 0; k < H; ++k) {
          const float av = acc[row * C + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            p[i][c] += av * nm0s[(F + k) * H + cg * CPT + c];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          bufA[(tg * 4 + i) * LD + j] = rnd<T>(silu(p[i][c] + nbs[j]));
        }
      __syncthreads();  // hmid complete; the block's h rows are read
      float q[4][CPT];
      tile_product<H, H, false>(bufA, nm1s, tg, cg, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + tg * 4 + i;
        if (row >= N) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float v = rnd<T>(q[i][c] + nbs[H + j]);
          hsm[row * H + j] = v;
          if (keep) hs[(bl * N + row) * H + j] = from_f<T>(v);
          if (l == L - 1) h_out[((size_t)b * N + row) * H + j] = from_f<T>(v);
        }
      }
      __syncthreads();  // bufA is rewritten by the next block
    }
  }
}

template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h0, const void* x0,
                   const float* weights, float* proj, void* h_out,
                   void* x_out, void* hs, void* xs, void* aggs, void* a1s,
                   void* xds, int B, int N, int E, int F0, int L,
                   cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(N, H) * sizeof(float);
  auto kernel = egnn_stack_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h0),
      static_cast<const T*>(x0), weights, proj, static_cast<T*>(h_out),
      static_cast<T*>(x_out), static_cast<T*>(hs), static_cast<T*>(xs),
      static_cast<T*>(aggs), static_cast<T*>(a1s), static_cast<T*>(xds), N,
      E, F0, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes and hidden width H.
long long egnn_stack_fwd_smem_bytes(int N, int H) {
  return smem_floats(N, H) * (long long)sizeof(float);
}

// Floats of the packed weights of L layers, the first of input width F0.
long long egnn_stack_fwd_weight_floats(int F0, int H, int L) {
  return layer_floats(F0, H) + (long long)(L - 1) * layer_floats(H, H);
}

// One launch: B CTAs of 256 threads on `stream`. src/dst [B,E] int32, mask
// [B,E] bool; ef [B,E,1], h0 [B,N,F0], x0 [B,N,3] in the compute dtype
// (bf16 != 0: bfloat16, else float32); weights: per layer, in order, w1ab
// [2F,H], w2 [H,H], wc1 [H,H], small [H,6], nm0w [F+H,H], nm0b [H], nm1w
// [H,H], nm1b [H], f32 (F = F0 for the first layer, else H); proj [B,N,2H]
// f32 scratch. Writes h_out [B,N,H] and x_out [B,N,3], and, unless hs is
// null (then xs, aggs, a1s and xds are null too), hs [B,L,N,H], xs
// [B,L,N,3], aggs [B,L,N,H+3], a1s [B,L,H,E] and xds [B,L,3,E], all in the
// compute dtype. Returns the cudaError_t of the launch.
int egnn_stack_fwd(const void* src, const void* dst, const void* mask,
                   const void* ef, const void* h0, const void* x0,
                   const void* weights, void* proj, void* h_out, void* x_out,
                   void* hs, void* xs, void* aggs, void* a1s, void* xds,
                   int B, int N, int E, int F0, int H, int L, int bf16,
                   void* stream) {
  const bool keep = hs != nullptr;
  if (B < 1 || N < 1 || E < 0 || F0 < 1 || F0 > H || H != egnn::kHidden ||
      L < 1 || keep != (xs != nullptr) || keep != (aggs != nullptr) ||
      keep != (a1s != nullptr) || keep != (xds != nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* w = static_cast<const float*>(weights);
  float* pp = static_cast<float*>(proj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, egnn::kHidden>(s, d, m, ef, h0, x0, w, pp,
                                                h_out, x_out, hs, xs, aggs,
                                                a1s, xds, B, N, E, F0, L, st);
  }
  return launch<float, egnn::kHidden>(s, d, m, ef, h0, x0, w, pp, h_out,
                                      x_out, hs, xs, aggs, a1s, xds, B, N, E,
                                      F0, L, st);
}

}  // extern "C"
