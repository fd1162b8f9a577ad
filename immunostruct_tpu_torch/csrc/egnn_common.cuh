// Device code shared by the EGNN kernels for Hopper (sm_90a): csrc/
// egnn_mega_fwd.cu (B1), csrc/egnn_tail_bwd.cu (B2) and their variants
// csrc/egnn_mega_paired_fwd.cu (B4), csrc/egnn_tail_bwd_db.cu (B5a),
// csrc/egnn_tail_bwd_nodes.cu (B5b), csrc/egnn_stack_fwd.cu (B6) and
// csrc/egnn_layer_fwd.cu (B7), and csrc/egnn_edge_bwd.cu (B3's backward).
//
//   rnd, sigmoid, silu, silu_grad, sum16
//                      the element-wise steps and rounding points;
//   tile_product, tile_product_k
//                      the f32 forms' products: register-tiled FMA loops
//                      over f32 tiles in shared memory (CUDA cores; f32 keeps
//                      them, since TF32 would break the f32 bounds);
//   node_projections   pa | pb = h @ W1ab for a graph's nodes, in f32 (B1 in
//                      both forms, B4, B6);
//   geometry_tile      the per-edge geometry from raw indices and the xd
//                      residual (B1 in both forms, B4, B6);
//   fwd_tile_chain     the edge chain over one 64-edge tile on the CUDA
//                      cores (a1, m, cw, the f32 aggregation with
//                      shared-memory atomics, the a1 residual): B1's f32
//                      form, B4, B6.
// The tensor-core forms (B1, B2, B5a, B5b and B3's backward in bf16) build
// on csrc/egnn_hopper.cuh, which includes this header. What bounds each
// kernel on the card and what its design does about it is in its source.
// Rounding points under bf16 are the TPU kernels' (pallas_mega.py,
// pallas_edge.py): see csrc/egnn_mega_fwd.cu and csrc/egnn_tail_bwd.cu.
//
// Each kernel is its own launch, from its own source's plain C interface.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace egnn {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // edges per tile: 16 edge groups x 4 edges
constexpr int kHidden = 64;  // H of every zoo model (gat_hidden_channels)
constexpr int kReduceThreads = 256;

// columns of the packed small [H, 6]
constexpr int kW1R = 0, kW1E = 1, kB1 = 2, kB2 = 3, kBC1 = 4, kWC2 = 5;

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// an f32 value stored in the compute dtype (round to nearest even)
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an f32 value to the compute dtype and back
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float silu(float v) { return v * sigmoid(v); }

// d silu / dx from the pre-activation and its sigmoid
__device__ __forceinline__ float silu_grad(float v, float s) {
  return s * (1.0f + v * (1.0f - s));
}

// sum over the 16 column groups: lanes 0-15 / 16-31 of the warp
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__host__ __device__ constexpr int row_stride(int hid) { return hid + 1; }

// acc[i][c] = sum_k A[tg*4+i][k] * W(k, cg*CPT+c), A rows of stride
// row_stride(H); W(k, j) at w[k*WLD + j] (kTransposed false) or
// w[j*WLD + k] (true)
template <int H, int WLD, bool kTransposed>
__device__ __forceinline__ void tile_product(const float* a, const float* w,
                                             int tg, int cg,
                                             float (&acc)[4][H / 16]) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    float av[4], wv[CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tg * 4 + i) * LD + k];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = cg * CPT + c;
      wv[c] = kTransposed ? w[j * WLD + k] : w[k * WLD + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
  }
}

// acc[i][c] = sum over k < K of A[tg*4+i][k] * W(k, cg*CPT+c), A rows of
// stride lda, W rows of stride row_stride(H): W(k, j) at w[k*LD + j]
// (kTransposed false) or w[j*LD + k] (true). The form of tile_product for a
// depth other than H (B3's backward, K = 2F).
template <int H, bool kTransposed>
__device__ __forceinline__ void tile_product_k(const float* a, int lda,
                                               const float* w, int K, int tg,
                                               int cg,
                                               float (&acc)[4][H / 16]) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], wv[CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tg * 4 + i) * lda + k];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = cg * CPT + c;
      wv[c] = kTransposed ? w[j * LD + k] : w[k * LD + j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
  }
}

// ---------------------------------------------------------------------------
// forward: B1's tile
// ---------------------------------------------------------------------------

// A tile's per-edge values in shared memory: x_hat [kTile][3], radial
// (rounded), ef, the gather/aggregation rows src/dst (0 on a skipped edge),
// ok (1: computed), and col, the edge's column in the [.,E] residuals (-1:
// none, the ragged end of the last tile).
struct TileGeometry {
  float* xh;
  float* rad;
  float* ef;
  int* src;
  int* dst;
  int* ok;
  int* col;
};

__host__ __device__ constexpr int geometry_floats() { return 9 * kTile; }

__device__ __forceinline__ TileGeometry carve_geometry(float* p) {
  TileGeometry g;
  g.xh = p;
  g.rad = p + 3 * kTile;
  g.ef = g.rad + kTile;
  g.src = reinterpret_cast<int*>(g.ef + kTile);
  g.dst = g.src + kTile;
  g.ok = g.dst + kTile;
  g.col = g.ok + kTile;
  return g;
}

// B1's geometry for edges e0 .. e0+kTile-1 of one graph, from raw indices
// (mask and index bounds tested before any load): xd = x[s] - x[d] and
// radial rounded, x_hat, ef. Writes the xd residual (zeros on a skipped
// edge) when xdb is not null. Run by threads 0 .. kTile-1; the caller
// synchronises.
template <typename T, typename XT>
__device__ __forceinline__ void geometry_tile(const int* srcb,
                                              const int* dstb,
                                              const uint8_t* maskb,
                                              const T* efb, const XT* xb,
                                              int N, int E, int e0, T* xdb,
                                              TileGeometry g, int tid) {
  if (tid >= kTile) return;
  const int e = e0 + tid;
  int s = 0, d = 0, ok = 0;
  float r = 0.0f, ev = 0.0f, h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (e < E) {
    s = srcb[e];
    d = dstb[e];
    ok = maskb[e] != 0 && s >= 0 && s < N && d >= 0 && d < N;
  }
  if (ok) {
    d0 = rnd<T>(to_f(xb[s * 3 + 0]) - to_f(xb[d * 3 + 0]));
    d1 = rnd<T>(to_f(xb[s * 3 + 1]) - to_f(xb[d * 3 + 1]));
    d2 = rnd<T>(to_f(xb[s * 3 + 2]) - to_f(xb[d * 3 + 2]));
    r = rnd<T>(d0 * d0 + d1 * d1 + d2 * d2);
    const float safe = r > 0.0f ? r : 1.0f;
    const float inv = 1.0f / (sqrtf(safe) + 1e-30f);
    h0 = d0 * inv;
    h1 = d1 * inv;
    h2 = d2 * inv;
    ev = to_f(efb[e]);
  } else {
    s = 0;
    d = 0;
  }
  if (xdb != nullptr && e < E) {
    xdb[0 * E + e] = from_f<T>(d0);
    xdb[1 * E + e] = from_f<T>(d1);
    xdb[2 * E + e] = from_f<T>(d2);
  }
  g.src[tid] = s;
  g.dst[tid] = d;
  g.ok[tid] = ok;
  g.col[tid] = e < E ? e : -1;
  g.rad[tid] = r;
  g.ef[tid] = ev;
  g.xh[tid * 3 + 0] = h0;
  g.xh[tid * 3 + 1] = h1;
  g.xh[tid * 3 + 2] = h2;
}

// B1's edge chain over one tile whose geometry is in shared memory (written
// and synchronised by the caller):
//   a1 = pa[src] + pb[dst] + w1r*radial + w1e*ef + b1
//   m = silu(silu(a1) @ W2 + b2) -> acc[dst][0..H-1] (shared-memory atomics)
//   cw = silu(m @ Wc1 + bc1) . wc2 -> acc[dst][H..H+2] += cw * x_hat
// pab [N][2H] holds pa | pb, rounded; w2s/wc1s [H][H] and sms [6][H] (small
// transposed) the weights, rounded; bufA/bufB [kTile][H+1] scratch. The a1
// residual goes to a1b[j*E + col] when a1b is not null. Ends synchronised.
template <typename T, int H>
__device__ __forceinline__ void fwd_tile_chain(
    float* acc, const float* w2s, const float* wc1s, const float* sms,
    float* bufA, float* bufB, TileGeometry g, const float* pab, T* a1b,
    int E, int tid) {
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;
  static_assert(H % 16 == 0, "H must be a multiple of 16");
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1

  // ---- a1 -> silu(a1) into bufA (and a1 into bufB for the residual) ----
  for (int i = tid; i < kTile * H; i += kThreads) {
    const int t = i / H, j = i % H;
    float v = 0.0f, a1 = 0.0f;
    if (g.ok[t]) {
      a1 = pab[g.src[t] * 2 * H + j] + pab[g.dst[t] * 2 * H + H + j];
      a1 = a1 + sms[kW1R * H + j] * g.rad[t];
      a1 = a1 + sms[kW1E * H + j] * g.ef[t];
      a1 = a1 + sms[kB1 * H + j];
      v = rnd<T>(silu(a1));
    }
    bufA[t * LD + j] = v;
    bufB[t * LD + j] = a1;
  }
  __syncthreads();
  if (a1b != nullptr) {  // uniform across the CTA
    // neighbouring threads on neighbouring edges: a coalesced store
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      if (g.col[t] >= 0) {
        a1b[(size_t)j * E + g.col[t]] = from_f<T>(bufB[t * LD + j]);
      }
    }
    __syncthreads();  // bufB is rewritten with m next
  }

  // ---- m = silu(silu(a1) @ W2 + b2): into bufB and the accumulator ----
  {
    float r[4][CPT];
    tile_product<H, H, false>(bufA, w2s, tg, cg, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg * 4 + i;
      const bool ok = g.ok[t] != 0;
      float* arow = acc + g.dst[t] * C;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = cg * CPT + c;
        const float mv = rnd<T>(silu(r[i][c] + sms[kB2 * H + j]));
        bufB[t * LD + j] = mv;
        if (ok) atomicAdd(arow + j, mv);
      }
    }
  }
  __syncthreads();

  // ---- cw = silu(m @ Wc1 + bc1) @ wc2; scatter cw * x_hat ----
  {
    float r[4][CPT];
    tile_product<H, H, false>(bufB, wc1s, tg, cg, r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg * 4 + i;
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = cg * CPT + c;
        const float c1 = rnd<T>(silu(r[i][c] + sms[kBC1 * H + j]));
        part += c1 * sms[kWC2 * H + j];
      }
      part = sum16(part);
      if (cg == 0 && g.ok[t]) {
        const float cwb = rnd<T>(part);
        float* arow = acc + g.dst[t] * C + H;
        atomicAdd(arow + 0, rnd<T>(cwb * g.xh[t * 3 + 0]));
        atomicAdd(arow + 1, rnd<T>(cwb * g.xh[t * 3 + 1]));
        atomicAdd(arow + 2, rnd<T>(cwb * g.xh[t * 3 + 2]));
      }
    }
  }
  __syncthreads();  // tile buffers and geometry are rewritten next tile
}

// W2, Wc1 (rounded to the compute dtype, [H][H]) and small transposed into
// shared memory; the caller synchronises.
template <typename T, int H>
__device__ __forceinline__ void stage_edge_weights(const float* w2,
                                                   const float* wc1,
                                                   const float* small,
                                                   float* w2s, float* wc1s,
                                                   float* sms, int tid) {
  for (int i = tid; i < H * H; i += kThreads) {
    w2s[i] = rnd<T>(w2[i]);
    wc1s[i] = rnd<T>(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
}

// pa | pb = h @ W1ab for N nodes into pab [N][2H], rounded; h rows of
// stride hld in f32 (hs, shared memory) or the compute dtype (hg, device
// memory), exactly one of them not null; w1s [2F][H] rounded weights. The
// caller synchronises.
template <typename T, int H>
__device__ __forceinline__ void node_projections(const float* hs,
                                                 const T* hg, int hld,
                                                 const float* w1s, int N,
                                                 int F, float* pab, int tid) {
  for (int i = tid; i < N * 2 * H; i += kThreads) {
    const int node = i / (2 * H), j = i % (2 * H);
    const float* wcol = w1s + (j / H) * F * H + (j % H);
    float s = 0.0f;
    if (hs != nullptr) {
      const float* hr = hs + node * hld;
      for (int f = 0; f < F; ++f) s += hr[f] * wcol[f * H];
    } else {
      const T* hr = hg + node * hld;
      for (int f = 0; f < F; ++f) s += to_f(hr[f]) * wcol[f * H];
    }
    pab[i] = rnd<T>(s);
  }
}

// shared-memory floats of a forward CTA: acc N*(H+3) | W2, Wc1 2*H*H |
// small^T 6*H | two edge-tile buffers 2*kTile*(H+1) | geometry
__host__ __device__ inline long long fwd_smem_floats(int n, int hid) {
  return (long long)n * (hid + 3) + 2LL * hid * hid + 6LL * hid +
         2LL * kTile * row_stride(hid) + geometry_floats();
}

}  // namespace egnn
