// Device code shared by the 'mega' EGNN kernels for Hopper (sm_90a):
// csrc/egnn_mega_fwd.cu (B1), csrc/egnn_tail_bwd.cu (B2) and their variants
// csrc/egnn_mega_paired_fwd.cu (B4), csrc/egnn_tail_bwd_db.cu (B5a),
// csrc/egnn_tail_bwd_nodes.cu (B5b) and csrc/egnn_stack_fwd.cu (B6).
//
//   geometry_tile      the per-edge geometry from raw indices (B1, B6);
//   fwd_tile_chain     the edge chain over one 64-edge tile whose geometry
//                      is in shared memory (a1, m, cw, the f32 aggregation
//                      with shared-memory atomics, the a1 residual store;
//                      B1, B4, B6);
//   tail_bwd_kernel    the chain's backward from the residuals (B2, with
//                      d_both an operand; B5a, reading g[dst] itself; B5b,
//                      also summing d_cat into node space by src and dst).
// The sources say what each kernel computes, what bounds it and what its
// design does about it. Rounding points under bf16 are the TPU kernels'
// (pallas_mega.py, pallas_edge.py): see csrc/egnn_mega_fwd.cu and
// csrc/egnn_tail_bwd.cu.
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

// ---------------------------------------------------------------------------
// backward: B2's body; B5a reads d_both = g[dst] itself; B5b also sums the
// node cotangents
// ---------------------------------------------------------------------------

// where the cotangent of [m ++ cw*x_hat] comes from
constexpr int kOperand = 0;  // B2: d_both [B,H+3,E], gathered by the caller
constexpr int kGather = 1;   // B5a: g [B,N,H+3], row dst[e] read here
constexpr int kNodes = 2;    // B5b: as kGather, and d_cat summed into nodes

// width of one block's partial gradients: dW2 | dWc1 | dsmall
__host__ __device__ constexpr int grad_width(int hid) {
  return 2 * hid * hid + 6 * hid;
}

// shared-memory floats: W2, Wc1 2*H*(H+1) | small^T 6*H | five edge-tile
// buffers 5*kTile*(H+1) | per-edge values 11*kTile | ok, src, dst ints
// 3*kTile | d_xd 3*kTile
__host__ __device__ inline long long tail_smem_floats(int hid) {
  return 2LL * hid * row_stride(hid) + 6LL * hid +
         5LL * kTile * row_stride(hid) + 17LL * kTile;
}

// Per graph b (blocks b*chunks .. b*chunks+chunks-1, each a chunk of
// edges), per valid edge e, from a1 [H], xd [3], ef and the cotangent
// d_both [H+3] of [m ++ cw*x_hat]: csrc/egnn_tail_bwd.cu's chain backward
// -> d_a1, d_xd, d_ef, and the weight gradients as per-block partials.
// kMode kOperand (B2): d_both read from cot = d_both [B,H+3,E]; kGather
//   (B5a): d_both = row dst[e] of cot = g [B,N,H+3] (the compute dtype, as
//   g arrives); both write d_cat [B,H+3,E] = [d_a1 ; d_xd] and d_ef.
// kMode kNodes (B5b, chunks 1): as kGather, but d_cat never leaves shared
//   memory; each of the 2(H+3) columns of dnodes [B][N][2(H+3)] (src side,
//   then dst side) is owned by one thread, which adds the tile's edges in
//   edge order: dnodes[b][src[e]][k] += d_cat[k][e],
//   dnodes[b][dst[e]][H+3+k] += d_cat[k][e], in f32, eight edges at a time
//   with the repeats among them resolved in registers. No atomics: the sums
//   are the same from run to run.
template <typename T, int H, int kMode>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const uint8_t* __restrict__ valid,
                    const T* __restrict__ ef, const float* __restrict__ w2,
                    const float* __restrict__ wc1,
                    const float* __restrict__ small,
                    const T* __restrict__ a1, const T* __restrict__ xd,
                    const T* __restrict__ cot, T* __restrict__ dcat,
                    float* __restrict__ dnodes, T* __restrict__ def,
                    float* __restrict__ partial, int N, int E, int chunks,
                    int chunk_edges) {
  constexpr bool kNodeSums = kMode == kNodes;
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");

  extern __shared__ float smem[];
  float* w2s = smem;                 // [H][LD], row k = input unit k
  float* wc1s = w2s + H * LD;        // [H][LD]
  float* sms = wc1s + H * LD;        // [6][H] (small transposed)
  float* bufA = sms + 6 * H;         // [kTile][LD] a1s
  float* bufM = bufA + kTile * LD;   // [kTile][LD] m
  float* bufG = bufM + kTile * LD;   // [kTile][LD] silu'(a1), then d_a1
  float* bufP3 = bufG + kTile * LD;  // [kTile][LD] d_p3
  float* bufP2 = bufP3 + kTile * LD; // [kTile][LD] d_m_in, then d_p2
  float* radv = bufP2 + kTile * LD;  // [kTile] radial (rounded)
  float* invv = radv + kTile;        // [kTile] 1 / (sqrt(radial) + 1e-30)
  float* efv = invv + kTile;         // [kTile]
  float* cwv = efv + kTile;          // [kTile] cw (rounded)
  float* dcwv = cwv + kTile;         // [kTile] d_cw
  float* xdv = dcwv + kTile;         // [3][kTile]
  float* dmxv = xdv + 3 * kTile;     // [3][kTile] d_msgx
  int* okv = reinterpret_cast<int*>(dmxv + 3 * kTile);
  int* srcv = okv + kTile;           // [kTile] src (0 on a skipped edge)
  int* dstv = srcv + kTile;          // [kTile] dst (0 on a skipped edge)
  float* dxv = reinterpret_cast<float*>(dstv + kTile);  // [3][kTile] d_xd

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const int* srcb = kNodeSums ? src + (size_t)b * E : nullptr;
  const int* dstb = kMode == kOperand ? nullptr : dst + (size_t)b * E;
  const uint8_t* vb = valid + (size_t)b * E;
  const T* efb = ef + (size_t)b * E;
  const T* a1b = a1 + (size_t)b * H * E;
  const T* xdb = xd + (size_t)b * 3 * E;
  // d_both [C][E] of this graph (kOperand), or g [N][C] (the others)
  const T* cb = cot + (size_t)b * (kMode == kOperand ? C * E : N * C);
  T* dcb = kNodeSums ? nullptr : dcat + (size_t)b * C * E;
  T* defb = def + (size_t)b * E;
  float* dnb = kNodeSums ? dnodes + (size_t)b * N * 2 * C : nullptr;

  // ---- weights, rounded to the compute dtype ----
  for (int i = tid; i < H * H; i += kThreads) {
    const int k = i / H, j = i % H;
    w2s[k * LD + j] = rnd<T>(w2[i]);
    wc1s[k * LD + j] = rnd<T>(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
  if (kNodeSums && tid < 2 * C) {
    // this thread's column of the graph's node sums starts at zero
    for (int n = 0; n < N; ++n) dnb[(size_t)n * 2 * C + tid] = 0.0f;
  }

  // this thread's share of the weight gradients, summed over its tiles:
  // dW2/dWc1 rows tg*4+r, columns cg*CPT+c; dsmall columns cg*CPT+c
  float gw2[4][CPT], gwc1[4][CPT], gsm[6][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gw2[r][c] = gwc1[r][c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gsm[k][c] = 0.0f;
  __syncthreads();

  for (int e0 = e_begin; e0 < e_end; e0 += kTile) {
    // ---- per-edge geometry and coordinate cotangent d_both[H..H+2] ----
    if (tid < kTile) {
      const int e = e0 + tid;
      const int ok = e < e_end && vb[e] != 0;
      int s = 0, d = 0;
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, m0 = 0.0f, m1 = 0.0f,
            m2 = 0.0f, ev = 0.0f;
      if (ok) {
        if (kNodeSums) s = srcb[e];
        x0 = to_f(xdb[0 * E + e]);
        x1 = to_f(xdb[1 * E + e]);
        x2 = to_f(xdb[2 * E + e]);
        if (kMode == kOperand) {
          m0 = to_f(cb[(size_t)(H + 0) * E + e]);
          m1 = to_f(cb[(size_t)(H + 1) * E + e]);
          m2 = to_f(cb[(size_t)(H + 2) * E + e]);
        } else {
          d = dstb[e];
          const T* grow = cb + (size_t)d * C + H;
          m0 = to_f(grow[0]);
          m1 = to_f(grow[1]);
          m2 = to_f(grow[2]);
        }
        ev = to_f(efb[e]);
      }
      const float r = rnd<T>(x0 * x0 + x1 * x1 + x2 * x2);
      const float safe = r > 0.0f ? r : 1.0f;
      okv[tid] = ok;
      srcv[tid] = s;
      dstv[tid] = d;
      radv[tid] = r;
      invv[tid] = 1.0f / (sqrtf(safe) + 1e-30f);
      efv[tid] = ev;
      xdv[0 * kTile + tid] = x0;
      xdv[1 * kTile + tid] = x1;
      xdv[2 * kTile + tid] = x2;
      dmxv[0 * kTile + tid] = m0;
      dmxv[1 * kTile + tid] = m1;
      dmxv[2 * kTile + tid] = m2;
    }
    // ---- a1 -> a1s, silu'(a1); d_m_in from d_both (coalesced: t fastest)
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      const int e = e0 + t;
      float a = 0.0f, dm = 0.0f;
      if (e < e_end && vb[e] != 0) {
        a = to_f(a1b[(size_t)j * E + e]);
        if (kMode == kOperand) dm = to_f(cb[(size_t)j * E + e]);
      }
      const float s = sigmoid(a);
      bufA[t * LD + j] = rnd<T>(a * s);
      bufG[t * LD + j] = silu_grad(a, s);
      if (kMode == kOperand) bufP2[t * LD + j] = dm;
    }
    __syncthreads();
    if (kMode != kOperand) {
      // ---- d_m_in = g[dst][0..H-1] (coalesced: a row's channels in turn);
      // bufP2 is first read after the next barriers ----
      for (int i = tid; i < kTile * H; i += kThreads) {
        const int t = i / H, j = i % H;
        bufP2[t * LD + j] =
            okv[t] ? to_f(cb[(size_t)dstv[t] * C + j]) : 0.0f;
      }
    }

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[4][CPT];
    {
      float acc[4][CPT];
      tile_product<H, LD, false>(bufA, w2s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float p = acc[i][c] + sms[kB2 * H + j];
          const float s = sigmoid(p);
          bufM[t * LD + j] = rnd<T>(p * s);
          g2[i][c] = silu_grad(p, s);
        }
    }
    __syncthreads();

    // ---- p3 = m @ Wc1 + bc1 -> c1, cw; keep silu'(p3) and c1 ----
    float g3[4][CPT], c1v[4][CPT];
    {
      float acc[4][CPT];
      tile_product<H, LD, false>(bufM, wc1s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float p = acc[i][c] + sms[kBC1 * H + j];
          const float s = sigmoid(p);
          c1v[i][c] = rnd<T>(p * s);
          g3[i][c] = silu_grad(p, s);
          part += c1v[i][c] * sms[kWC2 * H + j];
        }
        const float cw = sum16(part);
        if (cg == 0) {
          // d_cw = d_msgx . x_hat, x_hat = xd / (sqrt(radial) + 1e-30)
          const float inv = invv[t];
          cwv[t] = rnd<T>(cw);
          dcwv[t] = dmxv[0 * kTile + t] * (xdv[0 * kTile + t] * inv) +
                    dmxv[1 * kTile + t] * (xdv[1 * kTile + t] * inv) +
                    dmxv[2 * kTile + t] * (xdv[2 * kTile + t] * inv);
        }
      }
    }
    __syncthreads();

    // ---- d_p3 = wc2 * d_cw * silu'(p3); d bc1, d wc2 ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg * 4 + i;
      const float dcw = dcwv[t];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = cg * CPT + c;
        const float dp3 = rnd<T>(sms[kWC2 * H + j] * dcw * g3[i][c]);
        bufP3[t * LD + j] = dp3;
        gsm[kBC1][c] += dp3;
        gsm[kWC2][c] += c1v[i][c] * dcw;
      }
    }
    __syncthreads();

    // ---- d_m = d_m_in + Wc1 @ d_p3; d_p2 = d_m * silu'(p2); d b2 ----
    {
      float acc[4][CPT];
      tile_product<H, LD, true>(bufP3, wc1s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float dm = bufP2[t * LD + j] + acc[i][c];
          const float dp2 = rnd<T>(dm * g2[i][c]);
          bufP2[t * LD + j] = dp2;  // read and written by this thread only
          gsm[kB2][c] += dp2;
        }
    }
    __syncthreads();

    // ---- d_a1 = (W2 @ d_p2) * silu'(a1); d w1r, d w1e, d b1; d_xd, d_ef ----
    {
      float acc[4][CPT];
      tile_product<H, LD, true>(bufP2, w2s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float prad = 0.0f, pef = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float da = rnd<T>(acc[i][c] * bufG[t * LD + j]);
          bufG[t * LD + j] = da;  // read and written by this thread only
          gsm[kW1R][c] += da * radv[t];
          gsm[kW1E][c] += da * efv[t];
          gsm[kB1][c] += da;
          prad += sms[kW1R * H + j] * da;
          pef += sms[kW1E * H + j] * da;
        }
        const float d_rad_chain = sum16(prad);
        const float d_ef = sum16(pef);
        const int e = e0 + t;
        if (cg == 0 && e < e_end) {
          float dx[3] = {0.0f, 0.0f, 0.0f}, dfe = 0.0f;
          if (okv[t]) {
            const float r = radv[t], inv = invv[t], cwb = cwv[t];
            const float safe = r > 0.0f ? r : 1.0f;
            float sum_dxh_xd = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              sum_dxh_xd += dmxv[k * kTile + t] * cwb * xdv[k * kTile + t];
            }
            const float d_safe =
                sum_dxh_xd * (-0.5f) * inv * inv / sqrtf(safe);
            const float d_rad = d_rad_chain + (r > 0.0f ? d_safe : 0.0f);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              dx[k] = dmxv[k * kTile + t] * cwb * inv +
                      2.0f * xdv[k * kTile + t] * d_rad;
            }
            dfe = d_ef;
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (kNodeSums) {
              dxv[k * kTile + t] = rnd<T>(dx[k]);
            } else {
              dcb[(size_t)(H + k) * E + e] = from_f<T>(dx[k]);
            }
          }
          defb[e] = from_f<T>(dfe);
        }
      }
    }
    __syncthreads();

    if (kNodeSums) {
      // ---- d_cat summed into node space: one thread per (side, column),
      // the tile's edges in order, eight at a time ----
      if (tid < 2 * C) {
        const int side = tid / C, k = tid % C;
        const int* idxv = side == 0 ? srcv : dstv;
        float* col = dnb + tid;  // rows of stride 2C
        for (int t0 = 0; t0 < kTile; t0 += 8) {
          int idx[8];
          float add[8], cur[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int t = t0 + u;
            const bool ok = okv[t] != 0;
            idx[u] = ok ? idxv[t] : -1;
            add[u] = !ok ? 0.0f
                         : (k < H ? bufG[t * LD + k]
                                  : dxv[(k - H) * kTile + t]);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            cur[u] = idx[u] >= 0 ? col[(size_t)idx[u] * 2 * C] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float base = cur[u];
#pragma unroll
            for (int v = 0; v < u; ++v) {
              if (idx[v] == idx[u]) base = cur[v];
            }
            cur[u] = base + add[u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (idx[u] >= 0) col[(size_t)idx[u] * 2 * C] = cur[u];
          }
        }
      }
    } else {
      // ---- d_a1 into d_cat (coalesced) ----
      for (int i = tid; i < kTile * H; i += kThreads) {
        const int j = i / kTile, t = i % kTile;
        if (e0 + t < e_end) {
          dcb[(size_t)j * E + e0 + t] =
              from_f<T>(okv[t] ? bufG[t * LD + j] : 0.0f);
        }
      }
    }
    // ---- dW2 += a1s (x) d_p2, dWc1 += m (x) d_p3 ----
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float av[4], mv[4], p2v[CPT], p3v[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = bufA[t * LD + tg * 4 + r];
        mv[r] = bufM[t * LD + tg * 4 + r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        p2v[c] = bufP2[t * LD + cg * CPT + c];
        p3v[c] = bufP3[t * LD + cg * CPT + c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gw2[r][c] += av[r] * p2v[c];
          gwc1[r][c] += mv[r] * p3v[c];
        }
    }
    __syncthreads();  // tile buffers and per-edge values are rewritten next
  }

  // ---- this block's partial gradients: dW2 | dWc1 | dsmall [H][6] ----
  float* pb = partial + (size_t)blockIdx.x * grad_width(H);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int row = tg * 4 + r, col = cg * CPT + c;
      pb[row * H + col] = gw2[r][c];
      pb[H * H + row * H + col] = gwc1[r][c];
    }
  float* red = bufA;  // [16 edge groups][6][H], over the free tile buffers
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      red[(tg * 6 + k) * H + cg * CPT + c] = gsm[k][c];
    }
  __syncthreads();
  for (int i = tid; i < 6 * H; i += kThreads) {
    const int j = i / 6, k = i % 6;
    float s = 0.0f;
    for (int q = 0; q < 16; ++q) s += red[(q * 6 + k) * H + j];
    pb[2 * H * H + i] = s;
  }
}

// grads[i] = sum over blocks, in block order, of partial[block][i]
__global__ void __launch_bounds__(kReduceThreads)
    reduce_blocks(const float* __restrict__ partial, int blocks, int width,
                  float* __restrict__ grads) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * width + i];
  grads[i] = s;
}

// tail_bwd_kernel over B*chunks blocks, then the reduction
template <typename T, int H, int kMode>
cudaError_t launch_tail(const int* src, const int* dst,
                        const uint8_t* valid, const void* ef,
                        const float* w2, const float* wc1, const float* small,
                        const void* a1, const void* xd, const void* cot,
                        void* dcat, float* dnodes, void* def, float* partial,
                        float* grads, int B, int N, int E, int chunks,
                        cudaStream_t stream) {
  const size_t bytes = (size_t)tail_smem_floats(H) * sizeof(float);
  auto kernel = tail_bwd_kernel<T, H, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // edges per chunk: a whole number of tiles
  const int per = (E + chunks - 1) / chunks;
  const int chunk_edges = (per + kTile - 1) / kTile * kTile;
  const int blocks = B * chunks;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      src, dst, valid, static_cast<const T*>(ef), w2, wc1, small,
      static_cast<const T*>(a1), static_cast<const T*>(xd),
      static_cast<const T*>(cot), static_cast<T*>(dcat), dnodes,
      static_cast<T*>(def), partial, N, E, chunks, chunk_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = grad_width(H);
  reduce_blocks<<<(width + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, stream>>>(partial, blocks, width, grads);
  return cudaGetLastError();
}

}  // namespace egnn
