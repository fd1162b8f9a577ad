// Backward of the EGNN edge program for Hopper (sm_90a), over pre-gathered
// edge bundles. Nothing is saved from the forward: the chain is recomputed
// from the inputs.
//
// Replaces immunostruct_tpu/ops/pallas_edge.py::_bwd_kernel (launched by
// _bwd_call; the custom VJP of edge_program keeps only the inputs). Per
// graph b, per edge e of hsx, hdx [B,F+3,E], ef [B,1,E] and the cotangent
// dout = [d_m_in (H) ; d_msgx (3)] of [m ; cw*x_hat]:
//
//   recompute  xd, radial, x_hat; a1 = W1ab^T [hs ; hd] + w1r*radial +
//              w1e*ef + b1; a1s = silu(a1); p2 = a1s@W2 + b2; m = silu(p2);
//              p3 = m@Wc1 + bc1; c1 = silu(p3); cw = c1 . wc2
//   back       d_cw = d_msgx . x_hat;  d_xhat = d_msgx * cw
//              d_p3 = wc2 * d_cw * silu'(p3);  d_m = d_m_in + Wc1 @ d_p3
//              d_p2 = d_m * silu'(p2);  d_a1 = (W2 @ d_p2) * silu'(a1)
//              d_hsd = W1ab @ d_a1
//              d_rad = w1r . d_a1 + [radial > 0] d|x_hat|/d radial
//              d_xd = d_xhat / s + 2 xd d_rad;  d_ef = w1e . d_a1
//   out        dhsx[:,e] = [d_hsd[:F] ; d_xd], dhdx[:,e] = [d_hsd[F:] ; -d_xd]
//              [B,F+3,E]; def[e] = d_ef [B,1,E]
//   sums (f32) dW1ab += [hs ; hd] (x) d_a1;  dW2 += a1s (x) d_p2;
//              dWc1 += m (x) d_p3;
//              dsmall += [d_a1*radial, d_a1*ef, d_a1, d_p2, d_p3, c1*d_cw]
//
// What bounds it on the H100. Per edge, nine products: three to recompute
// the chain (2F x H, H x H, H x H), three back through Wc1, W2 and W1ab, and
// three outer products for dWc1, dW2 and dW1ab. At B=128, E=2560, F=H=64
// that is 2*E*(3*2F*H + 6*H*H) = 252 M multiply-adds per graph, 32 GFLOP
// per launch, against ~221 MB moved (hsx, hdx, dout read, dhsx, dhdx
// written, in bf16): ~66 us at 3.35 TB/s; the FLOPs on the CUDA cores in
// f32 (67 TFLOP/s) take ~0.48 ms, so a first form on the CUDA cores is
// bound by arithmetic.
//
// What the design does (the shape of csrc/egnn_tail_bwd.cu, B2):
//   - one CTA of 256 threads per (graph, edge chunk), enough CTAs to give
//     every SM one; 64-edge tiles inside;
//   - W1ab, W2 and Wc1, rounded to the compute dtype, sit in shared memory
//     with a padded row (H+1), so that W @ v and W^T @ v both read them
//     with at most 2-way bank conflicts; every product is a register-tiled
//     FMA loop (each thread 4 edges x H/16 columns);
//   - the tile's operands ([hs ; hd], a1s, m, silu'(a1) -> d_a1, d_p3,
//     d_m_in -> d_p2) live in shared memory; bundles, cotangents and the
//     outputs move between device memory and shared memory with
//     neighbouring threads on neighbouring edges (coalesced in [B,C,E]);
//   - the weight gradients cross blocks. On the TPU the grid runs in order
//     and carries them in a revisited output block; here blocks run in no
//     order. Each thread keeps its 4 x H/16 share of dW2 and dWc1 and its
//     columns of dsmall in registers over all its tiles, and its 8 x H/16
//     share of dW1ab in shared memory (no other thread touches it); the
//     CTA writes them to a [blocks, 2F*H + 2H^2 + 6H] f32 scratch, and a
//     second kernel sums the scratch over blocks in block order. No
//     atomics: the gradients are the same from run to run.
// Tensor cores (mma.sync / wgmma) for the nine products are the next step.
//
// Rounding points under bf16 are the TPU kernel's (pallas_edge.py:104-256):
// W1ab/W2/Wc1 rounded; the chain recomputed with the forward's rounding
// points (xd, radial, a1s, m, c1, and cw before it meets d_msgx); d_p3,
// d_p2, d_a1 and d_hsd rounded, d_xd and d_ef by their store in the compute
// dtype; d_m and W2 @ d_p2 are f32 sums; weight gradients are f32 sums of
// products of the rounded values, dsmall's radial column against the
// rounded radial.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;    // edges per tile: 16 edge groups x 4 edges
constexpr int kHidden = 64;  // H of every zoo model (gat_hidden_channels)
constexpr int kMaxF = 64;
constexpr int kRows1 = 2 * kMaxF / 16;  // dW1ab rows per thread
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

// shared-memory floats: W1ab 2F*(H+1) | W2, Wc1 2*H*(H+1) | small^T 6*H |
// feature tile kTile*(2F+1) | five edge-tile buffers 5*kTile*(H+1) | the
// dW1ab shares 2F*H | per-edge values 11*kTile
__host__ __device__ inline long long smem_floats(int f, int hid) {
  return 2LL * f * row_stride(hid) + 2LL * hid * row_stride(hid) +
         6LL * hid + (long long)kTile * (2 * f + 1) +
         5LL * kTile * row_stride(hid) + 2LL * f * hid + 11LL * kTile;
}

// width of one block's partial gradients: dW1ab | dW2 | dWc1 | dsmall
__host__ __device__ inline int grad_width(int f, int hid) {
  return 2 * f * hid + 2 * hid * hid + 6 * hid;
}

// acc[i][c] = sum_k A[tg*4+i][k] * W(k, cg*CPT+c), A at a[row*lda + k];
// W(k, j) at w[k*LD + j] (kTransposed false) or w[j*LD + k] (true)
template <int H, bool kTransposed>
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* w, int K, int tg,
                                             int cg, float (&acc)[4][H / 16]) {
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

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_edge_bwd_kernel(const T* __restrict__ hsx, const T* __restrict__ hdx,
                         const T* __restrict__ ef,
                         const float* __restrict__ w1ab,
                         const float* __restrict__ w2,
                         const float* __restrict__ wc1,
                         const float* __restrict__ small,
                         const T* __restrict__ dout, T* __restrict__ dhsx,
                         T* __restrict__ dhdx, T* __restrict__ def,
                         float* __restrict__ partial, int E, int F,
                         int chunks, int chunk_edges) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");
  const int F2 = 2 * F;
  const int LDX = F2 + 1;

  extern __shared__ float smem[];
  float* w1s = smem;                   // [2F][LD], row k = input feature k
  float* w2s = w1s + F2 * LD;          // [H][LD], row k = input unit k
  float* wc1s = w2s + H * LD;          // [H][LD]
  float* sms = wc1s + H * LD;          // [6][H] (small transposed)
  float* bufX = sms + 6 * H;           // [kTile][2F+1] [hs ; hd], then d_hsd
  float* bufA = bufX + kTile * LDX;    // [kTile][LD] a1s
  float* bufM = bufA + kTile * LD;     // [kTile][LD] m
  float* bufG = bufM + kTile * LD;     // [kTile][LD] silu'(a1), then d_a1
  float* bufP3 = bufG + kTile * LD;    // [kTile][LD] d_p3
  float* bufP2 = bufP3 + kTile * LD;   // [kTile][LD] d_m_in, then d_p2
  float* gw1 = bufP2 + kTile * LD;     // [2F][H] this CTA's dW1ab
  float* radv = gw1 + F2 * H;          // [kTile] radial (rounded)
  float* invv = radv + kTile;          // [kTile] 1 / (sqrt(radial) + 1e-30)
  float* efv = invv + kTile;           // [kTile]
  float* cwv = efv + kTile;            // [kTile] cw (rounded)
  float* dcwv = cwv + kTile;           // [kTile] d_cw
  float* xdv = dcwv + kTile;           // [3][kTile]
  float* dmxv = xdv + 3 * kTile;       // [3][kTile] d_msgx

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const T* hsb = hsx + (size_t)b * (F + 3) * E;
  const T* hdb = hdx + (size_t)b * (F + 3) * E;
  const T* efb = ef + (size_t)b * E;
  const T* dob = dout + (size_t)b * (H + 3) * E;
  T* dhsb = dhsx + (size_t)b * (F + 3) * E;
  T* dhdb = dhdx + (size_t)b * (F + 3) * E;
  T* defb = def + (size_t)b * E;

  // ---- weights, rounded to the compute dtype ----
  for (int i = tid; i < F2 * H; i += kThreads) {
    w1s[(i / H) * LD + i % H] = rnd<T>(w1ab[i]);
    gw1[i] = 0.0f;
  }
  for (int i = tid; i < H * H; i += kThreads) {
    const int k = i / H, j = i % H;
    w2s[k * LD + j] = rnd<T>(w2[i]);
    wc1s[k * LD + j] = rnd<T>(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
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
    // ---- [hs ; hd] features and d_m_in (coalesced: t fastest) ----
    for (int i = tid; i < F2 * kTile; i += kThreads) {
      const int k = i / kTile, t = i % kTile;
      const int e = e0 + t;
      float v = 0.0f;
      if (e < e_end) {
        v = to_f(k < F ? hsb[(size_t)k * E + e] : hdb[(size_t)(k - F) * E + e]);
      }
      bufX[t * LDX + k] = v;
    }
    for (int i = tid; i < H * kTile; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      const int e = e0 + t;
      bufP2[t * LD + j] = e < e_end ? to_f(dob[(size_t)j * E + e]) : 0.0f;
    }
    // ---- per-edge geometry and coordinate cotangent ----
    if (tid < kTile) {
      const int e = e0 + tid;
      float d[3] = {0.0f, 0.0f, 0.0f}, dm[3] = {0.0f, 0.0f, 0.0f}, ev = 0.0f;
      if (e < e_end) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d[k] = rnd<T>(to_f(hsb[(size_t)(F + k) * E + e]) -
                        to_f(hdb[(size_t)(F + k) * E + e]));
          dm[k] = to_f(dob[(size_t)(H + k) * E + e]);
        }
        ev = to_f(efb[e]);
      }
      const float r = rnd<T>(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const float safe = r > 0.0f ? r : 1.0f;
      radv[tid] = r;
      invv[tid] = 1.0f / (sqrtf(safe) + 1e-30f);
      efv[tid] = ev;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xdv[k * kTile + tid] = d[k];
        dmxv[k * kTile + tid] = dm[k];
      }
    }
    __syncthreads();

    // ---- a1 = W1ab^T [hs ; hd] + ... -> a1s, silu'(a1) ----
    {
      float acc[4][CPT];
      tile_product<H, false>(bufX, LDX, w1s, F2, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          float a = acc[i][c] + sms[kW1R * H + j] * radv[t];
          a = a + sms[kW1E * H + j] * efv[t];
          a = a + sms[kB1 * H + j];
          const float s = sigmoid(a);
          bufA[t * LD + j] = rnd<T>(a * s);
          bufG[t * LD + j] = silu_grad(a, s);
        }
    }
    __syncthreads();

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[4][CPT];
    {
      float acc[4][CPT];
      tile_product<H, false>(bufA, LD, w2s, H, tg, cg, acc);
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
      tile_product<H, false>(bufM, LD, wc1s, H, tg, cg, acc);
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
      tile_product<H, true>(bufP3, LD, wc1s, H, tg, cg, acc);
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
      tile_product<H, true>(bufP2, LD, w2s, H, tg, cg, acc);
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
          const float r = radv[t], inv = invv[t], cwb = cwv[t];
          const float safe = r > 0.0f ? r : 1.0f;
          float sum_dxh_xd = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sum_dxh_xd += dmxv[k * kTile + t] * cwb * xdv[k * kTile + t];
          }
          const float d_safe = sum_dxh_xd * (-0.5f) * inv * inv / sqrtf(safe);
          const float d_rad = d_rad_chain + (r > 0.0f ? d_safe : 0.0f);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float dx = dmxv[k * kTile + t] * cwb * inv +
                             2.0f * xdv[k * kTile + t] * d_rad;
            dhsb[(size_t)(F + k) * E + e] = from_f<T>(dx);
            dhdb[(size_t)(F + k) * E + e] = from_f<T>(-dx);
          }
          defb[e] = from_f<T>(d_ef);
        }
      }
    }
    __syncthreads();

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
    // ---- dW1ab += [hs ; hd] (x) d_a1: rows tg + 16*r, columns cg*CPT+c ----
    {
      float acc[kRows1][CPT];
#pragma unroll
      for (int r = 0; r < kRows1; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int t = 0; t < kTile; ++t) {
        float dv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) dv[c] = bufG[t * LD + cg * CPT + c];
#pragma unroll
        for (int r = 0; r < kRows1; ++r) {
          const int row = tg + 16 * r;
          const float xv = row < F2 ? bufX[t * LDX + row] : 0.0f;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] += xv * dv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows1; ++r) {
        const int row = tg + 16 * r;
        if (row < F2) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) gw1[row * H + cg * CPT + c] += acc[r][c];
        }
      }
    }
    __syncthreads();  // bufX is rewritten with d_hsd next

    // ---- d_hsd = W1ab @ d_a1 into bufX: columns in blocks of H ----
    for (int c0 = 0; c0 < F2; c0 += H) {
      float acc[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        float av[4], wv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = bufG[(tg * 4 + i) * LD + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + cg * CPT + c;
          wv[c] = col < F2 ? w1s[col * LD + k] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + cg * CPT + c;
          if (col < F2) bufX[(tg * 4 + i) * LDX + col] = rnd<T>(acc[i][c]);
        }
    }
    __syncthreads();
    // ---- d_hsd into dhsx / dhdx rows 0..F-1 (coalesced) ----
    for (int i = tid; i < F2 * kTile; i += kThreads) {
      const int k = i / kTile, t = i % kTile;
      const int e = e0 + t;
      if (e < e_end) {
        const T v = from_f<T>(bufX[t * LDX + k]);
        if (k < F) {
          dhsb[(size_t)k * E + e] = v;
        } else {
          dhdb[(size_t)(k - F) * E + e] = v;
        }
      }
    }
    __syncthreads();  // tile buffers and per-edge values are rewritten next
  }

  // ---- this block's partial gradients: dW1ab | dW2 | dWc1 | dsmall ----
  float* pb = partial + (size_t)blockIdx.x * grad_width(F, H);
  for (int i = tid; i < F2 * H; i += kThreads) pb[i] = gw1[i];
  float* p2 = pb + F2 * H;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int row = tg * 4 + r, col = cg * CPT + c;
      p2[row * H + col] = gw2[r][c];
      p2[H * H + row * H + col] = gwc1[r][c];
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
    for (int g = 0; g < 16; ++g) s += red[(g * 6 + k) * H + j];
    p2[2 * H * H + i] = s;
  }
}

// grads[i] = sum over blocks, in block order, of partial[block][i]
__global__ void __launch_bounds__(kReduceThreads)
    egnn_edge_bwd_reduce(const float* __restrict__ partial, int blocks,
                         int width, float* __restrict__ grads) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * width + i];
  grads[i] = s;
}

template <typename T, int H>
cudaError_t launch(const void* hsx, const void* hdx, const void* ef,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, const void* dout, void* dhsx,
                   void* dhdx, void* def, float* partial, float* grads, int B,
                   int E, int F, int chunks, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(F, H) * sizeof(float);
  auto kernel = egnn_edge_bwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // edges per chunk: a whole number of tiles
  const int per = (E + chunks - 1) / chunks;
  const int chunk_edges = (per + kTile - 1) / kTile * kTile;
  const int blocks = B * chunks;
  kernel<<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(hsx), static_cast<const T*>(hdx),
      static_cast<const T*>(ef), w1ab, w2, wc1, small,
      static_cast<const T*>(dout), static_cast<T*>(dhsx),
      static_cast<T*>(dhdx), static_cast<T*>(def), partial, E, F, chunks,
      chunk_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = grad_width(F, H);
  egnn_edge_bwd_reduce<<<(width + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, stream>>>(partial, blocks, width,
                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the main kernel needs for node features F and
// hidden width H.
long long egnn_edge_bwd_smem_bytes(int F, int H) {
  return smem_floats(F, H) * (long long)sizeof(float);
}

// One backward: B*chunks CTAs of 256 threads, then the reduction, both on
// `stream`. hsx/hdx [B,F+3,E], ef [B,1,E] and dout [B,H+3,E] in the
// compute dtype (bf16 != 0: bfloat16, else float32); w1ab [2F,H], w2/wc1
// [H,H], small [H,6] f32. Writes dhsx/dhdx [B,F+3,E] and def [B,1,E] in
// the compute dtype and grads = dW1ab [2F,H] | dW2 [H,H] | dWc1 [H,H] |
// dsmall [H,6] in f32; partial [B*chunks, 2F*H + 2H^2 + 6H] f32 is
// scratch. Returns the cudaError_t of the launches (0 on success).
int egnn_edge_bwd(const void* hsx, const void* hdx, const void* ef,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, const void* dout, void* dhsx, void* dhdx,
                  void* def, void* partial, void* grads, int B, int E, int F,
                  int H, int chunks, int bf16, void* stream) {
  if (B < 1 || E < 1 || F < 1 || F > kMaxF || H != kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  const float* pw1 = static_cast<const float*>(w1ab);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm,
                                          dout, dhsx, dhdx, def, pp, pg, B, E,
                                          F, chunks, st);
  }
  return launch<float, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm, dout, dhsx,
                                dhdx, def, pp, pg, B, E, F, chunks, st);
}

}  // extern "C"
