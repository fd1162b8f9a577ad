// EGNN edge program forward for Hopper (sm_90a), over pre-gathered edge
// bundles.
//
// Replaces immunostruct_tpu/ops/pallas_edge.py::_fwd_kernel (launched by
// _fwd_call; public op edge_program, aggregation 'fused'). Per graph b, per
// edge e of the bundles hsx, hdx [B,F+3,E] (rows 0..F-1 the source's and
// destination's node features, F..F+2 their coordinates):
//
//   xd     = hsx[F:,e] - hdx[F:,e];  radial = |xd|^2
//   x_hat  = xd / (sqrt(radial) + 1e-30)          (radial > 0 guarded)
//   a1     = W1ab^T [hs ; hd] + w1r*radial + w1e*ef + b1
//   m      = silu(silu(a1) @ W2 + b2)
//   cw     = silu(m @ Wc1 + bc1) @ wc2
//   out[:,e] = [m ; cw * x_hat]                    [B,H+3,E], compute dtype
//
// Every edge is computed: the bundles carry no mask. The caller gathers
// zeros for a masked edge and masks its output out of the aggregation.
//
// What bounds it on the H100. Per edge, three products (2F x H, H x H,
// H x H): at B=128, E=2560, F=H=64 that is 2*E*(2F*H + 2*H*H) = 84 M
// multiply-adds per graph, 10.7 GFLOP per launch, against ~132 MB moved
// (hsx and hdx read, out written, in bf16): ~40 us at 3.35 TB/s. The
// FLOPs on the CUDA cores in f32 (67 TFLOP/s) take ~0.16 ms, so a first
// form on the CUDA cores is bound by arithmetic.
//
// What the design does (a simple first form, the shape of the tail
// backward csrc/egnn_tail_bwd.cu):
//   - one CTA of 256 threads per (graph, edge chunk), enough CTAs to give
//     every SM one; 64-edge tiles inside;
//   - W1ab, W2 and Wc1, rounded to the compute dtype, sit in shared memory;
//     every product is a register-tiled FMA loop (each thread 4 edges x H/16
//     columns);
//   - a tile's [hs ; hd] features move from device memory into shared
//     memory with neighbouring threads on neighbouring edges (E is the
//     minor axis of the [B,C,E] layout: coalesced), and m goes back out the
//     same way through a tile buffer;
//   - no gathers, no atomics: the bundles come pre-gathered.
// Tensor cores (mma.sync / wgmma) for the products are the next step.
//
// Rounding points under bf16 are the TPU kernel's (pallas_edge.py:104-165):
// W1ab/W2/Wc1 rounded; xd the difference in the compute dtype; radial
// summed in f32 and rounded; silu(a1), m and silu(m @ Wc1 + bc1) rounded;
// cw an f32 dot with wc2, rounded before it meets x_hat; the output stored
// in the compute dtype. Sigmoid/silu and all sums in f32.
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

// sum over the 16 column groups: lanes 0-15 / 16-31 of the warp
__device__ __forceinline__ float sum16(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__host__ __device__ constexpr int row_stride(int hid) { return hid + 1; }

// shared-memory floats: W1ab 2F*H | W2, Wc1 2*H*H | small^T 6*H | feature
// tile kTile*(2F+1) | two edge-tile buffers 2*kTile*(H+1) | per-edge
// values 5*kTile (+ kTile ints)
__host__ __device__ inline long long smem_floats(int f, int hid) {
  return 2LL * f * hid + 2LL * hid * hid + 6LL * hid +
         (long long)kTile * (2 * f + 1) + 2LL * kTile * row_stride(hid) +
         6LL * kTile;
}

// acc[i][c] = sum_k A[tg*4+i][k] * W[k][cg*CPT+c], A at a[row*lda + k],
// W at w[k*ldw + j]
template <int H>
__device__ __forceinline__ void tile_product(const float* a, int lda,
                                             const float* w, int ldw, int K,
                                             int tg, int cg,
                                             float (&acc)[4][H / 16]) {
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
    for (int c = 0; c < CPT; ++c) wv[c] = w[k * ldw + cg * CPT + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
  }
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_edge_fwd_kernel(const T* __restrict__ hsx, const T* __restrict__ hdx,
                         const T* __restrict__ ef,
                         const float* __restrict__ w1ab,
                         const float* __restrict__ w2,
                         const float* __restrict__ wc1,
                         const float* __restrict__ small,
                         T* __restrict__ out, int E, int F, int chunks,
                         int chunk_edges) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");
  const int LDX = 2 * F + 1;

  extern __shared__ float smem[];
  float* w1s = smem;                  // [2F][H], row k = input feature k
  float* w2s = w1s + 2 * F * H;       // [H][H]
  float* wc1s = w2s + H * H;          // [H][H]
  float* sms = wc1s + H * H;          // [6][H] (small transposed)
  float* bufX = sms + 6 * H;          // [kTile][2F+1] features [hs ; hd]
  float* bufA = bufX + kTile * LDX;   // [kTile][LD] silu(a1)
  float* bufM = bufA + kTile * LD;    // [kTile][LD] m
  float* xhv = bufM + kTile * LD;     // [3][kTile] x_hat
  float* radv = xhv + 3 * kTile;      // [kTile] radial (rounded)
  float* efv = radv + kTile;          // [kTile]

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const T* hsb = hsx + (size_t)b * (F + 3) * E;
  const T* hdb = hdx + (size_t)b * (F + 3) * E;
  const T* efb = ef + (size_t)b * E;
  T* ob = out + (size_t)b * (H + 3) * E;

  // ---- weights, rounded to the compute dtype ----
  for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<T>(w1ab[i]);
  for (int i = tid; i < H * H; i += kThreads) {
    w2s[i] = rnd<T>(w2[i]);
    wc1s[i] = rnd<T>(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
  __syncthreads();

  for (int e0 = e_begin; e0 < e_end; e0 += kTile) {
    // ---- [hs ; hd] features of the tile (coalesced: t fastest) ----
    for (int i = tid; i < 2 * F * kTile; i += kThreads) {
      const int k = i / kTile, t = i % kTile;
      const int e = e0 + t;
      float v = 0.0f;
      if (e < e_end) {
        v = to_f(k < F ? hsb[(size_t)k * E + e] : hdb[(size_t)(k - F) * E + e]);
      }
      bufX[t * LDX + k] = v;
    }
    // ---- per-edge geometry ----
    if (tid < kTile) {
      const int e = e0 + tid;
      float d[3] = {0.0f, 0.0f, 0.0f}, ev = 0.0f;
      if (e < e_end) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d[k] = rnd<T>(to_f(hsb[(size_t)(F + k) * E + e]) -
                        to_f(hdb[(size_t)(F + k) * E + e]));
        }
        ev = to_f(efb[e]);
      }
      const float r = rnd<T>(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const float safe = r > 0.0f ? r : 1.0f;
      const float inv = 1.0f / (sqrtf(safe) + 1e-30f);
      radv[tid] = r;
      efv[tid] = ev;
#pragma unroll
      for (int k = 0; k < 3; ++k) xhv[k * kTile + tid] = d[k] * inv;
    }
    __syncthreads();

    // ---- a1 = W1ab^T [hs ; hd] + w1r*radial + w1e*ef + b1 -> silu(a1) ----
    {
      float acc[4][CPT];
      tile_product<H>(bufX, LDX, w1s, H, 2 * F, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          float a1 = acc[i][c] + sms[kW1R * H + j] * radv[t];
          a1 = a1 + sms[kW1E * H + j] * efv[t];
          a1 = a1 + sms[kB1 * H + j];
          bufA[t * LD + j] = rnd<T>(a1 * sigmoid(a1));
        }
    }
    __syncthreads();

    // ---- m = silu(silu(a1) @ W2 + b2) ----
    {
      float acc[4][CPT];
      tile_product<H>(bufA, LD, w2s, H, H, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float p = acc[i][c] + sms[kB2 * H + j];
          bufM[t * LD + j] = rnd<T>(p * sigmoid(p));
        }
    }
    __syncthreads();

    // ---- cw = silu(m @ Wc1 + bc1) @ wc2; out rows H.. = cw * x_hat ----
    {
      float acc[4][CPT];
      tile_product<H>(bufM, LD, wc1s, H, H, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float p = acc[i][c] + sms[kBC1 * H + j];
          part += rnd<T>(p * sigmoid(p)) * sms[kWC2 * H + j];
        }
        const float cw = sum16(part);
        const int e = e0 + t;
        if (cg == 0 && e < e_end) {
          const float cwb = rnd<T>(cw);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ob[(size_t)(H + k) * E + e] = from_f<T>(cwb * xhv[k * kTile + t]);
          }
        }
      }
    }
    // ---- out rows 0..H-1 = m (coalesced) ----
    for (int i = tid; i < H * kTile; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      if (e0 + t < e_end) {
        ob[(size_t)j * E + e0 + t] = from_f<T>(bufM[t * LD + j]);
      }
    }
    __syncthreads();  // tile buffers and per-edge values are rewritten next
  }
}

template <typename T, int H>
cudaError_t launch(const void* hsx, const void* hdx, const void* ef,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, void* out, int B, int E, int F,
                   int chunks, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(F, H) * sizeof(float);
  auto kernel = egnn_edge_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // edges per chunk: a whole number of tiles
  const int per = (E + chunks - 1) / chunks;
  const int chunk_edges = (per + kTile - 1) / kTile * kTile;
  kernel<<<B * chunks, kThreads, bytes, stream>>>(
      static_cast<const T*>(hsx), static_cast<const T*>(hdx),
      static_cast<const T*>(ef), w1ab, w2, wc1, small, static_cast<T*>(out),
      E, F, chunks, chunk_edges);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for node features F and hidden width H.
long long egnn_edge_fwd_smem_bytes(int F, int H) {
  return smem_floats(F, H) * (long long)sizeof(float);
}

// One launch: B*chunks CTAs of 256 threads on `stream`. hsx/hdx [B,F+3,E],
// ef [B,1,E] in the compute dtype (bf16 != 0: bfloat16, else float32);
// w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32. Writes out [B,H+3,E] in the
// compute dtype. Returns the cudaError_t of the launch (0 on success).
int egnn_edge_fwd(const void* hsx, const void* hdx, const void* ef,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, void* out, int B, int E, int F, int H,
                  int chunks, int bf16, void* stream) {
  if (B < 1 || E < 0 || F < 1 || F > kMaxF || H != kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  if (E == 0) return cudaSuccess;
  const float* pw1 = static_cast<const float*>(w1ab);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm,
                                          out, B, E, F, chunks, st);
  }
  return launch<float, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm, out, B, E,
                                F, chunks, st);
}

}  // extern "C"
