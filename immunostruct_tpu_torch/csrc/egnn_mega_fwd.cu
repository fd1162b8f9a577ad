// EGNN edge half-layer forward for Hopper (sm_90a), forward only.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // edges per tile: 16 edge groups x 4 edges
constexpr int kHidden = 64;  // H of every zoo model (gat_hidden_channels)

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 value to the compute dtype and back (round to nearest even)
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float silu(float v) {
  return v * (1.0f / (1.0f + expf(-v)));
}

__host__ __device__ constexpr int row_stride(int hid) { return hid + 1; }

// shared-memory floats: acc N*(H+3) | W2 H*H | Wc1 H*H | small^T 6*H |
// two edge-tile buffers 2*kTile*(H+1) | per-edge geometry 8*kTile
__host__ __device__ inline long long smem_floats(int n, int hid) {
  return (long long)n * (hid + 3) + 2LL * hid * hid + 6LL * hid +
         2LL * kTile * row_stride(hid) + 8LL * kTile;
}

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
                         float* __restrict__ out, float* proj, int N, int E,
                         int F) {
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // accumulator columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");

  extern __shared__ float smem[];
  float* acc = smem;                 // [N][C]
  float* w2s = acc + N * C;          // [H][H], row k = input unit k
  float* wc1s = w2s + H * H;         // [H][H]
  float* sms = wc1s + H * H;         // [6][H] (small transposed)
  float* bufA = sms + 6 * H;         // [kTile][LD]
  float* bufB = bufA + kTile * LD;   // [kTile][LD]
  float* xh = bufB + kTile * LD;     // [kTile][3] x_hat
  float* radv = xh + 3 * kTile;      // [kTile] radial (rounded)
  float* efv = radv + kTile;         // [kTile]
  int* srcv = reinterpret_cast<int*>(efv + kTile);
  int* dstv = srcv + kTile;
  int* okv = dstv + kTile;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const T* hb = h + (size_t)b * N * F;
  const T* xb = x + (size_t)b * N * 3;
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const T* efb = ef + (size_t)b * E;
  float* pab = proj + (size_t)b * N * 2 * H;  // [N][2H]: pa | pb

  // ---- phase 0: accumulator and weights ----
  for (int i = tid; i < N * C; i += kThreads) acc[i] = 0.0f;
  for (int i = tid; i < H * H; i += kThreads) {
    w2s[i] = rnd<T>(w2[i]);
    wc1s[i] = rnd<T>(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    const int j = i / 6, k = i % 6;
    sms[k * H + j] = small[i];
  }
  float* w1s = bufA;  // [2F][H]; fits: 2*F*H <= 2*kTile*LD for F <= kTile
  for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<T>(w1ab[i]);
  __syncthreads();

  // ---- phase 1: node projections ----
  for (int i = tid; i < N * 2 * H; i += kThreads) {
    const int node = i / (2 * H), j = i % (2 * H);
    const float* wcol = w1s + (j / H) * F * H + (j % H);
    const T* hr = hb + node * F;
    float s = 0.0f;
    for (int f = 0; f < F; ++f) s += to_f(hr[f]) * wcol[f * H];
    pab[i] = rnd<T>(s);
  }
  __syncthreads();  // projections visible to the whole CTA; bufA free

  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1

  for (int e0 = 0; e0 < E; e0 += kTile) {
    // ---- geometry ----
    if (tid < kTile) {
      const int e = e0 + tid;
      int s = 0, d = 0, ok = 0;
      float r = 0.0f, ev = 0.0f, h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
      if (e < E) {
        s = srcb[e];
        d = dstb[e];
        ok = maskb[e] != 0 && s >= 0 && s < N && d >= 0 && d < N;
      }
      if (ok) {
        const float d0 = rnd<T>(to_f(xb[s * 3 + 0]) - to_f(xb[d * 3 + 0]));
        const float d1 = rnd<T>(to_f(xb[s * 3 + 1]) - to_f(xb[d * 3 + 1]));
        const float d2 = rnd<T>(to_f(xb[s * 3 + 2]) - to_f(xb[d * 3 + 2]));
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
      srcv[tid] = s;
      dstv[tid] = d;
      okv[tid] = ok;
      radv[tid] = r;
      efv[tid] = ev;
      xh[tid * 3 + 0] = h0;
      xh[tid * 3 + 1] = h1;
      xh[tid * 3 + 2] = h2;
    }
    __syncthreads();

    // ---- a1 -> silu(a1) into bufA ----
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int t = i / H, j = i % H;
      float v = 0.0f;
      if (okv[t]) {
        float a1 = pab[srcv[t] * 2 * H + j] + pab[dstv[t] * 2 * H + H + j];
        a1 = a1 + sms[0 * H + j] * radv[t];
        a1 = a1 + sms[1 * H + j] * efv[t];
        a1 = a1 + sms[2 * H + j];
        v = rnd<T>(silu(a1));
      }
      bufA[t * LD + j] = v;
    }
    __syncthreads();

    // ---- m = silu(silu(a1) @ W2 + b2): into bufB and the accumulator ----
    {
      float r[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) r[i][c] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float a[4], w[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = bufA[(tg * 4 + i) * LD + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] = w2s[k * H + cg * CPT + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) r[i][c] += a[i] * w[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        const bool ok = okv[t] != 0;
        float* arow = acc + dstv[t] * C;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float mv = rnd<T>(silu(r[i][c] + sms[3 * H + j]));
          bufB[t * LD + j] = mv;
          if (ok) atomicAdd(arow + j, mv);
        }
      }
    }
    __syncthreads();

    // ---- cw = silu(m @ Wc1 + bc1) @ wc2; scatter cw * x_hat ----
    {
      float r[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) r[i][c] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        float a[4], w[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = bufB[(tg * 4 + i) * LD + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] = wc1s[k * H + cg * CPT + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) r[i][c] += a[i] * w[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float c1 = rnd<T>(silu(r[i][c] + sms[4 * H + j]));
          part += c1 * sms[5 * H + j];
        }
        // sum over the 16 column groups: lanes 0-15 / 16-31 of the warp
        part += __shfl_xor_sync(0xffffffffu, part, 8);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (cg == 0 && okv[t]) {
          const float cwb = rnd<T>(part);
          float* arow = acc + dstv[t] * C + H;
          atomicAdd(arow + 0, rnd<T>(cwb * xh[t * 3 + 0]));
          atomicAdd(arow + 1, rnd<T>(cwb * xh[t * 3 + 1]));
          atomicAdd(arow + 2, rnd<T>(cwb * xh[t * 3 + 2]));
        }
      }
    }
    __syncthreads();  // tile buffers and geometry are rewritten next tile
  }

  float* ob = out + (size_t)b * N * C;
  for (int i = tid; i < N * C; i += kThreads) ob[i] = acc[i];
}

template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h, const void* x,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, float* out, float* proj, int B, int N,
                   int E, int F, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(N, H) * sizeof(float);
  auto kernel = egnn_mega_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h),
      static_cast<const T*>(x), w1ab, w2, wc1, small, out, proj, N, E, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes and hidden width H.
long long egnn_mega_fwd_smem_bytes(int N, int H) {
  return smem_floats(N, H) * (long long)sizeof(float);
}

// One launch: B CTAs of 256 threads on `stream`. src/dst [B,E] int32,
// mask [B,E] bool, ef [B,E,1], h [B,N,F], x [B,N,3] in the compute dtype
// (bf16 != 0: bfloat16, else float32); w1ab [2F,H], w2/wc1 [H,H],
// small [H,6] f32; out [B,N,H+3] f32; proj [B,N,2H] f32 scratch.
// Returns the cudaError_t of the launch (0 on success).
int egnn_mega_fwd(const void* src, const void* dst, const void* mask,
                  const void* ef, const void* h, const void* x,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, void* out, void* proj, int B, int N,
                  int E, int F, int H, int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > kTile || H != kHidden) {
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
    return launch<__nv_bfloat16, kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1,
                                          psm, po, pp, B, N, E, F, st);
  }
  return launch<float, kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1, psm, po,
                                pp, B, N, E, F, st);
}

}  // extern "C"
