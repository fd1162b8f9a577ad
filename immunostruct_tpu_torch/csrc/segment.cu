// Masked segment scatter and gather for Hopper (sm_90a): B8.
//
// Replaces immunostruct_tpu/ops/experimental/pallas_segment.py::_scatter_kernel
// (launched by _scatter_call; public op segment_scatter, aggregation
// 'pallas') and ::_gather_kernel (launched by _gather_call; segment_gather,
// and segment_scatter's VJP). Per graph b, with
//
//   valid(b,e) = mask[b,e] && 0 <= idx[b,e] < N
//
//   scatter: out[b,n,c] = sum over valid e with idx[b,e] == n of m[b,e,c]
//            [B,E,C] -> [B,N,C]; f32 sums, one rounding to m's dtype
//   gather:  out[b,e,c] = valid(b,e) ? h[b,idx[b,e],c] : 0
//            [B,N,C] -> [B,E,C]; exact (one non-zero term)
//
// Each is the other's transpose, so each is the other's VJP. An index
// outside [0, N) contributes nothing, masked or not: on the TPU no one-hot
// row matches it; here it is tested before any load or store it would
// address.
//
// What bounds it on the H100. Neither has arithmetic to speak of (the
// scatter one add per element): both are bound by bytes. At B=128, E=2560,
// N=288, C=67 in bf16 each call moves ~50 MB ([B,E,C] read or written
// once, [B,N,C] the other way, idx and mask): ~15 us at 3.35 TB/s.
//
// What the design does (a simple first form):
//   scatter: one CTA of 256 threads per (graph, block of 32 channels); an
//     f32 accumulator [N][32] in shared memory (37 KB at N=288). Warp w
//     owns nodes [w*N/8, (w+1)*N/8), lane l owns channel l of the block.
//     Tiles of 256 edges are staged in shared memory: each edge's node (or
//     -1 where it is not valid) and its 32 messages (coalesced along the
//     channels). Every warp then finds its own edges of the tile, 32 at a
//     time with one ballot, and adds their rows in edge order (lowest set
//     bit first). So each (n, c) is summed by one lane in edge order: no
//     atomics, the same bits on every run, the order of a sequential sum
//     (index_add_ on the CPU). One rounding at the store.
//   gather: one warp per edge, its lanes along the channels: the edge's
//     index is read once, the gathered row and the output row are
//     contiguous (coalesced), and no thread divides.
// Next steps: more warps per node range, 16-byte loads, and the scatter
// fused with the edge MLP that produces its messages.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;         // channels per scatter CTA
constexpr int kLD = kLanes + 1;    // shared-memory row stride (floats)
constexpr int kTile = kThreads;    // edges per staged tile

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

// shared-memory floats of one scatter CTA: accumulator N*kLD | message tile
// kTile*kLD | the tile's nodes kTile (ints)
__host__ __device__ inline long long scatter_smem_floats(int n) {
  return (long long)n * kLD + (long long)kTile * kLD + kTile;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_scatter_kernel(const int* __restrict__ idx,
                           const uint8_t* __restrict__ mask,
                           const T* __restrict__ m, T* __restrict__ out,
                           int E, int N, int C, int blocks) {
  extern __shared__ float smem[];
  float* acc = smem;                                   // [N][kLD]
  float* tile = acc + (size_t)N * kLD;                 // [kTile][kLD]
  int* node = reinterpret_cast<int*>(tile + kTile * kLD);  // [kTile]

  const int b = blockIdx.x / blocks;
  const int c0 = (blockIdx.x % blocks) * kLanes;
  const int width = min(kLanes, C - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per_warp = (N + kWarps - 1) / kWarps;
  const int lo = warp * per_warp, hi = min(N, lo + per_warp);
  const int* ib = idx + (size_t)b * E;
  const uint8_t* mb = mask + (size_t)b * E;
  const T* mb_rows = m + (size_t)b * E * C + c0;

  for (int i = tid; i < N * kLD; i += kThreads) acc[i] = 0.0f;

  for (int e0 = 0; e0 < E; e0 += kTile) {
    const int te = min(kTile, E - e0);
    __syncthreads();  // the last tile is walked (and acc zeroed, the first time)
    if (tid < te) {
      const int e = e0 + tid;
      const int n = ib[e];
      node[tid] = (mb[e] != 0 && n >= 0 && n < N) ? n : -1;
    }
    for (int i = tid; i < te * kLanes; i += kThreads) {
      const int t = i / kLanes, l = i % kLanes;
      tile[t * kLD + l] =
          l < width ? to_f(mb_rows[(size_t)(e0 + t) * C + l]) : 0.0f;
    }
    __syncthreads();
    // every warp takes its edges of the tile in edge order, 32 edges a
    // ballot; -1 is no warp's node
    for (int t0 = 0; t0 < te; t0 += 32) {
      const int nl = t0 + lane < te ? node[t0 + lane] : -1;
      unsigned mine = __ballot_sync(0xffffffffu, nl >= lo && nl < hi);
      while (mine) {
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        const int n = __shfl_sync(0xffffffffu, nl, j);
        acc[n * kLD + lane] += tile[(t0 + j) * kLD + lane];
      }
    }
  }
  __syncthreads();

  T* ob = out + (size_t)b * N * C + c0;
  for (int i = tid; i < N * kLanes; i += kThreads) {
    const int n = i / kLanes, l = i % kLanes;
    if (l < width) ob[(size_t)n * C + l] = from_f<T>(acc[n * kLD + l]);
  }
}

// grid (ceil(E / kWarps), B): warp w of block x takes edge x*kWarps + w of
// graph blockIdx.y
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_gather_kernel(const int* __restrict__ idx,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ h, T* __restrict__ out,
                          int E, int N, int C) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (e >= E) return;
  const size_t row = (size_t)b * E + e;
  const int n = idx[row];
  T* orow = out + row * C;
  if (mask[row] != 0 && n >= 0 && n < N) {
    const T* hrow = h + ((size_t)b * N + n) * C;
    for (int c = lane; c < C; c += 32) orow[c] = hrow[c];
  } else {
    for (int c = lane; c < C; c += 32) orow[c] = from_f<T>(0.0f);
  }
}

template <typename T>
cudaError_t launch_scatter(const int* idx, const uint8_t* mask, const void* m,
                           void* out, int B, int E, int N, int C,
                           cudaStream_t stream) {
  const size_t bytes = (size_t)scatter_smem_floats(N) * sizeof(float);
  auto kernel = segment_scatter_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (C + kLanes - 1) / kLanes;
  kernel<<<B * blocks, kThreads, bytes, stream>>>(
      idx, mask, static_cast<const T*>(m), static_cast<T*>(out), E, N, C,
      blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather(const int* idx, const uint8_t* mask, const void* h,
                          void* out, int B, int E, int N, int C,
                          cudaStream_t stream) {
  const dim3 grid((E + kWarps - 1) / kWarps, B);
  segment_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      idx, mask, static_cast<const T*>(h), static_cast<T*>(out), E, N, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one scatter CTA needs for N nodes.
long long segment_scatter_smem_bytes(int N) {
  return scatter_smem_floats(N) * (long long)sizeof(float);
}

// One scatter launch: B*ceil(C/32) CTAs of 256 threads on `stream`. idx
// [B,E] int32, mask [B,E] bool (one byte), m [B,E,C] in the compute dtype
// (bf16 != 0: bfloat16, else float32). Writes every element of out [B,N,C]
// (zeros where no valid edge lands). Returns the cudaError_t of the launch
// (0 on success).
int segment_scatter(const void* idx, const void* mask, const void* m,
                    void* out, int B, int E, int N, int C, int bf16,
                    void* stream) {
  if (B < 1 || E < 0 || N < 1 || C < 1) return cudaErrorInvalidValue;
  const int* pi = static_cast<const int*>(idx);
  const uint8_t* pm = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_scatter<__nv_bfloat16>(pi, pm, m, out, B, E, N, C, st);
  }
  return launch_scatter<float>(pi, pm, m, out, B, E, N, C, st);
}

// One gather launch on `stream`: ceil(E/8) x B CTAs of 256 threads. idx,
// mask as above, h [B,N,C]; writes out [B,E,C] in h's dtype. Returns the
// cudaError_t of the launch.
int segment_gather(const void* idx, const void* mask, const void* h,
                   void* out, int B, int E, int N, int C, int bf16,
                   void* stream) {
  if (B < 1 || B > 65535 || E < 0 || N < 1 || C < 1) {
    return cudaErrorInvalidValue;
  }
  if (E == 0) return cudaSuccess;
  const int* pi = static_cast<const int*>(idx);
  const uint8_t* pm = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_gather<__nv_bfloat16>(pi, pm, h, out, B, E, N, C, st);
  }
  return launch_gather<float>(pi, pm, h, out, B, E, N, C, st);
}

}  // extern "C"
