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
//            (segment_scatter_rounded: each add rounded to m's dtype, the
//            sum XLA's scatter-add takes in that dtype: the transpose of a
//            row gather, take_along_axis, in the JAX package's 'pallas'
//            layer; in f32 the same bits as segment_scatter)
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
// once, [B,N,C] the other way, idx and mask): ~15 us at 3.35 TB/s. At the
// train_Cancer_wFT entry point's partial batches (B=25-77, E=1280) the
// bound is 2-5 us, so the latency of one CTA's walk, and the number of
// CTAs in flight, set the time.
//
// What the design does:
//   scatter: one CTA of 256 threads per (graph, range of R nodes), R from
//     the host (ops/segment.py::scatter_range_nodes: as many ranges as the
//     card holds CTAs at once, one wave, each at least 8 nodes and at most
//     kMaxRange). The CTA reads its graph's idx and mask once (16-byte
//     loads where aligned) and builds in shared memory a stable counting
//     sort of the valid edges whose node is in its range: each warp ranks
//     the edges of its own eighth of the graph in edge order
//     (__match_any_sync, 32 edges at a time), the per-warp counts give each
//     node's start and each warp's offset in it, and every edge lands in
//     the node's list in edge order. Then each warp takes a block of whole
//     nodes holding about an eighth of the range's edges and streams its
//     list, kUnroll message rows' loads in flight before their adds, its
//     lanes along the channels, each node's rows summed in f32 in list
//     order. So every message row is read once overall, every output row is
//     written once and whole, and each (n, c) is a sequential sum in edge
//     order from +0: no atomics, the same bits on every run, the bits of
//     index_add_ on the CPU (edges that are not valid add +0 there, which
//     changes no partial sum). One rounding at the store. What paces it is
//     the sums, not the sort: a message row an edge, read in node order,
//     and the instructions of its three channel passes (PERF.md;
//     scripts/torch_kernel_ties.py --kernel segment_phases).
//   gather: one CTA of 256 threads per (graph, chunk of edges), the chunk
//     from the host (ops/segment.py::gather_chunk_edges: enough CTAs for
//     four an SM, a multiple of 8 edges, at most kMaxChunk). The chunk's
//     output is one contiguous run of e*C elements of [B,E,C]; the CTA
//     writes it in 16-byte stores over that flat run (a head and a tail
//     element by element where the run is not aligned): element j is
//     h[b, idx[e0 + j / C], j % C] or 0. The chunk's nodes are read once
//     into shared memory; h is read through L1 and L2 (a copy of the
//     graph's [N,C] block in shared memory by cp.async read no faster in
//     bf16 and capped N: PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRange = 1024;     // nodes a scatter CTA: 10 bits of a key
constexpr int kKeyBits = 10;
constexpr int kWarpBits = 3;        // log2(kWarps)
constexpr int kMaxChunk = 2048;     // edges a gather CTA
constexpr int kV = 3;               // channels a lane sums at once: 96 a warp
constexpr int kUnroll = 4;          // message rows in flight a warp

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

// shared-memory ints of one scatter CTA: the edges' keys [E] | the range's
// edge list [E] | per-warp counts, then offsets [kWarps][R] | the nodes'
// starts [R + 1]
__host__ __device__ inline long long scatter_smem_ints(int e, int r) {
  return 2LL * e + (long long)kWarps * r + r + 1;
}

// the first node k in [0, rn] whose edges start at or after list entry t
__device__ __forceinline__ int node_at(const int* start, int rn, int t) {
  int lo = 0, hi = rn;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (start[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// acc, rounded once, into channels c0 + 32 v + lane of an output row; then
// acc = 0 for the next node
template <typename T>
__device__ __forceinline__ void store_node(T* orow, int c0, int lane, int C,
                                           float (&acc)[kV]) {
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int c = c0 + 32 * v + lane;
    if (c < C) orow[c] = from_f<T>(acc[v]);
    acc[v] = 0.0f;
  }
}

// grid: B * ranges CTAs; CTA x takes nodes [lo, lo + R) of graph x / ranges;
// kRoundEach: each add rounded to T
template <typename T, bool kRoundEach>
__global__ void __launch_bounds__(kThreads)
    segment_scatter_kernel(const int* __restrict__ idx,
                           const uint8_t* __restrict__ mask,
                           const T* __restrict__ m, T* __restrict__ out,
                           int E, int N, int C, int R, int ranges) {
  extern __shared__ int smem[];
  int* key = smem;                      // [E]: k | w | rank, or -1
  int* list = key + E;                  // [E]: e | k, by node, edge order
  int* cnt = list + E;                  // [kWarps][R]
  int* start = cnt + kWarps * R;        // [R + 1]

  const int b = blockIdx.x / ranges;
  const int lo = (blockIdx.x % ranges) * R;
  const int rn = min(R, N - lo);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* ib = idx + (size_t)b * E;
  const uint8_t* mb = mask + (size_t)b * E;
  const T* mg = m + (size_t)b * E * C;

  for (int i = tid; i < kWarps * R; i += kThreads) cnt[i] = 0;
  // the graph's indices, once: the node in the range, or -1 (not valid, or
  // another range's); four edges a thread (16-byte loads) where aligned
  auto in_range = [&](int n, uint8_t valid) {
    return (valid != 0 && n >= lo && n < lo + rn) ? n - lo : -1;
  };
  if (E % 4 == 0 && (reinterpret_cast<uintptr_t>(ib) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(mb) & 3) == 0) {
    for (int q = tid; q < E / 4; q += kThreads) {
      const int4 n = reinterpret_cast<const int4*>(ib)[q];
      const uchar4 v = reinterpret_cast<const uchar4*>(mb)[q];
      reinterpret_cast<int4*>(key)[q] =
          make_int4(in_range(n.x, v.x), in_range(n.y, v.y),
                    in_range(n.z, v.z), in_range(n.w, v.w));
    }
  } else {
    for (int e = tid; e < E; e += kThreads) key[e] = in_range(ib[e], mb[e]);
  }
  __syncthreads();

  // each warp ranks the edges of its segment in edge order, per node
  const int seg = ((E + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int s0 = warp * seg, s1 = min(E, s0 + seg);
  int* wcnt = cnt + warp * R;
  for (int e0 = s0; e0 < s1; e0 += 32) {
    const int e = e0 + lane;
    const int k = e < s1 ? key[e] : -1;
    const unsigned grp = __match_any_sync(0xffffffffu, k);
    const unsigned below = grp & ((1u << lane) - 1u);
    if (k >= 0) {
      const int rank = wcnt[k] + __popc(below);
      key[e] = (rank << (kKeyBits + kWarpBits)) | (warp << kKeyBits) | k;
    }
    __syncwarp();
    if (k >= 0 && (grp >> lane) == 1u) wcnt[k] += __popc(grp);  // last lane
    __syncwarp();
  }
  __syncthreads();

  // per node: each warp's offset among the node's edges, and the count
  for (int k = tid; k < rn; k += kThreads) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * R + k];
      cnt[w * R + k] = total;
      total += c;
    }
    start[k] = total;
  }
  __syncthreads();
  // the counts' exclusive prefix sum: each node's start in the list
  if (warp == 0) {
    int carry = 0;
    for (int k0 = 0; k0 < rn; k0 += 32) {
      const int k = k0 + lane;
      const int v = k < rn ? start[k] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      if (k < rn) start[k] = carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[rn] = carry;
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    const int p = key[e];
    if (p >= 0) {
      const int k = p & (kMaxRange - 1);
      const int w = (p >> kKeyBits) & (kWarps - 1);
      list[start[k] + cnt[w * R + k] + (p >> (kKeyBits + kWarpBits))] =
          (e << kKeyBits) | k;
    }
  }
  __syncthreads();

  // each warp sums a block of whole nodes that holds about an eighth of
  // the range's edges: it streams the block's list, kUnroll message rows in
  // flight, its lanes along the channels, each node's rows in edge order,
  // and stores each node's row (zeros where it has no edge) once
  const int total = start[rn];
  const int kb0 = node_at(start, rn, (int)((long long)total * warp / kWarps));
  const int kb1 =
      warp == kWarps - 1
          ? rn
          : node_at(start, rn, (int)((long long)total * (warp + 1) / kWarps));
  T* og = out + ((size_t)b * N + lo) * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kV) {
    float acc[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) acc[v] = 0.0f;
    int cur = kb0;
    const int j1 = start[kb1];
    for (int j = start[kb0]; j < j1; j += kUnroll) {
      int p[kUnroll];
      float val[kUnroll][kV];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = j + u < j1 ? list[j + u] : -1;
        const T* row =
            p[u] >= 0 ? mg + (size_t)(p[u] >> kKeyBits) * C : nullptr;
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int c = c0 + 32 * v + lane;
          val[u][v] = row != nullptr && c < C ? to_f(row[c]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p[u] >= 0) {
          const int k = p[u] & (kMaxRange - 1);
          for (; cur < k; ++cur) {
            store_node(og + (size_t)cur * C, c0, lane, C, acc);
          }
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            acc[v] += val[u][v];
            if constexpr (kRoundEach) acc[v] = to_f(from_f<T>(acc[v]));
          }
        }
      }
    }
    for (; cur < kb1; ++cur) {
      store_node(og + (size_t)cur * C, c0, lane, C, acc);
    }
  }
}

// kVec consecutive elements of the chunk's run from element (e, c) of it
template <typename T, int kVec>
__device__ __forceinline__ void gather_run(const T* __restrict__ hb,
                                           const int* node, int e, int c,
                                           int C, T* vals) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int n = node[e];
    vals[i] = n >= 0 ? hb[n * C + c] : from_f<T>(0.0f);
    if (++c == C) {
      c = 0;
      ++e;
    }
  }
}

// grid: B * chunks CTAs; CTA x writes edges [e0, e0 + chunk) of graph
// x / chunks
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_gather_kernel(const int* __restrict__ idx,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ h, T* __restrict__ out,
                          int E, int N, int C, int chunk, int chunks) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ int node[kMaxChunk];
  const int b = blockIdx.x / chunks;
  const int e0 = (blockIdx.x % chunks) * chunk;
  const int ne = min(chunk, E - e0);
  const int tid = threadIdx.x;
  const T* hb = h + (size_t)b * N * C;
  for (int t = tid; t < ne; t += kThreads) {
    const size_t row = (size_t)b * E + e0 + t;
    const int n = idx[row];
    node[t] = (mask[row] != 0 && n >= 0 && n < N) ? n : -1;
  }
  __syncthreads();

  const int len = ne * C;
  T* o = out + ((size_t)b * E + e0) * C;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(o) & 15);
  const int head = min(len, ((16 - skew) & 15) / (int)sizeof(T));
  const int body = (len - head) / kVec;
  for (int j = tid; j < head; j += kThreads) {
    T v;
    gather_run<T, 1>(hb, node, j / C, j % C, C, &v);
    o[j] = v;
  }
  for (int i = tid; i < body; i += kThreads) {
    const int j = head + i * kVec;
    __align__(16) T vals[kVec];
    gather_run<T, kVec>(hb, node, j / C, j % C, C, vals);
    *reinterpret_cast<uint4*>(o + j) = *reinterpret_cast<const uint4*>(vals);
  }
  for (int j = head + body * kVec + tid; j < len; j += kThreads) {
    T v;
    gather_run<T, 1>(hb, node, j / C, j % C, C, &v);
    o[j] = v;
  }
}

template <typename T, bool kRoundEach>
cudaError_t launch_scatter(const int* idx, const uint8_t* mask, const void* m,
                           void* out, int B, int E, int N, int C, int R,
                           cudaStream_t stream) {
  const size_t bytes = (size_t)scatter_smem_ints(E, R) * sizeof(int);
  const int ranges = (N + R - 1) / R;
  segment_scatter_kernel<T, kRoundEach>
      <<<B * ranges, kThreads, bytes, stream>>>(
      idx, mask, static_cast<const T*>(m), static_cast<T*>(out), E, N, C, R,
      ranges);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gather(const int* idx, const uint8_t* mask, const void* h,
                          void* out, int B, int E, int N, int C, int chunk,
                          cudaStream_t stream) {
  const int chunks = (E + chunk - 1) / chunk;
  segment_gather_kernel<T><<<B * chunks, kThreads, 0, stream>>>(
      idx, mask, static_cast<const T*>(h), static_cast<T*>(out), E, N, C,
      chunk, chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one scatter CTA needs for E edges and R nodes a range.
long long segment_scatter_smem_bytes(int E, int R) {
  return scatter_smem_ints(E, R) * (long long)sizeof(int);
}

// Scatter CTAs one SM of the current device holds at E edges and R nodes a
// range (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// cudaError_t.
int segment_scatter_ctas_per_sm(int E, int R, int bf16) {
  const size_t bytes = (size_t)scatter_smem_ints(E, R) * sizeof(int);
  int n = 0;
  const cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, segment_scatter_kernel<__nv_bfloat16, false>, kThreads,
                 bytes)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, segment_scatter_kernel<float, false>, kThreads, bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Lets every scatter kernel take up to `bytes` of dynamic shared memory a
// CTA on the current device: once per device, before the first launch.
// Returns the cudaError_t (0 on success).
int segment_set_smem_limit(int bytes) {
  const void* kernels[] = {
      reinterpret_cast<const void*>(segment_scatter_kernel<float, false>),
      reinterpret_cast<const void*>(
          segment_scatter_kernel<__nv_bfloat16, false>),
      reinterpret_cast<const void*>(segment_scatter_kernel<float, true>),
      reinterpret_cast<const void*>(
          segment_scatter_kernel<__nv_bfloat16, true>)};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One scatter launch on `stream`: B*ceil(N/R) CTAs of 256 threads, R nodes
// a CTA (1 <= R <= 1024), E < 2^21 (an edge list entry holds e and k).
// idx [B,E] int32, mask [B,E] bool (one byte), m [B,E,C] in the compute
// dtype (bf16 != 0: bfloat16, else float32). Writes
// every element of out [B,N,C] (zeros where no valid edge lands). Returns
// the cudaError_t of the launch (0 on success).
static int scatter_entry(const void* idx, const void* mask, const void* m,
                         void* out, int B, int E, int N, int C, int R,
                         int bf16, int round_each, void* stream) {
  if (B < 1 || E < 0 || N < 1 || C < 1 || R < 1 || R > kMaxRange ||
      E >= (1 << (31 - kKeyBits - kWarpBits)) * kWarps) {
    return cudaErrorInvalidValue;
  }
  const int* pi = static_cast<const int*>(idx);
  const uint8_t* pm = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return round_each ? launch_scatter<__nv_bfloat16, true>(
                            pi, pm, m, out, B, E, N, C, R, st)
                      : launch_scatter<__nv_bfloat16, false>(
                            pi, pm, m, out, B, E, N, C, R, st);
  }
  return round_each
             ? launch_scatter<float, true>(pi, pm, m, out, B, E, N, C, R, st)
             : launch_scatter<float, false>(pi, pm, m, out, B, E, N, C, R,
                                            st);
}

int segment_scatter(const void* idx, const void* mask, const void* m,
                    void* out, int B, int E, int N, int C, int R, int bf16,
                    void* stream) {
  return scatter_entry(idx, mask, m, out, B, E, N, C, R, bf16, 0, stream);
}

// segment_scatter with each add rounded to m's dtype (the header).
int segment_scatter_rounded(const void* idx, const void* mask, const void* m,
                            void* out, int B, int E, int N, int C, int R,
                            int bf16, void* stream) {
  return scatter_entry(idx, mask, m, out, B, E, N, C, R, bf16, 1, stream);
}

// One gather launch on `stream`: B*ceil(E/chunk) CTAs of 256 threads,
// `chunk` edges a CTA (1 <= chunk <= 2048, a multiple of 8 where E is
// larger). idx, mask as above, h [B,N,C]; writes out [B,E,C] in h's dtype.
// Returns the cudaError_t of the launch.
int segment_gather(const void* idx, const void* mask, const void* h,
                   void* out, int B, int E, int N, int C, int chunk, int bf16,
                   void* stream) {
  if (B < 1 || E < 0 || N < 1 || C < 1 || chunk < 1 || chunk > kMaxChunk) {
    return cudaErrorInvalidValue;
  }
  if (E == 0) return cudaSuccess;
  const int* pi = static_cast<const int*>(idx);
  const uint8_t* pm = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_gather<__nv_bfloat16>(pi, pm, h, out, B, E, N, C, chunk,
                                        st);
  }
  return launch_gather<float>(pi, pm, h, out, B, E, N, C, chunk, st);
}

}  // extern "C"
