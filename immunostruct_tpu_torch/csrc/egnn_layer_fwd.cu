// B7: one whole EGNN layer forward in one kernel, for Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/experimental/pallas_egnn.py::
// _fused_layer_kernel (launched by fused_egnn_layer). Forward only. For
// each graph b, from the raw edge indices and mask, with the edge features
// taken as all ones (their weight row folded into the bias):
//   h_src = h[src], h_dst = h[dst]       zeros on a side whose index is
//                                        masked or outside [0, N)
//   x_diff = xc[src] - xc[dst]           xc: x in the compute dtype; f32
//   radial = |x_diff|^2, x_hat = x_diff / (sqrt(radial) + 1e-30)      f32
//   z1 = h_src @ W_src + h_dst @ W_dst + rnd(radial) * w_rad + bias1
//   m1 = rnd(silu(z1)); m = rnd(silu(m1 @ We2 + be2))
//   c1 = rnd(silu(m @ Wc1 + bc1)); cw = c1 . wc2 (f32, not rounded)
//   msg_x = rnd(cw * x_hat)
//   acc[dst] += m, accx[dst] += msg_x    f32, only where dst lies in [0, N)
//                                        and the edge is not masked
//   a = rnd(silu(h @ Wn1_top + rnd(acc) @ Wn1_bot + bn1))
//   h' = rnd(a @ Wn2 + bn2)              the compute dtype
//   x' = x + accx                        f32 from x's own dtype, stored in it
// These are the TPU kernel's rounding points (pallas_egnn.py:56-125): bias1 =
// be1 + we1[2F+1] is summed in the compute dtype (the JAX wrapper casts both
// first); the weights arrive in the compute dtype, as the JAX wrapper casts
// them; every product accumulates in f32.
//
// What bounds it on the H100: per computed edge four [., 64] x [64, 64]
// products (the edge MLP's first layer per edge, not projection-first as
// in B1, then We2 and Wc1), plus the node MLP's two per node, on the CUDA
// cores in f32: bound by arithmetic, far above the bf16 tensor-core bound.
//
// Design: one CTA per graph (grid B, as the TPU kernel's grid), 256 threads,
// 64-edge tiles (egnn_common.cuh's thread layout: 16 edge groups of 4 edges
// x 16 column groups of 4 columns). Shared memory holds h in the compute
// dtype, x in the compute dtype, the f32 sums acc [N][H] and accx [N][3],
// two tile buffers and the tile's geometry: 192,268 B at N=288, F=H=64 in
// f32 (155,276 B in bf16), checked against the card's per-block limit by
// the wrapper. The weight matrices stay in device memory and are read
// through L1 (they do not fit beside the f32 sums). Each index is tested
// against [0, N) before any load; a side out of range reads a zero row. The
// sums at dst take no atomics: one thread per column adds the tile's edges
// in edge order, so the result is the same bits every run. Then a barrier
// and the node MLP in the same CTA, in 64-row blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

namespace {

using namespace egnn;

// the packed weights (the compute dtype), in order: we1 [2F+2][H], be1 [H],
// we2 [H][H], be2 [H], wc1 [H][H], bc1 [H], wc2 [H], wn1 [F+H][H], bn1 [H],
// wn2 [H][H], bn2 [H]
__host__ __device__ inline long long weight_count(int f, int hid) {
  return (2LL * f + 2) * hid + 3LL * hid * hid + (long long)(f + hid) * hid +
         6LL * hid;
}

template <typename T>
struct Weights {
  const T* w_src;    // [F][H]
  const T* w_dst;    // [F][H]
  const T* w_rad;    // [H]
  const T* w_ef;     // [H], the all-ones feature's row
  const T* be1;
  const T* we2;      // [H][H]
  const T* be2;
  const T* wc1;      // [H][H]
  const T* bc1;
  const T* wc2;      // [H]
  const T* wn1_top;  // [F][H]
  const T* wn1_bot;  // [H][H]
  const T* bn1;
  const T* wn2;      // [H][H]
  const T* bn2;
};

template <typename T>
__device__ __forceinline__ Weights<T> carve_weights(const T* w, int F, int H) {
  Weights<T> p;
  p.w_src = w;
  p.w_dst = p.w_src + F * H;
  p.w_rad = p.w_dst + F * H;
  p.w_ef = p.w_rad + H;
  p.be1 = p.w_ef + H;
  p.we2 = p.be1 + H;
  p.be2 = p.we2 + H * H;
  p.wc1 = p.be2 + H;
  p.bc1 = p.wc1 + H * H;
  p.wc2 = p.bc1 + H;
  p.wn1_top = p.wc2 + H;
  p.wn1_bot = p.wn1_top + F * H;
  p.bn1 = p.wn1_bot + H * H;
  p.wn2 = p.bn1 + H;
  p.bn2 = p.wn2 + H * H;
  return p;
}

// rows of the per-graph vectors in shared memory (f32, [7][H])
constexpr int kBias1 = 0, kWRad = 1, kBe2 = 2, kBc1 = 3, kWc2 = 4, kBn1 = 5,
              kBn2 = 6, kVecs = 7;

__host__ __device__ inline long long smem_bytes(int n, int f, int hid,
                                                int tsize) {
  const long long floats = (long long)n * hid + 3LL * n + 3LL * (n + 1) +
                           (long long)kVecs * hid +
                           2LL * kTile * row_stride(hid) + 7LL * kTile;
  const long long ints = 3LL * kTile;
  const long long hbytes = (long long)(n + 1) * f * tsize;
  return 4 * (floats + ints) + (hbytes + 3) / 4 * 4;
}

// acc[i][c] = sum_{k<K} a[i][k] * w[k*H + cg*CPT + c] in f32: a[i] the rows
// of this thread's four edges (or nodes), w a [K][H] matrix in device memory
template <typename A, typename W, int H>
__device__ __forceinline__ void rows_product(const A* const (&a)[4], int K,
                                             const W* __restrict__ w, int cg,
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
    for (int i = 0; i < 4; ++i) av[i] = to_f(a[i][k]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) wv[c] = to_f(w[k * H + cg * CPT + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
  }
}

template <typename T, typename XT, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_layer_fwd_kernel(const int* __restrict__ src,
                          const int* __restrict__ dst,
                          const uint8_t* __restrict__ mask,
                          const T* __restrict__ h, const XT* __restrict__ x,
                          const T* __restrict__ weights,
                          T* __restrict__ h_out, XT* __restrict__ x_out,
                          int N, int E, int F) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;
  static_assert(H % 16 == 0, "H must be a multiple of 16");

  extern __shared__ float smem[];
  float* acc = smem;                  // [N][H] f32 sums of m at dst
  float* accx = acc + N * H;          // [N][3] f32 sums of msg_x at dst
  float* xc = accx + N * 3;           // [N+1][3] x in the compute dtype
  float* vec = xc + (N + 1) * 3;      // [kVecs][H]
  float* bufA = vec + kVecs * H;      // [kTile][LD] m1; node MLP: a
  float* bufB = bufA + kTile * LD;    // [kTile][LD] m
  float* msgx = bufB + kTile * LD;    // [kTile][3]
  float* xh = msgx + kTile * 3;       // [kTile][3] x_hat
  float* rad = xh + kTile * 3;        // [kTile] radial, rounded
  int* srow = reinterpret_cast<int*>(rad + kTile);  // [kTile] node or N
  int* drow = srow + kTile;           // [kTile] node or N
  int* dok = drow + kTile;            // [kTile] 1: summed at drow
  T* hs = reinterpret_cast<T*>(dok + kTile);  // [N+1][F]; row N zeros

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge (node) group: rows tg*4 .. tg*4+3
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const Weights<T> w = carve_weights(weights, F, H);
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const XT* xb = x + (size_t)b * N * 3;

  // ---- h and x of the graph, zero rows, sums, per-graph vectors ----
  for (int i = tid; i < N * F; i += kThreads) hs[i] = h[(size_t)b * N * F + i];
  for (int i = tid; i < F; i += kThreads) hs[N * F + i] = from_f<T>(0.0f);
  for (int i = tid; i < N * 3; i += kThreads) xc[i] = rnd<T>(to_f(xb[i]));
  for (int i = tid; i < 3; i += kThreads) xc[N * 3 + i] = 0.0f;
  for (int i = tid; i < N * H; i += kThreads) acc[i] = 0.0f;
  for (int i = tid; i < N * 3; i += kThreads) accx[i] = 0.0f;
  for (int j = tid; j < H; j += kThreads) {
    // the all-ones edge feature's row folded into the bias, summed in the
    // compute dtype
    vec[kBias1 * H + j] = rnd<T>(to_f(w.be1[j]) + to_f(w.w_ef[j]));
    vec[kWRad * H + j] = to_f(w.w_rad[j]);
    vec[kBe2 * H + j] = to_f(w.be2[j]);
    vec[kBc1 * H + j] = to_f(w.bc1[j]);
    vec[kWc2 * H + j] = to_f(w.wc2[j]);
    vec[kBn1 * H + j] = to_f(w.bn1[j]);
    vec[kBn2 * H + j] = to_f(w.bn2[j]);
  }
  __syncthreads();

  for (int e0 = 0; e0 < E; e0 += kTile) {
    // ---- geometry: indices tested before any load ----
    if (tid < kTile) {
      const int e = e0 + tid;
      int s = N, d = N, ok = 0;
      if (e < E && maskb[e] != 0) {
        const int si = srcb[e], di = dstb[e];
        if (si >= 0 && si < N) s = si;
        if (di >= 0 && di < N) {
          d = di;
          ok = 1;
        }
      }
      const float d0 = __fsub_rn(xc[s * 3 + 0], xc[d * 3 + 0]);
      const float d1 = __fsub_rn(xc[s * 3 + 1], xc[d * 3 + 1]);
      const float d2 = __fsub_rn(xc[s * 3 + 2], xc[d * 3 + 2]);
      const float r = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                __fmul_rn(d2, d2));
      const float den = __fadd_rn(sqrtf(r > 0.0f ? r : 1.0f), 1e-30f);
      xh[tid * 3 + 0] = __fdiv_rn(d0, den);
      xh[tid * 3 + 1] = __fdiv_rn(d1, den);
      xh[tid * 3 + 2] = __fdiv_rn(d2, den);
      rad[tid] = rnd<T>(r);
      srow[tid] = s;
      drow[tid] = d;
      dok[tid] = ok;
    }
    __syncthreads();

    // ---- z1 = h_src @ W_src + h_dst @ W_dst + radial * w_rad + bias1 ----
    {
      const T* as[4];
      const T* ad[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        as[i] = hs + srow[tg * 4 + i] * F;
        ad[i] = hs + drow[tg * 4 + i] * F;
      }
      float za[4][CPT], zb[4][CPT];
      rows_product<T, T, H>(as, F, w.w_src, cg, za);
      rows_product<T, T, H>(ad, F, w.w_dst, cg, zb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float z1 = __fadd_rn(
              __fadd_rn(__fadd_rn(za[i][c], zb[i][c]),
                        __fmul_rn(rad[t], vec[kWRad * H + j])),
              vec[kBias1 * H + j]);
          bufA[t * LD + j] = rnd<T>(silu(z1));
        }
      }
    }
    __syncthreads();

    // ---- m = silu(m1 @ We2 + be2) ----
    {
      const float* a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = bufA + (tg * 4 + i) * LD;
      float r[4][CPT];
      rows_product<float, T, H>(a, H, w.we2, cg, r);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float mv = rnd<T>(silu(r[i][c] + vec[kBe2 * H + j]));
          bufB[t * LD + j] = mv;
        }
    }
    __syncthreads();

    // ---- cw = silu(m @ Wc1 + bc1) . wc2; msg_x = cw * x_hat ----
    {
      const float* a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = bufB + (tg * 4 + i) * LD;
      float r[4][CPT];
      rows_product<float, T, H>(a, H, w.wc1, cg, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float c1 = rnd<T>(silu(r[i][c] + vec[kBc1 * H + j]));
          part += c1 * vec[kWc2 * H + j];
        }
        const float cw = sum16(part);  // f32, not rounded
        if (cg == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            msgx[t * 3 + k] = rnd<T>(__fmul_rn(cw, xh[t * 3 + k]));
          }
        }
      }
    }
    __syncthreads();

    // ---- the sums at dst: one thread per column, the tile's edges in
    // edge order (no atomics) ----
    if (tid < H + 3) {
      for (int t = 0; t < kTile; ++t) {
        if (!dok[t]) continue;
        if (tid < H) {
          acc[drow[t] * H + tid] += bufB[t * LD + tid];
        } else {
          accx[drow[t] * 3 + tid - H] += msgx[t * 3 + tid - H];
        }
      }
    }
    __syncthreads();  // tile buffers and geometry are rewritten next tile
  }

  // ---- agg rounded to the compute dtype before the node MLP ----
  for (int i = tid; i < N * H; i += kThreads) acc[i] = rnd<T>(acc[i]);
  __syncthreads();

  // ---- node MLP in blocks of kTile rows ----
  for (int r0 = 0; r0 < N; r0 += kTile) {
    {
      const T* ah[4];
      const float* aa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = min(r0 + tg * 4 + i, N);  // row N: zeros
        ah[i] = hs + row * F;
        aa[i] = acc + min(row, N - 1) * H;
      }
      float za[4][CPT], zb[4][CPT];
      rows_product<T, T, H>(ah, F, w.wn1_top, cg, za);
      rows_product<float, T, H>(aa, H, w.wn1_bot, cg, zb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float zn =
              __fadd_rn(__fadd_rn(za[i][c], zb[i][c]), vec[kBn1 * H + j]);
          bufA[t * LD + j] = rnd<T>(silu(zn));
        }
      }
    }
    __syncthreads();  // a complete for the block
    {
      const float* a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = bufA + (tg * 4 + i) * LD;
      float q[4][CPT];
      rows_product<float, T, H>(a, H, w.wn2, cg, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + tg * 4 + i;
        if (row >= N) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          h_out[((size_t)b * N + row) * H + j] =
              from_f<T>(q[i][c] + vec[kBn2 * H + j]);
        }
      }
    }
    __syncthreads();  // bufA is rewritten by the next block
  }

  // ---- x' = x + accx, in f32 from x's own dtype ----
  for (int i = tid; i < N * 3; i += kThreads) {
    x_out[(size_t)b * N * 3 + i] = from_f<XT>(to_f(xb[i]) + accx[i]);
  }
}

template <typename T, typename XT>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* h, const void* x, const void* weights,
                   void* h_out, void* x_out, int B, int N, int E, int F,
                   cudaStream_t stream) {
  const size_t bytes = (size_t)smem_bytes(N, F, kHidden, sizeof(T));
  auto kernel = egnn_layer_fwd_kernel<T, XT, kHidden>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const T*>(h), static_cast<const XT*>(x),
      static_cast<const T*>(weights), static_cast<T*>(h_out),
      static_cast<XT*>(x_out), N, E, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes, input width F and hidden width
// H, features in bfloat16 (bf16 != 0) or float32.
long long egnn_layer_fwd_smem_bytes(int N, int F, int H, int bf16) {
  return smem_bytes(N, F, H, bf16 ? 2 : 4);
}

// Elements of the packed weights of one layer of input width F.
long long egnn_layer_fwd_weight_count(int F, int H) {
  return weight_count(F, H);
}

// One launch: B CTAs of 256 threads on `stream`. src/dst [B,E] int32, mask
// [B,E] bool; h [B,N,F] in the compute dtype (bf16 != 0: bfloat16, else
// float32); x [B,N,3] in bfloat16 (x_bf16 != 0) or float32; weights the
// packed layer (weight_count elements, the compute dtype). Writes h_out
// [B,N,H] in the compute dtype and x_out [B,N,3] in x's dtype. Returns the
// cudaError_t of the launch.
int egnn_layer_fwd(const void* src, const void* dst, const void* mask,
                   const void* h, const void* x, const void* weights,
                   void* h_out, void* x_out, int B, int N, int E, int F,
                   int H, int bf16, int x_bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > H || H != egnn::kHidden) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && x_bf16) {
    return launch<__nv_bfloat16, __nv_bfloat16>(s, d, m, h, x, weights, h_out,
                                                x_out, B, N, E, F, st);
  }
  if (bf16) {
    return launch<__nv_bfloat16, float>(s, d, m, h, x, weights, h_out, x_out,
                                        B, N, E, F, st);
  }
  if (x_bf16) {
    return launch<float, __nv_bfloat16>(s, d, m, h, x, weights, h_out, x_out,
                                        B, N, E, F, st);
  }
  return launch<float, float>(s, d, m, h, x, weights, h_out, x_out, B, N, E,
                              F, st);
}

}  // extern "C"
