// B4: the EGNN edge half-layer forward on the mirror-paired edge layout, for
// Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/pallas_mega.py::_mega_fwd_kernel_paired
// (launched by _mega_fwd_call_paired; JAX flag MEGA_PAIRED). The layout:
// edge k + E/2 is the reverse of edge k (k < E/2, "the arc"), with the same
// mask. The kernel reads the arc half's indices and mask only. Per arc
// s -> d: one xd = x[s] - x[d], one radial and one x_hat serve both
// directions, then two chains of B1 (csrc/egnn_mega_fwd.cu):
//   forward  a1 = pa[s] + pb[d] + w1r*radial + w1e*ef[k] + b1,
//            out[d] += [m ++ cw * x_hat]
//   mirror   a1' = pa[d] + pb[s] + w1r*radial + w1e*ef[k+E/2] + b1,
//            out[s] += [m' ++ cw' * (-x_hat)]
// Residuals: a1 of each direction at its column (k, k+E/2), xd at k and -xd
// at k+E/2. A masked arc, or one with an index outside [0, N), is skipped in
// both directions with zero residuals, as B1 skips an edge. Same outputs as
// B1 on the same (paired) batch: the mirror's xd is -xd exactly.
//
// What bounds it on the H100: B1's (the two HxH products per edge on the
// CUDA cores, the gathers and shared-memory atomics). The TPU kernel's gain
// was half the one-hot builds; a gather kernel has none, so what is left to
// save here is half the index, mask and coordinate loads and half the
// geometry (a sqrt and a division per arc): small against the products.
//
// Design: B1's, one CTA (256 threads) per graph, with 64-slot tiles of 32
// arcs and their 32 mirrors (slot t < 32 arc a0+t, slot t+32 its mirror), so
// that the chain (egnn_common.cuh fwd_tile_chain) runs unchanged on 64
// slots. Rounding points under bf16 are B1's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_common.cuh"

namespace {

using namespace egnn;

constexpr int kArcs = kTile / 2;  // arcs per tile; their mirrors fill the rest

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_mega_paired_fwd_kernel(const int* __restrict__ src,
                                const int* __restrict__ dst,
                                const uint8_t* __restrict__ mask,
                                const T* __restrict__ ef,
                                const T* __restrict__ h,
                                const T* __restrict__ x,
                                const float* __restrict__ w1ab,
                                const float* __restrict__ w2,
                                const float* __restrict__ wc1,
                                const float* __restrict__ small,
                                float* __restrict__ out, float* proj,
                                T* __restrict__ a1_out,
                                T* __restrict__ xd_out, int N, int E, int F) {
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
  const int half = E / 2;
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

  for (int a0 = 0; a0 < half; a0 += kArcs) {
    // ---- one geometry per arc, for both of its directions ----
    if (tid < kArcs) {
      const int k = a0 + tid;
      int s = 0, d = 0, ok = 0;
      float r = 0.0f, ev = 0.0f, er = 0.0f, h0 = 0.0f, h1 = 0.0f,
            h2 = 0.0f;
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
      if (k < half) {
        s = srcb[k];
        d = dstb[k];
        ok = maskb[k] != 0 && s >= 0 && s < N && d >= 0 && d < N;
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
        ev = to_f(efb[k]);
        er = to_f(efb[k + half]);
      } else {
        s = 0;
        d = 0;
      }
      if (xdb != nullptr && k < half) {
        xdb[0 * E + k] = from_f<T>(d0);
        xdb[1 * E + k] = from_f<T>(d1);
        xdb[2 * E + k] = from_f<T>(d2);
        xdb[0 * E + k + half] = from_f<T>(-d0);
        xdb[1 * E + k + half] = from_f<T>(-d1);
        xdb[2 * E + k + half] = from_f<T>(-d2);
      }
      const int m = tid + kArcs;  // the mirror's slot
      g.src[tid] = s;
      g.dst[tid] = d;
      g.src[m] = d;
      g.dst[m] = s;
      g.ok[tid] = g.ok[m] = ok;
      g.col[tid] = k < half ? k : -1;
      g.col[m] = k < half ? k + half : -1;
      g.rad[tid] = g.rad[m] = r;
      g.ef[tid] = ev;
      g.ef[m] = er;
      g.xh[tid * 3 + 0] = h0;
      g.xh[tid * 3 + 1] = h1;
      g.xh[tid * 3 + 2] = h2;
      g.xh[m * 3 + 0] = -h0;
      g.xh[m * 3 + 1] = -h1;
      g.xh[m * 3 + 2] = -h2;
    }
    __syncthreads();
    fwd_tile_chain<T, H>(acc, w2s, wc1s, sms, bufA, bufB, g, pab, a1b, E,
                         tid);
  }

  float* ob = out + (size_t)b * N * C;
  for (int i = tid; i < N * C; i += kThreads) ob[i] = acc[i];
}

template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h, const void* x,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, float* out, float* proj, void* a1,
                   void* xd, int B, int N, int E, int F, cudaStream_t stream) {
  const size_t bytes = (size_t)fwd_smem_floats(N, H) * sizeof(float);
  auto kernel = egnn_mega_paired_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h),
      static_cast<const T*>(x), w1ab, w2, wc1, small, out, proj,
      static_cast<T*>(a1), static_cast<T*>(xd), N, E, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes and hidden width H.
long long egnn_mega_paired_fwd_smem_bytes(int N, int H) {
  return egnn::fwd_smem_floats(N, H) * (long long)sizeof(float);
}

// One launch: B CTAs of 256 threads on `stream`, B1's interface
// (csrc/egnn_mega_fwd.cu) on a mirror-paired batch: src/dst [B,E] int32 and
// mask [B,E] bool of which only the arc half (edges 0 .. E/2-1) is read, E
// even; ef [B,E,1], h [B,N,F], x [B,N,3] in the compute dtype (bf16 != 0:
// bfloat16, else float32); w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32; out
// [B,N,H+3] f32; proj [B,N,2H] f32 scratch; a1 [B,H,E] and xd [B,3,E] in the
// compute dtype, or both null. Returns the cudaError_t of the launch.
int egnn_mega_paired_fwd(const void* src, const void* dst, const void* mask,
                         const void* ef, const void* h, const void* x,
                         const void* w1ab, const void* w2, const void* wc1,
                         const void* small, void* out, void* proj, void* a1,
                         void* xd, int B, int N, int E, int F, int H,
                         int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || E % 2 || F < 1 || F > egnn::kTile ||
      H != egnn::kHidden || (a1 == nullptr) != (xd == nullptr)) {
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
    return launch<__nv_bfloat16, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2,
                                                pwc1, psm, po, pp, a1, xd, B,
                                                N, E, F, st);
  }
  return launch<float, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1, psm,
                                      po, pp, a1, xd, B, N, E, F, st);
}

}  // extern "C"
