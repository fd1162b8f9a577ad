// B6: the whole EGNN conv stack forward in one kernel, for Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/experimental/pallas_stack.py::
// _stack_fwd_kernel (launched by _stack_fwd_call; JAX flag STACK_ENABLE).
// One CTA per graph runs all L layers with h and x resident in shared
// memory. Per layer l (input width F = F0 for l = 0, else H):
//   edge half   B1 (csrc/egnn_mega_fwd.cu): pa | pb = h @ W1ab, then per
//               edge a1, m, cw, summed in f32 into agg [N][H+3];
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
// What bounds it on the H100: per layer B1's work (bytes, the two H x H
// products per edge) plus the node MLP's [N,F+H]x[F+H,H] and [N,H]x[H,H]
// products per graph (37.3 GFLOP and 334 MB for six layers at B=128,
// N=288, E=2560 with the residuals: 0.10 ms at the bf16 tensor-core peak
// and the memory rate). One CTA a graph leaves a B=1 request on one SM.
//
// Design, bf16 (egnn_stack_fwd_mma_kernel): one CTA of 256 threads a graph,
// the layers in a loop, h and x resident in shared memory in bf16 (h in
// rows of kLdb, 41,472 B at N=288). Per layer:
//   - the projections pa | pb with B1's arithmetic (proj_block, the rounded
//     W1ab in f32 in the stage area) into the per-graph proj scratch in
//     device memory, rounded to bf16;
//   - the edge half is B1's chunk body (csrc/egnn_mega.cuh mma_edge_chunk)
//     over all E edges of the graph, x read from shared memory: mma.sync
//     for both H x H products, m from accumulator to A operand in
//     registers, and the sums at dst without atomics, tile by tile and slot
//     by slot. Where B1 runs one chunk a graph (ops/mega.py fwd_chunks at
//     B=128 on 132 SMs), layer l of B6 is B1 run on (hs[l-1], xs[l-1]) bit
//     for bit: the same projections, the same body, the same sum order;
//   - agg rounded in place; x += agg_x;
//   - the node MLP on mma.sync in 64-row blocks: the A tile [h ++ agg_h]
//     (bf16, zero columns up to a depth of 16k) against nm0w (bf16, in the
//     edge weights' place), silu in f32 on the f32 sum and bias, hmid
//     rounded into a bf16 tile, then hmid @ nm1w + nm1b rounded into h. Each
//     16-deep product starts from zero and is added in f32 (mma_add). A
//     value of hmid or h about to round within kTieUlps f32 units of a bf16
//     rounding boundary is recomputed on the CUDA cores in the plain
//     version's order (csrc/egnn_hopper.cuh near_tie, dot_n), as B2's and
//     B3's are: without it a B=1 graph's h rounded one step off the plain
//     version's in a column of small mean, past the per-column mean bound.
// Every sum is in a fixed order: the same bits every run.
//
// The f32 form (egnn_stack_fwd_kernel) keeps the CUDA cores, so its f32
// bounds hold: B1's f32 chain of egnn_common.cuh (fwd_tile_chain, sums in
// edge order) looped over the layers, the node MLP as f32 register tiles;
// h and x held as f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_mega.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

constexpr int kLdA = 2 * kHidden + 8;  // A tile row of the node MLP: 272 B

// byte offsets into a CTA's shared memory: the f32 node block [N][H+3], h
// bf16 [N][kLdb], x bf16 [N][3], W2 and Wc1 bf16 [H][kLdb] (node MLP: nm0w
// [F+H padded to 16k][kLdb]), small^T [6][H] f32, the node biases [2][H]
// f32, the two warpgroups' stages (projections: W1ab f32 [2F][H]; node MLP:
// the A tile [64][kLdA], nm1w [H][kLdb], hmid [64][kLdb]) and geometries
struct StackLayout {
  int h, x, w2, wc1, sms, nbs, stage, geo, bytes;
};

__host__ __device__ inline StackLayout stack_layout(int n) {
  StackLayout l;
  l.h = (4 * n * (kHidden + 3) + 15) / 16 * 16;
  l.x = l.h + n * kLdb * 2;
  l.w2 = l.x + (n * 3 * 2 + 15) / 16 * 16;
  l.wc1 = l.w2 + kHidden * kLdb * 2;
  l.sms = l.wc1 + kHidden * kLdb * 2;
  l.nbs = l.sms + 6 * kHidden * 4;
  l.stage = l.nbs + 2 * kHidden * 4;
  l.geo = l.stage + 2 * 2 * kTileBytes;
  l.bytes = l.geo + 2 * geometry_floats() * 4;
  return l;
}

template <int H>
__global__ void __launch_bounds__(kFwdThreads, 1)
    egnn_stack_fwd_mma_kernel(const int* __restrict__ src,
                              const int* __restrict__ dst,
                              const uint8_t* __restrict__ mask,
                              const bf* __restrict__ ef,
                              const bf* __restrict__ h0,
                              const bf* __restrict__ x0,
                              const float* __restrict__ weights, bf* proj,
                              bf* __restrict__ h_out, bf* __restrict__ x_out,
                              bf* __restrict__ hs, bf* __restrict__ xs,
                              bf* __restrict__ aggs, bf* __restrict__ a1s,
                              bf* __restrict__ xds, int N, int E, int F0,
                              int L) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  constexpr int C = H + 3;
  const StackLayout Y = stack_layout(N);
  extern __shared__ __align__(16) unsigned char smem_stack[];
  unsigned char* sm = smem_stack;
  float* acc = reinterpret_cast<float*>(sm);                // [N][C]
  bf* hsm = reinterpret_cast<bf*>(sm + Y.h);                // [N][kLdb]
  bf* xsm = reinterpret_cast<bf*>(sm + Y.x);                // [N][3]
  bf* w2s = reinterpret_cast<bf*>(sm + Y.w2);               // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + Y.wc1);             // [k][n]
  float* sms = reinterpret_cast<float*>(sm + Y.sms);        // [6][H]
  float* nbs = reinterpret_cast<float*>(sm + Y.nbs);        // [2][H]
  unsigned char* stage = sm + Y.stage;
  const ChunkSmem S{acc, w2s, wc1s, sms, stage,
                    reinterpret_cast<float*>(sm + Y.geo)};
  // the stage area between the edge halves: W1ab f32 for the projections;
  // the node MLP's A tile, nm1w and hmid
  float* w1s = reinterpret_cast<float*>(stage);             // [2F][H]
  bf* atile = reinterpret_cast<bf*>(stage);                 // [64][kLdA]
  bf* nm1s = atile + kTile * kLdA;                          // [H][kLdb]
  bf* hmid = nm1s + H * kLdb;                               // [64][kLdb]
  bf* nm0s = w2s;  // [Kp][kLdb]: fits, Kp <= 2H rows over W2 and Wc1

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fq = lane & 3;
  const int rb = (warp & 3) * 16, ch = (warp >> 2) * 32;  // node MLP block
  const bool keep = hs != nullptr;  // residuals for the backward
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const bf* efb = ef + (size_t)b * E;
  bf* projb = proj + (size_t)b * N * 2 * H;  // [N][2H]: pa | pb

  for (int i = tid; i < N * F0; i += kFwdThreads) {
    hsm[(i / F0) * kLdb + i % F0] = h0[(size_t)b * N * F0 + i];
  }
  for (int i = tid; i < N * 3; i += kFwdThreads) {
    xsm[i] = x0[(size_t)b * N * 3 + i];
  }

  const float* wl = weights;
  for (int l = 0; l < L; ++l) {
    const int F = l == 0 ? F0 : H;
    const int Kp = (F + H + 15) / 16 * 16;  // the node MLP's depth
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

    // ---- pa | pb = h @ W1ab, B1's arithmetic (proj_block) ----
    for (int i = tid; i < 2 * F * H; i += kFwdThreads) {
      w1s[i] = rnd<bf>(w1ab[i]);
    }
    __syncthreads();  // also: h and x of the layer are in place
    for (int n0 = 0; n0 < N; n0 += kProjNodes) {
      proj_block(hsm + n0 * kLdb, kLdb, w1s, F, min(kProjNodes, N - n0),
                 projb + (size_t)n0 * 2 * H, tid);
    }
    __syncthreads();  // pa | pb in device memory; the stage area is free

    // ---- the edge half: B1's chunk body over the graph's E edges ----
    for (int i = tid; i < N * C; i += kFwdThreads) acc[i] = 0.0f;
    stage_mma_weights(w2, wc1, small, w2s, wc1s, sms, tid);
    mma_edge_chunk<H, EdgeTiles>(
        srcb, dstb, maskb, efb, xsm, projb, keep ? a1s + bl * H * E : nullptr,
        keep ? xds + bl * 3 * E : nullptr, N, E, 0, E, S, tid);

    // ---- agg rounded; x += agg_x; the node MLP's weights ----
    for (int i = tid; i < N * C; i += kFwdThreads) {
      const float v = rnd<bf>(acc[i]);
      acc[i] = v;
      if (keep) aggs[bl * N * C + i] = __float2bfloat16(v);
    }
    __syncthreads();
    for (int i = tid; i < N * 3; i += kFwdThreads) {
      const bf v = __float2bfloat16(__bfloat162float(xsm[i]) +
                                    acc[(i / 3) * C + H + i % 3]);
      xsm[i] = v;
      if (keep) xs[bl * N * 3 + i] = v;
      if (l == L - 1) x_out[(size_t)b * N * 3 + i] = v;
    }
    for (int i = tid; i < Kp * H; i += kFwdThreads) {
      const int k = i / H, j = i % H;
      nm0s[k * kLdb + j] =
          __float2bfloat16(k < F + H ? nm0w[k * H + j] : 0.0f);
    }
    for (int i = tid; i < H * H; i += kFwdThreads) {
      nm1s[(i / H) * kLdb + i % H] = __float2bfloat16(nm1w[i]);
    }
    for (int i = tid; i < H; i += kFwdThreads) {
      nbs[i] = nm0b[i];
      nbs[H + i] = nm1b[i];
    }

    // ---- the node MLP in blocks of 64 rows: warp (rb, ch) takes rows
    // rb .. rb+15 and columns ch .. ch+31 of a block ----
    for (int r0 = 0; r0 < N; r0 += kTile) {
      __syncthreads();  // weights staged; the previous block's tiles read
      for (int i = tid; i < kTile * Kp; i += kFwdThreads) {
        const int row = i / Kp, k = i % Kp, node = r0 + row;
        bf v = __float2bfloat16(0.0f);
        if (node < N) {
          if (k < F) {
            v = hsm[node * kLdb + k];
          } else if (k < F + H) {
            v = __float2bfloat16(acc[node * C + k - F]);
          }
        }
        atile[row * kLdA + k] = v;
      }
      __syncthreads();
      {
        float p[4][4];
        block_product(atile, kLdA, nm0s, Kp, rb, ch, lane, p);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = rb + fr + 8 * hh, j = ch + q * 8 + 2 * fq;
            float v[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float p1 = p[q][2 * hh + c] + nbs[j + c];
              v[c] = p1 * sigmoid_fast(p1);
              if (near_tie(v[c])) {  // in the plain version's order
                const float pe = dot_n(atile + row * kLdA, 1,
                                       nm0s + j + c, kLdb, Kp) +
                                 nbs[j + c];
                v[c] = pe * sigmoid(pe);
              }
            }
            store_pair(hmid + row * kLdb + j, v[0], v[1]);
          }
      }
      __syncthreads();  // hmid complete
      {
        float p[4][4];
        block_product(hmid, kLdb, nm1s, H, rb, ch, lane, p);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int node = r0 + rb + fr + 8 * hh, j = ch + q * 8 + 2 * fq;
            if (node >= N) continue;
            float hv[2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              hv[c] = p[q][2 * hh + c] + nbs[H + j + c];
              if (near_tie(hv[c])) {  // in the plain version's order
                const int row = rb + fr + 8 * hh;
                hv[c] = dot_n(hmid + row * kLdb, 1, nm1s + j + c, kLdb, H) +
                        nbs[H + j + c];
              }
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(hsm + node * kLdb + j) = v;
            if (keep) {
              *reinterpret_cast<__nv_bfloat162*>(
                  hs + (bl * N + node) * H + j) = v;
            }
            if (l == L - 1) {
              *reinterpret_cast<__nv_bfloat162*>(
                  h_out + ((size_t)b * N + node) * H + j) = v;
            }
          }
      }
    }
    __syncthreads();  // h of the layer complete; the stage area is free
  }
}

// shared memory of one CTA: the f32 or the bf16 form
inline long long smem_bytes(int n, int hid, bool bf16) {
  return bf16 ? stack_layout(n).bytes
              : smem_floats(n, hid) * (long long)sizeof(float);
}

template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h0, const void* x0,
                   const float* weights, float* proj, void* h_out,
                   void* x_out, void* hs, void* xs, void* aggs, void* a1s,
                   void* xds, int B, int N, int E, int F0, int L,
                   cudaStream_t stream) {
  const bool bf16 = sizeof(T) == 2;
  const size_t bytes = (size_t)smem_bytes(N, H, bf16);
  if constexpr (sizeof(T) == 2) {
    auto kernel = egnn_stack_fwd_mma_kernel<H>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<B, kFwdThreads, bytes, stream>>>(
        src, dst, mask, static_cast<const bf*>(ef), static_cast<const bf*>(h0),
        static_cast<const bf*>(x0), weights, reinterpret_cast<bf*>(proj),
        static_cast<bf*>(h_out), static_cast<bf*>(x_out), static_cast<bf*>(hs),
        static_cast<bf*>(xs), static_cast<bf*>(aggs), static_cast<bf*>(a1s),
        static_cast<bf*>(xds), N, E, F0, L);
  } else {
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
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes, hidden width H and the compute
// dtype (bf16 != 0: bfloat16, else float32).
long long egnn_stack_fwd_smem_bytes(int N, int H, int bf16) {
  return smem_bytes(N, H, bf16 != 0);
}

// CTAs that fit on one SM at once for N nodes, hidden width H and the
// compute dtype (the occupancy calculator's count), or -1 on a CUDA error.
int egnn_stack_fwd_ctas_per_sm(int N, int H, int bf16) {
  const int bytes = (int)smem_bytes(N, H, bf16 != 0);
  int n = 0;
  cudaError_t err;
  if (bf16) {
    auto kernel = egnn_stack_fwd_mma_kernel<egnn::kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, egnn::kFwdThreads, bytes);
    }
  } else {
    auto kernel = egnn_stack_fwd_kernel<float, egnn::kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, egnn::kThreads, bytes);
    }
  }
  return err == cudaSuccess ? n : -1;
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
// f32 scratch (bf16 keeps pa | pb there in bf16). Writes h_out [B,N,H] and
// x_out [B,N,3], and, unless hs is null (then xs, aggs, a1s and xds are
// null too), hs [B,L,N,H], xs [B,L,N,3], aggs [B,L,N,H+3], a1s [B,L,H,E]
// and xds [B,L,3,E], all in the compute dtype. Returns the cudaError_t of
// the launch.
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
