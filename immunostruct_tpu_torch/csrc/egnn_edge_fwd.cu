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
// (hsx and hdx read, out written, in bf16): 0.040 ms at 3.35 TB/s, 0.011 ms
// at the tensor cores' bf16 peak, 0.16 ms at the CUDA cores' f32 rate.
//
// What the design does about it:
//   - bf16 (egnn_edge_fwd_mma_kernel): the three products on the tensor
//     cores (mma.sync m16n8k16, bf16 operands from bf16 tiles in shared
//     memory, each product added in f32), one warpgroup of 128 threads a
//     CTA; per 64-edge tile warp w owns edges 16w..16w+15. The chain's
//     steps are B3's backward's (egnn_hopper.cuh chain_a1, chain_p2 and
//     chain_c1 without d_p3), with their near-tie recompute: a1s, m and c1
//     about to round to bf16 within kTieUlps f32 units of a rounding
//     boundary are recomputed on the CUDA cores in the plain version's
//     order. At F=20 the depth 2F=40 pads to 48 with zero rows;
//   - the next tile's runs of 64 bf16 along E (the bundles' F+3 rows each
//     side, ef) arrive by cp.async into the other of two stages while this
//     tile computes; the bundle rows are the A operand of the a1 product as
//     they land ([feature][edge], ldmatrix.trans). An E that is not a
//     multiple of 8 is read into the stage element by element instead;
//   - m and cw * x_hat leave through an output tile in shared memory (m^T
//     by ldmatrix.trans from the m tile), each thread storing 16-byte runs
//     along E;
//   - one CTA per (graph, edge chunk), enough CTAs to give every SM one;
//     its shared memory (107 KB at F=64) lets two CTAs share an SM;
//   - f32 keeps the CUDA-core form (egnn_edge_fwd_kernel: 256 threads a CTA,
//     register-tiled FMA loops over f32 tiles, a tile's features moved in
//     with neighbouring threads on neighbouring edges), so its f32 bounds
//     hold; TF32 would break them.
// No gathers, no atomics: the bundles come pre-gathered.
//
// Rounding points under bf16 are the TPU kernel's (pallas_edge.py:104-165):
// W1ab/W2/Wc1 rounded; xd the difference in the compute dtype; radial
// summed in f32 and rounded; silu(a1), m and silu(m @ Wc1 + bc1) rounded;
// cw an f32 dot with wc2, rounded before it meets x_hat; the output stored
// in the compute dtype. Sigmoid/silu and all sums in f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_hopper.cuh"

namespace {

using namespace egnn;

constexpr int kMaxF = 64;

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

// Byte offsets into a CTA's shared memory for node features F. A stage holds
// one tile's runs of 64 bf16 along E, each in a row of kRunBytes: the bundle
// features [hs ; hd] in rows 0..2F-1 (rows 2F..kp-1 stay zero: the depth of
// the a1 product is kp, 2F rounded up to 16), hs's and hd's coordinates in
// rows kp..kp+5, ef in the last row; rows 0..kp-1 are the A operand
// [feature][edge] of the a1 product. Then W1ab bf16 [kp][kLdb], W2, Wc1
// bf16 [H][kLdb], the a1s [j][t] and m [t][j] tiles, the tile's output
// [H+3][kLdb] bf16 (m^T, then cw * x_hat), small^T [6][H] f32 and the
// per-edge values (rows kERad .. kEXd+2 of egnn_hopper.cuh's).
struct EdgeFwdLayout {
  int kp, rows, stage, w1, w2, wc1, a1s, m, out, sms, edge, bytes;
};

__host__ __device__ inline EdgeFwdLayout edge_fwd_layout(int f) {
  EdgeFwdLayout l;
  l.kp = (2 * f + 15) / 16 * 16;
  l.rows = l.kp + 6 + 1;
  l.stage = l.rows * kRunBytes;
  l.w1 = 2 * l.stage;
  l.w2 = l.w1 + l.kp * kLdb * 2;
  l.wc1 = l.w2 + kHidden * kLdb * 2;
  l.a1s = l.wc1 + kHidden * kLdb * 2;
  l.m = l.a1s + kTileBytes;
  l.out = l.m + kTileBytes;
  l.sms = l.out + (kHidden + 3) * kLdb * 2;
  l.edge = l.sms + 6 * kHidden * 4;
  l.bytes = l.edge + (kEXd + 3) * kTile * 4;
  return l;
}

// Per graph b (CTAs b*chunks .. b*chunks+chunks-1, each a chunk of edges),
// the contract of egnn_edge_fwd_kernel in bf16, with the TPU kernel's
// rounding points (the header). One warpgroup; warp w owns edges
// 16w..16w+15 of a 64-edge tile for the chain (egnn_hopper.cuh: chain_a1,
// chain_p2, chain_c1, with the near-tie recompute); the next tile's runs
// arrive by cp.async while this one computes (when E is a multiple of 8 and
// the tensors 16-byte aligned; otherwise each tile is read into its stage,
// and written out, element by element). The tile's output rows leave
// through shared memory in 16-byte runs along E.
template <int H>
__global__ void __launch_bounds__(kMmaThreads, 2)
    egnn_edge_fwd_mma_kernel(const bf* __restrict__ hsx,
                             const bf* __restrict__ hdx,
                             const bf* __restrict__ ef,
                             const float* __restrict__ w1ab,
                             const float* __restrict__ w2,
                             const float* __restrict__ wc1,
                             const float* __restrict__ small,
                             bf* __restrict__ out, int E, int F, int chunks,
                             int chunk_edges) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  constexpr int C = H + 3;
  const EdgeFwdLayout L = edge_fwd_layout(F);
  const int F2 = 2 * F;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  bf* w1s = reinterpret_cast<bf*>(sm + L.w1);     // [feature][j]
  bf* w2s = reinterpret_cast<bf*>(sm + L.w2);     // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + L.wc1);   // [k][n]
  bf* a1st = reinterpret_cast<bf*>(sm + L.a1s);   // a1s [j][t]
  bf* mt = reinterpret_cast<bf*>(sm + L.m);       // m [t][j]
  bf* ot = reinterpret_cast<bf*>(sm + L.out);     // out [row][t]
  float* sms = reinterpret_cast<float*>(sm + L.sms);
  float* ev = reinterpret_cast<float*>(sm + L.edge);

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = warp * 16;
  const int rx = L.kp, re = L.kp + 6;  // stage rows
  const bf* hsb = hsx + (size_t)b * (F + 3) * E;
  const bf* hdb = hdx + (size_t)b * (F + 3) * E;
  const bf* efb = ef + (size_t)b * E;
  bf* ob = out + (size_t)b * C * E;
  // runs start 16-byte aligned: cp.async takes them whole, and the output
  // leaves in 16-byte stores
  const bool aligned =
      (E & 7) == 0 &&
      ((reinterpret_cast<uintptr_t>(hsx) | reinterpret_cast<uintptr_t>(hdx) |
        reinterpret_cast<uintptr_t>(ef) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  // the tensor row that stage row r holds (null: a zero row)
  auto row_src = [&](int r) -> const bf* {
    if (r < F) return hsb + (size_t)r * E;
    if (r < F2) return hdb + (size_t)(r - F) * E;
    if (r < rx) return nullptr;
    if (r < rx + 3) return hsb + (size_t)(F + r - rx) * E;
    if (r < re) return hdb + (size_t)(F + r - rx - 3) * E;
    return efb;
  };

  // ---- weights, rounded to bf16 by their store; zero rows ----
  for (int i = tid; i < L.kp * H; i += kMmaThreads) {
    const int k = i / H, j = i % H;
    w1s[k * kLdb + j] = __float2bfloat16(k < F2 ? w1ab[i] : 0.0f);
  }
  for (int i = tid; i < H * H; i += kMmaThreads) {
    const int k = i / H, j = i % H;
    w2s[k * kLdb + j] = __float2bfloat16(w2[i]);
    wc1s[k * kLdb + j] = __float2bfloat16(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kMmaThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
  for (int i = tid; i < 2 * (L.kp - F2) * kTile; i += kMmaThreads) {
    const int s = i / ((L.kp - F2) * kTile), r = i % ((L.kp - F2) * kTile);
    reinterpret_cast<bf*>(sm + s * L.stage + (F2 + r / kTile) * kRunBytes)
        [r % kTile] = __float2bfloat16(0.0f);
  }

  // ---- the pipeline: tile it computes from stage it % 2 while tile it+1
  // arrives in the other ----
  const int ntiles =
      e_end > e_begin ? (e_end - e_begin + kTile - 1) / kTile : 0;
  auto stage_tile = [&](int it) {
    unsigned char* st = sm + (it & 1) * L.stage;
    const int e0 = e_begin + it * kTile;
    const int n = min(kTile, e_end - e0);
    if (aligned) {
      const int nc = (2 * n + 15) / 16;
      for (int i = tid; i < L.rows * kRowChunks; i += kMmaThreads) {
        const int r = i / kRowChunks, c = i % kRowChunks;
        const bf* g = row_src(r);
        if (g != nullptr && c < nc) {
          cp_async16(st + r * kRunBytes + c * 16, g + e0 + c * 8);
        }
      }
    } else {
      for (int i = tid; i < L.rows * kTile; i += kMmaThreads) {
        const int r = i / kTile, t = i % kTile;
        const bf* g = row_src(r);
        if (g != nullptr) {
          reinterpret_cast<bf*>(st + r * kRunBytes)[t] =
              t < n ? g[e0 + t] : __float2bfloat16(0.0f);
        }
      }
    }
  };
  __syncthreads();  // weights and zero rows
  if (ntiles > 0) stage_tile(0);
  cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int e0 = e_begin + it * kTile;
    const int n = min(kTile, e_end - e0);
    unsigned char* st = sm + (it & 1) * L.stage;
    const bf* xt = reinterpret_cast<const bf*>(st);  // [feature][t], kLdb
    if (aligned && n < kTile) {
      // the ragged end of the chunk: zeros past its last edge, so that
      // those rows of every product are finite
      for (int i = tid; i < L.rows * kTile; i += kMmaThreads) {
        const int r = i / kTile, t = i % kTile;
        if (t >= n && row_src(r) != nullptr) {
          reinterpret_cast<bf*>(st + r * kRunBytes)[t] =
              __float2bfloat16(0.0f);
        }
      }
      __syncthreads();
    }
    auto at = [&](int r, int t) {
      return __bfloat162float(
          reinterpret_cast<const bf*>(st + r * kRunBytes)[t]);
    };

    // ---- per edge: xd, radial, 1 / (sqrt(radial) + 1e-30), ef ----
    if (tid < kTile) {
      const int t = tid;
      float d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d[k] = rnd<bf>(at(rx + k, t) - at(rx + 3 + k, t));
      }
      const float r = rnd<bf>(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const float safe = r > 0.0f ? r : 1.0f;
      ev[kERad * kTile + t] = r;
      ev[kEInv * kTile + t] = 1.0f / (sqrtf(safe) + 1e-30f);
      ev[kEEf * kTile + t] = at(re, t);
#pragma unroll
      for (int k = 0; k < 3; ++k) ev[(kEXd + k) * kTile + t] = d[k];
    }
    __syncthreads();

    // ---- a1 -> a1s [j][t]; p2 -> m [t][j]; p3 -> c1 -> cw (rounded, into
    // ev) ----
    chain_a1(xt, w1s, L.kp, F2, sms, ev, a1st, nullptr, m0, lane);
    __syncwarp();
    {
      float g2[8][4];  // silu'(p2): the backward's, not read here
      chain_p2(a1st, w2s, sms, mt, m0, lane, g2);
    }
    __syncwarp();
    {
      float unused[16];  // dbc1 and dwc2: the backward's
      chain_c1<false>(mt, wc1s, sms, ev, nullptr, m0, lane, unused, unused);
    }
    __syncwarp();

    // ---- this warp's 16 edges into the output tile: m^T by ldmatrix.trans
    // (8 x 8 blocks of m [t][j], each a block of ot [j][t]), and
    // cw * x_hat ----
    {
      const int q = lane >> 3, r = lane & 7;
#pragma unroll
      for (int j0 = 0; j0 < H; j0 += 16) {
        // blocks (edges m0 + 8*(q&1), columns j0 + 8*(q>>1))
        unsigned v[4];
        ldsm_x4_t(v, mt + (m0 + (q & 1) * 8 + r) * kLdb + j0 + (q >> 1) * 8);
#pragma unroll
        for (int blk = 0; blk < 4; ++blk) {
          const int j = j0 + (blk >> 1) * 8 + (lane >> 2);
          const int t = m0 + (blk & 1) * 8 + 2 * (lane & 3);
          *reinterpret_cast<unsigned*>(ot + j * kLdb + t) = v[blk];
        }
      }
      if (lane < 16) {
        const int t = m0 + lane;
        const float cwb = ev[kECw * kTile + t];
        const float inv = ev[kEInv * kTile + t];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ot[(H + k) * kLdb + t] =
              __float2bfloat16(cwb * (ev[(kEXd + k) * kTile + t] * inv));
        }
      }
    }
    __syncthreads();  // the whole tile's output rows

    // ---- out[:, e0 ..] = the tile's rows, 16-byte runs along E ----
    for (int i = tid; i < C * kRowChunks; i += kMmaThreads) {
      const int r = i / kRowChunks, c = i % kRowChunks, t0 = c * 8;
      bf* row = ob + (size_t)r * E + e0 + t0;
      const bf* src = ot + r * kLdb + t0;
      if (aligned && t0 + 8 <= n) {
        *reinterpret_cast<uint4*>(row) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int t = 0; t < 8 && t0 + t < n; ++t) row[t] = src[t];
      }
    }
    __syncthreads();  // the stage, the tiles and the per-edge values turn over
  }
  cp_async_wait<0>();
}

// shared memory of one CTA: the f32 or the bf16 form
inline long long smem_bytes(int f, int hid, bool bf16) {
  return bf16 ? edge_fwd_layout(f).bytes
              : smem_floats(f, hid) * (long long)sizeof(float);
}

// f32: egnn_edge_fwd_kernel, bf16: egnn_edge_fwd_mma_kernel, over B*chunks
// CTAs
template <typename T, int H>
cudaError_t launch(const void* hsx, const void* hdx, const void* ef,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, void* out, int B, int E, int F,
                   int chunks, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t bytes = (size_t)smem_bytes(F, H, kBf16);
  // edges per chunk: a whole number of tiles
  const int per = (E + chunks - 1) / chunks;
  const int chunk_edges = (per + kTile - 1) / kTile * kTile;
  cudaError_t err;
  if constexpr (kBf16) {
    auto kernel = egnn_edge_fwd_mma_kernel<H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<B * chunks, kMmaThreads, bytes, stream>>>(
        static_cast<const bf*>(hsx), static_cast<const bf*>(hdx),
        static_cast<const bf*>(ef), w1ab, w2, wc1, small,
        static_cast<bf*>(out), E, F, chunks, chunk_edges);
  } else {
    auto kernel = egnn_edge_fwd_kernel<T, H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<B * chunks, kThreads, bytes, stream>>>(
        static_cast<const T*>(hsx), static_cast<const T*>(hdx),
        static_cast<const T*>(ef), w1ab, w2, wc1, small, static_cast<T*>(out),
        E, F, chunks, chunk_edges);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for node features F, hidden width H and the
// compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_edge_fwd_smem_bytes(int F, int H, int bf16) {
  return smem_bytes(F, H, bf16 != 0);
}

// CTAs that fit on one SM at once for node features F, hidden width H and
// the compute dtype (the occupancy calculator's count), or -1 on a CUDA
// error.
int egnn_edge_fwd_ctas_per_sm(int F, int H, int bf16) {
  const int bytes = (int)smem_bytes(F, H, bf16 != 0);
  int n = 0;
  cudaError_t err;
  if (bf16) {
    auto kernel = egnn_edge_fwd_mma_kernel<kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kMmaThreads, bytes);
    }
  } else {
    auto kernel = egnn_edge_fwd_kernel<float, kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                          kThreads, bytes);
    }
  }
  return err == cudaSuccess ? n : -1;
}

// One launch: B*chunks CTAs (256 threads in f32, 128 in bf16) on `stream`.
// hsx/hdx [B,F+3,E], ef [B,1,E] in the compute dtype (bf16 != 0: bfloat16,
// else float32); w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32. Writes out
// [B,H+3,E] in the compute dtype. Returns the cudaError_t of the launch (0
// on success).
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
