// EGNN edge half-layer forward for Hopper (sm_90a), with the residuals the
// backward (csrc/egnn_tail_bwd.cu) reads.
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
// For training it also stores, per edge, a1 (after the f32 sum, before the
// silu, rounded to the compute dtype) into a1_out [B,H,E] and xd into
// xd_out [B,3,E], zeros for a skipped edge; null pointers skip both stores
// (inference).
//
// What bounds it on the H100: bytes, and at small B the number of SMs a
// graph reaches. At B=128, N=288, E=2560, F=H=64 in bf16 a launch with the
// residuals moves 62.4 MB (the a1 residual, 42 MB, most of it): 0.019 ms at
// 3.35 TB/s; without them 18.5 MB, 0.006 ms. Its arithmetic, the two H x H
// products per edge and the node projections (5.4 GFLOP), is 0.005 ms at
// the tensor cores' bf16 peak but 0.08 ms at the CUDA cores' f32 rate. One
// CTA per graph, as the f32 form runs, leaves a B=1 request on one SM.
//
// What the design does about it (bf16):
//   - the node projections pa | pb = h @ W1ab run first, in their own
//     kernel (egnn_mega_proj_kernel: a CTA per 32 nodes of a graph), with
//     node_projections' f32 arithmetic and order, so B4's residuals stay B1's
//     bit for bit; rounded to bf16 (exact: they are rounded there) into the
//     proj scratch;
//   - the edges run one CTA per (graph, edge chunk), as the TPU kernel's
//     grid runs (graph, edge tile) and revisits the output block: a B=1
//     request reaches 20 CTAs at E=2560 (ops/mega.py fwd_chunks). Each
//     chunk sums its edges into an f32 node block [N][H+3] of its own in
//     shared memory (shared-memory atomics); with one chunk the block is
//     the output, with more a second kernel sums the chunks' blocks in
//     chunk order (reduce_node_chunks);
//   - the chunk's 64-edge tiles alternate between two warpgroups (256
//     threads a CTA, one CTA an SM); in each, warp w owns edges
//     16w..16w+15 of a tile. A warpgroup's next tile loads while the other
//     computes: its edge indices into registers, the rows pa[src] and
//     pb[dst] by cp.async, its geometry. a1 and silu(a1) are formed in
//     registers in the A-operand layout of the tensor cores, and both H x H
//     products are mma.sync m16n8k16 (bf16 operands, W2/Wc1 by ldmatrix from
//     shared memory, each product added in f32: csrc/egnn_hopper.cuh). m goes
//     from the accumulator of the first product to the A operand of the
//     second in registers; no edge tile passes through shared memory, and a
//     warp waits on no other warp within a tile. The sigmoids run on the
//     special-function unit (sigmoid_fast): unlike the backward's per-row
//     bounds, B1's per-column bounds over all graphs and nodes do not see a
//     rounding that falls the other way now and then, so there is no
//     near-tie recompute (scripts/torch_kernel_ties.py --kernel mega_fwd
//     reads how near the bounds it comes on seeded inputs);
//   - its shared memory (the node block, W2/Wc1 bf16, two stages, one
//     tile's geometry) stays within the f32 form's, which ops/mega.py's
//     admission rule (fwd_smem_bytes) reckons with.
// The f32 form keeps the CUDA cores (one CTA of 256 threads per graph, the
// products register-tiled FMA loops over f32 tiles), so its f32 bounds
// hold; TF32 would break them.
//
// Rounding points under bf16 are the TPU kernel's (pallas_mega.py:247-280,
// pallas_edge.py:104-139): weights rounded to bf16; pa/pb rounded, summed in
// f32; xd and radial rounded, radial > 0 guarded; silu(a1), m, the coord
// MLP's hidden layer and cw rounded; sigmoid/silu and all sums in f32. W2,
// Wc1 and silu(a1) reach only the tensor cores, as bf16 operands.
//
// The device code of the f32 form and of the projections and geometry
// (stage_edge_weights, node_projections, geometry_tile, fwd_tile_chain) is
// in csrc/egnn_common.cuh, shared with the variants B4 and B6.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_hopper.cuh"

namespace {

using namespace egnn;

// The f32 form: one CTA (256 threads) per graph, the products on the CUDA
// cores (egnn_common.cuh's phases, shared with B4 and B6).
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
                         float* __restrict__ out, float* proj,
                         T* __restrict__ a1_out, T* __restrict__ xd_out,
                         int N, int E, int F) {
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

  // ---- phase 2: 64-edge tiles ----
  for (int e0 = 0; e0 < E; e0 += kTile) {
    geometry_tile<T, T>(srcb, dstb, maskb, efb, xb, N, E, e0, xdb, g, tid);
    __syncthreads();
    fwd_tile_chain<T, H>(acc, w2s, wc1s, sms, bufA, bufB, g, pab, a1b, E,
                         tid);
  }

  float* ob = out + (size_t)b * N * C;
  for (int i = tid; i < N * C; i += kThreads) ob[i] = acc[i];
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

constexpr int kProjNodes = 32;  // nodes per CTA of the projections

// shared memory of the projections' CTA: W1ab f32 [2F][H] | the nodes' h
// f32 [kProjNodes][F] | pa | pb f32 [kProjNodes][2H]
inline long long proj_smem_bytes(int f) {
  return 4LL * (2 * f * kHidden + kProjNodes * f + kProjNodes * 2 * kHidden);
}

// pa | pb for nodes n0 .. n0+kProjNodes-1 of graph blockIdx.y, rounded to
// the compute dtype by node_projections, into proj [B][N][2H] in that dtype
// (h is read into shared memory first: the sums' f32 arithmetic and order
// are node_projections' either way)
template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
    egnn_mega_proj_kernel(const T* __restrict__ h,
                          const float* __restrict__ w1ab, T* __restrict__ proj,
                          int N, int F) {
  extern __shared__ float smem_proj[];
  float* w1s = smem_proj;                // [2F][H]
  float* hs = w1s + 2 * F * H;           // [kProjNodes][F]
  float* pab = hs + kProjNodes * F;      // [kProjNodes][2H]
  const int b = blockIdx.y, n0 = blockIdx.x * kProjNodes;
  const int nn = min(kProjNodes, N - n0);
  const int tid = threadIdx.x;
  const T* hb = h + ((size_t)b * N + n0) * F;
  for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<T>(w1ab[i]);
  for (int i = tid; i < nn * F; i += kThreads) hs[i] = to_f(hb[i]);
  __syncthreads();
  node_projections<T, H>(hs, static_cast<const T*>(nullptr), F, w1s, nn, F,
                         pab, tid);
  __syncthreads();
  T* pb = proj + ((size_t)b * N + n0) * 2 * H;
  for (int i = tid; i < nn * 2 * H; i += kThreads) pb[i] = from_f<T>(pab[i]);
}

constexpr int kFwdThreads = 256;  // two warpgroups, each its own tiles

using bf2 = __nv_bfloat162;

// byte offsets into a CTA's shared memory: the node block f32 [N][H+3], W2
// and Wc1 bf16 [H][kLdb], small^T [6][H] f32, and per warpgroup a stage
// (the rows pa[src] then pb[dst] of a tile's edges, bf16 [kTile][kLdb]) and
// its tile's geometry
struct FwdLayout {
  int w2, wc1, sms, stage, geo, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int n) {
  FwdLayout l;
  l.w2 = (4 * n * (kHidden + 3) + 15) / 16 * 16;  // 16-byte aligned rows
  l.wc1 = l.w2 + kHidden * kLdb * 2;
  l.sms = l.wc1 + kHidden * kLdb * 2;
  l.stage = l.sms + 6 * kHidden * 4;               // + wg * 2 * kTileBytes
  l.geo = l.stage + 2 * 2 * kTileBytes;            // + wg * geometry
  l.bytes = l.geo + 2 * geometry_floats() * 4;
  return l;
}

// two bf16 values as the 32-bit register of an mma operand
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// acc[nt][.] = rows m0..m0+15 of A . W over K = 64, A in registers as the
// A operands of the four 16-deep steps, W stored [k][n]
__device__ __forceinline__ void reg_product(const unsigned (&a)[4][4],
                                            const bf* w, int lane,
                                            float (&acc)[8][4]) {
  zero(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bfr[4];
      load_b<true>(bfr, w, np * 16, kk * 16, lane);
      mma_add(acc[2 * np], a[kk], bfr[0], bfr[1]);
      mma_add(acc[2 * np + 1], a[kk], bfr[2], bfr[3]);
    }
}

// the 128 threads of warpgroup wg wait for one another (barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kMmaThreads)
               : "memory");
}

// Per (graph, edge chunk): CTA b*chunks + c takes edges c*chunk_edges ..
// of graph b and sums them into its node block: the output (chunks 1) or
// nodes [B*chunks][N][H+3] for reduce_node_chunks. proj holds pa | pb
// [B][N][2H] in bf16 (egnn_mega_proj_kernel). The chunk's tiles alternate
// between the two warpgroups; each loads its next tile's rows and geometry
// while the other computes.
template <int H>
__global__ void __launch_bounds__(kFwdThreads, 1)
    egnn_mega_fwd_mma_kernel(const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const uint8_t* __restrict__ mask,
                             const bf* __restrict__ ef,
                             const bf* __restrict__ x,
                             const float* __restrict__ w2,
                             const float* __restrict__ wc1,
                             const float* __restrict__ small,
                             const bf* __restrict__ proj,
                             float* __restrict__ nodes, bf* __restrict__ a1_out,
                             bf* __restrict__ xd_out, int N, int E, int chunks,
                             int chunk_edges) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  constexpr int C = H + 3;
  const FwdLayout L = fwd_layout(N);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  float* acc = reinterpret_cast<float*>(sm);                // [N][C]
  bf* w2s = reinterpret_cast<bf*>(sm + L.w2);               // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + L.wc1);             // [k][n]
  float* sms = reinterpret_cast<float*>(sm + L.sms);

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int wg = tid / kMmaThreads, wtid = tid % kMmaThreads;
  const int lane = tid & 31;
  const int fr = lane >> 2, fq = lane & 3;  // fragment row, column pair
  const int m0 = (wtid >> 5) * 16;
  // this warpgroup's stage: pa[src] rows, then pb[dst] rows; its geometry
  unsigned char* st = sm + L.stage + wg * 2 * kTileBytes;
  const bf* pas = reinterpret_cast<const bf*>(st);               // [t][j]
  const bf* pbs = reinterpret_cast<const bf*>(st + kTileBytes);  // [t][j]
  const TileGeometry g = carve_geometry(
      reinterpret_cast<float*>(sm + L.geo) + wg * geometry_floats());
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const bf* efb = ef + (size_t)b * E;
  const bf* xb = x + (size_t)b * N * 3;
  const bf* pgb = proj + (size_t)b * N * 2 * H;  // [N][2H]: pa | pb
  bf* a1b = a1_out == nullptr ? nullptr : a1_out + (size_t)b * H * E;
  bf* xdb = xd_out == nullptr ? nullptr : xd_out + (size_t)b * 3 * E;

  // ---- the node block, and the weights rounded to bf16 by their store ----
  for (int i = tid; i < N * C; i += kFwdThreads) acc[i] = 0.0f;
  for (int i = tid; i < H * H; i += kFwdThreads) {
    const int k = i / H, j = i % H;
    w2s[k * kLdb + j] = __float2bfloat16(w2[i]);
    wc1s[k * kLdb + j] = __float2bfloat16(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kFwdThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }

  // ---- each warpgroup's tiles: wg, wg+2, ..; the next one's indices are
  // read into registers while this one computes, its rows then arrive by
  // cp.async and its geometry is formed while the other warpgroup
  // computes ----
  const int ntiles =
      e_end > e_begin ? (e_end - e_begin + kTile - 1) / kTile : 0;
  int n_ok = 0, n_s = 0, n_d = 0;  // this thread's edge of the coming tile
  auto read_edge = [&](int it) {
    const int e = e_begin + it * kTile + wtid;
    n_ok = 0;
    if (wtid < kTile && e < e_end) {
      n_s = srcb[e];
      n_d = dstb[e];
      n_ok = maskb[e] != 0 && n_s >= 0 && n_s < N && n_d >= 0 && n_d < N;
    }
  };
  auto load_tile = [&](int it) {
    if (wtid < kTile && n_ok) {
      const bf* pa = pgb + (size_t)n_s * 2 * H;
      const bf* pb = pgb + (size_t)n_d * 2 * H + H;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        cp_async16(st + wtid * kLdb * 2 + c * 16, pa + c * 8);
        cp_async16(st + kTileBytes + wtid * kLdb * 2 + c * 16, pb + c * 8);
      }
    }
    cp_async_commit();
    geometry_tile<bf, bf>(srcb, dstb, maskb, efb, xb, N, E,
                          e_begin + it * kTile, xdb, g, wtid);
  };
  if (wg < ntiles) {
    read_edge(wg);
    load_tile(wg);
  }
  __syncthreads();  // the node block's zeros and the weights

  for (int it = wg; it < ntiles; it += 2) {
    cp_async_wait<0>();
    wg_sync(wg);  // this tile's rows and geometry
    if (it + 2 < ntiles) read_edge(it + 2);

    // ---- a1 = pa[src] + pb[dst] + w1r*radial + w1e*ef + b1 (the a1
    // residual) -> silu(a1) as the A operand of p2 ----
    unsigned af[4][4];
    {
      // this thread's two edges: rows fr and fr + 8 of the warp's 16
      float rad[2], efv[2];
      int ok[2], col[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + fr + 8 * h;
        rad[h] = g.rad[t];
        efv[h] = g.ef[t];
        ok[h] = g.ok[t];
        col[h] = a1b != nullptr ? g.col[t] : -1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1, t = m0 + fr + 8 * h;
          const int j = kk * 16 + 8 * (q >> 1) + 2 * fq;
          const float2 wr =
              *reinterpret_cast<const float2*>(sms + kW1R * H + j);
          const float2 we =
              *reinterpret_cast<const float2*>(sms + kW1E * H + j);
          const float2 wb = *reinterpret_cast<const float2*>(sms + kB1 * H + j);
          float a1[2] = {0.0f, 0.0f}, v[2] = {0.0f, 0.0f};
          if (ok[h]) {
            const bf2 pa = *reinterpret_cast<const bf2*>(pas + t * kLdb + j);
            const bf2 pb = *reinterpret_cast<const bf2*>(pbs + t * kLdb + j);
            a1[0] = __low2float(pa) + __low2float(pb);
            a1[1] = __high2float(pa) + __high2float(pb);
            a1[0] = a1[0] + wr.x * rad[h];
            a1[1] = a1[1] + wr.y * rad[h];
            a1[0] = a1[0] + we.x * efv[h];
            a1[1] = a1[1] + we.y * efv[h];
            a1[0] = a1[0] + wb.x;
            a1[1] = a1[1] + wb.y;
#pragma unroll
            for (int c = 0; c < 2; ++c) v[c] = a1[c] * sigmoid_fast(a1[c]);
          }
          if (col[h] >= 0) {
            a1b[(size_t)j * E + col[h]] = __float2bfloat16(a1[0]);
            a1b[(size_t)(j + 1) * E + col[h]] = __float2bfloat16(a1[1]);
          }
          af[kk][q] = pack2(v[0], v[1]);
        }
    }

    // ---- m = silu(silu(a1) @ W2 + b2) -> the node block; m as the A
    // operand of p3 ----
    {
      float p2[8][4];
      reg_product(af, w2s, lane, p2);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = m0 + fr + 8 * (i >> 1), j = nt * 8 + 2 * fq + (i & 1);
          const float p = p2[nt][i] + sms[kB2 * H + j];
          const float mv = rnd<bf>(p * sigmoid_fast(p));
          if (g.ok[t]) atomicAdd(acc + g.dst[t] * C + j, mv);
          p2[nt][i] = mv;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        af[kk][0] = pack2(p2[2 * kk][0], p2[2 * kk][1]);
        af[kk][1] = pack2(p2[2 * kk][2], p2[2 * kk][3]);
        af[kk][2] = pack2(p2[2 * kk + 1][0], p2[2 * kk + 1][1]);
        af[kk][3] = pack2(p2[2 * kk + 1][2], p2[2 * kk + 1][3]);
      }
    }

    // ---- cw = silu(m @ Wc1 + bc1) . wc2 -> node block += cw * x_hat ----
    {
      float p3[8][4];
      reg_product(af, wc1s, lane, p3);
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          const float p = p3[nt][i] + sms[kBC1 * H + j];
          const float c1 = rnd<bf>(p * sigmoid_fast(p));
          part[i >> 1] += c1 * sms[kWC2 * H + j];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float cw = sum4(part[h]);
        const int t = m0 + fr + 8 * h;
        if (fq == 0 && g.ok[t]) {
          const float cwb = rnd<bf>(cw);
          float* arow = acc + g.dst[t] * C + H;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            atomicAdd(arow + k, rnd<bf>(cwb * g.xh[t * 3 + k]));
          }
        }
      }
    }
    wg_sync(wg);  // the stage and the geometry turn over
    if (it + 2 < ntiles) load_tile(it + 2);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* nb = nodes + (size_t)blockIdx.x * N * C;
  for (int i = tid; i < N * C; i += kFwdThreads) nb[i] = acc[i];
}

// shared memory of one CTA of the edge kernel: the f32 or the bf16 form
inline long long smem_bytes(int n, int hid, bool bf16) {
  return bf16 ? fwd_layout(n).bytes
              : fwd_smem_floats(n, hid) * (long long)sizeof(float);
}

// f32: the CUDA-core kernel over B CTAs. bf16: the projections, the edge
// kernel over B*chunks CTAs and, with chunks > 1, the chunks' node blocks
// (node_partial [B*chunks][N][H+3] f32 scratch) summed into out.
template <typename T, int H>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* ef, const void* h, const void* x,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, float* out, float* proj,
                   float* node_partial, void* a1, void* xd, int B, int N,
                   int E, int F, int chunks, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t bytes = (size_t)smem_bytes(N, H, kBf16);
  cudaError_t err;
  if constexpr (!kBf16) {
    auto kernel = egnn_mega_fwd_kernel<T, H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<B, kThreads, bytes, stream>>>(
        src, dst, mask, static_cast<const T*>(ef), static_cast<const T*>(h),
        static_cast<const T*>(x), w1ab, w2, wc1, small, out, proj,
        static_cast<T*>(a1), static_cast<T*>(xd), N, E, F);
    return cudaGetLastError();
  } else {
    bf* pj = reinterpret_cast<bf*>(proj);
    auto pkernel = egnn_mega_proj_kernel<T, H>;
    const size_t pbytes = (size_t)proj_smem_bytes(F);
    err = cudaFuncSetAttribute(
        pkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pbytes);
    if (err != cudaSuccess) return err;
    const dim3 pgrid((N + kProjNodes - 1) / kProjNodes, B);
    pkernel<<<pgrid, kThreads, pbytes, stream>>>(static_cast<const T*>(h),
                                                 w1ab, pj, N, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    auto kernel = egnn_mega_fwd_mma_kernel<H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    // edges per chunk: a whole number of tiles
    const int per = (E + chunks - 1) / chunks;
    const int chunk_edges = (per + kTile - 1) / kTile * kTile;
    float* nodes = chunks > 1 ? node_partial : out;
    kernel<<<B * chunks, kFwdThreads, bytes, stream>>>(
        src, dst, mask, static_cast<const bf*>(ef), static_cast<const bf*>(x),
        w2, wc1, small, pj, nodes, static_cast<bf*>(a1), static_cast<bf*>(xd),
        N, E, chunks, chunk_edges);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    const int width = N * (H + 3);
    const dim3 grid((width + kReduceThreads - 1) / kReduceThreads, B);
    reduce_node_chunks<<<grid, kReduceThreads, 0, stream>>>(
        node_partial, chunks, width, out);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA of the edge kernel needs for N nodes, hidden width
// H and the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_mega_fwd_smem_bytes(int N, int H, int bf16) {
  return smem_bytes(N, H, bf16 != 0);
}

// CTAs of the edge kernel that fit on one SM at once for N nodes, hidden
// width H and the compute dtype (the occupancy calculator's count), or -1
// on a CUDA error.
int egnn_mega_fwd_ctas_per_sm(int N, int H, int bf16) {
  const int bytes = (int)smem_bytes(N, H, bf16 != 0);
  int n = 0;
  cudaError_t err;
  if (bf16) {
    auto kernel = egnn_mega_fwd_mma_kernel<egnn::kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                          kFwdThreads, bytes);
    }
  } else {
    auto kernel = egnn_mega_fwd_kernel<float, egnn::kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, egnn::kThreads, bytes);
    }
  }
  return err == cudaSuccess ? n : -1;
}

// One forward on `stream`. src/dst [B,E] int32, mask [B,E] bool, ef
// [B,E,1], h [B,N,F], x [B,N,3] in the compute dtype (bf16 != 0: bfloat16,
// else float32); w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32; out [B,N,H+3]
// f32; proj [B,N,2H] f32 scratch (bf16 keeps pa | pb there in bf16); a1
// [B,H,E] and xd [B,3,E] in the compute dtype, or both null (no
// residuals). bf16 runs chunks CTAs per graph (f32: one); with chunks > 1
// node_partial [B*chunks,N,H+3] f32 is scratch, else it may be null.
// Returns the cudaError_t of the launches (0 on success).
int egnn_mega_fwd(const void* src, const void* dst, const void* mask,
                  const void* ef, const void* h, const void* x,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, void* out, void* proj,
                  void* node_partial, void* a1, void* xd, int B, int N, int E,
                  int F, int H, int chunks, int bf16, void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > egnn::kTile ||
      H != egnn::kHidden || (a1 == nullptr) != (xd == nullptr) ||
      chunks < 1 || (bf16 && chunks > 1 && node_partial == nullptr)) {
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
  float* pn = static_cast<float*>(node_partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2,
                                                pwc1, psm, po, pp, pn, a1, xd,
                                                B, N, E, F, chunks, st);
  }
  return launch<float, egnn::kHidden>(s, d, m, ef, h, x, pw1, pw2, pwc1, psm,
                                      po, pp, pn, a1, xd, B, N, E, F, 1, st);
}

}  // extern "C"
