// The tensor-core form of the EGNN edge half-layer forward for Hopper
// (sm_90a), in bf16: B1's (csrc/egnn_mega_fwd.cu) and, with another tile
// policy, B4's (csrc/egnn_mega_paired_fwd.cu). What it computes, what bounds
// it and what the design does about it: csrc/egnn_mega_fwd.cu.
//
//   egnn_mega_proj_kernel      pa | pb = h @ W1ab for 32 nodes a CTA, with
//                              node_projections' f32 arithmetic and order,
//                              rounded to bf16 into the proj scratch;
//   egnn_mega_fwd_mma_kernel   the edge chain over one CTA per (graph,
//                              chunk), two warpgroups each on its own 64-slot
//                              tiles; Tiles says which edge each slot of a
//                              tile computes and forms the tile's geometry
//                              (EdgeTiles: slot t is edge i0 + t; B4's
//                              ArcTiles: 32 arcs and their 32 mirrors);
//   launch_mma                 the projections, the edge kernel and, with
//                              more than one chunk, reduce_node_chunks.

#pragma once

#include "egnn_hopper.cuh"

namespace egnn {

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

// B1's tiles: slot t of the tile from edge i0 is edge i0 + t, as the edge
// list holds it (items: the E edges)
struct EdgeTiles {
  static constexpr int kPerTile = kTile;  // items a tile advances
  __host__ __device__ static int items(int E) { return E; }
  // this thread's slot (wtid < kTile) of the tile from item i0: its rows
  // (s, d) and whether it is computed (ok), items from i_end on not
  __device__ static void read(const int* srcb, const int* dstb,
                              const uint8_t* maskb, int N, int i0, int i_end,
                              int wtid, int& s, int& d, int& ok) {
    const int e = i0 + wtid;
    ok = 0;
    if (wtid < kTile && e < i_end) {
      s = srcb[e];
      d = dstb[e];
      ok = maskb[e] != 0 && s >= 0 && s < N && d >= 0 && d < N;
    }
  }
  __device__ static void geometry(const int* srcb, const int* dstb,
                                  const uint8_t* maskb, const bf* efb,
                                  const bf* xb, int N, int E, int i0,
                                  bf* xdb, TileGeometry g, int wtid) {
    geometry_tile<bf, bf>(srcb, dstb, maskb, efb, xb, N, E, i0, xdb, g, wtid);
  }
};

// Per (graph, chunk): CTA b*chunks + c takes items c*chunk_items .. of
// graph b (B1: edges; B4: arcs, each with its mirror) and sums them into
// its node block: the output (chunks 1) or nodes [B*chunks][N][H+3] for
// reduce_node_chunks. proj holds pa | pb [B][N][2H] in bf16
// (egnn_mega_proj_kernel). Tiles forms a tile's 64 slots (EdgeTiles, B4's
// ArcTiles). The chunk's tiles alternate between the two warpgroups; each
// loads its next tile's rows and geometry while the other computes.
template <int H, class Tiles>
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
                             int chunk_items) {
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
  const int i_begin = (blockIdx.x % chunks) * chunk_items;
  const int i_end = min(Tiles::items(E), i_begin + chunk_items);
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
  const int ntiles = i_end > i_begin ? (i_end - i_begin + Tiles::kPerTile - 1) /
                                           Tiles::kPerTile
                                     : 0;
  int n_ok = 0, n_s = 0, n_d = 0;  // this thread's slot of the coming tile
  auto read_edge = [&](int it) {
    Tiles::read(srcb, dstb, maskb, N, i_begin + it * Tiles::kPerTile, i_end,
                wtid, n_s, n_d, n_ok);
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
    Tiles::geometry(srcb, dstb, maskb, efb, xb, N, E,
                    i_begin + it * Tiles::kPerTile, xdb, g, wtid);
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

// shared memory of one CTA of the edge kernel
inline long long mma_smem_bytes(int n) { return fwd_layout(n).bytes; }

// CTAs of the edge kernel that fit on one SM at once for N nodes, or -1 on
// a CUDA error
template <class Tiles>
int mma_ctas_per_sm(int n) {
  const int bytes = (int)mma_smem_bytes(n);
  auto kernel = egnn_mega_fwd_mma_kernel<kHidden, Tiles>;
  int ctas = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kFwdThreads, bytes);
  }
  return err == cudaSuccess ? ctas : -1;
}

// The bf16 forward: the projections, the edge kernel over B*chunks CTAs
// and, with chunks > 1, the chunks' node blocks (node_partial
// [B*chunks][N][H+3] f32 scratch) summed into out. proj [B][N][2H] f32
// scratch holds pa | pb in bf16.
template <class Tiles, int H>
cudaError_t launch_mma(const int* src, const int* dst, const uint8_t* mask,
                       const bf* ef, const bf* h, const bf* x,
                       const float* w1ab, const float* w2, const float* wc1,
                       const float* small, float* out, float* proj,
                       float* node_partial, bf* a1, bf* xd, int B, int N,
                       int E, int F, int chunks, cudaStream_t stream) {
  bf* pj = reinterpret_cast<bf*>(proj);
  auto pkernel = egnn_mega_proj_kernel<bf, H>;
  const size_t pbytes = (size_t)proj_smem_bytes(F);
  cudaError_t err = cudaFuncSetAttribute(
      pkernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pbytes);
  if (err != cudaSuccess) return err;
  const dim3 pgrid((N + kProjNodes - 1) / kProjNodes, B);
  pkernel<<<pgrid, kThreads, pbytes, stream>>>(h, w1ab, pj, N, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = egnn_mega_fwd_mma_kernel<H, Tiles>;
  const size_t bytes = (size_t)mma_smem_bytes(N);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  // items per chunk: a whole number of tiles
  const int per = (Tiles::items(E) + chunks - 1) / chunks;
  const int chunk_items =
      (per + Tiles::kPerTile - 1) / Tiles::kPerTile * Tiles::kPerTile;
  float* nodes = chunks > 1 ? node_partial : out;
  kernel<<<B * chunks, kFwdThreads, bytes, stream>>>(
      src, dst, mask, ef, x, w2, wc1, small, pj, nodes, a1, xd, N, E, chunks,
      chunk_items);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const int width = N * (H + 3);
  const dim3 grid((width + kReduceThreads - 1) / kReduceThreads, B);
  reduce_node_chunks<<<grid, kReduceThreads, 0, stream>>>(
      node_partial, chunks, width, out);
  return cudaGetLastError();
}

}  // namespace egnn
