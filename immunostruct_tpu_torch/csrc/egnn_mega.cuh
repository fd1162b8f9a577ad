// The tensor-core form of the EGNN edge half-layer forward for Hopper
// (sm_90a), in bf16: B1's (csrc/egnn_mega_fwd.cu), with another tile policy
// B4's (csrc/egnn_mega_paired_fwd.cu), and layer by layer B6's
// (csrc/egnn_stack_fwd.cu). What it computes, what bounds it and what the
// design does about it: csrc/egnn_mega_fwd.cu.
//
//   proj_block                 pa | pb = h @ W1ab for up to 32 nodes, each
//                              output an f32 sum over the features in order
//                              from +0 (node_projections' arithmetic, in
//                              register tiles), rounded to bf16;
//   egnn_mega_proj_kernel      proj_block for 32 nodes a CTA into the proj
//                              scratch;
//   mma_edge_chunk             the edge chain over a chunk of one graph's
//                              items, two warpgroups each on its own 64-slot
//                              tiles; Tiles says which edge each slot of a
//                              tile computes and forms the tile's geometry
//                              (EdgeTiles: slot t is edge i0 + t; B4's
//                              ArcTiles: 32 arcs and their 32 mirrors). a1
//                              is summed op by op, and an a1s, m or c1 near
//                              a bf16 tie is recomputed in the plain
//                              version's order (near_tie). The sums at dst
//                              take no atomics: each tile's m and
//                              coordinate messages wait in shared memory, and
//                              one thread per column adds them into the node
//                              block slot by slot, the tiles in order (the
//                              warpgroups pass the turn: sum_tile_ordered,
//                              turn_wait, turn_pass), so each (n, c) is an f32
//                              sum from +0 in one fixed order: the same bits
//                              every run;
//   egnn_mega_fwd_mma_kernel   mma_edge_chunk over one CTA per (graph, chunk);
//   launch_mma                 the projections, the edge kernel and, with
//                              more than one chunk, reduce_node_chunks.

#pragma once

#include "egnn_hopper.cuh"

// EDGE_TIE_PROBE(kind, ties): mma_edge_chunk's near-tie recomputes, kind 0
// an a1s (ties 1, in the lane that recomputes it), 1 an m and 2 a c1 (ties
// the lane's bit mask for the tile, every lane of the warp at once). Nothing
// here; scripts/torch_kernel_ties.py --kernel ties builds a probe that
// counts them.
#ifndef EDGE_TIE_PROBE
#define EDGE_TIE_PROBE(kind, ties)
#endif

namespace egnn {

constexpr int kProjNodes = 32;  // nodes per CTA of the projections

// shared memory of the projections' CTA: W1ab f32 [2F][H] | the nodes' h
// f32 [kProjNodes][F]
inline long long proj_smem_bytes(int f) {
  return 4LL * (2 * f * kHidden + kProjNodes * f);
}

// pa | pb = h @ W1ab for nodes 0 .. nn-1 (nn <= kProjNodes) of the rows
// hrows (stride hld, f32 or bf16, shared or device memory), rounded to bf16
// into out [nn][2H] (device memory). Each output is an f32 sum over the F
// features in f order from +0, one fma a feature: node_projections'
// arithmetic, so B1's projections, B4's and B6's are the same bits. w1s
// [2F][H] f32 holds the rounded weights in shared memory. Thread (ng, cq) of
// the 256 takes nodes 4ng .. 4ng+3 and columns 4cq .. 4cq+3 (one float4 of
// weights and four h values a feature).
template <typename HT>
__device__ __forceinline__ void proj_block(const HT* hrows, int hld,
                                           const float* w1s, int F, int nn,
                                           bf* out, int tid) {
  constexpr int H = kHidden;
  const int cq = tid % 32, ng = tid / 32;
  const int j = cq * 4;
  const float* wcol = w1s + (j / H) * F * H + (j % H);
  const HT* hr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) hr[i] = hrows + min(ng * 4 + i, nn - 1) * hld;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
  for (int f = 0; f < F; ++f) {
    const float4 w = *reinterpret_cast<const float4*>(wcol + f * H);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hv = to_f(hr[i][f]);
      acc[i][0] = fmaf(hv, w.x, acc[i][0]);
      acc[i][1] = fmaf(hv, w.y, acc[i][1]);
      acc[i][2] = fmaf(hv, w.z, acc[i][2]);
      acc[i][3] = fmaf(hv, w.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int node = ng * 4 + i;
    if (node < nn) {
      __nv_bfloat162* o =
          reinterpret_cast<__nv_bfloat162*>(out + node * 2 * H + j);
      o[0] = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      o[1] = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
    }
  }
}

// pa | pb for nodes n0 .. n0+kProjNodes-1 of graph blockIdx.y into proj
// [B][N][2H] in bf16 (h is read into shared memory first)
__global__ void __launch_bounds__(kThreads)
    egnn_mega_proj_kernel(const bf* __restrict__ h,
                          const float* __restrict__ w1ab, bf* __restrict__ proj,
                          int N, int F) {
  constexpr int H = kHidden;
  extern __shared__ float smem_proj[];
  float* w1s = smem_proj;                // [2F][H]
  float* hs = w1s + 2 * F * H;           // [kProjNodes][F]
  const int b = blockIdx.y, n0 = blockIdx.x * kProjNodes;
  const int nn = min(kProjNodes, N - n0);
  const int tid = threadIdx.x;
  const bf* hb = h + ((size_t)b * N + n0) * F;
  for (int i = tid; i < 2 * F * H; i += kThreads) w1s[i] = rnd<bf>(w1ab[i]);
  for (int i = tid; i < nn * F; i += kThreads) hs[i] = to_f(hb[i]);
  __syncthreads();
  proj_block(hs, F, w1s, F, nn, proj + ((size_t)b * N + n0) * 2 * H, tid);
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

// a1 = pa + pb + wr*rad + we*ef + b1 in the plain version's order, each
// product and sum rounded on its own (no fused multiply-add, which nvcc
// would otherwise make of a + w*r)
__device__ __forceinline__ float a1_rn(float pa, float pb, float wr, float rad,
                                       float we, float ef, float b1) {
  float a = __fadd_rn(pa, pb);
  a = __fadd_rn(a, __fmul_rn(wr, rad));
  a = __fadd_rn(a, __fmul_rn(we, ef));
  return __fadd_rn(a, b1);
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

// W2 and Wc1 rounded to bf16 by their store ([k][kLdb]) and small^T, by
// kFwdThreads threads; the caller synchronises
__device__ __forceinline__ void stage_mma_weights(const float* w2,
                                                  const float* wc1,
                                                  const float* small, bf* w2s,
                                                  bf* wc1s, float* sms,
                                                  int tid) {
  constexpr int H = kHidden;
  for (int i = tid; i < H * H; i += kFwdThreads) {
    const int k = i / H, j = i % H;
    w2s[k * kLdb + j] = __float2bfloat16(w2[i]);
    wc1s[k * kLdb + j] = __float2bfloat16(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kFwdThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
}

// ---- the sums at dst, in a fixed order ----

constexpr int kMRow = 72;  // floats of a slot's f32 m row in the stage (288 B)

// Slot t's f32 m row in its warpgroup's stage st: the 16 slots of warp
// t / 16 lie over that warp's own pa rows (slots 0-7 of the warp) and pb
// rows (8-15), so a warp overwrites only rows it has read itself.
__device__ __forceinline__ float* m_row(unsigned char* st, int t) {
  const int w = t >> 4, r = t & 15;
  return reinterpret_cast<float*>(st + (r >> 3) * kTileBytes +
                                  w * 16 * kLdb * 2 + (r & 7) * kMRow * 4);
}

// node block acc [N][H+3] += the tile's messages: slot t's m (m_row) in
// columns 0..H-1 and its coordinate message (g.xh[3t..3t+2]) in H..H+2, for
// the computed slots (g.ok) at their row g.dst. One thread a column (wtid <
// H+3) adds the slots in slot order; the caller orders the tiles, so each
// (n, c) is an f32 sum from +0 in one fixed order.
__device__ __forceinline__ void sum_tile_ordered(float* acc,
                                                 unsigned char* st,
                                                 TileGeometry g, int wtid) {
  constexpr int C = kHidden + 3;
  if (wtid >= C) return;
  const bool is_m = wtid < kHidden;
#pragma unroll 1
  for (int t0 = 0; t0 < kTile; t0 += 8) {
    int row[8];
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int t = t0 + u;
      row[u] = g.ok[t] ? g.dst[t] : -1;
      v[u] = is_m ? m_row(st, t)[wtid] : g.xh[t * 3 + wtid - kHidden];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (row[u] >= 0) acc[row[u] * C + wtid] += v[u];
    }
  }
}

// The two warpgroups of a CTA take a chunk's tiles in turn (wg, wg+2, ..)
// and sum them in tile order: warpgroup wg waits on named barrier 3 + wg
// before it sums a tile other than the first, and arrives on the other's
// after, where a next tile exists. Each arrival meets exactly one wait.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(kFwdThreads)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 - wg), "n"(kFwdThreads)
               : "memory");
}

// a CTA's shared memory as mma_edge_chunk reads it: the f32 node block [N]
// [H+3], W2 and Wc1 bf16 [H][kLdb] ([k][n]), small^T [6][H] f32, the two
// warpgroups' stages (2 * kTileBytes each) and geometries
struct ChunkSmem {
  float* acc;
  const bf* w2s;
  const bf* wc1s;
  const float* sms;
  unsigned char* stage;
  float* geo;
};

// The edge chain of items i_begin .. i_end-1 of one graph (B1: edges; B4:
// arcs, each with its mirror), summed into S.acc in tile order. pgb holds
// the graph's pa | pb [N][2H] in bf16 (proj_block) in device memory; xb its
// coordinates in bf16 (device or shared memory). Writes the residuals a1
// [H][E] and xd [3][E] where a1b / xdb are not null. The caller has zeroed
// S.acc and staged the weights; this starts the first tiles' loads, then
// synchronises the CTA, and ends synchronised. The chunk's tiles alternate
// between the two warpgroups; each loads its next tile's rows and geometry
// while the other computes.
template <int H, class Tiles>
__device__ __forceinline__ void mma_edge_chunk(
    const int* srcb, const int* dstb, const uint8_t* maskb, const bf* efb,
    const bf* xb, const bf* pgb, bf* a1b, bf* xdb, int N, int E, int i_begin,
    int i_end, const ChunkSmem& S, int tid) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  const int wg = tid / kMmaThreads, wtid = tid % kMmaThreads;
  const int lane = tid & 31;
  const int fr = lane >> 2, fq = lane & 3;  // fragment row, column pair
  const int m0 = (wtid >> 5) * 16;
  const float* sms = S.sms;
  // this warpgroup's stage: pa[src] rows (then a1s in their place), then
  // pb[dst] rows; its geometry
  unsigned char* st = S.stage + wg * 2 * kTileBytes;
  bf* pas = reinterpret_cast<bf*>(st);                           // [t][j]
  const bf* pbs = reinterpret_cast<const bf*>(st + kTileBytes);  // [t][j]
  const TileGeometry g = carve_geometry(S.geo + wg * geometry_floats());

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
    // residual), each product and sum rounded on its own as in the plain
    // version -> a1s = silu(a1) (near a tie with the IEEE sigmoid) as the A
    // operand of p2, and over the pa row it was formed from (m's recompute
    // reads it there) ----
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
            a1[0] = a1_rn(__low2float(pa), __low2float(pb), wr.x, rad[h],
                          we.x, efv[h], wb.x);
            a1[1] = a1_rn(__high2float(pa), __high2float(pb), wr.y, rad[h],
                          we.y, efv[h], wb.y);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              v[c] = a1[c] * sigmoid_fast(a1[c]);
              if (near_tie(v[c])) {
                EDGE_TIE_PROBE(0, 1u);
                v[c] = a1[c] * sigmoid(a1[c]);
              }
            }
          }
          if (col[h] >= 0) {
            a1b[(size_t)j * E + col[h]] = __float2bfloat16(a1[0]);
            a1b[(size_t)(j + 1) * E + col[h]] = __float2bfloat16(a1[1]);
          }
          af[kk][q] = pack2(v[0], v[1]);
          *reinterpret_cast<unsigned*>(pas + t * kLdb + j) = af[kk][q];
        }
    }
    __syncwarp();  // the warp's a1s rows are in place of its pa rows

    // ---- m = silu(silu(a1) @ W2 + b2) -> its f32 row (m_row) for the
    // node sums; m as the A operand of p3. An m about to round near a tie
    // is recomputed in the plain version's order (dot_k over the a1s row,
    // the IEEE sigmoid) ----
    {
      float p2[8][4];
      reg_product(af, S.w2s, lane, p2);
      unsigned tie = 0;  // bit tie_bit(nt, h, c): m near a tie
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          const float p = p2[nt][i] + sms[kB2 * H + j];
          const float mv = p * sigmoid_fast(p);
          tie |= unsigned(near_tie(mv)) << (4 * nt + i);
          p2[nt][i] = rnd<bf>(mv);
        }
      EDGE_TIE_PROBE(1, tie);
      for (; tie; tie &= tie - 1) {
        const int i = __ffs(tie) - 1;
        const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
        const float p =
            dot_k(pas + t * kLdb, 1, S.w2s + j, kLdb) + sms[kB2 * H + j];
        set_at(p2, i, rnd<bf>(p * sigmoid(p)));
      }
      __syncwarp();  // the warp's a1s rows are read: m takes their place
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* mr = m_row(st, m0 + fr + 8 * h);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<float2*>(mr + nt * 8 + 2 * fq) =
              make_float2(p2[nt][2 * h], p2[nt][2 * h + 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        af[kk][0] = pack2(p2[2 * kk][0], p2[2 * kk][1]);
        af[kk][1] = pack2(p2[2 * kk][2], p2[2 * kk][3]);
        af[kk][2] = pack2(p2[2 * kk + 1][0], p2[2 * kk + 1][1]);
        af[kk][3] = pack2(p2[2 * kk + 1][2], p2[2 * kk + 1][3]);
      }
      __syncwarp();  // the warp's m rows are complete: c1's recompute
    }

    // ---- cw = silu(m @ Wc1 + bc1) . wc2 -> the coordinate message
    // rnd(cw) * x_hat, rounded, in x_hat's place. A c1 about to round near
    // a tie is recomputed in the plain version's order (over the f32 m row,
    // in k order). cw is summed in the plain version's order
    // (ops/mega.py cw_in_order): each lane its 16 columns in column order,
    // each product and sum rounded on its own, then sum4's (0 + 1) + (2 + 3)
    // over the four lanes. cw_in_order copies this fragment-lane layout: a
    // change to the one is a change to the other ----
    {
      float p3[8][4];
      reg_product(af, S.wc1s, lane, p3);
      unsigned tie = 0;  // bit tie_bit(nt, h, c): c1 near a tie
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          const float p = p3[nt][i] + sms[kBC1 * H + j];
          const float cv = p * sigmoid_fast(p);
          tie |= unsigned(near_tie(cv)) << (4 * nt + i);
          p3[nt][i] = rnd<bf>(cv);
        }
      EDGE_TIE_PROBE(2, tie);
      for (; tie; tie &= tie - 1) {
        const int i = __ffs(tie) - 1;
        const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
        const float* mr = m_row(st, t);
        float p = 0.0f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          p = fmaf(mr[k], __bfloat162float(S.wc1s[k * kLdb + j]), p);
        }
        p += sms[kBC1 * H + j];
        set_at(p3, i, rnd<bf>(p * sigmoid(p)));
      }
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          part[i >> 1] = __fadd_rn(part[i >> 1],
                                   __fmul_rn(p3[nt][i], sms[kWC2 * H + j]));
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float cw = sum4(part[h]);
        const int t = m0 + fr + 8 * h;
        if (fq == 0) {
          const float cwb = rnd<bf>(cw);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            g.xh[t * 3 + k] = rnd<bf>(cwb * g.xh[t * 3 + k]);
          }
        }
      }
    }

    // ---- the tile's messages into the node block, after the chunk's
    // previous tile ----
    wg_sync(wg);  // the tile's m rows and coordinate messages
    if (it > 0) turn_wait(wg);
    sum_tile_ordered(S.acc, st, g, wtid);
    if (it + 1 < ntiles) turn_pass(wg);
    wg_sync(wg);  // the stage and the geometry turn over
    if (it + 2 < ntiles) load_tile(it + 2);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---- the node MLPs of B6 and B7: 64-row blocks on mma.sync ----

// rows m0 .. m0+15, depth k0 .. k0+15 of a bf16 tile [m][k] of row stride
// ld, as the A operand of an m16n8k16 product
__device__ __forceinline__ void load_a_ld(unsigned (&a)[4], const bf* s,
                                          int ld, int m0, int k0, int lane) {
  ldsm_x4(a, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// acc[q][.] = rows m0..m0+15 of A [.][lda] . W [K][kLdb] over depth K (a
// multiple of 16), columns n0 .. n0+31 (four n-tiles of 8)
__device__ __forceinline__ void block_product(const bf* a, int lda,
                                              const bf* w, int K, int m0,
                                              int n0, int lane,
                                              float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned af[4];
    load_a_ld(af, a, lda, m0, k0, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned bfr[4];
      load_b<true>(bfr, w, n0 + np * 16, k0, lane);
      mma_add(acc[2 * np], af, bfr[0], bfr[1]);
      mma_add(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// Per (graph, chunk): CTA b*chunks + c takes items c*chunk_items .. of
// graph b (mma_edge_chunk) and sums them into its node block: the output
// (chunks 1) or nodes [B*chunks][N][H+3] for reduce_node_chunks. proj holds
// pa | pb [B][N][2H] in bf16 (egnn_mega_proj_kernel).
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
  constexpr int C = H + 3;
  const FwdLayout L = fwd_layout(N);
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  float* acc = reinterpret_cast<float*>(sm);                // [N][C]
  bf* w2s = reinterpret_cast<bf*>(sm + L.w2);               // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + L.wc1);             // [k][n]
  float* sms = reinterpret_cast<float*>(sm + L.sms);
  const ChunkSmem S{acc, w2s, wc1s, sms, sm + L.stage,
                    reinterpret_cast<float*>(sm + L.geo)};

  const int b = blockIdx.x / chunks;
  const int i_begin = (blockIdx.x % chunks) * chunk_items;
  const int i_end = min(Tiles::items(E), i_begin + chunk_items);
  const int tid = threadIdx.x;

  // ---- the node block, and the weights rounded to bf16 by their store ----
  for (int i = tid; i < N * C; i += kFwdThreads) acc[i] = 0.0f;
  stage_mma_weights(w2, wc1, small, w2s, wc1s, sms, tid);

  mma_edge_chunk<H, Tiles>(
      src + (size_t)b * E, dst + (size_t)b * E, mask + (size_t)b * E,
      ef + (size_t)b * E, x + (size_t)b * N * 3, proj + (size_t)b * N * 2 * H,
      a1_out == nullptr ? nullptr : a1_out + (size_t)b * H * E,
      xd_out == nullptr ? nullptr : xd_out + (size_t)b * 3 * E, N, E, i_begin,
      i_end, S, tid);

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
  auto pkernel = egnn_mega_proj_kernel;
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
