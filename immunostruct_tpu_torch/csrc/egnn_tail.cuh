// The backward of the EGNN edge chain for Hopper (sm_90a), the body shared
// by csrc/egnn_tail_bwd.cu (B2), csrc/egnn_tail_bwd_db.cu (B5a) and
// csrc/egnn_tail_bwd_nodes.cu (B5b). What it computes and where it rounds:
// csrc/egnn_tail_bwd.cu.
//
//   tail_bwd_kernel      f32 features: the CUDA-core form, every H x H
//                        product a register-tiled FMA loop over f32 tiles in
//                        shared memory (256 threads a CTA);
//   tail_bwd_mma_kernel  bf16 features: the tensor-core form below (one
//                        warpgroup, 128 threads a CTA);
//   reduce_blocks        the per-CTA weight-gradient partials summed in CTA
//                        order.
// B5b's per-chunk node sums are summed in chunk order by reduce_node_chunks,
// and the tensor-core building blocks (cp.async staging, ldmatrix, mma_add,
// the near-tie recompute) are csrc/egnn_hopper.cuh's.
//
// The tensor-core form, per 64-edge tile (warp w owns edges 16w..16w+15 of
// the tile for the chain, and rows 16w..16w+15 of dW2/dWc1):
//   - every operand of the six H x H products is a bf16-rounded value
//     already (W2, Wc1, a1s, m, d_p3, d_p2), so each product is
//     mma.sync.m16n8k16 with bf16 operands and f32 accumulation, fed by
//     ldmatrix (.trans where the operand is stored the other way) from bf16
//     tiles in shared memory with 144-byte rows (8 rows of a 16-byte
//     ldmatrix read fall in 8 different bank groups: no conflicts); each
//     m16n8k16 product starts from zero and is added in f32 (mma_add), since
//     the tensor cores' own accumulation does not round to nearest;
//   - the sigmoids run on the special-function unit; where a value about
//     to round to bf16 (a1s, m, c1, d_p3, d_p2, d_a1) lies within kTieUlps
//     f32 units of a bf16 rounding boundary, its element is recomputed on
//     the CUDA cores in the plain version's order (near_tie, dot_k), so
//     that it rounds as there: a rounding that falls the other way moves
//     the rest of the edge's chain;
//   - the element-wise steps (bias, silu, silu', the rounding points, the
//     per-edge sums for cw, d_cw, d_rad, d_ef) work on the accumulator
//     fragments in registers, and go back to shared memory in bf16 only
//     where a later product reads them;
//   - dW2 and dWc1 stay in register fragments over all of a CTA's tiles;
//     db2, dbc1 and dwc2 are f32 sums in registers over each thread's
//     columns; dw1r, dw1e and db1 are one more product, d_a1^T . [radial,
//     ef, 1] (exact bf16 operands, f32 accumulation);
//   - the next tile's a1 [H, 64], xd, ef and cotangent (d_both [H+3, 64],
//     or the rows g[dst]) arrive by cp.async into the other of two stages
//     while this tile computes; each run is copied as the 16-byte-aligned
//     chunks that cover it, so any E and any row offset is taken, and read
//     back at its offset. The edges' valid/src/dst are read into registers
//     two tiles ahead, since the rows g[dst] of the next tile need them;
//   - B5b: one CTA per (graph, edge chunk) as B2; each chunk sums its tile's
//     d_cat into an f32 node block of its own ([N, 2(H+3)], device memory,
//     L2-resident) and a second kernel sums the chunks in chunk order. In a
//     tile, each side's edges are ranked by node (a counting sort, edge
//     order kept within a node); each of the 2(H+3) columns is one thread's,
//     which adds a node's edges in registers and does one read-add-write per
//     node, the reads of 16 nodes in flight at once (no two of a tile's
//     nodes alias). No atomics anywhere: every output is the same bits from
//     run to run.

#pragma once

#include "egnn_hopper.cuh"

namespace egnn {

// ---------------------------------------------------------------------------
// f32: the CUDA-core form
// ---------------------------------------------------------------------------

// where the cotangent of [m ++ cw*x_hat] comes from
constexpr int kOperand = 0;  // B2: d_both [B,H+3,E], gathered by the caller
constexpr int kGather = 1;   // B5a: g [B,N,H+3], row dst[e] read here
constexpr int kNodes = 2;    // B5b: as kGather, and d_cat summed into nodes

// width of one block's partial gradients: dW2 | dWc1 | dsmall
__host__ __device__ constexpr int grad_width(int hid) {
  return 2 * hid * hid + 6 * hid;
}

// shared-memory floats: W2, Wc1 2*H*(H+1) | small^T 6*H | five edge-tile
// buffers 5*kTile*(H+1) | per-edge values 11*kTile | ok, src, dst ints
// 3*kTile | d_xd 3*kTile
__host__ __device__ inline long long tail_smem_floats(int hid) {
  return 2LL * hid * row_stride(hid) + 6LL * hid +
         5LL * kTile * row_stride(hid) + 17LL * kTile;
}

// Per graph b (blocks b*chunks .. b*chunks+chunks-1, each a chunk of
// edges), per valid edge e, from a1 [H], xd [3], ef and the cotangent
// d_both [H+3] of [m ++ cw*x_hat]: csrc/egnn_tail_bwd.cu's chain backward
// -> d_a1, d_xd, d_ef, and the weight gradients as per-block partials.
// kMode kOperand (B2): d_both read from cot = d_both [B,H+3,E]; kGather
//   (B5a): d_both = row dst[e] of cot = g [B,N,H+3] (f32, as
//   g arrives); both write d_cat [B,H+3,E] = [d_a1 ; d_xd] and d_ef.
// kMode kNodes (B5b): as kGather, but d_cat never leaves shared memory;
//   each of the 2(H+3) columns of the CTA's node block [N][2(H+3)] (src
//   side, then dst side; dnodes [B*chunks][N][2(H+3)] when chunks > 1, else
//   the output [B][N][2(H+3)]) is owned by one thread, which adds the
//   tile's edges in edge order: node[src[e]][k] += d_cat[k][e],
//   node[dst[e]][H+3+k] += d_cat[k][e], in f32, eight edges at a time with
//   the repeats among them resolved in registers. No atomics: the sums are
//   the same from run to run.
// This is the f32 form (CUDA cores); bf16 takes tail_bwd_mma_kernel.
template <int H, int kMode>
__global__ void __launch_bounds__(kThreads)
    tail_bwd_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ ef, const float* __restrict__ w2,
                    const float* __restrict__ wc1,
                    const float* __restrict__ small,
                    const float* __restrict__ a1, const float* __restrict__ xd,
                    const float* __restrict__ cot, float* __restrict__ dcat,
                    float* __restrict__ dnodes, float* __restrict__ def,
                    float* __restrict__ partial, int N, int E, int chunks,
                    int chunk_edges) {
  constexpr bool kNodeSums = kMode == kNodes;
  constexpr int C = H + 3;
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");

  extern __shared__ float smem[];
  float* w2s = smem;                 // [H][LD], row k = input unit k
  float* wc1s = w2s + H * LD;        // [H][LD]
  float* sms = wc1s + H * LD;        // [6][H] (small transposed)
  float* bufA = sms + 6 * H;         // [kTile][LD] a1s
  float* bufM = bufA + kTile * LD;   // [kTile][LD] m
  float* bufG = bufM + kTile * LD;   // [kTile][LD] silu'(a1), then d_a1
  float* bufP3 = bufG + kTile * LD;  // [kTile][LD] d_p3
  float* bufP2 = bufP3 + kTile * LD; // [kTile][LD] d_m_in, then d_p2
  float* radv = bufP2 + kTile * LD;  // [kTile] radial (rounded)
  float* invv = radv + kTile;        // [kTile] 1 / (sqrt(radial) + 1e-30)
  float* efv = invv + kTile;         // [kTile]
  float* cwv = efv + kTile;          // [kTile] cw (rounded)
  float* dcwv = cwv + kTile;         // [kTile] d_cw
  float* xdv = dcwv + kTile;         // [3][kTile]
  float* dmxv = xdv + 3 * kTile;     // [3][kTile] d_msgx
  int* okv = reinterpret_cast<int*>(dmxv + 3 * kTile);
  int* srcv = okv + kTile;           // [kTile] src (0 on a skipped edge)
  int* dstv = srcv + kTile;          // [kTile] dst (0 on a skipped edge)
  float* dxv = reinterpret_cast<float*>(dstv + kTile);  // [3][kTile] d_xd

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const int* srcb = kNodeSums ? src + (size_t)b * E : nullptr;
  const int* dstb = kMode == kOperand ? nullptr : dst + (size_t)b * E;
  const uint8_t* vb = valid + (size_t)b * E;
  const float* efb = ef + (size_t)b * E;
  const float* a1b = a1 + (size_t)b * H * E;
  const float* xdb = xd + (size_t)b * 3 * E;
  // d_both [C][E] of this graph (kOperand), or g [N][C] (the others)
  const float* cb = cot + (size_t)b * (kMode == kOperand ? C * E : N * C);
  float* dcb = kNodeSums ? nullptr : dcat + (size_t)b * C * E;
  float* defb = def + (size_t)b * E;
  // the CTA's node block (chunks 1: the graph's rows of the output)
  float* dnb = kNodeSums ? dnodes + (size_t)blockIdx.x * N * 2 * C : nullptr;

  // ---- weights ----
  for (int i = tid; i < H * H; i += kThreads) {
    const int k = i / H, j = i % H;
    w2s[k * LD + j] = w2[i];
    wc1s[k * LD + j] = wc1[i];
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
  if (kNodeSums && tid < 2 * C) {
    // this thread's column of the graph's node sums starts at zero
    for (int n = 0; n < N; ++n) dnb[(size_t)n * 2 * C + tid] = 0.0f;
  }

  // this thread's share of the weight gradients, summed over its tiles:
  // dW2/dWc1 rows tg*4+r, columns cg*CPT+c; dsmall columns cg*CPT+c
  float gw2[4][CPT], gwc1[4][CPT], gsm[6][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gw2[r][c] = gwc1[r][c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gsm[k][c] = 0.0f;
  __syncthreads();

  for (int e0 = e_begin; e0 < e_end; e0 += kTile) {
    // ---- per-edge geometry and coordinate cotangent d_both[H..H+2] ----
    if (tid < kTile) {
      const int e = e0 + tid;
      const int ok = e < e_end && vb[e] != 0;
      int s = 0, d = 0;
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f, m0 = 0.0f, m1 = 0.0f,
            m2 = 0.0f, ev = 0.0f;
      if (ok) {
        if (kNodeSums) s = srcb[e];
        x0 = xdb[0 * E + e];
        x1 = xdb[1 * E + e];
        x2 = xdb[2 * E + e];
        if (kMode == kOperand) {
          m0 = cb[(size_t)(H + 0) * E + e];
          m1 = cb[(size_t)(H + 1) * E + e];
          m2 = cb[(size_t)(H + 2) * E + e];
        } else {
          d = dstb[e];
          const float* grow = cb + (size_t)d * C + H;
          m0 = grow[0];
          m1 = grow[1];
          m2 = grow[2];
        }
        ev = efb[e];
      }
      const float r = x0 * x0 + x1 * x1 + x2 * x2;
      const float safe = r > 0.0f ? r : 1.0f;
      okv[tid] = ok;
      srcv[tid] = s;
      dstv[tid] = d;
      radv[tid] = r;
      invv[tid] = 1.0f / (sqrtf(safe) + 1e-30f);
      efv[tid] = ev;
      xdv[0 * kTile + tid] = x0;
      xdv[1 * kTile + tid] = x1;
      xdv[2 * kTile + tid] = x2;
      dmxv[0 * kTile + tid] = m0;
      dmxv[1 * kTile + tid] = m1;
      dmxv[2 * kTile + tid] = m2;
    }
    // ---- a1 -> a1s, silu'(a1); d_m_in from d_both (coalesced: t fastest)
    for (int i = tid; i < kTile * H; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      const int e = e0 + t;
      float a = 0.0f, dm = 0.0f;
      if (e < e_end && vb[e] != 0) {
        a = a1b[(size_t)j * E + e];
        if (kMode == kOperand) dm = cb[(size_t)j * E + e];
      }
      const float s = sigmoid(a);
      bufA[t * LD + j] = a * s;
      bufG[t * LD + j] = silu_grad(a, s);
      if (kMode == kOperand) bufP2[t * LD + j] = dm;
    }
    __syncthreads();
    if (kMode != kOperand) {
      // ---- d_m_in = g[dst][0..H-1] (coalesced: a row's channels in turn);
      // bufP2 is first read after the next barriers ----
      for (int i = tid; i < kTile * H; i += kThreads) {
        const int t = i / H, j = i % H;
        bufP2[t * LD + j] =
            okv[t] ? cb[(size_t)dstv[t] * C + j] : 0.0f;
      }
    }

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[4][CPT];
    {
      float acc[4][CPT];
      tile_product<H, LD, false>(bufA, w2s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float p = acc[i][c] + sms[kB2 * H + j];
          const float s = sigmoid(p);
          bufM[t * LD + j] = p * s;
          g2[i][c] = silu_grad(p, s);
        }
    }
    __syncthreads();

    // ---- p3 = m @ Wc1 + bc1 -> c1, cw; keep silu'(p3) and c1 ----
    float g3[4][CPT], c1v[4][CPT];
    {
      float acc[4][CPT];
      tile_product<H, LD, false>(bufM, wc1s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float p = acc[i][c] + sms[kBC1 * H + j];
          const float s = sigmoid(p);
          c1v[i][c] = p * s;
          g3[i][c] = silu_grad(p, s);
          part += c1v[i][c] * sms[kWC2 * H + j];
        }
        const float cw = sum16(part);
        if (cg == 0) {
          // d_cw = d_msgx . x_hat, x_hat = xd / (sqrt(radial) + 1e-30)
          const float inv = invv[t];
          cwv[t] = cw;
          dcwv[t] = dmxv[0 * kTile + t] * (xdv[0 * kTile + t] * inv) +
                    dmxv[1 * kTile + t] * (xdv[1 * kTile + t] * inv) +
                    dmxv[2 * kTile + t] * (xdv[2 * kTile + t] * inv);
        }
      }
    }
    __syncthreads();

    // ---- d_p3 = wc2 * d_cw * silu'(p3); d bc1, d wc2 ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg * 4 + i;
      const float dcw = dcwv[t];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = cg * CPT + c;
        const float dp3 = sms[kWC2 * H + j] * dcw * g3[i][c];
        bufP3[t * LD + j] = dp3;
        gsm[kBC1][c] += dp3;
        gsm[kWC2][c] += c1v[i][c] * dcw;
      }
    }
    __syncthreads();

    // ---- d_m = d_m_in + Wc1 @ d_p3; d_p2 = d_m * silu'(p2); d b2 ----
    {
      float acc[4][CPT];
      tile_product<H, LD, true>(bufP3, wc1s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          const float dm = bufP2[t * LD + j] + acc[i][c];
          const float dp2 = dm * g2[i][c];
          bufP2[t * LD + j] = dp2;  // read and written by this thread only
          gsm[kB2][c] += dp2;
        }
    }
    __syncthreads();

    // ---- d_a1 = (W2 @ d_p2) * silu'(a1); d w1r, d w1e, d b1; d_xd, d_ef ----
    {
      float acc[4][CPT];
      tile_product<H, LD, true>(bufP2, w2s, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tg * 4 + i;
        float prad = 0.0f, pef = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int j = cg * CPT + c;
          const float da = acc[i][c] * bufG[t * LD + j];
          bufG[t * LD + j] = da;  // read and written by this thread only
          gsm[kW1R][c] += da * radv[t];
          gsm[kW1E][c] += da * efv[t];
          gsm[kB1][c] += da;
          prad += sms[kW1R * H + j] * da;
          pef += sms[kW1E * H + j] * da;
        }
        const float d_rad_chain = sum16(prad);
        const float d_ef = sum16(pef);
        const int e = e0 + t;
        if (cg == 0 && e < e_end) {
          float dx[3] = {0.0f, 0.0f, 0.0f}, dfe = 0.0f;
          if (okv[t]) {
            const float r = radv[t], inv = invv[t], cwb = cwv[t];
            const float safe = r > 0.0f ? r : 1.0f;
            float sum_dxh_xd = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              sum_dxh_xd += dmxv[k * kTile + t] * cwb * xdv[k * kTile + t];
            }
            const float d_safe =
                sum_dxh_xd * (-0.5f) * inv * inv / sqrtf(safe);
            const float d_rad = d_rad_chain + (r > 0.0f ? d_safe : 0.0f);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              dx[k] = dmxv[k * kTile + t] * cwb * inv +
                      2.0f * xdv[k * kTile + t] * d_rad;
            }
            dfe = d_ef;
          }
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            if (kNodeSums) {
              dxv[k * kTile + t] = dx[k];
            } else {
              dcb[(size_t)(H + k) * E + e] = dx[k];
            }
          }
          defb[e] = dfe;
        }
      }
    }
    __syncthreads();

    if (kNodeSums) {
      // ---- d_cat summed into node space: one thread per (side, column),
      // the tile's edges in order, eight at a time ----
      if (tid < 2 * C) {
        const int side = tid / C, k = tid % C;
        const int* idxv = side == 0 ? srcv : dstv;
        float* col = dnb + tid;  // rows of stride 2C
        for (int t0 = 0; t0 < kTile; t0 += 8) {
          int idx[8];
          float add[8], cur[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const int t = t0 + u;
            const bool ok = okv[t] != 0;
            idx[u] = ok ? idxv[t] : -1;
            add[u] = !ok ? 0.0f
                         : (k < H ? bufG[t * LD + k]
                                  : dxv[(k - H) * kTile + t]);
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            cur[u] = idx[u] >= 0 ? col[(size_t)idx[u] * 2 * C] : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float base = cur[u];
#pragma unroll
            for (int v = 0; v < u; ++v) {
              if (idx[v] == idx[u]) base = cur[v];
            }
            cur[u] = base + add[u];
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (idx[u] >= 0) col[(size_t)idx[u] * 2 * C] = cur[u];
          }
        }
      }
    } else {
      // ---- d_a1 into d_cat (coalesced) ----
      for (int i = tid; i < kTile * H; i += kThreads) {
        const int j = i / kTile, t = i % kTile;
        if (e0 + t < e_end) {
          dcb[(size_t)j * E + e0 + t] =
              okv[t] ? bufG[t * LD + j] : 0.0f;
        }
      }
    }
    // ---- dW2 += a1s (x) d_p2, dWc1 += m (x) d_p3 ----
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float av[4], mv[4], p2v[CPT], p3v[CPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = bufA[t * LD + tg * 4 + r];
        mv[r] = bufM[t * LD + tg * 4 + r];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        p2v[c] = bufP2[t * LD + cg * CPT + c];
        p3v[c] = bufP3[t * LD + cg * CPT + c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gw2[r][c] += av[r] * p2v[c];
          gwc1[r][c] += mv[r] * p3v[c];
        }
    }
    __syncthreads();  // tile buffers and per-edge values are rewritten next
  }

  // ---- this block's partial gradients: dW2 | dWc1 | dsmall [H][6] ----
  float* pb = partial + (size_t)blockIdx.x * grad_width(H);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int row = tg * 4 + r, col = cg * CPT + c;
      pb[row * H + col] = gw2[r][c];
      pb[H * H + row * H + col] = gwc1[r][c];
    }
  float* red = bufA;  // [16 edge groups][6][H], over the free tile buffers
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      red[(tg * 6 + k) * H + cg * CPT + c] = gsm[k][c];
    }
  __syncthreads();
  for (int i = tid; i < 6 * H; i += kThreads) {
    const int j = i / 6, k = i % 6;
    float s = 0.0f;
    for (int q = 0; q < 16; ++q) s += red[(q * 6 + k) * H + j];
    pb[2 * H * H + i] = s;
  }
}

// grads[i] = sum over blocks, in block order, of partial[block][i]
__global__ void __launch_bounds__(kReduceThreads)
    reduce_blocks(const float* __restrict__ partial, int blocks, int width,
                  float* __restrict__ grads) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * width + i];
  grads[i] = s;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

constexpr int kGRowBytes = 160;         // a staged row g[dst] (H+3 bf16)
constexpr int kGRowChunks = kGRowBytes / 16;
constexpr int kNodeBatch = 16;          // node reads in flight per column

// byte offsets into a CTA's shared memory: two stages (each: a1 [H] runs,
// the cotangent, xd [3] and ef runs, ok/src/dst ints), then W2, Wc1 bf16
// [H][kLdb], the four bf16 tiles, V [kTile][8] bf16 (radial, ef, 1),
// small^T [6][H] f32, the per-edge values, and B5b's node ranks
template <int kMode>
struct TailLayout {
  static constexpr int C = kHidden + 3;
  static constexpr int a1 = 0;
  static constexpr int cot = a1 + kHidden * kRunBytes;
  static constexpr int cot_bytes =
      kMode == kOperand ? C * kRunBytes : kTile * kGRowBytes;
  static constexpr int xd = cot + cot_bytes;
  static constexpr int ef = xd + 3 * kRunBytes;
  static constexpr int ok = ef + kRunBytes;
  static constexpr int src = ok + 4 * kTile;
  static constexpr int dst = src + 4 * kTile;
  static constexpr int goff = dst + 4 * kTile;   // offset of row g[dst]
  static constexpr int stage = goff + 4 * kTile;
  static constexpr int w2 = 2 * stage;
  static constexpr int wc1 = w2 + kHidden * kLdb * 2;
  // a1s [H][kLdb] (feature-major), then d_a1 [kTile][kLdb] (edge-major)
  static constexpr int a1s = wc1 + kHidden * kLdb * 2;
  static constexpr int m = a1s + kTileBytes;     // [kTile][kLdb]
  static constexpr int dp3 = m + kTileBytes;     // [kTile][kLdb]
  static constexpr int dp2 = dp3 + kTileBytes;   // [kTile][kLdb]
  static constexpr int v = dp2 + kTileBytes;
  static constexpr int sms = v + kTile * 16;
  static constexpr int edge = sms + 6 * kHidden * 4;
  // B5b: per side, the tile's node keys in rank order and their edges
  static constexpr int order = edge + kEdgeRows * kTile * 4;
  static constexpr int bytes = order + (kMode == kNodes ? 16 * kTile : 0);
  static_assert(stage % 16 == 0, "stages must stay 16-byte aligned");
};


// Per graph b (CTAs b*chunks .. b*chunks+chunks-1, each a chunk of edges),
// the contract of tail_bwd_kernel in bf16 (the arithmetic of
// csrc/egnn_tail_bwd.cu, its rounding points, the partials' layout). kNodes:
// the chunk's node sums go to dnodes [B*chunks][N][2(H+3)] (chunks > 1, for
// reduce_node_chunks) or straight to the output (chunks 1).
template <int H, int kMode>
__global__ void __launch_bounds__(kMmaThreads, 2)
    tail_bwd_mma_kernel(const int* __restrict__ src,
                        const int* __restrict__ dst,
                        const uint8_t* __restrict__ valid,
                        const bf* __restrict__ ef, const float* __restrict__ w2,
                        const float* __restrict__ wc1,
                        const float* __restrict__ small,
                        const bf* __restrict__ a1, const bf* __restrict__ xd,
                        const bf* __restrict__ cot, bf* __restrict__ dcat,
                        float* __restrict__ dnodes, bf* __restrict__ def,
                        float* __restrict__ partial, int N, int E, int chunks,
                        int chunk_edges) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  static_assert(kMmaThreads == 2 * kTile, "one thread per (side, edge)");
  using L = TailLayout<kMode>;
  constexpr bool kNodeSums = kMode == kNodes;
  constexpr int C = H + 3;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  bf* w2s = reinterpret_cast<bf*>(sm + L::w2);    // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + L::wc1);  // [k][n]
  bf* a1st = reinterpret_cast<bf*>(sm + L::a1s);  // a1s [j][t], then d_a1 [t][j]
  bf* mt = reinterpret_cast<bf*>(sm + L::m);
  bf* dp3t = reinterpret_cast<bf*>(sm + L::dp3);
  bf* dp2t = reinterpret_cast<bf*>(sm + L::dp2);
  bf* vt = reinterpret_cast<bf*>(sm + L::v);      // [t][8]
  float* sms = reinterpret_cast<float*>(sm + L::sms);
  float* ev = reinterpret_cast<float*>(sm + L::edge);
  int* skey = reinterpret_cast<int*>(sm + L::order);  // [2][kTile]
  int* sord = skey + 2 * kTile;                       // [2][kTile]

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fq = lane & 3;  // fragment row, column pair
  const int m0 = warp * 16;
  const int* srcb = kNodeSums ? src + (size_t)b * E : nullptr;
  const int* dstb = kMode == kOperand ? nullptr : dst + (size_t)b * E;
  const uint8_t* vb = valid + (size_t)b * E;
  const bf* efb = ef + (size_t)b * E;
  const bf* a1b = a1 + (size_t)b * H * E;
  const bf* xdb = xd + (size_t)b * 3 * E;
  const bf* cb = cot + (size_t)b * (kMode == kOperand ? C * E : N * C);
  bf* dcb = kNodeSums ? nullptr : dcat + (size_t)b * C * E;
  bf* defb = def + (size_t)b * E;
  // the CTA's node block (chunks 1: the graph's rows of the output)
  float* dnb = kNodeSums ? dnodes + (size_t)blockIdx.x * N * 2 * C : nullptr;

  // ---- weights, rounded to bf16 by their store ----
  for (int i = tid; i < H * H; i += kMmaThreads) {
    const int k = i / H, j = i % H;
    w2s[k * kLdb + j] = __float2bfloat16(w2[i]);
    wc1s[k * kLdb + j] = __float2bfloat16(wc1[i]);
  }
  for (int i = tid; i < 6 * H; i += kMmaThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
  }
  if (kNodeSums) {
    // this chunk's node block starts at zero
    for (int i = tid; i < N * 2 * C; i += kMmaThreads) dnb[i] = 0.0f;
  }

  // the weight gradients: dW2/dWc1 rows m0.., as fragments; db2, dbc1 and
  // dwc2 over this thread's 16 columns (index 2*nt + i%2); dw1r, dw1e, db1
  // as the fragment of d_a1^T . V (rows m0.., columns 0..7)
  float gw2[8][4], gwc1[8][4], gv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gb2[16], gbc1[16], gwc2[16];
  zero(gw2);
  zero(gwc1);
#pragma unroll
  for (int c = 0; c < 16; ++c) gb2[c] = gbc1[c] = gwc2[c] = 0.0f;

  // ---- the pipeline: tile it computes from stage it % 2 while tile it+1
  // arrives in the other; edge indices are read two tiles ahead ----
  const int ntiles =
      e_end > e_begin ? (e_end - e_begin + kTile - 1) / kTile : 0;
  int n_ok = 0, n_s = 0, n_d = 0;  // this thread's edge of a coming tile
  auto read_edge = [&](int e0) {
    const int e = e0 + tid;
    n_ok = tid < kTile && e < e_end && vb[e] != 0;
    n_s = kNodeSums && n_ok ? srcb[e] : 0;
    n_d = kMode != kOperand && n_ok ? dstb[e] : 0;
  };
  auto stage_tile = [&](int it) {
    unsigned char* st = sm + (it & 1) * L::stage;
    const int e0 = e_begin + it * kTile;
    const int run = 2 * min(kTile, e_end - e0);
    if (tid < kTile) {
      reinterpret_cast<int*>(st + L::ok)[tid] = n_ok;
      reinterpret_cast<int*>(st + L::src)[tid] = n_s;
      reinterpret_cast<int*>(st + L::dst)[tid] = n_d;
      if (kMode != kOperand) {
        const bf* row = cb + (size_t)n_d * C;  // g[dst]
        reinterpret_cast<int*>(st + L::goff)[tid] = run_offset(row);
        if (n_ok) {
          for (int c = 0; c < kGRowChunks; ++c) {
            stage_run(st + L::cot + tid * kGRowBytes, row, 2 * C, c);
          }
        }
      }
    }
    constexpr int rows = H + 4 + (kMode == kOperand ? C : 0);
    for (int i = tid; i < rows * kRunChunks; i += kMmaThreads) {
      const int r = i / kRunChunks, c = i % kRunChunks;
      if (r < H) {
        stage_run(st + L::a1 + r * kRunBytes, a1b + (size_t)r * E + e0, run,
                  c);
      } else if (r < H + 3) {
        stage_run(st + L::xd + (r - H) * kRunBytes,
                  xdb + (size_t)(r - H) * E + e0, run, c);
      } else if (r == H + 3) {
        stage_run(st + L::ef, efb + e0, run, c);
      } else {
        const int k = r - H - 4;
        stage_run(st + L::cot + k * kRunBytes, cb + (size_t)k * E + e0, run,
                  c);
      }
    }
  };
  if (ntiles > 0) {
    read_edge(e_begin);
    stage_tile(0);
  }
  cp_async_commit();
  if (ntiles > 1) read_edge(e_begin + kTile);

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) stage_tile(it + 1);
    cp_async_commit();
    if (it + 2 < ntiles) read_edge(e_begin + (it + 2) * kTile);
    cp_async_wait<1>();
    __syncthreads();

    const int e0 = e_begin + it * kTile;
    const unsigned char* st = sm + (it & 1) * L::stage;
    const int* okv = reinterpret_cast<const int*>(st + L::ok);
    const int* srcv = reinterpret_cast<const int*>(st + L::src);
    const int* dstv = reinterpret_cast<const int*>(st + L::dst);
    const int* goffv = reinterpret_cast<const int*>(st + L::goff);
    // where the runs of this tile landed: row k of a [., E] tensor lies
    // (2*k*E) & 15 bytes after row 0's offset
    const int step = (2 * E) & 15;
    const int off_a1 = run_offset(a1b + e0);
    const int off_xd = run_offset(xdb + e0);
    const int off_cot = run_offset(cb + e0);  // kOperand
    // the cotangent of [m ++ cw*x_hat], channel k of tile edge t
    auto cot_at = [&](int t, int k) {
      if (kMode == kOperand) {
        return staged(st + L::cot + k * kRunBytes, (off_cot + k * step) & 15,
                      t);
      }
      return staged(st + L::cot + t * kGRowBytes, goffv[t], k);
    };
    auto a1_at = [&](int t, int j) {
      return staged(st + L::a1 + j * kRunBytes, (off_a1 + j * step) & 15, t);
    };
    // a1 and the cotangent d_m_in of tile edge t, column j (0: skipped)
    auto a1_of = [&](int t, int j) {
      return okv[t] ? a1_at(t, j) : 0.0f;
    };
    auto dm_in = [&](int t, int j) {
      return okv[t] ? cot_at(t, j) : 0.0f;
    };

    // ---- per edge: geometry, d_msgx, d_cw; V; B5b's node ranks ----
    if (tid < kTile) {
      const int t = tid;
      const bool ok = okv[t] != 0;
      float x[3], dmx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = ok ? staged(st + L::xd + k * kRunBytes,
                           (off_xd + k * step) & 15, t)
                  : 0.0f;
        dmx[k] = ok ? cot_at(t, H + k) : 0.0f;
      }
      const float efv =
          ok ? staged(st + L::ef, run_offset(efb + e0), t) : 0.0f;
      const float r = rnd<bf>(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
      const float safe = r > 0.0f ? r : 1.0f;
      const float inv = 1.0f / (sqrtf(safe) + 1e-30f);
      ev[kERad * kTile + t] = r;
      ev[kEInv * kTile + t] = inv;
      ev[kEEf * kTile + t] = efv;
      // d_cw = d_msgx . x_hat, x_hat = xd / (sqrt(radial) + 1e-30)
      ev[kEDcw * kTile + t] =
          dmx[0] * (x[0] * inv) + dmx[1] * (x[1] * inv) + dmx[2] * (x[2] * inv);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ev[(kEXd + k) * kTile + t] = x[k];
        ev[(kEDmx + k) * kTile + t] = dmx[k];
      }
      store_pair(vt + t * 8 + 0, r, efv);
      store_pair(vt + t * 8 + 2, 1.0f, 0.0f);
      store_pair(vt + t * 8 + 4, 0.0f, 0.0f);
      store_pair(vt + t * 8 + 6, 0.0f, 0.0f);
    }
    if (kNodeSums) {
      // rank of edge u among its side's edges by (node, edge); skipped edges
      // take key N and rank last
      const int side = tid / kTile, u = tid % kTile;
      const int* idx = side == 0 ? srcv : dstv;
      const int key = okv[u] ? idx[u] : N;
      int rank = 0;
      for (int v = 0; v < kTile; ++v) {
        const int kv = okv[v] ? idx[v] : N;
        rank += kv < key || (kv == key && v < u);
      }
      skey[side * kTile + rank] = key;
      sord[side * kTile + rank] = u;
    }
    // ---- a1 -> a1s [j][t] ----
    for (int i = tid; i < H * kTile; i += kMmaThreads) {
      const int j = i / kTile, t = i % kTile;
      const float a = okv[t] ? a1_at(t, j) : 0.0f;
      float v = a * sigmoid_fast(a);
      if (near_tie(v)) v = a * sigmoid(a);
      a1st[j * kLdb + t] = __float2bfloat16(v);
    }
    __syncthreads();

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[8][4];
    chain_p2(a1st, w2s, sms, mt, m0, lane, g2);
    __syncwarp();

    // ---- p3 = m @ Wc1 + bc1 -> c1, cw; d_p3 = wc2 * d_cw * silu'(p3) ----
    chain_p3(mt, wc1s, sms, ev, dp3t, m0, lane, gbc1, gwc2);
    __syncwarp();

    // ---- d_m = d_m_in + Wc1 @ d_p3; d_p2 = d_m * silu'(p2) ----
    chain_dp2(dp3t, wc1s, a1st, w2s, sms, g2, dm_in, dp2t, m0, lane, gb2);
    __syncthreads();  // every warp's d_p2/d_p3 rows for the weight gradients

    // ---- W2 @ d_p2; dW2 += a1s (x) d_p2; dWc1 += m (x) d_p3 ----
    float da_acc[8][4];
    zero(da_acc);
    warp_product<false, false>(dp2t, w2s, m0, lane, da_acc);
    warp_product<false, true>(a1st, dp2t, m0, lane, gw2);
    warp_product<true, true>(mt, dp3t, m0, lane, gwc1);
    __syncthreads();  // a1s is read; its tile takes d_a1 next

    // ---- d_a1 = (W2 @ d_p2) * silu'(a1); d_xd, d_ef ----
    {
      float prad[2] = {0.0f, 0.0f}, pef[2] = {0.0f, 0.0f};
      chain_da1(da_acc, dp2t, w2s, sms, a1_of, a1_of, a1st, m0, lane, prad,
                pef);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d_rad_chain = sum4(prad[h]);
        const float d_ef = sum4(pef[h]);
        const int t = m0 + fr + 8 * h;
        const int e = e0 + t;
        if (fq == 0 && e < e_end) {
          edge_dxd(ev, t, okv[t] != 0, d_rad_chain);
          defb[e] = __float2bfloat16(okv[t] ? d_ef : 0.0f);
        }
      }
    }
    __syncthreads();  // d_a1 and d_xd of every edge

    // ---- dw1r, dw1e, db1 += d_a1^T . [radial, ef, 1] ----
    chain_dsmall_v(a1st, vt, m0, lane, gv);

    if (kNodeSums) {
      // ---- d_cat summed into the chunk's node block: one thread per
      // (side, column) (threads 0-2 and 64-66 also take a d_xd column);
      // each node's edges are added in rank order in registers, then one
      // read-add-write per node ----
      const int side = tid / kTile, k = tid % kTile;
      const bool two = k < 3;
      const int* keys = skey + side * kTile;
      const int* ords = sord + side * kTile;
      float* col = dnb + side * C + k;
      float* col2 = dnb + side * C + H + (two ? k : 0);
      float run = 0.0f, run2 = 0.0f;
#pragma unroll
      for (int p0 = 0; p0 < kTile; p0 += kNodeBatch) {
        float old[kNodeBatch], old2[kNodeBatch];
#pragma unroll
        for (int u = 0; u < kNodeBatch; ++u) {
          const int pos = p0 + u, key = keys[pos];
          const bool last = key < N && (pos == kTile - 1 || keys[pos + 1] != key);
          old[u] = last ? col[(size_t)key * 2 * C] : 0.0f;
          old2[u] = last && two ? col2[(size_t)key * 2 * C] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kNodeBatch; ++u) {
          const int pos = p0 + u, key = keys[pos];
          if (key < N) {
            const int t = ords[pos];
            run += __bfloat162float(a1st[t * kLdb + k]);
            run2 += ev[(kEDxd + (two ? k : 0)) * kTile + t];
            if (pos == kTile - 1 || keys[pos + 1] != key) {
              col[(size_t)key * 2 * C] = old[u] + run;
              if (two) col2[(size_t)key * 2 * C] = old2[u] + run2;
              run = run2 = 0.0f;
            }
          }
        }
      }
    } else {
      // ---- d_cat = [d_a1 ; d_xd] (coalesced: neighbouring edges) ----
      for (int i = tid; i < C * kTile; i += kMmaThreads) {
        const int j = i / kTile, t = i % kTile;
        if (e0 + t < e_end) {
          const bf v = j < H ? (okv[t] ? a1st[t * kLdb + j]
                                       : __float2bfloat16(0.0f))
                             : __float2bfloat16(
                                   ev[(kEDxd + j - H) * kTile + t]);
          dcb[(size_t)j * E + e0 + t] = v;
        }
      }
    }
    __syncthreads();  // the stage, the tiles and the per-edge values turn over
  }
  cp_async_wait<0>();

  // ---- this CTA's partial gradients: dW2 | dWc1 | dsmall [H][6] ----
  store_chain_partials(partial + (size_t)blockIdx.x * grad_width(H), gw2,
                       gwc1, gv, gb2, gbc1, gwc2,
                       reinterpret_cast<float*>(sm + L::a1s), tid);
}

// shared memory of one CTA of the main kernel: the f32 or the bf16 form
template <int kMode>
inline long long tail_smem_bytes(int hid, bool bf16) {
  return bf16 ? TailLayout<kMode>::bytes
              : tail_smem_floats(hid) * (long long)sizeof(float);
}

// edges per chunk: a whole number of tiles
inline int tail_chunk_edges(int E, int chunks) {
  const int per = (E + chunks - 1) / chunks;
  return (per + kTile - 1) / kTile * kTile;
}

// The main kernel over B*chunks CTAs (f32: tail_bwd_kernel; bf16:
// tail_bwd_mma_kernel), then the weight gradients' reduction and, for
// kNodes with chunks > 1, the node sums' (node_partial [B*chunks][N][2(H+3)]
// f32 scratch; with chunks 1 the kernel writes dnodes itself).
template <typename T, int H, int kMode>
cudaError_t launch_tail(const int* src, const int* dst,
                        const uint8_t* valid, const void* ef,
                        const float* w2, const float* wc1, const float* small,
                        const void* a1, const void* xd, const void* cot,
                        void* dcat, float* dnodes, float* node_partial,
                        void* def, float* partial, float* grads, int B, int N,
                        int E, int chunks, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t bytes = (size_t)tail_smem_bytes<kMode>(H, kBf16);
  const int chunk_edges = tail_chunk_edges(E, chunks);
  const int blocks = B * chunks;
  float* node_out =
      kMode == kNodes && chunks > 1 ? node_partial : dnodes;
  cudaError_t err;
  if constexpr (kBf16) {
    auto kernel = tail_bwd_mma_kernel<H, kMode>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kMmaThreads, bytes, stream>>>(
        src, dst, valid, static_cast<const bf*>(ef), w2, wc1, small,
        static_cast<const bf*>(a1), static_cast<const bf*>(xd),
        static_cast<const bf*>(cot), static_cast<bf*>(dcat), node_out,
        static_cast<bf*>(def), partial, N, E, chunks, chunk_edges);
  } else {
    auto kernel = tail_bwd_kernel<H, kMode>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, bytes, stream>>>(
        src, dst, valid, static_cast<const float*>(ef), w2, wc1, small,
        static_cast<const float*>(a1), static_cast<const float*>(xd),
        static_cast<const float*>(cot), static_cast<float*>(dcat), node_out,
        static_cast<float*>(def), partial, N, E, chunks, chunk_edges);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = grad_width(H);
  reduce_blocks<<<(width + kReduceThreads - 1) / kReduceThreads,
                  kReduceThreads, 0, stream>>>(partial, blocks, width, grads);
  err = cudaGetLastError();
  if (err != cudaSuccess || kMode != kNodes || chunks == 1) return err;
  const int node_width = N * 2 * (H + 3);
  const dim3 grid((node_width + kReduceThreads - 1) / kReduceThreads, B);
  reduce_node_chunks<<<grid, kReduceThreads, 0, stream>>>(
      node_partial, chunks, node_width, dnodes);
  return cudaGetLastError();
}

}  // namespace egnn
