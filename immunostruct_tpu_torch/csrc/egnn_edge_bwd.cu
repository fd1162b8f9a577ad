// Backward of the EGNN edge program for Hopper (sm_90a), over pre-gathered
// edge bundles. Nothing is saved from the forward: the chain is recomputed
// from the inputs.
//
// Replaces immunostruct_tpu/ops/pallas_edge.py::_bwd_kernel (launched by
// _bwd_call; the custom VJP of edge_program keeps only the inputs). Per
// graph b, per edge e of hsx, hdx [B,F+3,E], ef [B,1,E] and the cotangent
// dout = [d_m_in (H) ; d_msgx (3)] of [m ; cw*x_hat]:
//
//   recompute  xd, radial, x_hat; a1 = W1ab^T [hs ; hd] + w1r*radial +
//              w1e*ef + b1; a1s = silu(a1); p2 = a1s@W2 + b2; m = silu(p2);
//              p3 = m@Wc1 + bc1; c1 = silu(p3); cw = c1 . wc2
//   back       d_cw = d_msgx . x_hat;  d_xhat = d_msgx * cw
//              d_p3 = wc2 * d_cw * silu'(p3);  d_m = d_m_in + Wc1 @ d_p3
//              d_p2 = d_m * silu'(p2);  d_a1 = (W2 @ d_p2) * silu'(a1)
//              d_hsd = W1ab @ d_a1
//              d_rad = w1r . d_a1 + [radial > 0] d|x_hat|/d radial
//              d_xd = d_xhat / s + 2 xd d_rad;  d_ef = w1e . d_a1
//   out        dhsx[:,e] = [d_hsd[:F] ; d_xd], dhdx[:,e] = [d_hsd[F:] ; -d_xd]
//              [B,F+3,E]; def[e] = d_ef [B,1,E]
//   sums (f32) dW1ab += [hs ; hd] (x) d_a1;  dW2 += a1s (x) d_p2;
//              dWc1 += m (x) d_p3;
//              dsmall += [d_a1*radial, d_a1*ef, d_a1, d_p2, d_p3, c1*d_cw]
//
// What bounds it on the H100: bytes. Per edge, nine products: three to
// recompute the chain (2F x H, H x H, H x H), three back through Wc1, W2
// and W1ab, and three outer products for dWc1, dW2 and dW1ab. At B=128,
// E=2560, F=H=64 that is 2*E*(3*2F*H + 6*H*H) = 252 M multiply-adds per
// graph, 32.2 GFLOP a launch: 0.033 ms at the tensor cores' bf16 peak, 0.48
// ms at the CUDA cores' f32 rate. A launch moves ~221 MB (hsx, hdx, dout
// read, dhsx, dhdx written, in bf16): 0.066 ms at 3.35 TB/s.
//
// What the design does about it:
//   - bf16 (egnn_edge_bwd_mma_kernel): all nine products on the tensor
//     cores (mma.sync m16n8k16, bf16 operands from bf16 tiles in shared
//     memory, each product added in f32: csrc/egnn_hopper.cuh), one
//     warpgroup of 128 threads a CTA; per 64-edge tile warp w owns edges
//     16w..16w+15 for the chain. Every operand is a bf16-rounded value at
//     its rounding point already (W1ab, W2, Wc1, the bundles, a1s, m, d_p3,
//     d_p2, d_a1), so no rounding moves; at F=20 the depth 2F=40 pads to 48
//     with zero rows. A value about to round to bf16 within kTieUlps f32
//     units of a rounding boundary (a1s, m, c1, d_p3, d_p2, d_a1) is
//     recomputed on the CUDA cores in the plain version's order. The
//     chain's steps are csrc/egnn_hopper.cuh's, its recompute (chain_a1,
//     chain_p2, chain_c1) shared with B3's forward;
//   - the next tile's runs of 64 bf16 along E (the bundles' [F+3] rows each
//     side, the cotangent's H+3, ef) arrive by cp.async into the other of
//     two stages while this tile computes; the bundle rows are the A operand
//     of the a1 product and of dW1ab as they land ([feature][edge], read by
//     ldmatrix and ldmatrix.trans). An E that is not a multiple of 8 is
//     read into the stage element by element instead;
//   - a1 stays in f32 in shared memory for silu'(a1); dW2 and dWc1 in
//     register fragments over a CTA's tiles; dW1ab (2F x H f32, 32 KB at
//     F=64: no room beside them in registers) in shared memory, each warp
//     adding 16-row blocks of [hs ; hd]^T . d_a1 to rows it alone owns;
//   - one CTA per (graph, edge chunk), enough CTAs to give every SM one
//     (~190 KB of shared memory at F=64: one CTA an SM); the weight
//     gradients cross CTAs: each writes its share to a [blocks, 2F*H +
//     2H^2 + 6H] f32 scratch and a second kernel sums it over CTAs in CTA
//     order. No atomics: the gradients are the same from run to run;
//   - f32 keeps the CUDA-core form (egnn_edge_bwd_kernel: register-tiled
//     FMA loops over f32 tiles, 256 threads a CTA), so its f32 bounds hold;
//     TF32 would break them.
//
// Rounding points under bf16 are the TPU kernel's (pallas_edge.py:104-256):
// W1ab/W2/Wc1 rounded; the chain recomputed with the forward's rounding
// points (xd, radial, a1s, m, c1, and cw before it meets d_msgx); d_p3,
// d_p2, d_a1 and d_hsd rounded, d_xd and d_ef by their store in the compute
// dtype; d_m and W2 @ d_p2 are f32 sums; weight gradients are f32 sums of
// products of the rounded values, dsmall's radial column against the
// rounded radial.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include "egnn_hopper.cuh"

namespace {

using namespace egnn;

constexpr int kMaxF = 64;
constexpr int kRows1 = 2 * kMaxF / 16;  // dW1ab rows per thread (f32 form)

// ---------------------------------------------------------------------------
// f32: the CUDA-core form
// ---------------------------------------------------------------------------

// shared-memory floats: W1ab 2F*(H+1) | W2, Wc1 2*H*(H+1) | small^T 6*H |
// feature tile kTile*(2F+1) | five edge-tile buffers 5*kTile*(H+1) | the
// dW1ab shares 2F*H | per-edge values 11*kTile
__host__ __device__ inline long long smem_floats(int f, int hid) {
  return 2LL * f * row_stride(hid) + 2LL * hid * row_stride(hid) +
         6LL * hid + (long long)kTile * (2 * f + 1) +
         5LL * kTile * row_stride(hid) + 2LL * f * hid + 11LL * kTile;
}

// width of one block's partial gradients: dW1ab | dW2 | dWc1 | dsmall
__host__ __device__ inline int grad_width(int f, int hid) {
  return 2 * f * hid + 2 * hid * hid + 6 * hid;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
    egnn_edge_bwd_kernel(const float* __restrict__ hsx,
                         const float* __restrict__ hdx,
                         const float* __restrict__ ef,
                         const float* __restrict__ w1ab,
                         const float* __restrict__ w2,
                         const float* __restrict__ wc1,
                         const float* __restrict__ small,
                         const float* __restrict__ dout,
                         float* __restrict__ dhsx,
                         float* __restrict__ dhdx, float* __restrict__ def,
                         float* __restrict__ partial, int E, int F,
                         int chunks, int chunk_edges) {
  constexpr int LD = row_stride(H);
  constexpr int CPT = H / 16;  // columns per thread
  static_assert(H % 16 == 0, "H must be a multiple of 16");
  const int F2 = 2 * F;
  const int LDX = F2 + 1;

  extern __shared__ float smem[];
  float* w1s = smem;                   // [2F][LD], row k = input feature k
  float* w2s = w1s + F2 * LD;          // [H][LD], row k = input unit k
  float* wc1s = w2s + H * LD;          // [H][LD]
  float* sms = wc1s + H * LD;          // [6][H] (small transposed)
  float* bufX = sms + 6 * H;           // [kTile][2F+1] [hs ; hd], then d_hsd
  float* bufA = bufX + kTile * LDX;    // [kTile][LD] a1s
  float* bufM = bufA + kTile * LD;     // [kTile][LD] m
  float* bufG = bufM + kTile * LD;     // [kTile][LD] silu'(a1), then d_a1
  float* bufP3 = bufG + kTile * LD;    // [kTile][LD] d_p3
  float* bufP2 = bufP3 + kTile * LD;   // [kTile][LD] d_m_in, then d_p2
  float* gw1 = bufP2 + kTile * LD;     // [2F][H] this CTA's dW1ab
  float* radv = gw1 + F2 * H;          // [kTile] radial
  float* invv = radv + kTile;          // [kTile] 1 / (sqrt(radial) + 1e-30)
  float* efv = invv + kTile;           // [kTile]
  float* cwv = efv + kTile;            // [kTile] cw
  float* dcwv = cwv + kTile;           // [kTile] d_cw
  float* xdv = dcwv + kTile;           // [3][kTile]
  float* dmxv = xdv + 3 * kTile;       // [3][kTile] d_msgx

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int tg = tid / 16;  // edge group: edges tg*4 .. tg*4+3 of a tile
  const int cg = tid % 16;  // column group: columns cg*CPT .. +CPT-1
  const float* hsb = hsx + (size_t)b * (F + 3) * E;
  const float* hdb = hdx + (size_t)b * (F + 3) * E;
  const float* efb = ef + (size_t)b * E;
  const float* dob = dout + (size_t)b * (H + 3) * E;
  float* dhsb = dhsx + (size_t)b * (F + 3) * E;
  float* dhdb = dhdx + (size_t)b * (F + 3) * E;
  float* defb = def + (size_t)b * E;

  // ---- weights ----
  for (int i = tid; i < F2 * H; i += kThreads) {
    w1s[(i / H) * LD + i % H] = w1ab[i];
    gw1[i] = 0.0f;
  }
  for (int i = tid; i < H * H; i += kThreads) {
    const int k = i / H, j = i % H;
    w2s[k * LD + j] = w2[i];
    wc1s[k * LD + j] = wc1[i];
  }
  for (int i = tid; i < 6 * H; i += kThreads) {
    sms[(i % 6) * H + i / 6] = small[i];
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
    // ---- [hs ; hd] features and d_m_in (coalesced: t fastest) ----
    for (int i = tid; i < F2 * kTile; i += kThreads) {
      const int k = i / kTile, t = i % kTile;
      const int e = e0 + t;
      float v = 0.0f;
      if (e < e_end) {
        v = k < F ? hsb[(size_t)k * E + e] : hdb[(size_t)(k - F) * E + e];
      }
      bufX[t * LDX + k] = v;
    }
    for (int i = tid; i < H * kTile; i += kThreads) {
      const int j = i / kTile, t = i % kTile;
      const int e = e0 + t;
      bufP2[t * LD + j] = e < e_end ? dob[(size_t)j * E + e] : 0.0f;
    }
    // ---- per-edge geometry and coordinate cotangent ----
    if (tid < kTile) {
      const int e = e0 + tid;
      float d[3] = {0.0f, 0.0f, 0.0f}, dm[3] = {0.0f, 0.0f, 0.0f}, ev = 0.0f;
      if (e < e_end) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          d[k] = hsb[(size_t)(F + k) * E + e] - hdb[(size_t)(F + k) * E + e];
          dm[k] = dob[(size_t)(H + k) * E + e];
        }
        ev = efb[e];
      }
      const float r = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const float safe = r > 0.0f ? r : 1.0f;
      radv[tid] = r;
      invv[tid] = 1.0f / (sqrtf(safe) + 1e-30f);
      efv[tid] = ev;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xdv[k * kTile + tid] = d[k];
        dmxv[k * kTile + tid] = dm[k];
      }
    }
    __syncthreads();

    // ---- a1 = W1ab^T [hs ; hd] + ... -> a1s, silu'(a1) ----
    {
      float acc[4][CPT];
      tile_product_k<H, false>(bufX, LDX, w1s, F2, tg, cg, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int t = tg * 4 + i, j = cg * CPT + c;
          float a = acc[i][c] + sms[kW1R * H + j] * radv[t];
          a = a + sms[kW1E * H + j] * efv[t];
          a = a + sms[kB1 * H + j];
          const float s = sigmoid(a);
          bufA[t * LD + j] = a * s;
          bufG[t * LD + j] = silu_grad(a, s);
        }
    }
    __syncthreads();

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[4][CPT];
    {
      float acc[4][CPT];
      tile_product_k<H, false>(bufA, LD, w2s, H, tg, cg, acc);
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
      tile_product_k<H, false>(bufM, LD, wc1s, H, tg, cg, acc);
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
      tile_product_k<H, true>(bufP3, LD, wc1s, H, tg, cg, acc);
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
      tile_product_k<H, true>(bufP2, LD, w2s, H, tg, cg, acc);
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
          const float r = radv[t], inv = invv[t], cwb = cwv[t];
          const float safe = r > 0.0f ? r : 1.0f;
          float sum_dxh_xd = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sum_dxh_xd += dmxv[k * kTile + t] * cwb * xdv[k * kTile + t];
          }
          const float d_safe = sum_dxh_xd * (-0.5f) * inv * inv / sqrtf(safe);
          const float d_rad = d_rad_chain + (r > 0.0f ? d_safe : 0.0f);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float dx = dmxv[k * kTile + t] * cwb * inv +
                             2.0f * xdv[k * kTile + t] * d_rad;
            dhsb[(size_t)(F + k) * E + e] = dx;
            dhdb[(size_t)(F + k) * E + e] = -dx;
          }
          defb[e] = d_ef;
        }
      }
    }
    __syncthreads();

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
    // ---- dW1ab += [hs ; hd] (x) d_a1: rows tg + 16*r, columns cg*CPT+c ----
    {
      float acc[kRows1][CPT];
#pragma unroll
      for (int r = 0; r < kRows1; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
      for (int t = 0; t < kTile; ++t) {
        float dv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) dv[c] = bufG[t * LD + cg * CPT + c];
#pragma unroll
        for (int r = 0; r < kRows1; ++r) {
          const int row = tg + 16 * r;
          const float xv = row < F2 ? bufX[t * LDX + row] : 0.0f;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] += xv * dv[c];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows1; ++r) {
        const int row = tg + 16 * r;
        if (row < F2) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            gw1[row * H + cg * CPT + c] += acc[r][c];
          }
        }
      }
    }
    __syncthreads();  // bufX is rewritten with d_hsd next

    // ---- d_hsd = W1ab @ d_a1 into bufX: columns in blocks of H ----
    for (int c0 = 0; c0 < F2; c0 += H) {
      float acc[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        float av[4], wv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = bufG[(tg * 4 + i) * LD + k];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + cg * CPT + c;
          wv[c] = col < F2 ? w1s[col * LD + k] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += av[i] * wv[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = c0 + cg * CPT + c;
          if (col < F2) bufX[(tg * 4 + i) * LDX + col] = acc[i][c];
        }
    }
    __syncthreads();
    // ---- d_hsd into dhsx / dhdx rows 0..F-1 (coalesced) ----
    for (int i = tid; i < F2 * kTile; i += kThreads) {
      const int k = i / kTile, t = i % kTile;
      const int e = e0 + t;
      if (e < e_end) {
        const float v = bufX[t * LDX + k];
        if (k < F) {
          dhsb[(size_t)k * E + e] = v;
        } else {
          dhdb[(size_t)(k - F) * E + e] = v;
        }
      }
    }
    __syncthreads();  // tile buffers and per-edge values are rewritten next
  }

  // ---- this block's partial gradients: dW1ab | dW2 | dWc1 | dsmall ----
  float* pb = partial + (size_t)blockIdx.x * grad_width(F, H);
  for (int i = tid; i < F2 * H; i += kThreads) pb[i] = gw1[i];
  float* p2 = pb + F2 * H;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int row = tg * 4 + r, col = cg * CPT + c;
      p2[row * H + col] = gw2[r][c];
      p2[H * H + row * H + col] = gwc1[r][c];
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
    for (int g = 0; g < 16; ++g) s += red[(g * 6 + k) * H + j];
    p2[2 * H * H + i] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

using bf2 = __nv_bfloat162;

// Byte offsets into a CTA's shared memory for node features F. A stage holds
// one tile's runs of 64 bf16 along E, each in a row of kRunBytes: the bundle
// features [hs ; hd] in rows 0..2F-1 (rows 2F..kp-1 stay zero: the depth of
// the a1 product is kp, 2F rounded up to 16), hs's and hd's coordinates in
// rows kp..kp+5, the cotangent [H+3] in rows kp+6.., ef in the last row;
// rows 0..kp-1 are the A operand [feature][edge] of the products that read
// the bundle. Then W1ab bf16 [np][kLdb] (np: 2F rounded up to 64, the
// columns of d_hsd in passes of 64), W2, Wc1 bf16 [H][kLdb], the four bf16
// tiles, a1 f32 [kTile][kLdf], dW1ab f32 [kp][kLdf], V [kTile][8] bf16
// (radial, ef, 1), small^T [6][H] f32 and the per-edge values.
struct EdgeLayout {
  int kp, np, rows, stage, w1, w2, wc1, a1s, m, dp3, dp2, a1f, gw1, v, sms,
      edge, bytes;
};

__host__ __device__ inline EdgeLayout edge_layout(int f) {
  EdgeLayout l;
  l.kp = (2 * f + 15) / 16 * 16;
  l.np = (2 * f + 63) / 64 * 64;
  l.rows = l.kp + 6 + kHidden + 3 + 1;
  l.stage = l.rows * kRunBytes;
  l.w1 = 2 * l.stage;
  l.w2 = l.w1 + l.np * kLdb * 2;
  l.wc1 = l.w2 + kHidden * kLdb * 2;
  l.a1s = l.wc1 + kHidden * kLdb * 2;
  l.m = l.a1s + kTileBytes;
  l.dp3 = l.m + kTileBytes;
  l.dp2 = l.dp3 + kTileBytes;
  l.a1f = l.dp2 + kTileBytes;
  l.gw1 = l.a1f + kTile * kLdf * 4;
  l.v = l.gw1 + l.kp * kLdf * 4;
  l.sms = l.v + kTile * 16;
  l.edge = l.sms + 6 * kHidden * 4;
  l.bytes = l.edge + kEdgeRows * kTile * 4;
  return l;
}

// Per graph b (CTAs b*chunks .. b*chunks+chunks-1, each a chunk of edges),
// the contract of egnn_edge_bwd_kernel in bf16, with the TPU kernel's
// rounding points (the header). One warpgroup; warp w owns edges
// 16w..16w+15 of a 64-edge tile for the chain and rows 16w..16w+15 of
// dW2/dWc1; the next tile's runs arrive by cp.async while this one computes
// (when E is a multiple of 8 and the tensors 16-byte aligned; otherwise each
// tile is read into its stage element by element).
template <int H>
__global__ void __launch_bounds__(kMmaThreads, 1)
    egnn_edge_bwd_mma_kernel(const bf* __restrict__ hsx,
                             const bf* __restrict__ hdx,
                             const bf* __restrict__ ef,
                             const float* __restrict__ w1ab,
                             const float* __restrict__ w2,
                             const float* __restrict__ wc1,
                             const float* __restrict__ small,
                             const bf* __restrict__ dout, bf* __restrict__ dhsx,
                             bf* __restrict__ dhdx, bf* __restrict__ def,
                             float* __restrict__ partial, int E, int F,
                             int chunks, int chunk_edges) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  constexpr int C = H + 3;
  const EdgeLayout L = edge_layout(F);
  const int F2 = 2 * F;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  unsigned char* sm = smem_mma;
  bf* w1s = reinterpret_cast<bf*>(sm + L.w1);     // [feature][j]
  bf* w2s = reinterpret_cast<bf*>(sm + L.w2);     // [k][n]
  bf* wc1s = reinterpret_cast<bf*>(sm + L.wc1);   // [k][n]
  bf* a1st = reinterpret_cast<bf*>(sm + L.a1s);   // a1s [j][t]; d_a1 [t][j]
  bf* mt = reinterpret_cast<bf*>(sm + L.m);       // m, then d_hsd [f][t]
  bf* dp3t = reinterpret_cast<bf*>(sm + L.dp3);   // d_p3 (d_hsd rows 64..)
  bf* dp2t = reinterpret_cast<bf*>(sm + L.dp2);
  float* a1f = reinterpret_cast<float*>(sm + L.a1f);  // a1 [t][kLdf]
  float* gw1 = reinterpret_cast<float*>(sm + L.gw1);  // dW1ab [kp][kLdf]
  bf* vt = reinterpret_cast<bf*>(sm + L.v);           // [t][8]
  float* sms = reinterpret_cast<float*>(sm + L.sms);
  float* ev = reinterpret_cast<float*>(sm + L.edge);

  const int b = blockIdx.x / chunks;
  const int e_begin = (blockIdx.x % chunks) * chunk_edges;
  const int e_end = min(E, e_begin + chunk_edges);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fq = lane & 3;  // fragment row, column pair
  const int m0 = warp * 16;
  const int rx = L.kp, rc = L.kp + 6, re = L.kp + 6 + C;  // stage rows
  const bf* hsb = hsx + (size_t)b * (F + 3) * E;
  const bf* hdb = hdx + (size_t)b * (F + 3) * E;
  const bf* efb = ef + (size_t)b * E;
  const bf* dob = dout + (size_t)b * C * E;
  bf* dhsb = dhsx + (size_t)b * (F + 3) * E;
  bf* dhdb = dhdx + (size_t)b * (F + 3) * E;
  bf* defb = def + (size_t)b * E;
  // runs start 16-byte aligned: cp.async takes them whole
  const bool aligned =
      (E & 7) == 0 &&
      ((reinterpret_cast<uintptr_t>(hsx) | reinterpret_cast<uintptr_t>(hdx) |
        reinterpret_cast<uintptr_t>(ef) | reinterpret_cast<uintptr_t>(dout)) &
       15) == 0;
  // the tensor row that stage row r holds (null: a zero row)
  auto row_src = [&](int r) -> const bf* {
    if (r < F) return hsb + (size_t)r * E;
    if (r < F2) return hdb + (size_t)(r - F) * E;
    if (r < rx) return nullptr;
    if (r < rx + 3) return hsb + (size_t)(F + r - rx) * E;
    if (r < rc) return hdb + (size_t)(F + r - rx - 3) * E;
    if (r < re) return dob + (size_t)(r - rc) * E;
    return efb;
  };

  // ---- weights, rounded to bf16 by their store; zero rows ----
  for (int i = tid; i < L.np * H; i += kMmaThreads) {
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
  for (int i = tid; i < L.kp * kLdf; i += kMmaThreads) gw1[i] = 0.0f;
  for (int i = tid; i < 2 * (L.kp - F2) * kTile; i += kMmaThreads) {
    const int s = i / ((L.kp - F2) * kTile), r = i % ((L.kp - F2) * kTile);
    reinterpret_cast<bf*>(sm + s * L.stage + (F2 + r / kTile) * kRunBytes)
        [r % kTile] = __float2bfloat16(0.0f);
  }

  // the weight gradients: dW2/dWc1 rows m0.., as fragments; db2, dbc1 and
  // dwc2 over this thread's 16 columns (index 2*nt + i%2); dw1r, dw1e, db1
  // as the fragment of d_a1^T . V; dW1ab in shared memory
  float gw2[8][4], gwc1[8][4], gv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float gb2[16], gbc1[16], gwc2[16];
  zero(gw2);
  zero(gwc1);
#pragma unroll
  for (int c = 0; c < 16; ++c) gb2[c] = gbc1[c] = gwc2[c] = 0.0f;

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
  __syncthreads();  // weights, zero rows and dW1ab's zeros
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
      // those rows of every product are finite and add nothing
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
    // a1 of tile edge t, column j, as the plain version sums it; a1 as the
    // chain's backward reads it; the cotangent d_m_in
    auto a1_tie = [&](int t, int j) {
      return a1_exact(xt, w1s, F2, sms, ev, t, j);
    };
    auto a1_of = [&](int t, int j) { return a1f[t * kLdf + j]; };
    auto dm_in = [&](int t, int j) { return at(rc + j, t); };

    // ---- per edge: geometry, d_msgx, d_cw; V ----
    if (tid < kTile) {
      const int t = tid;
      float d[3], dm[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        d[k] = rnd<bf>(at(rx + k, t) - at(rx + 3 + k, t));
        dm[k] = at(rc + H + k, t);
      }
      const float efv = at(re, t);
      const float r = rnd<bf>(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const float safe = r > 0.0f ? r : 1.0f;
      const float inv = 1.0f / (sqrtf(safe) + 1e-30f);
      ev[kERad * kTile + t] = r;
      ev[kEInv * kTile + t] = inv;
      ev[kEEf * kTile + t] = efv;
      // d_cw = d_msgx . x_hat, x_hat = xd / (sqrt(radial) + 1e-30)
      ev[kEDcw * kTile + t] =
          dm[0] * (d[0] * inv) + dm[1] * (d[1] * inv) + dm[2] * (d[2] * inv);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        ev[(kEXd + k) * kTile + t] = d[k];
        ev[(kEDmx + k) * kTile + t] = dm[k];
      }
      store_pair(vt + t * 8 + 0, r, efv);
      store_pair(vt + t * 8 + 2, 1.0f, 0.0f);
      store_pair(vt + t * 8 + 4, 0.0f, 0.0f);
      store_pair(vt + t * 8 + 6, 0.0f, 0.0f);
    }
    __syncthreads();

    // ---- a1 = [hs ; hd] @ W1ab + w1r*radial + w1e*ef + b1 -> a1s [j][t];
    // a1 kept in f32 for silu'(a1) ----
    chain_a1(xt, w1s, L.kp, F2, sms, ev, a1st, a1f, m0, lane);
    __syncwarp();

    // ---- p2 = a1s @ W2 + b2 -> m; keep silu'(p2) ----
    float g2[8][4];
    chain_p2(a1st, w2s, sms, mt, m0, lane, g2);
    __syncwarp();

    // ---- p3 = m @ Wc1 + bc1 -> c1, cw; d_p3 = wc2 * d_cw * silu'(p3) ----
    chain_c1<true>(mt, wc1s, sms, ev, dp3t, m0, lane, gbc1, gwc2);
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
    __syncthreads();  // a1s, m and d_p3 are read; their tiles turn over

    // ---- d_a1 = (W2 @ d_p2) * silu'(a1); d_xd, d_ef ----
    {
      float prad[2] = {0.0f, 0.0f}, pef[2] = {0.0f, 0.0f};
      chain_da1(da_acc, dp2t, w2s, sms, a1_of, a1_tie, a1st, m0, lane,
                prad, pef);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d_rad_chain = sum4(prad[h]);
        const float d_ef = sum4(pef[h]);
        const int t = m0 + fr + 8 * h;
        if (fq == 0 && t < n) {
          edge_dxd(ev, t, true, d_rad_chain);
          defb[e0 + t] = __float2bfloat16(d_ef);
        }
      }
    }
    __syncthreads();  // d_a1 [t][j] of every edge

    // ---- dw1r, dw1e, db1 += d_a1^T . [radial, ef, 1] ----
    chain_dsmall_v(a1st, vt, m0, lane, gv);
    // ---- dW1ab += [hs ; hd]^T . d_a1: 16-row blocks of it, one warp each,
    // added to the f32 sums in shared memory (rows 2F.. add zeros) ----
    for (int blk = warp; blk < L.kp / 16; blk += kMmaThreads / 32) {
      float acc[8][4];
      zero(acc);
      warp_product<false, true>(xt, a1st, blk * 16, lane, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* g = reinterpret_cast<float2*>(
              gw1 + (blk * 16 + fr + 8 * h) * kLdf + nt * 8 + 2 * fq);
          float2 s = *g;
          s.x += acc[nt][2 * h];
          s.y += acc[nt][2 * h + 1];
          *g = s;
        }
    }
    // ---- d_hsd = d_a1 @ W1ab^T, rounded, into the m and d_p3 tiles (one
    // run of np x kLdb) as [feature][t] (columns in passes of 64) ----
    bf* hsdt = mt;
    for (int p = 0; p < L.np / 64; ++p) {
      float acc[8][4];
      zero(acc);
      warp_product<false, false>(a1st, w1s + p * 64 * kLdb, m0, lane, acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = m0 + fr + 8 * (i >> 1);
          const int f = p * 64 + nt * 8 + 2 * fq + (i & 1);
          hsdt[f * kLdb + t] = __float2bfloat16(acc[nt][i]);
        }
    }
    __syncthreads();  // d_hsd and d_xd of every edge

    // ---- dhsx = [d_hsd[:F] ; d_xd], dhdx = [d_hsd[F:] ; -d_xd]: warp w
    // takes rows w, w+4, ..; lane l edges 2l, 2l+1 (one 32-bit store when
    // E is even) ----
    for (int k = warp; k < 2 * (F + 3); k += kMmaThreads / 32) {
      const int side = k >= F + 3, kk = k - side * (F + 3);
      const int t = 2 * lane;
      bf2 v;
      if (kk < F) {
        v = *reinterpret_cast<const bf2*>(hsdt + (side * F + kk) * kLdb + t);
      } else {
        const float* dx = ev + (kEDxd + kk - F) * kTile + t;
        v = side == 0 ? __floats2bfloat162_rn(dx[0], dx[1])
                      : __floats2bfloat162_rn(-dx[0], -dx[1]);
      }
      bf* row = (side == 0 ? dhsb : dhdb) + (size_t)kk * E + e0 + t;
      if ((E & 1) == 0 && t + 1 < n) {
        *reinterpret_cast<bf2*>(row) = v;
      } else {
        if (t < n) row[0] = v.x;
        if (t + 1 < n) row[1] = v.y;
      }
    }
    __syncthreads();  // the stage, the tiles and the per-edge values turn over
  }
  cp_async_wait<0>();

  // ---- this CTA's partial gradients: dW1ab | dW2 | dWc1 | dsmall [H][6] ----
  float* pb = partial + (size_t)blockIdx.x * grad_width(F, H);
  for (int i = tid; i < F2 * H; i += kMmaThreads) {
    pb[i] = gw1[(i / H) * kLdf + i % H];
  }
  store_chain_partials(pb + F2 * H, gw2, gwc1, gv, gb2, gbc1, gwc2,
                       reinterpret_cast<float*>(sm + L.a1s), tid);
}

// grads[i] = sum over blocks, in block order, of partial[block][i]
__global__ void __launch_bounds__(kReduceThreads)
    egnn_edge_bwd_reduce(const float* __restrict__ partial, int blocks,
                         int width, float* __restrict__ grads) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  float s = 0.0f;
  for (int k = 0; k < blocks; ++k) s += partial[(size_t)k * width + i];
  grads[i] = s;
}

// shared memory of one CTA of the main kernel: the f32 or the bf16 form
inline long long smem_bytes(int f, int hid, bool bf16) {
  return bf16 ? edge_layout(f).bytes
              : smem_floats(f, hid) * (long long)sizeof(float);
}

// The main kernel over B*chunks CTAs (f32: egnn_edge_bwd_kernel; bf16:
// egnn_edge_bwd_mma_kernel), then the weight gradients' reduction.
template <typename T, int H>
cudaError_t launch(const void* hsx, const void* hdx, const void* ef,
                   const float* w1ab, const float* w2, const float* wc1,
                   const float* small, const void* dout, void* dhsx,
                   void* dhdx, void* def, float* partial, float* grads, int B,
                   int E, int F, int chunks, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const size_t bytes = (size_t)smem_bytes(F, H, kBf16);
  // edges per chunk: a whole number of tiles
  const int per = (E + chunks - 1) / chunks;
  const int chunk_edges = (per + kTile - 1) / kTile * kTile;
  const int blocks = B * chunks;
  cudaError_t err;
  if constexpr (kBf16) {
    auto kernel = egnn_edge_bwd_mma_kernel<H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kMmaThreads, bytes, stream>>>(
        static_cast<const bf*>(hsx), static_cast<const bf*>(hdx),
        static_cast<const bf*>(ef), w1ab, w2, wc1, small,
        static_cast<const bf*>(dout), static_cast<bf*>(dhsx),
        static_cast<bf*>(dhdx), static_cast<bf*>(def), partial, E, F, chunks,
        chunk_edges);
  } else {
    auto kernel = egnn_edge_bwd_kernel<H>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, bytes, stream>>>(
        static_cast<const float*>(hsx), static_cast<const float*>(hdx),
        static_cast<const float*>(ef), w1ab, w2, wc1, small,
        static_cast<const float*>(dout), static_cast<float*>(dhsx),
        static_cast<float*>(dhdx), static_cast<float*>(def), partial, E, F,
        chunks, chunk_edges);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int width = grad_width(F, H);
  egnn_edge_bwd_reduce<<<(width + kReduceThreads - 1) / kReduceThreads,
                         kReduceThreads, 0, stream>>>(partial, blocks, width,
                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA of the main kernel needs for node features F,
// hidden width H and the compute dtype (bf16 != 0: bfloat16, else float32).
long long egnn_edge_bwd_smem_bytes(int F, int H, int bf16) {
  return smem_bytes(F, H, bf16 != 0);
}

// CTAs of the main kernel that fit on one SM at once for node features F,
// hidden width H and the compute dtype (the occupancy calculator's count),
// or -1 on a CUDA error.
int egnn_edge_bwd_ctas_per_sm(int F, int H, int bf16) {
  const int bytes = (int)smem_bytes(F, H, bf16 != 0);
  int n = 0;
  cudaError_t err;
  if (bf16) {
    auto kernel = egnn_edge_bwd_mma_kernel<kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, kMmaThreads, bytes);
    }
  } else {
    auto kernel = egnn_edge_bwd_kernel<kHidden>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                          kThreads, bytes);
    }
  }
  return err == cudaSuccess ? n : -1;
}

// One backward: B*chunks CTAs (256 threads in f32, 128 in bf16), then the
// reduction, both on `stream`. hsx/hdx [B,F+3,E], ef [B,1,E] and dout
// [B,H+3,E] in the compute dtype (bf16 != 0: bfloat16, else float32);
// w1ab [2F,H], w2/wc1 [H,H], small [H,6] f32. Writes dhsx/dhdx [B,F+3,E]
// and def [B,1,E] in the compute dtype and grads = dW1ab [2F,H] | dW2
// [H,H] | dWc1 [H,H] | dsmall [H,6] in f32; partial [B*chunks, 2F*H + 2H^2
// + 6H] f32 is scratch. Returns the cudaError_t of the launches (0 on success).
int egnn_edge_bwd(const void* hsx, const void* hdx, const void* ef,
                  const void* w1ab, const void* w2, const void* wc1,
                  const void* small, const void* dout, void* dhsx, void* dhdx,
                  void* def, void* partial, void* grads, int B, int E, int F,
                  int H, int chunks, int bf16, void* stream) {
  if (B < 1 || E < 1 || F < 1 || F > kMaxF || H != kHidden || chunks < 1) {
    return cudaErrorInvalidValue;
  }
  const float* pw1 = static_cast<const float*>(w1ab);
  const float* pw2 = static_cast<const float*>(w2);
  const float* pwc1 = static_cast<const float*>(wc1);
  const float* psm = static_cast<const float*>(small);
  float* pp = static_cast<float*>(partial);
  float* pg = static_cast<float*>(grads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm,
                                          dout, dhsx, dhdx, def, pp, pg, B, E,
                                          F, chunks, st);
  }
  return launch<float, kHidden>(hsx, hdx, ef, pw1, pw2, pwc1, psm, dout, dhsx,
                                dhdx, def, pp, pg, B, E, F, chunks, st);
}

}  // extern "C"
