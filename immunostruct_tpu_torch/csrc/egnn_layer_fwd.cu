// B7: one whole EGNN layer forward in one kernel, for Hopper (sm_90a).
//
// Replaces immunostruct_tpu/ops/experimental/pallas_egnn.py::
// _fused_layer_kernel (launched by fused_egnn_layer). Forward only. For
// each graph b, from the raw edge indices and mask, with the edge features
// taken as all ones (their weight row folded into the bias):
//   h_src = h[src], h_dst = h[dst]       zeros on a side whose index is
//                                        masked or outside [0, N)
//   x_diff = rnd(xc[src] - xc[dst])      xc: x in the compute dtype
//   radial = rnd(|x_diff|^2), x_hat = x_diff / (sqrt(radial) + 1e-30)
//   z1 = rnd(h_src @ W_src) + rnd(h_dst @ W_dst) + radial * w_rad + w_ef
//        + be1
//   m1 = rnd(silu(z1)); m = rnd(silu(m1 @ We2 + be2))
//   c1 = rnd(silu(m @ Wc1 + bc1)); cw = rnd(c1 . wc2)
//   msg_x = rnd(cw * x_hat)
//   acc[dst] += m, accx[dst] += msg_x    f32, only where dst lies in [0, N)
//                                        and the edge is not masked
//   a = node_silu(rnd(h @ Wn1_top + rnd(acc) @ Wn1_bot + bn1))  (each step
//       of silu rounded: 1 / (1 + exp(-z)), then the product)
//   h' = rnd(a @ Wn2 + bn2)              the compute dtype
//   x' = x + rnd(accx)                   in x's own dtype
// These are the rounding points of the 'mega' forward that B7 serves in
// place of (B1's, ops/mega.py, then the node update of ops/egnn.py), not
// those of the TPU kernel (pallas_egnn.py:56-125), which keeps the
// projections, x_diff, cw and accx unrounded and rounds the biases: on
// trained weights those roundings part B7's probabilities from the 'mega'
// forward's by up to 0.085 in bf16 (PERF.md §6). The weights arrive in f32:
// the matrices are rounded to the compute dtype where they are staged, the
// biases, w_rad, wc2 and w_ef = we1[2F+1] stay f32, as B1 keeps them, and
// w_ef (the all-ones edge feature's row) then be1 are added to z1 in B1's
// order; every product accumulates in f32.
//
// What bounds it on the H100: per computed edge four [., 64] x [64, 64]
// products (the edge MLP's first layer per edge, not projection-first as
// in B1, then We2 and Wc1), plus the node MLP's two per node: 10.6 GFLOP at
// B=128, N=288, E=2560, F=64, 0.011 ms at the bf16 tensor-core peak, above
// its 12.9 MB of bytes. One CTA a graph (the TPU kernel's grid) would leave
// a B=1 request on one SM.
//
// Design, bf16 h (egnn_layer_fwd_mma_kernel): a graph over a thread-block
// cluster of 1 to 8 CTAs of 256 threads (ops/fused_layer.py
// layer_cluster_size: one wave of CTAs, at least two 64-edge tiles a CTA;
// 1 at B=128 on 132 SMs, 8 at B=1). Each CTA
//   - takes an edge chunk: its 64-edge tiles alternate between two
//     warpgroups; a warpgroup gathers its next tile's rows h[src] and
//     h[dst] (bf16, by cp.async where the rows start on 16 bytes; a zero
//     row for a side that is masked or out of range) into its stage and
//     forms the geometry while the other computes. The projections h_src .
//     W_src and h_dst . W_dst (depth F padded to 16 each) run per edge on
//     mma.sync, by ldmatrix from the stage, in f32, each rounded (the
//     first held packed while the second accumulates); silu(z1), m and c1
//     pass from accumulator to A operand in registers; We2 and Wc1 are
//     mma.sync too. The weights are rounded to bf16 where they are staged
//     in shared memory (edge phase: W1, We2, Wc1; node phase: Wn1, Wn2, in
//     the same place). The sums at dst take no atomics: B1's
//     scheme (csrc/egnn_mega.cuh sum_tile_ordered), each (n, c) summed in
//     f32 from +0 in tile and slot order into the CTA's own node block;
//   - after cluster.sync(), takes a range of nodes, sums the cluster's
//     node blocks for them through distributed shared memory in rank order
//     (the same bits every run), forms x' and the A tile [h | rnd(agg)],
//     and runs the node MLP on mma.sync in 64-row blocks.
// h is gathered from device memory (L2), not held in shared memory: the f32
// node block, the staged weights and the stages leave room for N up to 543
// at F=64 (the CUDA-core form, h resident: 477) and 576 at F=20 (608).
// Every value the plain version rounds is rounded as it rounds it, in its
// order where it lies near a bf16 tie, by B1's scheme (egnn_hopper.cuh
// near_tie): the edge chain's sigmoids run on the special-function unit
// (sigmoid_fast, a few units in the last place from the IEEE quotient),
// and a projection, m1, m or c1 within kTieUlps of a tie is recomputed on
// the CUDA cores as the plain version computes it (redo_ties: dot_n over
// the staged row, dot_row over m1's or m's f32 row in the stage, in k
// order, as projection_in_order sums it; the IEEE sigmoid); cw sums its
// products op by op in B1's lane order; zn is recomputed within
// kZnTieUlps. The node MLP's silu (node_silu, four roundings) turns one
// flipped rounding upstream into up to two bf16 steps of a, so on trained
// weights a flip moves a served probability past the 'mega' forward's
// (1.3e-3 with the edge chain unrecomputed). scripts/torch_kernel_ties.py
// --kernel layer_fwd reads how near the bounds it comes.
//
// The f32 form (egnn_layer_fwd_kernel) keeps the CUDA cores, so its f32
// bounds hold: one CTA per graph (grid B, as the TPU kernel's grid), 256
// threads, 64-edge tiles (egnn_common.cuh's thread layout: 16 edge groups
// of 4 edges x 16 column groups of 4 columns). Shared memory holds h and x,
// the f32 sums acc [N][H] and accx [N][3], two tile buffers and the tile's
// geometry: 192,268 B at N=288, F=H=64, checked against the card's
// per-block limit by the wrapper. The weight matrices stay in device memory
// and are read through L1. Each index is tested against [0, N) before any
// load; a side out of range reads a zero row. The sums at dst take no
// atomics: one thread per column adds the tile's edges in edge order. Then
// a barrier and the node MLP in the same CTA, in 64-row blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (immunostruct_tpu_torch/ops/_build.py).

#include <cooperative_groups.h>

#include "egnn_mega.cuh"

namespace {

using namespace egnn;

// zn within kZnTieUlps f32 units in the last place of a bf16 rounding
// boundary (egnn_hopper.cuh's near_tie with a wider window): the tensor
// cores' sum of zn's F + H products can lie that far from the plain
// version's sum in k order where the products cancel, and a zn rounded the
// other way moves a by up to two bf16 steps through the node MLP's silu
// (node_silu rounds four times), so more than a step of h'
constexpr int kZnTieUlps = 1024;

__device__ __forceinline__ bool near_zn_tie(float v) {
  return ((__float_as_uint(v) + unsigned(kZnTieUlps - 0x8000)) & 0xffffu) <=
         unsigned(2 * kZnTieUlps);
}

// a row of f32 values that are bf16 numbers (m1's or m's, in the stage)
// times column j of a staged bf16 matrix, summed in k order as the plain
// version's projection_in_order sums it (each product exact in f32)
__device__ __forceinline__ float dot_row(const float* a, const bf* b, int K) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    acc = fmaf(a[k], __bfloat162float(b[k * kLdb]), acc);
  }
  return acc;
}

// B1's near-tie recompute (egnn_hopper.cuh) on a warp's fragment v: the
// values within kTieUlps of a bf16 rounding boundary are marked without a
// branch (bit 4 * nt + i), then, only where the mask is not empty, each is
// replaced by redo(t, j), its tile edge t and column j computed in the
// plain version's order
template <typename Redo>
__device__ __forceinline__ void redo_ties(float (&v)[8][4], int m0, int fr,
                                          int fq, Redo redo) {
  unsigned tie = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tie |= unsigned(near_tie(v[nt][i])) << (4 * nt + i);
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    set_at(v, i, redo(tie_edge(m0, fr, i), tie_col(i, fq)));
  }
}

// the node MLP's silu as the 'mega' forward's node update computes it
// (ops/nnp.py::silu, jax.nn.silu's rounding points): a = v * s with s =
// 1 / (1 + exp(-v)), each of exp, the sum, the quotient and the product
// rounded to T (in f32: v * sigmoid(v))
template <typename T>
__device__ __forceinline__ float node_silu(float v) {
  const float e = rnd<T>(expf(-v));
  const float s = rnd<T>(__frcp_rn(rnd<T>(__fadd_rn(1.0f, e))));
  return rnd<T>(__fmul_rn(v, s));
}

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
constexpr int kWEf = 0, kWRad = 1, kBe2 = 2, kBc1 = 3, kWc2 = 4, kBn1 = 5,
              kBn2 = 6, kBe1 = 7, kVecs = 8;

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
    // the all-ones edge feature's row and the bias, added in B1's order
    vec[kWEf * H + j] = to_f(w.w_ef[j]);
    vec[kBe1 * H + j] = to_f(w.be1[j]);
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
      const float d0 = rnd<T>(__fsub_rn(xc[s * 3 + 0], xc[d * 3 + 0]));
      const float d1 = rnd<T>(__fsub_rn(xc[s * 3 + 1], xc[d * 3 + 1]));
      const float d2 = rnd<T>(__fsub_rn(xc[s * 3 + 2], xc[d * 3 + 2]));
      const float r = rnd<T>(__fadd_rn(
          __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)));
      const float den = __fadd_rn(sqrtf(r > 0.0f ? r : 1.0f), 1e-30f);
      xh[tid * 3 + 0] = __fdiv_rn(d0, den);
      xh[tid * 3 + 1] = __fdiv_rn(d1, den);
      xh[tid * 3 + 2] = __fdiv_rn(d2, den);
      rad[tid] = r;
      srow[tid] = s;
      drow[tid] = d;
      dok[tid] = ok;
    }
    __syncthreads();

    // ---- z1 = rnd(h_src @ W_src) + rnd(h_dst @ W_dst) + radial * w_rad
    // + w_ef + be1 ----
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
              __fadd_rn(
                  __fadd_rn(__fadd_rn(rnd<T>(za[i][c]), rnd<T>(zb[i][c])),
                            __fmul_rn(rad[t], vec[kWRad * H + j])),
                  vec[kWEf * H + j]),
              vec[kBe1 * H + j]);
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
        const float cw = rnd<T>(sum16(part));
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
          const float zn = rnd<T>(
              __fadd_rn(__fadd_rn(za[i][c], zb[i][c]), vec[kBn1 * H + j]));
          bufA[t * LD + j] = node_silu<T>(zn);
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

  // ---- x' = x + rnd(accx), in x's own dtype ----
  for (int i = tid; i < N * 3; i += kThreads) {
    x_out[(size_t)b * N * 3 + i] = from_f<XT>(to_f(xb[i]) + rnd<T>(accx[i]));
  }
}

// ---------------------------------------------------------------------------
// bf16 h: the tensor-core form, a graph over a thread-block cluster
// ---------------------------------------------------------------------------

// rows of the per-graph vectors of the tensor-core form (f32, [kMVecs][H])
constexpr int kMWEf = 0, kMWRad = 1, kMBe2 = 2, kMBc1 = 3, kMWc2 = 4,
              kMBn1 = 5, kMBn2 = 6, kMBe1 = 7, kMVecs = 8;

__host__ __device__ inline int pad16(int f) { return (f + 15) / 16 * 16; }

constexpr int kMaxCluster = 8;  // the portable thread-block cluster size

// byte offsets into a CTA's shared memory: the f32 node block [N][H+3] (its
// edge chunk's sums), x in the compute dtype as f32 [N+1][3] (row N zeros),
// the weights bf16 [.][kLdb] (edge phase: W1 = [W_src ; W_dst], each padded
// with zero rows to Fp = F rounded up to 16, then We2 and Wc1; node phase:
// Wn1 = [Wn1_top padded to Fp ; Wn1_bot], then Wn2), the per-graph vectors,
// the two warpgroups' stages (the gathered rows h[src] then h[dst] of a
// tile's edges, bf16 [kTile][kLdb]; node phase: the A tile [64][Fp+H+8] and
// the a tile [64][kLdb]) and geometries
struct LayerLayout {
  int xc, w, vec, stage, geo, bytes;
};

__host__ __device__ inline LayerLayout layer_layout(int n, int f) {
  const int fp = pad16(f);
  LayerLayout l;
  l.xc = (4 * n * (kHidden + 3) + 15) / 16 * 16;
  l.w = l.xc + (12 * (n + 1) + 15) / 16 * 16;
  l.vec = l.w + (2 * fp + 2 * kHidden) * kLdb * 2;
  l.stage = l.vec + kMVecs * kHidden * 4;
  l.geo = l.stage + 2 * 2 * kTileBytes;
  l.bytes = l.geo + 2 * geometry_floats() * 4;
  return l;
}

// Per cluster of `cluster` CTAs a graph (blockIdx.x / cluster), CTA rank r:
//   1. the edge tiles of chunk r (ceil(tiles / cluster) tiles a chunk): per
//      tile its edges' rows h[src] and h[dst] gathered into the stage, the
//      projections on mma.sync, m1 = silu(z1), m and c1 on
//      mma.sync, cw and the coordinate message, summed into this CTA's node
//      block in tile and slot order (egnn_mega.cuh mma_edge_chunk's scheme);
//   2. cluster.sync();
//   3. nodes r*R .. (R = ceil(N / cluster)): each (n, c) summed over the
//      cluster's node blocks through distributed shared memory, in rank
//      order from +0; x' = x + accx; agg rounded into the A tile [h | agg];
//      the node MLP on mma.sync in 64-row blocks; h' and x' stored;
//   4. cluster.sync(), so that no CTA leaves while another reads its block.
template <typename XT, int H>
__global__ void __launch_bounds__(kFwdThreads, 1)
    egnn_layer_fwd_mma_kernel(const int* __restrict__ src,
                              const int* __restrict__ dst,
                              const uint8_t* __restrict__ mask,
                              const bf* __restrict__ h,
                              const XT* __restrict__ x,
                              const float* __restrict__ weights,
                              bf* __restrict__ h_out, XT* __restrict__ x_out,
                              int N, int E, int F) {
  static_assert(H == kHidden, "the tensor-core form is written for H = 64");
  constexpr int C = H + 3;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int Fp = pad16(F);
  const LayerLayout Y = layer_layout(N, F);
  extern __shared__ __align__(16) unsigned char smem_layer[];
  unsigned char* sm = smem_layer;
  float* acc = reinterpret_cast<float*>(sm);               // [N][C]
  float* xc = reinterpret_cast<float*>(sm + Y.xc);         // [N+1][3]
  bf* w1s = reinterpret_cast<bf*>(sm + Y.w);               // [2Fp][kLdb]
  bf* we2s = w1s + 2 * Fp * kLdb;                          // [H][kLdb]
  bf* wc1s = we2s + H * kLdb;                              // [H][kLdb]
  bf* wn1s = w1s;                                          // [Fp+H][kLdb]
  bf* wn2s = wn1s + (Fp + H) * kLdb;                       // [H][kLdb]
  float* vec = reinterpret_cast<float*>(sm + Y.vec);       // [kMVecs][H]
  unsigned char* stage = sm + Y.stage;

  const int b = blockIdx.x / ranks;
  const int tid = threadIdx.x;
  const int wg = tid / kMmaThreads, wtid = tid % kMmaThreads;
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fq = lane & 3;
  const int m0 = (wtid >> 5) * 16;
  const Weights<float> w = carve_weights(weights, F, H);
  const int* srcb = src + (size_t)b * E;
  const int* dstb = dst + (size_t)b * E;
  const uint8_t* maskb = mask + (size_t)b * E;
  const bf* hb = h + (size_t)b * N * F;
  const XT* xb = x + (size_t)b * N * 3;

  // ---- the node block, x in the compute dtype, the vectors, the edge
  // phase's weights ----
  for (int i = tid; i < N * C; i += kFwdThreads) acc[i] = 0.0f;
  for (int i = tid; i < (N + 1) * 3; i += kFwdThreads) {
    xc[i] = i < N * 3 ? rnd<bf>(to_f(xb[i])) : 0.0f;
  }
  for (int j = tid; j < H; j += kFwdThreads) {
    // the all-ones edge feature's row and the bias, added in B1's order
    vec[kMWEf * H + j] = to_f(w.w_ef[j]);
    vec[kMBe1 * H + j] = to_f(w.be1[j]);
    vec[kMWRad * H + j] = to_f(w.w_rad[j]);
    vec[kMBe2 * H + j] = to_f(w.be2[j]);
    vec[kMBc1 * H + j] = to_f(w.bc1[j]);
    vec[kMWc2 * H + j] = to_f(w.wc2[j]);
    vec[kMBn1 * H + j] = to_f(w.bn1[j]);
    vec[kMBn2 * H + j] = to_f(w.bn2[j]);
  }
  const bf bf_zero = __float2bfloat16(0.0f);
  // rows of H f32 weights (16-byte pieces; the packed layer's matrices
  // start on 16 bytes) rounded into bf16 rows of kLdb, or zero rows where
  // src is null
  auto stage_rows = [&](bf* to, const float* src, int rows) {
    for (int i = tid; i < rows * (H / 8); i += kFwdThreads) {
      const int r = i / (H / 8), c = i % (H / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src != nullptr) {
        const float4 lo = *reinterpret_cast<const float4*>(src + r * H + c * 8);
        const float4 hi =
            *reinterpret_cast<const float4*>(src + r * H + c * 8 + 4);
        v = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                       pack2(hi.z, hi.w));
      }
      *reinterpret_cast<uint4*>(to + r * kLdb + c * 8) = v;
    }
  };
  stage_rows(w1s, w.w_src, F);
  stage_rows(w1s + F * kLdb, nullptr, Fp - F);
  stage_rows(w1s + Fp * kLdb, w.w_dst, F);
  stage_rows(w1s + (Fp + F) * kLdb, nullptr, Fp - F);
  stage_rows(we2s, w.we2, H);
  stage_rows(wc1s, w.wc1, H);
  __syncthreads();

  // ---- 1. the edge tiles of this CTA's chunk ----
  const int tiles = (E + kTile - 1) / kTile;
  const int per = (tiles + ranks - 1) / ranks;
  const int t_begin = min(tiles, rank * per);
  const int ntiles = min(tiles, t_begin + per) - t_begin;
  unsigned char* st = stage + wg * 2 * kTileBytes;
  bf* hsrc = reinterpret_cast<bf*>(st);                    // [t][kLdb]
  bf* hdst = reinterpret_cast<bf*>(st + kTileBytes);       // [t][kLdb]
  const TileGeometry g = carve_geometry(
      reinterpret_cast<float*>(sm + Y.geo) + wg * geometry_floats());
  const bool aligned = F % 8 == 0;  // h rows start on 16 bytes

  // the features of node n (N: zeros) into a stage row, Fp columns (zeros
  // from F on): by cp.async where the rows start on 16 bytes
  auto gather_row = [&](bf* row, int n) {
    const bf* hr = hb + (size_t)n * F;
    for (int c = 0; c < Fp / 8; ++c) {
      if (n < N && aligned && 8 * c < F) {
        cp_async16(row + 8 * c, hr + 8 * c);
      } else {
        unsigned v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int f = 8 * c + 2 * u;
          __nv_bfloat162 pair = __halves2bfloat162(
              n < N && f < F ? hr[f] : bf_zero,
              n < N && f + 1 < F ? hr[f + 1] : bf_zero);
          v[u] = *reinterpret_cast<const unsigned*>(&pair);
        }
        *reinterpret_cast<uint4*>(row + 8 * c) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  // the tile's slots (threads wtid < kTile of the warpgroup): indices
  // tested before any load, the rows gathered, the geometry formed
  auto load_tile = [&](int it) {
    if (wtid < kTile) {
      const int e = (t_begin + it) * kTile + wtid;
      int s = N, d = N, ok = 0;
      if (e < E && maskb[e] != 0) {
        const int si = srcb[e], di = dstb[e];
        if (si >= 0 && si < N) s = si;
        if (di >= 0 && di < N) {
          d = di;
          ok = 1;
        }
      }
      gather_row(hsrc + wtid * kLdb, s);
      gather_row(hdst + wtid * kLdb, d);
      const float d0 = rnd<bf>(__fsub_rn(xc[s * 3 + 0], xc[d * 3 + 0]));
      const float d1 = rnd<bf>(__fsub_rn(xc[s * 3 + 1], xc[d * 3 + 1]));
      const float d2 = rnd<bf>(__fsub_rn(xc[s * 3 + 2], xc[d * 3 + 2]));
      const float r = rnd<bf>(__fadd_rn(
          __fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)));
      const float den = __fadd_rn(sqrtf(r > 0.0f ? r : 1.0f), 1e-30f);
      g.xh[wtid * 3 + 0] = __fdiv_rn(d0, den);
      g.xh[wtid * 3 + 1] = __fdiv_rn(d1, den);
      g.xh[wtid * 3 + 2] = __fdiv_rn(d2, den);
      g.rad[wtid] = r;
      g.dst[wtid] = d;
      g.ok[wtid] = ok;
    }
    cp_async_commit();
  };
  if (wg < ntiles) load_tile(wg);

  for (int it = wg; it < ntiles; it += 2) {
    cp_async_wait<0>();
    wg_sync(wg);  // this tile's rows and geometry

    // ---- z1 = rnd(h_src . W_src) + rnd(h_dst . W_dst) + radial * w_rad +
    // w_ef + be1 -> m1 = silu(z1) as the A operand of We2 ----
    unsigned af[4][4];
    {
      float z[8][4];
      unsigned pa[8][2];  // rnd(h_src . W_src), packed
      zero(z);
      for (int k0 = 0; k0 < 2 * Fp; k0 += 16) {
        if (k0 == Fp) {
          // a src projection about to round near a bf16 tie: in k order
          redo_ties(z, m0, fr, fq, [&](int t, int j) {
            return dot_n(hsrc + t * kLdb, 1, w1s + j, kLdb, F);
          });
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            pa[nt][0] = pack2(z[nt][0], z[nt][1]);
            pa[nt][1] = pack2(z[nt][2], z[nt][3]);
          }
          zero(z);
        }
        unsigned a[4];
        load_a<false>(a, k0 < Fp ? hsrc : hdst, m0, k0 < Fp ? k0 : k0 - Fp,
                      lane);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned bfr[4];
          load_b<true>(bfr, w1s, np * 16, k0, lane);
          mma_add(z[2 * np], a, bfr[0], bfr[1]);
          mma_add(z[2 * np + 1], a, bfr[2], bfr[3]);
        }
      }
      // a dst projection about to round near a bf16 tie: in k order
      redo_ties(z, m0, fr, fq, [&](int t, int j) {
        return dot_n(hdst + t * kLdb, 1, w1s + Fp * kLdb + j, kLdb, F);
      });
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = m0 + fr + 8 * (i >> 1), j = nt * 8 + 2 * fq + (i & 1);
          const __nv_bfloat162 p2 =
              *reinterpret_cast<const __nv_bfloat162*>(&pa[nt][i >> 1]);
          const float pav = (i & 1) ? __high2float(p2) : __low2float(p2);
          const float pbv = z[nt][i];
          const float z1 = __fadd_rn(
              __fadd_rn(
                  __fadd_rn(__fadd_rn(pav, rnd<bf>(pbv)),
                            __fmul_rn(g.rad[t], vec[kMWRad * H + j])),
                  vec[kMWEf * H + j]),
              vec[kMBe1 * H + j]);
          float v = z1 * sigmoid_fast(z1);
          if (near_tie(v)) v = z1 * sigmoid(z1);  // the IEEE quotient
          z[nt][i] = v;
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        af[kk][0] = pack2(z[2 * kk][0], z[2 * kk][1]);
        af[kk][1] = pack2(z[2 * kk][2], z[2 * kk][3]);
        af[kk][2] = pack2(z[2 * kk + 1][0], z[2 * kk + 1][1]);
        af[kk][3] = pack2(z[2 * kk + 1][2], z[2 * kk + 1][3]);
      }
      __syncwarp();  // the warp's gathered rows are read: m1 takes their place
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          m_row(st, m0 + fr + 8 * (i >> 1))[nt * 8 + 2 * fq + (i & 1)] =
              rnd<bf>(z[nt][i]);
        }
    }
    __syncwarp();  // m1's rows, for m's recompute; then m takes their place

    // ---- m = silu(m1 @ We2 + be2) -> its f32 row (m_row) for the node
    // sums; m as the A operand of Wc1. An m about to round near a tie is
    // recomputed in the plain version's order (over m1's row, in k order,
    // the IEEE sigmoid) ----
    {
      float p2[8][4];
      reg_product(af, we2s, lane, p2);
      unsigned tie = 0;  // bit 4 * nt + i: m near a tie
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          const float p = p2[nt][i] + vec[kMBe2 * H + j];
          const float v = p * sigmoid_fast(p);
          tie |= unsigned(near_tie(v)) << (4 * nt + i);
          const float mv = rnd<bf>(v);
          p2[nt][i] = mv;
        }
      for (; tie; tie &= tie - 1) {
        const int i = __ffs(tie) - 1, j = tie_col(i, fq);
        const float p = dot_row(m_row(st, tie_edge(m0, fr, i)), we2s + j, H) +
                        vec[kMBe2 * H + j];
        set_at(p2, i, rnd<bf>(p * sigmoid(p)));
      }
      __syncwarp();  // every lane has read m1's rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float* mr = m_row(st, m0 + fr + 8 * hh);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          *reinterpret_cast<float2*>(mr + nt * 8 + 2 * fq) =
              make_float2(p2[nt][2 * hh], p2[nt][2 * hh + 1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        af[kk][0] = pack2(p2[2 * kk][0], p2[2 * kk][1]);
        af[kk][1] = pack2(p2[2 * kk][2], p2[2 * kk][3]);
        af[kk][2] = pack2(p2[2 * kk + 1][0], p2[2 * kk + 1][1]);
        af[kk][3] = pack2(p2[2 * kk + 1][2], p2[2 * kk + 1][3]);
      }
    }

    // ---- cw = rnd(silu(m @ Wc1 + bc1) . wc2) -> the coordinate message
    // rnd(cw * x_hat) in x_hat's place. A c1 about to round near a tie is
    // recomputed in the plain version's order (over m's row, in k order,
    // the IEEE sigmoid) ----
    {
      float p3[8][4];
      reg_product(af, wc1s, lane, p3);
      __syncwarp();  // m's rows complete, for c1's recompute
      unsigned tie = 0;  // bit 4 * nt + i: c1 near a tie
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          const float p = p3[nt][i] + vec[kMBc1 * H + j];
          const float v = p * sigmoid_fast(p);
          tie |= unsigned(near_tie(v)) << (4 * nt + i);
          const float c1 = rnd<bf>(v);
          p3[nt][i] = c1;
        }
      for (; tie; tie &= tie - 1) {
        const int i = __ffs(tie) - 1, j = tie_col(i, fq);
        const float p = dot_row(m_row(st, tie_edge(m0, fr, i)), wc1s + j, H) +
                        vec[kMBc1 * H + j];
        set_at(p3, i, rnd<bf>(p * sigmoid(p)));
      }
      // cw = c1 . wc2 in B1's order (egnn_mega.cuh): each product and sum
      // rounded on its own, a lane's columns in column order, then sum4
      float part[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = nt * 8 + 2 * fq + (i & 1);
          part[i >> 1] =
              __fadd_rn(part[i >> 1], __fmul_rn(p3[nt][i], vec[kMWc2 * H + j]));
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float cw = rnd<bf>(sum4(part[hh]));
        const int t = m0 + fr + 8 * hh;
        if (fq == 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            g.xh[t * 3 + k] = rnd<bf>(__fmul_rn(cw, g.xh[t * 3 + k]));
          }
        }
      }
    }

    // ---- the tile's messages into the node block, after the chunk's
    // previous tile ----
    wg_sync(wg);  // the tile's m rows and coordinate messages
    if (it > 0) turn_wait(wg);
    sum_tile_ordered(acc, st, g, wtid);
    if (it + 1 < ntiles) turn_pass(wg);
    wg_sync(wg);  // the stage and the geometry turn over
    if (it + 2 < ntiles) load_tile(it + 2);
  }
  cp_async_wait<0>();

  // ---- 2. every node block of the cluster complete ----
  cluster.sync();

  // ---- 3. this CTA's nodes: the cluster's sums in rank order, x', the
  // node MLP ----
  stage_rows(wn1s, w.wn1_top, F);
  stage_rows(wn1s + F * kLdb, nullptr, Fp - F);
  stage_rows(wn1s + Fp * kLdb, w.wn1_bot, H);
  stage_rows(wn2s, w.wn2, H);
  const float* blocks[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    blocks[q] = q < ranks ? cluster.map_shared_rank(acc, q) : acc;
  }
  // (n, c) summed over the cluster's node blocks in rank order from +0;
  // the loads are issued together
  auto cluster_sum = [&](int i) {
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      v[q] = q < ranks ? blocks[q][i] : 0.0f;
    }
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < ranks) sum += v[q];
    }
    return sum;
  };
  const int rows = (N + ranks - 1) / ranks;
  const int n_lo = min(N, rank * rows), n_hi = min(N, n_lo + rows);
  const int K1 = Fp + H, lda = K1 + 8;
  bf* atile = reinterpret_cast<bf*>(stage);                // [64][lda]
  bf* as = atile + kTile * lda;                            // [64][kLdb]
  const int rb = (warp & 3) * 16, ch = (warp >> 2) * 32;
  for (int r0 = n_lo; r0 < n_hi; r0 += kTile) {
    __syncthreads();  // weights staged; the previous block's tiles read
    for (int i = tid; i < kTile * K1; i += kFwdThreads) {
      const int row = i / K1, k = i % K1, node = r0 + row;
      bf v = bf_zero;
      if (node < n_hi) {
        if (k < F) {
          v = hb[(size_t)node * F + k];
        } else if (k >= Fp) {
          v = __float2bfloat16(cluster_sum(node * C + k - Fp));
        }
      }
      atile[row * lda + k] = v;
    }
    for (int i = tid; i < kTile * 3; i += kFwdThreads) {
      const int node = r0 + i / 3, k = i % 3;
      if (node < n_hi) {
        const float accx = cluster_sum(node * C + H + k);
        x_out[((size_t)b * N + node) * 3 + k] =
            from_f<XT>(to_f(xb[node * 3 + k]) + rnd<bf>(accx));
      }
    }
    __syncthreads();
    // zn = rnd([h | agg] . Wn1 + bn1) and a = node_silu(zn); a zn about
    // to round near a bf16 tie (near_zn_tie) is recomputed as the plain
    // version computes
    // it (the product summed in k order by dot_n): the tensor cores sum in
    // another order, and a zn rounded the other way moves every column of
    // its row of h'. a's steps are IEEE, each rounded, as the plain
    // version's
    {
      float p[4][4];
      block_product(atile, lda, wn1s, K1, rb, ch, lane, p);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = rb + fr + 8 * hh, j = ch + q * 8 + 2 * fq;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float zn = __fadd_rn(p[q][2 * hh + c], vec[kMBn1 * H + j + c]);
            if (near_zn_tie(zn)) {
              zn = __fadd_rn(
                  dot_n(atile + row * lda, 1, wn1s + j + c, kLdb, K1),
                  vec[kMBn1 * H + j + c]);
            }
            zn = rnd<bf>(zn);
            v[c] = node_silu<bf>(zn);
          }
          store_pair(as + row * kLdb + j, v[0], v[1]);
        }
    }
    __syncthreads();  // a complete for the block
    {
      float p[4][4];
      block_product(as, kLdb, wn2s, H, rb, ch, lane, p);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int node = r0 + rb + fr + 8 * hh, j = ch + q * 8 + 2 * fq;
          if (node >= n_hi) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              h_out + ((size_t)b * N + node) * H + j) =
              __floats2bfloat162_rn(p[q][2 * hh] + vec[kMBn2 * H + j],
                                    p[q][2 * hh + 1] + vec[kMBn2 * H + j + 1]);
        }
    }
  }

  // ---- 4. no CTA leaves while another still reads its node block ----
  cluster.sync();
}

// CTAs of the tensor-core form that fit on one SM at once for N nodes and
// input width F, or -1 on a CUDA error
template <typename XT>
int layer_ctas_per_sm(int n, int f) {
  const int bytes = layer_layout(n, f).bytes;
  auto kernel = egnn_layer_fwd_mma_kernel<XT, kHidden>;
  int ctas = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                        kFwdThreads, bytes);
  }
  return err == cudaSuccess ? ctas : -1;
}

template <typename XT>
cudaError_t launch_layer_mma(const int* src, const int* dst,
                             const uint8_t* mask, const void* h,
                             const void* x, const void* weights, void* h_out,
                             void* x_out, int B, int N, int E, int F,
                             int cluster, cudaStream_t stream) {
  const size_t bytes = (size_t)layer_layout(N, F).bytes;
  auto kernel = egnn_layer_fwd_mma_kernel<XT, kHidden>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * cluster);
  config.blockDim = dim3(kFwdThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, src, dst, mask,
                           static_cast<const bf*>(h),
                           static_cast<const XT*>(x),
                           static_cast<const float*>(weights),
                           static_cast<bf*>(h_out), static_cast<XT*>(x_out),
                           N, E, F);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch(const int* src, const int* dst, const uint8_t* mask,
                   const void* h, const void* x, const void* weights,
                   void* h_out, void* x_out, int B, int N, int E, int F,
                   cudaStream_t stream) {
  const size_t bytes = (size_t)smem_bytes(N, F, kHidden, sizeof(float));
  auto kernel = egnn_layer_fwd_kernel<float, XT, kHidden>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, bytes, stream>>>(
      src, dst, mask, static_cast<const float*>(h), static_cast<const XT*>(x),
      static_cast<const float*>(weights), static_cast<float*>(h_out),
      static_cast<XT*>(x_out), N, E, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for N nodes, input width F and hidden width
// H, features in bfloat16 (bf16 != 0: the tensor-core form) or float32.
long long egnn_layer_fwd_smem_bytes(int N, int F, int H, int bf16) {
  return bf16 ? layer_layout(N, F).bytes : smem_bytes(N, F, H, 4);
}

// CTAs of the tensor-core form that fit on one SM at once for N nodes and
// input width F, coordinates in bfloat16 (x_bf16 != 0) or float32, or -1
// on a CUDA error.
int egnn_layer_fwd_ctas_per_sm(int N, int F, int x_bf16) {
  return x_bf16 ? layer_ctas_per_sm<__nv_bfloat16>(N, F)
                : layer_ctas_per_sm<float>(N, F);
}

// Clusters of `cluster` CTAs of the tensor-core form that the card can hold
// at once for N nodes and input width F (cudaOccupancyMaxActiveClusters),
// or -1 on a CUDA error.
int egnn_layer_fwd_max_clusters(int N, int F, int cluster) {
  const int bytes = layer_layout(N, F).bytes;
  auto kernel = egnn_layer_fwd_mma_kernel<__nv_bfloat16, egnn::kHidden>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(egnn::kFwdThreads);
  config.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &config);
  return err == cudaSuccess ? n : -1;
}

// Elements of the packed weights of one layer of input width F.
long long egnn_layer_fwd_weight_count(int F, int H) {
  return weight_count(F, H);
}

// One launch on `stream`. src/dst [B,E] int32, mask [B,E] bool; h [B,N,F]
// in the compute dtype (bf16 != 0: bfloat16, else float32); x [B,N,3] in
// bfloat16 (x_bf16 != 0) or float32; weights the packed layer
// (weight_count elements, float32). bf16 runs B clusters of
// `cluster` CTAs (1 to 8) of 256 threads, f32 B CTAs (cluster 1). Writes
// h_out [B,N,H] in the compute dtype and x_out [B,N,3] in x's dtype.
// Returns the cudaError_t of the launch.
int egnn_layer_fwd(const void* src, const void* dst, const void* mask,
                   const void* h, const void* x, const void* weights,
                   void* h_out, void* x_out, int B, int N, int E, int F,
                   int H, int bf16, int x_bf16, int cluster, void* stream) {
  if (B < 1 || N < 1 || E < 0 || F < 1 || F > H || H != egnn::kHidden ||
      cluster < 1 || cluster > kMaxCluster || (!bf16 && cluster != 1)) {
    return cudaErrorInvalidValue;
  }
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && x_bf16) {
    return launch_layer_mma<__nv_bfloat16>(s, d, m, h, x, weights, h_out,
                                           x_out, B, N, E, F, cluster, st);
  }
  if (bf16) {
    return launch_layer_mma<float>(s, d, m, h, x, weights, h_out, x_out, B,
                                   N, E, F, cluster, st);
  }
  if (x_bf16) {
    return launch<__nv_bfloat16>(s, d, m, h, x, weights, h_out, x_out, B, N,
                                 E, F, st);
  }
  return launch<float>(s, d, m, h, x, weights, h_out, x_out, B, N, E, F, st);
}

}  // extern "C"
