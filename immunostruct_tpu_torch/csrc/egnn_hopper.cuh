// Building blocks of the tensor-core forms for Hopper (sm_90a), shared by
// csrc/egnn_tail.cuh (B2, B5a, B5b), csrc/egnn_edge_fwd.cu and
// csrc/egnn_edge_bwd.cu (B3's forward and backward) and csrc/egnn_mega.cuh
// (B1 and B4):
//
//   cp_async*, stage_run, run_offset, staged
//                      tiles copied from device memory to shared memory by
//                      cp.async while the previous tile computes;
//   ldsm_*, load_a, load_b, mma_add, warp_product, warp_product_k
//                      mma.sync.m16n8k16 with bf16 operands fed by ldmatrix
//                      from bf16 tiles of row stride kLdb (144 B: the 8 rows
//                      of a 16-byte ldmatrix read fall in 8 bank groups), each
//                      product added to its accumulator in f32;
//   sigmoid_fast, near_tie, dot_k, dot_n and the tie helpers
//                      the near-tie recompute: a value about to round to bf16
//                      within kTieUlps f32 units of a rounding boundary is
//                      recomputed on the CUDA cores in the plain version's
//                      order, so that it rounds as there;
//   chain_a1, chain_p2, chain_c1
//                      the steps of the edge chain forward, per warp of 16
//                      edges, with their rounding points and the recompute:
//                      B3's forward and backward, and (from chain_p2 on) the
//                      tail backwards;
//   chain_dp2, chain_da1, edge_dxd, chain_dsmall_v, store_chain_partials
//                      the steps of the chain's backward that the tail
//                      backwards and B3's backward share;
//   reduce_node_chunks per-chunk f32 node blocks summed in chunk order (no
//                      atomics: the same bits from run to run).

#pragma once

#include "egnn_common.cuh"

namespace egnn {

using bf = __nv_bfloat16;

constexpr int kMmaThreads = 128;        // one warpgroup: 4 warps
constexpr int kLdb = kHidden + 8;       // bf16 row of an operand tile, 144 B
constexpr int kTileBytes = kTile * kLdb * 2;
constexpr int kRunBytes = 144;          // a staged run of 64 bf16: 9 chunks
constexpr int kRunChunks = kRunBytes / 16;
constexpr int kRowChunks = 8;          // 16-byte chunks of a run of 64 bf16
constexpr int kLdf = kHidden + 8;       // f32 row of a1 and dW1ab: 2-way banks

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// chunk `chunk` of the 16-byte-aligned chunks that cover the run of `bytes`
// bytes at g, into row (16-byte aligned); the run lands at row + (g & 15)
__device__ __forceinline__ void stage_run(unsigned char* row, const void* g,
                                          int bytes, int chunk) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const int off = static_cast<int>(a & 15);
  if (chunk * 16 < off + bytes) {
    cp_async16(row + chunk * 16,
               reinterpret_cast<const void*>(a - off + chunk * 16));
  }
}

// the offset at which the run from g lands in its staged row
__device__ __forceinline__ int run_offset(const void* g) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
}

// element i of a run staged at offset off
__device__ __forceinline__ float staged(const unsigned char* row, int off,
                                        int i) {
  return __bfloat162float(reinterpret_cast<const bf*>(row + off)[i]);
}

// sigmoid on the special-function unit (__expf, __fdividef): a few units in
// the last place from the IEEE quotient, well inside kTieUlps, so the
// near-tie recompute below gives every rounding the plain version's result
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// Near-tie recompute. The tensor cores sum a product's 64 terms in another
// order than the plain version's f32 sum in k order, and sigmoid_fast is not
// the IEEE quotient, so a value about to round to bf16 lies some f32 units
// in the last place from the plain version's; where it lies within kTieUlps
// such units of a bf16 rounding boundary, its rounding could fall the other
// way and move the rest of the edge's chain. Each step works on its 32
// fragment values without a branch and marks those near a tie (bit tie_bit
// of a mask); then, only where the mask is not empty, it recomputes them on
// the CUDA cores as the plain version computes them (the product summed in
// k order by dot_k, the sigmoid the IEEE quotient, the other element-wise
// steps rounded op by op: a1_exact, silu_grad_rn), stores them over the
// first ones and moves the f32 sums by the difference (c1, which is not
// stored, is left out of its sums until then). About 2 * kTieUlps / 65536
// of the values take that path; kTieUlps < 0 turns it off.
constexpr int kTieUlps = 32;

__device__ __forceinline__ bool near_tie(float v) {
  return kTieUlps >= 0 &&
         ((__float_as_uint(v) + unsigned(kTieUlps - 0x8000)) & 0xffffu) <=
             unsigned(2 * kTieUlps);
}

// the mask bit of fragment value (nt, 2 * h + c), and back from bit i: its
// tile edge (warp rows from m0), its column, its index 2 * nt + c among a
// thread's 16 columns
__device__ __forceinline__ int tie_bit(int nt, int h, int c) {
  return 4 * nt + 2 * h + c;
}
__device__ __forceinline__ int tie_edge(int m0, int fr, int i) {
  return m0 + fr + 8 * (i / 2 % 2);
}
__device__ __forceinline__ int tie_col(int i, int fq) {
  return i / 4 * 8 + 2 * fq + i % 2;
}
__device__ __forceinline__ int tie_sum(int i) { return i / 4 * 2 + i % 2; }

// a[i] = v or a[i] += v at a run-time index, the array kept in registers
// (a select on every element)
__device__ __forceinline__ void set_at(float (&a)[8][4], int i, float v) {
#pragma unroll
  for (int k = 0; k < 32; ++k) a[k / 4][k % 4] = k == i ? v : a[k / 4][k % 4];
}
template <int N>
__device__ __forceinline__ void add_at(float (&a)[N], int i, float v) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = k == i ? a[k] + v : a[k];
}

// sum over k = 0..H-1, in k order, of a[k * sa] * b[k * sb]
__device__ __forceinline__ float dot_k(const bf* a, int sa, const bf* b,
                                       int sb) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kHidden; ++k) {
    acc = fmaf(__bfloat162float(a[k * sa]), __bfloat162float(b[k * sb]),
               acc);
  }
  return acc;
}

// sum over k < K, in k order, of a[k * sa] * b[k * sb]
__device__ __forceinline__ float dot_n(const bf* a, int sa, const bf* b,
                                       int sb, int K) {
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    acc = fmaf(__bfloat162float(a[k * sa]), __bfloat162float(b[k * sb]),
               acc);
  }
  return acc;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const bf* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// c += a . b: one m16n8k16 product, bf16 operands, f32 accumulation. The
// product starts from zero and is added to c in f32: the tensor cores' own
// accumulation does not round to nearest as an f32 add does, and chained
// over K or over tiles its error moves bf16 roundings downstream (the
// weight gradients' sums drift towards the bf16 bounds)
__device__ __forceinline__ void mma_add(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += d[i];
}

// The A operand (16 x 16 at rows m0, depth k0) of a warp's product, from a
// bf16 tile of row stride kLdb stored [m][k] (kTrans false) or [k][m].
template <bool kTrans>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf* s, int m0,
                                       int k0, int lane) {
  if (kTrans) {
    const int q = lane >> 3, r = lane & 7;
    ldsm_x4_t(a, s + (k0 + r + (q >> 1) * 8) * kLdb + m0 + (q & 1) * 8);
  } else {
    ldsm_x4(a, s + (m0 + (lane & 15)) * kLdb + k0 + (lane >> 4) * 8);
  }
}

// The B operands of two n-tiles (columns n0..n0+15, depth k0): b[0], b[1]
// for n0, b[2], b[3] for n0+8; stored [k][n] (kTrans true) or [n][k].
template <bool kTrans>
__device__ __forceinline__ void load_b(unsigned (&b)[4], const bf* s, int n0,
                                       int k0, int lane) {
  const int q = lane >> 3, r = lane & 7;
  if (kTrans) {
    ldsm_x4_t(b, s + (k0 + r + (q & 1) * 8) * kLdb + n0 + (q >> 1) * 8);
  } else {
    ldsm_x4(b, s + (n0 + r + (q >> 1) * 8) * kLdb + k0 + (q & 1) * 8);
  }
}

// acc[nt][.] += rows m0..m0+15 of A . B over K = 64, all 64 columns.
// Fragment (nt, i): row m0 + lane/4 + 8*(i/2), column nt*8 + 2*(lane%4) +
// i%2.
template <bool kATrans, bool kBTrans>
__device__ __forceinline__ void warp_product(const bf* a, const bf* b,
                                             int m0, int lane,
                                             float (&acc)[8][4]) {
#pragma unroll
  for (int k0 = 0; k0 < kHidden; k0 += 16) {
    unsigned af[4];
    load_a<kATrans>(af, a, m0, k0, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bfr[4];
      load_b<kBTrans>(bfr, b, np * 16, k0, lane);
      mma_add(acc[2 * np], af, bfr[0], bfr[1]);
      mma_add(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc[nt][.] += rows m0..m0+15 of A . B over depth K (a multiple of 16), all
// 64 columns; A stored [k][m], B stored [k][n] (warp_product<true, true> at
// any depth)
__device__ __forceinline__ void warp_product_k(const bf* a, const bf* b,
                                               int m0, int lane, int K,
                                               float (&acc)[8][4]) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned af[4];
    load_a<true>(af, a, m0, k0, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bfr[4];
      load_b<true>(bfr, b, np * 16, k0, lane);
      mma_add(acc[2 * np], af, bfr[0], bfr[1]);
      mma_add(acc[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
}

__device__ __forceinline__ void store_pair(bf* s, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(lo, hi);
}

// sum over the four lanes of a fragment row (lane % 4)
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// ---------------------------------------------------------------------------
// The edge chain on the tensor cores: its forward steps, shared by B3's
// forward (csrc/egnn_edge_fwd.cu) and the backwards that recompute it, and
// its backward steps, shared by the tail backwards (B2, B5a, B5b:
// csrc/egnn_tail.cuh) and B3's backward (csrc/egnn_edge_bwd.cu). Per warp:
// the 16 edges m0..m0+15 of a 64-edge tile, lane `lane`. The tile's
// operands are bf16 [.][kLdb]: the staged bundle features xt [feature][t],
// a1s [j][t] (then d_a1 [t][j]), m, d_p3, d_p2 [t][j]; W1ab, W2 and Wc1
// [k][n]; small^T sms [6][H] f32; the per-edge f32 values ev
// [kEdgeRows][kTile].
// ---------------------------------------------------------------------------

// rows of the per-edge values
constexpr int kERad = 0, kEInv = 1, kEEf = 2, kECw = 3, kEDcw = 4, kEXd = 5,
              kEDmx = 8, kEDxd = 11, kEdgeRows = 14;

// a1 of tile edge t, column j, as the plain version sums it: [hs ; hd] . W1ab
// over the 2F features in k order (xt [feature][t], w1s [feature][j]), then
// w1r*radial, w1e*ef and b1 (radial and ef from ev), each product and sum
// rounded on its own as there (no fused multiply-add)
__device__ __forceinline__ float a1_exact(const bf* xt, const bf* w1s, int f2,
                                          const float* sms, const float* ev,
                                          int t, int j) {
  constexpr int H = kHidden;
  float a = __fadd_rn(dot_n(xt + t, kLdb, w1s + j, kLdb, f2),
                      __fmul_rn(sms[kW1R * H + j], ev[kERad * kTile + t]));
  a = __fadd_rn(a, __fmul_rn(sms[kW1E * H + j], ev[kEEf * kTile + t]));
  return __fadd_rn(a, sms[kB1 * H + j]);
}

// a1 = [hs ; hd] @ W1ab + w1r*radial + w1e*ef + b1 over depth kp (2F padded
// with zero rows to a multiple of 16) -> a1s into a1st [j][t]; a1 in f32
// into a1f [t][kLdf] where a1f is not null (the backward's silu'(a1))
__device__ __forceinline__ void chain_a1(const bf* xt, const bf* w1s, int kp,
                                         int f2, const float* sms,
                                         const float* ev, bf* a1st,
                                         float* a1f, int m0, int lane) {
  constexpr int H = kHidden;
  const int fr = lane >> 2, fq = lane & 3;
  float acc[8][4];
  zero(acc);
  warp_product_k(xt, w1s, m0, lane, kp, acc);
  unsigned tie = 0;  // bit tie_bit(nt, h, c): a1s near a tie
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + fr + 8 * h, j0 = nt * 8 + 2 * fq;
      float av[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c;
        float a = acc[nt][2 * h + c] +
                  sms[kW1R * H + j] * ev[kERad * kTile + t];
        a = a + sms[kW1E * H + j] * ev[kEEf * kTile + t];
        a = a + sms[kB1 * H + j];
        av[c] = a;
        const float v = a * sigmoid_fast(a);
        tie |= unsigned(near_tie(v)) << tie_bit(nt, h, c);
        a1st[j * kLdb + t] = __float2bfloat16(v);
      }
      if (a1f != nullptr) {
        *reinterpret_cast<float2*>(a1f + t * kLdf + j0) =
            make_float2(av[0], av[1]);
      }
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
    const float a = a1_exact(xt, w1s, f2, sms, ev, t, j);
    a1st[j * kLdb + t] = __float2bfloat16(a * sigmoid(a));
    if (a1f != nullptr) a1f[t * kLdf + j] = a;
  }
}

// p2 = a1s @ W2 + b2 -> m into mt; g2 = silu'(p2)
__device__ __forceinline__ void chain_p2(const bf* a1st, const bf* w2s,
                                         const float* sms, bf* mt, int m0,
                                         int lane, float (&g2)[8][4]) {
  constexpr int H = kHidden;
  const int fr = lane >> 2, fq = lane & 3;
  float acc[8][4];
  zero(acc);
  warp_product<true, true>(a1st, w2s, m0, lane, acc);
  unsigned tie = 0;  // bit tie_bit(nt, h, c): m near a tie
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + fr + 8 * h, j = nt * 8 + 2 * fq;
      float mv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = acc[nt][2 * h + c] + sms[kB2 * H + j + c];
        const float s = sigmoid_fast(p);
        mv[c] = p * s;
        g2[nt][2 * h + c] = silu_grad(p, s);
        tie |= unsigned(near_tie(mv[c])) << tie_bit(nt, h, c);
      }
      store_pair(mt + t * kLdb + j, mv[0], mv[1]);
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
    const float p = dot_k(a1st + t, kLdb, w2s + j, kLdb) + sms[kB2 * H + j];
    const float s = sigmoid(p);
    mt[t * kLdb + j] = __float2bfloat16(p * s);
    set_at(g2, i, silu_grad(p, s));
  }
}

// p3 = m @ Wc1 + bc1 -> c1, cw (rounded, into ev). With kDp3 (the
// backward) also d_p3 = wc2 * d_cw * silu'(p3) into dp3t, and dbc1 and dwc2
// summed over this thread's columns; the forward (B3's) passes no d_p3.
template <bool kDp3>
__device__ __forceinline__ void chain_c1(const bf* mt, const bf* wc1s,
                                         const float* sms, float* ev,
                                         bf* dp3t, int m0, int lane,
                                         float (&gbc1)[16],
                                         float (&gwc2)[16]) {
  constexpr int H = kHidden;
  const int fr = lane >> 2, fq = lane & 3;
  float acc[8][4];
  zero(acc);
  warp_product<false, true>(mt, wc1s, m0, lane, acc);
  float part[2] = {0.0f, 0.0f};
  unsigned tie = 0;  // c1 or d_p3 near a tie: c1's sums wait for it
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + fr + 8 * h, j0 = nt * 8 + 2 * fq;
      const float dcw = kDp3 ? ev[kEDcw * kTile + t] : 0.0f;
      float d3[2];
      bool at_tie[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c;
        const float p = acc[nt][2 * h + c] + sms[kBC1 * H + j];
        const float s = sigmoid_fast(p);
        const float c1 = rnd<bf>(p * s);
        if constexpr (kDp3) {
          const float g3 = silu_grad(p, s);
          d3[c] = sms[kWC2 * H + j] * dcw * g3;
          at_tie[c] = near_tie(p * s) || near_tie(d3[c]);
        } else {
          at_tie[c] = near_tie(p * s);
        }
        tie |= unsigned(at_tie[c]) << tie_bit(nt, h, c);
        part[h] += at_tie[c] ? 0.0f : c1 * sms[kWC2 * H + j];
        if constexpr (kDp3) gwc2[2 * nt + c] += at_tie[c] ? 0.0f : c1 * dcw;
      }
      if constexpr (kDp3) {
        // d_p3 rounds once, at its bf16 store, and dbc1 sums the stored
        // values: the products and dbc1 see the same rounded d_p3
        const __nv_bfloat162 q = __floats2bfloat162_rn(d3[0], d3[1]);
        *reinterpret_cast<__nv_bfloat162*>(dp3t + t * kLdb + j0) = q;
        gbc1[2 * nt] += __low2float(q);
        gbc1[2 * nt + 1] += __high2float(q);
      }
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
    const float p =
        dot_k(mt + t * kLdb, 1, wc1s + j, kLdb) + sms[kBC1 * H + j];
    const float s = sigmoid(p);
    const float c1 = rnd<bf>(p * s);
    if constexpr (kDp3) {
      const float dcw = ev[kEDcw * kTile + t];
      const bf q =
          __float2bfloat16(sms[kWC2 * H + j] * dcw * silu_grad_rn(p, s));
      add_at(gbc1, tie_sum(i),
             __bfloat162float(q) - __bfloat162float(dp3t[t * kLdb + j]));
      dp3t[t * kLdb + j] = q;
      add_at(gwc2, tie_sum(i), c1 * dcw);
    }
    add_at(part, i / 2 % 2, c1 * sms[kWC2 * H + j]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float cw = sum4(part[h]);
    if (fq == 0) ev[kECw * kTile + m0 + fr + 8 * h] = rnd<bf>(cw);
  }
}

// d_m = d_m_in + Wc1 @ d_p3; d_p2 = d_m * silu'(p2) into dp2t; db2 summed
// over this thread's columns. dm_in(t, j): the cotangent d_m_in of tile
// edge t, column j (a1st still holds a1s)
template <class DmIn>
__device__ __forceinline__ void chain_dp2(const bf* dp3t, const bf* wc1s,
                                          const bf* a1st, const bf* w2s,
                                          const float* sms,
                                          const float (&g2)[8][4], DmIn dm_in,
                                          bf* dp2t, int m0, int lane,
                                          float (&gb2)[16]) {
  constexpr int H = kHidden;
  const int fr = lane >> 2, fq = lane & 3;
  float acc[8][4];
  zero(acc);
  warp_product<false, false>(dp3t, wc1s, m0, lane, acc);
  unsigned tie = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + fr + 8 * h, j0 = nt * 8 + 2 * fq;
      float d2[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float dm = dm_in(t, j0 + c) + acc[nt][2 * h + c];
        const float dp2 = rnd<bf>(dm * g2[nt][2 * h + c]);
        tie |= unsigned(near_tie(dm * g2[nt][2 * h + c])) << tie_bit(nt, h, c);
        d2[c] = dp2;
        gb2[2 * nt + c] += dp2;
      }
      store_pair(dp2t + t * kLdb + j0, d2[0], d2[1]);
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
    const float p = dot_k(a1st + t, kLdb, w2s + j, kLdb) + sms[kB2 * H + j];
    const float g = silu_grad_rn(p, sigmoid(p));
    const float dm =
        dm_in(t, j) + dot_k(dp3t + t * kLdb, 1, wc1s + j * kLdb, 1);
    const float dp2 = rnd<bf>(dm * g);
    add_at(gb2, tie_sum(i), dp2 - __bfloat162float(dp2t[t * kLdb + j]));
    dp2t[t * kLdb + j] = __float2bfloat16(dp2);
  }
}

// d_a1 = (W2 @ d_p2) * silu'(a1), W2 @ d_p2 in da_acc, into a1st as
// [t][j]; prad/pef: this thread's shares of w1r . d_a1 and w1e . d_a1 for
// its two edges. a1(t, j): a1 of tile edge t, column j; a1_tie(t, j): the
// same as the plain version computes it, for an element near a tie
template <class A1, class A1Tie>
__device__ __forceinline__ void chain_da1(const float (&da_acc)[8][4],
                                          const bf* dp2t, const bf* w2s,
                                          const float* sms, A1 a1,
                                          A1Tie a1_tie, bf* a1st, int m0,
                                          int lane, float (&prad)[2],
                                          float (&pef)[2]) {
  constexpr int H = kHidden;
  const int fr = lane >> 2, fq = lane & 3;
  unsigned tie = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = m0 + fr + 8 * h, j0 = nt * 8 + 2 * fq;
      float d1[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = j0 + c;
        const float a = a1(t, j);
        const float dsum = da_acc[nt][2 * h + c];
        const float g1 = silu_grad(a, sigmoid_fast(a));
        const float da = rnd<bf>(dsum * g1);
        tie |= unsigned(near_tie(dsum * g1)) << tie_bit(nt, h, c);
        d1[c] = da;
        prad[h] += sms[kW1R * H + j] * da;
        pef[h] += sms[kW1E * H + j] * da;
      }
      store_pair(a1st + t * kLdb + j0, d1[0], d1[1]);
    }
  for (; tie; tie &= tie - 1) {
    const int i = __ffs(tie) - 1;
    const int t = tie_edge(m0, fr, i), j = tie_col(i, fq);
    const float a = a1_tie(t, j);
    const float dsum = dot_k(dp2t + t * kLdb, 1, w2s + j * kLdb, 1);
    const float g1 = silu_grad_rn(a, sigmoid(a));
    const float da = rnd<bf>(dsum * g1);
    const float step_da = da - __bfloat162float(a1st[t * kLdb + j]);
    a1st[t * kLdb + j] = __float2bfloat16(da);
    add_at(prad, i / 2 % 2, sms[kW1R * H + j] * step_da);
    add_at(pef, i / 2 % 2, sms[kW1E * H + j] * step_da);
  }
}

// d_xd of tile edge t (rounded, into ev rows kEDxd..) from d_rad's chain
// term w1r . d_a1; zeros for an edge that is not computed (ok false)
__device__ __forceinline__ void edge_dxd(float* ev, int t, bool ok,
                                         float d_rad_chain) {
  float dx[3] = {0.0f, 0.0f, 0.0f};
  if (ok) {
    const float r = ev[kERad * kTile + t], inv = ev[kEInv * kTile + t];
    const float cwb = ev[kECw * kTile + t];
    const float safe = r > 0.0f ? r : 1.0f;
    float sum_dxh_xd = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sum_dxh_xd +=
          ev[(kEDmx + k) * kTile + t] * cwb * ev[(kEXd + k) * kTile + t];
    }
    const float d_safe = sum_dxh_xd * (-0.5f) * inv * inv / sqrtf(safe);
    const float d_rad = d_rad_chain + (r > 0.0f ? d_safe : 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dx[k] = ev[(kEDmx + k) * kTile + t] * cwb * inv +
              2.0f * ev[(kEXd + k) * kTile + t] * d_rad;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) ev[(kEDxd + k) * kTile + t] = rnd<bf>(dx[k]);
}

// gv += d_a1^T . V (dw1r, dw1e, db1), d_a1 [t][j] in a1st, V [t][8]
__device__ __forceinline__ void chain_dsmall_v(const bf* a1st, const bf* vt,
                                               int m0, int lane,
                                               float (&gv)[4]) {
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 16) {
    unsigned af[4], bv[2];
    load_a<true>(af, a1st, m0, k0, lane);
    ldsm_x2_t(bv, vt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * 8);
    mma_add(gv, af, bv[0], bv[1]);
  }
}

// A CTA's partial weight gradients at pw: dW2 [H][H] | dWc1 [H][H] |
// dsmall [H][6], from the fragments gw2/gwc1/gv and the column sums
// gb2/gbc1/gwc2 (summed over a warp's rows, then the 4 warps in order
// through red [4][3][H] f32 in shared memory). Called by all 128 threads.
__device__ __forceinline__ void store_chain_partials(
    float* pw, const float (&gw2)[8][4], const float (&gwc1)[8][4],
    const float (&gv)[4], const float (&gb2)[16], const float (&gbc1)[16],
    const float (&gwc2)[16], float* red, int tid) {
  constexpr int H = kHidden;
  const int lane = tid & 31, warp = tid >> 5;
  const int fr = lane >> 2, fq = lane & 3, m0 = warp * 16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + fr + 8 * (i >> 1), col = nt * 8 + 2 * fq + (i & 1);
      pw[row * H + col] = gw2[nt][i];
      pw[H * H + row * H + col] = gwc1[nt][i];
    }
  // dw1r, dw1e, db1: fragment columns 0, 1 (fq 0) and 2 (fq 1)
  float* ps = pw + 2 * H * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = m0 + fr + 8 * h;
    if (fq == 0) {
      ps[j * 6 + kW1R] = gv[2 * h];
      ps[j * 6 + kW1E] = gv[2 * h + 1];
    } else if (fq == 1) {
      ps[j * 6 + kB1] = gv[2 * h];
    }
  }
  // db2, dbc1, dwc2: over the 8 fragment rows of a warp, then the 4 warps
  // in order
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    float v[3] = {gb2[c], gbc1[c], gwc2[c]};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 8);
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], 16);
    }
    if (fr == 0) {
      const int j = (c >> 1) * 8 + 2 * fq + (c & 1);
#pragma unroll
      for (int q = 0; q < 3; ++q) red[(warp * 3 + q) * H + j] = v[q];
    }
  }
  __syncthreads();
  for (int i = tid; i < 3 * H; i += kMmaThreads) {
    const int q = i / H, j = i % H;
    float s = 0.0f;
    for (int w = 0; w < kMmaThreads / 32; ++w) s += red[(w * 3 + q) * H + j];
    ps[j * 6 + (q == 0 ? kB2 : q == 1 ? kBC1 : kWC2)] = s;
  }
}

// d_nodes[b][i] = sum over the graph's chunks, in chunk order, of
// partial[b*chunks + c][i], i < width (a chunk's node block)
__global__ void __launch_bounds__(kReduceThreads)
    reduce_node_chunks(const float* __restrict__ partial, int chunks,
                       int width, float* __restrict__ dnodes) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= width) return;
  const float* p = partial + (size_t)b * chunks * width + i;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += p[(size_t)c * width];
  dnodes[(size_t)b * width + i] = s;
}

}  // namespace egnn
