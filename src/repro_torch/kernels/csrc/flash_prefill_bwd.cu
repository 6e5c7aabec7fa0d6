// flash_prefill_bwd: the backward pass of flash_prefill (causal GQA
// attention over a fresh sequence, head-major), for Hopper (sm_90a).
//
// The TPU kernel it pairs with (src/repro/kernels/flash_prefill.py,
// flash_prefill) has no backward: the reference trains on its jnp backend,
// where XLA differentiates the plain attention. The port trains through
// flash_prefill, so its autograd Function needs this kernel.
//
// Given q (B, H, S, D), k and v (B, Hkv, S, D), the forward's out o (q's
// strides), dout (the gradient of o) and lse (B, H, S), the log-sum-exp of
// each query's scores times 1/√D that flash_prefill.cu writes, it computes
// FlashAttention-2's backward:
//   P  = exp(Q·Kᵀ/√D − lse)   (causal: key t <= query s)
//   Δ  = rowsum(dO ∘ O)
//   dV = Pᵀ·dO,  dS = P ∘ (dO·Vᵀ − Δ),  dK = dSᵀ·Q/√D,  dQ = dS·K/√D
// with dK and dV summed over the G query heads of a kv head. Every view may
// be strided (a (B, S, H, D) tensor transposed to head-major is read in
// place) as long as D has unit stride and rows are 16-byte aligned; dq has
// q's strides, dk k's and dv v's.
//
// What bounds it on this card: 10·H·D·S(S+1)/2 flops a row (Q·Kᵀ again,
// dV, dP, dQ and dK over the causal half) against a few passes over q, k,
// v, o and dout, so any S past a few dozen is bound by the arithmetic:
// f32-accurate products at 165 TFLOP/s on the tensor cores (3xTF32, three
// TF32 products each), against 67 TFLOP/s of f32 FMA on the CUDA cores.
//
// The design: every product on the tensor cores, mma.sync.m16n8k8 in
// 3xTF32 (tf32x3.cuh), in FlashAttention-2's order (Δ first, then one
// block per kv tile with K and V resident), with dQ folded into the kv
// tiles' blocks where its partials fit a fixed budget:
// - attn_bwd_delta_kernel: Δ, one warp a query row, a shuffle sum in a
//   fixed order.
// - attn_bwd_dkdv_kernel: one block of 8 warps per (64-key kv tile, b, kv
//   head, head part), tile 0 (the most work) first. K and V stay in shared
//   memory; the q tiles (BQ = 32 queries, 16 past D = 160) of every head of
//   the part, from the kv tile's diagonal to S, stream through a 2-stage
//   cp.async ring with their lse and Δ. For each, four warps compute
//   S = Q·Kᵀ and four dP = dO·Vᵀ, a 16 x 32 (16 x 16) share each (each 32
//   of D in a fresh accumulator joined in f32); the first four form P in
//   f32 from lse and write it to shared memory, then the other four form
//   dS = P ∘ (dP − Δ) at their own fragment's places and write it beside.
//   There P and dS are the transposed A operands of dV += Pᵀ·dO and
//   dK += dSᵀ·Q: a warp owns 32 keys and a quarter of D (so a wide head
//   keeps the 64-key tile) and sums each staged q tile in a fresh
//   accumulator joined to its dK, dV registers in f32. Folded, the warps
//   then split the q tile's rows and D for dS·K over the block's 64 keys,
//   the q tile's dQ partial of this kv tile, written to scratch (queries at
//   or past the tile's first key only). Five products in all, where the
//   separate dQ pass recomputes S and dP (seven): folded, qwen3-0.6b's
//   B = 8, S = 512 took 0.64 ms against 0.85 on an H100 at 700 W
//   (scripts/backward_variants.py). Up to D = 128, K and V are split into
//   their TF32 hi and lo parts once, as they land, and kept so (both fit
//   the shared memory): splitting an operand takes five instructions,
//   which were most of what the warps issued.
// - The partials take Σ_t (S − 64t)·B·H·D floats, about S/128 times q's
//   size: past a fixed budget (the wrapper's plan, kernels/flash_prefill.py
//   bwd_plan) the dK/dV blocks skip them and attn_bwd_dq_kernel computes dQ
//   in a pass of its own, one block per (64-query tile, b, head; 32 queries
//   at D = 256), the longest tiles first: Q and dO resident, the K and V
//   tiles up to the diagonal (64 keys, 32 past D = 128) streaming through
//   a 2-stage ring. Its warps split a tile's rows and keys, recompute S and
//   dP, form dS in registers and add dS·K per staged tile in a fresh
//   accumulator; the key warps of a row add their sums in order at the
//   end. Its memory is O(S), as FlashAttention's. It costs time: at
//   B = 1, S = 4096 the fold took 4.05 ms against its 5.41, with 1.09 GB
//   of partials (the same script).
// - attn_bwd_sum_kernel: dQ as the sum of its kv tiles' partials, in tile
//   order (folded); and where the kv tiles alone would not give two blocks
//   an SM (few rows, few kv heads) and the group's heads split into parts,
//   dK and dV as the sums of the parts, in order.
// Shared memory: rows of Q, dO, K, V hold 8·DT + 4 floats and P, dS rows
// 68; both are 4 mod 32. A fragment read along a row (lane (g, t) at row
// g, column t) then hits bank 4g + t, and a transposed one (rows 2t and
// 2t + 1, column g: Pᵀ and dSᵀ as A operands, dO, Q and K as B operands
// whose k runs down the rows; k = t and t + 4 of a step are rows 2t and
// 2t + 1, the k order inside a step being free) bank 8t + g: 32 distinct
// banks either way. dS as the A operand of dS·K reads columns 2t and
// 2t + 1 to match K's rows: two lanes a bank there (a 16th of the loads).
// No float atomics: every sum runs in a fixed order, so a repeat launch
// gives the same bits. Head dims are compiled padded to 32, 64, 128, 160 or
// 256 (zeros past D). The plan (head parts, folded or not) and the scratch
// come from the wrapper.

#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 64;       // keys of a dK/dV block
constexpr int PP = BK + 4;   // row pitch of the P and dS tiles
constexpr int QK_FLUSH = 4;  // k8 steps of Q·Kᵀ and dO·Vᵀ per tensor-core sum

struct Strides {  // elements between neighbours along b, h and s
  long long b, h, s;
};

struct Args {
  const float *q, *k, *v, *o, *dout, *lse;
  float *delta, *dq, *dk, *dv;
  Strides qs, ks, vs, ds;  // q (o, dq), k (dk), v (dv), dout
  int B, S, H, Hkv, D, G;
  float scale;
  int hs;       // head parts of the dK/dV pass
  float* part;  // hs > 1: (2, hs, B, Hkv, S, D) partial dK, then dV
  float* dqp;   // folded: the kv tiles' dQ partials (dq_part_rows); else NULL
};

// d-tiles of 8 columns compiled for a head dim D (4 <= D <= 256, D % 4 == 0)
int d_tiles(int D) { return D <= 32 ? 4 : (D <= 64 ? 8 : (D <= 128 ? 16 : (D <= 160 ? 20 : 32))); }

__host__ __device__ constexpr int row_pitch(int DT) { return 8 * DT + 4; }

// queries of a staged q tile of the dK/dV pass
__host__ __device__ constexpr int kv_pass_bq(int DT) { return DT > 20 ? 16 : 32; }

// Rows (of D floats, for every b and head) of the dQ partials before kv
// tile t's: tile t holds queries t·64 .. S − 1 (kernels/flash_prefill.py
// sizes them with the same sum)
__device__ inline long long dq_part_rows(int t, int S) {
  return (long long)t * S - 32LL * t * (t - 1);
}

// K and V are split into TF32 hi and lo parts once, as they land, where
// both copies fit the shared memory (D <= 128); wider heads split each
// fragment as it is read
__host__ __device__ constexpr bool presplit(int DT) { return DT <= 16; }

template <int DT>
constexpr size_t dkdv_smem_bytes() {
  constexpr int LD = row_pitch(DT), BQ = kv_pass_bq(DT);
  return sizeof(float) * ((size_t)(presplit(DT) ? 4 : 2) * BK * LD + 2 * (2 * BQ * LD + 2 * BQ) +
                          2 * BQ * PP);
}

// Δ = rowsum(dO ∘ O), (B, H, S) contiguous: one warp a row
__global__ void __launch_bounds__(THREADS) attn_bwd_delta_kernel(Args a) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.H * a.S) return;
  const int s = (int)(row % a.S), h = (int)((row / a.S) % a.H);
  const int b = (int)(row / ((long long)a.S * a.H));
  const float* o = a.o + b * a.qs.b + h * a.qs.h + s * a.qs.s;
  const float* d = a.dout + b * a.ds.b + h * a.ds.h + s * a.ds.s;
  float acc = 0.f;
  for (int c = lane * 4; c < a.D; c += 128) {
    const float4 x = *reinterpret_cast<const float4*>(o + c);
    const float4 y = *reinterpret_cast<const float4*>(d + c);
    acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

// The B fragment (k = t4 and t4 + 4 at offsets 0 and ``step``) of a
// staged operand: its hi and lo parts as stored (PRE) or split from f32
template <bool PRE>
__device__ __forceinline__ void b_frag(const float* hi, const float* lo, int step,
                                       unsigned (&bhi)[2], unsigned (&blo)[2]) {
  if (PRE) {
    bhi[0] = __float_as_uint(hi[0]), bhi[1] = __float_as_uint(hi[step]);
    blo[0] = __float_as_uint(lo[0]), blo[1] = __float_as_uint(lo[step]);
  } else {
    split_tf32(hi[0], bhi[0], blo[0]);
    split_tf32(hi[step], bhi[1], blo[1]);
  }
}

// acc[n] (16 rows x 8 columns each) = X·Yᵀ over the padded head dim, for a
// warp's 16 rows of X (at its first row) and 8·NS rows of Y (at its first;
// Ylo its lo parts where PRE); each QK_FLUSH k8 steps sum in a fresh
// accumulator joined in f32
template <int DT, int NS, int LD, bool PRE>
__device__ __forceinline__ void dots(float (&acc)[NS][4], const float* X, const float* Y,
                                     const float* Ylo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* xa = X + g * LD + t4;
#pragma unroll
  for (int n = 0; n < NS; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < DT; k0 += QK_FLUSH) {
    float part[NS][4] = {};
#pragma unroll
    for (int kk = k0; kk < k0 + QK_FLUSH; ++kk) {
      const float* p = xa + kk * 8;
      const float v[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[i], alo[i]);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int o = (n * 8 + g) * LD + kk * 8 + t4;
        unsigned bhi[2], blo[2];
        b_frag<PRE>(Y + o, Ylo + o, 4, bhi, blo);
        mma_3xtf32(part[n], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += part[n][i];
  }
}

// acc (a warp's 32 keys x 8·DQ columns) += Xᵀ·Y over the BQ rows of a
// staged q tile: X the [BQ][PP] P or dS tile at the warp's first key, Y
// the [BQ][LD] dO or Q tile at the warp's first column. k = t and t + 4 of
// k8 step ks are rows 8ks + 2t and 8ks + 2t + 1 (the k order inside a step
// is free). Each 8 columns' sum over the tile is a fresh accumulator.
template <int BQ, int DQ, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[2][DQ][4], const float* X,
                                           const float* Y) {
  constexpr int KS = BQ / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  unsigned ahi[KS][2][4], alo[KS][2][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* p = X + (8 * ks + 2 * t4) * PP + 16 * m + g;
      const float v[4] = {p[0], p[8], p[PP], p[PP + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[ks][m][i], alo[ks][m][i]);
    }
#pragma unroll
  for (int dt = 0; dt < DQ; ++dt) {
    float f[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* yb = Y + (8 * ks + 2 * t4) * LD + dt * 8 + g;
      unsigned bhi[2], blo[2];
      split_tf32(yb[0], bhi[0], blo[0]);
      split_tf32(yb[LD], bhi[1], blo[1]);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_3xtf32(f[m], ahi[ks][m], alo[ks][m], bhi, blo);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][dt][i] += f[m][i];
  }
}

template <int DT>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dkdv_kernel(Args a) {
  constexpr bool PRE = presplit(DT);
  constexpr int LD = row_pitch(DT), BQ = kv_pass_bq(DT);
  constexpr int WQ = BQ / 16;        // row groups of a q tile
  constexpr int KW = BK * WQ / 4;    // keys of a score warp's share: 32 or 16
  constexpr int NSK = KW / 8;
  constexpr int DQ = DT / 4;         // d-tiles of a warp's dK, dV share
  constexpr int WD = WARPS / WQ, DW = DT / WD;  // dS·K: warps of a row, their d-tiles
  constexpr int C4 = 2 * DT;         // 16-byte chunks of a staged row
  constexpr int STAGE = 2 * BQ * LD + 2 * BQ;  // Q, dO, lse, Δ
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // K (its hi parts where PRE)
  float* Vs = Ks + BK * LD;
  float* Klo = Vs + BK * LD;                    // where PRE: the lo parts
  float* Vlo = Klo + BK * LD;
  float* ring = Vs + (PRE ? 3 : 1) * BK * LD;
  float* Ps = ring + 2 * STAGE;
  float* dSs = Ps + BQ * PP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // (kv tile, b, kv head, head part), the tile slowest: tile 0 first
  const int per_tile = a.B * a.Hkv * a.hs;
  const int tile = (int)(blockIdx.x / per_tile), rest = (int)(blockIdx.x % per_tile);
  const int b = rest / (a.Hkv * a.hs), hkv = (rest / a.hs) % a.Hkv, hp = rest % a.hs;
  const int k0 = tile * BK, S = a.S, D = a.D;
  const int g_lo = hp * a.G / a.hs, g_hi = (hp + 1) * a.G / a.hs;
  const int nq = (S - k0 + BQ - 1) / BQ;  // q tiles from the diagonal (k0) to S
  const int items = (g_hi - g_lo) * nq;

  const float* kb = a.k + b * a.ks.b + hkv * a.ks.h;
  const float* vb = a.v + b * a.vs.b + hkv * a.vs.h;
  for (int e = tid; e < BK * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, t = k0 + r;
    const bool ok = t < S && c < D;
    cp_async16(Ks + r * LD + c, ok ? kb + t * a.ks.s + c : kb, ok);
    cp_async16(Vs + r * LD + c, ok ? vb + t * a.vs.s + c : vb, ok);
  }
  auto load_item = [&](int i) {  // item i: head g_lo + i / nq, q tile i % nq
    float* st = ring + (i & 1) * STAGE;
    const int hq = hkv * a.G + g_lo + i / nq, q0 = k0 + (i % nq) * BQ;
    const float* qb = a.q + b * a.qs.b + hq * a.qs.h;
    const float* db = a.dout + b * a.ds.b + hq * a.ds.h;
    for (int e = tid; e < BQ * C4; e += THREADS) {
      const int r = e / C4, c = (e % C4) * 4, s = q0 + r;
      const bool ok = s < S && c < D;
      cp_async16(st + r * LD + c, ok ? qb + s * a.qs.s + c : qb, ok);
      cp_async16(st + (BQ + r) * LD + c, ok ? db + s * a.ds.s + c : db, ok);
    }
    const size_t row = ((size_t)b * a.H + hq) * S + q0;
    for (int r = tid; r < BQ; r += THREADS) {
      const bool ok = q0 + r < S;
      cp_async4(st + 2 * BQ * LD + r, ok ? a.lse + row + r : a.lse, ok);
      cp_async4(st + 2 * BQ * LD + BQ + r, ok ? a.delta + row + r : a.delta, ok);
    }
  };
  load_item(0);
  cp_async_commit();  // K, V and the first q tile

  // scores: warps 0-3 S = Q·Kᵀ, warps 4-7 dP = dO·Vᵀ, each rows 16·wq and
  // keys KW·kg of the tile
  const bool is_s = warp < 4;
  const int wq = warp % WQ, kg = (warp % 4) / WQ;
  const int km = warp % 2, dq4 = warp / 2;  // dK, dV: keys 32·km, d-tiles DQ·dq4
  float dk[2][DQ][4] = {}, dv[2][DQ][4] = {};
  for (int i = 0; i < items; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // item i landed; every warp is done with item i − 1
    if (i + 1 < items) load_item(i + 1);
    cp_async_commit();
    if (PRE && i == 0) {  // K and V as TF32 hi and lo parts, once
      for (int e = tid; e < BK * LD; e += THREADS) {
        unsigned hi, lo;
        split_tf32(Ks[e], hi, lo);
        Ks[e] = __uint_as_float(hi), Klo[e] = __uint_as_float(lo);
        split_tf32(Vs[e], hi, lo);
        Vs[e] = __uint_as_float(hi), Vlo[e] = __uint_as_float(lo);
      }
      __syncthreads();
    }
    const float* Qs = ring + (i & 1) * STAGE;
    const float* dOs = Qs + BQ * LD;
    const float* ls = dOs + BQ * LD;
    const float* dls = ls + BQ;
    const int q0 = k0 + (i % nq) * BQ;

    float sc[NSK][4];
    const int ko = KW * kg * LD;
    if (is_s)
      dots<DT, NSK, LD, PRE>(sc, Qs + 16 * wq * LD, Ks + ko, Klo + ko);
    else
      dots<DT, NSK, LD, PRE>(sc, dOs + 16 * wq * LD, Vs + ko, Vlo + ko);
    // P (score warps) to Ps; then dS = P ∘ (dP − Δ) (dP warps, from the P
    // at their own fragment's places) to dSs. c0, c1 are row r's keys 2t4,
    // 2t4 + 1 of a slice, c2, c3 row r + 8's
    if (is_s) {
#pragma unroll
      for (int n = 0; n < NSK; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * wq + g + 8 * hh, s = q0 + r;
          const int c = KW * kg + n * 8 + 2 * t4, t = k0 + c;
          float pr[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            pr[j] = (s < S && t + j <= s) ? expf(sc[n][2 * hh + j] * a.scale - ls[r]) : 0.f;
          *reinterpret_cast<float2*>(Ps + r * PP + c) = make_float2(pr[0], pr[1]);
        }
    }
    __syncthreads();
    if (!is_s) {
#pragma unroll
      for (int n = 0; n < NSK; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * wq + g + 8 * hh, c = KW * kg + n * 8 + 2 * t4;
          const float2 pr = *reinterpret_cast<const float2*>(Ps + r * PP + c);
          *reinterpret_cast<float2*>(dSs + r * PP + c) =
              make_float2(pr.x * (sc[n][2 * hh] - dls[r]), pr.y * (sc[n][2 * hh + 1] - dls[r]));
        }
    }
    __syncthreads();
    accumulate<BQ, DQ, LD>(dv, Ps + 32 * km, dOs + DQ * dq4 * 8);
    accumulate<BQ, DQ, LD>(dk, dSs + 32 * km, Qs + DQ * dq4 * 8);

    if (a.dqp == nullptr) continue;  // dQ has a pass of its own
    // this q tile's dQ partial: dS·K over the block's keys, rows 16·(warp
    // % WQ), d-tiles DW·(warp / WQ); k = t4 and t4 + 4 of a step are keys
    // 2t4 and 2t4 + 1
    const int rq = 16 * (warp % WQ), d0 = (warp / WQ) * DW;
    float f[DW][4] = {};
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const float* pa = dSs + (rq + g) * PP + 8 * ks + 2 * t4;
      const float v[4] = {pa[0], pa[8 * PP], pa[1], pa[8 * PP + 1]};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(v[j], ahi[j], alo[j]);
#pragma unroll
      for (int dt = 0; dt < DW; ++dt) {
        const int o = (8 * ks + 2 * t4) * LD + (d0 + dt) * 8 + g;
        unsigned bhi[2], blo[2];
        b_frag<PRE>(Ks + o, Klo + o, LD, bhi, blo);
        mma_3xtf32(f[dt], ahi, alo, bhi, blo);
      }
    }
    const int hq = hkv * a.G + g_lo + i / nq;
    float* dst = a.dqp + (dq_part_rows(tile, S) * a.B * a.H +
                          ((size_t)b * a.H + hq) * (S - k0)) * D;
#pragma unroll
    for (int dt = 0; dt < DW; ++dt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = q0 + rq + g + 8 * hh, col = (d0 + dt) * 8 + 2 * t4;
        if (s < S && col < D)
          *reinterpret_cast<float2*>(dst + (size_t)(s - k0) * D + col) =
              make_float2(f[dt][2 * hh] * a.scale, f[dt][2 * hh + 1] * a.scale);
      }
  }

  const size_t part_n = (size_t)a.hs * a.B * a.Hkv * S * D;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = k0 + 32 * km + 16 * m + g + 8 * hh;
      if (t >= S) continue;
      float* dkr = a.dk + b * a.ks.b + hkv * a.ks.h + t * a.ks.s;
      float* dvr = a.dv + b * a.vs.b + hkv * a.vs.h + t * a.vs.s;
      if (a.hs > 1) {  // this head part's sums, added by attn_bwd_sum_kernel
        dkr = a.part + ((((size_t)hp * a.B + b) * a.Hkv + hkv) * S + t) * D;
        dvr = dkr + part_n;
      }
#pragma unroll
      for (int dt = 0; dt < DQ; ++dt) {
        const int col = (DQ * dq4 + dt) * 8 + 2 * t4;
        if (col >= D) continue;
        *reinterpret_cast<float2*>(dkr + col) =
            make_float2(dk[m][dt][2 * hh] * a.scale, dk[m][dt][2 * hh + 1] * a.scale);
        *reinterpret_cast<float2*>(dvr + col) =
            make_float2(dv[m][dt][2 * hh], dv[m][dt][2 * hh + 1]);
      }
    }
}

// The separate dQ pass's tiles: WR row groups of 16 queries a block, KB
// keys a staged K/V tile
template <int DT>
struct DqTile {
  static constexpr int WR = DT > 20 ? 2 : 4;
  static constexpr int KB = DT > 16 ? 32 : 64;
};

template <int DT>
constexpr size_t dq_smem_bytes() {
  constexpr int LD = row_pitch(DT), ROWS = 16 * DqTile<DT>::WR, KB = DqTile<DT>::KB;
  return sizeof(float) * ((size_t)2 * ROWS * LD + 2 * ROWS + 2 * 2 * KB * LD);
}

// dQ of one (q tile, b, head), where the dK/dV blocks do not fold it in
template <int DT>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dq_kernel(Args a, int n_q_tiles) {
  constexpr int LD = row_pitch(DT), C4 = 2 * DT;
  constexpr int WR = DqTile<DT>::WR, KB = DqTile<DT>::KB;
  constexpr int WK = WARPS / WR, ROWS = 16 * WR;  // the key warps of a row group
  constexpr int NS = KB / WK / 8;                 // n-tiles of a warp's keys
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + ROWS * LD;
  float* ls = dOs + ROWS * LD;
  float* dls = ls + ROWS;
  float* ring = dls + ROWS;  // 2 stages of K, V; at the end the warps' sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // (q tile, b, head), the last tile (the most keys) first
  const int tile = n_q_tiles - 1 - (int)(blockIdx.x / (a.B * a.H));
  const int b = (int)((blockIdx.x % (a.B * a.H)) / a.H), hq = (int)(blockIdx.x % a.H);
  const int hkv = hq / a.G, q0 = tile * ROWS, S = a.S, D = a.D;
  const int n_kv = (min(q0 + ROWS, S) + KB - 1) / KB;  // K/V tiles up to the diagonal
  const float* qb = a.q + b * a.qs.b + hq * a.qs.h;
  const float* db = a.dout + b * a.ds.b + hq * a.ds.h;
  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, s = q0 + r;
    const bool ok = s < S && c < D;
    cp_async16(Qs + r * LD + c, ok ? qb + s * a.qs.s + c : qb, ok);
    cp_async16(dOs + r * LD + c, ok ? db + s * a.ds.s + c : db, ok);
  }
  const size_t row0 = ((size_t)b * a.H + hq) * S + q0;
  for (int r = tid; r < ROWS; r += THREADS) {
    const bool ok = q0 + r < S;
    cp_async4(ls + r, ok ? a.lse + row0 + r : a.lse, ok);
    cp_async4(dls + r, ok ? a.delta + row0 + r : a.delta, ok);
  }
  const float* kb = a.k + b * a.ks.b + hkv * a.ks.h;
  const float* vb = a.v + b * a.vs.b + hkv * a.vs.h;
  auto load_kv = [&](int u) {
    float* ks = ring + (u & 1) * 2 * KB * LD;
    float* vs = ks + KB * LD;
    for (int e = tid; e < KB * C4; e += THREADS) {
      const int r = e / C4, c = (e % C4) * 4, t = u * KB + r;
      const bool ok = t < S && c < D;
      cp_async16(ks + r * LD + c, ok ? kb + t * a.ks.s + c : kb, ok);
      cp_async16(vs + r * LD + c, ok ? vb + t * a.vs.s + c : vb, ok);
    }
  };
  load_kv(0);
  cp_async_commit();  // Q, dO, lse, Δ and the first K/V tile
  const int wr = warp / WK, wk = warp % WK;  // rows 16·wr, keys kw .. kw + 8·NS
  const int kw = wk * NS * 8;
  float dq[DT][4] = {};
  for (int u = 0; u < n_kv; ++u) {
    cp_async_wait<0>();
    __syncthreads();  // tile u landed; every warp is done with tile u − 1
    if (u + 1 < n_kv) load_kv(u + 1);
    cp_async_commit();
    const float* Ks = ring + (u & 1) * 2 * KB * LD;
    const float* Vs = Ks + KB * LD;
    float sc[NS][4], dp[NS][4];
    dots<DT, NS, LD, false>(sc, Qs + 16 * wr * LD, Ks + kw * LD, nullptr);
    dots<DT, NS, LD, false>(dp, dOs + 16 * wr * LD, Vs + kw * LD, nullptr);
    // dS in f32 at the score fragment's places, then as the A operand of
    // dS·K: k = t4 and t4 + 4 of a step are keys 2t4 and 2t4 + 1
    unsigned dhi[NS][4], dlo[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * wr + g + 8 * (i >> 1), s = q0 + r;
        const int t = u * KB + kw + n * 8 + 2 * t4 + (i & 1);
        const float p = (s < S && t <= s) ? expf(sc[n][i] * a.scale - ls[r]) : 0.f;
        d[i] = p * (dp[n][i] - dls[r]);
      }
      const float v[4] = {d[0], d[2], d[1], d[3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], dhi[n][i], dlo[n][i]);
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float f[4] = {};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* kr = Ks + (kw + n * 8 + 2 * t4) * LD + dt * 8 + g;
        unsigned bhi[2], blo[2];
        split_tf32(kr[0], bhi[0], blo[0]);
        split_tf32(kr[LD], bhi[1], blo[1]);
        mma_3xtf32(f, dhi[n], dlo[n], bhi, blo);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[dt][i] += f[i];
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* Os = ring;  // [WK][ROWS][LD]: each key warp's sums
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    float* p = Os + (wk * ROWS + 16 * wr + g) * LD + dt * 8 + 2 * t4;
    *reinterpret_cast<float2*>(p) = make_float2(dq[dt][0], dq[dt][1]);
    *reinterpret_cast<float2*>(p + 8 * LD) = make_float2(dq[dt][2], dq[dt][3]);
  }
  __syncthreads();
  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, s = q0 + r;
    if (c >= D || s >= S) continue;
    float4 x = *reinterpret_cast<const float4*>(Os + r * LD + c);
#pragma unroll
    for (int k = 1; k < WK; ++k) {  // the key warps in order
      const float4 y = *reinterpret_cast<const float4*>(Os + (k * ROWS + r) * LD + c);
      x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
    }
    *reinterpret_cast<float4*>(a.dq + b * a.qs.b + hq * a.qs.h + s * a.qs.s + c) =
        make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale);
  }
}

// blockIdx.y 0 where dQ is folded: dQ as the sum of the kv tiles'
// partials, in tile order; else dK and dV as the sums of the head parts'
// partials, in part order
__global__ void __launch_bounds__(THREADS) attn_bwd_sum_kernel(Args a) {
  const int D4 = a.D / 4, S = a.S;
  const bool dq = a.dqp != nullptr && blockIdx.y == 0;
  const int heads = dq ? a.H : a.Hkv;
  const size_t n4 = (size_t)a.B * heads * S * D4, part_n = 4 * n4 * a.hs;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * THREADS) {
    const int c = (int)(e % D4) * 4, s = (int)((e / D4) % S);
    const int h = (int)((e / ((size_t)D4 * S)) % heads);
    const int b = (int)(e / ((size_t)D4 * S * heads));
    if (dq) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int t = 0; t <= s / BK; ++t) {
        const float* p = a.dqp + (dq_part_rows(t, S) * a.B * a.H +
                                  ((size_t)b * a.H + h) * (S - t * BK) + s - t * BK) * a.D;
        const float4 y = *reinterpret_cast<const float4*>(p + c);
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
      *reinterpret_cast<float4*>(a.dq + b * a.qs.b + h * a.qs.h + s * a.qs.s + c) = x;
      continue;
    }
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int hp = 0; hp < a.hs; ++hp) {
      const float* pk = a.part + ((((size_t)hp * a.B + b) * a.Hkv + h) * S + s) * a.D + c;
      const float4 x = *reinterpret_cast<const float4*>(pk);
      const float4 y = *reinterpret_cast<const float4*>(pk + part_n);
      sk.x += x.x, sk.y += x.y, sk.z += x.z, sk.w += x.w;
      sv.x += y.x, sv.y += y.y, sv.z += y.z, sv.w += y.w;
    }
    *reinterpret_cast<float4*>(a.dk + b * a.ks.b + h * a.ks.h + s * a.ks.s + c) = sk;
    *reinterpret_cast<float4*>(a.dv + b * a.vs.b + h * a.vs.h + s * a.vs.s + c) = sv;
  }
}

template <int DT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<DT>(), q_smem = dq_smem_bytes<DT>();
  constexpr int ROWS = 16 * DqTile<DT>::WR;
  const bool fold = a.dqp != nullptr;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (!fold) {
    err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long rows = (long long)a.B * a.H * a.S;
  const long long delta_blocks = (rows + WARPS - 1) / WARPS;
  const long long kv_blocks = (long long)((a.S + BK - 1) / BK) * a.B * a.Hkv * a.hs;
  const int n_q_tiles = (a.S + ROWS - 1) / ROWS;
  const long long q_blocks = fold ? 0 : (long long)n_q_tiles * a.B * a.H;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  attn_bwd_delta_kernel<<<(unsigned)delta_blocks, THREADS, 0, stream>>>(a);
  attn_bwd_dkdv_kernel<DT><<<(unsigned)kv_blocks, THREADS, smem, stream>>>(a);
  if (!fold)
    attn_bwd_dq_kernel<DT><<<(unsigned)q_blocks, THREADS, q_smem, stream>>>(a, n_q_tiles);
  const unsigned sums = (fold ? 1 : 0) + (a.hs > 1 ? 1 : 0);
  if (sums > 0) {
    const long long blocks = (rows * (a.D / 4) + THREADS - 1) / THREADS;
    attn_bwd_sum_kernel<<<dim3((unsigned)(blocks < 8192 ? blocks : 8192), sums), THREADS, 0,
                          stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, o and dq share q's strides, dk has k's and dv v's; lse is (B, H, S)
// contiguous. The wrapper's plan gives hs, the head parts of the dK/dV
// pass, and the scratch: delta (B, H, S); part, (2, hs, B, Hkv, S, D)
// where hs > 1, else NULL; dqp, the kv tiles' dQ partials where dQ is
// folded into the dK/dV blocks, else NULL (a pass of its own). All 16-byte
// aligned.
extern "C" int flash_prefill_bwd_launch(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    const float* lse, float* delta, float* part, float* dqp, float* dq, float* dk, float* dv,
    int B, int S, int H, int Hkv, int D, int hs, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long dsb, long long dsh, long long dss, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 4 != 0 || D <= 0 || D > 256 ||
      hs < 1 || hs > H / Hkv || (hs > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, lse, delta, dq, dk, dv,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {dsb, dsh, dss},
         B, S, H, Hkv, D, H / Hkv, 1.f / sqrtf((float)D), hs, part, dqp};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (d_tiles(D)) {
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    case 16: return launch<16>(a, st);
    case 20: return launch<20>(a, st);
    default: return launch<32>(a, st);
  }
}

extern "C" const char* flash_prefill_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
