// The causal GQA attention tile loop of ragged_extend.cu and flash_prefill.cu,
// on the tensor cores of Hopper (sm_90a): f32 inputs with f32 accuracy
// (3xTF32), or bf16 inputs with f32 sums (see "bf16" below).
//
// A source hands attend() one block's work: a q tile of query tokens, the
// keys each token may see, the range of K/V tiles to walk, and where the
// result goes. The source keeps its own index arithmetic in a small struct
// (Src below): where the q, k, v and out vectors of a token and head lie.
//
// What bounds the loop on this card: 4·D flops per (query vector, key) over
// (query vectors + 2·keys)·D·4 bytes per group of G heads, so a q tile of
// dozens of vectors against a prefix of hundreds of keys is bound by the
// arithmetic. f32-accurate products run at 165 TFLOP/s on the tensor cores
// (495 TFLOP/s TF32, three products each) against 67 TFLOP/s of f32 FMA on
// the CUDA cores.
//
// The design:
// - A block is 8 warps. Its q tile holds ROWS = 16·WR query vectors of one
//   KV group, packed into the rows of the mma tile so the G heads of the
//   group share every staged K/V tile. The vectors of a (row, kv head) are
//   numbered v = s·G + h (token s, head h of the group) and tile i takes
//   vectors i·ROWS .. i·ROWS + ROWS − 1, so any G fits: where G does not
//   divide ROWS a token's heads straddle two tiles (G = 7 at 16 rows: 2
//   tokens and 2 heads of a third), and rows past the S·G vectors are
//   dead (never live, never written). The warps form a WR x WK grid
//   (WR·WK = 8) and warp (wr, wk) owns rows 16·wr .. 16·wr + 15.
// - Narrow heads (D <= 128): warp (wr, wk) takes keys 8·WR·wk ..
//   8·WR·(wk + 1) − 1 of every 64-key K/V tile. A large tile (ROWS = 128,
//   WK = 1) gives each warp all 64 keys; the engine's small buckets (S·G
//   down to 16 vectors) give the idle row slots' warps a share of the keys
//   instead, so no 128-row tile runs mostly empty. The WK partial results
//   of a row meet once, at the end, in shared memory.
// - Wide heads (D = 136 .. 256): a warp's 16 x D share of O and of a tile's
//   fresh P·V sums would not fit its registers, and a 64-key K/V stage of
//   D = 256 not the shared memory. So K and V are staged 32 keys at a time
//   (two stages per 64-key tile of the caller's schedule), q tiles hold at
//   most 64 rows (WK >= 2), and the WK warps of a row split D instead of
//   the keys: each computes the row's scores for all 32 keys (the same
//   bits in every warp of the row) and P·V for its own d-tiles. Q·Kᵀ is
//   then done WK times over; speed at these widths is later work.
// - S = Q·Kᵀ: mma.sync.m16n8k8 in 3xTF32 (tf32x3.cuh). K's [t][d] rows are
//   the column-major B operand as they lie; row pitches of 8·DT + 4 floats
//   put every fragment load of a warp on 32 banks. Each 32 of D sum in a
//   fresh accumulator that joins the score with a rounded f32 add: the
//   tensor cores round their sums toward zero, a bias that grows with the
//   products one accumulator sums, and a score's sum over all of D in one
//   accumulator more than doubled the error on the card.
// - Online softmax on the accumulator fragment: a row's scores live in one
//   quad of 4 lanes, so its max and sum take 2 shuffles. Scores are scaled
//   by 1/√D (a multiply in f32: dividing by √D cost a sixth of the loop's
//   time) and exponentiated with f32 expf; masked probabilities are
//   exactly 0, so a fully masked or padded row keeps l == 0.
// - P·V: P goes from the accumulator layout to the A operand without a
//   shuffle. The accumulator holds columns 2t, 2t + 1 of each 8-key slice
//   where the A operand wants k = t, t + 4; the k order inside a slice is
//   free, so k = t reads key 2t and k = t + 4 key 2t + 1, and V's B
//   fragment reads rows 2t and 2t + 1 to match. P (in [0, 1]) is split
//   hi/lo like every operand: one TF32 product misses the 1e-5 tolerance.
//   A staged tile's P·V sums in fresh accumulators, one per 8 columns (DT
//   independent chains of mma, DT/WK for a wide head), then O = α·O + that
//   in f32: the flash recurrence, and the flush that keeps the tensor
//   cores' round-toward-zero sums to one staged tile.
// - The loop walks only the K/V tiles the caller gives it; callers stop it
//   at min(row frontier, the q tile's causal diagonal). Rows of tokens past
//   the live ones come out as exact zeros. Sums run in a fixed order:
//   repeat launches give the same bits.
// - Why mma.sync and not wgmma: TF32 wgmma reads B from shared memory
//   K-major only. For S = Q·Kᵀ the B operand is Kᵀ, and K's [t][d] rows
//   are K-major: that would fit. For P·V the B operand is V, [t][d] with
//   the reduction over t: N-major, which TF32 wgmma does not read without
//   a transpose of every V tile in shared memory. wgmma is later work.
//
// Registers: at D = 128 and 128 rows a thread holds its share of the
// warp's 16 x 128 O (64 floats), of the tile's fresh P·V sums (64) and of
// the 16 x 64 scores (32): 249-252 registers without spills, one block of
// 8 warps per SM, as the shared memory also sets. What holds the loop below
// its bound is then the rate of mma.sync: three TF32 products per f32
// product, each issued by a warp, at a rate well below wgmma's, with 8
// warps to hide their latency. Dropping two of the three products (which
// breaks the tolerance) nearly halves the loop's time on the card
// (scripts/attention_variants.py). A wide head at 64 rows and WK = 2 holds
// 16 d-tiles of O and of the fresh sums a warp, as D = 128 does.

#pragma once

#include "bf16_mma.cuh"

namespace {
namespace attn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BKV = 64;               // keys per K/V tile of the callers' schedule
constexpr int STAGES = 2;             // staged K/V tiles in the cp.async ring
constexpr int MAX_ROWS = 16 * WARPS;  // query vectors per block, at most
constexpr int MAX_D = 256;
constexpr int NARROW_D = 128;         // wider heads take the wide tiles
constexpr int QK_FLUSH = 4;           // k8 steps of Q·Kᵀ per tensor-core sum (f32)
constexpr int QK_FLUSH16 = 2;         // k16 steps of the same 32 of D (bf16)
constexpr float NEG_INF = -1e30f;

// d-tiles of 8 columns compiled for a head dim D (4 <= D <= 256, D % 4 == 0)
__host__ __device__ inline int d_tiles(int D) {
  return D <= 32 ? 4 : (D <= 64 ? 8 : (D <= 128 ? 16 : (D <= 160 ? 20 : 32)));
}

__host__ __device__ constexpr bool is_wide(int DT) { return DT > NARROW_D / 8; }

// keys of a staged K/V tile: half a schedule tile for a wide head
__host__ __device__ constexpr int stage_keys(int DT) { return is_wide(DT) ? BKV / 2 : BKV; }

// The q tile's rows for ``vectors`` = S·G query vectors of a (row, kv
// head): the smallest of 16, 32, 64 and 128 that holds them all, up to 128
// (64 for a wide head).
__host__ __device__ inline int tile_rows(int vectors, int D) {
  const int most = D > NARROW_D ? MAX_ROWS / 2 : MAX_ROWS;
  int rows = 16;
  while (rows < most && rows < vectors) rows *= 2;
  return rows;
}

// row pitch (elements) of a staged tile: f32 8·DT + 4, bf16 8·DT + 8
template <class T>
__host__ __device__ constexpr int row_pitch(int DT) {
  return sizeof(T) == 4 ? 8 * DT + 4 : 8 * DT + 8;
}

// dynamic shared memory of a block: the q tile, then the K/V ring; the
// epilogue's f32 partial rows reuse all of it
template <class T, int WR, int DT>
constexpr size_t smem_bytes() {
  constexpr int ROWS = 16 * WR, WKE = is_wide(DT) ? 1 : WARPS / WR;
  constexpr size_t loop =
      sizeof(T) * (size_t)(ROWS + STAGES * 2 * stage_keys(DT)) * row_pitch<T>(DT);
  constexpr size_t epilogue =
      sizeof(float) * ((size_t)WKE * ROWS * row_pitch<float>(DT) + (3 * WKE + 1) * ROWS);
  return loop > epilogue ? loop : epilogue;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One block's attention. Src gives the addresses (h is the head within
// the group, 0 .. G − 1), T being the element type:
//   const T* q_at(int s, int h), k_at(int t), v_at(int t), any();
//   T* o_at(int s, int h); size_t part_at(int s, int h);
//   float* lse_at(int s, int h): where a row's log-sum-exp of its scaled
//   scores goes (for a backward pass, or to merge partial attentions over
//   parts of the keys), or nullptr for none; -inf for a padded row.
// Row r of the tile is query vector v_lo + r, token (v_lo + r) / G, head
// (v_lo + r) % G; tokens below q_hi (<= S) are live, and token s sees keys
// t < kv_end with t <= pos0 + s. The loop walks K/V tiles j0 .. j1 − 1 of
// 64 keys (keys 64·j0 .. 64·j1 − 1, j1 >= j0 + 1). With part_o == nullptr
// it writes each live row's attention, and zeros for the other rows of
// tokens below S, through o_at. Otherwise it writes each live row's
// unnormalised sum Σ p·v to part_o + part_at(s, h)·D and its max and sum
// of p to part_ml + 2·part_at(s, h), for a combine pass.
template <class T, int WR, int DT, class Src>
__device__ __forceinline__ void attend(const Src& src, float4* smem4, int G, int D, int S,
                                       int v_lo, int q_hi, int pos0, int kv_end, int j0,
                                       int j1, float* part_o, float* part_ml) {
  constexpr bool WIDE = is_wide(DT);
  constexpr int ROWS = 16 * WR;
  constexpr int WK = WARPS / WR;  // warps that share a row
  constexpr int BK = stage_keys(DT);  // keys of a staged K/V tile
  constexpr int SUB = BKV / BK;       // staged tiles per schedule tile
  // 8-key slices of a warp's part of a staged tile: a share of the keys
  // (narrow), all of them (wide)
  constexpr int NS = WIDE ? BK / 8 : BK / WK / 8;
  constexpr int DW = WIDE ? (DT + WK - 1) / WK : DT;  // P·V d-tiles of a warp, at most
  constexpr int WKE = WIDE ? 1 : WK;  // partial rows that meet in the epilogue
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int LD = row_pitch<T>(DT);
  constexpr int C4 = 2 * DT;  // 4-element chunks of a staged row
  static_assert(!WIDE || WK >= 2, "a wide head splits D over the warps of a row");
  T* Qs = reinterpret_cast<T*>(smem4);  // [ROWS][LD]
  T* ring = Qs + ROWS * LD;             // STAGES x (K [BK][LD], V [BK][LD])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / WK, wk = warp % WK;
  const int r0 = 16 * wr + g, r1 = r0 + 8;  // this thread's two rows
  const int s0 = (v_lo + r0) / G, s1 = (v_lo + r1) / G;
  const bool live0 = s0 < q_hi, live1 = s1 < q_hi;
  const int lim0 = min(pos0 + s0 + 1, kv_end), lim1 = min(pos0 + s1 + 1, kv_end);
  const float scale = 1.f / sqrtf((float)D);  // scores times 1/√D: a multiply
  const int kw0 = WIDE ? 0 : wk * NS * 8;     // this warp's first key of a staged tile
  // a wide head's d-tiles of this warp: dlo .. dlo + dn − 1
  const int dlo = WIDE ? wk * DT / WK : 0;
  const int dn = WIDE ? (wk + 1) * DT / WK - dlo : DT;

  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, vec = v_lo + r, s = vec / G;
    const bool ok = s < q_hi && c < D;
    cp_chunk(Qs + r * LD + c, ok ? src.q_at(s, vec % G) + c : src.any(), ok);
  }
  auto load_kv = [&](int stage, int u) {  // staged tile u: keys u·BK ..
    T* ks = ring + stage * 2 * BK * LD;
    T* vs = ks + BK * LD;
    for (int e = tid; e < BK * C4; e += THREADS) {
      const int r = e / C4, c = (e % C4) * 4, t = u * BK + r;
      const bool ok = t < kv_end && c < D;
      cp_chunk(ks + r * LD + c, ok ? src.k_at(t) + c : src.any(), ok);
      cp_chunk(vs + r * LD + c, ok ? src.v_at(t) + c : src.any(), ok);
    }
  };
  const int u0 = j0 * SUB;
  int u1 = j1 * SUB;
  if (WIDE) u1 = min(u1, (kv_end + BK - 1) / BK);  // a half tile past the keys: nothing
  load_kv(0, u0);
  cp_async_commit();  // Q and the first K/V tile

  float o[DW][4] = {};
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  for (int u = u0; u < u1; ++u) {
    if (u + 1 < u1) load_kv((u + 1 - u0) % STAGES, u + 1);
    cp_async_commit();  // an empty group at the end keeps the count uniform
    cp_async_wait<1>();  // tile u (and Q) landed, for this thread's copies
    __syncthreads();
    const T* ks = ring + ((u - u0) % STAGES) * 2 * BK * LD;
    const T* vs = ks + BK * LD;
    const int key0 = u * BK + kw0;  // this warp's first key

    // S = Q·Kᵀ for 16 rows x NS·8 keys, each 32 of D in a fresh
    // accumulator added to the scores in f32. The loop over the chunks
    // stays rolled: unrolled, the compiler hoists the loads of later chunks
    // and spills at D = 128.
    float sc[NS][4] = {};
    if constexpr (BF16) {
      const T* qa = Qs + r0 * LD + 2 * t4;
#pragma unroll 1
      for (int k0 = 0; k0 < DT / 2; k0 += QK_FLUSH16) {
        float part[NS][4] = {};
#pragma unroll
        for (int kk = k0; kk < k0 + QK_FLUSH16; ++kk) {
          const T* p = qa + kk * 16;
          const unsigned a[4] = {lds_pair(p), lds_pair(p + 8 * LD), lds_pair(p + 8),
                                 lds_pair(p + 8 * LD + 8)};
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const T* kb = ks + (kw0 + n * 8 + g) * LD + kk * 16 + 2 * t4;
            const unsigned b[2] = {lds_pair(kb), lds_pair(kb + 8)};
            mma_bf16(part[n], a, b);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[n][i] += part[n][i];
      }
    } else {
    const float* qa = Qs + r0 * LD + t4;
#pragma unroll 1
    for (int k0 = 0; k0 < DT; k0 += QK_FLUSH) {
      float part[NS][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + QK_FLUSH; ++kk) {
        const float* p = qa + kk * 8;
        const float a[4] = {p[0], p[8 * LD], p[4], p[8 * LD + 4]};
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* kb = ks + (kw0 + n * 8 + g) * LD + kk * 8 + t4;
          unsigned bhi[2], blo[2];
          split_tf32(kb[0], bhi[0], blo[0]);
          split_tf32(kb[4], bhi[1], blo[1]);
          mma_3xtf32(part[n], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[n][i] += part[n][i];
    }
    }

    // online softmax: c0, c1 are row r0's keys 2t4, 2t4 + 1 of a slice, c2,
    // c3 row r1's
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = key0 + n * 8 + 2 * t4 + (i & 1);
        const bool valid = i < 2 ? (live0 && t < lim0) : (live1 && t < lim1);
        sc[n][i] = valid ? sc[n][i] * scale : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sc[n][i] = sc[n][i] == NEG_INF ? 0.f : expf(sc[n][i] - (i < 2 ? mn0 : mn1));
      ps0 += sc[n][0] + sc[n][1];
      ps1 += sc[n][2] + sc[n][3];
    }
    l0 = l0 * al0 + quad_sum(ps0);
    l1 = l1 * al1 + quad_sum(ps1);

    // O = α·O + P·V, the tile's P·V in fresh accumulators (one per 8
    // columns: independent chains of mma)
    float f[DW][4] = {};
    if constexpr (BF16) {
      // k16 step n / 2 over slices n and n + 1: A is their accumulators as
      // they lie, P split into bf16 hi + lo
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        const bool pair = n + 1 < NS;  // an odd last slice: upper half zero
        unsigned phi[4] = {0u, 0u, 0u, 0u}, plo[4] = {0u, 0u, 0u, 0u};
        split_bf16(sc[n][0], sc[n][1], phi[0], plo[0]);
        split_bf16(sc[n][2], sc[n][3], phi[1], plo[1]);
        if (pair) {
          split_bf16(sc[n + 1][0], sc[n + 1][1], phi[2], plo[2]);
          split_bf16(sc[n + 1][2], sc[n + 1][3], phi[3], plo[3]);
        }
        // ldmatrix rows: lanes 0-7 keys n·8 + 0..7, lanes 8-15 the next 8
        // (the same 8 again where there is no pair)
        const int vrow = kw0 + n * 8 + (lane & 7) + (pair && (lane & 8) ? 8 : 0);
        const T* vb = vs + vrow * LD + dlo * 8;
#pragma unroll
        for (int dt = 0; dt < DW; ++dt) {
          if (WIDE && dt >= dn) break;  // uniform over the warp
          unsigned b[2];
          ldsm_x2_trans(b, vb + dt * 8);
          mma_bf16(f[dt], plo, b);
          mma_bf16(f[dt], phi, b);
        }
      }
    } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      // A operand: k = t4 is key 2t4, k = t4 + 4 is key 2t4 + 1
      const float a[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
      unsigned phi[4], plo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], phi[i], plo[i]);
      const float* vb = vs + (kw0 + n * 8 + 2 * t4) * LD + g + dlo * 8;
#pragma unroll
      for (int dt = 0; dt < DW; ++dt) {
        if (WIDE && dt >= dn) break;  // uniform over the warp
        unsigned bhi[2], blo[2];
        split_tf32(vb[dt * 8], bhi[0], blo[0]);
        split_tf32(vb[dt * 8 + LD], bhi[1], blo[1]);
        mma_3xtf32(f[dt], phi, plo, bhi, blo);
      }
    }
    }
#pragma unroll
    for (int dt = 0; dt < DW; ++dt) {
      o[dt][0] = o[dt][0] * al0 + f[dt][0];
      o[dt][1] = o[dt][1] * al0 + f[dt][1];
      o[dt][2] = o[dt][2] * al1 + f[dt][2];
      o[dt][3] = o[dt][3] * al1 + f[dt][3];
    }
    __syncthreads();  // the stage is free for the load of tile u + 2
  }
  cp_async_wait<0>();
  __syncthreads();  // Q and the ring are free

  // epilogue: the WKE partial rows meet in shared memory, in a fixed order
  // (a wide head's warps hold disjoint columns of one partial), in f32
  // over all of it
  constexpr int LDF = row_pitch<float>(DT);
  float* Os = reinterpret_cast<float*>(smem4);  // [WKE][ROWS][LDF]
  float* ms = Os + WKE * ROWS * LDF;    // [WKE][ROWS]
  float* ls = ms + WKE * ROWS;         // [WKE][ROWS]
  float* ws = ls + WKE * ROWS;         // [WKE][ROWS]: exp(m_k − M)
  float* inv = ws + WKE * ROWS;        // [ROWS]
  const int ke = WIDE ? 0 : wk;        // this warp's partial
#pragma unroll
  for (int dt = 0; dt < DW; ++dt) {
    if (WIDE && dt >= dn) break;
    float* p = Os + (ke * ROWS + r0) * LDF + (dlo + dt) * 8 + 2 * t4;
    p[0] = o[dt][0];
    p[1] = o[dt][1];
    p[8 * LDF] = o[dt][2];
    p[8 * LDF + 1] = o[dt][3];
  }
  if (t4 == 0 && (!WIDE || wk == 0)) {
    ms[ke * ROWS + r0] = m0;
    ls[ke * ROWS + r0] = l0;
    ms[ke * ROWS + r1] = m1;
    ls[ke * ROWS + r1] = l1;
  }
  __syncthreads();
  for (int r = tid; r < ROWS; r += THREADS) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int k = 0; k < WKE; ++k) M = fmaxf(M, ms[k * ROWS + r]);
#pragma unroll
    for (int k = 0; k < WKE; ++k) {
      const float w = expf(ms[k * ROWS + r] - M);
      ws[k * ROWS + r] = w;
      L += ls[k * ROWS + r] * w;
    }
    const int vec = v_lo + r, s = vec / G;
    inv[r] = s < q_hi ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    if (part_o == nullptr && s < S) {
      float* lse = src.lse_at(s, vec % G);
      if (lse != nullptr) *lse = s < q_hi ? M + logf(fmaxf(L, 1e-30f)) : -__builtin_huge_valf();
    }
    if (part_o != nullptr && s < q_hi) {
      float* ml = part_ml + 2 * src.part_at(s, vec % G);
      ml[0] = M;
      ml[1] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, vec = v_lo + r, s = vec / G;
    if (c >= D || s >= S) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < WKE; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(Os + (k * ROWS + r) * LDF + c);
      const float w = ws[k * ROWS + r];
      a.x += x.x * w;
      a.y += x.y * w;
      a.z += x.z * w;
      a.w += x.w * w;
    }
    if (part_o == nullptr) {
      const float f = inv[r];  // 0 for a padded query
      store4(src.o_at(s, vec % G) + c, make_float4(a.x * f, a.y * f, a.z * f, a.w * f));
    } else if (s < q_hi) {
      *reinterpret_cast<float4*>(part_o + src.part_at(s, vec % G) * D + c) = a;
    }
  }
}

// The tokens of q tile v_lo .. v_lo + ROWS − 1: [v_lo / G, s_end), at most S.
__host__ __device__ inline int tile_token_end(int v_lo, int rows, int G, int S) {
  const int e = (v_lo + rows + G - 1) / G;
  return e < S ? e : S;
}

// Zeros for query vectors v_lo .. v_hi − 1 (token v / G, head v % G), and
// -inf for their log-sum-exp where the source keeps one.
template <class Src>
__device__ __forceinline__ void zero_vectors(const Src& src, int G, int D, int v_lo, int v_hi) {
  const int D4 = D / 4;
  for (int e = threadIdx.x; e < (v_hi - v_lo) * D4; e += THREADS) {
    const int vec = v_lo + e / D4, c = (e % D4) * 4;
    store4(src.o_at(vec / G, vec % G) + c, make_float4(0.f, 0.f, 0.f, 0.f));
    float* lse = c == 0 ? src.lse_at(vec / G, vec % G) : nullptr;
    if (lse != nullptr) *lse = -__builtin_huge_valf();
  }
}

}  // namespace attn
}  // namespace
