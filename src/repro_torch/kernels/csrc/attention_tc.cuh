// The causal GQA attention tile loop of ragged_extend.cu and flash_prefill.cu,
// on the tensor cores of Hopper (sm_90a) with f32 accuracy (3xTF32).
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
// - A block is 8 warps. Its q tile holds ROWS = 16·WR query vectors: the G
//   heads of one KV group times ROWS/G tokens, packed into the rows of the
//   mma tile, so the G heads share every staged K/V tile. The warps form a
//   WR x WK grid (WR·WK = 8): warp (wr, wk) owns rows 16·wr .. 16·wr + 15
//   and keys 8·WR·wk .. 8·WR·(wk + 1) − 1 of every 64-key K/V tile. A large
//   tile (ROWS = 128, WK = 1) gives each warp all 64 keys; the engine's
//   small buckets (S·G down to 16 vectors) give the idle row slots' warps a
//   share of the keys instead, so no 128-row tile runs mostly empty. The
//   WK partial results of a row meet once, at the end, in shared memory.
// - Q is staged once in shared memory. K and V tiles of 64 keys move
//   through a 2-stage cp.async ring (commit_group / wait_group): tile j + 1
//   loads while tile j computes. Copies past the keys the tile may see are
//   zero-filled, so no stale or out-of-bounds value (NaN) reaches P·V: the
//   NaN guard of the TPU kernels. A head dim that is no multiple of 8 is
//   zero-padded in shared memory to the k8 step. At D = 128 a 128-row block
//   takes 198 KiB of shared memory, one block per SM.
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
//   A KV tile's P·V sums in fresh accumulators, one per 8 columns (DT
//   independent chains of mma), then O = α·O + that in f32: the flash
//   recurrence, and the flush that keeps the tensor cores'
//   round-toward-zero sums to one 64-key tile.
// - The loop walks only the K/V tiles the caller gives it; callers stop it
//   at min(row frontier, the q tile's causal diagonal). Rows past the live
//   tokens come out as exact zeros. Sums run in a fixed order: repeat
//   launches give the same bits.
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
// (scripts/attention_variants.py).

#pragma once

#include "tf32x3.cuh"

namespace {
namespace attn {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BKV = 64;               // keys per K/V tile
constexpr int STAGES = 2;             // K/V tiles in the cp.async ring
constexpr int MAX_ROWS = 16 * WARPS;  // query vectors per block, at most
constexpr int MAX_D = 128;
constexpr int QK_FLUSH = 4;           // k8 steps of Q·Kᵀ per tensor-core sum
constexpr float NEG_INF = -1e30f;

// The q tile's rows for ``vectors`` = S·G query vectors of a row and G heads
// a group: the smallest of 16, 32, 64 and 128 that holds them (all of them,
// up to 128), and no fewer than G.
__host__ __device__ inline int tile_rows(int vectors, int G) {
  const int want = vectors > G ? vectors : G;
  int rows = 16;
  while (rows < MAX_ROWS && rows < want) rows *= 2;
  return rows;
}

// d-tiles of 8 columns compiled for a head dim D (4 <= D <= 128, D % 4 == 0)
__host__ __device__ inline int d_tiles(int D) { return D <= 32 ? 4 : (D <= 64 ? 8 : 16); }

__host__ __device__ constexpr int row_pitch(int DT) { return 8 * DT + 4; }

// dynamic shared memory of a block: the q tile, then the K/V ring; the
// epilogue reuses the ring
template <int WR, int DT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(16 * WR + STAGES * 2 * BKV) * row_pitch(DT);
}

static_assert(MAX_ROWS * row_pitch(4) + 4 * MAX_ROWS <= STAGES * 2 * BKV * row_pitch(4),
              "the epilogue's partial rows fit in the ring it reuses");

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], const unsigned (&bhi)[2],
                                           const unsigned (&blo)[2]) {
  mma_tf32(d, alo, bhi);  // the small products first
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// One block's attention. Src gives the addresses (h is the head within
// the group, 0 .. G − 1):
//   const float* q_at(int s, int h), k_at(int t), v_at(int t), any();
//   float* o_at(int s, int h); size_t part_at(int s, int h).
// Query tokens q_lo .. q_lo + ROWS/G − 1 form the tile; tokens below q_hi
// are live, and token s sees keys t < kv_end with t <= pos0 + s. The loop
// walks K/V tiles j0 .. j1 − 1 (keys 64·j0 .. 64·j1 − 1, j1 >= j0 + 1).
// With part_o == nullptr it writes each live row's attention, and zeros for
// the other tokens below S, through o_at. Otherwise it writes each live
// row's unnormalised sum Σ p·v to part_o + part_at(s, h)·D and its max and
// sum of p to part_ml + 2·part_at(s, h), for a combine pass.
template <int WR, int DT, class Src>
__device__ __forceinline__ void attend(const Src& src, float* smem, int G, int D, int S,
                                       int q_lo, int q_hi, int pos0, int kv_end, int j0,
                                       int j1, float* part_o, float* part_ml) {
  constexpr int ROWS = 16 * WR;
  constexpr int WK = WARPS / WR;  // warps that share a row, each a part of every tile
  constexpr int NS = BKV / WK / 8;  // 8-key slices of a warp's part of a tile
  constexpr int LD = row_pitch(DT);
  constexpr int C4 = 2 * DT;  // 16-byte chunks of a staged row
  float* Qs = smem;                    // [ROWS][LD]
  float* ring = smem + ROWS * LD;      // STAGES x (K [BKV][LD], V [BKV][LD])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp / WK, wk = warp % WK;
  const int r0 = 16 * wr + g, r1 = r0 + 8;  // this thread's two rows
  const int s0 = q_lo + r0 / G, s1 = q_lo + r1 / G;
  const bool live0 = s0 < q_hi, live1 = s1 < q_hi;
  const int lim0 = min(pos0 + s0 + 1, kv_end), lim1 = min(pos0 + s1 + 1, kv_end);
  const float scale = 1.f / sqrtf((float)D);  // scores times 1/√D: a multiply

  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, s = q_lo + r / G;
    const bool ok = s < q_hi && c < D;
    cp_async16(Qs + r * LD + c, ok ? src.q_at(s, r % G) + c : src.any(), ok);
  }
  auto load_kv = [&](int stage, int j) {
    float* ks = ring + stage * 2 * BKV * LD;
    float* vs = ks + BKV * LD;
    for (int e = tid; e < BKV * C4; e += THREADS) {
      const int r = e / C4, c = (e % C4) * 4, t = j * BKV + r;
      const bool ok = t < kv_end && c < D;
      cp_async16(ks + r * LD + c, ok ? src.k_at(t) + c : src.any(), ok);
      cp_async16(vs + r * LD + c, ok ? src.v_at(t) + c : src.any(), ok);
    }
  };
  load_kv(0, j0);
  cp_async_commit();  // Q and the first K/V tile

  float o[DT][4] = {};
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const float* qa = Qs + r0 * LD + t4;
  for (int j = j0; j < j1; ++j) {
    if (j + 1 < j1) load_kv((j + 1 - j0) % STAGES, j + 1);
    cp_async_commit();  // an empty group at the end keeps the count uniform
    cp_async_wait<1>();  // tile j (and Q) landed, for this thread's copies
    __syncthreads();
    const float* ks = ring + ((j - j0) % STAGES) * 2 * BKV * LD;
    const float* vs = ks + BKV * LD;
    const int key0 = j * BKV + wk * NS * 8;  // this warp's first key

    // S = Q·Kᵀ for 16 rows x NS·8 keys, each QK_FLUSH k8 steps in a fresh
    // accumulator added to the scores in f32. The loop over the chunks
    // stays rolled: unrolled, the compiler hoists the loads of later chunks
    // and spills at D = 128.
    float sc[NS][4] = {};
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
          const float* kb = ks + ((wk * NS + n) * 8 + g) * LD + kk * 8 + t4;
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
    // columns: DT independent chains of mma)
    float f[DT][4] = {};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      // A operand: k = t4 is key 2t4, k = t4 + 4 is key 2t4 + 1
      const float a[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
      unsigned phi[4], plo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], phi[i], plo[i]);
      const float* vb = vs + ((wk * NS + n) * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        unsigned bhi[2], blo[2];
        split_tf32(vb[dt * 8], bhi[0], blo[0]);
        split_tf32(vb[dt * 8 + LD], bhi[1], blo[1]);
        mma_3xtf32(f[dt], phi, plo, bhi, blo);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] = o[dt][0] * al0 + f[dt][0];
      o[dt][1] = o[dt][1] * al0 + f[dt][1];
      o[dt][2] = o[dt][2] * al1 + f[dt][2];
      o[dt][3] = o[dt][3] * al1 + f[dt][3];
    }
    __syncthreads();  // the stage is free for the load of tile j + 2
  }
  cp_async_wait<0>();

  // epilogue: the WK partial rows meet in shared memory, in a fixed order
  float* Os = ring;                    // [WK][ROWS][LD]
  float* ms = Os + WK * ROWS * LD;     // [WK][ROWS]
  float* ls = ms + WK * ROWS;          // [WK][ROWS]
  float* ws = ls + WK * ROWS;          // [WK][ROWS]: exp(m_k − M)
  float* inv = ws + WK * ROWS;         // [ROWS]
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    float* p = Os + (wk * ROWS + r0) * LD + dt * 8 + 2 * t4;
    p[0] = o[dt][0];
    p[1] = o[dt][1];
    p[8 * LD] = o[dt][2];
    p[8 * LD + 1] = o[dt][3];
  }
  if (t4 == 0) {
    ms[wk * ROWS + r0] = m0;
    ls[wk * ROWS + r0] = l0;
    ms[wk * ROWS + r1] = m1;
    ls[wk * ROWS + r1] = l1;
  }
  __syncthreads();
  for (int r = tid; r < ROWS; r += THREADS) {
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int k = 0; k < WK; ++k) M = fmaxf(M, ms[k * ROWS + r]);
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      const float w = expf(ms[k * ROWS + r] - M);
      ws[k * ROWS + r] = w;
      L += ls[k * ROWS + r] * w;
    }
    const int s = q_lo + r / G;
    inv[r] = s < q_hi ? 1.f / fmaxf(L, 1e-30f) : 0.f;
    if (part_o != nullptr && s < q_hi) {
      float* ml = part_ml + 2 * src.part_at(s, r % G);
      ml[0] = M;
      ml[1] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4, s = q_lo + r / G;
    if (c >= D || s >= S) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < WK; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(Os + (k * ROWS + r) * LD + c);
      const float w = ws[k * ROWS + r];
      a.x += x.x * w;
      a.y += x.y * w;
      a.z += x.z * w;
      a.w += x.w * w;
    }
    if (part_o == nullptr) {
      const float f = inv[r];  // 0 for a padded query
      *reinterpret_cast<float4*>(src.o_at(s, r % G) + c) =
          make_float4(a.x * f, a.y * f, a.z * f, a.w * f);
    } else if (s < q_hi) {
      *reinterpret_cast<float4*>(part_o + src.part_at(s, r % G) * D + c) = a;
    }
  }
}

// Zeros for the G heads of tokens s_lo .. s_hi − 1.
template <class Src>
__device__ __forceinline__ void zero_tokens(const Src& src, int G, int D, int s_lo, int s_hi) {
  const int D4 = D / 4;
  for (int e = threadIdx.x; e < (s_hi - s_lo) * G * D4; e += THREADS) {
    const int r = e / D4, c = (e % D4) * 4;
    *reinterpret_cast<float4*>(src.o_at(s_lo + r / G, r % G) + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace attn
}  // namespace
