// The bf16 tile loop of flash_prefill.cu and ragged_extend_wgmma.cu on
// Hopper's warpgroup tensor cores (sm_90a): wgmma for both products, K and
// V tiles brought by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels flash_prefill and
// flash_prefill_ragged of src/repro/kernels/flash_prefill.py (body
// _flash_ragged_kernel): causal GQA attention over a fresh sequence; and
// ragged_extend of src/repro/kernels/ragged_extend.py: padded chunks whose
// query s sits at absolute position start[b] + s against a cache of T
// keys. The f32 paths stay on attention_tc.cuh's mma.sync loop (3xTF32):
// TF32 wgmma reads B from shared memory K-major only, and V in P·V is
// N-major; 16-bit wgmma reads an MN-major B through the descriptor's
// transpose bit, so V is read as it lies.
//
// What bounds it on this card: a row of S tokens does 4·H·D·S(S+1)/2 flops
// on 2·(H + 2·Hkv)·S·D bytes, so past a few dozen tokens the tensor cores
// bound it: 989 TFLOP/s in bf16. P·V takes P as bf16 hi + lo (two
// products: the reference multiplies an f32 P), so the loop issues 1.5x
// the flops of the bound. attention_tc.cuh reached ~150 TFLOP/s of that
// work with mma.sync (8 warps, each issuing its own 16-row products, and a
// wide head's warps each recomputing Q·Kᵀ).
//
// What the design does about it:
// - A block is one q tile of ROWS = 128 query vectors of one (row b, kv
//   head): the vectors v = s·G + h (token s, head h of the group), as in
//   attention_tc.cuh, so any G fits and the G heads share every K/V tile.
//   Three warpgroups: a producer (one thread issues the TMA loads; the
//   warpgroup gives up its registers with setmaxnreg) and two consumers of
//   64 rows each, which run every product as wgmma.mma_async over the
//   whole warpgroup. Blocks go longest first (the q tile is the slowest
//   grid axis, reversed), as in flash_prefill.cu.
// - Q is copied once, 16 bytes a thread (cp.async: a TMA box cannot pack
//   a token's G heads when G does not divide the tile), into the 128-byte
//   swizzle that TMA and wgmma use: d in chunks of 64 (128 bytes), row r's
//   16-byte group j of a chunk at j ^ (r % 8). Rows past the live tokens
//   are zeros.
// - K and V tiles of BK = 64 keys come through a ring of 2 stages, one
//   TMA box of (64 d, 64 keys) per chunk from a 4-D tensor map over
//   (D, S, Hkv, B) with the views' own strides (a (B, S, H, D) tensor
//   transposed to head-major is read in place); completion is counted on a
//   "full" mbarrier per stage, release on an "empty" one. Columns past D
//   and keys past S are the map's out-of-bounds zeros; keys from the q
//   tile's end to S in its last K/V tile (later tokens, or a ragged row's
//   padding) are zeroed in shared memory before P·V, as the reference
//   zeroes V past the valid keys, so no stale V row reaches P·V.
// - S = Q·Kᵀ: wgmma m64n64k16, A = Q and B = K both from shared memory,
//   K-major as they lie, the whole of D in one accumulator chain of fresh
//   scores each tile (D padded to 64·DC with zeros in Q and K, so the
//   chain is unrolled and ptxas keeps the products in flight).
// - The online softmax runs on the accumulator as it lies: a warp holds
//   16 rows, a row's values sit in one quad of lanes (max and sum take 2
//   shuffles). Scores are scaled by log2(e)/√D in f32 and exponentiated
//   with ex2; masked scores are -inf, so their p is exactly 0. The causal
//   mask is applied only on the K/V tiles that reach past the q tile's
//   first token; the loop stops at min(row length, the q tile's last
//   token), which also bounds it by a ragged row's length.
// - P·V: wgmma m64nDPk16 (DP = D rounded up to 64) with A = P from
//   registers: the accumulator's quads are the A fragment's k pairs, so P
//   goes from one to the other without a shuffle; P splits into bf16
//   hi + lo, lo's product first. B = V from shared memory, MN-major (the
//   descriptor's transpose bit). O accumulates across K/V tiles inside
//   wgmma, rescaled by α in f32 before each tile's products.
// - A warpgroup takes one tile at a time (Q·Kᵀ, softmax, P·V); the two
//   warpgroups interleave on the tensor cores on their own. Issuing tile
//   u's Q·Kᵀ with tile u − 1's P·V (FlashAttention-3's intra-warpgroup
//   overlap) keeps P's hi and lo and the next scores live at once: past
//   D = 128 ptxas then spills and serializes the products.
// - Registers (setmaxnreg: 240 a consumer thread, 24 a producer's): a
//   consumer thread holds 64·DP/128 floats of O (128 at D = 256, where
//   ptxas spills 256 bytes), 32 of scores and 32 registers of P's hi and
//   lo. scripts/flash_wgmma_variants.py times the alternatives: 128-key
//   tiles, three stages, a producer warp without setmaxnreg. No warp
//   recomputes Q·Kᵀ at any width.
// - Epilogue: O·(1/l), rounded once to bf16, goes through the warpgroup's
//   own Q rows of shared memory to 16-byte stores; rows of tokens past the
//   live ones are exact zeros; with lse, each live row's m + log(l)
//   (flash_prefill: (B, H, S); ragged_extend: (B, S, H), and -inf for a
//   padded row, so that partial attentions over parts of the keys merge).
// - ragged_extend (RAGGED): the keys of a q tile run over [0,
//   min(start + the tile's live end, T)) (the row frontier or the tile's
//   diagonal), the causal mask (key > start + s, and key >= the range's
//   end, for a query at or past T) applies only on the K/V tiles that reach
//   past the tile's first position or that end, and where the q tiles
//   do not fill the card the KV range is split over n_split blocks
//   (ragged_split.cuh): a block of a split tile writes its live rows'
//   (m·ln 2, l, Σ p·v) in f32 to part_o for the combine pass. A consumer
//   warpgroup whose 64 rows are all past the live vectors (a decode rider
//   fills G of 128 rows) issues no products and only releases its stages.
// Sums run in a fixed order: repeat launches give the same bits.
// tests/test_torch_attn_wgmma.py emulates the arithmetic, the tensor
// cores' rounding toward zero included, against the Pallas kernel.
//
// Shapes: bf16, D a multiple of 16 up to 256, q, k and v on 16-byte bases
// with b, h and s strides of whole 16-byte steps. flash_prefill.py's
// bf16_path picks this loop or attention_tc.cuh's before the launch; the C
// entry refuses any other shape.

#pragma once

#include "attention_tc.cuh"
#include "ragged_split.cuh"
#include "wgmma.cuh"

namespace {
namespace wg {

constexpr int ROWS = 128;       // query vectors of a q tile
constexpr int CONSUMERS = 2;    // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128·24 + 256·240 <= 65536
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -__builtin_huge_valf();

constexpr int BK = 64;     // keys of a K/V tile
constexpr int STAGES = 2;  // of the K/V ring

// dynamic shared memory: 1024 bytes of alignment slack, Q, the ring, the
// mbarriers (D = 128: 97 KiB; D = 256: 193 KiB)
template <int DC>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)DC * ROWS * 128 + (size_t)STAGES * 2 * DC * BK * 128 + 16 * STAGES;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block: KV part ``blockIdx.x % n_split`` of q tile ``n_tiles - 1 -
// blockIdx.x / n_split / (B·Hkv)`` of (row b, kv head hkv). q and out
// (token s, head h of row b at b·qsb + h·qsh + s·qss; out has q's strides);
// K and V through kmap and vmap (4-D: D, T, Hkv, B; boxes of 64 x 64 keys);
// true_lens (B,) or nullptr for S in every row; start (B,) (RAGGED; a
// fresh sequence has 0 and T = S); lse (B, H, S) contiguous or nullptr;
// part_o: the split's scratch (n_split > 1 only). DC = chunks of 64 of D
// (D <= 64·DC). RAGGED: ragged_extend's source (start, T, the split);
// flash_prefill compiles without it, so its loop carries none of that. The
// kernels below call it.
template <int DC, bool RAGGED>
__device__ __forceinline__ void attention_wgmma(
    const CUtensorMap& kmap, const CUtensorMap& vmap, const bf16* __restrict__ q,
    const int* __restrict__ true_lens, bf16* __restrict__ out, float* __restrict__ lse, int B,
    int S, int H, int Hkv, int D, int n_tiles, long long qsb, long long qsh, long long qss,
    const int* __restrict__ start, int T, int n_split, float* __restrict__ part_o) {
  constexpr int ST = STAGES;
  constexpr uint32_t QC = ROWS * 128;     // bytes of a Q chunk: 128 rows of 64 d
  constexpr uint32_t KC = BK * 128;       // bytes of a K or V chunk: BK keys of 64 d
  constexpr uint32_t STAGE = 2 * DC * KC;  // a stage: K's chunks, then V's
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every chunk starts on one
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t sq = smem_u32(smem), sring = sq + DC * QC;
  const uint32_t full0 = sring + ST * STAGE, empty0 = full0 + 8 * ST;

  const int G = H / Hkv;
  const int part = (int)(blockIdx.x % n_split), rest = (int)(blockIdx.x / n_split);
  const int tile = n_tiles - 1 - rest / (B * Hkv);
  const int b = (rest % (B * Hkv)) / Hkv, hkv = rest % Hkv;
  const int v_lo = tile * ROWS;  // the tile's query vectors: tokens [v_lo / G, ..)
  const int n = true_lens ? min(max(true_lens[b], 0), S) : S;
  const int q_hi = min(attn::tile_token_end(v_lo, ROWS, G, S), n);  // live below q_hi
  const int st = RAGGED ? start[b] : 0;  // the absolute position of token 0
  const long long qbase = b * qsb + (long long)hkv * G * qsh;
  auto qoff = [&](int vec) { return qbase + (vec % G) * qsh + (long long)(vec / G) * qss; };
  const int D8 = D / 8;  // 16-byte groups of a row
  // where a row's log-sum-exp goes: (B, S, H) for ragged_extend, (B, H, S)
  // for flash_prefill
  auto lse_at = [&](int vec) {
    const int s = vec / G, h = hkv * G + vec % G;
    return RAGGED ? ((size_t)b * S + s) * H + h : ((size_t)b * H + h) * S + s;
  };
  if (v_lo / G >= q_hi) {
    // a q tile past the row's length (or a row of length 0): zeros, written
    // by the combine pass where the KV range is split
    const int v_hi = min(v_lo + ROWS, S * G);
    if (n_split == 1) {
      for (int e = threadIdx.x; e < (v_hi - v_lo) * D8; e += THREADS)
        *reinterpret_cast<uint4*>(out + qoff(v_lo + e / D8) + 8 * (e % D8)) = make_uint4(0, 0, 0, 0);
      if (RAGGED && lse != nullptr)
        for (int vec = v_lo + threadIdx.x; vec < v_hi; vec += THREADS) lse[lse_at(vec)] = NEG_INF;
    }
    return;
  }
  // keys [0, kv_end): the row frontier or the q tile's diagonal; this
  // block's part: K/V tiles [u0, u0 + nt)
  const int kv_end = min(st + q_hi, T);
  const int kv_tiles = (kv_end + BK - 1) / BK;
  const int parts = RAGGED ? kv_parts(kv_tiles, n_split) : 1;
  if (part >= parts) return;
  const int u0 = part * kv_tiles / parts;
  const int nt = (part + 1) * kv_tiles / parts - u0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int u = 0; u < nt; ++u) {
        const int sg = u % ST;
        if (u >= ST) mbar_wait(empty0 + 8 * sg, (u / ST - 1) & 1);  // stage released
        const uint32_t fb = full0 + 8 * sg, ks = sring + sg * STAGE, vs = ks + DC * KC;
        mbar_expect_tx(fb, STAGE);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tma_load4(ks + c * KC, &kmap, fb, 64 * c, (u0 + u) * BK, hkv, b);
          tma_load4(vs + c * KC, &vmap, fb, 64 * c, (u0 + u) * BK, hkv, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: tile rows 64c .. 64c + 63
  const int wt = threadIdx.x % 128, warp = wt / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this warpgroup's Q rows: row r's group j at chunk j / 8, slot (j % 8) ^ (r % 8);
  // zeros past D, so Q·Kᵀ runs all 4·DC k16 steps (K is zero there too)
  for (int e = wt; e < 64 * DC * 8; e += 128) {
    const int r = 64 * c + e / (DC * 8), j = e % (DC * 8), vec = v_lo + r;
    const bool ok = vec / G < q_hi && j < D8;
    cp_async16_to(sq + (j / 8) * QC + r * 128 + (((j % 8) ^ (r % 8)) << 4),
                  ok ? q + qoff(vec) + 8 * j : q, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // the copies are visible to wgmma
  bar_sync(2 + c, 128);

  const int r0 = 64 * c + 16 * warp + g, r1 = r0 + 8;  // this thread's two rows
  const int s0 = (v_lo + r0) / G, s1 = (v_lo + r1) / G;
  const bool live0 = s0 < q_hi, live1 = s1 < q_hi;
  const int s_first = v_lo / G;
  const bool wg_live = !RAGGED || (v_lo + 64 * c) / G < q_hi;  // a live row among its 64
  const float sl2 = LOG2E / sqrtf((float)D);  // scores to log2 units: one multiply
  const uint32_t qa = sq + c * 64 * 128;       // A: this warpgroup's 64 rows
  float o[DC * 32];  // 64 x 64·DC of O, DC·8 n8 blocks
#pragma unroll
  for (int i = 0; i < DC * 32; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  for (int i = 0; i < nt; ++i) {
    const int u = u0 + i;  // keys u·BK ..
    const uint32_t ks = opaque(sring + (i % ST) * STAGE), vs = ks + DC * KC;
    mbar_wait(full0 + 8 * (i % ST), (i / ST) & 1);  // tile u's K and V have landed
    // In the last tile, keys [kv_end, min(T, tile end)) (later tokens, a
    // ragged row's padding or cache past the frontier, never attended) are
    // zeroed in V, so no stale V reaches P·V.
    const int z0 = kv_end - u * BK, z1 = min(T - u * BK, BK);
    if (u == kv_tiles - 1 && z0 < z1) {
      for (int e = threadIdx.x - 128; e < (z1 - z0) * DC * 8; e += 128 * CONSUMERS) {
        const int r = z0 + e / (8 * DC), cc = (e / 8) % DC;
        *reinterpret_cast<uint4*>(smem + (vs - sq) + cc * KC + r * 128 + 16 * (e % 8)) =
            make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      bar_sync(1, 128 * CONSUMERS);
    }
    if (!wg_live) {  // no live row: the stage is only released
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (i % ST));
      continue;
    }

    // S = Q·Kᵀ over all of D: k16 step kk reads 32 bytes into its chunk.
    // The scores are fresh each tile (the first step ignores them).
    float sc[BK / 2];  // 64 x BK of scores
    const uint32_t q0 = opaque(qa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(sc, desc(q0 + (kk >> 2) * QC + off, 0, 1024),
               desc(ks + (kk >> 2) * KC + off, 0, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // online softmax: sc[4j + i] is row r0 (i < 2) or r1, key u·BK + 8j +
    // 2·t4 + (i & 1)
    // a key past the tile's first position; ragged: or past kv_end (a query
    // at or past T sees every key below T, and none of the zeros past it)
    const bool diag = (u + 1) * BK > (RAGGED ? min(st + s_first + 1, kv_end) : st + s_first + 1);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[4 * j + i] * sl2;
        const int key = u * BK + 8 * j + 2 * t4 + (i & 1);
        if (diag && (key > st + (i < 2 ? s0 : s1) || (RAGGED && key >= kv_end))) x = NEG_INF;
        sc[4 * j + i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, attn::quad_max(mx0)), mn1 = fmaxf(m1, attn::quad_max(mx1));
    // a row with no key yet keeps max -inf: subtract 0 there (its p are 0)
    const float mu0 = mn0 == NEG_INF ? 0.f : mn0, mu1 = mn1 == NEG_INF ? 0.f : mn1;
    const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    // P split into bf16 hi + lo as the register form's A fragments: n8
    // block j is half j % 2 of k16 step j / 2
    unsigned ph[BK / 16][4], pl[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(sc[4 * j] - mu0), p1 = ex2(sc[4 * j + 1] - mu0);
      const float p2 = ex2(sc[4 * j + 2] - mu1), p3 = ex2(sc[4 * j + 3] - mu1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      split_bf16(p0, p1, ph[j / 2][2 * (j % 2)], pl[j / 2][2 * (j % 2)]);
      split_bf16(p2, p3, ph[j / 2][2 * (j % 2) + 1], pl[j / 2][2 * (j % 2) + 1]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < DC * 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }

    // O += P·V: k16 step j reads keys 16j .. 16j + 15 of V, MN-major (LBO:
    // the next 64 of D, SBO: the next 8 keys); lo's product first
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t db = desc(vs + j * 16 * 128, KC, 1024);
      wgmma_rs(o, pl[j], db);
      wgmma_rs(o, ph[j], db);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % ST));  // this warp is done with the stage
  }

  // epilogue
  l0 = attn::quad_sum(l0);
  l1 = attn::quad_sum(l1);
  if (RAGGED && parts > 1) {  // a part of a split tile: its live rows' partials, f32
    const size_t stride = (size_t)B * S * H;
    float* ml = part_o + (size_t)n_split * stride * D;
    auto row = [&](int r) { return part * stride + ((size_t)b * S + (v_lo + r) / G) * H + hkv * G + (v_lo + r) % G; };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? live1 : live0)) continue;
      const size_t pr = row(half ? r1 : r0);
#pragma unroll
      for (int j = 0; j < DC * 8; ++j)
        if (8 * j < D)
          *reinterpret_cast<float2*>(part_o + pr * D + 8 * j + 2 * t4) =
              make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      if (t4 == 0) {
        const float m = half ? m1 : m0;
        ml[2 * pr] = m * LN2;  // natural-log units of the scaled scores
        ml[2 * pr + 1] = half ? l1 : l0;
      }
    }
    return;
  }
  if (lse != nullptr && t4 == 0) {
    if (live0)
      lse[lse_at(v_lo + r0)] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    else if (RAGGED && s0 < S)
      lse[lse_at(v_lo + r0)] = NEG_INF;
    if (live1)
      lse[lse_at(v_lo + r1)] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
    else if (RAGGED && s1 < S)
      lse[lse_at(v_lo + r1)] = NEG_INF;
  }
  const float f0 = 1.f / fmaxf(l0, 1e-30f), f1 = 1.f / fmaxf(l1, 1e-30f);
  bar_sync(2 + c, 128);  // every warp of the group is past its last Q·Kᵀ: its Q rows are free
  unsigned char* qrows = smem;
#pragma unroll
  for (int j = 0; j < DC * 8; ++j) {
    const int slot = j % 8, col = 4 * t4;  // bytes into the 16-byte group
    // rows of tokens past the live ones: exact zeros (their sums are never used)
    *reinterpret_cast<unsigned*>(qrows + (j / 8) * QC + r0 * 128 + ((slot ^ (r0 % 8)) << 4) + col) =
        live0 ? pack_bf16(o[4 * j] * f0, o[4 * j + 1] * f0) : 0u;
    *reinterpret_cast<unsigned*>(qrows + (j / 8) * QC + r1 * 128 + ((slot ^ (r1 % 8)) << 4) + col) =
        live1 ? pack_bf16(o[4 * j + 2] * f1, o[4 * j + 3] * f1) : 0u;
  }
  bar_sync(2 + c, 128);
  for (int e = wt; e < 64 * D8; e += 128) {
    const int r = 64 * c + e / D8, j = e % D8, vec = v_lo + r;
    if (vec / G >= S) continue;  // rows past the S·G vectors: dead, never written
    *reinterpret_cast<uint4*>(out + qoff(vec) + 8 * j) = *reinterpret_cast<const uint4*>(
        qrows + (j / 8) * QC + r * 128 + (((j % 8) ^ (r % 8)) << 4));
  }
}

// The two kernels of the loop, one name each (profiles group kernels by
// name): flash_prefill's, compiled without the ragged source, and
// ragged_extend's.
template <int DC>
__global__ void __launch_bounds__(THREADS, 1) flash_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const int* __restrict__ true_lens, bf16* __restrict__ out,
    float* __restrict__ lse, int B, int S, int H, int Hkv, int D, int n_tiles, long long qsb,
    long long qsh, long long qss) {
  attention_wgmma<DC, false>(kmap, vmap, q, true_lens, out, lse, B, S, H, Hkv, D, n_tiles, qsb,
                             qsh, qss, nullptr, S, 1, nullptr);
}

template <int DC>
__global__ void __launch_bounds__(THREADS, 1) ragged_extend_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const int* __restrict__ start,
    const int* __restrict__ true_lens, bf16* __restrict__ out, float* __restrict__ part_o,
    float* __restrict__ lse, int B, int S, int T, int H, int Hkv, int D, int n_tiles,
    int n_split) {
  const long long qs = (long long)H * D;  // q (B, S, H, D): the s stride
  attention_wgmma<DC, true>(kmap, vmap, q, true_lens, out, lse, B, S, H, Hkv, D, n_tiles,
                            S * qs, D, qs, start, T, n_split, part_o);
}

// The 4-D tensor map (D, S, Hkv, B) of k or v with its element strides sb,
// sh, ss: boxes of 64 d x BK keys, the 128-byte swizzle, zeros out of
// bounds.
inline int kv_map(CUtensorMap* map, const bf16* base, int B, int S, int Hkv, int D,
                  long long sb, long long sh, long long ss) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hkv, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)BK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims, bytes, box,
                         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

}  // namespace wg
}  // namespace
