// The KV split of ragged_extend and its combine pass, shared by the tile
// loops of ragged_extend.cu (attention_tc.cuh, f32 and bf16 mma.sync) and
// ragged_extend_wgmma.cu (attention_wgmma.cuh, bf16 wgmma).
//
// The rows of an engine bucket are ragged (a 256-token chunk at a long
// prefix beside decode riders that each walk a whole prefix in one block),
// and the blocks of the live rows alone do not fill the card. So where the
// q tiles do not give a few waves of blocks, the KV range of a tile is cut
// into up to MAX_SPLIT parts of about PART_TILES 64-key tiles, one block
// each, with the part count from the SM count (split_count). A tile whose
// range makes one part writes its result directly; the others write (m, l,
// Σ p·v) partials to a scratch buffer the wrapper allocates (f32: the sums
// at part_o + (part·B·S·Hq + row)·D, the pairs after all n_split·B·S·Hq
// sums; m in natural-log units of the scaled scores), and
// ragged_extend_combine_kernel merges the parts in a fixed order and writes
// the zeros of padded queries; with an lse (B, S, Hq), each merged query's
// m + log(l) and -inf for a padded one.

#pragma once

#include "attention_tc.cuh"

namespace {

constexpr int MAX_SPLIT = 8;       // KV parts of one q tile, at most
constexpr int PART_TILES = 4;      // 64-key K/V tiles of a part, about

// KV parts of a q tile whose keys span ``kv_tiles`` K/V tiles, with up to
// ``n_split`` parts a tile
__host__ __device__ inline int kv_parts(int kv_tiles, int n_split) {
  const int p = (kv_tiles + PART_TILES - 1) / PART_TILES;
  return p < n_split ? p : n_split;
}

// The keys of a q tile of row b whose tokens end at s_end: [0, kv_end)
__device__ __forceinline__ int tile_kv_end(int st, int n_new, int T, int s_end) {
  return min(st + min(s_end, n_new), T);
}

// KV parts of a launch whose q tiles make ``blocks`` blocks over a cache of
// T keys: parts until about four blocks an SM, as many as T allows.
inline int split_count(long long blocks, int T) {
  const int kv_tiles = (T + attn::BKV - 1) / attn::BKV;
  int most = (kv_tiles + PART_TILES - 1) / PART_TILES;
  most = most < MAX_SPLIT ? most : MAX_SPLIT;
  const int n_split = (int)((4LL * sm_count() + blocks - 1) / blocks);
  return n_split < 1 ? 1 : (n_split > most ? most : n_split);
}

// One warp per (b, s, head) of a split launch: a padded query gets zeros; a
// live query whose tile made more than one part gets
// Σ_p w_p·o_p / Σ_p w_p·l_p with w_p = exp(m_p − max m), parts in order.
// A lane takes 4-column chunks lane, lane + 32, ... of D.
template <class E>
__global__ void __launch_bounds__(attn::THREADS) ragged_extend_combine_kernel(
    const int* __restrict__ start, const int* __restrict__ true_lens,
    const float* __restrict__ part_o, E* __restrict__ out, float* __restrict__ lse, int B,
    int S, int T, int Hq, int G, int D, int n_split, int rows) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (attn::THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (size_t)B * S * Hq) return;
  const int b = (int)(row / ((size_t)S * Hq)), s = (int)(row / Hq % S);
  const int n_new = min(true_lens[b], S);
  E* o = out + row * D;
  if (s >= n_new) {
    for (int c = lane * 4; c < D; c += 128) store4(o + c, make_float4(0.f, 0.f, 0.f, 0.f));
    if (lse != nullptr && lane == 0) lse[row] = -__builtin_huge_valf();
    return;
  }
  const int v_lo = (s * G + (int)(row % Hq) % G) / rows * rows;  // the vector's q tile
  const int kv_end = tile_kv_end(start[b], n_new, T, attn::tile_token_end(v_lo, rows, G, S));
  const int parts = kv_parts((kv_end + attn::BKV - 1) / attn::BKV, n_split);
  if (parts == 1) return;  // written by the attention kernel
  const size_t stride = (size_t)B * S * Hq;
  const float* ml = part_o + (size_t)n_split * stride * D + 2 * row;
  float M = attn::NEG_INF;
  for (int p = 0; p < parts; ++p) M = fmaxf(M, ml[2 * p * stride]);
  float L = 0.f;
  for (int p = 0; p < parts; ++p) L += ml[2 * p * stride + 1] * expf(ml[2 * p * stride] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  if (lse != nullptr && lane == 0) lse[row] = M + logf(fmaxf(L, 1e-30f));
  for (int c = lane * 4; c < D; c += 128) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < parts; ++p) {
      const float w = expf(ml[2 * p * stride] - M);
      const float4 x = *reinterpret_cast<const float4*>(part_o + (p * stride + row) * D + c);
      a.x += x.x * w;
      a.y += x.y * w;
      a.z += x.z * w;
      a.w += x.w * w;
    }
    store4(o + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
  }
}

}  // namespace
