// ragged_extend in bf16 on Hopper's warpgroup tensor cores (sm_90a): its
// own translation unit, so the build's wall time does not grow.
//
// Replaces, for bf16 inputs, src/repro/kernels/ragged_extend.py:
// ragged_extend, the Pallas TPU kernel: row b holds true_lens[b] live
// queries at absolute positions start[b] + s; query s attends cache
// positions 0 .. start[b] + s; padded queries and rows with true_lens == 0
// come out as exact zeros.
//
// What bounds it on this card: for chunks of a few dozen tokens and more,
// the tensor cores (4·S·P·D flops per head against (S + 2P)·D·2 bytes per
// KV head group, bf16 at 989 TFLOP/s); a decode rider (S = 1) reads its
// whole prefix once and is bound by bytes.
//
// What the design does about it: attention_wgmma.cuh's loop (a producer
// warpgroup on TMA, two consumer warpgroups on wgmma m64n64k16 for Q·Kᵀ and
// m64nDPk16 for P·V, P as bf16 hi + lo), given a ragged source: q (B, S,
// Hq, D) read in place through its strides, K and V by a 4-D tensor map
// over (D, T, Hkv, B), a q tile's keys stopping at min(row frontier, the
// tile's causal diagonal), the causal mask only on the tiles that reach
// past the tile's first position. The KV split and combine of
// ragged_split.cuh keep the card busy where the q tiles alone do not: the
// parts write (m, l, Σ p·v) partials and the combine merges them in a fixed
// order. A consumer warpgroup with no live row (the engine's decode riders
// fill G of a tile's 128 rows) issues no products. Sums run in a fixed
// order: repeat launches give the same bits.
//
// An optional lse (B, S, Hq) f32 takes each query's log-sum-exp of its
// scaled scores (-inf for a padded query), from the tile loop or the
// combine pass, as ragged_extend.cu writes it.
//
// Shapes: bf16, D a multiple of 16 up to 256, q, k, v and out contiguous
// on 16-byte bases (ragged_extend.py's bf16_path, the rule of
// flash_prefill.bf16_path); every other launch takes ragged_extend.cu.

#include <cuda_runtime.h>

#include <stdio.h>

#include "attention_wgmma.cuh"

namespace {

// q tiles of a launch: 128 query vectors s·G + h of one (row, kv head)
int wgmma_tiles(int S, int Hq, int Hkv) {
  return (int)(((long long)S * (Hq / Hkv) + wg::ROWS - 1) / wg::ROWS);
}

bool valid(int B, int S, int T, int Hq, int Hkv, int D) {
  return B > 0 && S > 0 && T > 0 && Hkv > 0 && Hq % Hkv == 0 && D % 16 == 0 && D > 0 &&
         D <= 256;
}

template <int DC>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* start, const int* true_lens,
           bf16* out, float* part_o, float* lse, int B, int S, int T, int Hq, int Hkv, int D,
           int n_split, cudaStream_t stream) {
  const long long kvs = (long long)Hkv * D;  // (B, T, Hkv, D): s stride
  CUtensorMap kmap, vmap;
  int err = wg::kv_map(&kmap, k, B, T, Hkv, D, T * kvs, D, kvs);
  if (err == 0) err = wg::kv_map(&vmap, v, B, T, Hkv, D, T * kvs, D, kvs);
  if (err != 0) return err;
  const size_t smem = wg::smem_bytes<DC>();
  cudaError_t e = cudaFuncSetAttribute(wg::ragged_extend_wgmma_kernel<DC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = wgmma_tiles(S, Hq, Hkv);
  const long long blocks = (long long)n_tiles * B * Hkv * n_split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wg::ragged_extend_wgmma_kernel<DC><<<(unsigned)blocks, wg::THREADS, smem, stream>>>(
      kmap, vmap, q, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, n_tiles, n_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  const size_t rows = (size_t)B * S * Hq;
  const int per_block = attn::THREADS / 32;
  ragged_extend_combine_kernel<bf16><<<(unsigned)((rows + per_block - 1) / per_block),
                                       attn::THREADS, 0, stream>>>(
      start, true_lens, part_o, out, lse, B, S, T, Hq, Hq / Hkv, D, n_split, wg::ROWS);
  return (int)cudaGetLastError();
}

}  // namespace

// KV parts of a q tile that a launch with these shapes runs (1: no split,
// 0: shapes this loop does not take). A split launch needs
// n·B·S·Hq·(D + 2) floats of scratch.
extern "C" int ragged_extend_wgmma_kv_parts(int B, int S, int T, int Hq, int Hkv, int D) {
  if (!valid(B, S, T, Hq, Hkv, D)) return 0;
  return split_count((long long)B * Hkv * wgmma_tiles(S, Hq, Hkv), T);
}

// bf16 q (B, S, Hq, D), k and v (B, T, Hkv, D), out like q, all contiguous
// on 16-byte bases; part_o: scratch for a split launch (NULL when
// ragged_extend_wgmma_kv_parts is 1); lse: (B, S, Hq) f32, or NULL.
// Anything else returns cudaErrorInvalidValue.
extern "C" int ragged_extend_wgmma_launch(const bf16* q, const bf16* k, const bf16* v,
                                          const int* start, const int* true_lens, bf16* out,
                                          float* part_o, float* lse, int B, int S, int T, int Hq,
                                          int Hkv, int D, void* stream) {
  auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (!valid(B, S, T, Hq, Hkv, D) || !a16(q) || !a16(k) || !a16(v) || !a16(out))
    return (int)cudaErrorInvalidValue;
  const int n_split = ragged_extend_wgmma_kv_parts(B, S, T, Hq, Hkv, D);
  if (n_split > 1 && part_o == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 63) / 64) {  // chunks of 64 of D
    case 1: return launch<1>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, n_split, st);
    case 2: return launch<2>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, n_split, st);
    case 3: return launch<3>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, n_split, st);
    default: return launch<4>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, n_split, st);
  }
}

extern "C" const char* ragged_extend_wgmma_error_string(int err) {
  if (err >= TENSOR_MAP_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the K/V tensor map (CUresult %d)",
             err - TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
