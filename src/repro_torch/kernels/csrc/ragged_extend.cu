// ragged_extend: causal GQA attention of padded suffix chunks against the
// dense KV cache, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ragged_extend.py:ragged_extend, the Pallas TPU
// kernel. Row b holds true_lens[b] live queries whose absolute positions
// start at start[b]; query s attends cache positions 0 .. start[b] + s.
// Padded queries and rows with true_lens == 0 come out as exact zeros.
//
// What bounds it on this card: a prefill chunk of S queries against a
// prefix of P keys does 4·S·P·D flops per head over (S + 2P)·D·4 bytes per
// KV head group, so for S of a few dozen and more it is bound by the
// arithmetic: f32-accurate products at 165 TFLOP/s on the tensor cores (bf16
// inputs: 989 TFLOP/s, over half the bytes). A decode rider (S = 1) reads
// its whole prefix once and is bound by bytes.
//
// ragged_extend_launch takes f32 q, k, v and out; ragged_extend_bf16_launch
// bf16 ones (attention_tc.cuh: bf16 products, f32 softmax and sums); the
// partials' scratch is f32 in both. A bf16 launch whose head dim is a
// multiple of 16 on 16-byte bases takes ragged_extend_wgmma.cu instead
// (ragged_extend.py's bf16_path).
//
// What the design does about it: one block per (b, kv head, q tile, KV
// part) runs the tensor-core tile loop of attention_tc.cuh (3xTF32
// mma.sync for Q·Kᵀ and P·V, a cp.async ring of K/V tiles, GQA heads
// packed into the rows of the mma tile, any group size: a token's heads
// may straddle two q tiles). The q tile holds up to 128 query vectors (64
// for a head dim past 128); the engine's small buckets (S·G down to 16)
// take smaller tiles whose spare warps share the keys. A block reads its own start[b] and
// true_lens[b], and its KV loop stops at min(row frontier, the tile's
// causal diagonal): Hopper has no revisit-skip as the TPU's block pipeline
// does, so skipping a tile means not looping over it.
//
// Where the q tiles do not fill the card, the KV range of a tile is split
// over blocks and a combine pass merges the parts (ragged_split.cuh).
//
// An optional lse (B, S, Hq) f32 takes each query's log-sum-exp of its
// scaled scores (m + log(l), natural-log units; -inf for a padded query),
// written by the tile loop or by the combine pass: a caller that attends
// part of a sequence's keys (a time shard of the cache) merges the parts'
// outputs with it. With a NULL lse nothing more is written.

#include <cuda_runtime.h>

#include "attention_tc.cuh"
#include "ragged_split.cuh"

namespace {

template <class E>
struct RaggedSrc {  // row b and kv head hkv of q, k, v, out (B, S|T, H, D)
  const E *q, *k, *v;
  E* out;
  float* lse;  // (B, S, Hq) or nullptr
  int b, hkv, S, T, Hq, Hkv, D, G, part, B;
  __device__ size_t qrow(int s, int h) const {
    return ((size_t)b * S + s) * Hq + hkv * G + h;
  }
  __device__ const E* q_at(int s, int h) const { return q + qrow(s, h) * D; }
  __device__ const E* k_at(int t) const {
    return k + (((size_t)b * T + t) * Hkv + hkv) * D;
  }
  __device__ const E* v_at(int t) const {
    return v + (((size_t)b * T + t) * Hkv + hkv) * D;
  }
  __device__ const E* any() const { return q; }
  __device__ E* o_at(int s, int h) const { return out + qrow(s, h) * D; }
  // (part, b, s, head) in the scratch buffer's row order
  __device__ size_t part_at(int s, int h) const {
    return (size_t)part * B * S * Hq + qrow(s, h);
  }
  __device__ float* lse_at(int s, int h) const {
    return lse == nullptr ? nullptr : lse + qrow(s, h);
  }
};

template <class E, int WR, int DT>
__global__ void __launch_bounds__(attn::THREADS, 1) ragged_extend_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ start,
    const int* __restrict__ true_lens, E* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ lse, int B, int S, int T, int Hq,
    int Hkv, int D, int n_split) {
  extern __shared__ float4 smem4[];
  constexpr int ROWS = 16 * WR;
  const int G = Hq / Hkv;
  const int tile = blockIdx.x / n_split, part = blockIdx.x % n_split;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const RaggedSrc<E> src{q, k, v, out, lse, b, hkv, S, T, Hq, Hkv, D, G, part, B};
  const int v_lo = tile * ROWS;  // the tile's query vectors: tokens [v_lo / G, s_end)
  const int s_end = attn::tile_token_end(v_lo, ROWS, G, S);
  const int st = start[b], n_new = min(true_lens[b], S);
  const int q_hi = min(s_end, n_new);  // live queries below q_hi
  if (v_lo / G >= q_hi) {
    // a q tile past the row's live queries (or an inactive row): zeros,
    // written by the combine pass when the KV range is split
    if (n_split == 1) attn::zero_vectors(src, G, D, v_lo, min(v_lo + ROWS, S * G));
    return;
  }
  const int kv_end = tile_kv_end(st, n_new, T, s_end);
  const int kv_tiles = (kv_end + attn::BKV - 1) / attn::BKV;
  const int parts = kv_parts(kv_tiles, n_split);
  if (part >= parts) return;
  const int j0 = part * kv_tiles / parts, j1 = (part + 1) * kv_tiles / parts;
  // partial sums, then the (m, l) pairs after all n_split·B·S·Hq sums
  float* po = parts > 1 ? part_o : nullptr;
  attn::attend<E, WR, DT>(src, smem4, G, D, S, v_lo, q_hi, st,
                       kv_end, j0, j1, po, po ? po + (size_t)n_split * B * S * Hq * D : nullptr);
}

struct Plan {
  int wr, dt, n_split, n_tiles;
};

// The q tile and the KV split of a launch, from the shapes and the SM
// count (start and true_lens lie on the card): parts until the q tiles give
// about four blocks per SM, as many as T allows.
Plan plan(int B, int S, int T, int Hq, int Hkv, int D) {
  const int vectors = S * (Hq / Hkv);  // of one (row, kv head)
  Plan p{attn::tile_rows(vectors, D) / 16, attn::d_tiles(D), 1, 0};
  p.n_tiles = (vectors + 16 * p.wr - 1) / (16 * p.wr);
  p.n_split = split_count((long long)B * Hkv * p.n_tiles, T);
  return p;
}

template <class E, int WR, int DT>
int launch(const E* q, const E* k, const E* v, const int* start,
           const int* true_lens, E* out, float* part_o, float* lse, int B, int S, int T,
           int Hq, int Hkv, int D, const Plan& p, cudaStream_t stream) {
  const size_t smem = attn::smem_bytes<E, WR, DT>();
  cudaError_t err = cudaFuncSetAttribute(
      ragged_extend_kernel<E, WR, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_tiles * p.n_split, Hkv, B);
  ragged_extend_kernel<E, WR, DT><<<grid, attn::THREADS, smem, stream>>>(
      q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p.n_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return (int)err;
  const size_t rows = (size_t)B * S * Hq;
  const int per_block = attn::THREADS / 32;
  ragged_extend_combine_kernel<E><<<(unsigned)((rows + per_block - 1) / per_block),
                                 attn::THREADS, 0, stream>>>(
      start, true_lens, part_o, out, lse, B, S, T, Hq, Hq / Hkv, D, p.n_split, 16 * WR);
  return (int)cudaGetLastError();
}

// q tiles of 16·wr rows: 16 .. 128 (16 .. 64 for a wide head)
template <class E, int DT>
int launch_dt(const E* q, const E* k, const E* v, const int* start,
              const int* true_lens, E* out, float* part_o, float* lse, int B, int S, int T,
              int Hq, int Hkv, int D, const Plan& p, cudaStream_t stream) {
  switch (p.wr) {
    case 1: return launch<E, 1, DT>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, stream);
    case 2: return launch<E, 2, DT>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, stream);
    case 4: return launch<E, 4, DT>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, stream);
    default:
      if constexpr (attn::is_wide(DT)) return (int)cudaErrorInvalidValue;
      else return launch<E, 8, DT>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, stream);
  }
}

bool valid(int B, int S, int T, int Hq, int Hkv, int D) {
  return B > 0 && S > 0 && T > 0 && Hkv > 0 && Hq % Hkv == 0 && D % 4 == 0 && D > 0 &&
         D <= attn::MAX_D;
}

}  // namespace

// KV parts of a q tile a launch with these shapes runs (1: no split, 0:
// shapes the kernel does not take). A split launch needs n·B·S·Hq·(D + 2)
// floats of scratch.
extern "C" int ragged_extend_kv_parts(int B, int S, int T, int Hq, int Hkv, int D) {
  return valid(B, S, T, Hq, Hkv, D) ? plan(B, S, T, Hq, Hkv, D).n_split : 0;
}

template <class E>
int dispatch(const E* q, const E* k, const E* v, const int* start, const int* true_lens,
             E* out, float* part_o, float* lse, int B, int S, int T, int Hq, int Hkv, int D,
             void* stream) {
  if (!valid(B, S, T, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, S, T, Hq, Hkv, D);
  if (p.n_split > 1 && part_o == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p.dt) {
    case 4: return launch_dt<E, 4>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, st);
    case 8: return launch_dt<E, 8>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, st);
    case 16: return launch_dt<E, 16>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, st);
    case 20: return launch_dt<E, 20>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, st);
    default: return launch_dt<E, 32>(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, p, st);
  }
}

// part_o: scratch for a split launch (NULL when ragged_extend_kv_parts is
// 1); lse: (B, S, Hq) f32, or NULL.
extern "C" int ragged_extend_launch(const float* q, const float* k, const float* v,
                                    const int* start, const int* true_lens, float* out,
                                    float* part_o, float* lse, int B, int S, int T, int Hq,
                                    int Hkv, int D, void* stream) {
  return dispatch(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, stream);
}

// The same on bf16 q, k, v and out (f32 scratch and lse).
extern "C" int ragged_extend_bf16_launch(const bf16* q, const bf16* k, const bf16* v,
                                         const int* start, const int* true_lens, bf16* out,
                                         float* part_o, float* lse, int B, int S, int T, int Hq,
                                         int Hkv, int D, void* stream) {
  return dispatch(q, k, v, start, true_lens, out, part_o, lse, B, S, T, Hq, Hkv, D, stream);
}

extern "C" const char* ragged_extend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
