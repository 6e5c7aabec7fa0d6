// flash_prefill: causal GQA flash attention over a fresh sequence, in the
// head-major layout, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/flash_prefill.py:
// flash_prefill (every row has S live tokens) and flash_prefill_ragged (row
// b has true_lens[b] live tokens, possibly 0). One kernel serves both:
// true_lens is a nullable pointer, and NULL means S for every row. Query s
// attends keys 0 .. s; queries at or past the row's length, and rows of
// length 0, come out as exact zeros. q and out are (B, H, S, D), k and v
// (B, Hkv, S, D), each with its own element strides for b, h and s and a
// unit stride on D, so a (B, S, H, D) tensor transposed to head-major is
// read in place; out takes q's strides. With a non-NULL lse (B, H, S)
// (contiguous), each live query's log-sum-exp of its scaled scores,
// m + log(l) with the scores times 1/√D as the kernel uses them, goes
// there too, for the backward pass (flash_prefill_bwd.cu); out is the same
// with or without it.
//
// What bounds it on this card: a row of S tokens does 4·H·D·S(S+1)/2
// flops against (2H + 4Hkv)·S·D·4 bytes, so any S past a few dozen is
// bound by the arithmetic: f32-accurate products at 165 TFLOP/s on the
// tensor cores (3xTF32); bf16 inputs at 989 TFLOP/s.
//
// flash_prefill_launch takes f32 q, k, v and out; flash_prefill_bf16_launch
// bf16 ones (attention_tc.cuh: bf16 mma.sync products, f32 softmax and
// sums); flash_prefill_bf16_wgmma_launch bf16 ones on attention_wgmma.cuh's
// loop (wgmma for Q·Kᵀ and P·V, K/V tiles by TMA), for a head dim that is a
// multiple of 16 up to 256 on 16-byte bases and strides; lse f32 in all.
// flash_prefill.py's bf16_path picks the bf16 entry by shape before the
// launch; each entry refuses a shape it does not take.
//
// What the design does about it (f32, and bf16 shapes that attention_wgmma.cuh
// does not take; the bf16 wgmma loop's design is in its header): one block
// per (q tile, b, kv head) runs the tensor-core tile loop of attention_tc.cuh, which ragged_extend.cu
// runs too (here with start = 0 and T = S): 3xTF32 mma.sync for Q·Kᵀ and
// P·V, a cp.async ring of K/V tiles, the G heads of a group packed into
// the rows of the mma tile (128 query vectors, 64 for a head dim past 128;
// any G: a token's heads may straddle two q tiles). The KV
// loop stops at the q tile's diagonal, which also bounds it by the row's
// length: the TPU kernel's lower-triangular schedule becomes a loop bound,
// so tiles above the diagonal are never loaded. Q tiles past the row's
// length write zeros and return. Q tile i walks about i + 1 K/V tiles, so
// blocks do unequal work: the q tile is the slowest axis of the grid,
// reversed, so the longest tiles start first and the tail of the grid is
// short. At B = 8, S = 2016 the grid has 2048 blocks, 15 waves of one
// block per SM, so no KV range is split across blocks.

#include <cuda_runtime.h>

#include <stdio.h>

#include "attention_tc.cuh"
#include "attention_wgmma.cuh"

namespace {

struct Strides {  // elements between neighbours along b, h and s
  long long b, h, s;
};

template <class E>
struct FlashSrc {  // row b and kv head hkv of the head-major views
  const E *q, *k, *v;
  E* out;
  float* lse;  // (B, H, S) or nullptr
  Strides qs, ks, vs;
  int b, hkv, G, H, S;
  __device__ size_t qoff(int s, int h) const {
    return (size_t)(b * qs.b + (long long)(hkv * G + h) * qs.h + s * qs.s);
  }
  __device__ const E* q_at(int s, int h) const { return q + qoff(s, h); }
  __device__ const E* k_at(int t) const {
    return k + (size_t)(b * ks.b + hkv * ks.h + t * ks.s);
  }
  __device__ const E* v_at(int t) const {
    return v + (size_t)(b * vs.b + hkv * vs.h + t * vs.s);
  }
  __device__ const E* any() const { return q; }
  __device__ E* o_at(int s, int h) const { return out + qoff(s, h); }
  __device__ size_t part_at(int, int) const { return 0; }  // never split
  __device__ float* lse_at(int s, int h) const {
    return lse == nullptr ? nullptr : lse + ((size_t)b * H + hkv * G + h) * S + s;
  }
};

template <class E, int WR, int DT>
__global__ void __launch_bounds__(attn::THREADS, 1) flash_prefill_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ true_lens,
    E* __restrict__ out, float* __restrict__ lse, int B, int S, int H, int Hkv, int D,
    int n_tiles,
    Strides qs, Strides ks, Strides vs) {
  extern __shared__ float4 smem4[];
  constexpr int ROWS = 16 * WR;
  const int G = H / Hkv;
  // the q tile is the slowest grid axis, reversed: longest tiles first
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (B * Hkv));
  const int b = (blockIdx.x % (B * Hkv)) / Hkv, hkv = blockIdx.x % Hkv;
  const FlashSrc<E> src{q, k, v, out, lse, qs, ks, vs, b, hkv, G, H, S};
  const int v_lo = tile * ROWS;  // the tile's query vectors: tokens [v_lo / G, s_end)
  const int n = true_lens ? min(max(true_lens[b], 0), S) : S;
  const int q_hi = min(attn::tile_token_end(v_lo, ROWS, G, S), n);  // live below q_hi
  if (v_lo / G >= q_hi) {
    // a q tile past the row's length (or a row of length 0): zeros
    attn::zero_vectors(src, G, D, v_lo, min(v_lo + ROWS, S * G));
    return;
  }
  // keys [0, q_hi): the tile's diagonal
  attn::attend<E, WR, DT>(src, smem4, G, D, S, v_lo, q_hi, 0, q_hi,
                       0, (q_hi + attn::BKV - 1) / attn::BKV, nullptr, nullptr);
}

template <class E, int WR, int DT>
int launch(const E* q, const E* k, const E* v, const int* true_lens,
           E* out, float* lse, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
           Strides vs, cudaStream_t stream) {
  const size_t smem = attn::smem_bytes<E, WR, DT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<E, WR, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long vectors = (long long)S * (H / Hkv);  // of one (row, kv head)
  const int n_tiles = (int)((vectors + 16 * WR - 1) / (16 * WR));
  const long long blocks = (long long)n_tiles * B * Hkv;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_kernel<E, WR, DT><<<(unsigned)blocks, attn::THREADS, smem, stream>>>(
      q, k, v, true_lens, out, lse, B, S, H, Hkv, D, n_tiles, qs, ks, vs);
  return (int)cudaGetLastError();
}

template <class E, int DT>
int launch_dt(int wr, const E* q, const E* k, const E* v, const int* true_lens,
              E* out, float* lse, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
              Strides vs, cudaStream_t stream) {
  switch (wr) {  // q tiles of 16·wr rows: 16 .. 128 (16 .. 64 for a wide head)
    case 1: return launch<E, 1, DT>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, stream);
    case 2: return launch<E, 2, DT>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, stream);
    case 4: return launch<E, 4, DT>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, stream);
    default:
      if constexpr (attn::is_wide(DT)) return (int)cudaErrorInvalidValue;
      else return launch<E, 8, DT>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, stream);
  }
}

}  // namespace

template <class E>
int dispatch(const E* q, const E* k, const E* v, const int* true_lens, E* out, float* lse,
             int B, int S, int H, int Hkv, int D, long long qsb, long long qsh,
             long long qss, long long ksb, long long ksh, long long kss, long long vsb,
             long long vsh, long long vss, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 4 != 0 || D <= 0 ||
      D > attn::MAX_D)
    return (int)cudaErrorInvalidValue;
  const int wr = attn::tile_rows(S * (H / Hkv), D) / 16;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (attn::d_tiles(D)) {
    case 4: return launch_dt<E, 4>(wr, q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    case 8: return launch_dt<E, 8>(wr, q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    case 16: return launch_dt<E, 16>(wr, q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    case 20: return launch_dt<E, 20>(wr, q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    default: return launch_dt<E, 32>(wr, q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
  }
}

// true_lens: (B,) int32 live tokens per row, or NULL for S in every row.
// out has q's strides; lse: (B, H, S) contiguous, or NULL.
extern "C" int flash_prefill_launch(const float* q, const float* k, const float* v,
                                    const int* true_lens, float* out, float* lse, int B,
                                    int S, int H, int Hkv, int D, long long qsb,
                                    long long qsh, long long qss, long long ksb,
                                    long long ksh, long long kss, long long vsb,
                                    long long vsh, long long vss, void* stream) {
  return dispatch(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qsb, qsh, qss, ksb, ksh,
                  kss, vsb, vsh, vss, stream);
}

// The same on bf16 q, k, v and out (lse f32).
extern "C" int flash_prefill_bf16_launch(const bf16* q, const bf16* k, const bf16* v,
                                         const int* true_lens, bf16* out, float* lse, int B,
                                         int S, int H, int Hkv, int D, long long qsb,
                                         long long qsh, long long qss, long long ksb,
                                         long long ksh, long long kss, long long vsb,
                                         long long vsh, long long vss, void* stream) {
  return dispatch(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qsb, qsh, qss, ksb, ksh,
                  kss, vsb, vsh, vss, stream);
}

namespace {

template <int DC>
int launch_wgmma(const bf16* q, const bf16* k, const bf16* v, const int* true_lens, bf16* out,
                 float* lse, int B, int S, int H, int Hkv, int D, Strides qs, Strides ks,
                 Strides vs, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  int err = wg::kv_map(&kmap, k, B, S, Hkv, D, ks.b, ks.h, ks.s);
  if (err == 0) err = wg::kv_map(&vmap, v, B, S, Hkv, D, vs.b, vs.h, vs.s);
  if (err != 0) return err;
  const size_t smem = wg::smem_bytes<DC>();
  const cudaError_t e = cudaFuncSetAttribute(
      wg::flash_prefill_wgmma_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long vectors = (long long)S * (H / Hkv);  // of one (row, kv head)
  const int n_tiles = (int)((vectors + wg::ROWS - 1) / wg::ROWS);
  const long long blocks = (long long)n_tiles * B * Hkv;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  wg::flash_prefill_wgmma_kernel<DC><<<(unsigned)blocks, wg::THREADS, smem, stream>>>(
      kmap, vmap, q, true_lens, out, lse, B, S, H, Hkv, D, n_tiles, qs.b, qs.h, qs.s);
  return (int)cudaGetLastError();
}

bool wgmma_shape_ok(const void* p, Strides st) {
  return (uintptr_t)p % 16 == 0 && st.b > 0 && st.h > 0 && st.s > 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.s % 8 == 0;
}

}  // namespace

// The same as flash_prefill_bf16_launch on attention_wgmma.cuh's loop: D a
// multiple of 16 up to 256, q, k and v on 16-byte bases with positive b, h
// and s strides of multiples of 8 elements (flash_prefill.py's bf16_path);
// anything else returns cudaErrorInvalidValue.
extern "C" int flash_prefill_bf16_wgmma_launch(const bf16* q, const bf16* k, const bf16* v,
                                               const int* true_lens, bf16* out, float* lse,
                                               int B, int S, int H, int Hkv, int D,
                                               long long qsb, long long qsh, long long qss,
                                               long long ksb, long long ksh, long long kss,
                                               long long vsb, long long vsh, long long vss,
                                               void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss};
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 16 != 0 || D <= 0 || D > 256 ||
      !wgmma_shape_ok(q, qs) || !wgmma_shape_ok(k, ks) || !wgmma_shape_ok(v, vs) ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 63) / 64) {  // chunks of 64 of D
    case 1: return launch_wgmma<1>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    case 2: return launch_wgmma<2>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    case 3: return launch_wgmma<3>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
    default: return launch_wgmma<4>(q, k, v, true_lens, out, lse, B, S, H, Hkv, D, qs, ks, vs, st);
  }
}

extern "C" const char* flash_prefill_error_string(int err) {
  if (err >= TENSOR_MAP_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the K/V tensor map (CUresult %d)",
             err - TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
