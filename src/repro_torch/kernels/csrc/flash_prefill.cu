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
// read in place; out takes q's strides.
//
// What bounds it on this card: a row of S tokens does 4·H·D·S(S+1)/2
// flops against (2H + 4Hkv)·S·D·4 bytes, so any S past a few dozen is
// bound by f32 FMA throughput (67 TFLOP/s outside the tensor cores).
//
// What the design does about it: it is ragged_extend.cu's block and tile
// loop with start = 0 and T = S. One block per (q tile, b, kv head), so the
// G query heads of a group share every K/V tile staged in shared memory; a
// q tile holds 32 query vectors (32/G tokens x G heads), 8 per warp. The KV
// loop stops at the q tile's diagonal, which also bounds it by the row's
// length: the TPU kernel's lower-triangular schedule becomes a loop bound,
// so tiles above the diagonal are never loaded. Q tiles past the row's
// length write zeros and return. Scores use one lane per key (8 queries per
// lane); the online softmax is f32, with masked probabilities set to 0 so a
// fully masked query keeps l == 0; V rows past the bound are zero-filled by
// cp.async before P·V (the NaN guard of the TPU kernel's _flash_body).
// Q tile i walks i + 1 KV tiles, so blocks do unequal work: the q tile is
// the slowest axis of the grid, reversed, so the longest tiles start first
// and the tail of the grid is short. No KV range is split across blocks.
// IEEE f32 FMA throughout: no TF32, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int NQ = 32;        // query vectors per block
constexpr int BKV = 32;       // keys per tile: one per lane
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QPW = NQ / WARPS;  // query vectors per warp
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 f4(float a) { return make_float4(a, a, a, a); }

// 16-byte global -> shared copy that does not stall the thread; where
// ``pred`` is false it reads nothing and writes zeros (cp.async zero-fill)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

struct Strides {  // elements between neighbours along b, h and s
  long long b, h, s;
};

__device__ __forceinline__ size_t offset(const Strides& st, int b, int h, int s) {
  return (size_t)(b * st.b + h * st.h + s * st.s);
}

__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ true_lens,
    float* __restrict__ out, int B, int S, int H, int Hkv, int D, int n_tiles,
    Strides qs, Strides ks, Strides vs) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [NQ][D]
  float* Ks = Qs + NQ * D;                       // [BKV][D + 4]
  float* Vs = Ks + BKV * (D + 4);                // [BKV][D]
  float* Ps = Vs + BKV * D;                      // [WARPS][QPW][BKV]

  const int G = H / Hkv;
  const int BQ = NQ / G;
  // the q tile is the slowest grid axis, reversed: longest tiles first
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (B * Hkv));
  const int b = (blockIdx.x % (B * Hkv)) / Hkv, hkv = blockIdx.x % Hkv;
  const int q_lo = tile * BQ;
  const int n = true_lens ? min(max(true_lens[b], 0), S) : S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = lane * 4;
  const bool dlive = d4 < D;
  const int D4 = D / 4;

  const int q_hi = min(q_lo + BQ, n);  // live queries: [q_lo, q_hi)
  if (q_lo >= q_hi) {
    // a q tile past the row's length (or a row of length 0): zeros
    for (int e = threadIdx.x; e < NQ * D4; e += THREADS) {
      const int qv = e / D4, c = (e % D4) * 4;
      const int s = q_lo + qv / G;
      if (s < S)
        *reinterpret_cast<float4*>(out + offset(qs, b, hkv * G + qv % G, s) + c) = f4(0.f);
    }
    return;
  }
  const int kv_end = q_hi;  // keys [0, kv_end): the tile's diagonal

  for (int e = threadIdx.x; e < NQ * D4; e += THREADS) {
    const int qv = e / D4, c = (e % D4) * 4;
    const int s = q_lo + qv / G;
    const bool ok = s < q_hi;
    cp_async16(Qs + qv * D + c, ok ? q + offset(qs, b, hkv * G + qv % G, s) + c : q, ok);
  }

  const float sqrt_d = sqrtf((float)D);
  int qpos[QPW];
  bool qlive[QPW];
  float m[QPW], l[QPW];
  float4 acc[QPW];
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int s = q_lo + (warp * QPW + i) / G;
    qlive[i] = s < q_hi;
    qpos[i] = s;
    m[i] = NEG_INF;
    l[i] = 0.f;
    acc[i] = f4(0.f);
  }

  for (int t0 = 0; t0 < kv_end; t0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and Q staged, first time)
    for (int e = threadIdx.x; e < BKV * D4; e += THREADS) {
      const int row = e / D4, c = (e % D4) * 4;
      const int t = t0 + row;
      const bool ok = t < kv_end;
      cp_async16(Ks + row * (D + 4) + c, ok ? k + offset(ks, b, hkv, t) + c : k, ok);
      cp_async16(Vs + row * D + c, ok ? v + offset(vs, b, hkv, t) + c : v, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: lane = key t, QPW queries per lane
    const int t = t0 + lane;
    float sc[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) sc[i] = 0.f;
    const float* krow = Ks + lane * (D + 4);
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (warp * QPW + i) * D + c);
        sc[i] = fmaf(qq.x, kk.x, sc[i]);
        sc[i] = fmaf(qq.y, kk.y, sc[i]);
        sc[i] = fmaf(qq.z, kk.z, sc[i]);
        sc[i] = fmaf(qq.w, kk.w, sc[i]);
      }
    }
    float* prow = Ps + warp * QPW * BKV;
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const bool valid = qlive[i] && t < kv_end && t <= qpos[i];
      const float x = valid ? sc[i] / sqrt_d : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p);
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
      m[i] = m_new;
      prow[i * BKV + lane] = p;
    }
    __syncwarp();
    if (dlive) {
      for (int j = 0; j < BKV; j += 4) {
        float4 vj[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          vj[jj] = *reinterpret_cast<const float4*>(Vs + (j + jj) * D + d4);
#pragma unroll
        for (int i = 0; i < QPW; ++i) {
          const float4 pp = *reinterpret_cast<const float4*>(prow + i * BKV + j);
          const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[i].x = fmaf(pv[jj], vj[jj].x, acc[i].x);
            acc[i].y = fmaf(pv[jj], vj[jj].y, acc[i].y);
            acc[i].z = fmaf(pv[jj], vj[jj].z, acc[i].z);
            acc[i].w = fmaf(pv[jj], vj[jj].w, acc[i].w);
          }
        }
      }
    }
    __syncwarp();
  }

  if (!dlive) return;
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int qv = warp * QPW + i;
    const int s = q_lo + qv / G;
    if (s >= S) continue;
    float4 o = f4(0.f);
    if (qlive[i]) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      o = make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
    *reinterpret_cast<float4*>(out + offset(qs, b, hkv * G + qv % G, s) + d4) = o;
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)NQ * D + (size_t)BKV * (D + 4) + (size_t)BKV * D +
                          (size_t)WARPS * QPW * BKV);
}

}  // namespace

// true_lens: (B,) int32 live tokens per row, or NULL for S in every row.
// out has q's strides.
extern "C" int flash_prefill_launch(const float* q, const float* k,
                                    const float* v, const int* true_lens,
                                    float* out, int B, int S, int H, int Hkv,
                                    int D, long long qsb, long long qsh,
                                    long long qss, long long ksb, long long ksh,
                                    long long kss, long long vsb, long long vsh,
                                    long long vss, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || NQ % (H / Hkv) != 0 ||
      D % 4 != 0 || D <= 0 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = NQ / (H / Hkv);
  const int n_tiles = (S + BQ - 1) / BQ;
  const long long blocks = (long long)n_tiles * B * Hkv;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, true_lens, out, B, S, H, Hkv, D, n_tiles, Strides{qsb, qsh, qss},
      Strides{ksb, ksh, kss}, Strides{vsb, vsh, vss});
  return (int)cudaGetLastError();
}

extern "C" const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
