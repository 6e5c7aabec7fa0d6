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
// KV head group, so for S of a few dozen and more it is bound by f32 FMA
// throughput; a decode rider (S = 1) reads its whole prefix once and is
// bound by bytes.
//
// What the design does about it: one block per (b, kv head, q tile), so the
// G query heads of a group share every K/V tile it stages in shared memory.
// A q tile holds 32 query vectors (32/G tokens x G heads), 8 per warp. The
// block reads its own start[b] and true_lens[b], and its KV loop stops at
// min(row frontier, the tile's causal diagonal): Hopper has no revisit-skip
// as the TPU's block pipeline does, so skipping a tile means not looping
// over it. Q tiles past true_lens write zeros and return. Scores use one
// lane per key (8 queries per lane); the online softmax is f32, with masked
// probabilities set to 0 so fully masked and padded rows keep l == 0; V rows
// past the frontier are staged as zeros, so no stale value reaches P·V.
// Q, K and V tiles move with cp.async (zero-filled past the frontier), so
// every load of a tile is in flight before the block waits. IEEE f32 FMA
// throughout: no TF32.

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

__global__ void __launch_bounds__(THREADS) ragged_extend_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ start,
    const int* __restrict__ true_lens, float* __restrict__ out, int S, int T,
    int Hq, int Hkv, int D) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [NQ][D]
  float* Ks = Qs + NQ * D;                       // [BKV][D + 4]
  float* Vs = Ks + BKV * (D + 4);                // [BKV][D]
  float* Ps = Vs + BKV * D;                      // [WARPS][QPW][BKV]

  const int G = Hq / Hkv;
  const int BQ = NQ / G;
  const int b = blockIdx.z, hkv = blockIdx.y;
  const int q_lo = blockIdx.x * BQ;
  const int st = start[b], n_new = true_lens[b];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = lane * 4;
  const bool dlive = d4 < D;
  const int D4 = D / 4;

  const int q_hi = min(q_lo + BQ, n_new);  // live queries: [q_lo, q_hi)
  if (q_lo >= q_hi) {
    // a q tile past the row's live queries (or an inactive row): zeros
    for (int e = threadIdx.x; e < NQ * D4; e += THREADS) {
      const int qv = e / D4, c = (e % D4) * 4;
      const int s = q_lo + qv / G;
      if (s < S)
        *reinterpret_cast<float4*>(
            out + (((size_t)b * S + s) * Hq + hkv * G + qv % G) * D + c) = f4(0.f);
    }
    return;
  }
  const int kv_end = min(st + q_hi, T);  // keys [0, kv_end): frontier ∧ diagonal

  for (int e = threadIdx.x; e < NQ * D4; e += THREADS) {
    const int qv = e / D4, c = (e % D4) * 4;
    const int s = q_lo + qv / G;
    const bool ok = s < q_hi;
    cp_async16(Qs + qv * D + c,
               ok ? q + (((size_t)b * S + s) * Hq + hkv * G + qv % G) * D + c : q, ok);
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
    qpos[i] = st + s;
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
      const size_t off = ok ? (((size_t)b * T + t) * Hkv + hkv) * D + c : 0;
      cp_async16(Ks + row * (D + 4) + c, k + off, ok);
      cp_async16(Vs + row * D + c, v + off, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // scores: lane = key t, QPW queries per lane
    const int t = t0 + lane;
    float s[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) s[i] = 0.f;
    const float* krow = Ks + lane * (D + 4);
    for (int c = 0; c < D; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int i = 0; i < QPW; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (warp * QPW + i) * D + c);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }
    float* prow = Ps + warp * QPW * BKV;
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      const bool valid = qlive[i] && t < kv_end && t <= qpos[i];
      const float sc = valid ? s[i] / sqrt_d : NEG_INF;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float alpha = expf(m[i] - m_new);
      const float p = valid ? expf(sc - m_new) : 0.f;
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
    *reinterpret_cast<float4*>(
        out + (((size_t)b * S + s) * Hq + hkv * G + qv % G) * D + d4) = o;
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)NQ * D + (size_t)BKV * (D + 4) + (size_t)BKV * D +
                          (size_t)WARPS * QPW * BKV);
}

}  // namespace

extern "C" int ragged_extend_launch(const float* q, const float* k,
                                    const float* v, const int* start,
                                    const int* true_lens, float* out, int B,
                                    int S, int T, int Hq, int Hkv, int D,
                                    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      NQ % (Hq / Hkv) != 0 || D % 4 != 0 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_extend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int BQ = NQ / (Hq / Hkv);
  const dim3 grid((S + BQ - 1) / BQ, Hkv, B);
  ragged_extend_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, k, v, start, true_lens, out, S, T, Hq, Hkv, D);
  return (int)cudaGetLastError();
}

extern "C" const char* ragged_extend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
