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
// What bounds it on this card: about 10·H·D·S(S+1)/2 flops a row (Q·Kᵀ
// again, dV, dP, dQ and dK over the causal half) against a few passes over
// q, k, v, o and dout, so any S past a few dozen is bound by the
// arithmetic.
//
// The design (plain f32 FMA on the CUDA cores; a tensor-core version is
// later work):
// - attn_bwd_delta_kernel: Δ, one warp a query row, a shuffle sum in a
//   fixed order.
// - attn_bwd_dkdv_kernel: one block per (kv tile of BK keys, b, kv head,
//   head part), the tile 0 (the most work) first. Where the kv tiles alone
//   would not give two blocks an SM (few rows, few kv heads), the group's
//   heads split into parts and attn_bwd_sum_kernel adds the parts' dK and
//   dV in order. It keeps K and V in shared memory and dK, dV in
//   registers, and walks the G heads of the group and, for each, the q
//   tiles from the kv tile's diagonal to S: it recomputes the scores and
//   dP = dO·Vᵀ (each thread a 16-stride share of the BQ x BK tile), forms
//   P and dS, stages them, and adds Pᵀ·dO and dSᵀ·Q into its share of the
//   BK x D accumulators. The heads' sum is a loop in registers: no atomics.
// - attn_bwd_dq_kernel: one block per (q tile, b, head), the longest tiles
//   first; it walks the kv tiles up to the q tile's diagonal, recomputes P and dS and
//   adds dS·K into its share of the BQ x D accumulator.
// Every sum runs in a fixed order, so a repeat launch gives the same bits.
// Shared-memory rows are padded to D + 4 floats (a multiple of 32 plus 4),
// so the float4 reads of eight neighbouring rows fall on distinct banks.
// Head dims are compiled padded to 32, 64, 128, 160 or 256 (zeros past D);
// past 128 the tiles shrink to 32 x 32 so the accumulators and the shared
// memory fit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads (tx, ty)

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
};

// Δ = rowsum(dO ∘ O), (B, H, S) contiguous: one warp a row
__global__ void __launch_bounds__(THREADS) attn_bwd_delta_kernel(Args a) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
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

template <int DP>
__host__ __device__ constexpr int pitch() {
  return DP + 4;
}

// rows [r0, r0 + ROWS) of a (S, D) view with row stride ``rs`` into
// shared rows of DP + 4 floats; rows past S and columns past D are zeros
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long rs,
                                          int r0, int S, int D) {
  constexpr int C4 = DP / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += THREADS) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < D) x = *reinterpret_cast<const float4*>(base + (r0 + r) * rs + c);
    *reinterpret_cast<float4*>(dst + r * pitch<DP>() + c) = x;
  }
}

// acc[i][j] = Σ_d X[ty + 16i][d]·Y[tx + 16j][d] over the padded head dim
template <int DP, int NI, int NJ>
__device__ __forceinline__ void dot_tile(float (&acc)[NI][NJ], const float* X, const float* Y) {
  constexpr int P = pitch<DP>();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 x[NI], y[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      x[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * P + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(Y + (tx + 16 * j) * P + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// P and dS of a BQ x BK tile (queries q0 + i, keys k0 + j) from the scores
// and dP, into shared [BQ][BK + 16]; the thread's share is rows ty + 16i,
// columns tx + 16j
template <int NI, int NJ, int PP>
__device__ __forceinline__ void p_and_ds(const float (&sc)[NI][NJ], const float (&dp)[NI][NJ],
                                         const float* ls, const float* dls, float* Ps,
                                         float* dSs, int q0, int k0, int S, float scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j, t = k0 + c;
      const float p = (s < S && t <= s) ? expf(sc[i][j] * scale - ls[r]) : 0.f;
      if (Ps != nullptr) Ps[r * PP + c] = p;
      dSs[r * PP + c] = p * (dp[i][j] - dls[r]);
    }
  }
}

// the per-row log-sum-exp and Δ of queries [q0, q0 + BQ) of head hq
template <int BQ>
__device__ __forceinline__ void load_row_stats(const Args& a, float* ls, float* dls, int b,
                                               int hq, int q0) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int s = q0 + r;
    const size_t at = ((size_t)b * a.H + hq) * a.S + s;
    ls[r] = s < a.S ? a.lse[at] : 0.f;
    dls[r] = s < a.S ? a.delta[at] : 0.f;
  }
}

template <int DP, int BQ, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * pitch<DP>() + 2 * BQ * (BK + 16) + 2 * BQ);
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dkdv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  constexpr int P = pitch<DP>(), PP = BK + 16;
  constexpr int NI = BQ / 16, NJ = BK / 16;  // score tile share
  constexpr int NR = BK / 16;                // key rows of the accumulators
  constexpr int NC = (DP / 4 + 15) / 16;     // float4 columns of the accumulators
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* Ps = Vs + BK * P;
  float* dSs = Ps + BQ * PP;
  float* ls = dSs + BQ * PP;
  float* dls = ls + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // (kv tile, b, kv head, head part), the tile slowest: tile 0, the most
  // work, first
  const int per_tile = a.B * a.Hkv * a.hs;
  const int tile = (int)(blockIdx.x / per_tile), rest = (int)(blockIdx.x % per_tile);
  const int b = rest / (a.Hkv * a.hs), hkv = (rest / a.hs) % a.Hkv, hp = rest % a.hs;
  const int k0 = tile * BK;
  load_rows<DP, BK>(Ks, a.k + b * a.ks.b + hkv * a.ks.h, a.ks.s, k0, a.S, a.D);
  load_rows<DP, BK>(Vs, a.v + b * a.vs.b + hkv * a.vs.h, a.vs.s, k0, a.S, a.D);
  float dk[NR][NC][4] = {}, dv[NR][NC][4] = {};
  for (int g = hp * a.G / a.hs; g < (hp + 1) * a.G / a.hs; ++g) {
    const int hq = hkv * a.G + g;
    for (int q0 = (k0 / BQ) * BQ; q0 < a.S; q0 += BQ) {
      __syncthreads();  // the last tile's readers are done
      load_rows<DP, BQ>(Qs, a.q + b * a.qs.b + hq * a.qs.h, a.qs.s, q0, a.S, a.D);
      load_rows<DP, BQ>(dOs, a.dout + b * a.ds.b + hq * a.ds.h, a.ds.s, q0, a.S, a.D);
      load_row_stats<BQ>(a, ls, dls, b, hq, q0);
      __syncthreads();
      float sc[NI][NJ], dp[NI][NJ];
      dot_tile<DP, NI, NJ>(sc, Qs, Ks);
      dot_tile<DP, NI, NJ>(dp, dOs, Vs);
      p_and_ds<NI, NJ, PP>(sc, dp, ls, dls, Ps, dSs, q0, k0, a.S, a.scale);
      __syncthreads();
      // dV += Pᵀ·dO and dK += dSᵀ·Q: key rows ty + 16r, float4 columns tx + 16c
      const int i_end = min(BQ, a.S - q0);
#pragma unroll 2
      for (int i = 0; i < i_end; ++i) {
        float p[NR], d[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          p[r] = Ps[i * PP + ty + 16 * r];
          d[r] = dSs[i * PP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = 4 * (tx + 16 * c);
          if (col >= DP) break;
          const float4 o4 = *reinterpret_cast<const float4*>(dOs + i * P + col);
          const float4 q4 = *reinterpret_cast<const float4*>(Qs + i * P + col);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            dv[r][c][0] = fmaf(p[r], o4.x, dv[r][c][0]);
            dv[r][c][1] = fmaf(p[r], o4.y, dv[r][c][1]);
            dv[r][c][2] = fmaf(p[r], o4.z, dv[r][c][2]);
            dv[r][c][3] = fmaf(p[r], o4.w, dv[r][c][3]);
            dk[r][c][0] = fmaf(d[r], q4.x, dk[r][c][0]);
            dk[r][c][1] = fmaf(d[r], q4.y, dk[r][c][1]);
            dk[r][c][2] = fmaf(d[r], q4.z, dk[r][c][2]);
            dk[r][c][3] = fmaf(d[r], q4.w, dk[r][c][3]);
          }
        }
      }
    }
  }
  const size_t part_n = (size_t)a.hs * a.B * a.Hkv * a.S * a.D;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int t = k0 + ty + 16 * r;
    if (t >= a.S) continue;
    float* dkr = a.dk + b * a.ks.b + hkv * a.ks.h + t * a.ks.s;
    float* dvr = a.dv + b * a.vs.b + hkv * a.vs.h + t * a.vs.s;
    if (a.hs > 1) {  // this head part's sums, added by attn_bwd_sum_kernel
      dkr = a.part + ((((size_t)hp * a.B + b) * a.Hkv + hkv) * a.S + t) * a.D;
      dvr = dkr + part_n;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col >= a.D) break;
      *reinterpret_cast<float4*>(dkr + col) =
          make_float4(dk[r][c][0] * a.scale, dk[r][c][1] * a.scale, dk[r][c][2] * a.scale,
                      dk[r][c][3] * a.scale);
      *reinterpret_cast<float4*>(dvr + col) =
          make_float4(dv[r][c][0], dv[r][c][1], dv[r][c][2], dv[r][c][3]);
    }
  }
}

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(THREADS, 1) attn_bwd_dq_kernel(Args a, int n_q_tiles) {
  extern __shared__ float4 smem4[];
  constexpr int P = pitch<DP>(), PP = BK + 16;
  constexpr int NI = BQ / 16, NJ = BK / 16;
  constexpr int NC = (DP / 4 + 15) / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * P;
  float* Ks = dOs + BQ * P;
  float* Vs = Ks + BK * P;
  float* dSs = Vs + BK * P + BQ * PP;  // the P buffer of attn_bwd_dkdv_kernel is unused
  float* ls = dSs + BQ * PP;
  float* dls = ls + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the q tile is the slowest grid axis, reversed: the longest tiles first
  const int tile = n_q_tiles - 1 - (int)(blockIdx.x / (a.B * a.H));
  const int b = (int)((blockIdx.x % (a.B * a.H)) / a.H), hq = (int)(blockIdx.x % a.H);
  const int hkv = hq / a.G, q0 = tile * BQ;
  load_rows<DP, BQ>(Qs, a.q + b * a.qs.b + hq * a.qs.h, a.qs.s, q0, a.S, a.D);
  load_rows<DP, BQ>(dOs, a.dout + b * a.ds.b + hq * a.ds.h, a.ds.s, q0, a.S, a.D);
  load_row_stats<BQ>(a, ls, dls, b, hq, q0);
  float dq[NI][NC][4] = {};
  const int q_end = min(q0 + BQ, a.S);
  for (int k0 = 0; k0 < q_end; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    load_rows<DP, BK>(Ks, a.k + b * a.ks.b + hkv * a.ks.h, a.ks.s, k0, a.S, a.D);
    load_rows<DP, BK>(Vs, a.v + b * a.vs.b + hkv * a.vs.h, a.vs.s, k0, a.S, a.D);
    __syncthreads();
    float sc[NI][NJ], dp[NI][NJ];
    dot_tile<DP, NI, NJ>(sc, Qs, Ks);
    dot_tile<DP, NI, NJ>(dp, dOs, Vs);
    p_and_ds<NI, NJ, PP>(sc, dp, ls, dls, nullptr, dSs, q0, k0, a.S, a.scale);
    __syncthreads();
    // dQ += dS·K: query rows ty + 16i, float4 columns tx + 16c
    const int j_end = min(BK, q_end - k0);
#pragma unroll 2
    for (int j = 0; j < j_end; ++j) {
      float d[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) d[i] = dSs[(ty + 16 * i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 4 * (tx + 16 * c);
        if (col >= DP) break;
        const float4 k4 = *reinterpret_cast<const float4*>(Ks + j * P + col);
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          dq[i][c][0] = fmaf(d[i], k4.x, dq[i][c][0]);
          dq[i][c][1] = fmaf(d[i], k4.y, dq[i][c][1]);
          dq[i][c][2] = fmaf(d[i], k4.z, dq[i][c][2]);
          dq[i][c][3] = fmaf(d[i], k4.w, dq[i][c][3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= a.S) continue;
    float* dqr = a.dq + b * a.qs.b + hq * a.qs.h + s * a.qs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (tx + 16 * c);
      if (col >= a.D) break;
      *reinterpret_cast<float4*>(dqr + col) =
          make_float4(dq[i][c][0] * a.scale, dq[i][c][1] * a.scale, dq[i][c][2] * a.scale,
                      dq[i][c][3] * a.scale);
    }
  }
}

// dK and dV as the sums of the head parts' partials, in part order
__global__ void __launch_bounds__(THREADS) attn_bwd_sum_kernel(Args a) {
  const int D4 = a.D / 4;
  const size_t n4 = (size_t)a.B * a.Hkv * a.S * D4, part_n = 4 * n4 * a.hs;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n4;
       e += (size_t)gridDim.x * THREADS) {
    const int c = (int)(e % D4) * 4, t = (int)((e / D4) % a.S);
    const int hkv = (int)((e / ((size_t)D4 * a.S)) % a.Hkv);
    const int b = (int)(e / ((size_t)D4 * a.S * a.Hkv));
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int hp = 0; hp < a.hs; ++hp) {
      const float* pk = a.part + ((((size_t)hp * a.B + b) * a.Hkv + hkv) * a.S + t) * a.D + c;
      const float4 x = *reinterpret_cast<const float4*>(pk);
      const float4 y = *reinterpret_cast<const float4*>(pk + part_n);
      sk.x += x.x, sk.y += x.y, sk.z += x.z, sk.w += x.w;
      sv.x += y.x, sv.y += y.y, sv.z += y.z, sv.w += y.w;
    }
    *reinterpret_cast<float4*>(a.dk + b * a.ks.b + hkv * a.ks.h + t * a.ks.s + c) = sk;
    *reinterpret_cast<float4*>(a.dv + b * a.vs.b + hkv * a.vs.h + t * a.vs.s + c) = sv;
  }
}

int sm_count() {
  static int sms = 0;  // read once per process
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// keys of a dK/dV block for head dim D (the tiles of launch<>)
int kv_block_keys(int D) { return D <= 128 ? 64 : 32; }

// Head parts of the dK/dV pass: where the (kv tile, b, kv head) blocks do
// not give two blocks an SM, each block takes a part of the group's heads
// (at most G parts) and a second pass adds the parts in order.
int head_parts(int B, int S, int Hkv, int G, int D) {
  const int bk = kv_block_keys(D);
  const long long blocks = (long long)((S + bk - 1) / bk) * B * Hkv;
  const long long want = (2LL * sm_count() + blocks - 1) / blocks;
  return (int)(want < 1 ? 1 : (want > G ? G : want));
}

template <int DP, int BQ, int BK>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, BQ, BK>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<DP, BQ, BK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)a.B * a.H * a.S;
  const long long delta_blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  const long long kv_blocks = (long long)((a.S + BK - 1) / BK) * a.B * a.Hkv * a.hs;
  const int n_q_tiles = (a.S + BQ - 1) / BQ;
  const long long q_blocks = (long long)n_q_tiles * a.B * a.H;
  if (delta_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  attn_bwd_delta_kernel<<<(unsigned)delta_blocks, THREADS, 0, stream>>>(a);
  attn_bwd_dkdv_kernel<DP, BQ, BK><<<(unsigned)kv_blocks, THREADS, smem, stream>>>(a);
  if (a.hs > 1) {
    const long long n4 = (long long)a.B * a.Hkv * a.S * (a.D / 4);
    const long long blocks = (n4 + THREADS - 1) / THREADS;
    attn_bwd_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(a);
  }
  attn_bwd_dq_kernel<DP, BQ, BK><<<(unsigned)q_blocks, THREADS, smem, stream>>>(
      a, n_q_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a launch of these shapes needs (Δ, and the head
// parts' partial dK and dV where the dK/dV pass splits the heads); -1 past
// 2^31 − 1.
extern "C" int flash_prefill_bwd_scratch_floats(int B, int S, int H, int Hkv, int D) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return 0;
  const int hs = head_parts(B, S, Hkv, H / Hkv, D);
  const long long n = (long long)B * H * S + (hs > 1 ? 2LL * hs * B * Hkv * S * D : 0);
  return n > 0x7fffffffLL ? -1 : (int)n;
}

// q, o and dq share q's strides, dk has k's and dv v's; lse is (B, H, S)
// contiguous; scratch holds flash_prefill_bwd_scratch_floats floats.
extern "C" int flash_prefill_bwd_launch(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    const float* lse, float* scratch, float* dq, float* dk, float* dv, int B, int S, int H,
    int Hkv, int D, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    long long dsb, long long dsh, long long dss, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 4 != 0 || D <= 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int hs = head_parts(B, S, Hkv, H / Hkv, D);
  // scratch: Δ (B, H, S), then the head parts' partials
  Args a{q, k, v, o, dout, lse, scratch, dq, dk, dv,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {dsb, dsh, dss},
         B, S, H, Hkv, D, H / Hkv, 1.f / sqrtf((float)D),
         hs, hs > 1 ? scratch + (size_t)B * H * S : nullptr};
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32) return launch<32, 64, 64>(a, st);
  if (D <= 64) return launch<64, 64, 64>(a, st);
  if (D <= 128) return launch<128, 64, 64>(a, st);
  if (D <= 160) return launch<160, 32, 32>(a, st);  // kv_block_keys: 32 past 128
  return launch<256, 32, 32>(a, st);
}

extern "C" const char* flash_prefill_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
