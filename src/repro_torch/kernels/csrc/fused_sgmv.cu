// fused_sgmv and sgmv: base projection plus multi-LoRA delta, and the delta
// alone, for Hopper (sm_90a).
//
// fused_sgmv_launch replaces src/repro/kernels/sgmv.py:fused_sgmv, the
// Pallas TPU kernel; sgmv_launch replaces src/repro/kernels/sgmv.py:sgmv.
// Both run the kernels below, with the base term compiled in or out
// (HAS_BASE): without it the tiled path never stages W and the skinny path
// never streams it, so y = scale·(x·A[id])·B[id], and a row with a negative
// id comes out as exact zeros without touching A or B. The sums run in the
// same fixed order either way.
//
// Computes y = x·W + scale·(x·A[id])·B[id] with x flattened to M = B·S rows;
// row m carries its batch row's adapter id ids[m / S]. A negative id keeps
// x·W and drops the delta: it never dereferences A or B (the TPU kernel
// clamps the id for the gather and masks with the raw id; the result is the
// same).
//
// What bounds it on this card: at decode (M = 8 rows) the kernel does
// 2·M flops per weight it reads (W is 4·d_in·d_out bytes), 4 flop/byte,
// far below the H100's ~20 f32 flop/byte, so it is bound by the bytes of W.
// At a 256-token prefill bucket (M = 2048) it does ~1000 flop/byte and is
// bound by f32 FMA throughput (67 TFLOP/s outside the tensor cores).
//
// What the design does about it. Two paths, chosen from the shapes:
//
// Tiled (M > 16, the prefill buckets): tiles run over (M, d_out), so W is
// read once per 64-row M tile rather than once per batch row (the Pallas
// grid (B, S/bs, d_out/bo) re-reads W for every b). Each tile stages x and W
// in shared memory in 32-wide k slices and keeps a 4x4 block of the base sum
// in registers per thread. The rows of a tile fall into a few segments, one
// per batch row and so one adapter each: the k slice of A[id] is staged
// once per segment with coalesced loads, and the x slice already in shared
// memory feeds the rank-r shrink h = x·A[id] (4 threads per row). The
// epilogue stages B[id] once per segment and adds scale·h·B[id] only where
// id >= 0. The A and B tiles move with cp.async (zero-filled where id < 0
// or past d_in), and the x and W loops are unrolled, so every load of a k
// slice is in flight before the block waits.
//
// Skinny (M <= 16, the decode steps): a 64-row tile would leave the card
// nearly empty (d_out / 64 blocks) and every block would re-read A[id] for
// all rows, more bytes than W itself. So the shrink runs first, once, as
// its own small kernel: h partials over 128-row k chunks, one block per
// (chunk, row), written to a scratch buffer the wrapper allocates. The
// second kernel gives each block 16 output columns and the whole k range:
// 64 k-lanes of 4 threads stream W as 16-byte loads, eight in flight per
// thread, against x staged once in shared memory; lane g < r also adds
// scale·h[r=g]·B[id][g] for its columns, and the lanes' partial sums meet in
// a fixed order (warp shuffles, then eight warp partials), so the result
// does not change from run to run.
//
// sgmv (no base term) does 2·r·(d_in + d_out) flops per row against
// 4·(d_in + d_out) bytes of x and y, 16 flop/byte at r = 32: bound by the
// bytes of x and y at every M. It runs on the same two paths, which is
// simple and repeats fused_sgmv's sums, but spends the tiled path's 4x4
// register block on nothing; a delta-only tiling is for a later change.
//
// All arithmetic is IEEE f32 FMA: no TF32, no tensor cores (a later change
// can move the base product to wgmma once the parity tolerances allow it).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // rows per tile
constexpr int BN = 64;       // output columns per tile
constexpr int BK = 32;       // k slice staged in shared memory
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

constexpr int SK_MAX_M = 16;                   // skinny path: rows at most
constexpr int SK_COLS = 16;                    // output columns per block
constexpr int SK_QUADS = SK_COLS / 4;          // float4 columns per block
constexpr int SK_KLANES = THREADS / SK_QUADS;  // 64 k lanes
constexpr int SK_UNROLL = 8;                   // W loads in flight per thread
constexpr int SK_MAX_X_BYTES = 160 * 1024;     // x staged in shared memory
constexpr int SHRINK_KC = 128;                 // k rows per shrink block

// 4-byte global -> shared copy that does not stall the thread; where
// ``pred`` is false it reads nothing and writes 0 (cp.async zero-fill)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// batch-row segments one BM-row tile can touch
int max_segments(int B, int S) {
  const int n = (BM + S - 2) / S + 1;
  return n < B ? n : B;
}

// floats of the A slices (all segments) or, in the epilogue, one B tile
__host__ __device__ inline int ab_floats(int nseg, int R) {
  const int a = nseg * BK * R, b = R * BN;
  return a > b ? a : b;
}

// dynamic shared memory: xs [BK][BM+4], ws [BK][BN], ab, hs [BM][R+1]
size_t smem_bytes(int nseg, int R) {
  return sizeof(float) *
         ((size_t)BK * (BM + 4) + BK * BN + ab_floats(nseg, R) + (size_t)BM * (R + 1));
}

bool use_skinny(int M, int d_in, int d_out) {
  return M <= SK_MAX_M && d_in % 4 == 0 && d_out % 4 == 0 &&
         (size_t)M * d_in * sizeof(float) <= (size_t)SK_MAX_X_BYTES;
}

__host__ __device__ inline int shrink_chunks(int d_in) { return (d_in + SHRINK_KC - 1) / SHRINK_KC; }

// The rank R is a template parameter: the staging loops index by it, and a
// division by a runtime R costs more than the copy it addresses.
template <int R, bool HAS_BASE>
__global__ void __launch_bounds__(THREADS) fused_sgmv_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ lora_a, const float* __restrict__ lora_b,
    const int* __restrict__ ids, float* __restrict__ y, int M, int S,
    int d_in, int d_out, int nseg_max, float scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // x slice, transposed
  float* ws = xs + BK * (BM + 4);
  float* ab = ws + BK * BN;
  float* hs = ab + ab_floats(nseg_max, R);
  __shared__ int seg_id[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int b0 = m0 / S;
  const int nseg = (min(m0 + BM, M) - 1) / S - b0 + 1;
  if (tid < nseg) seg_id[tid] = ids[b0 + tid];

  // shrink lanes: tile row hm, ranks hr, hr + 4, hr + 8, ...
  const int hm = tid >> 2, hr = tid & 3;
  const int hseg = min((m0 + hm) / S - b0, nseg - 1);
  const bool hrow = m0 + hm < M;

  float acc[4][4] = {};
  float h[(R + 3) / 4] = {};
  constexpr int slice = BK * R;
  __syncthreads();  // seg_id

  for (int k0 = 0; k0 < d_in; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int mm = idx / BK, kk = idx % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk * (BM + 4) + mm] = (gm < M && gk < d_in) ? x[(size_t)gm * d_in + gk] : 0.f;
    }
    if constexpr (HAS_BASE) {
#pragma unroll
      for (int i = 0; i < (BK * BN) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int kk = idx / BN, nn = idx % BN;
        const int gk = k0 + kk, gn = n0 + nn;
        ws[kk * BN + nn] = (gk < d_in && gn < d_out) ? w[(size_t)gk * d_out + gn] : 0.f;
      }
    }
    // the k slice of A[id] for every segment: A[id] is (d_in, R) row-major,
    // so a slice is BK·R contiguous floats
    for (int e = tid; e < nseg * slice; e += THREADS) {
      const int seg = e / slice, rem = e % slice;
      const int id = seg_id[seg];
      const bool ok = id >= 0 && k0 + rem / R < d_in;
      cp_async4(ab + e, ok ? lora_a + (size_t)id * d_in * R + (size_t)k0 * R + rem
                           : lora_a, ok);
    }
    cp_async_wait_all();
    __syncthreads();
    if constexpr (HAS_BASE) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[kk * (BM + 4) + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&ws[kk * BN + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (hrow) {
      const float* as = ab + hseg * slice;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float xv = xs[kk * (BM + 4) + hm];
#pragma unroll
        for (int j = 0; j < (R + 3) / 4; ++j) {
          const int r = hr + 4 * j;
          if (r < R) h[j] = fmaf(xv, as[kk * R + r], h[j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < (R + 3) / 4; ++j) {
    const int r = hr + 4 * j;
    if (r < R) hs[hm * (R + 1) + r] = h[j];
  }

  float d[4][4] = {};
  for (int seg = 0; seg < nseg; ++seg) {
    const int id = seg_id[seg];
    if (id < 0) continue;  // base-model rows: no delta (uniform branch)
    __syncthreads();       // hs written / previous B tile consumed
    for (int e = tid; e < R * BN; e += THREADS) {
      const int r = e / BN, gn = n0 + e % BN;
      const bool ok = gn < d_out;
      cp_async4(ab + e, ok ? lora_b + ((size_t)id * R + r) * d_out + gn : lora_b, ok);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty * 4 + i;
      if (m0 + m >= M || (m0 + m) / S - b0 != seg) continue;
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const float hv = hs[m * (R + 1) + r];
        const float4 bv = *reinterpret_cast<const float4*>(&ab[r * BN + tx * 4]);
        d[i][0] = fmaf(hv, bv.x, d[i][0]);
        d[i][1] = fmaf(hv, bv.y, d[i][1]);
        d[i][2] = fmaf(hv, bv.z, d[i][2]);
        d[i][3] = fmaf(hv, bv.w, d[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < d_out) y[(size_t)gm * d_out + gn] = acc[i][j] + scale * d[i][j];
    }
  }
}

// Skinny path, step 1: hpart[c][m][r] = sum over k in chunk c of
// x[m, k]·A[id_m, k, r]. One block per (chunk, row); thread (g, r) takes
// rank r and k rows g, g + THREADS/R, ...; the k lanes meet in shared
// memory in a fixed order. A row with a negative id writes zeros.
template <int R>
__global__ void __launch_bounds__(THREADS) lora_shrink_kernel(
    const float* __restrict__ x, const float* __restrict__ lora_a,
    const int* __restrict__ ids, float* __restrict__ hpart, int M, int S,
    int d_in) {
  constexpr int G = THREADS / R;  // k lanes
  __shared__ float red[G][R];
  const int c = blockIdx.x, m = blockIdx.y;
  const int id = ids[m / S];
  const int r = threadIdx.x % R, g = threadIdx.x / R;
  const int k1 = min((c + 1) * SHRINK_KC, d_in);
  float acc = 0.f;
  if (id >= 0) {  // uniform over the block
    const float* a = lora_a + (size_t)id * d_in * R + r;
    const float* xr = x + (size_t)m * d_in;
#pragma unroll 4
    for (int k = c * SHRINK_KC + g; k < k1; k += G) acc = fmaf(xr[k], a[(size_t)k * R], acc);
  }
  red[g][r] = acc;
  __syncthreads();
  if (threadIdx.x < R) {
    float s = 0.f;
    for (int j = 0; j < G; ++j) s += red[j][threadIdx.x];
    hpart[((size_t)c * M + m) * R + threadIdx.x] = s;
  }
}

// Skinny path, step 2: y[:, n0 .. n0+16) for all M rows. Thread (g, q)
// owns float4 column q and k rows g, g + 64, ...; x rows sit in shared
// memory, W streams from device memory SK_UNROLL loads at a time. Without
// the base term neither x nor W is read: only the rank lanes' delta.
template <int R, bool HAS_BASE>
__global__ void __launch_bounds__(THREADS) fused_sgmv_skinny_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ lora_b, const int* __restrict__ ids,
    const float* __restrict__ hpart, float* __restrict__ y, int M, int S,
    int d_in, int d_out, float scale) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [M][d_in]
  __shared__ float hs[SK_MAX_M][R];
  __shared__ int row_id[SK_MAX_M];
  __shared__ float4 red[THREADS / 32][SK_MAX_M][SK_QUADS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if constexpr (HAS_BASE)
    for (int e = tid; e < M * d_in / 4; e += THREADS)
      reinterpret_cast<float4*>(xs)[e] = reinterpret_cast<const float4*>(x)[e];
  const int chunks = shrink_chunks(d_in);
  for (int e = tid; e < M * R; e += THREADS) {
    const int m = e / R, r = e % R;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += hpart[((size_t)c * M + m) * R + r];
    hs[m][r] = s;
  }
  if (tid < SK_MAX_M) row_id[tid] = tid < M ? ids[tid / S] : -1;
  __syncthreads();

  const int q = tid % SK_QUADS, g = tid / SK_QUADS;
  const int n = blockIdx.x * SK_COLS + q * 4;
  float4 acc[SK_MAX_M];
#pragma unroll
  for (int m = 0; m < SK_MAX_M; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (n < d_out) {
    if constexpr (HAS_BASE) {
      const float* wc = w + n;
      int k = g;
      for (; k + (SK_UNROLL - 1) * SK_KLANES < d_in; k += SK_UNROLL * SK_KLANES) {
        float4 wv[SK_UNROLL];
#pragma unroll
        for (int u = 0; u < SK_UNROLL; ++u)
          wv[u] = __ldg(reinterpret_cast<const float4*>(wc + (size_t)(k + u * SK_KLANES) * d_out));
#pragma unroll
        for (int u = 0; u < SK_UNROLL; ++u)
#pragma unroll
          for (int m = 0; m < SK_MAX_M; ++m)
            if (m < M) fma4(acc[m], xs[m * d_in + k + u * SK_KLANES], wv[u]);
      }
      for (; k < d_in; k += SK_KLANES) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wc + (size_t)k * d_out));
#pragma unroll
        for (int m = 0; m < SK_MAX_M; ++m)
          if (m < M) fma4(acc[m], xs[m * d_in + k], wv);
      }
    }
    // the delta: lane g < R adds scale·h[m][g]·B[id_m][g][n .. n+4)
    if (g < R) {
#pragma unroll
      for (int m = 0; m < SK_MAX_M; ++m) {
        const int id = row_id[m];
        if (m < M && id >= 0) {
          const float4 bv = __ldg(reinterpret_cast<const float4*>(
              lora_b + ((size_t)id * R + g) * d_out + n));
          fma4(acc[m], scale * hs[m][g], bv);
        }
      }
    }
  }

  // k lanes meet: lanes q, q+4, ..., q+28 of a warp by shuffles, then the
  // eight warps' partials in shared memory, always in the same order
#pragma unroll
  for (int m = 0; m < SK_MAX_M; ++m) {
#pragma unroll
    for (int o = SK_QUADS; o < 32; o <<= 1) {
      acc[m].x += __shfl_xor_sync(0xffffffffu, acc[m].x, o);
      acc[m].y += __shfl_xor_sync(0xffffffffu, acc[m].y, o);
      acc[m].z += __shfl_xor_sync(0xffffffffu, acc[m].z, o);
      acc[m].w += __shfl_xor_sync(0xffffffffu, acc[m].w, o);
    }
    if (lane < SK_QUADS) red[warp][m][lane] = acc[m];
  }
  __syncthreads();
  for (int e = tid; e < M * SK_QUADS; e += THREADS) {
    const int m = e / SK_QUADS, qq = e % SK_QUADS;
    const int nn = blockIdx.x * SK_COLS + qq * 4;
    if (nn >= d_out) continue;
    float4 s = red[0][m][qq];
    for (int wp = 1; wp < THREADS / 32; ++wp) {
      const float4 p = red[wp][m][qq];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    *reinterpret_cast<float4*>(y + (size_t)m * d_out + nn) = s;
  }
}

template <int R, bool HAS_BASE>
int launch(const float* x, const float* w, const float* lora_a,
           const float* lora_b, const int* ids, float* y, float* scratch,
           int M, int S, int d_in, int d_out, float scale, cudaStream_t stream) {
  if (use_skinny(M, d_in, d_out)) {
    lora_shrink_kernel<R><<<dim3(shrink_chunks(d_in), M), THREADS, 0, stream>>>(
        x, lora_a, ids, scratch, M, S, d_in);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = HAS_BASE ? (size_t)M * d_in * sizeof(float) : 0;
    err = cudaFuncSetAttribute(fused_sgmv_skinny_kernel<R, HAS_BASE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fused_sgmv_skinny_kernel<R, HAS_BASE>
        <<<(d_out + SK_COLS - 1) / SK_COLS, THREADS, smem, stream>>>(
            x, w, lora_b, ids, scratch, y, M, S, d_in, d_out, scale);
    return (int)cudaGetLastError();
  }
  const int nseg_max = max_segments(M / S, S);
  const size_t smem = smem_bytes(nseg_max, R);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sgmv_kernel<R, HAS_BASE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d_out + BN - 1) / BN, (M + BM - 1) / BM);
  fused_sgmv_kernel<R, HAS_BASE><<<grid, THREADS, smem, stream>>>(
      x, w, lora_a, lora_b, ids, y, M, S, d_in, d_out, nseg_max, scale);
  return (int)cudaGetLastError();
}

template <bool HAS_BASE>
int dispatch(const float* x, const float* w, const float* lora_a,
             const float* lora_b, const int* ids, float* y, float* scratch,
             int M, int S, int d_in, int d_out, int R, float scale, void* stream) {
  if (M <= 0 || S <= 0 || M % S != 0 || d_in <= 0 || d_out <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 4: return launch<4, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, scale, st);
    case 8: return launch<8, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, scale, st);
    case 16: return launch<16, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, scale, st);
    case 32: return launch<32, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, scale, st);
    case 64: return launch<64, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch the launch needs for these shapes (the skinny path's
// shrink partials; 0 on the tiled path).
extern "C" int fused_sgmv_scratch_floats(int M, int d_in, int d_out, int R) {
  return use_skinny(M, d_in, d_out) ? shrink_chunks(d_in) * M * R : 0;
}

extern "C" int fused_sgmv_launch(const float* x, const float* w,
                                 const float* lora_a, const float* lora_b,
                                 const int* ids, float* y, float* scratch,
                                 int M, int S, int d_in, int d_out, int R,
                                 float scale, void* stream) {
  return dispatch<true>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, R,
                        scale, stream);
}

// The delta alone: y = scale·(x·A[id])·B[id], zeros where id < 0.
extern "C" int sgmv_launch(const float* x, const float* lora_a,
                           const float* lora_b, const int* ids, float* y,
                           float* scratch, int M, int S, int d_in, int d_out,
                           int R, float scale, void* stream) {
  return dispatch<false>(x, nullptr, lora_a, lora_b, ids, y, scratch, M, S, d_in,
                         d_out, R, scale, stream);
}

extern "C" const char* fused_sgmv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
