// paged_attention: one-token GQA decode over a paged KV pool through block
// tables, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/paged_attention.py:paged_attention, the Pallas
// TPU kernel. Query head h of row b attends the first lengths[b] tokens of
// the row's pages, block_tables[b, 0..]; a row whose length is 0 writes
// zeros, not mean(V).
//
// What bounds it on this card: each KV element read feeds G (= 2 on the
// main path) multiply-adds for the scores and G for P·V, under 1 flop/byte,
// so it is bound by the bytes of the live pages.
//
// What the design does about it: one block per (b, kv head, page split)
// serves the G query heads of the group, so each K/V page is read once, not
// G times. One block per (b, kv head) alone would put 64 blocks on the 132
// SMs at the main path's B = 8, so the page range is split in as many
// pieces as fill the card twice (flash-decoding); the TPU kernel walks the
// pages in order on one core and needs no split. The page loop runs only to
// min(ceil(len / page), pages_per_seq): pages past the length are never
// read (a split that starts past it writes an empty state and returns), and
// the clamp to the table width matters because an inactive row's length
// can point past it. Eight warps split a block's keys in chunks of 8 to
// keep many loads in flight; each warp holds an online f32 softmax (masked
// probabilities are 0, so l stays 0 on an empty row) and the block merges
// the eight partial states. A second, small kernel merges the splits in a
// fixed order, so the result does not change from run to run. Each lane
// owns 4 of the D channels, so every K/V row is one coalesced 512-byte read
// per warp. IEEE f32 FMA throughout: no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KC = 8;  // keys per warp chunk (page sizes are multiples of 8)
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 f4(float a) { return make_float4(a, a, a, a); }

// How the pages of a row are split over blocks: as many splits as put
// about two blocks on every SM, at least one page each.
struct Split {
  int n;      // splits per row
  int pages;  // pages per split
};

// The SM count of the first device that asks, read once: the port runs on
// one card per process.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

Split split_for(int B, int Hkv, int pages_per_seq) {
  const int sms = sm_count();
  const int blocks = B * Hkv;
  int n = (2 * sms + blocks - 1) / blocks;
  n = n < 1 ? 1 : (n > pages_per_seq ? pages_per_seq : n);
  const int pages = (pages_per_seq + n - 1) / n;
  return {(pages_per_seq + pages - 1) / pages, pages};
}

// Partial softmax state of one (b, query head, split): acc [D] unnormalised
// and (m, l), in a scratch buffer laid out as acc[B·H·splits][D] followed by
// ml[B·H·splits][2].
template <int G>
__global__ void __launch_bounds__(THREADS) paged_attention_split_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int Hkv, int D, int page_size,
    int pages_per_seq, int pages_per_split) {
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float4 sm_acc[WARPS][G][32];

  const int hkv = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;
  const int H = Hkv * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d4 = lane * 4;
  const bool dlive = d4 < D;
  const int len = min(max(lengths[b], 0), pages_per_seq * page_size);
  const int t_lo = split * pages_per_split * page_size;
  const int t_hi = min(len, t_lo + pages_per_split * page_size);
  const float sqrt_d = sqrtf((float)D);
  const size_t tok_stride = (size_t)Hkv * D;

  float4 qf[G];
  float m[G], l[G];
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qf[g] = dlive ? *reinterpret_cast<const float4*>(
                        q + ((size_t)b * H + hkv * G + g) * D + d4)
                  : f4(0.f);
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = f4(0.f);
  }

  // keys [t_lo, t_hi) in chunks of KC; t_lo is a multiple of the page size
  for (int t0 = t_lo + warp * KC; t0 < t_hi; t0 += WARPS * KC) {
    const int page = tables[(size_t)b * pages_per_seq + t0 / page_size];
    const float* kb = k_pages + ((size_t)page * page_size + t0 % page_size) * tok_stride +
                      (size_t)hkv * D + d4;
    const float* vb = v_pages + ((size_t)page * page_size + t0 % page_size) * tok_stride +
                      (size_t)hkv * D + d4;
    float4 kf[KC], vf[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const bool ok = dlive && t0 + kk < t_hi;
      kf[kk] = ok ? *reinterpret_cast<const float4*>(kb + kk * tok_stride) : f4(0.f);
      vf[kk] = ok ? *reinterpret_cast<const float4*>(vb + kk * tok_stride) : f4(0.f);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[KC];
      float mc = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float part = qf[g].x * kf[kk].x;
        part = fmaf(qf[g].y, kf[kk].y, part);
        part = fmaf(qf[g].z, kf[kk].z, part);
        part = fmaf(qf[g].w, kf[kk].w, part);
        const float dot = warp_sum(part);
        s[kk] = t0 + kk < t_hi ? dot / sqrt_d : NEG_INF;
        mc = fmaxf(mc, s[kk]);
      }
      const float m_new = fmaxf(m[g], mc);
      const float alpha = expf(m[g] - m_new);
      float psum = 0.f;
      float4 pv = f4(0.f);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float p = t0 + kk < t_hi ? expf(s[kk] - m_new) : 0.f;
        psum += p;
        pv.x = fmaf(p, vf[kk].x, pv.x);
        pv.y = fmaf(p, vf[kk].y, pv.y);
        pv.z = fmaf(p, vf[kk].z, pv.z);
        pv.w = fmaf(p, vf[kk].w, pv.w);
      }
      l[g] = l[g] * alpha + psum;
      acc[g].x = fmaf(acc[g].x, alpha, pv.x);
      acc[g].y = fmaf(acc[g].y, alpha, pv.y);
      acc[g].z = fmaf(acc[g].z, alpha, pv.z);
      acc[g].w = fmaf(acc[g].w, alpha, pv.w);
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    sm_acc[warp][g][lane] = acc[g];
  }
  __syncthreads();

  // merge the warps' partial states: warp g writes query head g's state
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.f;
    float4 A = f4(0.f);
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      L = fmaf(sm_l[w][g], f, L);
      const float4 a = sm_acc[w][g][lane];
      A.x = fmaf(a.x, f, A.x);
      A.y = fmaf(a.y, f, A.y);
      A.z = fmaf(a.z, f, A.z);
      A.w = fmaf(a.w, f, A.w);
    }
    const size_t row = ((size_t)b * H + hkv * G + g) * nsplit + split;
    if (dlive) *reinterpret_cast<float4*>(part_acc + row * D + d4) = A;
    if (lane == 0) {
      part_ml[2 * row] = mx;
      part_ml[2 * row + 1] = L;
    }
  }
}

// One warp per (b, query head): merge the splits in order and normalise.
// A row with no keys has l == 0 in every split and writes zeros.
__global__ void __launch_bounds__(32) paged_attention_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    float* __restrict__ out, int D, int nsplit) {
  const int bh = blockIdx.x, d4 = threadIdx.x * 4;
  const size_t row0 = (size_t)bh * nsplit;
  float mx = NEG_INF;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_ml[2 * (row0 + s)]);
  float L = 0.f;
  float4 A = f4(0.f);
  for (int s = 0; s < nsplit; ++s) {
    const float f = expf(part_ml[2 * (row0 + s)] - mx);
    L = fmaf(part_ml[2 * (row0 + s) + 1], f, L);
    if (d4 < D) {
      const float4 a = *reinterpret_cast<const float4*>(part_acc + (row0 + s) * D + d4);
      A.x = fmaf(a.x, f, A.x);
      A.y = fmaf(a.y, f, A.y);
      A.z = fmaf(a.z, f, A.z);
      A.w = fmaf(a.w, f, A.w);
    }
  }
  if (d4 < D) {
    const float inv = 1.f / fmaxf(L, 1e-30f);
    *reinterpret_cast<float4*>(out + (size_t)bh * D + d4) =
        make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
  }
}

template <int G>
int launch(const float* q, const float* k_pages, const float* v_pages,
           const int* tables, const int* lengths, float* out, float* scratch,
           int B, int Hkv, int D, int page_size, int pages_per_seq,
           cudaStream_t stream) {
  const Split sp = split_for(B, Hkv, pages_per_seq);
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * Hkv * G * sp.n * D;
  paged_attention_split_kernel<G><<<dim3(Hkv, B, sp.n), THREADS, 0, stream>>>(
      q, k_pages, v_pages, tables, lengths, part_acc, part_ml, Hkv, D,
      page_size, pages_per_seq, sp.pages);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_merge_kernel<<<B * Hkv * G, 32, 0, stream>>>(
      part_acc, part_ml, out, D, sp.n);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a launch needs: the splits' partial states.
extern "C" int paged_attention_scratch_floats(int B, int H, int Hkv, int D,
                                              int pages_per_seq) {
  if (B <= 0 || Hkv <= 0 || pages_per_seq <= 0) return 0;
  return B * H * split_for(B, Hkv, pages_per_seq).n * (D + 2);
}

extern "C" int paged_attention_launch(const float* q, const float* k_pages,
                                      const float* v_pages, const int* tables,
                                      const int* lengths, float* out,
                                      float* scratch, int B, int H, int Hkv,
                                      int D, int page_size, int pages_per_seq,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D % 4 != 0 || D > MAX_D ||
      page_size <= 0 || page_size % KC != 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (H / Hkv) {
    case 1: return launch<1>(q, k_pages, v_pages, tables, lengths, out, scratch, B, Hkv, D, page_size, pages_per_seq, s);
    case 2: return launch<2>(q, k_pages, v_pages, tables, lengths, out, scratch, B, Hkv, D, page_size, pages_per_seq, s);
    case 4: return launch<4>(q, k_pages, v_pages, tables, lengths, out, scratch, B, Hkv, D, page_size, pages_per_seq, s);
    case 8: return launch<8>(q, k_pages, v_pages, tables, lengths, out, scratch, B, Hkv, D, page_size, pages_per_seq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
