// paged_attention: one-token GQA decode over a paged KV pool through block
// tables, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/paged_attention.py:paged_attention, the Pallas
// TPU kernel. Query head h of row b attends the first lengths[b] tokens of
// the row's pages, block_tables[b, 0..]; a row whose length is 0 writes
// zeros, not mean(V). A length past the table (pages_per_seq·page tokens)
// is clamped to it: an inactive row's length can point past it.
//
// What bounds it on this card: each KV element read feeds G (= 2 on the
// main path) multiply-adds for the scores and G for P·V, under 1 flop/byte,
// so it is bound by the bytes of the live pages, and the work of a row
// grows with its live length, not with the table's width.
//
// What the design does about it:
// - Work follows the live length. The grid cannot read the device-side
//   lengths without a host sync, so it covers the whole table in chunks of
//   CT = 64 tokens (half a page at the main path's 128; 32 for a head dim
//   past 128, so a chunk's K and V stay under 70 KB), one block per
//   (chunk, kv head, b), chunks slowest, so the blocks of late chunks, past
//   most lengths, come last. A block whose chunk starts at or past the
//   row's clamped length returns after two loads; every live chunk gets a block
//   of its own, so a 300-token row spreads over 5 blocks and a 2048-token
//   row over 32, and no page is read twice. The TPU kernel walks the pages
//   in order on one core and needs no split.
// - One block serves the G query heads of its kv head: each K/V row is read
//   once, not G times. The group sizes 1, 2, 4 and 8 are compiled; any
//   other G up to 128 (7 for qwen2-vl) takes its heads in blocks of 8 with
//   the dead heads of the last block masked.
// - Loads stay in flight. The block stages its chunk's K rows, then its V
//   rows, into shared memory as two cp.async groups of 16-byte copies (a
//   token row of one kv head is D contiguous floats at a stride of Hkv·D;
//   each warp copies whole 128-byte lines) and computes the scores while V
//   lands. 32 KB of K and 32 KB of V a block, three blocks an SM: up to
//   ~190 KB in flight per SM. The page table entry of each token and the
//   row's length are loaded together, before the copies.
// - Scores with threads owning keys: four threads per key, each taking a
//   quarter of D (float4 chunks p, p + 4, ...) against the G query heads in
//   shared memory, then two shuffles (KPT = 256 / CT threads a key: eight
//   at CT = 32). A row pitch of D rounded up to 32
//   plus 16 floats puts the two keys of each quarter-warp on disjoint
//   banks. The tile's softmax is one warp reduction per head (warp g takes
//   head g), and P·V runs with threads owning D channels (float4 each) and
//   a share of the keys; the shares meet in shared memory in a fixed order
//   (where the G·D/4 channels outnumber the threads, each thread walks all
//   keys for its channels instead).
// - A second, small kernel merges the live chunks of each (b, query head)
//   in order and normalises; it reads only chunks below the clamped length.
//   It is launched as a programmatic dependent of the first, so its launch
//   is prepared while the first runs; a warp takes 128 columns of D. Every
//   sum runs in a fixed order: two
//   launches on the same inputs give the same bits.
// IEEE f32 FMA throughout: no TF32.
// - bf16 pages and q (paged_attention_bf16_launch): the reference upcasts
//   q, K and V to f32 and computes in f32, and so does this kernel: the
//   chunk's K, V and q are staged as bf16 (8-byte copies of 4 elements,
//   half the bytes that bound it) and widened to f32 as they are read. The
//   chunk states and scratch stay f32; the output is rounded to bf16 once.

#include <cuda_runtime.h>

#include "bf16_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int NARROW_D = 128;        // wider heads take chunks of 32 tokens
constexpr int MAX_GROUP = 128;       // query heads per kv head, at most
constexpr int GB_ANY = 8;            // heads of a block where G is not compiled
constexpr int PAGE_MULTIPLE = 8;     // page sizes the launch accepts
constexpr float NEG_INF = -1e30f;

// tokens per chunk, one block each
__host__ __device__ constexpr int chunk_tokens(int D) { return D > NARROW_D ? 32 : 64; }

__device__ __forceinline__ float4 f4(float a) { return make_float4(a, a, a, a); }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

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

int chunks_for(int page_size, int pages_per_seq, int D) {
  const int ct = chunk_tokens(D);
  return (pages_per_seq * page_size + ct - 1) / ct;
}

// shared-memory row pitch of the K and V tiles: ≡ 16 (mod 32) floats
__host__ __device__ inline int tile_ld(int D) { return (D + 31) / 32 * 32 + 16; }

// at most 212 KB (f32, G = 128, D = 256) of the 227 KB a block may take
template <class E>
size_t smem_bytes(int G, int D) {
  const int ct = chunk_tokens(D);
  return sizeof(E) * ((size_t)2 * ct * tile_ld(D) + (size_t)G * D) +
         sizeof(float) * (size_t)G * ct;
}

// Partial softmax state of one (b, query head, chunk): acc [D]
// unnormalised and (m, l), in a scratch buffer laid out as
// acc[B·H·chunks][D] followed by ml[B·H·chunks][2]. GF: the group size,
// or 0 for any (g_any heads, taken in blocks of GB_ANY).
template <class E, int GF, int CT>
__global__ void __launch_bounds__(THREADS, 2) paged_attention_chunk_kernel(
    const E* __restrict__ q, const E* __restrict__ k_pages,
    const E* __restrict__ v_pages, const int* __restrict__ tables,
    const int* __restrict__ lengths, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int Hkv, int D, int page_size, int pages_per_seq,
    int g_any) {
  constexpr int KPT = THREADS / CT;  // threads per key for the scores
  constexpr int GB = GF > 0 ? GF : GB_ANY;  // heads of a block of the scores
  static_assert(KPT * CT == THREADS && 32 % KPT == 0, "a key's threads share a warp");
  const int G = GF > 0 ? GF : g_any;
  extern __shared__ float4 smem4[];
  const int ld = tile_ld(D);
  E* ks = reinterpret_cast<E*>(smem4);  // [CT][ld]
  E* vs = ks + CT * ld;                 // [CT][ld]
  E* qs = vs + CT * ld;                 // [G][D]
  float* ps = reinterpret_cast<float*>(qs + G * D);  // [G][CT]: scores, then p
  __shared__ long long tok_row[CT];             // float offset of each token's K/V row

  // chunks slowest: blocks of late chunks, mostly past every length, come last
  const int hkv = blockIdx.x % Hkv, b = blockIdx.x / Hkv, ch = blockIdx.y;
  const int nc = gridDim.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = pages_per_seq * page_size;
  const int t0 = ch * CT;
  // the token's page and the row's length, loaded together
  int page = -1;
  if (tid < CT && t0 + tid < T) page = tables[(size_t)b * pages_per_seq + (t0 + tid) / page_size];
  const int len = min(max(lengths[b], 0), T);
  if (t0 >= len) return;  // uniform over the block: a chunk past the length
  const int live = min(CT, len - t0);
  if (tid < CT)
    tok_row[tid] = tid < live ? (((long long)page * page_size + (t0 + tid) % page_size) * Hkv + hkv) * D
                              : -1;
  __syncthreads();

  // group 0: q and K; group 1: V. Rows past the length are zero-filled.
  const int d4n = D / 4;
  for (int c = tid; c < G * d4n; c += THREADS)
    cp_chunk(qs + c * 4, q + ((size_t)b * H + hkv * G) * D + c * 4, true);
  for (int c = tid; c < CT * d4n; c += THREADS) {
    const int j = c / d4n, c4 = (c % d4n) * 4;
    const long long row = tok_row[j];
    cp_chunk(ks + j * ld + c4, row >= 0 ? k_pages + row + c4 : k_pages, row >= 0);
  }
  cp_async_commit();
  for (int c = tid; c < CT * d4n; c += THREADS) {
    const int j = c / d4n, c4 = (c % d4n) * 4;
    const long long row = tok_row[j];
    cp_chunk(vs + j * ld + c4, row >= 0 ? v_pages + row + c4 : v_pages, row >= 0);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // scores: thread (j, p) takes float4 chunks p, p + KPT, ... of key j,
  // against the heads in blocks of GB (one block where G is compiled)
  {
    const int j = tid / KPT, p = tid % KPT;
    const float sqrt_d = sqrtf((float)D);
    for (int g0 = 0; g0 < G; g0 += GB) {
      float dot[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) dot[g] = 0.f;
      for (int c = p; c < d4n; c += KPT) {
        const float4 kv = load4f(ks + j * ld + c * 4);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (GF == 0 && g0 + g >= G) break;  // uniform over the block
          const float4 qv = load4f(qs + (g0 + g) * D + c * 4);
          dot[g] = fmaf(qv.x, kv.x, dot[g]);
          dot[g] = fmaf(qv.y, kv.y, dot[g]);
          dot[g] = fmaf(qv.z, kv.z, dot[g]);
          dot[g] = fmaf(qv.w, kv.w, dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (GF == 0 && g0 + g >= G) break;
        float s = dot[g];
#pragma unroll
        for (int o = 1; o < KPT; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (p == 0) ps[(g0 + g) * CT + j] = j < live ? s / sqrt_d : NEG_INF;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax: warp g takes head g, keys lane, lane + 32, ...
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = NEG_INF;
    for (int j = lane; j < CT; j += 32) mx = fmaxf(mx, ps[g * CT + j]);
    mx = warp_max(mx);  // a live chunk has a live key
    float l = 0.f;
    for (int j = lane; j < CT; j += 32) {
      const float e = j < live ? expf(ps[g * CT + j] - mx) : 0.f;
      ps[g * CT + j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t row = ((size_t)b * H + hkv * G + g) * nc + ch;
      part_ml[2 * row] = mx;
      part_ml[2 * row + 1] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V landed, p written; K is free for the shares below

  // P·V: thread (kp, o) owns float4 o of the G·D outputs and keys kp,
  // kp + kparts, ...; the key shares meet in shared memory (over K). Where
  // the outputs outnumber the threads, thread o takes outputs o, o + 256,
  // ... over all the live keys.
  const int n_out = G * d4n;
  // at most 8 heads of 128 columns: 256 outputs, one a thread
  constexpr bool MANY_OUT = GF == 0 || CT < chunk_tokens(NARROW_D);
  if (MANY_OUT && n_out > THREADS) {
    for (int o = tid; o < n_out; o += THREADS) {
      const int g = o / d4n, c4 = (o % d4n) * 4;
      float4 acc = f4(0.f);
      for (int j = 0; j < live; ++j)
        fma4(acc, ps[g * CT + j], load4f(vs + j * ld + c4));
      const size_t row = ((size_t)b * H + hkv * G + g) * nc + ch;
      *reinterpret_cast<float4*>(part_acc + row * D + c4) = acc;
    }
    return;
  }
  const int kparts = THREADS / n_out;
  float4* red = reinterpret_cast<float4*>(ks);  // [kparts][n_out]
  if (tid < kparts * n_out) {
    const int o = tid % n_out, kp = tid / n_out;
    const int g = o / d4n, c4 = (o % d4n) * 4;
    float4 acc = f4(0.f);
    for (int j = kp; j < live; j += kparts)
      fma4(acc, ps[g * CT + j], load4f(vs + j * ld + c4));
    red[kp * n_out + o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < n_out; o += THREADS) {
    float4 a = red[o];
    for (int kp = 1; kp < kparts; ++kp) {
      const float4 u = red[kp * n_out + o];
      a.x += u.x;
      a.y += u.y;
      a.z += u.z;
      a.w += u.w;
    }
    const int g = o / d4n, c4 = (o % d4n) * 4;
    const size_t row = ((size_t)b * H + hkv * G + g) * nc + ch;
    *reinterpret_cast<float4*>(part_acc + row * D + c4) = a;
  }
}

// One warp per (b, query head, 128 columns of D): merge the live chunks in
// order and normalise. A row of length 0 has none and writes zeros. Lane s holds the (m, l) of chunk s of each group of 32
// chunks; the sums run over the
// chunks in order with their weights passed by shuffles. The first
// group's states and partial outputs are loaded together, right after the
// wait: one round trip where a row has at most 32 live chunks.
template <class E, int CT>
__global__ void __launch_bounds__(32) paged_attention_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, E* __restrict__ out, int H, int D, int T, int nc) {
  const int bh = blockIdx.x, lane = threadIdx.x, d4 = blockIdx.y * 128 + lane * 4;
  const int len = min(max(lengths[bh / H], 0), T);
  const int n_live = (len + CT - 1) / CT;
  const size_t row0 = (size_t)bh * nc;
  float4 pa[32];
  // group s0's (m, l) into this lane and its partial outputs into pa
  auto load_group = [&](int s0, float& m, float& l) {
    const int cnt = min(32, n_live - s0);
    m = NEG_INF;
    l = 0.f;
    if (lane < cnt) {
      m = part_ml[2 * (row0 + s0 + lane)];
      l = part_ml[2 * (row0 + s0 + lane) + 1];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < cnt && d4 < D)
        pa[i] = *reinterpret_cast<const float4*>(part_acc + (row0 + s0 + i) * D + d4);
  };
  grid_dependency_wait();  // the chunk kernel's states are written
  float m, l;
  load_group(0, m, l);
  float mx = m;
  for (int s = lane + 32; s < n_live; s += 32) mx = fmaxf(mx, part_ml[2 * (row0 + s)]);
  mx = warp_max(mx);
  float L = 0.f;
  float4 A = f4(0.f);
  for (int s0 = 0; s0 < n_live; s0 += 32) {
    if (s0 > 0) load_group(s0, m, l);
    const int cnt = min(32, n_live - s0);
    const float f = lane < cnt ? expf(m - mx) : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i < cnt) {  // uniform over the warp
        const float fi = __shfl_sync(0xffffffffu, f, i);
        L = fmaf(__shfl_sync(0xffffffffu, l, i), fi, L);
        if (d4 < D) fma4(A, fi, pa[i]);
      }
    }
  }
  if (d4 < D) {
    const float inv = 1.f / fmaxf(L, 1e-30f);
    store4(out + (size_t)bh * D + d4, make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv));
  }
}

template <class E, int GF, int CT>
int launch(const E* q, const E* k_pages, const E* v_pages,
           const int* tables, const int* lengths, E* out, float* scratch,
           int B, int H, int Hkv, int D, int page_size, int pages_per_seq,
           cudaStream_t stream) {
  const int nc = chunks_for(page_size, pages_per_seq, D);
  const int G = H / Hkv;
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * H * nc * D;
  const size_t smem = smem_bytes<E>(G, D);
  cudaError_t err = cudaFuncSetAttribute(paged_attention_chunk_kernel<E, GF, CT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  paged_attention_chunk_kernel<E, GF, CT><<<dim3(Hkv * B, nc), THREADS, smem, stream>>>(
      q, k_pages, v_pages, tables, lengths, part_acc, part_ml, Hkv, D, page_size,
      pages_per_seq, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_dependent(paged_attention_merge_kernel<E, CT>, dim3(B * H, (D + 127) / 128),
                         dim3(32), 0, stream, (const float*)part_acc, (const float*)part_ml,
                         lengths, out, H, D, pages_per_seq * page_size, nc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class E, int CT>
int launch_g(const E* q, const E* k_pages, const E* v_pages,
             const int* tables, const int* lengths, E* out, float* scratch,
             int B, int H, int Hkv, int D, int page_size, int pages_per_seq,
             cudaStream_t s) {
  switch (H / Hkv) {
    case 1: return launch<E, 1, CT>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 2: return launch<E, 2, CT>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 4: return launch<E, 4, CT>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 8: return launch<E, 8, CT>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    default: return launch<E, 0, CT>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
  }
}

}  // namespace

// Floats of scratch a launch needs: every chunk's partial state.
extern "C" int paged_attention_scratch_floats(int B, int H, int Hkv, int D,
                                              int page_size, int pages_per_seq) {
  if (B <= 0 || Hkv <= 0 || page_size <= 0 || pages_per_seq <= 0) return 0;
  return B * H * chunks_for(page_size, pages_per_seq, D) * (D + 2);
}

template <class E>
int dispatch(const E* q, const E* k_pages, const E* v_pages, const int* tables,
             const int* lengths, E* out, float* scratch, int B, int H, int Hkv, int D,
             int page_size, int pages_per_seq, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 || D % 4 != 0 ||
      D > MAX_D || page_size <= 0 || page_size % PAGE_MULTIPLE != 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D > NARROW_D) return launch_g<E, chunk_tokens(MAX_D)>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
  return launch_g<E, chunk_tokens(NARROW_D)>(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
}

extern "C" int paged_attention_launch(const float* q, const float* k_pages,
                                      const float* v_pages, const int* tables,
                                      const int* lengths, float* out,
                                      float* scratch, int B, int H, int Hkv,
                                      int D, int page_size, int pages_per_seq,
                                      void* stream) {
  return dispatch(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D,
                  page_size, pages_per_seq, stream);
}

// The same on bf16 q, pages and out (f32 scratch).
extern "C" int paged_attention_bf16_launch(const bf16* q, const bf16* k_pages,
                                           const bf16* v_pages, const int* tables,
                                           const int* lengths, bf16* out, float* scratch,
                                           int B, int H, int Hkv, int D, int page_size,
                                           int pages_per_seq, void* stream) {
  return dispatch(q, k_pages, v_pages, tables, lengths, out, scratch, B, H, Hkv, D,
                  page_size, pages_per_seq, stream);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
