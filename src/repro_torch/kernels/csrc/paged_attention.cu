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
//   This "chunk" loop serves f32 and the bf16 shapes that the split loop
//   below does not take.
//
// The bf16 split loop (paged_attention_bf16_split_launch; paged_attention.py's
// bf16_path sends a bf16 launch here for G <= 16, D a multiple of 8 up to
// 256 and 16-byte bases). In bf16 the chunk loop's bytes halve but its time
// hardly moves: a fixed chain of round trips per 64-token block (the table
// entry, the token rows, two cp.async groups, a partial to scratch, a
// second kernel to merge) bounds it, not the bytes. So:
// - The grid is (n_split, B·Hkv): block (s, b, kv head) reads lengths[b]
//   (clamped to the table) and takes the s-th contiguous, equal share of
//   the row's live 64-token tiles; n_split <= 8 comes from the host
//   (paged_attention.split_plan: a few blocks an SM). Blocks follow the
//   live length, not the table's width; a block whose share is empty only
//   joins its cluster's barriers.
// - A ring of K/V tiles, loaded by TMA: a 4-D tensor map over (D, page,
//   Hkv, P), boxes of 64 d x BT tokens (BT = gcd(page, 64), so a box never
//   crosses a page), the 128-byte swizzle, full and empty mbarriers per
//   stage. A producer warp loads the block's table entries in one parallel
//   load (a window of 256 pages, reloaded in the rare row that needs more)
//   and issues each tile's boxes up to the ring's depth ahead, without a
//   round trip per tile. Boxes wholly past the length are not loaded, and
//   no key past it is read.
// - Eight consumer warps, each on 8 keys of every tile with a softmax state
//   of its own (m, l and Σ p·v in registers), so no barrier of the block
//   runs inside the loop: a warp waits for its stage, attends and releases
//   it. f32 FMA on the widened bf16 (a bf16 x bf16 product is exact in f32,
//   so this is the reference's upcast arithmetic up to the order of the
//   sums): at <= 1 flop a byte this stays under a tile's load time. Scores:
//   four lanes a key, each a quarter of D against the G heads' q (f32 in
//   shared memory), two shuffles; the swizzle puts the 8 keys of a warp on
//   disjoint banks. P·V: lane l owns columns 4l, 4l + 128, ... of every
//   head, p passed by shuffles. The warps' states meet once, at the end, in
//   a fixed order.
// - The merge without a second launch: the n_split blocks of one (b, kv
//   head) form a thread-block cluster. Each leaves (m, l, Σ p·v) in shared
//   memory; after a cluster barrier the blocks read one another's states
//   through distributed shared memory, block r merging the outputs
//   r, r + n_split, ... of the group, ranks in order, and write bf16; a
//   second barrier keeps every block's states alive until all have read
//   them. A row of length 0 writes zeros. No scratch, no atomics: repeat
//   launches give the same bits.
//
// Both loops take an optional lse (B, H) f32: each query's log-sum-exp of
// its scaled scores, m + log(l) in natural-log units, written where the
// chunks or the cluster's blocks merge; -inf for a row of length 0. A
// caller that attends part of a sequence's keys (a time shard of the
// cache) merges the parts' outputs with it. With a NULL lse nothing more
// is written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>

#include "bf16_mma.cuh"
#include "wgmma.cuh"

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
    const int* __restrict__ lengths, E* __restrict__ out, float* __restrict__ lse, int H,
    int D, int T, int nc) {
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
  if (lse != nullptr && blockIdx.y == 0 && lane == 0)
    lse[bh] = n_live > 0 ? mx + logf(fmaxf(L, 1e-30f)) : -__builtin_huge_valf();
}

template <class E, int GF, int CT>
int launch(const E* q, const E* k_pages, const E* v_pages,
           const int* tables, const int* lengths, E* out, float* lse, float* scratch,
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
                         lengths, out, lse, H, D, pages_per_seq * page_size, nc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class E, int CT>
int launch_g(const E* q, const E* k_pages, const E* v_pages,
             const int* tables, const int* lengths, E* out, float* lse, float* scratch,
             int B, int H, int Hkv, int D, int page_size, int pages_per_seq,
             cudaStream_t s) {
  switch (H / Hkv) {
    case 1: return launch<E, 1, CT>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 2: return launch<E, 2, CT>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 4: return launch<E, 4, CT>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    case 8: return launch<E, 8, CT>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
    default: return launch<E, 0, CT>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
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
             const int* lengths, E* out, float* lse, float* scratch, int B, int H, int Hkv, int D,
             int page_size, int pages_per_seq, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 || D % 4 != 0 ||
      D > MAX_D || page_size <= 0 || page_size % PAGE_MULTIPLE != 0 || pages_per_seq <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D > NARROW_D) return launch_g<E, chunk_tokens(MAX_D)>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
  return launch_g<E, chunk_tokens(NARROW_D)>(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D, page_size, pages_per_seq, s);
}

extern "C" int paged_attention_launch(const float* q, const float* k_pages,
                                      const float* v_pages, const int* tables,
                                      const int* lengths, float* out, float* lse,
                                      float* scratch, int B, int H, int Hkv,
                                      int D, int page_size, int pages_per_seq,
                                      void* stream) {
  return dispatch(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D,
                  page_size, pages_per_seq, stream);
}

// The same on bf16 q, pages and out (f32 scratch and lse).
extern "C" int paged_attention_bf16_launch(const bf16* q, const bf16* k_pages,
                                           const bf16* v_pages, const int* tables,
                                           const int* lengths, bf16* out, float* lse,
                                           float* scratch, int B, int H, int Hkv, int D,
                                           int page_size, int pages_per_seq, void* stream) {
  return dispatch(q, k_pages, v_pages, tables, lengths, out, lse, scratch, B, H, Hkv, D,
                  page_size, pages_per_seq, stream);
}

namespace {
namespace split {

namespace cg = cooperative_groups;

constexpr int CONSUMERS = 8;                  // warps that attend, 8 keys of a tile each
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp, last
constexpr int TK = 8 * CONSUMERS;             // tokens of a tile: 64
constexpr int MAX_SPLIT = 8;   // blocks of a cluster, at most (the portable size)
constexpr int MAX_G = 16;      // query heads per kv head of this loop
constexpr int WIN = 256;       // table entries a block holds at a time
constexpr int KPT = 4;         // lanes a key for the scores

// stages of the K/V ring: 4 for a head of at most 64, else 2 (D = 128: a
// 64 KiB ring, three blocks an SM)
template <int DC>
__host__ __device__ constexpr int stages() { return DC == 1 ? 4 : 2; }

// shared-memory pitch (floats) of a head's row of q or of the result
template <int DC>
__host__ __device__ constexpr int ld() { return 64 * DC; }

// dynamic shared memory: alignment slack, the ring (at the end, the warps'
// sums: 8·GP·QLD floats fit 2 stages), q (at the end, the warps' (m, l)),
// the result, (m, l) per head (4 floats a head: the mbarriers on 8 bytes),
// the table window, the full and empty mbarriers
template <int DC, int GP>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)stages<DC>() * 2 * DC * 8192 +
         sizeof(float) * ((size_t)2 * GP * ld<DC>() + 4 * GP) + sizeof(int) * WIN +
         16 * stages<DC>();
}

// n bf16 (4 or 8) at p widened to f32
template <int N>
__device__ __forceinline__ void widen(const unsigned char* p, float (&x)[N]) {
  unsigned w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// byte offset of 16-byte group c (8 d) of token row j in a tile of DC
// 64-d chunks of 64 rows each (row pitch 128 bytes, the 128-byte swizzle)
__device__ __forceinline__ int at(int j, int c) {
  return (c >> 3) * 8192 + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}

// One block: share s = blockIdx.x of (b, kv head) = blockIdx.y. q, out (B,
// H, D); K and V through kmap and vmap (D, page, Hkv, P; boxes of 64 x bt);
// tables (B, pages_per_seq), lengths (B,). GP: G rounded up to a power of
// two (heads past G run on zero q and are not written). Warps 0-7 attend,
// warp 8 loads.
template <int DC, int GP>
__global__ void __launch_bounds__(THREADS) paged_attention_split_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const int* __restrict__ tables,
    const int* __restrict__ lengths, bf16* __restrict__ out, float* __restrict__ lse, int Hkv,
    int G, int D, int page_size, int pages_per_seq, int bt) {
  constexpr int ST = stages<DC>();
  constexpr int QLD = ld<DC>();
  constexpr int K4 = (16 * DC + 31) / 32;  // 4-column groups of P·V a lane, at most
  constexpr uint32_t STAGE = 2 * DC * 8192;  // K's chunks, then V's
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(ring + ST * STAGE);  // [GP][QLD]
  float* res = qs + GP * QLD;                              // [GP][QLD]: Σ p·v
  float* ml = res + GP * QLD;                              // m [GP], l [GP], a pad
  int* pg = reinterpret_cast<int*>(ml + 4 * GP);           // [WIN]
  const uint32_t full0 = wg::smem_u32(pg + WIN), empty0 = full0 + 8 * ST;

  cg::cluster_group cluster = cg::this_cluster();
  const int ns = gridDim.x, s = blockIdx.x;
  const int b = blockIdx.y / Hkv, hkv = blockIdx.y % Hkv;
  const int H = Hkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = pages_per_seq * page_size;
  const int len = min(max(lengths[b], 0), T);
  const int n_live = (len + TK - 1) / TK;
  const int j0 = s * n_live / ns, j1 = (s + 1) * n_live / ns;  // this block's tiles
  const int nt = j1 - j0;
  const int NC = D / 8;  // 16-byte groups of a row

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      wg::mbar_init(full0 + 8 * i, 1);
      wg::mbar_init(empty0 + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: the table window (its lanes load it, in one round trip),
    // then each tile's boxes that hold a live token, ST tiles ahead
    int win0 = j0 * TK / page_size;
    auto load_window = [&]() {
      for (int i = lane; i < WIN; i += 32) {
        const int p = win0 + i;
        pg[i] = p < pages_per_seq ? tables[(size_t)b * pages_per_seq + p] : 0;
      }
      __syncwarp();
    };
    if (nt > 0) load_window();
    for (int i = 0; i < nt; ++i) {
      const int sg = i % ST;
      if (i >= ST) wg::mbar_wait(empty0 + 8 * sg, (i / ST - 1) & 1);  // stage released
      const int t0 = (j0 + i) * TK, t1 = min(t0 + TK, len);
      if ((t1 - 1) / page_size >= win0 + WIN) {  // past the window: reload it
        __syncwarp();
        win0 = t0 / page_size;
        load_window();
      }
      if (lane == 0) {
        const int nbox = (t1 - t0 + bt - 1) / bt;
        const uint32_t fb = full0 + 8 * sg;
        const uint32_t ks = wg::smem_u32(ring + sg * STAGE), vs = ks + DC * 8192;
        wg::mbar_expect_tx(fb, (uint32_t)nbox * DC * 2 * bt * 128);
        for (int x = 0; x < nbox; ++x) {
          const int t = t0 + x * bt;
          const int pe = pg[t / page_size - win0], off = t % page_size;
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            wg::tma_load4(ks + c * 8192 + x * bt * 128, &kmap, fb, 64 * c, off, hkv, pe);
            wg::tma_load4(vs + c * 8192 + x * bt * 128, &vmap, fb, 64 * c, off, hkv, pe);
          }
        }
      }
    }
  } else {
    // q widened to f32 (zeros past G and D)
    for (int e = tid; e < GP * QLD / 8; e += 32 * CONSUMERS) {
      const int g = e / (QLD / 8), c = e % (QLD / 8);
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (g < G && c < NC)
        widen(reinterpret_cast<const unsigned char*>(
                  q + ((size_t)b * H + hkv * G + g) * D + 8 * c), x);
      float4* dst = reinterpret_cast<float4*>(qs + g * QLD + 8 * c);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    wg::bar_sync(1, 32 * CONSUMERS);

    // Warp w attends keys 8w .. 8w + 7 of every tile with a softmax state of
    // its own; lanes 4j .. 4j + 3 hold key j's scores (a quarter of D each,
    // then two shuffles). P·V: lane l owns columns 4l, 4l + 128, ... of
    // every head. No barrier of the block inside the loop.
    const int jw = lane / KPT, p = lane % KPT;
    float m[GP], l[GP], acc[GP][K4][4];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int k = 0; k < K4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][k][e] = 0.f;
    }
    const float sqrt_d = sqrtf((float)D);
    for (int i = 0; i < nt; ++i) {
      const unsigned char* ks = ring + (i % ST) * STAGE;
      const unsigned char* vs = ks + DC * 8192;
      const int key0 = 8 * warp;  // the warp's keys in the tile
      const int live = min(8, len - (j0 + i) * TK - key0);  // live keys of the warp (may be <= 0)
      wg::mbar_wait(full0 + 8 * (i % ST), (i / ST) & 1);
      if (live > 0) {
        const int j = key0 + jw;
        float dot[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g) dot[g] = 0.f;
        if (jw < live) {
          for (int c = p; c < NC; c += KPT) {
            float kx[8];
            widen(ks + at(j, c), kx);
#pragma unroll
            for (int g = 0; g < GP; ++g) {
              const float4 q0 = *reinterpret_cast<const float4*>(qs + g * QLD + 8 * c);
              const float4 q1 = *reinterpret_cast<const float4*>(qs + g * QLD + 8 * c + 4);
              float d = dot[g];
              d = fmaf(q0.x, kx[0], d);
              d = fmaf(q0.y, kx[1], d);
              d = fmaf(q0.z, kx[2], d);
              d = fmaf(q0.w, kx[3], d);
              d = fmaf(q1.x, kx[4], d);
              d = fmaf(q1.y, kx[5], d);
              d = fmaf(q1.z, kx[6], d);
              d = fmaf(q1.w, kx[7], d);
              dot[g] = d;
            }
          }
        }
        float pr[GP];  // this lane's key's p of each head
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          float x = dot[g];
          x += __shfl_xor_sync(0xffffffffu, x, 1);
          x += __shfl_xor_sync(0xffffffffu, x, 2);
          x = jw < live ? x / sqrt_d : NEG_INF;
          float mx = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[g], mx);  // key 0 of the warp is live
          const float al = expf(m[g] - mn);
          const float e = jw < live ? expf(x - mn) : 0.f;
          float sum = e + __shfl_xor_sync(0xffffffffu, e, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          m[g] = mn;
          l[g] = l[g] * al + sum;
          pr[g] = e;
#pragma unroll
          for (int k = 0; k < K4; ++k)
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) acc[g][k][e4] *= al;
        }
        // O += P·V over the warp's live keys, in key order
        for (int jj = 0; jj < live; ++jj) {
          const int jk = key0 + jj;
#pragma unroll
          for (int k = 0; k < K4; ++k) {
            const int c4 = lane + 32 * k;  // 4-column group
            float vx[4] = {0.f, 0.f, 0.f, 0.f};
            if (c4 < D / 4) widen(vs + at(jk, c4 >> 1) + 8 * (c4 & 1), vx);
#pragma unroll
            for (int g = 0; g < GP; ++g) {
              const float pj = __shfl_sync(0xffffffffu, pr[g], KPT * jj);
#pragma unroll
              for (int e4 = 0; e4 < 4; ++e4) acc[g][k][e4] = fmaf(pj, vx[e4], acc[g][k][e4]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty0 + 8 * (i % ST));  // this warp is done with the stage
    }

    // the warps' states meet in a fixed order, into res and ml: their sums in
    // the free ring, their (m, l) where q was
    float* wacc = reinterpret_cast<float*>(ring);  // [CONSUMERS][GP][QLD]
    float* wm = qs;                                // [CONSUMERS][GP]: m, then l
    float* wl = wm + CONSUMERS * GP;
    wg::bar_sync(1, 32 * CONSUMERS);  // every warp is past its last read of the ring and q
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (lane == 0) {
        wm[warp * GP + g] = m[g];
        wl[warp * GP + g] = l[g];
      }
#pragma unroll
      for (int k = 0; k < K4; ++k) {
        const int c4 = lane + 32 * k;
        if (c4 < QLD / 4)
          *reinterpret_cast<float4*>(wacc + ((size_t)warp * GP + g) * QLD + 4 * c4) =
              make_float4(acc[g][k][0], acc[g][k][1], acc[g][k][2], acc[g][k][3]);
      }
    }
    wg::bar_sync(1, 32 * CONSUMERS);
    for (int e = tid; e < GP * QLD / 4; e += 32 * CONSUMERS) {
      const int g = e / (QLD / 4), c4 = e % (QLD / 4);
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) M = fmaxf(M, wm[w * GP + g]);
      float L = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        const float f = expf(wm[w * GP + g] - M);
        L = fmaf(wl[w * GP + g], f, L);
        const float4 x = *reinterpret_cast<const float4*>(wacc + ((size_t)w * GP + g) * QLD + 4 * c4);
        a.x = fmaf(x.x, f, a.x);
        a.y = fmaf(x.y, f, a.y);
        a.z = fmaf(x.z, f, a.z);
        a.w = fmaf(x.w, f, a.w);
      }
      *reinterpret_cast<float4*>(res + g * QLD + 4 * c4) = a;
      if (c4 == 0) {
        ml[g] = M;
        ml[GP + g] = L;
      }
    }
  }
  cluster.sync();  // every block's (m, l, Σ p·v) is in its shared memory

  // block s merges outputs s, s + ns, ... of (head, 16-byte group), ranks in order
  for (int unit = s * THREADS + tid; unit < G * NC; unit += ns * THREADS) {
    const int g = unit / NC, c = unit % NC;
    float M = NEG_INF;
    for (int r = 0; r < ns; ++r) M = fmaxf(M, *cluster.map_shared_rank(ml + g, r));
    float L = 0.f, a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ns; ++r) {
      const float w = expf(*cluster.map_shared_rank(ml + g, r) - M);
      L = fmaf(*cluster.map_shared_rank(ml + GP + g, r), w, L);
      const float4* rr =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(res + g * QLD + 8 * c, r));
      const float4 x0 = rr[0], x1 = rr[1];
      a[0] = fmaf(x0.x, w, a[0]);
      a[1] = fmaf(x0.y, w, a[1]);
      a[2] = fmaf(x0.z, w, a[2]);
      a[3] = fmaf(x0.w, w, a[3]);
      a[4] = fmaf(x1.x, w, a[4]);
      a[5] = fmaf(x1.y, w, a[5]);
      a[6] = fmaf(x1.z, w, a[6]);
      a[7] = fmaf(x1.w, w, a[7]);
    }
    const float inv = len > 0 ? 1.f / fmaxf(L, 1e-30f) : 0.f;  // a row of length 0: zeros
    *reinterpret_cast<uint4*>(out + ((size_t)b * H + hkv * G + g) * D + 8 * c) =
        make_uint4(pack_bf16(a[0] * inv, a[1] * inv), pack_bf16(a[2] * inv, a[3] * inv),
                   pack_bf16(a[4] * inv, a[5] * inv), pack_bf16(a[6] * inv, a[7] * inv));
    if (lse != nullptr && c == 0)
      lse[(size_t)b * H + hkv * G + g] = len > 0 ? M + logf(fmaxf(L, 1e-30f)) : -__builtin_huge_valf();
  }
  cluster.sync();  // no block leaves while another may still read its states
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The 4-D tensor map (D, page, Hkv, P) of a page pool: boxes of 64 d x bt
// tokens, the 128-byte swizzle, zeros out of bounds.
int pool_map(CUtensorMap* map, const bf16* base, int P, int page_size, int Hkv, int D, int bt) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)page_size, (cuuint64_t)Hkv,
                              (cuuint64_t)P};
  const cuuint64_t bytes[3] = {(cuuint64_t)Hkv * D * 2, (cuuint64_t)D * 2,
                               (cuuint64_t)page_size * Hkv * D * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)bt, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims, bytes, box,
                         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)r;
}

template <int DC, int GP>
int launch(const bf16* q, const bf16* k_pages, const bf16* v_pages, const int* tables,
           const int* lengths, bf16* out, float* lse, int B, int H, int Hkv, int D,
           int page_size, int pages_per_seq, int P, int n_split, cudaStream_t stream) {
  const int bt = gcd(page_size, TK);
  CUtensorMap kmap, vmap;
  int err = pool_map(&kmap, k_pages, P, page_size, Hkv, D, bt);
  if (err == 0) err = pool_map(&vmap, v_pages, P, page_size, Hkv, D, bt);
  if (err != 0) return err;
  const size_t smem = smem_bytes<DC, GP>();
  cudaError_t e = cudaFuncSetAttribute(paged_attention_split_kernel<DC, GP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * Hkv);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_attention_split_kernel<DC, GP>, kmap, vmap, q, tables,
                         lengths, out, lse, Hkv, H / Hkv, D, page_size, pages_per_seq, bt);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int DC>
int launch_g(const bf16* q, const bf16* k_pages, const bf16* v_pages, const int* tables,
             const int* lengths, bf16* out, float* lse, int B, int H, int Hkv, int D,
             int page_size, int pages_per_seq, int P, int n_split, cudaStream_t st) {
  const int G = H / Hkv;
  if (G <= 1) return launch<DC, 1>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, st);
  if (G <= 2) return launch<DC, 2>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, st);
  if (G <= 4) return launch<DC, 4>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, st);
  if (G <= 8) return launch<DC, 8>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, st);
  return launch<DC, 16>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, st);
}

}  // namespace split

}  // namespace

// The bf16 split loop: G <= 16, D a multiple of 8 up to 256, page a
// multiple of 8, q, the pools and out on 16-byte bases, 1 <= n_split <= 8
// (paged_attention.py: bf16_path, split_plan); P pages in each pool.
// Anything else returns cudaErrorInvalidValue.
extern "C" int paged_attention_bf16_split_launch(const bf16* q, const bf16* k_pages,
                                                 const bf16* v_pages, const int* tables,
                                                 const int* lengths, bf16* out, float* lse,
                                                 int B, int H, int Hkv, int D, int page_size,
                                                 int pages_per_seq, int P, int n_split,
                                                 void* stream) {
  auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > split::MAX_G || D <= 0 || D % 8 != 0 ||
      D > MAX_D || page_size <= 0 || page_size % PAGE_MULTIPLE != 0 || pages_per_seq <= 0 ||
      P <= 0 || n_split < 1 || n_split > split::MAX_SPLIT || B * Hkv > 65535 || !a16(q) ||
      !a16(k_pages) || !a16(v_pages) || !a16(out))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch ((D + 63) / 64) {  // chunks of 64 of D
    case 1: return split::launch_g<1>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, s);
    case 2: return split::launch_g<2>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, s);
    case 3: return split::launch_g<3>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, s);
    default: return split::launch_g<4>(q, k_pages, v_pages, tables, lengths, out, lse, B, H, Hkv, D, page_size, pages_per_seq, P, n_split, s);
  }
}

extern "C" const char* paged_attention_error_string(int err) {
  if (err >= TENSOR_MAP_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the page pool's tensor map (CUresult %d)",
             err - TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
