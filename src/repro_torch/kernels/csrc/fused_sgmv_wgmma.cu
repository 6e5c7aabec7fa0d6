// fused_sgmv on Hopper's warpgroup tensor cores (sm_90a), for bf16 inputs:
// y = x·W + scale·(x·A[id])·B[id], the base product and the expand on
// wgmma with x, W and B[id] brought by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel fused_sgmv of
// src/repro/kernels/sgmv.py (body _fused_sgmv_kernel): bf16 x, W, A and B,
// f32 dot products, h = x·A kept in f32, B promoted to f32 for h·B, y
// rounded to bf16 once; a negative id keeps x·W and drops the delta (it
// never reads A or B). x is flattened to M = B·S rows and row m carries
// the id of batch row m / S. f32 launches, sgmv, M <= 16 (the skinny
// path) and the bf16 shapes this file does not take stay on
// fused_sgmv.cu; sgmv.py's bf16_path picks the loop before the launch.
//
// What bounds it on this card: past a few hundred rows, the tensor cores.
// qwen3-0.6b's q projection over 8 x 2016 tokens is 2·M·d_in·d_out = 67.6
// GFLOP of x·W against 2·(M·d_in + d_in·d_out + M·d_out) = 103 MB, ~650
// flop/byte, 0.068 ms at 989 TFLOP/s in bf16. fused_sgmv.cu's mma.sync
// loop (8 warps issuing their own m16n8k16 products from fragments they
// load themselves) reached ~109 TFLOP/s of it.
//
// What the design does about it, three kernels:
// 1. The rank-r shrink, h = scale·x·A[id] in f32, on mma.sync bf16
//    m16n8k16 (f32 sums; 3 % of the flops at r = 32): a block takes 64 rows
//    of one batch row (one id) and 32 ranks, over one part of d_in (at
//    most 512 of d_in where the card has room for more blocks, as at the
//    extend's 8 x 32 rows), and the last part's block of each (an int32
//    counter tells it) adds the parts in order into h. Ranks pad to rs =
//    32·ceil(r/32) with zeros; the rank is a loop count, no template. Rows
//    of id < 0 write zeros and never read A.
// 2. The tile loop. A block owns a 128 x 256 output tile. Three
//    warpgroups: a producer (one thread issues the TMA loads; setmaxnreg
//    hands its registers to the others) and two consumers of 64 rows,
//    which run every product as wgmma.mma_async over the whole warpgroup
//    (m64n256k16, 128 f32 sums a thread).
//    - x tiles (128 rows x 64 k, K-major as they lie) and W tiles (64 k x
//      256 columns: W (d_in, d_out) is MN-major, read through the
//      descriptor's transpose bit, no copy) come through a ring of 4
//      stages of 48 KiB in the 128-byte swizzle, on a "full" and an
//      "empty" mbarrier a stage. Rows past M, k past d_in and columns past
//      d_out are the tensor maps' out-of-bounds zeros, so any M and S
//      (2016, 37), deepseek's d_out = 576 and a partial k slice run one
//      code path; stores are masked.
//    - A consumer issues a stage's four k16 products, waits until only
//      they are in flight and releases the stage before (2-3 % faster than
//      waiting for its own: scripts/sgmv_wgmma_variants.py).
//    - The expand follows x·W in the same accumulator, through the same
//      ring, so its loads are in flight while x·W runs (placed before it,
//      with a stage's products left in flight, ptxas serialized every
//      wgmma: C7515; with h read from global memory in the consumers it
//      cost ~20 % of a call). For each adapter id live in the tile (once,
//      however many batch rows carry it), stages of 32 ranks: h's rows
//      (f32, 128 bytes a row) into the x slot and B[id] (a 3-D map over
//      (d_out, r, N): ranks past r are zeros) into the W slot. h splits in
//      registers into bf16 hi + lo, the register form's
//      A fragments, with rows of other ids and past M zero (their products
//      add exact zeros); lo·B[id], then hi·B[id]. B[id] is exact in bf16,
//      and hi + lo keeps h to 2^-17 of |h|. A warpgroup without a row of
//      the id skips the products. Tiles straddle batch rows wherever S is
//      no multiple of 128.
//    - Where the output tiles fill less than half the card (M below ~1000
//      rows at d_out = 2048) the plan splits d_in over up to 8 blocks a
//      tile (make_plan); each writes its f32 partial tile.
//    - Epilogue: rounded once to bf16, staged in shared memory, 16-byte
//      stores.
//    - It is launched as a programmatic dependent of the shrink: its blocks
//      take the SMs as the shrink's drain, and only the producer's h loads
//      wait for the shrink to finish.
// 3. Where d_in is split: the partial tiles added in order, rounded once.
//
// Sums. Each k16 step adds its 16 exact products to the f32 accumulator
// rounding toward zero, one chain over all of d_in: at d_in = 4096 (256
// steps) the drift stays below 2^-15 of the sum, inside one bf16 rounding,
// so there is no f32 flush. tests/test_torch_sgmv_wgmma.py emulates the
// arithmetic. No float atomics (the counters are int32 and pick a block,
// not an order): repeat launches give the same bits.
//
// Shapes: bf16, d_in and d_out multiples of 8 (TMA's 16-byte strides), x,
// W, A and B on 16-byte bases, ranks 1 to 128; anything else returns
// cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include <stdio.h>

#include <algorithm>

#include "bf16_mma.cuh"
#include "wgmma.cuh"

namespace {

// the tile loop
constexpr int BM = 128, BN = 256;  // output tile
constexpr int BK = 64;             // k of a ring stage: 128 bytes of a row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;       // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128·40 + 256·232 <= 65536
constexpr uint32_t X_BYTES = BM * BK * 2;          // a stage's x: 128 rows of 128 bytes
constexpr uint32_t W_CHUNK = BK * 128;             // 64 columns of 64 k rows
constexpr uint32_t W_BYTES = (BN / 64) * W_CHUNK;  // a stage's W (or B[id])
constexpr uint32_t STAGE = X_BYTES + W_BYTES;      // 48 KiB
constexpr int EXPAND_RANKS = 32;  // ranks of an expand stage: h's rows are 128 bytes
constexpr int OUT_LD = BN + 8;    // epilogue rows (bf16): lanes of a quad on distinct banks
// dynamic shared memory: 1024 bytes of alignment slack, the ring, the mbarriers
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 16 * STAGES;
static_assert(CONSUMERS * 64 * OUT_LD * 2 <= STAGES * STAGE, "the epilogue fits the ring");
constexpr int MAX_PARTS = 8;  // parts of d_in, in the shrink and in the tile loop
constexpr int MIN_KPER = 2;   // k stages a part of the tile loop takes at least

// the shrink
constexpr int SH_THREADS = 128, SH_ROWS = 64, SH_RANKS = 32, SH_K = 64, SH_STAGES = 3;
constexpr int SX_LD = SH_K + 8;      // x rows: fragment (g, t) -> bank 4g + t
constexpr int SA_LD = SH_RANKS + 8;  // A rows of 80 bytes: ldmatrix's 8 rows on distinct banks

// k stages a shrink block takes at most where the card has room for more
// blocks: 8, or 2 where A is staged element by element (r % 8 != 0)
constexpr int SH_KPER = 8, SH_KPER_SCALAR = 2;

__host__ __device__ constexpr int padded_rank(int r) { return (r + SH_RANKS - 1) / SH_RANKS * SH_RANKS; }

// Pass 1: h[m][rk0 .. rk0 + 31] = scale·x[m]·A[id] for the rows s0 .. s0 +
// 63 of batch row b = blockIdx.x (s0 = 64·blockIdx.y), rk0 = 32·(blockIdx.z
// % (rs / 32)), over part z = blockIdx.z / (rs / 32) of d_in: k slices [z·kper,
// (z + 1)·kper) of 64. Each warp owns 16 rows, four m16n8k16 tiles of ranks;
// x and A[id] come through a 3-stage cp.async ring. vec_a: r % 8 == 0, A
// staged in 16-byte copies; else element by element. Ranks past r are
// zeros. With one part the block writes h; with more, its partial goes to
// hpart[z] and the last part's block to finish (an int32 counter per
// (b, row block, rank chunk) tells it, and it sets the counter back to 0)
// adds the parts in order into h. Rows of id < 0 get zeros, A unread.
__global__ void __launch_bounds__(SH_THREADS) shrink_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ lora_a, const int* __restrict__ ids,
    float* __restrict__ h, float* __restrict__ hpart, int* __restrict__ counters, int M, int S,
    int d_in, int r, int rs, int kper, bool vec_a, float scale) {
  __shared__ __align__(16) bf16 xs[SH_STAGES][SH_ROWS][SX_LD];
  __shared__ __align__(16) bf16 a_s[SH_STAGES][SH_K][SA_LD];
  __shared__ bool last;
  grid_dependents_launch();  // the tile loop may start its x·W while this grid runs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rparts = rs / SH_RANKS, parts = gridDim.z / rparts;
  const int z = blockIdx.z / rparts, rk0 = blockIdx.z % rparts * SH_RANKS;
  const int b = blockIdx.x, s0 = blockIdx.y * SH_ROWS;
  const int rows = min(SH_ROWS, S - s0);
  const size_t m0 = (size_t)b * S + s0;
  const int id = ids[b];
  float* hb = h + m0 * rs + rk0;
  if (id < 0) {  // uniform over the block; every part writes the same zeros
    for (int e = tid; e < rows * SH_RANKS; e += SH_THREADS)
      hb[(size_t)(e / SH_RANKS) * rs + e % SH_RANKS] = 0.f;
    return;
  }
  const bf16* xb = x + m0 * d_in;
  const bf16* ab = lora_a + (size_t)id * d_in * r;
  const int KT = (d_in + SH_K - 1) / SH_K;
  const int kt0 = z * kper, kt1 = min(kt0 + kper, KT);  // the plan: kt0 < kt1
  auto load = [&](int kt, int st) {
    const int k0 = kt * SH_K;
#pragma unroll
    for (int i = 0; i < SH_ROWS * SH_K / 8 / SH_THREADS; ++i) {
      const int c = tid + i * SH_THREADS, row = c / (SH_K / 8), kc = c % (SH_K / 8) * 8;
      const bool ok = row < rows && k0 + kc < d_in;
      wg::cp_async16_to(wg::smem_u32(&xs[st][row][kc]),
                        ok ? xb + (size_t)row * d_in + k0 + kc : x, ok);
    }
    if (vec_a) {
#pragma unroll
      for (int i = 0; i < SH_K * SH_RANKS / 8 / SH_THREADS; ++i) {
        const int c = tid + i * SH_THREADS, kk = c / (SH_RANKS / 8), rc = c % (SH_RANKS / 8) * 8;
        const bool ok = k0 + kk < d_in && rk0 + rc < r;
        wg::cp_async16_to(wg::smem_u32(&a_s[st][kk][rc]),
                          ok ? ab + (size_t)(k0 + kk) * r + rk0 + rc : lora_a, ok);
      }
    } else {  // visible after the barrier every consumer of the stage waits at
      for (int c = tid; c < SH_K * SH_RANKS; c += SH_THREADS) {
        const int kk = c / SH_RANKS, rc = c % SH_RANKS;
        const bool ok = k0 + kk < d_in && rk0 + rc < r;
        a_s[st][kk][rc] = ok ? ab[(size_t)(k0 + kk) * r + rk0 + rc] : __float2bfloat16_rn(0.f);
      }
    }
  };
  float acc[1][SH_RANKS / 8][4] = {};
#pragma unroll
  for (int s = 0; s < SH_STAGES - 1; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<SH_STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();                 // everyone's; and the slot of kt - 1 is consumed
    if (kt + SH_STAGES - 1 < kt1) load(kt + SH_STAGES - 1, (kt - kt0 + SH_STAGES - 1) % SH_STAGES);
    cp_async_commit();
    const int st = (kt - kt0) % SH_STAGES;
#pragma unroll
    for (int kk = 0; kk < SH_K; kk += 16)
      mma_k16_bf16(acc, &xs[st][16 * warp][kk], SX_LD, &a_s[st][kk][0], SA_LD);
  }
  // C fragment of n8 tile nt: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  float* dst = parts > 1 ? hpart + ((size_t)z * M + m0) * rs + rk0 : hb;
#pragma unroll
  for (int nt = 0; nt < SH_RANKS / 8; ++nt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
      if (row < rows)
        *reinterpret_cast<float2*>(dst + (size_t)row * rs + 8 * nt + 2 * t) =
            make_float2(scale * acc[0][nt][2 * hh], scale * acc[0][nt][2 * hh + 1]);
    }
  if (parts == 1) return;
  __threadfence();  // this block's part is visible before the count
  __syncthreads();
  if (tid == 0) {
    int* count = counters + ((size_t)b * gridDim.y + blockIdx.y) * rparts + blockIdx.z % rparts;
    last = atomicAdd(count, 1) == parts - 1;
    if (last) *count = 0;  // every part has counted: zero for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = hpart + m0 * rs + rk0;
  for (int e = tid; e < rows * SH_RANKS / 4; e += SH_THREADS) {
    const size_t off = (size_t)(e / (SH_RANKS / 4)) * rs + e % (SH_RANKS / 4) * 4;
    float4 v = __ldcg(reinterpret_cast<const float4*>(p0 + off));
    for (int zz = 1; zz < parts; ++zz) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(p0 + (size_t)zz * M * rs + off));
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(hb + off) = v;
  }
}

// Pass 2: the BM x BN output tile (blockIdx.y, blockIdx.x) over k slices
// [z·kper, (z + 1)·kper) of 64, z = blockIdx.z: y, or with gridDim.z > 1
// the f32 partial tile part[z] (M x d_out). Block z = 0 adds the expand.
// Through the ring: x and W by xmap (d_in, M; boxes of 64 x 128) and wmap
// (d_out, d_in; 64 x 64), then for each expand stage h by hmap (f32; rs,
// M; 32 x 128) into the x slot and B[id] by bmap (d_out, r, N; 64 x 32 x
// 1) into the W slot.
__global__ void __launch_bounds__(THREADS, 1) tile_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap bmap,
    const int* __restrict__ ids, float* __restrict__ part, int kper, bf16* __restrict__ y,
    int M, int S, int d_in, int d_out, int r) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every tile starts on one
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = wg::smem_u32(smem);
  const uint32_t full0 = ring + STAGES * STAGE, empty0 = full0 + 8 * STAGES;
  __shared__ int seg_id[BM];    // adapter id of each batch row in the tile
  __shared__ int seg_lead[BM];  // that id is live and new in the tile

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, z = blockIdx.z;
  const int KT = (d_in + BK - 1) / BK;
  const int kt0 = z * kper, kt1 = min(kt0 + kper, KT);  // the plan: kt0 < kt1
  const int b0 = m0 / S;
  // batch rows the tile meets; the expand is block z = 0's alone
  const int nseg = z == 0 ? (min(m0 + BM, M) - 1) / S - b0 + 1 : 0;
  const int echunks = (r + EXPAND_RANKS - 1) / EXPAND_RANKS;  // expand stages an id
  const int wchunks = min(BN / 64, (d_out - n0 + 63) / 64);   // 64-column chunks inside d_out
  if (tid < nseg) seg_id[tid] = ids[b0 + tid];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full0 + 8 * s, 1);
      wg::mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < nseg) {
    const int id = seg_id[tid];
    bool lead = id >= 0;
    for (int p = 0; p < tid && lead; ++p) lead = seg_id[p] != id;
    seg_lead[tid] = lead;
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues the loads
    wg::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      int u = 0;  // stages issued
      auto acquire = [&](uint32_t bytes) {
        const int st = u % STAGES;
        if (u >= STAGES) wg::mbar_wait(empty0 + 8 * st, (u / STAGES - 1) & 1);  // released
        wg::mbar_expect_tx(full0 + 8 * st, bytes);
        ++u;
        return st;
      };
      for (int kt = kt0; kt < kt1; ++kt) {
        const int st = acquire(X_BYTES + wchunks * W_CHUNK);
        const uint32_t xs = ring + st * STAGE;
        wg::tma_load2(xs, &xmap, full0 + 8 * st, kt * BK, m0);
        for (int c = 0; c < wchunks; ++c)
          wg::tma_load2(xs + X_BYTES + c * W_CHUNK, &wmap, full0 + 8 * st, n0 + 64 * c, kt * BK);
      }
      // h is the shrink's: launched as its programmatic dependent, the block
      // may have run x·W beside it, and waits here (every block, so the
      // grid ends after the shrink) until it has finished
      grid_dependency_wait();
      for (int s = 0; s < nseg; ++s) {
        if (!seg_lead[s]) continue;
        for (int e = 0; e < echunks; ++e) {  // ranks [32e, 32e + 32) of h and of B[id]
          const int st = acquire(X_BYTES + wchunks * (W_CHUNK / 2));
          const uint32_t xs = ring + st * STAGE;
          wg::tma_load2(xs, &hmap, full0 + 8 * st, e * EXPAND_RANKS, m0);
          for (int c = 0; c < wchunks; ++c)
            wg::tma_load3(xs + X_BYTES + c * W_CHUNK, &bmap, full0 + 8 * st, n0 + 64 * c,
                          e * EXPAND_RANKS, seg_id[s]);
        }
      }
    }
    return;
  }
  wg::setmaxnreg_inc<CONSUMER_REGS>();

  const int c = tid / 128 - 1;  // consumer warpgroup: tile rows 64c .. 64c + 63
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int mw = m0 + 64 * c;                      // the warpgroup's first row
  const int row0 = mw + 16 * warp + g, row1 = row0 + 8;  // this thread's two rows
  float acc[BN / 2];  // 64 x BN of the tile: BN / 8 n8 blocks
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int u = 0;  // stages consumed
  auto wait_full = [&]() {
    const int st = u % STAGES;
    wg::mbar_wait(full0 + 8 * st, (u / STAGES) & 1);
    ++u;
    return st;
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty0 + 8 * st);  // this warp is done with the stage
  };

  // x·W: k16 step kk of a stage reads 32 bytes into each x row (K-major)
  // and W's k rows 16kk .. 16kk + 15 (MN-major: LBO the next 64 columns,
  // SBO the next 8 k rows)
  int prev = -1;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = wait_full();
    const uint32_t xs = wg::opaque(ring + st * STAGE), ws = xs + X_BYTES;
    const uint32_t xa = xs + 64 * c * 128;  // this warpgroup's 64 rows
    wg::fence_regs(acc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::wgmma_ss_mn(acc, wg::desc(xa + 32 * kk, 0, 1024),
                      wg::desc(ws + kk * 16 * 128, W_CHUNK, 1024));
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // the previous stage's products have completed
    wg::fence_regs(acc);
    if (prev >= 0) release(prev);
    prev = st;
  }
  wg::wgmma_wait();
  wg::fence_regs(acc);
  release(prev);

  // The expand, into the same accumulator: an expand stage holds ranks e0
  // .. e0 + 31 of the tile's h rows (f32, 128 bytes a row, 16-byte groups
  // swizzled by row) and of B[id] (MN-major, as W). k16 step j of it: A =
  // h at (row0, 16j + 2t ..), (row1, ..), (row0, 16j + 2t + 8 ..), (row1,
  // ..), zero where the row's id is not this one, as bf16 lo and hi.
  for (int s = 0; s < nseg; ++s) {
    if (!seg_lead[s]) continue;  // uniform over the block
    const int id = seg_id[s];
    bool has = false;  // a row of this warpgroup carries the id: uniform over it
    if (mw < M)
      for (int p = mw / S - b0; p <= (min(mw + 64, M) - 1) / S - b0; ++p) has |= seg_id[p] == id;
    const bool keep0 = row0 < M && seg_id[row0 / S - b0] == id;
    const bool keep1 = row1 < M && seg_id[row1 / S - b0] == id;
    for (int e = 0; e < echunks; ++e) {
      const int st = wait_full();
      if (has) {
        const unsigned char* hs = smem + st * STAGE;
        const uint32_t ws = wg::opaque(ring + st * STAGE + X_BYTES);
        auto h2 = [&](bool keep, int row, int k) {  // h[row][k], h[row][k + 1] of the stage
          const int lr = row - m0;
          const float2 v = *reinterpret_cast<const float2*>(
              hs + lr * 128 + (((k >> 2) ^ (lr & 7)) << 4) + (k & 3) * 4);
          return keep ? v : make_float2(0.f, 0.f);
        };
        unsigned ahi[EXPAND_RANKS / 16][4], alo[EXPAND_RANKS / 16][4];
#pragma unroll
        for (int j = 0; j < EXPAND_RANKS / 16; ++j) {
          const int k = 16 * j + 2 * t;
          const float2 v[4] = {h2(keep0, row0, k), h2(keep1, row1, k), h2(keep0, row0, k + 8),
                               h2(keep1, row1, k + 8)};
#pragma unroll
          for (int i = 0; i < 4; ++i) split_bf16(v[i].x, v[i].y, ahi[j][i], alo[j][i]);
        }
        wg::fence_regs(acc);
        wg::fence_regs(ahi);
        wg::fence_regs(alo);
        wg::wgmma_fence();
#pragma unroll
        for (int j = 0; j < EXPAND_RANKS / 16; ++j) {
          const uint64_t db = wg::desc(ws + j * 16 * 128, W_CHUNK, 1024);
          wg::wgmma_rs(acc, alo[j], db);
          wg::wgmma_rs(acc, ahi[j], db);
        }
        wg::wgmma_commit();
        wg::wgmma_wait();
        wg::fence_regs(acc);
        wg::fence_regs(ahi);  // live until here: nothing reuses them while they are read
        wg::fence_regs(alo);
      }
      release(st);
    }
  }

  // epilogue: accumulator fragment d[4j + 0..3] = (row0, n), (row0, n + 1),
  // (row1, n), (row1, n + 1) with n = n0 + 8j + 2t
  if (gridDim.z > 1) {  // the f32 partial tile
    float* pz = part + (size_t)z * M * d_out;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= d_out) continue;
      if (row0 < M)
        *reinterpret_cast<float2*>(pz + (size_t)row0 * d_out + n) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row1 < M)
        *reinterpret_cast<float2*>(pz + (size_t)row1 * d_out + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  wg::bar_sync(1, 128 * CONSUMERS);  // both warpgroups' products are done: the ring is free
  bf16* stg = reinterpret_cast<bf16*>(smem) + c * 64 * OUT_LD;
  const int l0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<unsigned*>(stg + l0 * OUT_LD + 8 * j + 2 * t) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<unsigned*>(stg + (l0 + 8) * OUT_LD + 8 * j + 2 * t) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg::bar_sync(2 + c, 128);
  for (int e = wt; e < 64 * (BN / 8); e += 128) {
    const int l = e / (BN / 8), j = e % (BN / 8), m = mw + l, n = n0 + 8 * j;
    if (m < M && n < d_out)
      *reinterpret_cast<uint4*>(y + (size_t)m * d_out + n) =
          *reinterpret_cast<const uint4*>(stg + l * OUT_LD + 8 * j);
  }
}

// A 2-D tensor map over a row-major (outer, inner) matrix of ``type``
// (``bytes`` an element): boxes of box_inner x box_outer, the 128-byte
// swizzle, zeros out of bounds.
int map2(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int inner,
         int outer, int box_inner, int box_outer) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)inner * bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = enc(map, type, 2, const_cast<void*>(base), dims, stride, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

// The 3-D tensor map (d_out, r, N) of lora_b: boxes of 64 columns x 32
// ranks of one adapter; ranks past r are zeros.
int map_b(CUtensorMap* map, const bf16* base, int d_out, int r, int N) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d_out, (cuuint64_t)r, (cuuint64_t)N};
  const cuuint64_t stride[2] = {(cuuint64_t)d_out * 2, (cuuint64_t)r * d_out * 2};
  const cuuint32_t box[3] = {64, EXPAND_RANKS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)base, dims, stride,
                           box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

int cdiv(long long a, int b) { return (int)((a + b - 1) / b); }

// How a launch splits its work on a card of ``sms`` SMs. h's ranks pad to
// rs. The shrink's blocks (64 rows of one batch row, 32 ranks) split d_in
// into parts of at most SH_KPER k stages of 64 (SH_KPER_SCALAR where r % 8
// != 0) while the parts give at most two blocks an SM; the last part's
// block of each adds the parts in order into h, told by one of
// ``counters`` int32 zeros. The tile loop's 128 x 256 output tiles split
// d_in where they fill less than half the card, until they fill about half
// of it (past that the partial tiles cost more than the idle SMs), each
// part at least MIN_KPER stages, and sum_parts_kernel adds their partial
// tiles in order (scripts/sgmv_wgmma_variants.py times other plans). The
// scratch (f32) holds h (M x rs), the shrink's partials (parts x M x rs)
// where it is split and the partial tiles (parts x M x d_out) where the
// tile loop is.
struct Plan {
  int rs;
  int shrink_parts, shrink_kper;  // of the shrink, in k stages of 64
  int base_parts, base_kper;      // of the tile loop
  long long scratch_floats;
  int counters;
};

// KT k stages in at most ``want`` (and MAX_PARTS) parts of at least
// ``least`` stages, none empty
void split(int KT, int want, int least, int& parts, int& kper) {
  parts = std::max(1, std::min(std::min(want, MAX_PARTS), KT / least));
  kper = (KT + parts - 1) / parts;
  parts = (KT + kper - 1) / kper;
}

Plan make_plan(int B, int S, int d_in, int d_out, int r, int sms) {
  Plan p;
  const long long M = (long long)B * S;
  const int KT = cdiv(d_in, BK);
  p.rs = padded_rank(r);
  const int blocks = B * cdiv(S, SH_ROWS) * (p.rs / SH_RANKS);
  const int kmax = r % 8 == 0 ? SH_KPER : SH_KPER_SCALAR;
  split(KT, std::min(cdiv(KT, kmax), 2 * sms / blocks), 1, p.shrink_parts, p.shrink_kper);
  const int tiles = cdiv(M, BM) * cdiv(d_out, BN);
  split(KT, sms / (2 * tiles), MIN_KPER, p.base_parts, p.base_kper);
  p.scratch_floats = M * p.rs + (p.shrink_parts > 1 ? p.shrink_parts * M * p.rs : 0) +
                     (p.base_parts > 1 ? p.base_parts * M * d_out : 0);
  p.counters = p.shrink_parts > 1 ? blocks : 0;
  return p;
}

bool shape_ok(int M, int S, int d_in, int d_out, int r, int sms) {
  return M > 0 && S > 0 && M % S == 0 && d_in > 0 && d_in % 8 == 0 && d_out > 0 &&
         d_out % 8 == 0 && r > 0 && r <= 128 && sms > 0;
}

}  // namespace

// The plan of a launch of B x S rows (make_plan), for the caller to size
// the scratch and the counters: out = {shrink parts, shrink kper, base
// parts, base kper, scratch floats, counters}.
extern "C" int fused_sgmv_wgmma_plan(int B, int S, int d_in, int d_out, int r, int sms,
                                     long long* out) {
  if (B <= 0 || !shape_ok(B * S, S, d_in, d_out, r, sms) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, S, d_in, d_out, r, sms);
  const long long v[6] = {p.shrink_parts, p.shrink_kper, p.base_parts, p.base_kper,
                          p.scratch_floats, p.counters};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// fused_sgmv_bf16_launch's function on this file's kernels, split by
// make_plan for a card of ``sms`` SMs. N: adapters in lora_a and lora_b.
// scratch: ``scratch_floats`` f32, at least the plan's; counters:
// ``n_counters`` int32 zeros, at least the plan's (NULL where it needs
// none), left zero. A buffer shorter than the plan needs is refused.
extern "C" int fused_sgmv_bf16_wgmma_launch(const bf16* x, const bf16* w, const bf16* lora_a,
                                            const bf16* lora_b, const int* ids, bf16* y,
                                            float* scratch, long long scratch_floats,
                                            int* counters, int n_counters, int M, int S,
                                            int d_in, int d_out, int r, int N, int sms,
                                            float scale, void* stream) {
  if (!shape_ok(M, S, d_in, d_out, r, sms) || N <= 0 || !aligned16(x) || !aligned16(w) ||
      !aligned16(lora_a) || !aligned16(lora_b) || !aligned16(y) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  const Plan plan = make_plan(M / S, S, d_in, d_out, r, sms);
  if (scratch_floats < plan.scratch_floats ||
      (plan.counters > 0 && (counters == nullptr || n_counters < plan.counters)))
    return (int)cudaErrorInvalidValue;
  const int shrink_parts = plan.shrink_parts, shrink_kper = plan.shrink_kper;
  const int base_parts = plan.base_parts, base_kper = plan.base_kper;
  const cudaStream_t st = (cudaStream_t)stream;
  const int rs = plan.rs;
  float* h = scratch;
  float* hpart = h + (size_t)M * rs;
  float* part = hpart + (shrink_parts > 1 ? (size_t)shrink_parts * M * rs : 0);
  CUtensorMap xmap, wmap, hmap, bmap;
  int err = map2(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, d_in, M, BK, BM);
  if (err == 0) err = map2(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, d_out, d_in, 64, BK);
  if (err == 0) err = map2(&hmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, h, rs, M, EXPAND_RANKS, BM);
  if (err == 0) err = map_b(&bmap, lora_b, d_out, r, N);
  if (err != 0) return err;
  const dim3 sgrid(M / S, (S + SH_ROWS - 1) / SH_ROWS, shrink_parts * (rs / SH_RANKS));
  shrink_kernel<<<sgrid, SH_THREADS, 0, st>>>(x, lora_a, ids, h, hpart, counters, M, S, d_in, r,
                                              rs, shrink_kper, r % 8 == 0, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d_out + BN - 1) / BN, (M + BM - 1) / BM, base_parts);
  e = launch_dependent(tile_kernel, grid, dim3(THREADS), SMEM, st, xmap, wmap, hmap, bmap, ids,
                       part, base_kper, y, M, S, d_in, d_out, r);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || base_parts == 1) return (int)e;
  const size_t n = (size_t)M * d_out;
  const size_t blocks = (n / 4 + 255) / 256;
  const int cap = 4 * sm_count();
  sum_parts_kernel<bf16, true><<<blocks < (size_t)cap ? (int)blocks : cap, 256, 0, st>>>(
      part, y, n, base_parts);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sgmv_wgmma_error_string(int err) {
  if (err >= TENSOR_MAP_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             err - TENSOR_MAP_ERROR);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
