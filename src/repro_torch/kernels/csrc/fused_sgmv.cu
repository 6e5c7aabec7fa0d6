// fused_sgmv and sgmv: base projection plus multi-LoRA delta, and the delta
// alone, for Hopper (sm_90a): the kernels, templated on the element type,
// and their launch plans, with the C entries for f32 and bf16 inputs at
// the end. The build compiles this file with --split-compile (the two
// element types' kernels optimise in parallel threads).
//
// fused_sgmv_launch replaces src/repro/kernels/sgmv.py:fused_sgmv, the
// Pallas TPU kernel; sgmv_launch replaces src/repro/kernels/sgmv.py:sgmv.
// Both run the kernels below, with the base term compiled in or out
// (HAS_BASE): without it the tiled path never stages W and the skinny path
// never streams it, so y = scale·(x·A[id])·B[id], and a row with a negative
// id comes out as exact zeros without touching A or B.
//
// Computes y = x·W + scale·(x·A[id])·B[id] with x flattened to M = B·S rows;
// row m carries its batch row's adapter id ids[m / S]. A negative id keeps
// x·W and drops the delta: it never dereferences A or B (the TPU kernel
// clamps the id for the gather and masks with the raw id; the result is the
// same). Every output element has one owner and its sums run in a fixed
// order, so two launches on the same inputs give the same bits.
//
// What bounds it on this card: at decode (M = 8 rows) the kernel does
// 2·M flops per weight it reads (W is 4·d_in·d_out bytes), 4 flop/byte,
// so it is bound by the bytes of W. At a 256-token prefill bucket
// (M = 2048) it does ~1000 flop/byte and is bound by the arithmetic: f32
// products that keep f32 accuracy run at 165 TFLOP/s on the tensor cores
// (495 TFLOP/s TF32, three products each, see 3xTF32 below) and at
// 67 TFLOP/s on the CUDA cores.
//
// Two paths, chosen from the shapes:
//
// Tiled (M > 16, the prefill buckets and fresh prefills), two kernels:
// 1. The rank-r shrink, once per row: h[m] = scale·x[m]·A[id], f32 FMA on
//    the CUDA cores, as up to 8 partial sums over parts of d_in in a
//    scratch buffer the wrapper allocates. One block takes 64 rows of one
//    batch row, so one adapter, and one part of d_in: the parts put two
//    blocks per SM on the card (at M = 2048 the rows alone give 32). A row
//    of id < 0 writes zeros and never reads A. It is 2·M·d_in·r flops, 3 %
//    of the base product at r = 32, and one more read of x.
// 2. The base product and the expand on the tensor cores. A block owns a
//    128 x 128 output tile; its 8 warps own 64 x 32 each, 4 x 4 tiles of
//    mma.sync.m16n8k8 TF32. x and W move in 32-wide k slices through a
//    3-stage cp.async ring (16-byte copies, or 4-byte ones in the same
//    kernel where d_in or d_out is no multiple of 4; zero-fill past M,
//    d_in and d_out): slice k + 2 is in flight while slice k computes,
//    with one wait and one barrier per slice. Row pitches of 36 (x) and
//    136 (W) floats put the 32 scalar fragment loads of a warp on 32
//    banks. After the d_in loop, for each adapter id live in the tile
//    (once, however many batch rows carry it), B[id] (r x 128) and the
//    tile's h rows are staged, rows of other ids read as zero, and r/8
//    more k steps add h·B[id] to the same accumulator. Tiles straddle
//    batch rows wherever S is no multiple of 128 (2016 in a fresh
//    prefill, 37 in the tests).
//    Grid: columns fastest, so the blocks in flight share their x rows.
//    ~185 registers a thread allow one block per SM. At M = 2048 the q
//    projection gives 16 x 16 tiles, 256 blocks: two waves on 132 SMs, the
//    second 94 % full; k, v and o give 128 blocks, one wave. The engine's
//    smaller buckets (M = 64 .. 1024) give too few tiles, and each would
//    walk all of d_in alone: there d_in is split over up to 8 blocks per
//    tile for about one wave, each writes its partial tile, and a third
//    kernel adds them in a fixed order. A 64-row tile would double the
//    blocks but halve the reuse of each B fragment.
//
// 3xTF32. Each operand a splits as it leaves shared memory into
// hi = tf32(a) and lo = tf32(a − hi), rounded to nearest, so
// a = hi + lo + e with |e| <= 2^-22·|a|. The product is
// lo·hi + hi·lo + hi·hi (lo·lo, below 2^-22 of it, is dropped), each term
// exact in f32. The tensor cores add into their accumulator rounding
// toward zero, an error that grows with the number of products added to
// one accumulator; so each 128-wide part of d_in sums in its own
// accumulator, which then joins the tile's total in shared memory with a
// rounded f32 add (FLUSH). The result is within f32 reordering error of
// the plain version, and the kernel keeps the f32 tolerances of the
// parity checks; tests/test_torch_tf32x3.py emulates the arithmetic on the
// CPU. One TF32 product per term would keep ~11 bits and break them.
//
// Why the f32 path stays on mma.sync: wgmma reads TF32 operands from shared
// memory only K-major, and W is (d_in, d_out) row-major, N-major; it would
// need a transpose of every W tile in shared memory or a transposed copy of
// the weights in the model. mma.sync fragments are loaded thread by thread,
// so the [k][n] W tile is read as it lies. bf16 wgmma reads an MN-major B
// through the descriptor's transpose bit, so bf16 launches of fused_sgmv
// with more than 16 rows, d_in and d_out multiples of 8 and 16-byte bases
// run fused_sgmv_wgmma.cu's loop (sgmv.py's bf16_path); this file's bf16
// tiled loop takes the other bf16 shapes and sgmv.
//
// Skinny (M <= 16, the decode steps). Bound by the bytes of W: at M = 8
// the q projection reads 8 MB of W, ~0.9 MB of the live A and ~1.8 MB of
// the live B for ~3.4 us of device memory time, so the card has to stream
// W at close to its full rate, and the fixed costs of a launch weigh. Two
// kernels:
// 1. fused_sgmv_skinny_kernel, split-K. The grid takes d_out in slabs of
//    64 columns and d_in in as many k splits as put about two blocks on
//    every SM (q: 32 slabs x 8 splits; k, v, o: 16 x 16). Each block
//    streams its W slab (256 bytes of each k row, two whole 128-byte lines)
//    and its slab of x (M rows x 32 k) through a 4-stage cp.async ring of
//    32-row stages, all four in flight from the start (32 KB a block: the
//    whole k range of a q or o block; up to three blocks an SM), and
//    writes the M x 64 partial sum of its k range. Each of its 16 k
//    lanes owns two k rows of a stage and 4 columns, M float4 sums in
//    registers; the lanes meet by one shuffle and then in shared memory
//    in a fixed order. The same grid holds one more block per (batch row,
//    k split) for the rank-r shrink: the block of the first batch row with
//    a given live id streams that k range of A[id] (and of x) through the
//    same ring and writes h partials for every row carrying the id, so A
//    is read once per (adapter, k). Blocks of other rows and of id < 0
//    return at once; rows of id < 0 never touch A or B.
// 2. fused_sgmv_skinny_merge_kernel, one block per (row, 256 columns):
//    the k splits' partials in order, then scale·h·B[id] with h the
//    shrink partials in order. It is launched as a programmatic dependent
//    of the first kernel: its blocks start as the first kernel's blocks
//    finish and load their rows of B while the last W slabs stream.
// No atomics, no counters: two launches on the same inputs give the same
// bits, and nothing in the launch syncs with the host or allocates.
//
// Ranks. The rank is a template parameter R of every kernel (the staging
// loops index by it, and a division by a runtime rank costs more than the
// copy it addresses): 4, 8, 16, 32, 64 and 128 are compiled. Any rank r
// from 1 to 128 runs on the smallest compiled R >= r, with the ranks past r
// zero-filled in shared memory and never loaded (A and B keep their own
// (d_in, r) and (r, d_out) layouts), so h's ranks past r are exact zeros.
// Ranks past 64 are taken 64 at a time: the shrink blocks split the rank
// in halves and the expand stages h and B[id] in two chunks, so no tile
// outgrows the R = 64 one.
//
// sgmv (no base term) does 2·r·(d_in + d_out) flops per row against
// 4·(d_in + d_out) bytes of x and y, 16 flop/byte at r = 32: bound by the
// bytes of x and y at every M. On the tiled path it is the shrink pass and
// the expand alone: no d_in loop.
//
// bf16 (fused_sgmv_bf16_launch, sgmv_bf16_launch): x, W, A, B and y bf16,
// computing what the reference's Pallas kernel computes on bf16 inputs:
// x·W and h = x·A of the bf16 values with f32 sums, h kept in f32, h·B[id]
// with B promoted to f32, the sum in f32 and y rounded to bf16 once. Every
// kernel is templated on the element type E and stages 4 elements a copy
// (8 bytes in bf16: the same indices as f32, half the bytes); scratch and
// partials stay f32. The tiled path's base product runs one
// mma.sync.m16n8k16 bf16 product per k16 (x as 4-byte fragment loads, W's
// B fragments by ldmatrix.trans from its row-major [k][n] tile, no
// transpose), flushed to f32 every FLUSH slices as in f32; its expand runs
// the f32 h in two TF32 products (hi, lo) against B, which is exact in
// TF32. The skinny path streams bf16 W slabs through the same ring, half
// the bytes that bound a decode projection, widened to f32 for the FMA.
// The shrinks widen x and A to f32 for the FMA.

#include <cuda_runtime.h>

#include "bf16_mma.cuh"

namespace {

constexpr int THREADS = 256; // every kernel of this file

// tiled path
constexpr int TM = 128;      // rows per output tile
constexpr int TN = 128;      // output columns per tile
constexpr int TK = 32;       // k slice of one pipeline stage
constexpr int STAGES = 3;    // k slices in the cp.async ring
constexpr int FLUSH = 4;     // k slices summed on the tensor cores per f32 add
constexpr int WM = 64, WN = 32;           // one warp's part of the tile
constexpr int MT = WM / 16, NT = WN / 8;  // its m16n8k8 tiles
constexpr int XS_LD = TK + 4;  // x row pitch: fragment (g, t) -> bank 4g + t
constexpr int WS_LD = TN + 8;  // W row pitch: fragment (t, g) -> bank 8t + g
constexpr int XS_FLOATS = TM * XS_LD;
constexpr int STAGE_FLOATS = XS_FLOATS + TK * WS_LD;
// the tiled kernel's row pitches (elements) in bf16: x 20 words (its
// 4-byte fragment loads of a warp on 32 banks), W 16-byte rows of 272
// bytes (ldmatrix's eight rows on disjoint banks)
constexpr int XS_LD16 = TK + 8;
constexpr int WS_LD16 = TN + 8;

template <class E>
struct Tiled {  // the tiled kernel's ring for element type E
  static constexpr int XS_LD = sizeof(E) == 4 ? ::XS_LD : XS_LD16;
  static constexpr int WS_LD = sizeof(E) == 4 ? ::WS_LD : WS_LD16;
  static constexpr int XS = TM * XS_LD;          // elements of a stage's x
  static constexpr int STAGE = XS + TK * WS_LD;  // elements of a stage
  static constexpr size_t RING_BYTES = sizeof(E) * (size_t)STAGES * STAGE;
};
constexpr int SH_ROWS = 64;    // rows per shrink block
constexpr int MAX_SPLIT = 8;   // parts of d_in, each in its own block, at most
constexpr int MAX_RANK = 128;
constexpr int RANK_CHUNK = 64;  // ranks a shrink block or an expand stage takes

constexpr int SK_MAX_M = 16;                 // skinny path: rows at most
constexpr int SK_CN = 64;                    // output columns of a W block
constexpr int SK_KS = 32;                    // k rows of a ring stage
constexpr int SK_STAGES = 4;                 // ring depth, all stages in flight
constexpr int SK_PANEL = SK_KS * SK_CN;      // floats of a stage's W (or A) panel
constexpr int SK_STAGE = SK_PANEL + SK_MAX_M * SK_KS;  // panel, then x [M][SK_KS]
constexpr int SK_MERGE_THREADS = 64;         // merge block: 256 columns of one row
constexpr int SK_MAX_SPLITS = 16;            // k splits at most
static_assert(SK_KS * RANK_CHUNK <= SK_PANEL, "an A panel (SK_KS x 64 ranks) fits a stage");
static_assert(THREADS * SK_MAX_M <= SK_STAGES * SK_STAGE, "the shrink's k lanes meet in the ring");

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

bool use_skinny(int M, int d_in, int d_out) {
  return M <= SK_MAX_M && d_in % 4 == 0 && d_out % 4 == 0;
}

// How the skinny path splits its work: ``cols`` W blocks (64-column slabs;
// none without the base term) and one shrink block per batch row, in each
// of ``splits`` k splits of ``kper`` ring stages. The splits put about two
// W blocks on every SM (without the base term, about two shrink blocks per
// SM, counting one per row: M/S batch rows are at most M), at most 16;
// no split is empty. The shrink blocks come on top: at most one per adapter works.
struct SkinnyPlan {
  int cols, splits, kper;
};

SkinnyPlan skinny_plan(int M, int d_in, int d_out, bool has_base) {
  const int KT = (d_in + SK_KS - 1) / SK_KS;
  const int cols = has_base ? (d_out + SK_CN - 1) / SK_CN : 0;
  const int per_split = has_base ? cols : M;
  int splits = (2 * sm_count() + per_split - 1) / per_split;
  splits = splits < 1 ? 1 : (splits > KT ? KT : splits);
  splits = splits > SK_MAX_SPLITS ? SK_MAX_SPLITS : splits;
  const int kper = (KT + splits - 1) / splits;
  return {cols, (KT + kper - 1) / kper, kper};
}

// the compiled rank a rank r in [1, 128] runs on
int rank_capacity(int r) {
  int R = 4;
  while (R < r) R *= 2;
  return R;
}

// ranks of a shrink block or an expand stage, and how many a rank holds
__host__ __device__ constexpr int rank_chunk(int R) { return R < RANK_CHUNK ? R : RANK_CHUNK; }
__host__ __device__ constexpr int rank_parts(int R) { return R / rank_chunk(R); }

// the expand's depth: the rank, at least one k8 step (ranks past r are 0)
__host__ __device__ constexpr int expand_depth(int R) { return R < 8 ? 8 : R; }
// ranks of one expand stage
__host__ __device__ constexpr int expand_chunk(int R) { return rank_chunk(expand_depth(R)); }

// dynamic shared memory of the tiled kernel: the cp.async ring (reused by
// the expand's h rows [TM][EK + 4] and B tile [EK][WS_LD], EK ranks a
// stage), then with the base term the tile's running f32 sums (TM x TN)
// the expand's f32 h rows, then its B tile of element type E
template <class E, int EK>
constexpr size_t expand_bytes() {
  return sizeof(float) * (size_t)TM * (EK + 4) + sizeof(E) * (size_t)EK * Tiled<E>::WS_LD;
}
static_assert(expand_bytes<float, RANK_CHUNK>() <= Tiled<float>::RING_BYTES &&
                  expand_bytes<bf16, RANK_CHUNK>() <= Tiled<bf16>::RING_BYTES,
              "the expand's tiles fit in the ring it reuses");

template <class E, int R, bool HAS_BASE>
size_t tiled_smem_bytes() {
  return HAS_BASE ? Tiled<E>::RING_BYTES + sizeof(float) * (size_t)TM * TN
                  : expand_bytes<E, expand_chunk(R)>();
}

// How the tiled path splits d_in to fill the card where the rows alone do
// not (the engine's prefill buckets run M = 8 x 8 .. 8 x 256 rows): the
// shrink into ``shrink`` parts, for two blocks per SM; with the base term,
// the product into ``base`` parts of ``kper`` k slices (at least FLUSH
// each), for one wave of output tiles. Partials are added in a fixed order.
struct TiledSplit {
  int shrink, base, kper;
};

TiledSplit tiled_split(int M, int d_in, int d_out, bool has_base) {
  const int sms = sm_count();
  const int KT = (d_in + TK - 1) / TK;
  // v in [1, min(hi, MAX_SPLIT)]
  auto clamp = [](int v, int hi) {
    hi = hi < MAX_SPLIT ? hi : MAX_SPLIT;
    return v > hi ? (hi > 1 ? hi : 1) : (v < 1 ? 1 : v);
  };
  const int row_blocks = (M + SH_ROWS - 1) / SH_ROWS;
  TiledSplit sp{clamp((2 * sms + row_blocks - 1) / row_blocks, KT), 1, KT};
  if (has_base) {
    const int tiles = ((M + TM - 1) / TM) * ((d_out + TN - 1) / TN);
    sp.base = clamp(sms / tiles, KT / FLUSH);
    sp.kper = (KT + sp.base - 1) / sp.base;
    sp.base = (KT + sp.kper - 1) / sp.kper;  // no empty part
  }
  return sp;
}

// Tiled path, pass 1: hpart[z][m, :] = scale·x[m, k part z]·A[id] for
// SH_ROWS rows of batch row blockIdx.x, part z = blockIdx.z / RP of
// gridDim.z / RP, ranks RC·(blockIdx.z % RP) .. + RC − 1 (rows of id < 0
// get zeros, A unread). The split fills the card where the rows alone
// would not (32 blocks at M = 2048); the tiled kernel adds the partials in
// a fixed order. Thread (rg, rc) owns rank rc of the block's ranks for rows
// rg, rg + THREADS/RC, ...; x and the k slice of A[id] come through a
// two-stage cp.async ring, and each sum runs in k order. A rank r < R
// stages A with 4-byte copies, ranks past r zero-filled.
template <class E, int R, bool EXACT, bool V4>
__global__ void __launch_bounds__(THREADS) lora_shrink_rows_kernel(
    const E* __restrict__ x, const E* __restrict__ lora_a,
    const int* __restrict__ ids, float* __restrict__ hpart, int M, int S,
    int d_in, int r_arg, float scale) {
  constexpr int RC = rank_chunk(R), RP = rank_parts(R);
  const int r_in = EXACT ? R : r_arg;
  constexpr int RG = THREADS / RC;   // row groups
  constexpr int RPT = SH_ROWS / RG;  // rows per thread
  __shared__ __align__(16) E xs[2][SH_ROWS][XS_LD];
  __shared__ __align__(16) E as[2][TK][RC];
  const int tid = threadIdx.x;
  const int b = blockIdx.x, s0 = blockIdx.y * SH_ROWS;
  const int zpart = blockIdx.z / RP, rk0 = blockIdx.z % RP * RC;  // d_in part, first rank
  const int rows = min(SH_ROWS, S - s0);
  const size_t m0 = (size_t)b * S + s0;
  const int id = ids[b];
  float* hb = hpart + ((size_t)zpart * M + m0) * R + rk0;
  if (id < 0) {  // uniform over the block
    for (int e = tid; e < rows * RC; e += THREADS) hb[e / RC * R + e % RC] = 0.f;
    return;
  }
  const E* xb = x + m0 * d_in;
  const E* ab = lora_a + (size_t)id * d_in * r_in;
  auto load_slice = [&](int kt, int st) {
    const int k0 = kt * TK;
    if constexpr (V4) {
      for (int c = tid; c < SH_ROWS * TK / 4; c += THREADS) {
        const int row = c / (TK / 4), kc = c % (TK / 4) * 4;
        const bool ok = row < rows && k0 + kc < d_in;
        cp_chunk(&xs[st][row][kc], ok ? xb + (size_t)row * d_in + k0 + kc : x, ok);
      }
    } else {
      for (int c = tid; c < SH_ROWS * TK; c += THREADS) {
        const int row = c / TK, kc = c % TK;
        const bool ok = row < rows && k0 + kc < d_in;
        copy1(&xs[st][row][kc], ok ? xb + (size_t)row * d_in + k0 + kc : x, ok);
      }
    }
    // TK rows of A[id], the block's RC ranks of each
    if (r_in == R) {  // 16-byte copies (R % 4 == 0)
      for (int c = tid; c < TK * RC / 4; c += THREADS) {
        const int kk = c / (RC / 4), rc = c % (RC / 4) * 4;
        const bool ok = k0 + kk < d_in;
        cp_chunk(&as[st][kk][rc], ok ? ab + (size_t)(k0 + kk) * R + rk0 + rc : lora_a, ok);
      }
    } else {
      for (int c = tid; c < TK * RC; c += THREADS) {
        const int kk = c / RC, rc = c % RC;
        const bool ok = k0 + kk < d_in && rk0 + rc < r_in;
        copy1(&as[st][kk][rc], ok ? ab + (size_t)(k0 + kk) * r_in + rk0 + rc : lora_a, ok);
      }
    }
    cp_async_commit();
  };

  const int r = tid % RC, rg = tid / RC;
  float acc[RPT] = {};
  const int parts = gridDim.z / RP;
  const int per = ((d_in + TK - 1) / TK + parts - 1) / parts;  // k slices per part
  const int KT0 = zpart * per;
  const int KT = min(KT0 + per, (d_in + TK - 1) / TK);
  if (KT0 < KT) load_slice(KT0, 0);
  for (int kt = KT0; kt < KT; ++kt) {
    const int st = (kt - KT0) & 1;
    if (kt + 1 < KT) {
      load_slice(kt + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      const float a0 = to_f(as[st][kk][r]), a1 = to_f(as[st][kk + 1][r]);
      const float a2 = to_f(as[st][kk + 2][r]), a3 = to_f(as[st][kk + 3][r]);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 xv = load4f(&xs[st][rg + j * RG][kk]);
        acc[j] = fmaf(xv.x, a0, acc[j]);
        acc[j] = fmaf(xv.y, a1, acc[j]);
        acc[j] = fmaf(xv.z, a2, acc[j]);
        acc[j] = fmaf(xv.w, a3, acc[j]);
      }
    }
    __syncthreads();  // stage st is free for slice kt + 2
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = rg + j * RG;
    if (row < rows) hb[row * R + r] = scale * acc[j];
  }
}

// The tiled kernel's epilogue: acc (+ the running base sums) to out
template <bool HAS_BASE, class O>
__device__ __forceinline__ void tiled_store(const float (&acc)[MT][NT][4], const float4* total,
                                            O* out, int m0, int n0, int wm, int wn, int M,
                                            int d_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  const bool pairs = (d_out & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm + mt * 16 + g + 8 * hh;
      if (m >= M) continue;
      O* yr = out + (size_t)m * d_out;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if constexpr (HAS_BASE) {
          const float4 b = total[(mt * NT + nt) * THREADS];
          v0 += hh ? b.z : b.x;
          v1 += hh ? b.w : b.y;
        }
        if (pairs && n < d_out) {
          store2(yr + n, v0, v1);
        } else {
          if (n < d_out) store1(yr + n, v0);
          if (n + 1 < d_out) store1(yr + n + 1, v1);
        }
      }
    }
}

// Tiled path, pass 2: the TM x TN output tile at (blockIdx.y, blockIdx.x),
// y = x·W (HAS_BASE) + h·B[id] per row, on the tensor cores in 3xTF32,
// with h the sum of ``hsplit`` shrink partials. With gridDim.z > 1 block z
// takes k slices [z·kper, (z + 1)·kper) of the base product and writes its
// partial tile to part[z] (M x d_out), z = 0 with the expand, for
// sum_parts_kernel to add; otherwise it writes y. V4: d_in and d_out are
// multiples of 4, so every 16-byte chunk of x, W and B lies wholly inside
// or outside its matrix.
template <class E, int R, bool EXACT, bool HAS_BASE, bool V4>
__global__ void __launch_bounds__(THREADS) fused_sgmv_tiled_kernel(
    const E* __restrict__ x, const E* __restrict__ w,
    const E* __restrict__ lora_b, const int* __restrict__ ids,
    const float* __restrict__ h, int hsplit, float* __restrict__ part, int kper,
    E* __restrict__ y, int M, int S, int d_in, int d_out, int r_arg) {
  using L = Tiled<E>;  // row pitches and stage size of E
  const int r_in = EXACT ? R : r_arg;
  constexpr int RK = expand_depth(R);
  constexpr int EK = expand_chunk(R);  // ranks of an expand stage
  constexpr int HS_LD = EK + 4;  // fragment (g, t) -> bank (g·HS_LD + t) % 32, all distinct
  extern __shared__ float4 smem4[];
  E* sm = reinterpret_cast<E*>(smem4);  // the ring
  __shared__ int seg_id[TM];    // adapter id of each batch row in the tile
  __shared__ int seg_lead[TM];  // that id is live and new in the tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (TN / WN) * WM, wn = warp % (TN / WN) * WN;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[MT][NT][4] = {};
  // the running sums of the base product, one float4 per (mt, nt) fragment
  // of each thread: acc holds the sum of at most FLUSH k slices
  float4* total =
      reinterpret_cast<float4*>(reinterpret_cast<char*>(smem4) + L::RING_BYTES) + tid;

  if constexpr (HAS_BASE) {
    // stage slice kt of x (TM x TK) and W (TK x TN) into ring slot kt % STAGES
    auto load_slice = [&](int kt) {
      E* xs = sm + (kt % STAGES) * L::STAGE;
      E* ws = xs + L::XS;
      const int k0 = kt * TK;
      if constexpr (V4) {
#pragma unroll
        for (int i = 0; i < TM * TK / 4 / THREADS; ++i) {
          const int c = tid + i * THREADS, row = c / (TK / 4), kc = c % (TK / 4) * 4;
          const bool ok = m0 + row < M && k0 + kc < d_in;
          cp_chunk(xs + row * L::XS_LD + kc,
                   ok ? x + (size_t)(m0 + row) * d_in + k0 + kc : x, ok);
        }
#pragma unroll
        for (int i = 0; i < TK * TN / 4 / THREADS; ++i) {
          const int c = tid + i * THREADS, kk = c / (TN / 4), nc = c % (TN / 4) * 4;
          const bool ok = k0 + kk < d_in && n0 + nc < d_out;
          cp_chunk(ws + kk * L::WS_LD + nc,
                   ok ? w + (size_t)(k0 + kk) * d_out + n0 + nc : w, ok);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < TM * TK / THREADS; ++i) {
          const int c = tid + i * THREADS, row = c / TK, kc = c % TK;
          const bool ok = m0 + row < M && k0 + kc < d_in;
          copy1(xs + row * L::XS_LD + kc,
                ok ? x + (size_t)(m0 + row) * d_in + k0 + kc : x, ok);
        }
#pragma unroll 4
        for (int i = 0; i < TK * TN / THREADS; ++i) {
          const int c = tid + i * THREADS, kk = c / TN, nc = c % TN;
          const bool ok = k0 + kk < d_in && n0 + nc < d_out;
          copy1(ws + kk * L::WS_LD + nc,
                ok ? w + (size_t)(k0 + kk) * d_out + n0 + nc : w, ok);
        }
      }
    };
    const int KT0 = blockIdx.z * kper;
    const int KT = min(KT0 + kper, (d_in + TK - 1) / TK);  // launch: KT0 < KT
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (KT0 + s < KT) load_slice(KT0 + s);
      cp_async_commit();  // empty groups keep the count uniform
    }
    for (int kt = KT0; kt < KT; ++kt) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
      __syncthreads();              // everyone's; and slot (kt - 1) % STAGES is consumed
      if (kt + STAGES - 1 < KT) load_slice(kt + STAGES - 1);
      cp_async_commit();
      const E* xs = sm + (kt % STAGES) * L::STAGE;
      const E* ws = xs + L::XS;
      if constexpr (sizeof(E) == 2) {
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16)
          mma_k16_bf16(acc, xs + wm * L::XS_LD + kk, L::XS_LD, ws + kk * L::WS_LD + wn,
                       L::WS_LD);
      } else {
#pragma unroll
        for (int kk = 0; kk < TK; kk += 8)
          mma_k8_3xtf32<false>(acc, xs + wm * XS_LD + kk, XS_LD, ws + kk * WS_LD + wn,
                               WS_LD, 0u);
      }
      // The tensor cores round their sums toward zero, relative to the
      // accumulator: over all of d_in that bias reaches ~1e-5 of |y| at
      // d_in = 1024. So every FLUSH slices the sum joins the total in a
      // rounded f32 add.
      if ((kt + 1 - KT0) % FLUSH == 0 || kt + 1 == KT) {
#pragma unroll
        for (int i = 0; i < MT * NT; ++i) {
          float(&p)[4] = acc[i / NT][i % NT];
          float4 v = kt + 1 - KT0 > FLUSH ? total[i * THREADS]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
          v.x += p[0];
          v.y += p[1];
          v.z += p[2];
          v.w += p[3];
          total[i * THREADS] = v;
          p[0] = p[1] = p[2] = p[3] = 0.f;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the expand
  }

  // The expand (block z = 0 alone): for each adapter id live in the tile,
  // its rows' h times B[id], into the same accumulator, EK ranks a stage.
  // Rows of id < 0 take no delta.
  if (blockIdx.z == 0) {  // uniform over the block
    const int b0 = m0 / S;
    const int nseg = (min(m0 + TM, M) - 1) / S - b0 + 1;
    if (tid < nseg) seg_id[tid] = ids[b0 + tid];
    __syncthreads();
    if (tid < nseg) {
      const int id = seg_id[tid];
      bool lead = id >= 0;
      for (int p = 0; p < tid && lead; ++p) lead = seg_id[p] != id;
      seg_lead[tid] = lead;
    }
    int rid[MT][2];  // ids of this thread's fragment rows, -1 past M
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + mt * 16 + g + 8 * hh;
        rid[mt][hh] = m < M ? seg_id[m / S - b0] : -1;
      }
    __syncthreads();  // seg_lead

    float* hs = reinterpret_cast<float*>(smem4);  // [TM][HS_LD], f32
    E* bs = reinterpret_cast<E*>(hs + TM * HS_LD);  // [EK][L::WS_LD]
    bool h_staged = false;
    for (int s = 0; s < nseg; ++s) {
      if (!seg_lead[s]) continue;  // uniform over the block
      const int id = seg_id[s];
      // ranks e0 .. e0 + EK − 1; stages past the rank hold only zeros
      for (int e0 = 0; e0 < RK && e0 < r_in; e0 += EK) {
        if (!h_staged || EK < RK) {  // h = the shrink's partials, added in order
          if (h_staged) __syncthreads();  // the previous stage's tiles are consumed
          for (int c = tid; c < TM * EK / 4; c += THREADS) {
            const int row = c / (EK / 4), rc = c % (EK / 4) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m0 + row < M && e0 + rc < R) {
              const float* p = h + (size_t)(m0 + row) * R + e0 + rc;
              v = *reinterpret_cast<const float4*>(p);
              for (int z = 1; z < hsplit; ++z) {
                const float4 u = *reinterpret_cast<const float4*>(p + (size_t)z * M * R);
                v.x += u.x;
                v.y += u.y;
                v.z += u.z;
                v.w += u.w;
              }
            }
            *reinterpret_cast<float4*>(hs + row * HS_LD + rc) = v;
          }
          h_staged = true;
        } else {
          __syncthreads();  // the previous id's B tile is consumed
        }
        const E* bsrc = lora_b + (size_t)id * r_in * d_out;
        if constexpr (V4) {
          for (int c = tid; c < EK * TN / 4; c += THREADS) {
            const int rr = c / (TN / 4), nc = c % (TN / 4) * 4;
            const bool ok = e0 + rr < r_in && n0 + nc < d_out;
            cp_chunk(bs + rr * L::WS_LD + nc,
                     ok ? bsrc + (size_t)(e0 + rr) * d_out + n0 + nc : lora_b, ok);
          }
        } else {
          for (int c = tid; c < EK * TN; c += THREADS) {
            const int rr = c / TN, nc = c % TN;
            const bool ok = e0 + rr < r_in && n0 + nc < d_out;
            copy1(bs + rr * L::WS_LD + nc,
                  ok ? bsrc + (size_t)(e0 + rr) * d_out + n0 + nc : lora_b, ok);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        unsigned keep = 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) keep |= (unsigned)(rid[mt][hh] == id) << (2 * mt + hh);
        if (__any_sync(0xffffffffu, keep != 0u)) {  // a warp with no row of this id skips
          if constexpr (sizeof(E) == 2) {
#pragma unroll
            for (int kk = 0; kk < EK; kk += 8)
              mma_k8_2xtf32<true>(acc, hs + wm * HS_LD + kk, HS_LD, bs + kk * L::WS_LD + wn,
                                  L::WS_LD, keep);
          } else {
#pragma unroll
            for (int kk = 0; kk < EK; kk += 8)
              mma_k8_3xtf32<true>(acc, hs + wm * HS_LD + kk, HS_LD, bs + kk * WS_LD + wn,
                                  WS_LD, keep);
          }
        }
      }
    }
  }

  // the f32 partial tile where d_in is split, else y
  if (gridDim.z > 1)
    tiled_store<HAS_BASE>(acc, total, part + (size_t)blockIdx.z * M * d_out, m0, n0, wm, wn,
                          M, d_out);
  else
    tiled_store<HAS_BASE>(acc, total, y, m0, n0, wm, wn, M, d_out);
}

// Skinny path, pass 1 (see the header). Block x < cols is a W block: rows
// [0, M) times columns [64·x, 64·x + 64) over k split blockIdx.y, written
// to part[split][M][d_out]. Block x >= cols is a shrink block: ranks
// RC·(y % RP) .. + RC − 1 of batch row b = y / RP, y = x − cols. If b is the
// first batch row with its id and the id is live, it writes
// hpart[split][m][those ranks] = x[m, k split]·A[id] for every row m
// carrying that id (unscaled); otherwise it returns. MT: rows the
// registers hold (M <= MT).
template <class E, int R, bool EXACT, int MT>
__global__ void __launch_bounds__(THREADS, MT <= 8 ? 3 : 2) fused_sgmv_skinny_kernel(
    const E* __restrict__ x, const E* __restrict__ w,
    const E* __restrict__ lora_a, const int* __restrict__ ids,
    float* __restrict__ part, float* __restrict__ hpart, int M, int S, int d_in,
    int d_out, int cols, int kper, int r_arg) {
  constexpr int RC = rank_chunk(R), RP = rank_parts(R);
  const int r_in = EXACT ? R : r_arg;
  // the f32 size in either type: the k lanes' f32 partials reuse it
  __shared__ __align__(16) float ring[SK_STAGES * SK_STAGE];
  E* ring_e = reinterpret_cast<E*>(ring);  // the stages, SK_STAGE elements each
  grid_dependents_launch();  // the merge may load B while this grid streams W
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y;
  const bool w_block = (int)blockIdx.x < cols;  // uniform over the block
  int id = -1, rk0 = 0;
  if (!w_block) {
    const int b = (blockIdx.x - cols) / RP;
    rk0 = (blockIdx.x - cols) % RP * RC;
    id = ids[b];
    bool lead = id >= 0;
    for (int p = 0; p < b && lead; ++p) lead = ids[p] != id;
    if (!lead) return;
  }
  const int n0 = blockIdx.x * SK_CN;
  const int KT = (d_in + SK_KS - 1) / SK_KS;
  const int kt0 = split * kper, kt1 = min(kt0 + kper, KT);  // kt0 < kt1
  const E* a_id = lora_a + (size_t)(id < 0 ? 0 : id) * d_in * r_in;

  // stage kt: the panel (W: SK_KS x 64 of the slab; A: SK_KS x RC) and
  // x [M][SK_KS], zero-filled past d_in and d_out
  auto load = [&](int kt, int slot) {
    E* ps = ring_e + slot * SK_STAGE;
    E* xs = ps + SK_PANEL;
    const int k0 = kt * SK_KS;
    if (w_block) {
#pragma unroll
      for (int i = 0; i < SK_PANEL / 4 / THREADS; ++i) {
        const int c = tid + i * THREADS, row = c / (SK_CN / 4), col = c % (SK_CN / 4) * 4;
        const bool ok = k0 + row < d_in && n0 + col < d_out;
        cp_chunk(ps + row * SK_CN + col, ok ? w + (size_t)(k0 + row) * d_out + n0 + col : w, ok);
      }
    } else if (r_in == R) {  // 16-byte copies (R % 4 == 0)
      for (int c = tid; c < SK_KS * RC / 4; c += THREADS) {
        const int kk = c / (RC / 4), rc = c % (RC / 4) * 4;
        const bool ok = k0 + kk < d_in;
        cp_chunk(ps + kk * RC + rc, ok ? a_id + (size_t)(k0 + kk) * R + rk0 + rc : lora_a, ok);
      }
    } else {  // ranks past r zero-filled, never loaded
      for (int c = tid; c < SK_KS * RC; c += THREADS) {
        const int kk = c / RC, rc = c % RC;
        const bool ok = k0 + kk < d_in && rk0 + rc < r_in;
        copy1(ps + kk * RC + rc, ok ? a_id + (size_t)(k0 + kk) * r_in + rk0 + rc : lora_a, ok);
      }
    }
    for (int c = tid; c < M * SK_KS / 4; c += THREADS) {
      const int m = c / (SK_KS / 4), kc = c % (SK_KS / 4) * 4;
      const bool ok = k0 + kc < d_in;
      cp_chunk(xs + m * SK_KS + kc, ok ? x + (size_t)m * d_in + k0 + kc : x, ok);
    }
  };

  // W block: k lane g = 2·warp + lane / 16 owns rows 2g, 2g + 1 of every
  // stage and float4 column q = lane % 16. Shrink block: k lane g = tid / RC
  // owns rows g, g + THREADS / RC, ... and rank r = tid % RC of its ranks.
  const int q = lane & 15, g = 2 * warp + (lane >> 4);
  constexpr int SG = THREADS / RC;
  const int r = tid % RC, sg = tid / RC;
  float4 acc[MT];
  float hacc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    hacc[m] = 0.f;
  }

  // every slot of the ring in flight from the start (a q or o block's
  // whole k range); a slot is refilled once the block has consumed it
#pragma unroll
  for (int s = 0; s < SK_STAGES; ++s) {
    if (kt0 + s < kt1) load(kt0 + s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    if (kt > kt0) {
      __syncthreads();  // the slot of kt - 1 is consumed: refill it
      if (kt - 1 + SK_STAGES < kt1) load(kt - 1 + SK_STAGES, (kt - 1 - kt0) % SK_STAGES);
      cp_async_commit();
    }
    cp_async_wait<SK_STAGES - 1>();  // this thread's copies of stage kt landed
    __syncthreads();                 // everyone's
    const E* ps = ring_e + (kt - kt0) % SK_STAGES * SK_STAGE;
    const E* xs = ps + SK_PANEL;
    if (w_block) {
      const float4 w0 = load4f(ps + (2 * g) * SK_CN + 4 * q);
      const float4 w1 = load4f(ps + (2 * g + 1) * SK_CN + 4 * q);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float2 xv = load2f(xs + m * SK_KS + 2 * g);
          fma4(acc[m], xv.x, w0);
          fma4(acc[m], xv.y, w1);
        }
      }
    } else {
      for (int kk = sg; kk < SK_KS; kk += SG) {
        const float a = to_f(ps[kk * RC + r]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < M) hacc[m] = fmaf(to_f(xs[m * SK_KS + kk]), a, hacc[m]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the k lanes' partials

  if (w_block) {
    float4* red = reinterpret_cast<float4*>(ring);  // [8 warps][MT][16]
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        acc[m].x += __shfl_xor_sync(0xffffffffu, acc[m].x, 16);
        acc[m].y += __shfl_xor_sync(0xffffffffu, acc[m].y, 16);
        acc[m].z += __shfl_xor_sync(0xffffffffu, acc[m].z, 16);
        acc[m].w += __shfl_xor_sync(0xffffffffu, acc[m].w, 16);
        if (lane < 16) red[(warp * MT + m) * 16 + lane] = acc[m];
      }
    }
    __syncthreads();
    for (int e = tid; e < M * 16; e += THREADS) {
      const int m = e / 16, qq = e % 16, n = n0 + 4 * qq;
      if (n >= d_out) continue;
      float4 v = red[m * 16 + qq];
      for (int wp = 1; wp < THREADS / 32; ++wp) {
        const float4 u = red[(wp * MT + m) * 16 + qq];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(part + ((size_t)split * M + m) * d_out + n) = v;
    }
  } else {
    float* red = ring;  // [SG][MT][RC]
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (m < M) red[(sg * MT + m) * RC + r] = hacc[m];
    __syncthreads();
    for (int e = tid; e < M * RC; e += THREADS) {
      const int m = e / RC, rr = e % RC;
      if (ids[m / S] != id) continue;
      float h = red[m * RC + rr];
      for (int k = 1; k < SG; ++k) h += red[(k * MT + m) * RC + rr];
      hpart[((size_t)split * M + m) * R + rk0 + rr] = h;
    }
  }
}

// Skinny path, pass 2: y[m, n .. n+4) = the splits' partials of x·W in
// order (HAS_BASE), plus, where row m's id is live, scale·h[m]·B[id] with
// h[m] the splits' shrink partials in order (0 past the rank r_in: those
// ranks read B's last row, times 0). Without the base term a row of id < 0
// is exact zeros. B is an input, so
// its first rows are loaded before the wait for pass 1; every other load is
// issued before its first use (the loops over splits and ranks are
// unrolled), so the pass costs about two round trips to L2 after pass 1
// ends.
template <class E, int R, bool EXACT, bool HAS_BASE>
__global__ void __launch_bounds__(SK_MERGE_THREADS) fused_sgmv_skinny_merge_kernel(
    const E* __restrict__ lora_b, const int* __restrict__ ids,
    const float* __restrict__ part, const float* __restrict__ hpart,
    E* __restrict__ y, int M, int S, int d_out, int splits, float scale, int r_arg) {
  const int r_in = EXACT ? R : r_arg;
  constexpr int RP = R < 32 ? R : 32;  // rows of B loaded before the wait
  __shared__ float hs[R];
  const int tid = threadIdx.x, m = blockIdx.y;
  const int n = (blockIdx.x * SK_MERGE_THREADS + tid) * 4;
  const bool col = n < d_out;
  const int id = ids[m / S];  // uniform over the block
  const E* bp = lora_b + (size_t)(id < 0 ? 0 : id) * r_in * d_out + n;
  // row rr of B, or a row B has where rr is past the rank: h is 0 there
  auto brow = [&](int rr) { return ldg4f(bp + (size_t)min(rr, r_in - 1) * d_out); };
  float4 bv[RP];
  if (id >= 0 && col) {
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) bv[rr] = brow(rr);
  }
  grid_dependency_wait();  // pass 1's partials are written
  auto merge_h = [&](int rk) {  // h[rk]: the splits' shrink partials in order
    float hp[SK_MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < SK_MAX_SPLITS; ++s)
      hp[s] = s < splits ? hpart[((size_t)s * M + m) * R + rk] : 0.f;
    float h = hp[0];
#pragma unroll
    for (int s = 1; s < SK_MAX_SPLITS; ++s)
      if (s < splits) h += hp[s];
    hs[rk] = scale * h;
  };
  if constexpr (R <= SK_MERGE_THREADS) {
    if (id >= 0 && tid < R) merge_h(tid);
  } else {
    for (int rk = tid; id >= 0 && rk < R; rk += SK_MERGE_THREADS) merge_h(rk);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (HAS_BASE) {
    if (col) {
      float4 pv[SK_MAX_SPLITS];
#pragma unroll
      for (int s = 0; s < SK_MAX_SPLITS; ++s)
        if (s < splits)
          pv[s] = *reinterpret_cast<const float4*>(part + ((size_t)s * M + m) * d_out + n);
      v = pv[0];
#pragma unroll
      for (int s = 1; s < SK_MAX_SPLITS; ++s) {
        if (s < splits) {
          v.x += pv[s].x;
          v.y += pv[s].y;
          v.z += pv[s].z;
          v.w += pv[s].w;
        }
      }
    }
  }
  __syncthreads();  // hs
  if (!col) return;
  if (id >= 0) {
#pragma unroll
    for (int rr = 0; rr < RP; ++rr) fma4(v, hs[rr], bv[rr]);
#pragma unroll
    for (int rr = RP; rr < R; ++rr) fma4(v, hs[rr], brow(rr));
  }
  store4(y + (size_t)m * d_out + n, v);
}

// scratch: the shrink's partials (shrink x M x R), then the base
// product's partial tiles (base x M x d_out) where base > 1
template <class E, int R, bool EXACT, bool HAS_BASE, bool V4>
int launch_tiled(const E* x, const E* w, const E* lora_a,
                 const E* lora_b, const int* ids, E* y, float* scratch,
                 int M, int S, int d_in, int d_out, int r, float scale, cudaStream_t stream) {
  const TiledSplit sp = tiled_split(M, d_in, d_out, HAS_BASE);
  float* part = scratch + (size_t)sp.shrink * M * R;
  const dim3 sgrid(M / S, (S + SH_ROWS - 1) / SH_ROWS, sp.shrink * rank_parts(R));
  lora_shrink_rows_kernel<E, R, EXACT, V4><<<sgrid, THREADS, 0, stream>>>(x, lora_a, ids, scratch, M,
                                                                S, d_in, r, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = tiled_smem_bytes<E, R, HAS_BASE>();
  err = cudaFuncSetAttribute(fused_sgmv_tiled_kernel<E, R, EXACT, HAS_BASE, V4>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d_out + TN - 1) / TN, (M + TM - 1) / TM, sp.base);
  fused_sgmv_tiled_kernel<E, R, EXACT, HAS_BASE, V4><<<grid, THREADS, smem, stream>>>(
      x, w, lora_b, ids, scratch, sp.shrink, part, sp.kper, y, M, S, d_in, d_out, r);
  if (sp.base == 1) return (int)cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)M * d_out;
  const size_t blocks = (n / (V4 ? 4 : 1) + THREADS - 1) / THREADS;
  const int cap = 4 * sm_count();
  sum_parts_kernel<E, V4><<<blocks < (size_t)cap ? (int)blocks : cap, THREADS, 0,
                                    stream>>>(part, y, n, sp.base);
  return (int)cudaGetLastError();
}

// scratch: the shrink's partials (splits x M x R), then with the base term
// the W blocks' partial sums (splits x M x d_out)
template <class E, int R, bool EXACT, int MT, bool HAS_BASE>
int launch_skinny(const E* x, const E* w, const E* lora_a,
                  const E* lora_b, const int* ids, E* y, float* scratch,
                  int M, int S, int d_in, int d_out, int r, float scale, cudaStream_t stream) {
  const SkinnyPlan sp = skinny_plan(M, d_in, d_out, HAS_BASE);
  float* part = scratch + (size_t)sp.splits * M * R;
  const dim3 grid(sp.cols + M / S * rank_parts(R), sp.splits);
  fused_sgmv_skinny_kernel<E, R, EXACT, MT><<<grid, THREADS, 0, stream>>>(
      x, w, lora_a, ids, part, scratch, M, S, d_in, d_out, sp.cols, sp.kper, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int col_blocks = (d_out / 4 + SK_MERGE_THREADS - 1) / SK_MERGE_THREADS;
  err = launch_dependent(fused_sgmv_skinny_merge_kernel<E, R, EXACT, HAS_BASE>, dim3(col_blocks, M),
                         dim3(SK_MERGE_THREADS), 0, stream, lora_b, ids, (const float*)part,
                         (const float*)scratch, y, M, S, d_out, sp.splits, scale, r);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// EXACT: the rank is the compiled R (every config's rank 32, the reduced
// configs' 4), and the kernels index A and B by it at compile time; a rank
// between compiled ones runs with it as a runtime bound
template <class E, int R, bool EXACT, bool HAS_BASE>
int launch(const E* x, const E* w, const E* lora_a,
           const E* lora_b, const int* ids, E* y, float* scratch,
           int M, int S, int d_in, int d_out, int r, float scale, cudaStream_t stream) {
  if (use_skinny(M, d_in, d_out)) {
    if (M <= 8) return launch_skinny<E, R, EXACT, 8, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, stream);
    return launch_skinny<E, R, EXACT, SK_MAX_M, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, stream);
  }
  if (d_in % 4 == 0 && d_out % 4 == 0)
    return launch_tiled<E, R, EXACT, HAS_BASE, true>(x, w, lora_a, lora_b, ids, y, scratch, M,
                                                  S, d_in, d_out, r, scale, stream);
  return launch_tiled<E, R, EXACT, HAS_BASE, false>(x, w, lora_a, lora_b, ids, y, scratch, M, S,
                                                 d_in, d_out, r, scale, stream);
}

template <class E, int R, bool HAS_BASE>
int launch_rank(const E* x, const E* w, const E* lora_a,
                const E* lora_b, const int* ids, E* y, float* scratch,
                int M, int S, int d_in, int d_out, int r, float scale, cudaStream_t stream) {
  if (r == R)
    return launch<E, R, true, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, stream);
  return launch<E, R, false, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, stream);
}

template <class E, bool HAS_BASE>
int dispatch(const E* x, const E* w, const E* lora_a,
             const E* lora_b, const int* ids, E* y, float* scratch,
             int M, int S, int d_in, int d_out, int r, float scale, void* stream) {
  if (M <= 0 || S <= 0 || M % S != 0 || d_in <= 0 || d_out <= 0 || r <= 0 || r > MAX_RANK)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rank_capacity(r)) {
    case 4: return launch_rank<E, 4, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
    case 8: return launch_rank<E, 8, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
    case 16: return launch_rank<E, 16, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
    case 32: return launch_rank<E, 32, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
    case 64: return launch_rank<E, 64, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
    default: return launch_rank<E, 128, HAS_BASE>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r, scale, st);
  }
}

}  // namespace

// Floats of scratch a launch needs for these shapes: on the skinny path
// the k splits' shrink partials and, with the base term, their partial
// sums of x·W; on the tiled path those of its shrink pass and, where d_in
// is split, the partial output tiles. The shrink partials hold the
// compiled rank the rank r runs on.
extern "C" int fused_sgmv_scratch_floats(int M, int d_in, int d_out, int r, int has_base) {
  if (r <= 0 || r > MAX_RANK) return 0;
  const int R = rank_capacity(r);
  if (use_skinny(M, d_in, d_out)) {
    const SkinnyPlan sp = skinny_plan(M, d_in, d_out, has_base != 0);
    return sp.splits * M * (R + (has_base ? d_out : 0));
  }
  const TiledSplit sp = tiled_split(M, d_in, d_out, has_base != 0);
  return sp.shrink * M * R + (sp.base > 1 ? sp.base * M * d_out : 0);
}

extern "C" int fused_sgmv_launch(const float* x, const float* w,
                                 const float* lora_a, const float* lora_b,
                                 const int* ids, float* y, float* scratch,
                                 int M, int S, int d_in, int d_out, int r,
                                 float scale, void* stream) {
  return dispatch<float, true>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r,
                               scale, stream);
}

// The delta alone: y = scale·(x·A[id])·B[id], zeros where id < 0.
extern "C" int sgmv_launch(const float* x, const float* lora_a,
                           const float* lora_b, const int* ids, float* y,
                           float* scratch, int M, int S, int d_in, int d_out,
                           int r, float scale, void* stream) {
  return dispatch<float, false>(x, nullptr, lora_a, lora_b, ids, y, scratch, M, S, d_in,
                                d_out, r, scale, stream);
}

// fused_sgmv_launch on bf16 x, w, A, B and y (f32 scratch).
extern "C" int fused_sgmv_bf16_launch(const bf16* x, const bf16* w, const bf16* lora_a,
                                      const bf16* lora_b, const int* ids, bf16* y,
                                      float* scratch, int M, int S, int d_in, int d_out,
                                      int r, float scale, void* stream) {
  return dispatch<bf16, true>(x, w, lora_a, lora_b, ids, y, scratch, M, S, d_in, d_out, r,
                              scale, stream);
}

// sgmv_launch on bf16 x, A, B and y (f32 scratch).
extern "C" int sgmv_bf16_launch(const bf16* x, const bf16* lora_a, const bf16* lora_b,
                                const int* ids, bf16* y, float* scratch, int M, int S,
                                int d_in, int d_out, int r, float scale, void* stream) {
  return dispatch<bf16, false>(x, nullptr, lora_a, lora_b, ids, y, scratch, M, S, d_in,
                               d_out, r, scale, stream);
}

extern "C" const char* fused_sgmv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
