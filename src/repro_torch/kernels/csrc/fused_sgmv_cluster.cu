// fused_sgmv at decode (M = B·S <= 16 rows) in bf16, for Hopper (sm_90a):
// y = x·W + scale·(x·A[id])·B[id] in ONE launch on thread-block clusters
// that split d_in.
//
// Replaces, for bf16 launches of at most 16 rows with d_in and d_out
// multiples of 8 and x, W, A and B on 16-byte bases, the Pallas TPU kernel
// fused_sgmv of src/repro/kernels/sgmv.py:115 (body _fused_sgmv_kernel):
// x·W and h = x·A of the bf16 values with f32 sums, h kept in f32, B
// promoted, the sum in f32 and y rounded to bf16 once. Row m carries the
// id of batch row m / S; a negative id keeps x·W bit for bit (nothing is
// added to its row, and the sums of x·W run in the same order whatever
// the ids) and never reads A or B. Every sum runs in a
// fixed order and no float is added atomically: a repeat launch gives the
// same bits. sgmv.py's bf16_path sends it the decode launches whose W has
// at least 2^22 elements (2^21 past 8 rows): below that fused_sgmv.cu's
// skinny loop was faster on the H100 (its fixed costs are smaller), and it
// keeps those, f32 launches and sgmv.
//
// What bounds it on this card: the bytes of W plus the live A and B. At
// llama-7b's q projection (4096 x 4096, 2 rows, rank 32) W is 32 MB: 10 us
// at 3.35 TB/s, against 2·M flops per W element. So the card has to stream
// W at close to its rate from the first microsecond, and the fixed costs
// of a launch (ramp, tail, a second kernel, partial sums through device
// memory, the hand-off of h from the shrink to the expand) are what is left
// to cut. What the design does about each:
//
// - One launch. The grid is (cs, nb + cols) in clusters of cs blocks
//   (cudaLaunchKernelEx with the cluster attribute): cluster y < nb is the
//   shrink of batch row y, cluster nb + c the c-th slab of 128 output
//   columns (256 bytes of each bf16 W row). Block z of a cluster takes k
//   rows [k0(z), k0(z + 1)) of d_in, k0(z) = 8·floor(z·(d_in/8)/cs): split-K
//   inside the cluster, never across clusters.
// - Bytes, not elements. W and x move in 16-byte cp.async copies through a
//   2-stage ring of 64 k rows (17 KB of W a stage, row pitch 272 bytes),
//   every stage in flight from the start (a W block issues the ring's head,
//   reads the ids, then the rest); the products are mma.sync m16n8k16 bf16
//   with f32 sums (x as A, M padded to 16 with zero rows; W's B fragments
//   by ldmatrix.trans from the [k][n] tile as it lies), a warp per 16
//   columns, so each output of the block has one owner and no reduction
//   inside the block.
// - The shrink once per (live adapter, k part). Cluster b < nb works only
//   if batch row b is the first with its id and the id is live; its block z
//   streams x and k part z of A[id] (a contiguous run of (k1 - k0)·r bf16,
//   any rank 1..128) in stages of 128 rows (64 past rank 32): at a rank r %
//   8 == 0 on mma.sync (A[id]'s rows by ldmatrix.trans; two chains of k16
//   steps, even and odd, added), at any other rank in f32 FMA (a thread a
//   (rank, row of that id, k lane), the lanes met by shuffles; a loop over
//   16 rows with all but the id's predicated off cost ~1 us a stage). It
//   stores its part of h for the id's rows in part z of a scratch of cs x
//   M x r 64-bit words, each an f32 and the launch's tag (from %gridid),
//   so a reader knows a part of this launch by the part alone: no counter,
//   no release and no acquire before the read, and nothing to reset
//   after it. (Summing the parts inside the shrink cluster, through
//   distributed shared memory, put ~1 us more before the expand.)
// - No partial sum in device memory. A slab's blocks meet in distributed
//   shared memory: block z owns units [z·U/cs, (z + 1)·U/cs) of the slab's
//   U = M·32 outputs of 4 columns (its rows: its "share"). Once its M x 128
//   f32 partial of x·W is in its shared memory it arrives at the cluster
//   barrier, reads h (below), and only then waits there; then it adds every
//   block's partial of its units, in rank order, and writes y (the merge of
//   paged_attention.cu's split loop), the loads of up to 8 ranks issued
//   together; then a relaxed barrier before exit. (Pushing each partial
//   into its owner's buffer instead, one barrier and no remote loads, was
//   slower: that barrier waits on the stores.)
// - The expand beside the merge, off the tensor cores. A block whose share
//   holds a live row prefetches the share's rows of B[id] into L1 while W
//   streams. Between its arrival and its wait at the cluster barrier it
//   reads the parts of h of its live rows, each again until it carries the
//   launch's tag, sums h = scale·(the k parts in order) into shared memory,
//   and computes each unit's delta: 8 lanes add h[m][k]·B[id][k][n .. n +
//   3] over the ranks k = lane, lane + 8, .. in f32 FMA and meet by a
//   butterfly. The delta joins the unit's merged x·W before y is rounded;
//   a row of id -1 gets nothing added: its y is the merged x·W.
// - No memset, sync or allocation. The wrapper keeps the scratch per device
//   and stream, zeros when made, and a CUDA graph can capture a launch:
//   each replay is a grid of its own, with a tag of its own. No two
//   launches that share a scratch may run at the same time: one would
//   overwrite the other's parts, and that one's readers would wait until
//   the trap below. Launches on one stream run in turn; a launch captured
//   into a graph takes a scratch of its own (sgmv.cluster_h), zeroed by the
//   graph before it at each replay, so a replay on any stream shares none
//   with the launches beside it.
// - No deadlock. Blocks that wait for h's parts wait for blocks of the
//   same grid, so the whole grid is co-resident: the plan takes the largest
//   cluster size (a power of two up to 16, non-portable past 8) that keeps
//   about two W blocks an SM, at least 8 k rows a block and every cluster
//   of the grid inside cudaOccupancyMaxActiveClusters (queried once per
//   cluster size and device), and refuses a shape no size fits. A wait that
//   never ends traps after ~2^34 clocks, so a fault fails the launch rather
//   than hangs it.
//
// tests/test_torch_skinny_cluster.py emulates the decomposition on the CPU;
// sgmv.py's cluster_plan mirrors make_plan; scripts/cluster_variants.py
// times edited copies of this file and records a per-block timeline.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;  // 8 warps, 16 output columns each
constexpr int MAX_M = 16;     // rows a launch takes
constexpr int CN = 128;       // output columns of a slab: 256 bytes of a W row
constexpr int KS = 64;        // k rows of a ring stage
constexpr int STAGES = 2;     // ring depth, all in flight from the start
constexpr int HEAD = 1;       // stages a W block issues before it reads the ids
constexpr int WP = CN + 8;    // W stage row pitch (elements): 272 bytes, ldmatrix rows on distinct banks
constexpr int XP = KS + 8;    // x stage row pitch: 80 bytes, fragment (g, t) on bank 20g + t
constexpr int STAGE = KS * WP + MAX_M * XP;  // elements of a stage: W (or A), then x
constexpr int MAX_R = 128;
constexpr int MAX_CS = 16;    // the largest cluster (non-portable past 8)
constexpr int PP = CN + 8;    // f32 partial row pitch (16-byte aligned)
constexpr int UR = CN / 4;    // output units (4 columns) of a slab row
constexpr int KL = 8;         // lanes of a unit in the expand's sum over ranks
constexpr int MAX_DEVICES = 64;

// after the ring's last stage the ring holds, in a W block, the f32
// partial [MAX_M][PP], scale·h of the share's live rows [MAX_M][MAX_R] and
// the deltas of its units (all M·UR of them at cs = 1)
static_assert(4 * MAX_M * (PP + MAX_R) + 16 * MAX_M * UR <= 2 * STAGES * STAGE, "W epilogue fits");
static_assert(2 * KS * 32 + MAX_M * (2 * KS + 8) <= STAGE, "a shrink stage of 2·KS rows fits a slot at r <= 32");
static_assert(KS * MAX_R + MAX_M * (KS + 8) <= STAGE, "a shrink stage of KS rows fits a slot");

__device__ __forceinline__ void cp16(const void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

// the tag of this launch's parts of h: the grid's temporal identifier
// (%gridid, new at every launch, a graph's replays included), its top bit
// set so that no tag is 0, the scratch's first contents. A tag comes back
// 2^31 grids later: a part stored then, and by no launch since, would pass
// for that launch's.
__device__ __forceinline__ unsigned launch_tag() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%gridid;\n" : "=l"(g));
  return (unsigned)g | 0x80000000u;
}

// h's parts: an f32 and the tag of the launch that stored it, one 64-bit
// word, so a reader that sees the tag sees the value
__device__ __forceinline__ void st_tagged(unsigned long long* p, float v, unsigned tag) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p),
               "l"(((unsigned long long)tag << 32) | __float_as_uint(v))
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_tagged(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// Σ_q p[q·stride], q = 0 .. n - 1 in order, each part read once its shrink
// block has stored it in this launch (``tag``): 8 loads at a time issued
// together, a part loaded again until it is there. A wait that never ends
// traps after ~2^34 clocks, so a fault fails the launch rather than hangs it.
__device__ __forceinline__ float tagged_sum(const unsigned long long* p, size_t stride, int n,
                                            unsigned tag) {
  float v = 0.f;
  const long long c0 = clock64();
  for (int q0 = 0; q0 < n; q0 += 8) {
    unsigned long long t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < n) t[q] = ld_tagged(p + (q0 + q) * stride);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < n) {
        while ((unsigned)(t[q] >> 32) != tag) {
          __nanosleep(32);
          if (clock64() - c0 > (1LL << 34)) __trap();
          t[q] = ld_tagged(p + (q0 + q) * stride);
        }
        const float f = __uint_as_float((unsigned)t[q]);
        v = q0 + q == 0 ? f : v + f;
      }
  }
  return v;
}

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Σ_q *rank_q(p), q = 0 .. cs - 1 in order, over the cluster's shared
// memory: the loads of 8 ranks at a time issued together (one round trip
// each), then added in rank order
template <class T>
__device__ __forceinline__ T rank_sum(cg::cluster_group& cluster, T* p, int cs) {
  T v = T();
#pragma unroll
  for (int q0 = 0; q0 < MAX_CS; q0 += 8) {
    if (q0 >= cs) break;
    T part[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < cs) part[q] = *cluster.map_shared_rank(p, q0 + q);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q0 + q < cs) v = q0 + q == 0 ? part[q] : v + part[q];
  }
  return v;
}

// One block (see the header). x (M, d_in), w (d_in, d_out), lora_a (N,
// d_in, r), lora_b (N, r, d_out), ids (nb), y (M, d_out); h (cs, M, r)
// tagged f32 scratch: the shrink's k parts.
__global__ void __launch_bounds__(THREADS, 3) fused_sgmv_cluster_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ lora_a,
    const bf16* __restrict__ lora_b, const int* __restrict__ ids, bf16* __restrict__ y,
    unsigned long long* __restrict__ h, int M, int S, int d_in, int d_out,
    int r, float scale) {
  __shared__ __align__(16) bf16 ring[STAGES * STAGE];
  __shared__ int s_ids[MAX_M];   // each batch row's id
  __shared__ int s_jrow[MAX_M];  // each batch row's index among the live ids (-1: id < 0)
  __shared__ int s_rows[MAX_M];  // a shrink block's rows of its id
  __shared__ int s_nrows;
  __shared__ unsigned s_lead_mask;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned tag = launch_tag();
  const int cs = gridDim.x, z = blockIdx.x;  // the cluster spans x: z is its rank
  const int nb = M / S;
  const bool w_block = (int)blockIdx.y >= nb;  // uniform over the cluster
  const int n0 = ((int)blockIdx.y - nb) * CN;
  const int K8 = d_in / 8;
  const int k0 = (int)((long long)z * K8 / cs) * 8, k1 = (int)((long long)(z + 1) * K8 / cs) * 8;
  // a stage: W blocks KS rows of W (x after them, pitch XP); shrink blocks
  // KSR rows of A[id] (2·KS where they and x fit a slot: r <= 32), x right
  // after them (pitch KSR + 8)
  const int KSR = w_block || r > 32 ? KS : 2 * KS;
  const int XO = w_block ? KS * WP : KSR * r, XPR = w_block ? XP : KSR + 8;
  const int nst = (k1 - k0 + KSR - 1) / KSR;
  const bf16* a_id = lora_a;  // the shrink's A[id]

  // stage st of the block's k range into ring slot ``slot``: W (KS x 128 of
  // the slab) or the contiguous run of A[id], then x [M][KSR]; zeros past
  // the block's k rows and past d_out
  auto load = [&](int st, int slot) {
    bf16* ws = ring + slot * STAGE;
    bf16* xs = ws + XO;
    const int kb = k0 + st * KSR, kn = min(KSR, k1 - kb);
    if (w_block) {
#pragma unroll
      for (int i = 0; i < KS * (CN / 8) / THREADS; ++i) {
        const int c = tid + i * THREADS, row = c / (CN / 8), q = c % (CN / 8);
        const bool ok = row < kn && n0 + 8 * q < d_out;
        cp16(ws + row * WP + 8 * q, ok ? w + (size_t)(kb + row) * d_out + n0 + 8 * q : w, ok);
      }
    } else {  // and zeros up to the stage's next k16 step (rows kn .. kn + 7)
      const bf16* src = a_id + (size_t)kb * r;
      for (int c = tid; c < (kn + 15) / 16 * 16 * r / 8; c += THREADS)
        cp16(ws + 8 * c, c < kn * r / 8 ? src + 8 * c : lora_a, c < kn * r / 8);
    }
    for (int c = tid; c < M * (KSR / 8); c += THREADS) {
      const int m = c / (KSR / 8), q = c % (KSR / 8);
      const bool ok = 8 * q < kn;
      cp16(xs + m * XPR + 8 * q, ok ? x + (size_t)m * d_in + kb + 8 * q : x, ok);
    }
  };
  auto issue = [&](int s0, int s1) {  // stages [s0, s1) into their slots
    for (int s = s0; s < s1; ++s) {
      if (s < nst) load(s, s);
      cp_async_commit();  // empty groups keep the count uniform
    }
  };
  // warp 0: the ids, which batch rows lead a live id (the first row with
  // it) and each row's index among the live ids
  auto read_ids = [&]() {
    if (warp == 0) {
      const int id = lane < nb ? ids[lane] : -1;
      int first = lane;  // the first batch row with this id
#pragma unroll
      for (int p = MAX_M - 1; p >= 0; --p) {
        const int v = __shfl_sync(0xffffffffu, id, p);
        if (p < lane && v == id) first = p;
      }
      const bool lead = id >= 0 && first == lane;
      const unsigned mask = __ballot_sync(0xffffffffu, lead);
      if (lane < nb) {
        s_ids[lane] = id;
        s_jrow[lane] = id >= 0 ? __popc(mask & ((1u << first) - 1u)) : -1;
      }
      if (lane == 0) s_lead_mask = mask;
    }
    __syncthreads();
  };

  // the ring: stage i in slot i % STAGES, each slot refilled once consumed
  auto stream = [&](auto&& compute) {
    for (int i = 0; i < nst; ++i) {
      if (i > 0) {
        __syncthreads();  // slot of stage i - 1 consumed: refill it
        if (i - 1 + STAGES < nst) load(i - 1 + STAGES, (i - 1) % STAGES);
        cp_async_commit();
      }
      cp_async_wait<STAGES - 1>();  // this thread's copies of stage i landed
      __syncthreads();              // everyone's
      const bf16* ws = ring + (i % STAGES) * STAGE;
      compute(ws, ws + XO, min(KSR, k1 - k0 - i * KSR));
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
  };

  if (!w_block) {
    // ---------------------------------------------------------- the shrink
    const int b = blockIdx.y;
    read_ids();
    if (!((s_lead_mask >> b) & 1u)) return;  // uniform over the cluster
    const int id = s_ids[b];
    a_id = lora_a + (size_t)id * d_in * r;
    // rows of x past M read as zeros (the products take 16 rows)
    for (int e = tid; e < STAGES * (MAX_M - M) * (XPR / 2); e += THREADS) {
      const int st = e / ((MAX_M - M) * (XPR / 2)), rem = e % ((MAX_M - M) * (XPR / 2));
      reinterpret_cast<unsigned*>(ring + st * STAGE + XO + M * XPR)[rem] = 0u;
    }
    issue(0, STAGES);
    if (warp == 0) {  // the rows of this id (visible after the ring's first barrier)
      const bool mine = lane < M && s_ids[lane / S] == id;
      const unsigned mask = __ballot_sync(0xffffffffu, mine);
      if (mine) s_rows[__popc(mask & ((1u << lane) - 1u))] = lane;
      if (lane == 0) s_nrows = __popc(mask);
    }
    // Any other rank: f32 FMA, into block z's part of h ``hz``
    auto shrink_fma = [&](unsigned long long* hz) {
      // With P = RP·NRP <= 256 (RP, NRP: r and the id's nrows rows rounded up
      // to powers of two), thread t is k lane kl = t % KL (KL = min(256 / P,
      // 32): the lanes of a (row, rank) share a warp) of row i and rank rho,
      // (i, rho) = (t / KL / RP, t / KL % RP), adding the stage rows kl, kl +
      // KL, ..; the lanes meet by a butterfly of shuffles. With more rows (16
      // rows of one id at rank 32 or more) thread t takes rank t % RP and rows
      // s, s + RS, .. (s = t / RP, RS = 256 / RP) over every k.
      int RP = 1;
      while (RP < r) RP *= 2;
      const int RS = THREADS / RP;
      constexpr int MAX_Q = MAX_M / 2;  // rows a thread holds: RS >= 2
      float hacc[MAX_Q];
#pragma unroll
      for (int q = 0; q < MAX_Q; ++q) hacc[q] = 0.f;
      int nrows = 0, KL = 1, rho = 0, i = 0, xoff = 0;
      bool wide = false, live = false;
      stream([&](const bf16* as, const bf16* xs, int kn) {
        if (nrows == 0) {  // the rows are known from the first stage's barrier on
          nrows = s_nrows;
          int NRP = 1;
          while (NRP < nrows) NRP *= 2;
          wide = RP * NRP > THREADS;
          if (wide) {
            rho = tid % RP;
            i = tid / RP;  // the first of rows i, i + RS, ..
            live = rho < r;
          } else {
            KL = min(THREADS / (RP * NRP), 32);
            rho = tid / KL % RP;
            i = tid / KL / RP;
            live = tid < KL * RP * NRP && rho < r && i < nrows;
            xoff = live ? s_rows[i] * XPR : 0;
          }
        }
        if (!live) return;
        if (!wide) {
          float acc = hacc[0];
          for (int kk = tid % KL; kk < kn; kk += KL)
            acc = fmaf(__bfloat162float(xs[xoff + kk]), __bfloat162float(as[kk * r + rho]), acc);
          hacc[0] = acc;
        } else {
          for (int kk = 0; kk < kn; ++kk) {
            const float a = __bfloat162float(as[kk * r + rho]);
#pragma unroll
            for (int q = 0; q < MAX_Q; ++q)
              if (i + q * RS < nrows)
                hacc[q] = fmaf(__bfloat162float(xs[s_rows[i + q * RS] * XPR + kk]), a, hacc[q]);
          }
        }
      });
      // the lanes' sums into hz
      if (!wide) {
        float v = hacc[0];
        for (int off = 1; off < KL; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (live && tid % KL == 0) st_tagged(hz + s_rows[i] * r + rho, v, tag);
      } else if (live) {
#pragma unroll
        for (int q = 0; q < MAX_Q; ++q)
          if (i + q * RS < nrows) st_tagged(hz + s_rows[i + q * RS] * r + rho, hacc[q], tag);
      }
    };
    unsigned long long* hz = h + (size_t)z * M * r;  // block z's part of h
    if (r % 8 == 0) {
      // On the tensor cores: x (16 rows, zeros past M) times the stage's A
      // run ([k][r], row pitch r bytes·2 on 16 bytes), m16n8k16 bf16 with
      // f32 sums, one chain over the block's k part; warp w takes the rank
      // tiles w and w + 8 of r / 8
      const int NTR = r / 8;
      float sacc[2][2][4] = {};  // [tile][the even, odd k16 steps of the k part]
      int step = 0;
      stream([&](const bf16* as, const bf16* xs, int kn) {
        for (int k0s = 0; k0s < kn; k0s += 16, ++step) {
          unsigned a[4];
          const bf16* xp = xs + (lane >> 2) * XPR + k0s + 2 * (lane & 3);
          a[0] = lds_pair(xp), a[1] = lds_pair(xp + 8 * XPR);
          a[2] = lds_pair(xp + 8), a[3] = lds_pair(xp + 8 * XPR + 8);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int nt = warp + 8 * u;
            if (nt < NTR) {
              unsigned bb[2];
              ldsm_x2_trans(bb, as + (k0s + (lane & 15)) * r + 8 * nt);
              if (step & 1)
                mma_bf16(sacc[u][1], a, bb);
              else
                mma_bf16(sacc[u][0], a, bb);
            }
          }
        }
      });
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[u][0][e] += sacc[u][1][e];
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int nt = warp + 8 * u;
        if (nt >= NTR) continue;
        if (g < M && s_ids[g / S] == id) {
          st_tagged(hz + g * r + 8 * nt + 2 * tq, sacc[u][0][0], tag);
          st_tagged(hz + g * r + 8 * nt + 2 * tq + 1, sacc[u][0][1], tag);
        }
        if (g + 8 < M && s_ids[(g + 8) / S] == id) {
          st_tagged(hz + (g + 8) * r + 8 * nt + 2 * tq, sacc[u][0][2], tag);
          st_tagged(hz + (g + 8) * r + 8 * nt + 2 * tq + 1, sacc[u][0][3], tag);
        }
      }
    } else {
      shrink_fma(hz);
    }
    return;
  }

  // ------------------------------------------------------------ a W slab
  // rows of x past M read as zeros in every stage (cp.async writes rows < M)
  for (int e = tid; e < STAGES * (MAX_M - M) * (XP / 2); e += THREADS) {
    const int st = e / ((MAX_M - M) * (XP / 2)), rem = e % ((MAX_M - M) * (XP / 2));
    reinterpret_cast<unsigned*>(ring + st * STAGE + KS * WP + M * XP)[rem] = 0u;
  }
  // the ring's head streams while the ids come; the rest of the ring
  // after them, so the shrink's loads, issued once it has the ids, do not
  // queue behind every W block's whole ring
  issue(0, HEAD);
  read_ids();
  // this block's share of the slab's outputs: units [u0, u1) of M·UR, unit
  // u the 4 columns n0 + 4·(u % UR) .. + 3 of row u / UR; its rows m_lo ..
  // m_hi. It reads h only where one of them carries a live id (``mine``).
  const int U = M * UR;
  const int u0 = (int)((long long)z * U / cs), u1 = (int)((long long)(z + 1) * U / cs);
  const int m_lo = u0 / UR, m_hi = (u1 - 1) / UR;
  auto live_row = [&](int m) { return s_jrow[m / S] >= 0; };
  bool mine = false;
  for (int m = m_lo; m <= m_hi; ++m) mine |= live_row(m);
  // the expand's rows of B[id] (the share's columns of each live row) into
  // L1 while W streams: addresses 64 bytes apart, and each run's last
  for (int m = m_lo; m <= m_hi; ++m) {
    const int c0 = 4 * (max(u0, m * UR) - m * UR);
    const int c1 = min(4 * (min(u1, (m + 1) * UR) - m * UR), d_out - n0);
    if (!live_row(m) || c1 <= c0) continue;
    const bf16* bm = lora_b + (size_t)s_ids[m / S] * r * d_out + n0;
    const int nl = (c1 - c0) / 32 + 1;
    for (int e = tid; e < r * nl; e += THREADS)
      prefetch_l1(bm + (size_t)(e / nl) * d_out + min(c0 + 32 * (e % nl), c1 - 1));
  }
  issue(HEAD, STAGES);

  float acc[1][2][4] = {};
  stream([&](const bf16* ws, const bf16* xs, int) {
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) mma_k16_bf16(acc, xs + kk, XP, ws + kk * WP + 16 * warp, WP);
  });

  // the block's partial of the slab: fragment (g, 2tq), (g, 2tq + 1),
  // (g + 8, 2tq), (g + 8, 2tq + 1) of each n8 tile of the warp's 16 columns
  float* part = reinterpret_cast<float*>(ring);  // [MAX_M][PP]
  float* hs = part + MAX_M * PP;                 // [MAX_M][MAX_R]: scale·h of the live rows
  float4* ds = reinterpret_cast<float4*>(hs + MAX_M * MAX_R);  // the deltas of the share's units
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = 16 * warp + 8 * nt + 2 * tq;
    if (g < M) *reinterpret_cast<float2*>(part + g * PP + col) = make_float2(acc[0][nt][0], acc[0][nt][1]);
    if (g + 8 < M)
      *reinterpret_cast<float2*>(part + (g + 8) * PP + col) = make_float2(acc[0][nt][2], acc[0][nt][3]);
  }
  // the partial is out: arrive at the cluster barrier now and wait at it
  // only once h is read, so the two overlap
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (mine) {
    // h = scale·(the shrink's k parts in order) of the share's live rows,
    // each part read once its shrink block has stored it
    const int nm = m_hi - m_lo + 1;
    for (int e = tid; e < nm * r; e += THREADS) {
      const int m = m_lo + e / r, k = e % r;
      if (live_row(m))
        hs[m * MAX_R + k] = scale * tagged_sum(h + (size_t)m * r + k, (size_t)M * r, cs, tag);
    }
    __syncthreads();
    // the delta of each unit of a live row: KL lanes, lane l adding
    // h[m][k]·B[id][k][n .. n + 3] for k = l, l + KL, .. in f32 FMA, met
    // by a butterfly
    for (int ub = u0; ub < u1; ub += THREADS / KL) {
      const int u = ub + tid / KL, l = tid % KL;
      const int m = u / UR, n = n0 + 4 * (u % UR);
      const bool live = u < u1 && n < d_out && live_row(m);
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        const bf16* bm = lora_b + (size_t)s_ids[m / S] * r * d_out + n;
        const float* hm = hs + m * MAX_R;
#pragma unroll 4
        for (int k = l; k < r; k += KL) {
          const float4 b = ldg4f(bm + (size_t)k * d_out);
          const float hk = hm[k];
          d = make_float4(fmaf(hk, b.x, d.x), fmaf(hk, b.y, d.y), fmaf(hk, b.z, d.z),
                          fmaf(hk, b.w, d.w));
        }
      }
#pragma unroll
      for (int off = 1; off < KL; off *= 2)
        d = d + make_float4(__shfl_xor_sync(0xffffffffu, d.x, off), __shfl_xor_sync(0xffffffffu, d.y, off),
                            __shfl_xor_sync(0xffffffffu, d.z, off), __shfl_xor_sync(0xffffffffu, d.w, off));
      if (live && l == 0) ds[u - u0] = d;
    }
    __syncthreads();
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // every partial is out
  // a thread a unit adds the blocks' partials in rank order, then the
  // unit's delta where its row carries a live id, and writes y rounded once
  for (int u = u0 + tid; u < u1; u += THREADS) {
    const int m = u / UR, n = n0 + 4 * (u % UR);
    if (n >= d_out) continue;
    float4 v = rank_sum(cluster, reinterpret_cast<float4*>(part + m * PP + 4 * (u % UR)), cs);
    if (live_row(m)) v = v + ds[u - u0];
    store4(y + (size_t)m * d_out + n, v);
  }
  // no block leaves while another reads its partial (the reads are done
  // when a thread arrives: their sums are stored)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// clusters of ``cs`` blocks of this kernel the current device holds at
// once (cudaOccupancyMaxActiveClusters), queried once per size and device;
// negative: the query failed (its error)
int capacity(int cs) {
  static int cache[MAX_DEVICES][5];
  static bool filled[MAX_DEVICES][5];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  int slot = 0;
  while ((1 << slot) < cs) ++slot;
  if (dev < MAX_DEVICES && filled[dev][slot]) return cache[dev][slot];
  e = cudaFuncSetAttribute(fused_sgmv_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, 1);
  cfg.blockDim = dim3(THREADS);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, fused_sgmv_cluster_kernel, &cfg);
  if (e != cudaSuccess) return -(int)e;
  if (dev < MAX_DEVICES) {
    cache[dev][slot] = n;
    filled[dev][slot] = true;
  }
  return n;
}

// The launch's plan: ``cols`` slabs of 128 columns, ``nb`` shrink clusters
// (one a batch row) and the cluster size ``cs``: the largest power of two
// up to MAX_CS with cols·cs <= 2·sms (about two W blocks an SM), cs·8 <=
// d_in (every block at least one 8-row k step) and cols + nb clusters
// inside the card's capacity at that size (the grid co-resident). cs = 0:
// no size fits (or the query failed: ``cap`` holds its negated error).
struct Plan {
  int cols, nb, cs, cap;
};

Plan make_plan(int M, int S, int d_in, int d_out, int sms) {
  Plan p;
  p.cols = (d_out + CN - 1) / CN;
  p.nb = M / S;
  for (p.cs = MAX_CS; p.cs >= 1; p.cs /= 2) {
    if (p.cs > 1 && (p.cols * p.cs > 2 * sms || 8 * p.cs > d_in)) continue;
    p.cap = capacity(p.cs);
    if (p.cap < 0) {
      p.cs = 0;
      return p;
    }
    if (p.cols + p.nb <= p.cap) return p;
  }
  p.cs = 0;
  return p;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

bool shape_ok(int M, int S, int d_in, int d_out, int r, int sms) {
  return M > 0 && M <= MAX_M && S > 0 && M % S == 0 && d_in > 0 && d_in % 8 == 0 && d_out > 0 &&
         d_out % 8 == 0 && r > 0 && r <= MAX_R && sms > 0;
}

}  // namespace

// Clusters of ``cs`` blocks the card holds at once, or a negated CUDA error.
extern "C" int fused_sgmv_cluster_capacity(int cs) {
  if (cs < 1 || cs > MAX_CS || (cs & (cs - 1)) != 0) return -(int)cudaErrorInvalidValue;
  return capacity(cs);
}

// The plan of a launch (make_plan): out = {cols, nb, cs, capacity at cs}.
extern "C" int fused_sgmv_cluster_plan(int M, int S, int d_in, int d_out, int sms,
                                       long long* out) {
  if (!shape_ok(M, S, d_in, d_out, 1, sms) || out == nullptr) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, S, d_in, d_out, sms);
  if (p.cs == 0) return p.cap < 0 ? -p.cap : (int)cudaErrorCooperativeLaunchTooLarge;
  const long long v[4] = {p.cols, p.nb, p.cs, p.cap};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// fused_sgmv_bf16_launch's function for M <= 16 rows, d_in and d_out
// multiples of 8, x, W, A, B and y on 16-byte bases, ranks 1..128. h: at
// least cs·M·r 64-bit words of scratch (``h_words``; cs the plan's cluster
// size, at most MAX_CS) on 16 bytes, zeros before its first launch, for
// launches of this loop that run one after another, never two at once (a
// launch knows its parts of h by their tag, but a launch running beside it
// would overwrite them: its readers would wait until the trap). Anything
// else returns cudaErrorInvalidValue, a shape whose grid no cluster size
// keeps co-resident cudaErrorCooperativeLaunchTooLarge; nothing is written
// then.
extern "C" int fused_sgmv_cluster_launch(const bf16* x, const bf16* w, const bf16* lora_a,
                                         const bf16* lora_b, const int* ids, bf16* y,
                                         unsigned long long* h, long long h_words, int M, int S,
                                         int d_in, int d_out, int r, int sms, float scale,
                                         void* stream) {
  if (!shape_ok(M, S, d_in, d_out, r, sms) || !aligned16(x) || !aligned16(w) ||
      !aligned16(lora_a) || !aligned16(lora_b) || !aligned16(y) || !aligned16(h) ||
      h_words < (long long)M * r || ids == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, S, d_in, d_out, sms);
  if (p.cs == 0) return p.cap < 0 ? -p.cap : (int)cudaErrorCooperativeLaunchTooLarge;
  if (h_words < (long long)p.cs * M * r) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, p.nb + p.cols);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, fused_sgmv_cluster_kernel, x, w, lora_a, lora_b, ids, y,
                                     h, M, S, d_in, d_out, r, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* fused_sgmv_cluster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
