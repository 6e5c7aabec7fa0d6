// lora_grad: the adapter-indexed part of fused_sgmv's backward pass, for
// Hopper (sm_90a).
//
// The TPU kernel it pairs with (src/repro/kernels/sgmv.py, fused_sgmv:
// y = x·W + scale·(x·A[id])·B[id], one adapter id a batch row, a negative
// id a base-model row) has no backward: the reference trains on its jnp
// backend, where XLA differentiates the gather einsum. Given x (B·S, d_in),
// dy (B·S, d_out), A (N, d_in, r), B (N, r, d_out) and ids (B,), it
// computes, for the rows of a live id only:
//   h = x·A[id],  g = dy·B[id]ᵀ                       (the shrink)
//   dB[n] = scale·Σ_{rows of id n} hᵀ·dy,  dA[n] = scale·Σ_{rows of id n} xᵀ·g
//   dx += scale·g·A[id]ᵀ                               (when dx is given)
// An adapter with no row gets exact zeros. The base parts, dx = dy·Wᵀ
// (written before this launch) and dW = xᵀ·dy, are plain large products
// left to the library, as the reference leaves them to XLA.
//
// What bounds it on this card: 2·B·S·r·(3·d_in + 2·d_out) flops against a
// pass over x, dy and dx (and the adapters), so up to rank ~100 it is bound
// by the bytes. The least it can move is x and dy once and dx twice.
//
// The design: every product on the tensor cores (mma.sync.m16n8k8 in
// 3xTF32, tf32x3.cuh), ranks padded to r8, the next multiple of 8 (the
// mma's n and k; registers and shared memory are sized for 16, 32, 64 or
// 128, but only r8 columns are computed, staged or stored), and at most
// three launches:
// 1. lora_grad_shrink_kernel: one block per (64 tokens of one batch row,
//    h or g, a part of d). The tokens share an id, so A[id] or B[id]
//    streams through a 3-stage cp.async ring beside the tokens' x (dy), 32
//    rows of d a stage, each stage summed in a fresh accumulator joined in
//    f32. One block a tile streams too few bytes at a time to keep the
//    memory busy, so d splits into parts until the tiles give about four
//    blocks an SM; each part goes to scratch, and the last part's block of
//    a tile (an integer counter tells it, and sets it back to zero for the
//    next launch) adds the parts in order into h and g (B·S, r8). Rows of
//    a negative id return at once: nothing reads their h and g.
// 2. lora_grad_outer_kernel: one block per (64 columns of d_in for dA or of
//    d_out for dB, adapter, part of the sequence). It walks the batch rows
//    of its adapter 64 tokens at a time through a 3-stage ring of x and g
//    (dy and h) and adds xᵀ·g (dyᵀ·h) into its 64 x r8 tile, each stage in
//    a fresh accumulator. A dA block also holds A[id]'s 64 rows of its
//    columns and, from the g it has staged, adds scale·g·A[id]ᵀ into those
//    tokens' dx columns: every (live token, d_in column) belongs to exactly
//    one dA block, so dx takes no second pass over g and no atomics.
// 3. lora_grad_sum_kernel: where the sequence splits into parts to fill
//    the card, dA and dB as scale times the sum of the parts, in order.
// So x and dy are read twice, dx once each way, h and g once more. No
// float atomics: every sum runs in a fixed order, so a repeat launch gives
// the same bits.
// Shared memory: k = t and t + 4 of an mma step are rows (or columns) 2t
// and 2t + 1 of the step's eight, the k order inside a step being free. A
// fragment read down the rows (lane (g, t) at rows 2t and 2t + 1, column
// g: A[id] as the shrink's B operand, xᵀ and dyᵀ as the outer A operand, g
// and h as its B operand) hits bank 8t + g in rows of a multiple of 8
// floats plus 4; one read along a row (columns 2t and 2t + 1 of row g: x,
// dy and B[id] in the shrink) is one 8-byte load, whose half-warps hit 16
// distinct bank pairs in rows of a multiple of 32 floats plus 8; the dx
// product's operands, read along rows at columns t and t + 4, hit bank
// 4g + t in rows of a multiple of 8 plus 4. Rows that are not 16-byte
// aligned (d_in, d_out or r not a multiple of 4) are staged with 4-byte
// copies. The splits (the plan) and the scratch come from the wrapper.

#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TM = 64;           // tokens of a shrink tile
constexpr int KC = 32;           // d rows of a shrink stage
constexpr int SHRINK_STAGES = 3;
constexpr int TT = 64;           // tokens of an outer stage
constexpr int TD = 64;           // d_in / d_out columns of an outer block
constexpr int OUTER_STAGES = 3;
constexpr int UP = KC + 8;       // row pitch of a shrink stage's x, dy and B[id]
constexpr int XP = TD + 4;       // row pitch of an outer stage's x or dy

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// How the reductions split: the wrapper's plan (kernels/sgmv.py,
// lora_grad_plan).
struct Plan {
  int r8;                          // rank padded to a multiple of 8
  int ks_h, kper_h, ks_g, kper_g;  // shrink parts of d_in (h) and d_out (g)
  int ms, sper;                    // outer parts of the sequence
};

struct Args {
  const float *x, *dy, *a, *b;
  const int* ids;
  float *h, *g;                // (B·S, r8) each
  float *parts_h, *parts_g;    // (ks, B·S, r8) where the shrink splits d, else NULL
  float *parts_a, *parts_b;    // (ms, N, d_in, r), (ms, N, r, d_out) where ms > 1
  int* counters;  // (2, B, S / 64 tiles), zeros: the shrink's parts that are done
  float *da, *db, *dx;
  int B, S, N, d_in, d_out, r;
  float scale;
  Plan plan;
};

// A stage of the shrink: x or dy [TM][UP], then A[id] [KC][RMAX + 4] (h)
// or B[id] [RMAX][UP] (g)
__host__ __device__ constexpr int shrink_stage_floats(int RMAX) {
  return TM * UP + (KC * (RMAX + 4) > RMAX * UP ? KC * (RMAX + 4) : RMAX * UP);
}

__host__ __device__ constexpr int outer_smem_floats(int RMAX) {
  return OUTER_STAGES * TT * (XP + RMAX + 4) + TD * (RMAX + 4);
}

// Copy 4 floats (a 16-byte chunk where ``aligned``) of a row into shared
// memory; elements at or past ``n`` read as zeros.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n, bool aligned,
                                      const float* any) {
  if (aligned) {
    cp_async16(dst, n >= 4 ? src : any, n >= 4);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async4(dst + j, j < n ? src + j : any, j < n);
  }
}

// h (z < ks_h) or g, a part of d, for tokens [s0, s0 + 64) of batch row
// bi: out[tok][c] = Σ_k U[tok][k]·W[k][c] with U = x, W = A[id] (h) or
// U = dy, W = B[id]ᵀ (g)
template <int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(THREADS) lora_grad_shrink_kernel(Args p) {
  constexpr int NTW = RMAX / 16;  // n-tiles of a warp: the two of a row split r8 / 8
  constexpr int AP = RMAX + 4;    // row pitch of A[id]'s staged rows
  constexpr int STAGE = shrink_stage_floats(RMAX);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ bool last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bi = blockIdx.y, s0 = blockIdx.x * TM;
  const int id = p.ids[bi];
  if (id < 0) return;
  const Plan& pl = p.plan;
  const int r = p.r, r8 = pl.r8;
  const bool is_h = (int)blockIdx.z < pl.ks_h;
  const int part = is_h ? blockIdx.z : blockIdx.z - pl.ks_h;
  const int ks = is_h ? pl.ks_h : pl.ks_g;
  const int d = is_h ? p.d_in : p.d_out, kper = is_h ? pl.kper_h : pl.kper_g;
  const int k_lo = part * kper, k_hi = min(d, k_lo + kper);
  const int n_tok = min(TM, p.S - s0);
  const float* src = (is_h ? p.x : p.dy) + ((size_t)bi * p.S + s0) * d;
  const float* an = p.a + (size_t)id * p.d_in * r;   // (d_in, r)
  const float* bn = p.b + (size_t)id * r * p.d_out;  // (r, d_out)
  const bool r_aligned = r % 4 == 0;

  auto load_stage = [&](int j) {  // d rows k_lo + j·KC ..
    float* us = smem + (j % SHRINK_STAGES) * STAGE;
    float* ws = us + TM * UP;
    const int k0 = k_lo + j * KC;
    for (int e = tid; e < TM * KC / 4; e += THREADS) {
      const int t = e / (KC / 4), k = (e % (KC / 4)) * 4;
      copy4(us + t * UP + k, src + (size_t)t * d + k0 + k, t < n_tok ? k_hi - k0 - k : 0,
            ALIGNED, src);
    }
    if (is_h) {  // ws[k][c] = A[id][k0 + k][c]
      for (int e = tid; e < KC * RMAX / 4; e += THREADS) {
        const int k = e / (RMAX / 4), c = (e % (RMAX / 4)) * 4;
        if (c < r8)
          copy4(ws + k * AP + c, an + (size_t)(k0 + k) * r + c, k0 + k < k_hi ? r - c : 0,
                r_aligned, an);
      }
    } else {  // ws[c][k] = B[id][c][k0 + k]
      for (int e = tid; e < r8 * KC / 4; e += THREADS) {
        const int c = e / (KC / 4), k = (e % (KC / 4)) * 4;
        copy4(ws + c * UP + k, bn + (size_t)c * p.d_out + k0 + k, c < r ? k_hi - k0 - k : 0,
              ALIGNED, bn);
      }
    }
  };
  const int n_stages = cdiv(k_hi - k_lo, KC);
#pragma unroll
  for (int j = 0; j < SHRINK_STAGES - 1; ++j) {
    if (j < n_stages) load_stage(j);
    cp_async_commit();
  }
  const int wm = warp % 4, wn = warp / 4;  // tokens 16·wm, n-tiles NTW·wn ..
  const int nt_hi = min(NTW, r8 / 8 - NTW * wn);  // this warp's n-tiles
  float acc[NTW][4] = {};
  for (int j = 0; j < n_stages; ++j) {
    cp_async_wait<SHRINK_STAGES - 2>();
    __syncthreads();  // stage j landed; every warp is done with stage j − 1
    if (j + SHRINK_STAGES - 1 < n_stages) load_stage(j + SHRINK_STAGES - 1);
    cp_async_commit();
    const float* us = smem + (j % SHRINK_STAGES) * STAGE;
    const float* ws = us + TM * UP;
    float f[NTW][4] = {};
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // A: k = t4 and t4 + 4 are columns 8kk + 2t4 and + 1 of rows g, g + 8
      const float* pa = us + (16 * wm + g) * UP + 8 * kk + 2 * t4;
      const float2 x0 = *reinterpret_cast<const float2*>(pa);
      const float2 x1 = *reinterpret_cast<const float2*>(pa + 8 * UP);
      const float v[4] = {x0.x, x1.x, x0.y, x1.y};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[i], alo[i]);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        if (n >= nt_hi) break;  // uniform over the warp
        const int c = (NTW * wn + n) * 8 + g;
        float b0, b1;
        if (is_h) {  // A[id]'s rows 8kk + 2t4 and + 1 at column c
          const float* pb = ws + (8 * kk + 2 * t4) * AP + c;
          b0 = pb[0], b1 = pb[AP];
        } else {  // B[id]'s row c at columns 8kk + 2t4 and + 1
          const float2 y = *reinterpret_cast<const float2*>(ws + c * UP + 8 * kk + 2 * t4);
          b0 = y.x, b1 = y.y;
        }
        unsigned bhi[2], blo[2];
        split_tf32(b0, bhi[0], blo[0]);
        split_tf32(b1, bhi[1], blo[1]);
        mma_3xtf32(f[n], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += f[n][i];
  }
  cp_async_wait<0>();
  const size_t M = (size_t)p.B * p.S, row0 = (size_t)bi * p.S + s0;
  float* out = (is_h ? p.h : p.g) + row0 * r8;
  float* parts = ks > 1 ? (is_h ? p.parts_h : p.parts_g) + row0 * r8 : nullptr;
  float* dst = ks > 1 ? parts + (size_t)part * M * r8 : out;
#pragma unroll
  for (int n = 0; n < NTW; ++n) {
    if (n >= nt_hi) break;
    const int c = (NTW * wn + n) * 8 + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = 16 * wm + g + 8 * hh;
      if (t < n_tok)
        *reinterpret_cast<float2*>(dst + (size_t)t * r8 + c) =
            make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
  if (ks == 1) return;
  // the last part's block of this tile adds the parts in order
  __threadfence();  // this block's part is visible before the count
  __syncthreads();
  if (tid == 0) {
    int* count = p.counters + ((is_h ? 0 : p.B) + bi) * (int)gridDim.x + (int)blockIdx.x;
    last = atomicAdd(count, 1) == ks - 1;
    if (last) *count = 0;  // every part has counted: zero for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < n_tok * r8 / 4; e += THREADS) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < ks; ++k) {
      const float4 y = __ldcg(reinterpret_cast<const float4*>(parts + k * M * r8) + e);
      s.x += y.x, s.y += y.y, s.z += y.z, s.w += y.w;
    }
    reinterpret_cast<float4*>(out)[e] = s;
  }
}

// One (64-column tile, adapter n, part of the sequence) of dA (blockIdx.x
// below the d_in tiles: acc[col][c] = Σ x[tok][col]·g[tok][c], and dx) or
// dB (acc[col][c] = Σ dy[tok][col]·h[tok][c]) over the tokens of the rows
// of id n in the part.
template <int RMAX, bool ALIGNED>
__global__ void __launch_bounds__(THREADS) lora_grad_outer_kernel(Args p) {
  constexpr int NTW = RMAX / 16, VP = RMAX + 4;
  constexpr int STAGE = TT * (XP + VP);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* As = smem + OUTER_STAGES * STAGE;  // [TD][VP]: A[n]'s rows of the tile (dA)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Plan& pl = p.plan;
  const int r = p.r, r8 = pl.r8;
  const int tiles_in = cdiv(p.d_in, TD);
  const bool is_a = (int)blockIdx.x < tiles_in;
  const int n = blockIdx.y, part = blockIdx.z;
  const int col0 = (is_a ? blockIdx.x : blockIdx.x - tiles_in) * TD;
  const int W = is_a ? p.d_in : p.d_out;  // width of U's rows
  const float* U = is_a ? p.x : p.dy;
  const float* V = is_a ? p.g : p.h;
  const int s_lo = part * pl.sper, s_hi = min(p.S, s_lo + pl.sper);
  const bool do_dx = is_a && p.dx != nullptr;

  auto next_row = [&](int bi) {  // the first row >= bi of id n, or B
    while (bi < p.B && p.ids[bi] != n) ++bi;
    return bi;
  };
  if (do_dx) {  // As[col][c] = A[n][col0 + col][c]
    const float* an = p.a + (size_t)n * p.d_in * r;
    for (int e = tid; e < TD * RMAX / 4; e += THREADS) {
      const int col = e / (RMAX / 4), c = (e % (RMAX / 4)) * 4;
      if (c < r8)
        copy4(As + col * VP + c, an + (size_t)(col0 + col) * r + c,
              col0 + col < p.d_in ? r - c : 0, r % 4 == 0, an);
    }
  }
  int lb = next_row(0), lt = s_lo;  // the next chunk to load: row lb, tokens lt ..
  auto load_chunk = [&](int j) {
    float* us = smem + (j % OUTER_STAGES) * STAGE;
    float* vs = us + TT * XP;
    const int n_tok = min(TT, s_hi - lt);
    const size_t row0 = (size_t)lb * p.S + lt;
    const float* ub = U + row0 * W + col0;
    for (int e = tid; e < TT * TD / 4; e += THREADS) {
      const int t = e / (TD / 4), c = (e % (TD / 4)) * 4;
      copy4(us + t * XP + c, ub + (size_t)t * W + c, t < n_tok ? W - col0 - c : 0, ALIGNED,
            U);
    }
    const float* vb = V + row0 * r8;
    for (int e = tid; e < TT * RMAX / 4; e += THREADS) {
      const int t = e / (RMAX / 4), c = (e % (RMAX / 4)) * 4;
      if (c < r8)
        cp_async16(vs + t * VP + c, t < n_tok ? vb + (size_t)t * r8 + c : V, t < n_tok);
    }
    lt += TT;
    if (lt >= s_hi) {
      lt = s_lo;
      lb = next_row(lb + 1);
    }
  };
#pragma unroll
  for (int j = 0; j < OUTER_STAGES - 1; ++j) {
    if (lb < p.B) load_chunk(j);
    cp_async_commit();  // the first with As
  }

  const int wm = warp % 4, wn = warp / 4;  // acc: columns 16·wm, n-tiles NTW·wn ..
  const int nt_hi = min(NTW, r8 / 8 - NTW * wn);
  const int tg = warp % 4, ch = warp / 4;  // dx: tokens 16·tg, columns 32·ch
  float acc[NTW][4] = {};
  int cb = next_row(0), ct = s_lo;  // the chunk to compute
  for (int j = 0; cb < p.B; ++j) {
    cp_async_wait<OUTER_STAGES - 2>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j − 1
    if (lb < p.B) load_chunk(j + OUTER_STAGES - 1);
    cp_async_commit();
    const float* us = smem + (j % OUTER_STAGES) * STAGE;
    const float* vs = us + TT * XP;
    const int n_tok = min(TT, s_hi - ct);
    // this thread's dx elements of the chunk (tokens 16·tg + g and + 8,
    // columns 32·ch + 8nn + 2t4 and + 1), loaded before the products so
    // their latency hides behind them
    float xo[2][4][2];
    if (do_dx) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = min(16 * tg + g + 8 * hh, n_tok - 1);  // a live row
        const float* row = p.dx + ((size_t)cb * p.S + ct + t) * p.d_in;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2) {
            const int col = col0 + 32 * ch + 8 * nn + 2 * t4 + j2;
            xo[hh][nn][j2] = col < p.d_in ? row[col] : 0.f;
          }
      }
    }
    // acc += Uᵀ·V over the chunk's tokens: k = t4 and t4 + 4 of step kk
    // are tokens 8kk + 2t4 and 8kk + 2t4 + 1
    float f[NTW][4] = {};
#pragma unroll
    for (int kk = 0; kk < TT / 8; ++kk) {
      const float* pa = us + (8 * kk + 2 * t4) * XP + 16 * wm + g;
      const float v[4] = {pa[0], pa[8], pa[XP], pa[XP + 8]};
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[i], alo[i]);
#pragma unroll
      for (int nn = 0; nn < NTW; ++nn) {
        if (nn >= nt_hi) break;  // uniform over the warp
        const float* pb = vs + (8 * kk + 2 * t4) * VP + (NTW * wn + nn) * 8 + g;
        unsigned bhi[2], blo[2];
        split_tf32(pb[0], bhi[0], blo[0]);
        split_tf32(pb[VP], bhi[1], blo[1]);
        mma_3xtf32(f[nn], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int nn = 0; nn < NTW; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nn][i] += f[nn][i];
    if (do_dx) {
      // dx[tok][col] += scale·Σ_c g[tok][c]·A[n][col][c], the sum over r8
      // in a fresh accumulator
      float e[4][4] = {};
      for (int kk = 0; kk < r8 / 8; ++kk) {
        const float* pa = vs + (16 * tg + g) * VP + kk * 8 + t4;
        const float v[4] = {pa[0], pa[8 * VP], pa[4], pa[8 * VP + 4]};
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[i], alo[i]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float* pb = As + (32 * ch + 8 * nn + g) * VP + kk * 8 + t4;
          unsigned bhi[2], blo[2];
          split_tf32(pb[0], bhi[0], blo[0]);
          split_tf32(pb[4], bhi[1], blo[1]);
          mma_3xtf32(e[nn], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = 16 * tg + g + 8 * hh;
        if (t >= n_tok) continue;
        float* row = p.dx + ((size_t)cb * p.S + ct + t) * p.d_in;
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
          for (int j2 = 0; j2 < 2; ++j2) {
            const int col = col0 + 32 * ch + 8 * nn + 2 * t4 + j2;
            if (col < p.d_in) row[col] = xo[hh][nn][j2] + p.scale * e[nn][2 * hh + j2];
          }
        }
      }
    }
    ct += TT;
    if (ct >= s_hi) {
      ct = s_lo;
      cb = next_row(cb + 1);
    }
  }
  cp_async_wait<0>();
  // the tile: scale·acc, or this part's acc for lora_grad_sum_kernel
  const bool direct = pl.ms == 1;
  float* out = is_a ? (direct ? p.da : p.parts_a + (size_t)part * p.N * p.d_in * r)
                    : (direct ? p.db : p.parts_b + (size_t)part * p.N * r * p.d_out);
  const float f = direct ? p.scale : 1.f;
#pragma unroll
  for (int nn = 0; nn < NTW; ++nn) {
    if (nn >= nt_hi) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = col0 + 16 * wm + g + 8 * (i >> 1);
      const int c = (NTW * wn + nn) * 8 + 2 * t4 + (i & 1);
      if (col >= W || c >= r) continue;
      if (is_a)
        out[((size_t)n * p.d_in + col) * r + c] = acc[nn][i] * f;
      else
        out[((size_t)n * r + c) * p.d_out + col] = acc[nn][i] * f;
    }
  }
}

// dA (blockIdx.y 0) and dB (1) as scale times the sum of the parts, in
// part order
__global__ void __launch_bounds__(THREADS) lora_grad_sum_kernel(Args p) {
  const Plan& pl = p.plan;
  const bool is_a = blockIdx.y == 0;
  const size_t n = (size_t)p.N * p.r * (is_a ? p.d_in : p.d_out);
  const float* src = is_a ? p.parts_a : p.parts_b;
  float* dst = is_a ? p.da : p.db;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < pl.ms; ++k) s += src[k * n + i];
    dst[i] = s * p.scale;
  }
}

template <int RMAX, bool ALIGNED>
int launch(const Args& p, cudaStream_t stream) {
  const Plan& pl = p.plan;
  constexpr size_t shrink_smem = sizeof(float) * SHRINK_STAGES * shrink_stage_floats(RMAX);
  constexpr size_t outer_smem = sizeof(float) * outer_smem_floats(RMAX);
  cudaError_t err = cudaFuncSetAttribute(lora_grad_shrink_kernel<RMAX, ALIGNED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shrink_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(lora_grad_outer_kernel<RMAX, ALIGNED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)outer_smem);
  if (err != cudaSuccess) return (int)err;
  lora_grad_shrink_kernel<RMAX, ALIGNED>
      <<<dim3(cdiv(p.S, TM), p.B, pl.ks_h + pl.ks_g), THREADS, shrink_smem, stream>>>(p);
  const int tiles = cdiv(p.d_in, TD) + cdiv(p.d_out, TD);
  lora_grad_outer_kernel<RMAX, ALIGNED>
      <<<dim3(tiles, p.N, pl.ms), THREADS, outer_smem, stream>>>(p);
  if (pl.ms > 1) {
    const size_t n = (size_t)p.N * p.r * (p.d_in > p.d_out ? p.d_in : p.d_out);
    const size_t blocks = (n + THREADS - 1) / THREADS;
    lora_grad_sum_kernel<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), 2), THREADS, 0,
                           stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int RMAX>
int launch_aligned(const Args& p, cudaStream_t stream) {
  return p.d_in % 4 == 0 && p.d_out % 4 == 0 ? launch<RMAX, true>(p, stream)
                                             : launch<RMAX, false>(p, stream);
}

}  // namespace

// x (B·S, d_in), dy (B·S, d_out), a (N, d_in, r), b (N, r, d_out), ids (B,)
// int32; the plan (r8, the shrink's ks_h parts of kper_h rows of d_in and
// ks_g of kper_g of d_out, the outer products' ms parts of sper tokens) and
// the scratch of kernels/sgmv.py's lora_grad_plan: h, g; parts_h, parts_g
// where ks > 1; parts_a, parts_b where ms > 1; counters, 2·B·⌈S / 64⌉
// int32 zeros where a ks > 1 (left zero); da, db are written whole; dx
// (B·S, d_in) is added into, or NULL to skip it. All contiguous, 16-byte
// aligned.
extern "C" int lora_grad_launch(const float* x, const float* dy, const float* a,
                                const float* b, const int* ids, float* h, float* g,
                                float* parts_h, float* parts_g, float* parts_a,
                                float* parts_b, int* counters, float* da, float* db, float* dx,
                                int B, int S, int N, int d_in, int d_out, int r, int r8,
                                int ks_h, int kper_h, int ks_g, int kper_g, int ms, int sper,
                                float scale, void* stream) {
  // a part of a split is a whole number of stages and no part is empty
  auto split_ok = [](int n, int ks, int per, int step, const void* parts) {
    return ks >= 1 && per > 0 && per % step == 0 && (long long)(ks - 1) * per < n &&
           (long long)ks * per >= n && (ks == 1 || parts != nullptr);
  };
  if (B <= 0 || S <= 0 || N <= 0 || d_in <= 0 || d_out <= 0 || r <= 0 || r > 128 ||
      B > 65535 || N > 65535 || r8 % 8 != 0 || r8 < r || r8 >= r + 8 ||
      !split_ok(d_in, ks_h, kper_h, KC, parts_h) || !split_ok(d_out, ks_g, kper_g, KC, parts_g) ||
      !split_ok(S, ms, sper, 1, parts_a) || (ms > 1 && parts_b == nullptr) ||
      (ks_h + ks_g > 2 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args p{x, dy, a, b, ids, h, g, parts_h, parts_g, parts_a, parts_b, counters,
               da, db, dx, B, S, N, d_in, d_out, r, scale,
               Plan{r8, ks_h, kper_h, ks_g, kper_g, ms, sper}};
  const cudaStream_t st = (cudaStream_t)stream;
  if (r <= 16) return launch_aligned<16>(p, st);
  if (r <= 32) return launch_aligned<32>(p, st);
  if (r <= 64) return launch_aligned<64>(p, st);
  return launch_aligned<128>(p, st);
}

extern "C" const char* lora_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
