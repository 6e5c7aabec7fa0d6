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
// An adapter with no row gets a zero gradient. The base parts, dx = dy·Wᵀ
// (written before this launch) and dW = xᵀ·dy, are plain large products
// left to the library, as the reference leaves them to XLA.
//
// What bounds it on this card: 2·B·S·r·(3·d_in + 2·d_out) flops against a
// pass over x, dy and dx (and the adapters), so at rank 32 it is bound by
// the bytes.
//
// The design (plain f32 FMA on the CUDA cores). Every reduction is split
// over enough blocks to fill the card, each part written to scratch, and
// the parts are added in a fixed order by lora_grad_sum_kernel: no atomics,
// so a repeat launch gives the same bits whatever the ids repeat.
// - lora_grad_shrink_kernel: one block per (64 tokens of one batch row, a
//   part of d_in for h or of d_out for g, up to 8 parts of at least 256);
//   the tokens share an id, so A[id] (or B[id], transposed as it is
//   staged) comes through shared memory 32 rows of d at a time beside the
//   tokens' x (dy); each thread sums a 16-stride share of the 64 x r tile.
//   Rows of a negative id return at once: nothing reads their h and g.
// - lora_grad_outer_kernel: one block per (adapter, 64-wide tile of d_out
//   for dB or of d_in for dA, a part of the sequence: up to 8 parts of at
//   least 128 tokens); it walks the batch rows of that adapter in order,
//   32 tokens at a time, and sums the outer products of its tile in
//   registers.
// - lora_grad_dx_kernel: one block per (64 tokens of one batch row, 64
//   columns of d_in): dx += scale·g·A[id]ᵀ, each element read, added to
//   and written by one thread.
// Ranks 1–128 run padded to 32, 64 or 128 (zeros past r).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads (tx, ty)
constexpr int TOK = 64;       // tokens of a shrink or dx tile
constexpr int KC = 32;        // reduction rows staged at a time
constexpr int TD = 64;        // d_in / d_out columns of an outer or dx tile
constexpr int MAX_PARTS = 8;  // parts of a split reduction, at most
constexpr int MIN_K = 256;    // d rows of a shrink part, at least
constexpr int MIN_TOK = 128;  // tokens of a row in an outer part, at least

// How the reductions split, and where each buffer lies in the scratch.
struct Plan {
  int ks_h, kper_h, ks_g, kper_g;  // shrink parts of d_in (h) and d_out (g)
  int ms, sper;                    // outer parts of the sequence
  size_t h, g, parts_h, parts_g, parts_b, parts_a, total;  // float offsets
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ``n`` split into parts of at least ``least`` (at most MAX_PARTS), each a
// multiple of ``step``: (parts, per)
__host__ __device__ inline void split(int n, int least, int step, int& parts, int& per) {
  parts = n / least < 1 ? 1 : (n / least > MAX_PARTS ? MAX_PARTS : n / least);
  per = cdiv(cdiv(n, parts), step) * step;
  parts = cdiv(n, per);
}

__host__ __device__ inline Plan make_plan(int B, int S, int N, int d_in, int d_out, int r) {
  Plan p;
  const size_t M = (size_t)B * S;
  split(d_in, MIN_K, KC, p.ks_h, p.kper_h);
  split(d_out, MIN_K, KC, p.ks_g, p.kper_g);
  split(S, MIN_TOK, 1, p.ms, p.sper);
  p.h = 0;
  p.g = p.h + M * r;
  p.parts_h = p.g + M * r;
  p.parts_g = p.parts_h + (size_t)p.ks_h * M * r;
  p.parts_b = p.parts_g + (size_t)p.ks_g * M * r;
  p.parts_a = p.parts_b + (size_t)p.ms * N * r * d_out;
  p.total = p.parts_a + (size_t)p.ms * N * d_in * r;
  return p;
}

struct Args {
  const float *x, *dy, *a, *b;
  const int* ids;
  float *scratch, *da, *db, *dx;
  int B, S, N, d_in, d_out, r;
  float scale;
  Plan plan;
};

// A part of h (z < ks_h) or of g of tokens [s0, s0 + 64) of batch row bi,
// into its partial buffer
template <int RP>
__global__ void __launch_bounds__(THREADS) lora_grad_shrink_kernel(Args p) {
  __shared__ float Xs[TOK][KC + 1];
  __shared__ float Ys[KC][RP + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bi = blockIdx.y, s0 = blockIdx.x * TOK;
  const int id = p.ids[bi];
  if (id < 0) return;
  const bool is_h = (int)blockIdx.z < p.plan.ks_h;
  const int part = is_h ? blockIdx.z : blockIdx.z - p.plan.ks_h;
  const int d = is_h ? p.d_in : p.d_out, kper = is_h ? p.plan.kper_h : p.plan.kper_g;
  const int k_lo = part * kper, k_hi = min(d, k_lo + kper);
  const float* src = (is_h ? p.x : p.dy) + ((size_t)bi * p.S + s0) * d;
  const int n_tok = min(TOK, p.S - s0);
  constexpr int NC = RP / 16;
  float acc[4][NC] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < TOK * KC; e += THREADS) {
      const int t = e / KC, k = e % KC;
      Xs[t][k] = (t < n_tok && k0 + k < k_hi) ? src[(size_t)t * d + k0 + k] : 0.f;
    }
    if (is_h) {  // A[id] rows k0 .. k0 + 31: (d_in, r), r contiguous
      const float* an = p.a + (size_t)id * p.d_in * p.r;
      for (int e = threadIdx.x; e < KC * RP; e += THREADS) {
        const int k = e / RP, c = e % RP;
        Ys[k][c] = (k0 + k < k_hi && c < p.r) ? an[(size_t)(k0 + k) * p.r + c] : 0.f;
      }
    } else {  // B[id]ᵀ: B is (r, d_out), read along d_out
      const float* bn = p.b + (size_t)id * p.r * p.d_out;
      for (int e = threadIdx.x; e < KC * RP; e += THREADS) {
        const int c = e / KC, k = e % KC;
        Ys[k][c] = (k0 + k < k_hi && c < p.r) ? bn[(size_t)c * p.d_out + k0 + k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float xv[4], yv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = Xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < NC; ++j) yv[j] = Ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
  }
  const size_t M = (size_t)p.B * p.S;
  float* dst = p.scratch + (is_h ? p.plan.parts_h : p.plan.parts_g) + part * M * p.r +
               ((size_t)bi * p.S + s0) * p.r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= n_tok) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tx + 16 * j;
      if (c < p.r) dst[(size_t)t * p.r + c] = acc[i][j];
    }
  }
}

// dst[i] = scale·Σ_{k < parts} src[k·n + i], the parts in order
__global__ void __launch_bounds__(THREADS) lora_grad_sum_kernel(float* dst, const float* src,
                                                                size_t n, int parts,
                                                                float scale) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float s = 0.f;
    for (int k = 0; k < parts; ++k) s += src[k * n + i];
    dst[i] = s * scale;
  }
}

// A part (tokens [ms·sper, (ms + 1)·sper) of every row of adapter n) of
// Σ U[tok][p]·V[tok][q] for one 64-wide tile of the side that is not r:
// dB (side 0: U = h, V = dy, tile over d_out) or dA (side 1: U = x, V = g,
// tile over d_in), into its partial buffer
template <int RP>
__global__ void __launch_bounds__(THREADS) lora_grad_outer_kernel(Args p) {
  constexpr int TPmax = RP > TD ? RP : TD;
  __shared__ float Us[KC][TPmax + 1];
  __shared__ float Vs[KC][TPmax + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n = blockIdx.y, side = blockIdx.z / p.plan.ms, ms = blockIdx.z % p.plan.ms;
  const int tile0 = blockIdx.x * TD;
  if (tile0 >= (side == 0 ? p.d_out : p.d_in)) return;
  // rows p of the tile (ty + 16i) and columns q (tx + 16j)
  const int TP = side == 0 ? RP : TD, TQ = side == 0 ? TD : RP;
  const int P = side == 0 ? p.r : p.d_in, Q = side == 0 ? p.d_out : p.r;
  const int p0 = side == 0 ? 0 : tile0, q0 = side == 0 ? tile0 : 0;
  const float* U = side == 0 ? p.scratch + p.plan.h : p.x;
  const float* V = side == 0 ? p.dy : p.scratch + p.plan.g;
  const int uw = side == 0 ? p.r : p.d_in, vw = side == 0 ? p.d_out : p.r;  // row widths
  const int s_lo = ms * p.plan.sper, s_hi = min(p.S, s_lo + p.plan.sper);
  constexpr int NI = TPmax / 16;
  float acc[NI][NI] = {};
  const int ni = TP / 16, nj = TQ / 16;
  for (int bi = 0; bi < p.B; ++bi) {
    if (p.ids[bi] != n) continue;  // uniform over the block
    for (int t0 = s_lo; t0 < s_hi; t0 += KC) {
      const int n_tok = min(KC, s_hi - t0);
      const size_t row0 = (size_t)bi * p.S + t0;
      __syncthreads();
      for (int e = threadIdx.x; e < KC * TP; e += THREADS) {
        const int t = e / TP, c = e % TP;
        Us[t][c] = (t < n_tok && p0 + c < P) ? U[(row0 + t) * uw + p0 + c] : 0.f;
      }
      for (int e = threadIdx.x; e < KC * TQ; e += THREADS) {
        const int t = e / TQ, c = e % TQ;
        Vs[t][c] = (t < n_tok && q0 + c < Q) ? V[(row0 + t) * vw + q0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int t = 0; t < n_tok; ++t) {
        float u[NI], v[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          u[i] = i < ni ? Us[t][ty + 16 * i] : 0.f;
          v[i] = i < nj ? Vs[t][tx + 16 * i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i >= ni) break;
#pragma unroll
          for (int j = 0; j < NI; ++j) {
            if (j >= nj) break;
            acc[i][j] = fmaf(u[i], v[j], acc[i][j]);
          }
        }
      }
    }
  }
  float* out = p.scratch + (side == 0 ? p.plan.parts_b : p.plan.parts_a) +
               ((size_t)ms * p.N + n) * P * Q;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int pp = p0 + ty + 16 * i;
    if (i >= ni || pp >= P) continue;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int qq = q0 + tx + 16 * j;
      if (j < nj && qq < Q) out[(size_t)pp * Q + qq] = acc[i][j];
    }
  }
}

// dx[tok][col] += scale·Σ_c g[tok][c]·A[id][col][c] for 64 tokens of batch
// row bi and 64 columns of d_in
__global__ void __launch_bounds__(THREADS) lora_grad_dx_kernel(Args p) {
  __shared__ float Gs[TOK][KC + 1];
  __shared__ float As[TD][KC + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bi = blockIdx.y, s0 = blockIdx.x * TOK, c0 = blockIdx.z * TD;
  const int id = p.ids[bi];
  if (id < 0) return;
  const int n_tok = min(TOK, p.S - s0);
  const float* gr = p.scratch + p.plan.g + ((size_t)bi * p.S + s0) * p.r;
  const float* an = p.a + (size_t)id * p.d_in * p.r;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.r; k0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < TOK * KC; e += THREADS) {
      const int t = e / KC, k = e % KC;
      Gs[t][k] = (t < n_tok && k0 + k < p.r) ? gr[(size_t)t * p.r + k0 + k] : 0.f;
    }
    for (int e = threadIdx.x; e < TD * KC; e += THREADS) {
      const int c = e / KC, k = e % KC;
      As[c][k] = (c0 + c < p.d_in && k0 + k < p.r) ? an[(size_t)(c0 + c) * p.r + k0 + k]
                                                    : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KC; ++k) {
      float gv[4], av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gv[i] = Gs[ty + 16 * i][k];
        av[i] = As[tx + 16 * i][k];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], av[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= n_tok) continue;
    float* row = p.dx + ((size_t)bi * p.S + s0 + t) * p.d_in;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < p.d_in) row[c] += acc[i][j] * p.scale;
    }
  }
}

void sum_parts(float* dst, const float* src, size_t n, int parts, float scale,
               cudaStream_t stream) {
  const size_t blocks = (n + THREADS - 1) / THREADS;
  lora_grad_sum_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), THREADS, 0, stream>>>(
      dst, src, n, parts, scale);
}

template <int RP>
int launch(const Args& p, cudaStream_t stream) {
  const Plan& pl = p.plan;
  const size_t M = (size_t)p.B * p.S;
  const unsigned tok_tiles = (unsigned)cdiv(p.S, TOK);
  lora_grad_shrink_kernel<RP><<<dim3(tok_tiles, p.B, pl.ks_h + pl.ks_g), THREADS, 0,
                                stream>>>(p);
  sum_parts(p.scratch + pl.h, p.scratch + pl.parts_h, M * p.r, pl.ks_h, 1.f, stream);
  sum_parts(p.scratch + pl.g, p.scratch + pl.parts_g, M * p.r, pl.ks_g, 1.f, stream);
  const unsigned tiles = (unsigned)cdiv(p.d_in > p.d_out ? p.d_in : p.d_out, TD);
  lora_grad_outer_kernel<RP><<<dim3(tiles, p.N, 2 * pl.ms), THREADS, 0, stream>>>(p);
  sum_parts(p.db, p.scratch + pl.parts_b, (size_t)p.N * p.r * p.d_out, pl.ms, p.scale,
            stream);
  sum_parts(p.da, p.scratch + pl.parts_a, (size_t)p.N * p.d_in * p.r, pl.ms, p.scale,
            stream);
  if (p.dx != nullptr)
    lora_grad_dx_kernel<<<dim3(tok_tiles, p.B, (unsigned)cdiv(p.d_in, TD)), THREADS, 0,
                          stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch a launch of these shapes needs; -1 past 2^31 − 1.
extern "C" int lora_grad_scratch_floats(int B, int S, int N, int d_in, int d_out, int r) {
  const size_t total = make_plan(B, S, N, d_in, d_out, r).total;
  return total > 0x7fffffffu ? -1 : (int)total;
}

// x (B·S, d_in), dy (B·S, d_out), a (N, d_in, r), b (N, r, d_out), ids (B,)
// int32; scratch of lora_grad_scratch_floats; da, db are written whole; dx
// (B·S, d_in) is added into, or NULL to skip it. All contiguous.
extern "C" int lora_grad_launch(const float* x, const float* dy, const float* a,
                                const float* b, const int* ids, float* scratch, float* da,
                                float* db, float* dx, int B, int S, int N, int d_in,
                                int d_out, int r, float scale, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || d_in <= 0 || d_out <= 0 || r <= 0 || r > 128 ||
      B > 65535 || N > 65535 || cdiv(d_in, TD) > 65535)
    return (int)cudaErrorInvalidValue;
  const Args p{x, dy, a, b, ids, scratch, da, db, dx, B, S, N, d_in, d_out, r, scale,
               make_plan(B, S, N, d_in, d_out, r)};
  const cudaStream_t st = (cudaStream_t)stream;
  if (r <= 32) return launch<32>(p, st);
  if (r <= 64) return launch<64>(p, st);
  return launch<128>(p, st);
}

extern "C" const char* lora_grad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
