// bf16 helpers shared by the CUDA sources of this directory: element-typed
// loads, stores and cp.async copies (float or __nv_bfloat16), bf16 products
// on the tensor cores with f32 sums, and ldmatrix.
//
// A kernel templated on its element type T stages 4 elements at a time: a
// 16-byte copy in f32, an 8-byte one in bf16. So every index of the f32
// path holds in bf16, and a bf16 row needs only 8-byte alignment (a head
// dim of 20 is a 40-byte row). Conversions go through the __nv_bfloat16
// intrinsics (round to nearest even on the way to bf16; exact on the way
// back).
//
// mma.sync.m16n8k16 bf16 fragments, with g = lane / 4 and t = lane % 4 (each
// register holds two bf16, the lower k in the low half):
//   A (row-major 16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                          a3 (g + 8, 2t+8..)
//   B (col-major 16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C/D (16 x 8, f32):     c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The C layout of one 8-column tile is the A layout of half a k16 step, so
// two neighbouring score tiles feed P·V without a shuffle (FlashAttention-2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

// 8-byte global -> shared copy; where ``pred`` is false it reads nothing
// and writes 0
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 8 : 0));
}

// 4 elements (a chunk): 16 bytes of f32, 8 of bf16
__device__ __forceinline__ void cp_chunk(float* dst, const float* src, bool pred) {
  cp_async16(dst, src, pred);
}
__device__ __forceinline__ void cp_chunk(bf16* dst, const bf16* src, bool pred) {
  cp_async8(dst, src, pred);
}

// one element: cp.async of 4 bytes in f32; cp.async has no 2-byte copy, so
// a bf16 element is a plain load and store (visible after the barrier that
// every consumer of the ring waits at)
__device__ __forceinline__ void copy1(float* dst, const float* src, bool pred) {
  cp_async4(dst, src, pred);
}
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool pred) {
  *dst = pred ? *src : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float to_f(float a) { return a; }
__device__ __forceinline__ float to_f(bf16 a) { return __bfloat162float(a); }

__device__ __forceinline__ float4 load4f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4f(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// the same through the read-only cache (inputs of the whole launch)
__device__ __forceinline__ float4 ldg4f(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4f(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float2 load2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2f(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two bf16 of (lo, hi), rounded to nearest even, as one register
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }

// The tiled paths of fused_sgmv.cu and fused_sgmv_wgmma.cu with d_in split
// over blocks: y = part[0] + part[1] + ... in that order, ``parts`` f32
// partials of n elements each, rounded once to E. V4: n % 4 == 0. Both
// launch blocks of 256 threads.
template <class E, bool V4>
__global__ void __launch_bounds__(256) sum_parts_kernel(const float* __restrict__ part, E* __restrict__ y, size_t n,
                                 int parts) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  if constexpr (V4) {
    const float4* p = reinterpret_cast<const float4*>(part);
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += stride) {
      float4 v = p[i];
      for (int z = 1; z < parts; ++z) {
        const float4 u = p[z * (n / 4) + i];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      store4(y + 4 * i, v);
    }
  } else {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      float v = part[i];
      for (int z = 1; z < parts; ++z) v += part[z * n + i];
      store1(y + i, v);
    }
  }
}

// a = hi + lo + e, hi and lo bf16 (hi rounded to nearest, lo the rounded
// rest), |e| <= 2^-17·|a|: two bf16 products on an f32 operand keep ~16 bits
__device__ __forceinline__ void split_bf16(float a0, float a1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(a0 - hf.x, a1 - hf.y);
}

// d += a·b: one m16n8k16 bf16 product on the tensor cores, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragment of one k16 x n8 tile from a row-major [k][n] tile in
// shared memory (W of x·W, V of P·V): ldmatrix.trans of two 8 x 8
// matrices, keys/rows k0 .. k0 + 7 (b0) and k0 + 8 .. k0 + 15 (b1). Lane l
// (of 0 .. 15; the others repeat them) passes the address of row l of the
// pair: ``row`` = &tile[k0 + l][n0] for l < 8, &tile[k0 + 8 + l - 8][n0]
// after. Each row is 16 bytes, 16-byte aligned.
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&b)[2], const bf16* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(a));
}

// Two such fragments (n0 and n0 + 8) at once: lane l passes the address of
// row l % 8 of matrix l / 8, matrices (k0, n0), (k0 + 8, n0), (k0, n0 + 8),
// (k0 + 8, n0 + 8); b[0..1] is the n0 fragment, b[2..3] the n0 + 8 one.
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&b)[4], const bf16* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(a));
}

// two neighbouring bf16 of shared memory as one register (4-byte aligned)
__device__ __forceinline__ unsigned lds_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// One k16 step of a warp's (16·MT) x (8·NT) tile in bf16 with f32 sums: ``as``
// points at the warp's first row and this step's k of a row-major [m][k]
// tile (pitch lda, even), ``bs`` at this step's k row and the warp's first
// column of a row-major [k][n] tile (pitch ldb, 16-byte rows). NT is even:
// B comes two n8 tiles per ldmatrix.x4.trans.
template <int MT, int NT>
__device__ __forceinline__ void mma_k16_bf16(float (&acc)[MT][NT][4], const bf16* as, int lda,
                                             const bf16* bs, int ldb) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned a[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const bf16* p = as + (mt * 16 + g) * lda + 2 * t;
    a[mt][0] = lds_pair(p);
    a[mt][1] = lds_pair(p + 8 * lda);
    a[mt][2] = lds_pair(p + 8);
    a[mt][3] = lds_pair(p + 8 * lda + 8);
  }
  // lane l: row l % 8 of matrix l / 8 = (k half (l / 8) % 2, n tile l / 16)
  const bf16* brow = bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    unsigned b[4];
    ldsm_x4_trans(b, brow + nt * 8);
    const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(acc[mt][nt], a[mt], b0);
      mma_bf16(acc[mt][nt + 1], a[mt], b1);
    }
  }
}

// One k8 step of mma_k8_3xtf32 (tf32x3.cuh) with an f32 A and a bf16 B:
// B is exact in TF32, so A's hi/lo split alone carries the f32 accuracy,
// two products (lo·B, then hi·B). The expand of fused_sgmv runs its f32 h
// against a bf16 B[id] with it, as the reference upcasts B.
template <bool MASKED, int MT, int NT>
__device__ __forceinline__ void mma_k8_2xtf32(float (&acc)[MT][NT][4], const float* as,
                                              int lda, const bf16* bs, int ldb,
                                              unsigned keep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* p = as + (mt * 16 + g) * lda + t;
    float v[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
    if constexpr (MASKED) {
      if (!((keep >> (2 * mt)) & 1u)) v[0] = v[2] = 0.f;
      if (!((keep >> (2 * mt + 1)) & 1u)) v[1] = v[3] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], ahi[mt][i], alo[mt][i]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const bf16* p = bs + t * ldb + nt * 8 + g;
    const unsigned b[2] = {__float_as_uint(__bfloat162float(p[0])),
                           __float_as_uint(__bfloat162float(p[4 * ldb]))};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_tf32(acc[mt][nt], alo[mt], b);
      mma_tf32(acc[mt][nt], ahi[mt], b);
    }
  }
}

}  // namespace
