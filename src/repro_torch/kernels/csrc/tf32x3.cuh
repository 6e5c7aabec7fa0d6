// Helpers shared by the CUDA sources of this directory: cp.async copies
// into shared memory, f32-accurate products on the tensor cores as three
// TF32 products (3xTF32), and programmatic dependent launch.
//
// 3xTF32: an f32 operand a splits into hi = tf32(a) and lo = tf32(a − hi),
// both rounded to nearest, so a = hi + lo + e with |e| <= 2^-22·|a|. The
// product a·b is lo·hi + hi·lo + hi·hi (lo·lo, below 2^-22 of it, is
// dropped), each term exact in f32. The tensor cores add into their
// accumulator rounding toward zero, an error that grows with the number of
// products one accumulator sums: callers bound that number and add the
// accumulators together in rounded f32. tests/test_torch_tf32x3.py and
// tests/test_torch_attn_tf32x3.py emulate the arithmetic on the CPU.
//
// mma.sync.m16n8k8 fragments, with g = lane / 4 and t = lane % 4:
//   A (row-major 16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (col-major 8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C/D (16 x 8):         c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>

namespace {

// 4-byte global -> shared copy that does not stall the thread; where
// ``pred`` is false it reads nothing and writes 0 (cp.async zero-fill)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

// the same for 16 bytes, through L2 only
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
// from zero: cvt.rna.tf32.f32 for finite a, in two integer ops where the
// cvt compiles to four
__device__ __forceinline__ unsigned tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// a = hi + lo, both TF32; a − hi is exact in f32
__device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a·b: one m16n8k8 TF32 product on the tensor cores, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b in 3xTF32 from fragments split by split_tf32
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], const unsigned (&bhi)[2],
                                           const unsigned (&blo)[2]) {
  mma_tf32(d, alo, bhi);  // the small products first
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// One k8 step of a warp's (16·MT) x (8·NT) tile in 3xTF32: ``as`` points at the
// warp's first row and this step's k (row pitch lda), ``bs`` at this
// step's k row and the warp's first column (pitch ldb). Fragments: A
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (t, g), (t + 4, g);
// g = lane / 4, t = lane % 4. With MASKED, fragment row mt·16 + g + 8·hh
// reads as zero unless bit 2·mt + hh of ``keep`` is set. The small
// products go first.
template <bool MASKED, int MT, int NT>
__device__ __forceinline__ void mma_k8_3xtf32(float (&acc)[MT][NT][4], const float* as,
                                              int lda, const float* bs, int ldb,
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
    const float* p = bs + t * ldb + nt * 8 + g;
    unsigned bhi[2], blo[2];
    split_tf32(p[0], bhi[0], blo[0]);
    split_tf32(p[4 * ldb], bhi[1], blo[1]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_tf32(acc[mt][nt], alo[mt], bhi);
      mma_tf32(acc[mt][nt], ahi[mt], blo);
      mma_tf32(acc[mt][nt], ahi[mt], bhi);
    }
  }
}

// Programmatic dependent launch (sm_90). A kernel launched with
// launch_dependent() may be scheduled while the kernel before it on the
// stream drains; it calls grid_dependency_wait() before it reads anything
// that kernel wrote (the wait returns once that grid has finished and its
// writes are visible). The kernel before it calls grid_dependents_launch()
// where its blocks are done, so the dependent's launch overlaps its tail.
// Both stay legal under CUDA graph capture.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The SM count of the first device that asks, read once: the port runs on
// one card per process.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

}  // namespace
