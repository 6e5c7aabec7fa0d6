// The bf16 tile loop of flash_prefill.cu on Hopper's warpgroup tensor
// cores (sm_90a): wgmma for both products, K and V tiles brought by TMA.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels flash_prefill and
// flash_prefill_ragged of src/repro/kernels/flash_prefill.py (body
// _flash_ragged_kernel): causal GQA attention over a fresh sequence. The
// f32 path and ragged_extend stay on attention_tc.cuh's mma.sync loop
// (3xTF32): TF32 wgmma reads B from shared memory K-major only, and V in
// P·V is N-major; 16-bit wgmma reads an MN-major B through the
// descriptor's transpose bit, so V is read as it lies.
//
// What bounds it on this card: a row of S tokens does 4·H·D·S(S+1)/2 flops
// on 2·(H + 2·Hkv)·S·D bytes, so past a few dozen tokens the tensor cores
// bound it: 989 TFLOP/s in bf16. P·V takes P as bf16 hi + lo (two
// products: the reference multiplies an f32 P), so the loop issues 1.5x
// the flops of the bound. attention_tc.cuh reached ~150 TFLOP/s of that
// work with mma.sync (8 warps, each issuing its own 16-row products, and a
// wide head's warps each recomputing Q·Kᵀ).
//
// What the design does about it:
// - A block is one q tile of ROWS = 128 query vectors of one (row b, kv
//   head): the vectors v = s·G + h (token s, head h of the group), as in
//   attention_tc.cuh, so any G fits and the G heads share every K/V tile.
//   Three warpgroups: a producer (one thread issues the TMA loads; the
//   warpgroup gives up its registers with setmaxnreg) and two consumers of
//   64 rows each, which run every product as wgmma.mma_async over the
//   whole warpgroup. Blocks go longest first (the q tile is the slowest
//   grid axis, reversed), as in flash_prefill.cu.
// - Q is copied once, 16 bytes a thread (cp.async: a TMA box cannot pack
//   a token's G heads when G does not divide the tile), into the 128-byte
//   swizzle that TMA and wgmma use: d in chunks of 64 (128 bytes), row r's
//   16-byte group j of a chunk at j ^ (r % 8). Rows past the live tokens
//   are zeros.
// - K and V tiles of BK = 64 keys come through a ring of 2 stages, one
//   TMA box of (64 d, 64 keys) per chunk from a 4-D tensor map over
//   (D, S, Hkv, B) with the views' own strides (a (B, S, H, D) tensor
//   transposed to head-major is read in place); completion is counted on a
//   "full" mbarrier per stage, release on an "empty" one. Columns past D
//   and keys past S are the map's out-of-bounds zeros; keys from the q
//   tile's end to S in its last K/V tile (later tokens, or a ragged row's
//   padding) are zeroed in shared memory before P·V, as the reference
//   zeroes V past the valid keys, so no stale V row reaches P·V.
// - S = Q·Kᵀ: wgmma m64n64k16, A = Q and B = K both from shared memory,
//   K-major as they lie, the whole of D in one accumulator chain of fresh
//   scores each tile (D padded to 64·DC with zeros in Q and K, so the
//   chain is unrolled and ptxas keeps the products in flight).
// - The online softmax runs on the accumulator as it lies: a warp holds
//   16 rows, a row's values sit in one quad of lanes (max and sum take 2
//   shuffles). Scores are scaled by log2(e)/√D in f32 and exponentiated
//   with ex2; masked scores are -inf, so their p is exactly 0. The causal
//   mask is applied only on the K/V tiles that reach past the q tile's
//   first token; the loop stops at min(row length, the q tile's last
//   token), which also bounds it by a ragged row's length.
// - P·V: wgmma m64nDPk16 (DP = D rounded up to 64) with A = P from
//   registers: the accumulator's quads are the A fragment's k pairs, so P
//   goes from one to the other without a shuffle; P splits into bf16
//   hi + lo, lo's product first. B = V from shared memory, MN-major (the
//   descriptor's transpose bit). O accumulates across K/V tiles inside
//   wgmma, rescaled by α in f32 before each tile's products.
// - A warpgroup takes one tile at a time (Q·Kᵀ, softmax, P·V); the two
//   warpgroups interleave on the tensor cores on their own. Issuing tile
//   u's Q·Kᵀ with tile u − 1's P·V (FlashAttention-3's intra-warpgroup
//   overlap) keeps P's hi and lo and the next scores live at once: past
//   D = 128 ptxas then spills and serializes the products.
// - Registers (setmaxnreg: 240 a consumer thread, 24 a producer's): a
//   consumer thread holds 64·DP/128 floats of O (128 at D = 256, where
//   ptxas spills 256 bytes), 32 of scores and 32 registers of P's hi and
//   lo. scripts/flash_wgmma_variants.py times the alternatives: 128-key
//   tiles, three stages, a producer warp without setmaxnreg. No warp
//   recomputes Q·Kᵀ at any width.
// - Epilogue: O·(1/l), rounded once to bf16, goes through the warpgroup's
//   own Q rows of shared memory to 16-byte stores; rows of tokens past the
//   live ones are exact zeros; with lse, each live row's m + log(l).
// Sums run in a fixed order: repeat launches give the same bits.
// tests/test_torch_attn_wgmma.py emulates the arithmetic, the tensor
// cores' rounding toward zero included, against the Pallas kernel.
//
// Shapes: bf16, D a multiple of 16 up to 256, q, k and v on 16-byte bases
// with b, h and s strides of whole 16-byte steps. flash_prefill.py's
// bf16_path picks this loop or attention_tc.cuh's before the launch; the C
// entry refuses any other shape.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {
namespace wg {

constexpr int ROWS = 128;       // query vectors of a q tile
constexpr int CONSUMERS = 2;    // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);  // the producer warpgroup first
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // 128·24 + 256·240 <= 65536
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -__builtin_huge_valf();

constexpr int BK = 64;     // keys of a K/V tile
constexpr int STAGES = 2;  // of the K/V ring

// dynamic shared memory: 1024 bytes of alignment slack, Q, the ring, the
// mbarriers (D = 128: 97 KiB; D = 256: 193 KiB)
template <int DC>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)DC * ROWS * 128 + (size_t)STAGES * 2 * DC * BK * 128 + 16 * STAGES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A wgmma shared-memory descriptor of the 128-byte swizzle: start address,
// leading and stride byte offsets. The layout's atom is 8 rows of 128
// bytes. K-major (Q, K): SBO steps 8 rows of M or N, LBO is unused, a k16
// step adds 32 bytes to the start. MN-major (V): LBO steps the next 64 of
// N, SBO the next 8 of K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed group of products has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins registers in place around the products: before wgmma_fence, so no
// write to an accumulator or an A register sinks past it (ptxas would
// serialize the products); after a wait, so no read rises above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait for the phase of parity ``parity`` to complete. A phase that never
// completes (a lost TMA completion) traps after ~2^35 clocks (~20 s), so
// the launch fails rather than hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 < 0) t0 = now;
    else if (now - t0 > (1LL << 35)) __trap();
  }
}

// one TMA box of a 4-D tensor map into shared memory, counted on ``bar``
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16-byte global -> shared copy (shared address), zeros where ``pred`` is false
__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

// ``x`` as the compiler cannot see through: addresses made from it are
// computed where they are used, not hoisted out of the loop into registers
// that would stay live across it
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The products: one wgmma each over the whole warpgroup (64 rows x N),
// f32 sums. The accumulator fragment of a thread (warp w of the group,
// lane = 4g + t): rows 16w + g and 16w + g + 8, columns 8j + 2t and
// 8j + 2t + 1 of each n8 block j: d[4j + 0..3] = (r0, c), (r0, c + 1),
// (r1, c), (r1, c + 1), as the C fragment of mma.sync.m16n8. The A
// fragment from registers (the RS form) is mma.sync.m16n8k16's A per warp:
// a0 (g, k 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..).
// d = A·B (acc 0) or d + A·B (acc 1), m64n64k16; A and B from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A·B, m64n64k16; A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n128k16; A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n192k16; A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n256k16; A from registers, B from shared memory MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One block: q tile ``n_tiles - 1 - blockIdx.x / (B·Hkv)`` of (row b, kv
// head hkv). q and out (B, H, S, D) with element strides qsb, qsh, qss (out
// has q's); K and V through kmap and vmap (4-D: D, S, Hkv, B; boxes of 64 x
// 64 keys); true_lens (B,) or nullptr for S in every row; lse (B, H,
// S) contiguous or nullptr. DC = chunks of 64 of D (D <= 64·DC).
template <int DC>
__global__ void __launch_bounds__(THREADS, 1) flash_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    const bf16* __restrict__ q, const int* __restrict__ true_lens, bf16* __restrict__ out,
    float* __restrict__ lse, int B, int S, int H, int Hkv, int D, int n_tiles, long long qsb,
    long long qsh, long long qss) {
  constexpr int ST = STAGES;
  constexpr uint32_t QC = ROWS * 128;     // bytes of a Q chunk: 128 rows of 64 d
  constexpr uint32_t KC = BK * 128;       // bytes of a K or V chunk: BK keys of 64 d
  constexpr uint32_t STAGE = 2 * DC * KC;  // a stage: K's chunks, then V's
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every chunk starts on one
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t sq = smem_u32(smem), sring = sq + DC * QC;
  const uint32_t full0 = sring + ST * STAGE, empty0 = full0 + 8 * ST;

  const int G = H / Hkv;
  const int tile = n_tiles - 1 - (int)(blockIdx.x / (B * Hkv));
  const int b = (blockIdx.x % (B * Hkv)) / Hkv, hkv = blockIdx.x % Hkv;
  const int v_lo = tile * ROWS;  // the tile's query vectors: tokens [v_lo / G, ..)
  const int n = true_lens ? min(max(true_lens[b], 0), S) : S;
  const int q_hi = min(attn::tile_token_end(v_lo, ROWS, G, S), n);  // live below q_hi
  const long long qbase = b * qsb + (long long)hkv * G * qsh;
  auto qoff = [&](int vec) { return qbase + (vec % G) * qsh + (long long)(vec / G) * qss; };
  const int D8 = D / 8;  // 16-byte groups of a row
  if (v_lo / G >= q_hi) {
    // a q tile past the row's length (or a row of length 0): zeros
    const int v_hi = min(v_lo + ROWS, S * G);
    for (int e = threadIdx.x; e < (v_hi - v_lo) * D8; e += THREADS)
      *reinterpret_cast<uint4*>(out + qoff(v_lo + e / D8) + 8 * (e % D8)) = make_uint4(0, 0, 0, 0);
    return;
  }
  const int nt = (q_hi + BK - 1) / BK;  // K/V tiles: keys [0, q_hi), the q tile's diagonal
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues the loads
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int u = 0; u < nt; ++u) {
        const int st = u % ST;
        if (u >= ST) mbar_wait(empty0 + 8 * st, (u / ST - 1) & 1);  // stage released
        const uint32_t fb = full0 + 8 * st, ks = sring + st * STAGE, vs = ks + DC * KC;
        mbar_expect_tx(fb, STAGE);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          tma_load4(ks + c * KC, &kmap, fb, 64 * c, u * BK, hkv, b);
          tma_load4(vs + c * KC, &vmap, fb, 64 * c, u * BK, hkv, b);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int c = threadIdx.x / 128 - 1;  // consumer warpgroup: tile rows 64c .. 64c + 63
  const int wt = threadIdx.x % 128, warp = wt / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  // this warpgroup's Q rows: row r's group j at chunk j / 8, slot (j % 8) ^ (r % 8);
  // zeros past D, so Q·Kᵀ runs all 4·DC k16 steps (K is zero there too)
  for (int e = wt; e < 64 * DC * 8; e += 128) {
    const int r = 64 * c + e / (DC * 8), j = e % (DC * 8), vec = v_lo + r;
    const bool ok = vec / G < q_hi && j < D8;
    cp_async16_to(sq + (j / 8) * QC + r * 128 + (((j % 8) ^ (r % 8)) << 4),
                  ok ? q + qoff(vec) + 8 * j : q, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();  // the copies are visible to wgmma
  bar_sync(2 + c, 128);

  const int r0 = 64 * c + 16 * warp + g, r1 = r0 + 8;  // this thread's two rows
  const int s0 = (v_lo + r0) / G, s1 = (v_lo + r1) / G;
  const bool live0 = s0 < q_hi, live1 = s1 < q_hi;
  const int s_first = v_lo / G;
  const float sl2 = LOG2E / sqrtf((float)D);  // scores to log2 units: one multiply
  const uint32_t qa = sq + c * 64 * 128;       // A: this warpgroup's 64 rows
  float o[DC * 32];  // 64 x 64·DC of O, DC·8 n8 blocks
#pragma unroll
  for (int i = 0; i < DC * 32; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  for (int u = 0; u < nt; ++u) {
    const uint32_t ks = opaque(sring + (u % ST) * STAGE), vs = ks + DC * KC;
    mbar_wait(full0 + 8 * (u % ST), (u / ST) & 1);  // tile u's K and V have landed
    // In the last tile, keys [q_hi, min(S, tile end)) (later tokens or a
    // ragged row's padding, never attended) are zeroed in V, so no stale V
    // reaches P·V.
    const int z0 = q_hi - u * BK, z1 = min(S - u * BK, BK);
    if (u == nt - 1 && z0 < z1) {
      for (int e = threadIdx.x - 128; e < (z1 - z0) * DC * 8; e += 128 * CONSUMERS) {
        const int r = z0 + e / (8 * DC), cc = (e / 8) % DC;
        *reinterpret_cast<uint4*>(smem + (vs - sq) + cc * KC + r * 128 + 16 * (e % 8)) =
            make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      bar_sync(1, 128 * CONSUMERS);
    }

    // S = Q·Kᵀ over all of D: k16 step kk reads 32 bytes into its chunk.
    // The scores are fresh each tile (the first step ignores them).
    float sc[BK / 2];  // 64 x BK of scores
    const uint32_t q0 = opaque(qa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss(sc, desc(q0 + (kk >> 2) * QC + off, 0, 1024),
               desc(ks + (kk >> 2) * KC + off, 0, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(sc);

    // online softmax: sc[4j + i] is row r0 (i < 2) or r1, key u·BK + 8j +
    // 2·t4 + (i & 1)
    const bool diag = (u + 1) * BK > s_first + 1;  // a key past the tile's first token
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = sc[4 * j + i] * sl2;
        if (diag && u * BK + 8 * j + 2 * t4 + (i & 1) > (i < 2 ? s0 : s1)) x = NEG_INF;
        sc[4 * j + i] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, attn::quad_max(mx0)), mn1 = fmaxf(m1, attn::quad_max(mx1));
    // a row with no key yet keeps max -inf: subtract 0 there (its p are 0)
    const float mu0 = mn0 == NEG_INF ? 0.f : mn0, mu1 = mn1 == NEG_INF ? 0.f : mn1;
    const float al0 = ex2(m0 - mu0), al1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    // P split into bf16 hi + lo as the register form's A fragments: n8
    // block j is half j % 2 of k16 step j / 2
    unsigned ph[BK / 16][4], pl[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(sc[4 * j] - mu0), p1 = ex2(sc[4 * j + 1] - mu0);
      const float p2 = ex2(sc[4 * j + 2] - mu1), p3 = ex2(sc[4 * j + 3] - mu1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      split_bf16(p0, p1, ph[j / 2][2 * (j % 2)], pl[j / 2][2 * (j % 2)]);
      split_bf16(p2, p3, ph[j / 2][2 * (j % 2) + 1], pl[j / 2][2 * (j % 2) + 1]);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < DC * 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }

    // O += P·V: k16 step j reads keys 16j .. 16j + 15 of V, MN-major (LBO:
    // the next 64 of D, SBO: the next 8 keys); lo's product first
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint64_t db = desc(vs + j * 16 * 128, KC, 1024);
      wgmma_rs(o, pl[j], db);
      wgmma_rs(o, ph[j], db);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (u % ST));  // this warp is done with the stage
  }

  // epilogue
  l0 = attn::quad_sum(l0);
  l1 = attn::quad_sum(l1);
  if (lse != nullptr && t4 == 0) {
    if (live0)
      lse[((size_t)b * H + hkv * G + (v_lo + r0) % G) * S + s0] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (live1)
      lse[((size_t)b * H + hkv * G + (v_lo + r1) % G) * S + s1] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
  const float f0 = 1.f / fmaxf(l0, 1e-30f), f1 = 1.f / fmaxf(l1, 1e-30f);
  bar_sync(2 + c, 128);  // every warp of the group is past its last Q·Kᵀ: its Q rows are free
  unsigned char* qrows = smem;
#pragma unroll
  for (int j = 0; j < DC * 8; ++j) {
    const int slot = j % 8, col = 4 * t4;  // bytes into the 16-byte group
    // rows of tokens past the live ones: exact zeros (their sums are never used)
    *reinterpret_cast<unsigned*>(qrows + (j / 8) * QC + r0 * 128 + ((slot ^ (r0 % 8)) << 4) + col) =
        live0 ? pack_bf16(o[4 * j] * f0, o[4 * j + 1] * f0) : 0u;
    *reinterpret_cast<unsigned*>(qrows + (j / 8) * QC + r1 * 128 + ((slot ^ (r1 % 8)) << 4) + col) =
        live1 ? pack_bf16(o[4 * j + 2] * f1, o[4 * j + 3] * f1) : 0u;
  }
  bar_sync(2 + c, 128);
  for (int e = wt; e < 64 * D8; e += 128) {
    const int r = 64 * c + e / D8, j = e % D8, vec = v_lo + r;
    if (vec / G >= S) continue;  // rows past the S·G vectors: dead, never written
    *reinterpret_cast<uint4*>(out + qoff(vec) + 8 * j) = *reinterpret_cast<const uint4*>(
        qrows + (j / 8) * QC + r * 128 + (((j % 8) ^ (r % 8)) << 4));
  }
}

}  // namespace wg
}  // namespace
