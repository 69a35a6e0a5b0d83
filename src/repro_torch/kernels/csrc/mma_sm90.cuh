// Warp-level tensor-core helpers shared by the bf16 attention kernels:
// cp.async staging, ldmatrix fragment loads and the bf16 mma.sync
// m16n8k16 product with f32 accumulators, as inline PTX (sm_80 and up;
// built here for sm_90a).
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, qr = lane / 4,
// qc = 2 * (lane % 4)):
//   A 16 x 16 (row): a0 (qr, qc..qc+1), a1 (qr+8, qc..), a2 (qr, qc+8..),
//                    a3 (qr+8, qc+8..)
//   B 16 x 8  (col): b0 (k qc..qc+1, n qr), b1 (k qc+8.., n qr)
//   C 16 x 8  (f32): c0,c1 (qr, qc..qc+1), c2,c3 (qr+8, qc..qc+1)
// so the C fragments of two neighbouring n8 tiles are, rounded to bf16,
// the A fragment of the next product (FlashAttention-2's register reuse).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `full` false writes 16 zero
// bytes and reads nothing (the src-size 0 form).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b on the tensor cores: bf16 inputs, f32 accumulators
__device__ __forceinline__ void bf16_16816(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), `lo` in
// the low half as the fragment layouts want the lower column there
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx: 2 ulp; -inf and large negative x give +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The shared layout of a [rows][D] tile of 16-byte chunks of EPC
// elements (8 for bf16, 4 for f32), laid out so that the 8 row addresses
// of one ldmatrix matrix (or 8 rows read at one chunk) fall in distinct
// banks:
// - when a row's CH chunks come in whole groups of 8, or are one power
//   of two below 8, rows are D elements apart and chunk c of row r sits
//   at chunk c ^ (r & 7) (an XOR swizzle inside each group of 8);
// - otherwise (D 80: 10 chunks in bf16, 20 in f32) the XOR would move a
//   tail chunk past the row, so a row is padded to an odd number of
//   chunks (CH + 1) and not swizzled: 8 rows read at one chunk then
//   start at 8 distinct 16-byte phases of the 128-byte bank line.
template <int D, int EPC = 8>
struct Tile {
  static constexpr int CH = D / EPC;
  static constexpr bool XOR =
      CH % 8 == 0 || (CH < 8 && (CH & (CH - 1)) == 0);
  static constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  static constexpr int STRIDE = (XOR ? CH : (CH | 1)) * EPC;  // a row
};

// Element offset of chunk `c` of row `row` in such a tile.
template <int D, int EPC = 8>
__device__ __forceinline__ int swz(int row, int c) {
  using L = Tile<D, EPC>;
  return row * L::STRIDE + (L::XOR ? c ^ (row & L::MASK) : c) * EPC;
}

// The smallest multiple of both a and b (for the loaders' periods).
__host__ __device__ constexpr int lcm(int a, int b) {
  int x = a, y = b;
  while (y) {
    const int t = x % y;
    x = y;
    y = t;
  }
  return a / x * b;
}

}  // namespace mma
