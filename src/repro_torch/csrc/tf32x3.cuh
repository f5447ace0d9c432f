// Shared pieces of the two fp32 routes (swa_attention.cu, ssd_chunk.cu):
// fp32 products at fp32 accuracy on Hopper's tensor cores by three TF32
// terms, and cp.async staging of row tiles into shared memory.
//
// 3xTF32: x = big + small, big = x truncated to TF32 (the low 13 bits of
// its pattern cleared: 10 explicit significand bits), small = x - big,
// exact in fp32; the tensor core reads small to TF32 in turn, so big +
// small keeps at least 21 of fp32's 24 bits. A product
//   x·y ~ small_x·big_y + big_x·small_y + big_x·big_y
// drops small_x·small_y and the residuals (~2^-21 relative), as CUTLASS's
// OpMultiplyAddFastF32 does. The split is two ALU ops (a mask, a
// subtract); `cvt.rna.tf32` runs on the conversion unit at a quarter of
// the ALU's rate and made a first version of both kernels slower. One TF32
// term alone keeps ~3 decimal digits (tests/test_torch_fp32_routes.py
// shows it missing both routes' bounds).
//
// The products of a k-step go term-major over a row of independent
// accumulator tiles (every tile's small·big, then big·small, then
// big·big), so consecutive mma.sync never wait on each other; the loops
// that issue them carry no run-time branch.
//
// mma.sync m16n8k8 TF32 fragments (lane = 4·g + t, g = lane / 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A C tile feeds the next product as its A operand without a shuffle when
// that product's k index is permuted within each group of 8: logical k = t
// is column 2t and k = t + 4 is column 2t + 1, so a = (c0, c2, c1, c3), and
// the B operand of that product reads its rows 2t and 2t + 1 (b0, b1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x = big + small: big a TF32 pattern, small exact in fp32
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand halves of one k-step: A (4 registers) or B (2), big and small.
struct FragA {
  uint32_t b[4], s[4];
};
struct FragB {
  uint32_t b0, b1, s0, s1;
};

__device__ __forceinline__ FragB frag_b(float x0, float x1) {
  FragB f;
  split(x0, f.b0, f.s0);
  split(x1, f.b1, f.s1);
  return f;
}

// d[off + i] += A·B_i for the M tiles i < M at fp32 accuracy, term-major
// (off is a constant once the caller's loops are unrolled).
template <int M, int N>
__device__ __forceinline__ void mma3_row(float (&d)[N][4], int off,
                                         const FragA& a,
                                         const FragB (&bf)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[off + i], a.s, bf[i].b0, bf[i].b1);
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[off + i], a.b, bf[i].s0, bf[i].s1);
#pragma unroll
  for (int i = 0; i < M; ++i) mma(d[off + i], a.b, bf[i].b0, bf[i].b1);
}

// mma under a warp-uniform predicate: no branch, so a row of them still
// issues back to back.
__device__ __forceinline__ void mma_if(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "@p mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"((int)on));
}

// mma3_row on the tiles off + i that lie in [lo, hi) only.
template <int M, int N>
__device__ __forceinline__ void mma3_row_in(float (&d)[N][4], int off,
                                            int lo, int hi, const FragA& a,
                                            const FragB (&bf)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
    mma_if(d[off + i], a.s, bf[i].b0, bf[i].b1, off + i >= lo && off + i < hi);
#pragma unroll
  for (int i = 0; i < M; ++i)
    mma_if(d[off + i], a.b, bf[i].s0, bf[i].s1, off + i >= lo && off + i < hi);
#pragma unroll
  for (int i = 0; i < M; ++i)
    mma_if(d[off + i], a.b, bf[i].b0, bf[i].b1, off + i >= lo && off + i < hi);
}

__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2,
                                        float x3) {
  FragA f;
  split(x0, f.b[0], f.s[0]);
  split(x1, f.b[1], f.s[1]);
  split(x2, f.b[2], f.s[2]);
  split(x3, f.b[3], f.s[3]);
  return f;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- cp.async staging ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (16, 8 or 4) from src to shared dst, or zero-fills them
// when `valid` is false (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows r in [0, nrows) of a tile: global row r0 + r (element stride
// rstride, `ncols` contiguous elements) into shared row r (pitch elements);
// rows outside [0, rlimit) are zero-filled. `vec` is the copy width in
// bytes that every address allows (16, 8, 4), or the element size when
// none does (then plain loads and stores: only bf16 with an odd head dim or
// stride gets there). Columns at or past ncols are not touched.
template <typename T, int NTHREADS>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* src,
                                           long long rstride, int r0,
                                           int nrows, int rlimit, int ncols,
                                           int vec, int tid) {
  const int per = vec / (int)sizeof(T) > 0 ? vec / (int)sizeof(T) : 1;
  const int cpr = (ncols + per - 1) / per;
  for (int e = tid; e < nrows * cpr; e += NTHREADS) {
    const int r = e / cpr, c = (e - r * cpr) * per, gr = r0 + r;
    const bool ok = gr >= 0 && gr < rlimit;
    T* d = dst + r * pitch + c;
    const T* s = ok ? src + gr * rstride + c : src;
    if (vec >= 4)
      cp_async(d, s, vec, ok);
    else
      *d = ok ? *s : T(0.f);
  }
}

// The widest copy (16, 8, 4 bytes, else the element size) that a base
// address, its byte strides and the bytes of one row all allow.
inline int copy_width(const void* p, const long long* strides, int n,
                      int row_bytes, int elem) {
  unsigned long long a = reinterpret_cast<unsigned long long>(p) |
                         static_cast<unsigned long long>(row_bytes);
  for (int i = 0; i < n; ++i)
    a |= static_cast<unsigned long long>(strides[i] * elem);
  if (a % 16 == 0) return 16;
  if (a % 8 == 0) return 8;
  if (a % 4 == 0) return 4;
  return elem;
}

}  // namespace tf32x3
