// Mamba2 SSD intra-chunk block, on Hopper's tensor cores (sm_90a): the
// bf16 route of `kernels/ssd_chunk.py`.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` (src/repro/kernels/
// ssd_chunk.py:49, body `_kernel` :26) for X, B, C all bf16 with Q = 64 or
// 128 and P = N = 64; every other input goes to ssd_chunk.cu (CUDA cores,
// fp32). Same function, fp32 outputs, for each (batch, chunk, head) with a
// the inclusive cumsum of dt·A over the chunk (fp32, computed outside):
//   Y_diag = (C Bᵀ ⊙ L) X,   L[i][j] = exp(a_i - a_j) for j <= i, else 0
//   state  = (B ⊙ w)ᵀ X,     w_k = exp(a_last - a_k)
// L is a select: for j > i, a_i - a_j > 0 and exp overflows, so a 0/1
// multiply would give inf·0 = NaN.
//
// What bounds it on this card: bytes. At Zamba2's prefill (b = 4, 16
// chunks, 64 heads, Q = 128, P = N = 64, one B/C group) X in bf16 is 67 MB,
// Y_diag in fp32 134 MB and the states 67 MB; B and C are read once per
// group (1 MB each): 272.6 MB, 0.081 ms at 3.35 TB/s. With C·Bᵀ built once
// per (batch, chunk) and only the causal triangle's tiles computed, the
// products are ~10.7 GFLOP, 0.011 ms at the 989 TFLOP/s bf16 tensor-core
// rate, even three times over (the split below): the kernel has to stream
// X in and Y_diag and the states out, and hide the math under that.
//
// Design:
// - One CTA per (batch, chunk, block of heads), 384 threads, one CTA per
//   SM at a time (registers). The head block is the largest power-of-two
//   split of the heads whose grid still holds two CTAs per SM (8 heads at
//   Zamba2's shape, 512 CTAs); the grid runs the head blocks of one
//   (batch, chunk) next to each other, so the CTAs in flight read and
//   write whole rows of the (b, l, h, ·) tensors (faster on the card than
//   the other order). Warpgroup 0 is the producer (24 registers after
//   `setmaxnreg`); one thread issues every TMA load. Warpgroups 1 and 2
//   are consumers (240 registers). The kernel is instantiated apart for
//   B/C shared by the heads and per head, so the shared case has no C·Bᵀ
//   `wgmma` inside its head loop (which made ptxas serialize every
//   `wgmma` of the kernel).
// - TMA loads from maps of the tensors as they lie (5-D: 64 columns, Q
//   rows, heads, chunks, batch; real strides, no copy), so the model's
//   (b, c, Q, h, p) view of X is read in place. When B and C are one group
//   expanded over the heads with stride 0, their maps have one head and
//   C, B are loaded once per CTA; otherwise (the Pallas layout, a copied
//   expansion) each head's C and B come with its X. Each head's X tile
//   (Q x 64 bf16, 128-byte swizzle) and its Q values of a come through an
//   mbarrier ring of 4 stages (2 when C and B come with each head); the
//   consumers' 8 warps release a stage.
// - G = C·Bᵀ with `wgmma` from shared memory (both K-major), fp32, kept in
//   registers across the heads that share it. Only the causal triangle's
//   tiles: the consumer that owns rows 0-63 computes columns 0-63 (m64n64),
//   the one that owns rows 64-127 columns 0-127 (m64n128).
// - Per head, S = G ⊙ L in fp32 in registers (the m64nN accumulator
//   layout of G is the A-fragment layout of the next product), L a select
//   with one ex2.approx per element (relative error ~2^-22).
// - fp32 accuracy from bf16 tensor cores: the outputs are held to 2e-4
//   (the JAX zoo computes this einsum in fp32), so S, and B ⊙ w for the
//   states, are split into three bf16 terms, each its own `wgmma` into
//   the same fp32 accumulator; X, B and C are exact in bf16 already. Each
//   term is what is left truncated to its top 16 bits (hi = x with the low
//   16 bits cleared, mid the same of x - hi, lo = x - hi - mid): every
//   residual is exact, three 8-bit significands hold fp32's 24, so the
//   split is exact, and it costs integer ops only (a mask and a byte
//   permute), not the conversion unit's `cvt.rn.bf16x2`. Two terms leave
//   ~2^-16 of |S| per product: in the slow-decay regime (L ~ 1 across the
//   chunk, all 128 terms count) the CPU emulation of this kernel then
//   misses 2e-4 (tests/test_torch_ssd_routes.py); three terms meet it.
// - Y_diag rows = Σ_terms S_t · X: A from registers, X the MN-major B
//   operand (transpose bit) from swizzled shared memory, k-steps only over
//   columns j <= the row block's last row.
// - state: stateᵀ (n x p) = (B ⊙ w)ᵀ · X, the same X operand; (B ⊙ w)ᵀ
//   comes from B's [k][n] tile by ldmatrix .trans, scaled by w and split
//   in registers. At Q = 128 the rows-0-63 consumer also does the state
//   (its S·X has half the k-steps of the other's); at Q = 64 the second
//   consumer does only the state.
// - Stores: 74 % of the bytes are the fp32 outputs. Stored straight from
//   the accumulators (8-byte and 4-byte stores, 8 or 4 lines a warp
//   instruction), a first version of this kernel moved 1.8 TB/s
//   (PERF.md). Each consumer instead
//   writes its 64 x 64 fp32 tiles (Y_diag rows, the state as [p][n]) into
//   a shared buffer laid out as two 128-byte-swizzled [64][32] halves
//   (conflict-free from the accumulator layout), and one thread issues a
//   TMA store of each half; the buffers are double-buffered per consumer,
//   so a head's stores drain while the next head is computed and the
//   producer already loads the heads after it.
// - A barrier wait that never completes traps after ~2e10 cycles instead
//   of hanging the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kTerms = 3;                // bf16 terms of S and of B ⊙ w
constexpr int kBatch = 4;                // k-steps of A fragments per batch
constexpr int kAbytes = 1024;            // a (Q fp32), padded to alignment
constexpr int kOutTile = 64 * 64 * 4;    // a [64][64] fp32 output tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: C and B (when the heads share them), the load stages
// (X, a, and C and B when they differ per head), each consumer's two
// output buffers (Q = 128: Y rows 0-63 and the state, then Y rows 64-127;
// Q = 64: Y, then the state), the barriers.
template <int Q, bool PH>
struct Cfg {
  static constexpr int kStages = PH ? 2 : 4;
  static constexpr int kTile = Q * 128;  // [Q][64] bf16 rows of 128 B
  static constexpr int kShared = PH ? 0 : 2 * kTile;
  static constexpr int kStage = kTile + kAbytes + (PH ? 2 * kTile : 0);
  static constexpr int kOut0 = 2 * (Q == 128 ? 2 : 1) * kOutTile;
  static constexpr int kOut1 = 2 * kOutTile;
  static constexpr int kBars = kShared + kStages * kStage + kOut0 + kOut1;
  // + 1024: the dynamic shared base is aligned up to 1024 B in the kernel
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

struct TcArgs {
  int H, NC, hb, n_hb, c_heads, b_heads;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits for the phase of the given parity to complete; traps after ~10 s
// of SM clock (2e10 cycles) so a broken pipeline fails the launch.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000LL) __trap();
  }
}

// One [Q rows][64] bf16 box of a (b, c, q, h, ·) tensor, coordinates
// innermost first (col, q, h, c, b), into swizzled shared memory.
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int c,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0),
         "r"(0), "r"(h), "r"(c), "r"(b)
      : "memory");
}

// The Q values of a of one (b, h, c): coordinates (q, c, h, b).
__device__ __forceinline__ void tma_load_a(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int h,
                                           int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0),
         "r"(c), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// 16 rows (k) of an X tile [k][p], the MN-major B operand: 8-row groups
// 1024 B apart.
__device__ __forceinline__ uint64_t x_desc(uint32_t sx, int kk) {
  return sw128_desc(sx + kk * 2048, 128 * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers in program order around the asynchronous
// wgmma, so the compiler moves no read or write of them across.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The top 16 bits of x0 and x1 as a bf16 pair (x0 in the low half).
__device__ __forceinline__ uint32_t top16x2(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}

// x with its low 16 bits cleared: the bf16 truncation of x, as fp32.
__device__ __forceinline__ float trunc16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// (x0, x1) = hi + mid + lo exactly, each a bf16 pair: each term is the
// truncation of what is left, and every residual is exact in fp32.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = top16x2(x0, x1);
  const float r0 = x0 - trunc16(x0), r1 = x1 - trunc16(x1);
  mid = top16x2(r0, r1);
  lo = top16x2(r0 - trunc16(r0), r1 - trunc16(r1));
}

// TMA store of one [64 rows][32] fp32 half-tile (128-byte swizzle) to a
// 5-D map, coordinates innermost first.
__device__ __forceinline__ void tma_store5(const CUtensorMap* map,
                                           uint32_t src, int x0, int x1,
                                           int h, int c, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x0), "r"(x1),
         "r"(h), "r"(c), "r"(b)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most one committed group of stores still reads shared memory.
__device__ __forceinline__ void bulk_wait_read_1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes visible to TMA (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A barrier of one warpgroup's 128 threads (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Byte offset of (row r, column c) in a [64][64] fp32 output tile stored
// as two [64][32] halves of 8 kB, each with the 128-byte swizzle of its
// TMA box: 16-byte chunk c/4 of row r sits at chunk (c/4) ^ (r % 8).
__device__ __forceinline__ uint32_t out_off(int r, int c) {
  return (c >> 5) * 8192 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         (c & 3) * 4;
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&q)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3]) : "r"(addr)
      : "memory");
}

// d (m64 x n64, fp32) = [d +] A·Bᵀ: A (64 x 16) and B (64 x 16), both bf16
// in shared memory, K-major; m64n64k16. scale_d = 0 starts the sum.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128, fp32) = [d +] A·Bᵀ, as above with B 128 x 16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, fp32) += A·B: A (64 x 16) bf16 pairs in registers, B
// (16 x n64) bf16 in shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// G (m64 x NG, fp32) = C[rows]·Bᵀ[0 .. NG): N = 64 in 4 k-steps of 32 B.
template <int NG>
__device__ __forceinline__ void gram(float (&g)[NG / 2], uint32_t c_rows,
                                     uint32_t b_rows) {
#pragma unroll
  for (int i = 0; i < NG / 2; ++i) g[i] = 0.f;
  fence_regs(g);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sw128_desc(c_rows + kk * 32, 16, 1024);
    const uint64_t db = sw128_desc(b_rows + kk * 32, 16, 1024);
    if constexpr (NG == 64) wgmma_ss_n64(g, da, db, kk > 0);
    else wgmma_ss_n128(g, da, db, kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(g);
}

// One consumer warpgroup (cw = 0, 1). R0 >= 0: it owns Y_diag rows
// R0 .. R0 + 63; STATE: it computes the chunk state. PH: C and B come per
// head with X; else once per CTA.
template <int Q, bool PH, int R0, bool STATE>
__device__ __forceinline__ void consumer(
    const CUtensorMap* ty, const CUtensorMap* ts, uint8_t* smem_raw,
    uint32_t s_c, uint32_t s_b, uint32_t stages, uint32_t obuf,
    uint32_t bc_full, uint32_t full, uint32_t empty, int cw, int b, int c,
    int h0, int nh) {
  using Cf = Cfg<Q, PH>;
  constexpr bool ROWS = R0 >= 0;
  constexpr int NG = ROWS ? R0 + 64 : 64;    // G's columns: j < R0 + 64
  constexpr int kOutBuf = (int(ROWS) + int(STATE)) * kOutTile;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool leader = threadIdx.x % 128 == 0;
  // accumulator layout: this thread holds rows 16·warp + g (+ 8) of the
  // warpgroup's 64, columns 8j + 2·t4 + {0, 1} for every j
  const int r0 = 16 * warp + g, i0 = (ROWS ? R0 : 0) + r0, i1 = i0 + 8;
  const uint32_t raw = smem_u32(smem_raw);
  float G[NG / 2];
  if constexpr (!PH) {
    mbar_wait(bc_full, 0);
    if constexpr (ROWS) gram<NG>(G, s_c + R0 * 128, s_b);
  }
  for (int t = 0; t < nh; ++t) {
    const int s = t % Cf::kStages, ph = (t / Cf::kStages) & 1, h = h0 + t;
    const uint32_t sx = stages + s * Cf::kStage, sa = sx + Cf::kTile;
    const uint32_t sc = PH ? sa + kAbytes : s_c;
    const uint32_t sb = PH ? sc + Cf::kTile : s_b;
    const float* av = reinterpret_cast<const float*>(smem_raw + (sa - raw));
    const uint32_t ob = obuf + (t & 1) * kOutBuf;
    uint8_t* og = smem_raw + (ob - raw);
    mbar_wait(full + 8 * s, ph);
    // per-head C·Bᵀ before the leader's branch below: after it, ptxas
    // serializes the kernel's wgmma (C7520, a warpgroup arrive on a
    // divergent path)
    if constexpr (PH && ROWS) gram<NG>(G, sc + R0 * 128, sb);
    // this head's output buffer was last read by the stores of head t - 2
    if (leader) bulk_wait_read_1();
    wg_sync(1 + cw);

    if constexpr (ROWS) {
      const float ai0 = av[i0], ai1 = av[i1];
      float y[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) y[i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < NG / 16; k0 += kBatch) {
        uint32_t fr[kBatch][kTerms][4];
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb) {
          const int kk = k0 + kb;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            // A-fragment register r: row i0 (r even) or i1, columns
            // 16kk + 8(r / 2) + 2·t4 + {0, 1} = G[8kk + 2r + {0, 1}]
            const int j = 16 * kk + 8 * (r >> 1) + 2 * t4;
            const int i = (r & 1) ? i1 : i0;
            const float ai = (r & 1) ? ai1 : ai0;
            const float2 aj = *reinterpret_cast<const float2*>(av + j);
            const float s0 = j <= i ? G[8 * kk + 2 * r] *
                                          ex2((ai - aj.x) * kLog2e)
                                    : 0.f;
            const float s1 = j + 1 <= i ? G[8 * kk + 2 * r + 1] *
                                              ex2((ai - aj.y) * kLog2e)
                                        : 0.f;
            split3(s0, s1, fr[kb][0][r], fr[kb][1][r], fr[kb][2][r]);
          }
        }
        fence_regs(y);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb)
#pragma unroll
          for (int tm = 0; tm < kTerms; ++tm)
            wgmma_rs_n64(y, fr[kb][tm], x_desc(sx, k0 + kb));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(y);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(og + out_off(r0, p)) =
            make_float2(y[4 * j], y[4 * j + 1]);
        *reinterpret_cast<float2*>(og + out_off(r0 + 8, p)) =
            make_float2(y[4 * j + 2], y[4 * j + 3]);
      }
    }

    if constexpr (STATE) {
      // stateᵀ rows n = 16·warp + g (+ 8), columns p; A = (B ⊙ w)ᵀ
      const float a_last = av[Q - 1];
      const int mi = lane >> 3, mr = lane & 7;
      const int n_ld = 16 * warp + 8 * (mi & 1);
      float st[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < Q / 16; k0 += kBatch) {
        uint32_t fr[kBatch][kTerms][4];
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb) {
          const int kk = k0 + kb;
          // matrices: (k 0-7 | 8-15) x (n 0-7 | 8-15) of this k-step and
          // warp; .trans gives thread (g, t4) rows n = g, k = 2·t4 + {0,1}
          const int k_ld = 16 * kk + mr + 8 * (mi >> 1);
          uint32_t q[4];
          ldmatrix_x4_trans(
              q, sb + k_ld * 128 + ((((n_ld >> 3) ^ (k_ld & 7))) << 4));
          const int k = 16 * kk + 2 * t4;
          const float2 ak = *reinterpret_cast<const float2*>(av + k);
          const float2 ak8 = *reinterpret_cast<const float2*>(av + k + 8);
          const float w[4] = {ex2((a_last - ak.x) * kLog2e),
                              ex2((a_last - ak.y) * kLog2e),
                              ex2((a_last - ak8.x) * kLog2e),
                              ex2((a_last - ak8.y) * kLog2e)};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&q[r]));
            split3(bv.x * w[2 * (r >> 1)], bv.y * w[2 * (r >> 1) + 1],
                   fr[kb][0][r], fr[kb][1][r], fr[kb][2][r]);
          }
        }
        fence_regs(st);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < kBatch; ++kb)
#pragma unroll
          for (int tm = 0; tm < kTerms; ++tm)
            wgmma_rs_n64(st, fr[kb][tm], x_desc(sx, k0 + kb));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
      }
      // the state tile is [p][n]: this thread's (n, p) go transposed
      uint8_t* sg = og + (ROWS ? kOutTile : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + 2 * t4;
        *reinterpret_cast<float*>(sg + out_off(p, r0)) = st[4 * j];
        *reinterpret_cast<float*>(sg + out_off(p + 1, r0)) = st[4 * j + 1];
        *reinterpret_cast<float*>(sg + out_off(p, r0 + 8)) = st[4 * j + 2];
        *reinterpret_cast<float*>(sg + out_off(p + 1, r0 + 8)) =
            st[4 * j + 3];
      }
    }
    // the stage's X, a (and C, B) are no longer read
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    fence_async_smem();
    wg_sync(1 + cw);
    if (leader) {
      for (int half = 0; half < 2; ++half) {
        if constexpr (ROWS)
          tma_store5(ty, ob + half * 8192, 32 * half, R0, h, c, b);
        if constexpr (STATE)
          tma_store5(ts, ob + (ROWS ? kOutTile : 0) + half * 8192, 32 * half,
                     0, h, c, b);
      }
      bulk_commit();
    }
  }
  // shared memory must outlive the stores' reads of it
  if (leader) bulk_wait_all();
}

template <int Q, bool PH>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc,
              const __grid_constant__ CUtensorMap ty,
              const __grid_constant__ CUtensorMap ts, const TcArgs a) {
  using Cf = Cfg<Q, PH>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 8 rows of 128 B: align to 1024 B
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_c = base, s_b = base + Cf::kTile;  // shared C, B
  const uint32_t stages = base + Cf::kShared;
  const uint32_t out0 = stages + Cf::kStages * Cf::kStage;
  const uint32_t out1 = out0 + Cf::kOut0;
  const uint32_t bars = base + Cf::kBars;             // 8 B each
  const uint32_t bc_full = bars, full = bars + 8;
  const uint32_t empty = bars + 8 * (1 + Cf::kStages);

  // CTA u: heads (u % n_hb)·hb .. of the (batch, chunk) pair u / n_hb
  const int bc = blockIdx.x / a.n_hb, b = bc / a.NC, c = bc % a.NC;
  const int h0 = blockIdx.x % a.n_hb * a.hb, nh = min(a.hb, a.H - h0);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(bc_full, 1);
    for (int s = 0; s < Cf::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);           // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      if constexpr (!PH) {
        mbar_expect_tx(bc_full, 2 * Cf::kTile);
        tma_load5(s_c, &tc, bc_full, 0, c, b);
        tma_load5(s_b, &tb, bc_full, 0, c, b);
      }
      for (int t = 0; t < nh; ++t) {
        const int s = t % Cf::kStages, ph = (t / Cf::kStages) & 1;
        const int h = h0 + t;
        const uint32_t sx = stages + s * Cf::kStage;
        mbar_wait(empty + 8 * s, ph ^ 1);    // a fresh stage passes
        mbar_expect_tx(full + 8 * s, Cf::kStage - kAbytes + Q * 4);
        tma_load5(sx, &tx, full + 8 * s, h, c, b);
        tma_load_a(sx + Cf::kTile, &ta, full + 8 * s, c, h, b);
        if constexpr (PH) {
          const uint32_t sc = sx + Cf::kTile + kAbytes;
          tma_load5(sc, &tc, full + 8 * s, a.c_heads ? h : 0, c, b);
          tma_load5(sc + Cf::kTile, &tb, full + 8 * s, a.b_heads ? h : 0, c,
                    b);
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    if (wg == 1)
      consumer<Q, PH, 0, Q == 128>(&ty, &ts, smem_raw, s_c, s_b, stages,
                                   out0, bc_full, full, empty, 0, b, c, h0,
                                   nh);
    else
      consumer<Q, PH, (Q == 128 ? 64 : -1), Q != 128>(
          &ty, &ts, smem_raw, s_c, s_b, stages, out1, bc_full, full,
          empty, 1, b, c, h0, nh);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || !p)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 5-D map of a (b, c, rows, h, 64) tensor with element strides st =
// (b, c, rows, h), the last dim contiguous: bf16 inputs in boxes of
// [rows][64], fp32 outputs in boxes of [64 rows][32]; 128-byte swizzle.
// heads = 1 maps a head expansion of stride 0 (st[3] is then any valid
// stride: the dim is never stepped).
CUresult map5(EncodeTiled enc, CUtensorMap* map, const void* ptr, bool fp32,
              int rows, int box_rows, int heads, int NC, int nb,
              const long long* st) {
  const int es = fp32 ? 4 : 2;
  const cuuint64_t dims[5] = {64, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)NC, (cuuint64_t)nb};
  const cuuint64_t strides[4] = {
      (cuuint64_t)(st[2] * es), (cuuint64_t)(st[3] * es),
      (cuuint64_t)(st[1] * es), (cuuint64_t)(st[0] * es)};
  const cuuint32_t box[5] = {fp32 ? 32u : 64u, (cuuint32_t)box_rows, 1, 1,
                             1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return enc(map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             5, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A 4-D map of a (b, h, c, q) fp32 tensor with element strides st = (b, h,
// c), q contiguous; boxes of Q values.
CUresult map_a(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Q,
               int H, int NC, int nb, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)Q, (cuuint64_t)NC, (cuuint64_t)H,
                              (cuuint64_t)nb};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 4, (cuuint64_t)st[1] * 4,
                                 (cuuint64_t)st[0] * 4};
  const cuuint32_t box[4] = {(cuuint32_t)Q, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int Q, bool PH>
cudaError_t launch_q(const CUtensorMap* m, const TcArgs& a, dim3 grid,
                     cudaStream_t stream) {
  static bool attr_set[64] = {};         // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(ssd_tc_kernel<Q, PH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<Q, PH>::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) attr_set[dev] = true;
  }
  ssd_tc_kernel<Q, PH><<<grid, kThreads, Cfg<Q, PH>::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA at chunk length Q (64 or 128), with C
// and B loaded per head (per_head = 1) or once per CTA; 0 for another Q.
int ssd_intra_chunk_tc_smem(int Q, int per_head) {
  if (Q == 64) return per_head ? Cfg<64, true>::kSmem : Cfg<64, false>::kSmem;
  if (Q == 128)
    return per_head ? Cfg<128, true>::kSmem : Cfg<128, false>::kSmem;
  return 0;
}

// Heads per CTA: the largest power-of-two split of H that still gives
// two CTAs per SM over the nb·NC (batch, chunk) pairs.
int ssd_intra_chunk_tc_heads_per_cta(int nb, int NC, int H, int sms) {
  const long long pairs = (long long)nb * NC;
  int hb = H;
  while (hb > 1 && pairs * ((H + hb - 1) / hb) < 2LL * sms) hb = (hb + 1) / 2;
  return hb;
}

// X (b, c, Q, h, 64), B and C (b, c, Q, h, 64), all bf16, Q 64 or 128, with
// element strides (b, c, q, h) st[0..3] for X, st[7..10] for B, st[11..14]
// for C; A (b, h, c, Q) fp32, q contiguous, strides (b, h, c) st[4..6];
// Y_diag (b, c, Q, h, 64) fp32, strides st[15..18], p contiguous; states
// (b, c, h, 64, 64) fp32, strides st[19..23], n contiguous. b_heads /
// c_heads = 0 when B / C is one group expanded over the heads with stride
// 0 (its head stride in st is then any valid one). The caller checks
// TMA's rules: 16-byte aligned pointers, strides that are multiples of 16
// bytes. Returns the CUDA error of the launch, or -r where
// cuTensorMapEncodeTiled refused a map with r.
int ssd_intra_chunk_tc_launch(const void* X, const void* A, const void* B,
                              const void* C, void* Y, void* S,
                              const long long* st, int nb, int NC, int Q,
                              int H, int b_heads, int c_heads, void* stream) {
  if (nb <= 0 || NC <= 0 || H <= 0 || H > 65535 || (Q != 64 && Q != 128) ||
      (long long)nb * NC > 0x7fffffffLL || st[23] != 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  EncodeTiled enc;
  e = encoder(&enc);
  if (e != cudaSuccess) return (int)e;
  TcArgs a;
  a.H = H;
  a.NC = NC;
  a.hb = ssd_intra_chunk_tc_heads_per_cta(nb, NC, H, sms);
  a.n_hb = (H + a.hb - 1) / a.hb;
  if ((long long)nb * NC * a.n_hb > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.b_heads = b_heads && H > 1;
  a.c_heads = c_heads && H > 1;
  const bool per_head = a.b_heads || a.c_heads;
  // the states as (b, c, h, p, n): rows p, heads h
  const long long ss[4] = {st[19], st[20], st[22], st[21]};
  CUtensorMap m[6];                      // X, A, B, C, Y_diag, states
  CUresult r = map5(enc, &m[0], X, false, Q, Q, H, NC, nb, st);
  if (r == CUDA_SUCCESS) r = map_a(enc, &m[1], A, Q, H, NC, nb, st + 4);
  if (r == CUDA_SUCCESS)
    r = map5(enc, &m[2], B, false, Q, Q, a.b_heads ? H : 1, NC, nb, st + 7);
  if (r == CUDA_SUCCESS)
    r = map5(enc, &m[3], C, false, Q, Q, a.c_heads ? H : 1, NC, nb, st + 11);
  if (r == CUDA_SUCCESS)
    r = map5(enc, &m[4], Y, true, Q, 64, H, NC, nb, st + 15);
  if (r == CUDA_SUCCESS) r = map5(enc, &m[5], S, true, 64, 64, H, NC, nb, ss);
  if (r != CUDA_SUCCESS) return -(int)r;
  const dim3 grid((unsigned)(nb * NC * a.n_hb));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q == 64)
    e = per_head ? launch_q<64, true>(m, a, grid, s)
                 : launch_q<64, false>(m, a, grid, s);
  else
    e = per_head ? launch_q<128, true>(m, a, grid, s)
                 : launch_q<128, false>(m, a, grid, s);
  return (int)e;
}

}  // extern "C"
