// Sliding-window flash attention, forward, on Hopper's tensor cores
// (sm_90a): the bf16 route of `kernels/swa_attention.py`.
//
// Replaces the Pallas TPU kernel `swa_attention` (src/repro/kernels/
// swa_attention.py:73, body `_kernel` :26) for q, k, v all bf16 with head
// dim 64 or 128; every other input goes to swa_attention.cu (CUDA cores,
// fp32). Same function:
//   out[b, i, h] = softmax_k(q_i · k_k / sqrt(hd), masked) · v
// with query i at absolute position qpos = i + (Sk - Sq), key k kept where
// k < Sk, k <= qpos (causal) and k > qpos - window (window > 0).
//
// What bounds it on this card: operations. At Zamba2's prefill (B = 4,
// S = 2048, H = 32, hd = 64, causal) the two products need 4·hd FLOPs per
// kept (query, key) pair, 68.8 GFLOP: 0.070 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 0.050 ms for the 168 MB of inputs and fp32
// output at 3.35 TB/s. The fp32 route runs the products on the CUDA cores
// (67 TFLOP/s peak); here they are `wgmma`. At hd = 64 one score costs
// 2·64 tensor-core FLOPs per product but one MUFU exp2 (16 per clock per
// SM), so the softmax is as long as the products: the two consumer
// warpgroups of a CTA overlap one's softmax with the other's products only
// as far as the warp schedulers interleave them (ping-pong scheduling and
// intra-warpgroup overlap are later steps, ROADMAP queue 4).
//
// Design (FlashAttention-3's layout, Shah et al. 2024):
// - One CTA per (query tile of 128 rows, batch·head), 384 threads. The
//   query tiles launch last-first: under a causal mask the last tiles see
//   the most keys, so the long CTAs start first and the short ones fill the
//   tail. Warpgroup 0 is the producer (24 registers a thread after
//   `setmaxnreg`); one thread issues every TMA load. Warpgroups 1 and 2 are
//   consumers (240 registers), each owning 64 query rows.
// - Q is loaded once; K and V tiles of 128 keys come through a ring of
//   stages (3 at hd = 64, 2 at hd = 128), each with a "K full", a "V full"
//   and an "empty" mbarrier; the consumers' 8 warps arrive on "empty" when
//   both products of a stage are done. Tiles outside [qpos - window + 1,
//   qpos] of every row of the CTA are never loaded.
// - Tensor maps are built on the host from the (B, S, heads, hd) tensors as
//   they lie (4-D, real strides, no copy); k/v with KV < H heads are read
//   at kv head h / (H / KV). Every shared tile is [rows][64] bf16 with the
//   128-byte swizzle (an hd = 64 row is exactly 128 B; hd = 128 is two such
//   column chunks), 1024-byte aligned. TMA zero-fills rows past Sq / Sk and
//   the key mask covers them.
// - S = Q·Kᵀ: `wgmma` m64n128k16, both operands from shared memory
//   (K-major), fp32 accumulators, hd/16 k-steps.
// - Mask and online softmax in fp32, on the tiles that cut the diagonal,
//   the window edge or Sk only. Masked scores are -1e30, never -inf. A row
//   keeps its running max m in score units; p = exp2(s·c - m·c) with c =
//   scale·log2(e), one FMA and `ex2.approx`. While every key a row has seen
//   is masked, m = -1e30 and its m·c is taken as 0, so p = exp2(-1e30·c) =
//   0 (not 1, as in swa_attention.cu): nothing is added, and the first kept
//   key's rescale exp2((-1e30 - m)·c) = 0 multiplies zeros, so no NaN and
//   no trace remains either way; a row with no kept key at all gives 0.
//   Row max and sum reduce over the 4 threads that share a row in the
//   accumulator layout.
// - O += P·V: P is rounded to bf16 in registers and is `wgmma`'s A operand
//   straight from registers (the m64nNk16 accumulator layout of S is the
//   A-fragment layout of the next product); V is the B operand from shared
//   memory, MN-major (transpose bit), since its tile is [key][d]. The
//   denominator l is summed in fp32 from the unrounded p. Rounding P to
//   bf16 is what the JAX zoo's `sdpa` does (`softmax(...).astype(q.dtype)`);
//   the Pallas kernel and the plain version keep P in fp32, hence the
//   route's 1e-2 tolerance against them.
// - Epilogue: O / max(l, 1e-30), fp32, at the output's strides.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // query rows per CTA (64 a consumer)
constexpr int kBN = 128;                 // keys per K/V tile
constexpr int kThreads = 384;            // producer + 2 consumer warpgroups
constexpr int kChunkBytes = 128 * 128;   // one [128 rows][64] bf16 chunk
constexpr float kNegInf = -1e30f;

template <int NC>                        // NC = hd / 64 column chunks
struct Cfg {
  static constexpr int kStages = NC == 1 ? 3 : 2;
  static constexpr int kTileBytes = NC * kChunkBytes;    // Q, or K or V
  static constexpr int kBarBytes = 8 * (1 + 3 * kStages);
  // + 1024: the dynamic shared base is aligned up to 1024 B in the kernel
  static constexpr int kSmem =
      kTileBytes * (1 + 2 * kStages) + kBarBytes + 1024;
};

struct TcArgs {
  float* out;
  long long so_b, so_s, so_h;            // element strides of out; d is 1
  int H, KV, Sq, Sk, window, causal, n_qt;
  float c;                               // scale · log2(e)
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

// Waits for the phase of the given parity to complete. A wait that never
// ends (a broken pipeline) traps after ~10 s of SM clock (2e10 cycles)
// instead of hanging the card: the launch then fails with an error that
// the next synchronising call reports.
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

// One [128 rows][64] bf16 box of a (B, S, heads, hd) tensor, coordinates
// innermost first (d, s, head, b), into swizzled shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int hh,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(s), "r"(hh), "r"(b)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64 x n128, fp32) = [d +] A·Bᵀ: A (64 x 16) and B (128 x 16), both
// bf16 in shared memory, K-major; m64n128k16. scale_d = 0 starts the sum.
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

// d (m64 x n128, fp32) += A·B: A (64 x 16) bf16 pairs in registers, B
// (16 x n128) bf16 in shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using C = Cfg<NC>;
  constexpr int ST = C::kStages;
  constexpr int kD = 64 * NC;                  // head dim
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 8 rows of 128 B: align to 1024 B
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::kTileBytes;                 // ST K tiles
  const uint32_t sv = sk + ST * C::kTileBytes;            // ST V tiles
  const uint32_t bars = sv + ST * C::kTileBytes;          // 8 B each
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                       // + 8·stage
  const uint32_t v_full = bars + 8 * (1 + ST);
  const uint32_t empty = bars + 8 * (1 + 2 * ST);

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = (a.n_qt - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int off = a.Sk - a.Sq;
  // the key tiles that hold a kept key for some row of this CTA
  const int pmin = q0 + off, pmax = min(q0 + kBM, a.Sq) - 1 + off;
  const int k_lo = a.window > 0 ? max(0, pmin - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk, pmax + 1) : a.Sk;
  const int t_lo = k_lo / kBN;
  const int n_t = (k_hi + kBN - 1) / kBN - t_lo;

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);             // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
      for (int c = 0; c < NC; ++c)
        tma_load(sq + c * kChunkBytes, &tq, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_t; ++it) {
        const int s = it % ST, ph = (it / ST) & 1;
        const int k0 = (t_lo + it) * kBN;
        mbar_wait(empty + 8 * s, ph ^ 1);      // a fresh stage passes
        mbar_expect_tx(k_full + 8 * s, C::kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(sk + s * C::kTileBytes + c * kChunkBytes, &tk,
                   k_full + 8 * s, 64 * c, k0, kvh, b);
        mbar_expect_tx(v_full + 8 * s, C::kTileBytes);
        for (int c = 0; c < NC; ++c)
          tma_load(sv + s * C::kTileBytes + c * kChunkBytes, &tv,
                   v_full + 8 * s, 64 * c, k0, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int g = lane / 4, t4 = lane % 4;
    // accumulator layout: this thread holds rows r0 and r0 + 8 of the
    // warpgroup's 64, columns 8j + 2·t4 + {0, 1} for every j
    const int r0 = q0 + 64 * cw + 16 * warp + g;
    const int qp0 = r0 + off, qp1 = r0 + 8 + off;
    const int w_first = q0 + 64 * cw;
    const bool rows_dead = w_first >= a.Sq;    // every row past Sq
    const int wmin = w_first + off;
    const int wmax = min(w_first + 64, a.Sq) - 1 + off;
    const uint32_t q_rows = sq + cw * 64 * 128;   // this warpgroup's Q rows

    float o[32 * NC];
#pragma unroll
    for (int i = 0; i < 32 * NC; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(q_full, 0);

    for (int it = 0; it < n_t; ++it) {
      const int s = it % ST, ph = (it / ST) & 1;
      const int k0 = (t_lo + it) * kBN;
      // warpgroup-uniform: no row of this warpgroup keeps a key of the
      // tile (skip), or every row keeps every key (no mask)
      const bool skip = rows_dead || k0 >= a.Sk ||
                        (a.causal && k0 > wmax) ||
                        (a.window > 0 && k0 + kBN - 1 <= wmin - a.window);
      const bool whole = k0 + kBN <= a.Sk &&
                         (!a.causal || k0 + kBN - 1 <= wmin) &&
                         (a.window <= 0 || k0 > wmax - a.window);
      uint32_t p[8][4];
      float corr0 = 1.f, corr1 = 1.f;
      mbar_wait(k_full + 8 * s, ph);
      if (!skip) {
        float sc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * NC; ++kk) {
          const uint32_t chunk = (kk / 4) * kChunkBytes + (kk % 4) * 32;
          wgmma_ss_n128(sc, sw128_desc(q_rows + chunk, 16, 1024),
                        sw128_desc(sk + s * C::kTileBytes + chunk, 16, 1024),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        if (!whole) {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int kpos = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
            const int qp = (i & 2) ? qp1 : qp0;
            bool ok = kpos < a.Sk;
            if (a.causal) ok = ok && kpos <= qp;
            if (a.window > 0) ok = ok && kpos > qp - a.window;
            if (!ok) sc[i] = kNegInf;
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sc[i]);
          else mx0 = fmaxf(mx0, sc[i]);
        }
#pragma unroll
        for (int x = 1; x <= 2; x <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        corr0 = ex2((m0 - mx0) * a.c);
        corr1 = ex2((m1 - mx1) * a.c);
        m0 = mx0;
        m1 = mx1;
        const float mc0 = mx0 == kNegInf ? 0.f : mx0 * a.c;
        const float mc1 = mx1 == kNegInf ? 0.f : mx1 * a.c;
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float pv = ex2(fmaf(sc[i], a.c, (i & 2) ? -mc1 : -mc0));
          sc[i] = pv;
          if (i & 2) rs1 += pv;
          else rs0 += pv;
        }
        l0 = l0 * corr0 + rs0;
        l1 = l1 * corr1 + rs1;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
      }
      mbar_wait(v_full + 8 * s, ph);
      if (!skip) {
#pragma unroll
        for (int i = 0; i < 32 * NC; ++i) o[i] *= (i & 2) ? corr1 : corr0;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          // 16 keys of V, [key][d] rows of 128 B: MN-major, 8-key groups
          // 1024 B apart, the two 64-wide d chunks (hd = 128) 16 KB apart
          const uint64_t dv = sw128_desc(
              sv + s * C::kTileBytes + kk * 2048, kChunkBytes, 1024);
          if constexpr (NC == 1) wgmma_rs_n64(o, p[kk], dv);
          else wgmma_rs_n128(o, p[kk], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // epilogue: O / max(l, 1e-30), fp32, rows < Sq
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    if (!rows_dead) {
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      float* og = a.out + b * a.so_b + h * a.so_h;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (r0 < a.Sq)
          *reinterpret_cast<float2*>(og + r0 * a.so_s + col) =
              make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (r0 + 8 < a.Sq)
          *reinterpret_cast<float2*>(og + (r0 + 8) * a.so_s + col) =
              make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
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

// A 4-D map of a (B, S, heads, hd) bf16 tensor, element strides st =
// (b, s, h), d contiguous; boxes of [128 rows][64], 128-byte swizzle,
// zero fill out of bounds.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd,
                  int S, int heads, int B, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, kBN, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int NC>
cudaError_t launch_nc(const CUtensorMap& mq, const CUtensorMap& mk,
                      const CUtensorMap& mv, const TcArgs& a, int B,
                      cudaStream_t stream) {
  static bool attr_set[64] = {};         // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !attr_set[dev]) {
    e = cudaFuncSetAttribute(swa_tc_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<NC>::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 64) attr_set[dev] = true;
  }
  const dim3 grid(B * a.H, a.n_qt);
  swa_tc_kernel<NC><<<grid, kThreads, Cfg<NC>::kSmem, stream>>>(mq, mk, mv,
                                                                 a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA at head dim hd (64 or 128), else 0.
int swa_attention_tc_smem(int hd) {
  return hd == 64 ? Cfg<1>::kSmem : hd == 128 ? Cfg<2>::kSmem : 0;
}

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), all bf16, hd 64 or 128, with
// element strides st[0..2] = (b, s, h) for q, st[3..5] for k, st[6..8] for
// v, st[9..11] for out (B, Sq, H, hd) fp32; the d stride is 1 for all four.
// The caller checks TMA's rules: 16-byte aligned pointers, strides that are
// multiples of 16 bytes. window <= 0 means none. Returns the CUDA error of
// the launch, or -r where cuTensorMapEncodeTiled refused a map with r.
int swa_attention_tc_launch(const void* q, const void* k, const void* v,
                            void* out, const long long* st, int B, int Sq,
                            int Sk, int H, int KV, int hd, int window,
                            int causal, float scale, void* stream) {
  const int n_qt = (Sq + kBM - 1) / kBM;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      (hd != 64 && hd != 128) || n_qt > 65535 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc;
  cudaError_t e = encoder(&enc);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  CUresult r = make_map(enc, &mq, q, hd, Sq, H, B, st);
  if (r == CUDA_SUCCESS) r = make_map(enc, &mk, k, hd, Sk, KV, B, st + 3);
  if (r == CUDA_SUCCESS) r = make_map(enc, &mv, v, hd, Sk, KV, B, st + 6);
  if (r != CUDA_SUCCESS) return -(int)r;
  TcArgs a;
  a.out = static_cast<float*>(out);
  a.so_b = st[9];
  a.so_s = st[10];
  a.so_h = st[11];
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.window = window;
  a.causal = causal;
  a.n_qt = n_qt;
  a.c = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = hd == 64 ? launch_nc<1>(mq, mk, mv, a, B, s)
               : launch_nc<2>(mq, mk, mv, a, B, s);
  return (int)e;
}

}  // extern "C"
