// Sliding-window flash attention, backward, on bf16 tensor cores, for
// Hopper (sm_90a): the `tc` route of `kernels/swa_attention.py`'s
// `swa_attention_bwd`, taken when q, k and v are all bf16 (any head dim up
// to 256).
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// attention (`jax.vjp` of src/repro/kernels/ref.py:23, `swa_attention_ref`),
// while the port's forward on the card is a kernel whose output has no
// autograd graph. It computes
//   S = scale · Q Kᵀ (masked), P = exp(S - lse), D_i = Σ_d dO_i O_i,
//   dP = dO Vᵀ, dS = P ⊙ (dP - D),
//   dQ = scale · dS K, dK = scale · dSᵀ Q, dV = Pᵀ dO,
// with query i at qpos = i + (Sk - Sq), key j kept where j <= qpos
// (causal) and j > qpos - window (window > 0), dK and dV summed over the
// H/KV query heads of each kv head. Rounding, as the forward's `tc` route
// and SDPA's backward round: q, k, v arrive in bf16, the wrapper casts dO
// to bf16 once, and P and dS are rounded to bf16 before the products that
// take them; every product runs as mma.sync m16n8k16 bf16 with fp32
// accumulators, and every sum (lse, D, the accumulators) is fp32
// (`kernels.ref.swa_attention_bwd_ref(..., rounded=True)` is the plain
// version).
//
// What bounds it on this card: operations. At Zamba2's shape (B = 4,
// S = 2048, H = 32, hd = 64, causal) the four products of a backward are
// 10·hd FLOPs a kept pair, 172 GFLOP: 0.17 ms at 989 TFLOP/s. This design
// does 16·hd (the row pass recomputes S, and the dK/dV and dQ passes each
// recompute S and dP) so that no pass waits on another's partial sums and
// none needs atomics.
//
// Three passes, each output element summed by one thread in a fixed order
// (a call repeats bit for bit): (a) first, then (b) on a second stream of
// the library's beside (c) on the caller's stream, whose later work waits
// for (b) (an event):
// (a) rows: per (128-row query tile, batch·head), 8 warps of 16 rows: the
//     row log-sum-exp of the masked scores on the tensor cores (an online
//     max and sum over 64-key tiles, three staged by cp.async), and D from
//     dO (bf16) and O (fp32);
// (b) dK/dV: per (128-key tile, batch·query head), a warp per 16 keys:
//     each query tile that sees the key tile gives Sᵀ = K Qᵀ and
//     dPᵀ = V dOᵀ in the warp's accumulators (rows: its keys), P and dS
//     rounded to bf16 in registers, and dV += Pᵀ dO, dK += dSᵀ Q take them
//     as A operands as they stand (a C fragment's column pairs are an A
//     fragment's k pairs), with dO and Q read by ldmatrix.trans. With GQA /
//     MQA each query head writes its partial dK and dV to a workspace and
//     (d) sums each kv head's group in head order: one CTA per query head
//     keeps the grid full where one per kv head would walk the group in
//     series (Gemma-2B: 256 CTAs of 64 keys, not 32 each looping over 8
//     heads);
// (c) dQ: per (128-row query tile, batch·head), a warp per 16 rows: S, dP
//     and dS in registers per key tile, then dQ += dS K from them.
// Tiles are bf16 in shared memory at a pitch of Dp + 8 elements, where
// Dp = 16·⌈hd/16⌉ is the head dim padded with zero columns (56 -> 64, 80
// stays 80): rows lie 16·odd bytes apart, so ldmatrix reads are free of
// bank conflicts. Tiles load by cp.async, three stages deep along each
// pass's loop (two where shared memory is short: (a) at DM = 256, (c) at
// DM = 128). The loops run over Dp; DM (64, 80, 128 or 256, the smallest
// >= Dp) sizes the register arrays: dK + dV of 16 keys over the whole
// head dim are DM registers a thread, so at DM = 256 a warp pair shares
// 16 keys and splits the head dim (see (b); 64 keys a CTA there). (b)
// steps 32 query rows at a time and (c) 32 keys, and each caps its
// registers (launch bounds) so that two 8-warp CTAs fit an SM at
// DM <= 80: the passes are latency-bound; left at 226-255 registers a
// thread (8 warps an SM) they ran 1.3-1.5x slower on the H100, and CTAs
// of 8 warps, which share each staged tile and barrier, ran 1.04-1.4x
// faster than CTAs of 4.
#include <math.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

using tf32x3::cp_async;
using tf32x3::cp_commit;
using tf32x3::cp_wait_all;
using tf32x3::smem_u32;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowThreads = 256;          // pass (a): 8 warps

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dO;                         // (B, Sq, H, hd) contiguous
  const float* o;                         // (B, Sq, H, hd) contiguous
  float* lse;                             // (B·H, Sq): lse · log2(e)
  float* dd;                              // (B·H, Sq): D
  float* dq;                              // (B, Sq, H, hd) contiguous
  float* dk;                              // (B, Sk, KV or H, hd) contiguous
  float* dv;
  long long sq[3], sk[3], sv[3];          // element strides (b, s, h)
  int H, KV, Sq, Sk, hd, Dp, P, window, causal, ws_heads, vq, vk, vv, vo;
  float scale;
};

// --- mma.sync m16n8k16 bf16 and ldmatrix -----------------------------------

__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A fragment (16 x 16) of a row-major tile whose rows are m, columns k:
// rows r0.., columns c0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int pitch, int r0, int c0, int lane) {
  ldm4(a, t + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
}

// B fragments of two n-tiles (n0.., n0 + 8..) x 16 k of a tile whose rows
// are n, columns k: b[0], b[1] the first n-tile's, b[2], b[3] the second's
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* t,
                                          int pitch, int n0, int k0,
                                          int lane) {
  ldm4(b, t + (n0 + (lane >> 4) * 8 + (lane & 7)) * pitch + k0 +
              ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles x 16 k of a tile whose rows are k, columns n
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* t,
                                          int pitch, int k0, int n0,
                                          int lane) {
  ldm4t(b, t + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * pitch + n0 +
               (lane >> 4) * 8);
}

// wait until at most NS - 1 cp.async groups are pending: with one group
// committed a tile, the tile NS - 1 loads back has landed
template <int NS>
__device__ __forceinline__ void cp_wait_stage() {
  if (NS >= 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- masks and ranges --------------------------------------------------------

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
  if (i >= a.Sq || j >= a.Sk) return false;
  const int qp = i + a.Sk - a.Sq;
  if (a.causal && j > qp) return false;
  return a.window <= 0 || j > qp - a.window;
}

// every (query, key) of rows [q0, q0 + nq) x keys [k0, k0 + nk) kept: a
// tile inside the causal triangle and the window needs no mask
__device__ __forceinline__ bool tile_full(const Args& a, int q0, int nq,
                                          int k0, int nk) {
  if (q0 + nq > a.Sq || k0 + nk > a.Sk) return false;
  const int off = a.Sk - a.Sq;
  if (a.causal && k0 + nk - 1 > q0 + off) return false;
  return a.window <= 0 || k0 > q0 + nq - 1 + off - a.window;
}

// key tiles [t_lo, t_hi) of width BK holding a kept key for some row of
// [q0, q0 + BQ)
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int BQ,
                                          int BK, int& t_lo, int& t_hi) {
  const int off = a.Sk - a.Sq;
  const int pmin = q0 + off, pmax = min(q0 + BQ, a.Sq) - 1 + off;
  const int k_lo = a.window > 0 ? max(0, pmin - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk, pmax + 1) : a.Sk;
  t_lo = k_lo / BK;
  t_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : t_lo;
}

// query rows [i_lo, i_hi) that keep some key of [k0, k0 + BK)
__device__ __forceinline__ void query_rows(const Args& a, int k0, int BK,
                                           int& i_lo, int& i_hi) {
  const int off = a.Sk - a.Sq, k_last = min(k0 + BK, a.Sk) - 1;
  i_lo = a.causal ? max(0, k0 - off) : 0;
  i_hi = a.window > 0 ? min(a.Sq, k_last + a.window - off) : a.Sq;
}

// rows [r0, r0 + R) of a (rows, hd) bf16 slab at `base` (row stride rs)
// into a tile of pitch P; rows past `nrows` zero-filled. Columns hd..Dp
// are zeroed once by zero_pad.
template <int NT>
__device__ __forceinline__ void stage(bf16* dst, int P, const bf16* base,
                                      long long rs, int r0, int R, int nrows,
                                      int hd, int vec) {
  tf32x3::stage_rows<bf16, NT>(dst, P, base, rs, r0, R, nrows, hd, vec,
                               threadIdx.x);
}

template <int NT>
__device__ __forceinline__ void zero_pad(bf16* t, int P, int R, int hd,
                                         int Dp) {
  if (Dp > hd)
    for (int e = threadIdx.x; e < R * (Dp - hd); e += NT)
      t[(e / (Dp - hd)) * P + hd + e % (Dp - hd)] = __float2bfloat16(0.f);
}

// --- (a) row pass -------------------------------------------------------------

template <int DM>
__global__ void __launch_bounds__(kRowThreads)
swa_bwd_tc_rows_kernel(Args a) {
  constexpr int BQ = 128, BK = 64, NS = DM == 256 ? 2 : 3;
  const int P = a.P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);     // [BQ][P]
  bf16* ks = qs + BQ * P;                       // [NS][BK][P]
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV), q0 = blockIdx.x * BQ;
  const bf16* kbase = a.k + b * a.sk[0] + kvh * a.sk[2];
  zero_pad<kRowThreads>(qs, P, BQ, a.hd, a.Dp);
  zero_pad<kRowThreads>(ks, P, NS * BK, a.hd, a.Dp);
  __syncthreads();
  stage<kRowThreads>(qs, P, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], q0, BQ,
                     a.Sq, a.hd, a.vq);
  int t_lo, t_hi;
  key_tiles(a, q0, BQ, BK, t_lo, t_hi);
  // an NS-stage pipeline of key tiles: one cp.async group a tile
  for (int t = t_lo; t < t_lo + NS - 1; ++t) {
    if (t < t_hi)
      stage<kRowThreads>(ks + (t - t_lo) % NS * BK * P, P, kbase, a.sk[1],
                         t * BK, BK, a.Sk, a.hd, a.vk);
    cp_commit();
  }
  const float sl2 = a.scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int r0 = w * 16;
  // this warp's A fragments of Q, over the head dim (fixed for the CTA)
  constexpr int QF = DM / 16;
  uint32_t aq[QF][4];
  cp_wait_all();
  __syncthreads();
#pragma unroll
  for (int x = 0; x < QF; ++x)
    if (16 * x < a.Dp) frag_a(aq[x], qs, P, r0, 16 * x, lane);
  for (int t = t_lo; t < t_hi; ++t) {
    const bf16* kt = ks + (t - t_lo) % NS * BK * P;
    if (t + NS - 1 < t_hi)
      stage<kRowThreads>(ks + (t + NS - 1 - t_lo) % NS * BK * P, P, kbase,
                         a.sk[1], (t + NS - 1) * BK, BK, a.Sk, a.hd, a.vk);
    cp_commit();
    cp_wait_stage<NS>();
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int x = 0; x < QF; ++x) {
      if (16 * x >= a.Dp) break;
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bf[4];
        frag_b_nk(bf, kt, P, n * 8, 16 * x, lane);
        mma16(s[n], aq[x], bf[0], bf[1]);
        mma16(s[n + 1], aq[x], bf[2], bf[3]);
      }
    }
    // online max and sum of the two rows g, g + 8 (log2 units); the max
    // of the raw scores (the scale is positive) and the sum in two chains
    // each, so consecutive operations do not wait on each other
    const bool full = tile_full(a, q0 + r0, 16, t * BK, BK);
    if (!full)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = q0 + r0 + g + 8 * (e >> 1);
          const int j = t * BK + n * 8 + 2 * t4 + (e & 1);
          if (!kept(a, i, j)) s[n][e] = -INFINITY;
        }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, s[n][2 * hr]);
        mx1 = fmaxf(mx1, s[n][2 * hr + 1]);
      }
      float mx = fmaxf(mx0, mx1) * sl2;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hr], mx);
      const float ms = mn == -INFINITY ? 0.f : mn;  // no kept key yet
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sum0 += ex2(fmaf(s[n][2 * hr], sl2, -ms));
        sum1 += ex2(fmaf(s[n][2 * hr + 1], sl2, -ms));
      }
      float sum = sum0 + sum1;
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hr] = l[hr] * ex2(m[hr] - ms) + sum;
      m[hr] = mn;
    }
    __syncthreads();
  }
  cp_wait_all();
  if (t4 == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = q0 + r0 + g + 8 * hr;
      if (i < a.Sq)
        a.lse[(long long)bh * a.Sq + i] =
            l[hr] > 0.f ? m[hr] + __log2f(l[hr]) : 0.f;
    }
  // D_i = Σ_d dO_i · O_i: a lane pair a row (the warp's 16 rows at once,
  // their loads in flight together), each lane half the head dim, then
  // the pair's two halves added
  {
    const int i = q0 + r0 + lane / 2, half = (a.hd + 1) / 2;
    const int d0 = (lane & 1) * half, d1 = min(a.hd, d0 + half);
    float acc = 0.f;
    if (i < a.Sq) {
      const long long base = ((long long)(b * a.Sq + i) * a.H + h) * a.hd;
      for (int d = d0; d < d1; ++d)
        acc += __bfloat162float(a.dO[base + d]) * a.o[base + d];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && i < a.Sq) a.dd[(long long)bh * a.Sq + i] = acc;
  }
}

// fp32 C fragments (16 rows from r0 x 8 columns from c0) times `mul` into
// a row-major global tile (row stride rs elements), rows < nrows, columns
// < hd
__device__ __forceinline__ void store_c(float* out, long long rs,
                                        const float (&c)[4], int r0, int c0,
                                        int nrows, int hd, float mul,
                                        int lane) {
  const int g = lane / 4, t4 = lane % 4, col = c0 + 2 * t4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + g + 8 * hr;
    if (row >= nrows || col >= hd) continue;
    float* p = out + row * rs + col;
    const float x0 = c[2 * hr] * mul, x1 = c[2 * hr + 1] * mul;
    if (col + 1 < hd && ((reinterpret_cast<uintptr_t>(p) & 7) == 0)) {
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    } else {
      p[0] = x0;
      if (col + 1 < hd) p[1] = x1;
    }
  }
}

// the bf16 A fragments (16 rows x 16 k) of k-step kq of fp32 C fragments
// whose columns are that k: no shuffle (C's (g, 2t) pairs are A's)
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&f)[NT / 2][4],
                                     const float (&c)[NT][4]) {
#pragma unroll
  for (int kq = 0; kq < NT / 2; ++kq) {
    f[kq][0] = pack(c[2 * kq][0], c[2 * kq][1]);
    f[kq][1] = pack(c[2 * kq][2], c[2 * kq][3]);
    f[kq][2] = pack(c[2 * kq + 1][0], c[2 * kq + 1][1]);
    f[kq][3] = pack(c[2 * kq + 1][2], c[2 * kq + 1][3]);
  }
}

// --- (b) dK / dV ----------------------------------------------------------------
// A warp owns 16 keys of the CTA's 64 and computes, per query tile, Sᵀ =
// K Qᵀ and dPᵀ = V dOᵀ (rows: its keys), P and dS in registers, then dV +=
// Pᵀ dO and dK += dSᵀ Q straight from those registers. At DM = 256 a warp
// pair shares 16 keys and halves the head dim (dK + dV of all of it would
// be 256 registers a thread): each sums Sᵀ and dPᵀ over its half, they
// swap the partial sums through shared memory (a + b = b + a: both warps
// hold the same bits), and each accumulates its half of dK and dV.

template <int DM>
struct KvCfg {
  static constexpr int DSPLIT = DM > 128 ? 2 : 1;
  static constexpr int WARPS = 8;
  static constexpr int BK = 128 / DSPLIT;            // keys a CTA
  static constexpr int KBN = BK / 16;                // key blocks of 16
  static constexpr int BQ = 32;                      // query rows a step
  static constexpr int NC = DM / 8 / DSPLIT;         // column tiles a warp
  static constexpr int KF = DM / 16 / DSPLIT + DSPLIT - 1;  // k-steps a warp
  // CTAs an SM the registers must allow (occupancy hides the mma latency)
  static constexpr int MINB = DM <= 80 ? 2 : 1;
};

template <int DM>
__global__ void __launch_bounds__(32 * KvCfg<DM>::WARPS, KvCfg<DM>::MINB)
swa_bwd_tc_dkv_kernel(Args a) {
  using C = KvCfg<DM>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = BQ / 8, NC = C::NC, NS = 3;
  constexpr int NTH = 32 * C::WARPS;
  const int P = a.P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);     // [BK][P]
  bf16* vs = ks + BK * P;                       // [BK][P]
  bf16* qs = vs + BK * P;                       // [NS][BQ][P]
  bf16* dos = qs + NS * BQ * P;                 // [NS][BQ][P]
  float* ls = reinterpret_cast<float*>(dos + NS * BQ * P);  // [NS][BQ]
  float* dds = ls + NS * BQ;                                 // [NS][BQ]
  float* xch = dds + NS * BQ;         // DSPLIT 2: [WARPS][2][NT][4][32]
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4, kb = w % C::KBN, dh = w / C::KBN;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV), k0 = blockIdx.x * BK;
  // this warp's head-dim columns [c0, c1): both phase 1's k range and its
  // share of dK / dV (a multiple of 16 apart)
  const int half = (a.Dp / 16 + 1) / 2 * 16;
  const int c0 = C::DSPLIT == 1 ? 0 : dh * half;
  const int c1 = C::DSPLIT == 1 ? a.Dp : (dh ? a.Dp : half);
  zero_pad<NTH>(ks, P, 2 * BK + 2 * NS * BQ, a.hd, a.Dp);  // ks .. dos
  __syncthreads();
  stage<NTH>(ks, P, a.k + b * a.sk[0] + kvh * a.sk[2], a.sk[1], k0, BK, a.Sk,
             a.hd, a.vk);
  stage<NTH>(vs, P, a.v + b * a.sv[0] + kvh * a.sv[2], a.sv[1], k0, BK, a.Sk,
             a.hd, a.vv);
  const bf16* qbase = a.q + b * a.sq[0] + h * a.sq[2];
  const bf16* dobase = a.dO + ((long long)b * a.Sq * a.H + h) * a.hd;
  const long long dors = (long long)a.H * a.hd;
  const float* lrow = a.lse + (long long)bh * a.Sq;
  const float* drow = a.dd + (long long)bh * a.Sq;
  int i_lo, i_hi;
  query_rows(a, k0, BK, i_lo, i_hi);
  const int t_lo = i_lo / BQ, t_hi = i_hi > i_lo ? (i_hi + BQ - 1) / BQ
                                                  : t_lo;
  auto load_q = [&](int t, int buf) {
    stage<NTH>(qs + buf * BQ * P, P, qbase, a.sq[1], t * BQ, BQ, a.Sq, a.hd,
               a.vq);
    stage<NTH>(dos + buf * BQ * P, P, dobase, dors, t * BQ, BQ, a.Sq, a.hd,
               a.vo);
    // the rows' lse and D by cp.async as well (0 past Sq): a plain load
    // here would hold every warp at the next barrier for its latency
    for (int r = tid; r < BQ; r += NTH) {
      const int i = t * BQ + r;
      cp_async(ls + buf * BQ + r, lrow + (i < a.Sq ? i : 0), 4, i < a.Sq);
      cp_async(dds + buf * BQ + r, drow + (i < a.Sq ? i : 0), 4, i < a.Sq);
    }
  };
  // an NS-stage pipeline of query tiles: one cp.async group a tile (K and
  // V ride in the first)
  for (int t = t_lo; t < t_lo + NS - 1; ++t) {
    if (t < t_hi) load_q(t, t - t_lo);
    cp_commit();
  }
  const float sl2 = a.scale * kLog2e;
  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int x = 0; x < NC; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[x][e] = dv[x][e] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) % NS;
    if (t + NS - 1 < t_hi) load_q(t + NS - 1, (t + NS - 1 - t_lo) % NS);
    cp_commit();
    cp_wait_stage<NS>();
    __syncthreads();
    const bf16* qt = qs + buf * BQ * P;
    const bf16* dot = dos + buf * BQ * P;
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int x = 0; x < C::KF; ++x) {
      const int kk = c0 + 16 * x;
      if (kk >= c1) break;
      uint32_t ak[4], av[4];
      frag_a(ak, ks, P, kb * 16, kk, lane);
      frag_a(av, vs, P, kb * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bq[4], bo[4];
        frag_b_nk(bq, qt, P, n * 8, kk, lane);
        frag_b_nk(bo, dot, P, n * 8, kk, lane);
        mma16(st[n], ak, bq[0], bq[1]);
        mma16(st[n + 1], ak, bq[2], bq[3]);
        mma16(dpt[n], av, bo[0], bo[1]);
        mma16(dpt[n + 1], av, bo[2], bo[3]);
      }
    }
    if (C::DSPLIT == 2) {                 // the partner's half of the sums
      float* mine = xch + w * 2 * NT * 128 + lane;
      const float* other =
          xch + ((w + C::KBN) % C::WARPS) * 2 * NT * 128 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(n * 4 + e) * 32] = st[n][e];
          mine[((NT + n) * 4 + e) * 32] = dpt[n][e];
        }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[n][e] += other[(n * 4 + e) * 32];
          dpt[n][e] += other[((NT + n) * 4 + e) * 32];
        }
    }
    // P and dS of keys (g, g + 8) x the tile's queries (2t, 2t + 1 of each
    // column tile), with the queries' lse and D
    // the lse and D of this thread's query columns (2t, 2t + 1 of each
    // column tile), read once a tile
    float2 lc[NT], dc[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      lc[n] = *reinterpret_cast<const float2*>(ls + buf * BQ + n * 8 + 2 * t4);
      dc[n] = *reinterpret_cast<const float2*>(dds + buf * BQ + n * 8 + 2 * t4);
    }
    const bool full = tile_full(a, t * BQ, BQ, k0 + kb * 16, 16);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = n * 8 + 2 * t4 + (e & 1);
        const int j = k0 + kb * 16 + g + 8 * (e >> 1);
        const float li = e & 1 ? lc[n].y : lc[n].x;
        const float di = e & 1 ? dc[n].y : dc[n].x;
        const float p = full || kept(a, t * BQ + ii, j)
                            ? ex2(st[n][e] * sl2 - li) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - di);
      }
    uint32_t pa[NT / 2][4], dsa[NT / 2][4];
    to_a<NT>(pa, st);
    to_a<NT>(dsa, dpt);
#pragma unroll
    for (int kq = 0; kq < NT / 2; ++kq) {
#pragma unroll
      for (int x = 0; x < NC; x += 2) {
        const int col = c0 + 8 * x;
        if (col >= c1) break;
        uint32_t bo[4], bq[4];
        frag_b_kn(bo, dot, P, kq * 16, col, lane);
        frag_b_kn(bq, qt, P, kq * 16, col, lane);
        mma16(dv[x], pa[kq], bo[0], bo[1]);
        mma16(dv[x + 1], pa[kq], bo[2], bo[3]);
        mma16(dk[x], dsa[kq], bq[0], bq[1]);
        mma16(dk[x + 1], dsa[kq], bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_wait_all();
  // rows: keys k0 + 16·kb..; the output is (B, Sk, heads, hd) with heads =
  // KV (written in place) or H (the workspace of a GQA / MQA call)
  const int oh = a.ws_heads == a.H ? h : kvh;
  const long long rs = (long long)a.ws_heads * a.hd;
  const long long base = ((long long)b * a.Sk * a.ws_heads + oh) * a.hd +
                         (long long)k0 * rs;
  const int nrows = a.Sk - k0;
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    const int col = c0 + 8 * x;
    if (col >= c1) break;
    store_c(a.dk + base, rs, dk[x], kb * 16, col, nrows, a.hd, a.scale, lane);
    store_c(a.dv + base, rs, dv[x], kb * 16, col, nrows, a.hd, 1.f, lane);
  }
}

// --- (c) dQ ------------------------------------------------------------------------
// A warp owns 16 query rows of the CTA's 64 and walks the key tiles that
// its tile sees: S and dP (rows: its queries), dS in registers, dQ += dS K
// straight from them.

template <int DM>
struct QCfg {
  static constexpr int BQ = 128;                     // 8 warps of 16 rows
  static constexpr int BK = 32;                      // keys a step
  static constexpr int NC = DM / 8;
  static constexpr int MINB = DM <= 80 ? 2 : 1;      // CTAs an SM
  static constexpr int NS = DM == 256 ? 2 : 3;       // pipeline stages
};

template <int DM>
__global__ void __launch_bounds__(256, QCfg<DM>::MINB)
swa_bwd_tc_dq_kernel(Args a) {
  using C = QCfg<DM>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = BK / 8, NC = C::NC;
  constexpr int NS = C::NS;
  const int P = a.P;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);     // [BQ][P]
  bf16* dos = qs + BQ * P;                      // [BQ][P]
  bf16* ks = dos + BQ * P;                      // [NS][BK][P]
  bf16* vs = ks + NS * BK * P;                  // [NS][BK][P]
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV), q0 = blockIdx.x * BQ, r0 = w * 16;
  zero_pad<256>(qs, P, 2 * BQ + 2 * NS * BK, a.hd, a.Dp);  // qs .. vs
  __syncthreads();
  stage<256>(qs, P, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], q0, BQ, a.Sq,
             a.hd, a.vq);
  stage<256>(dos, P, a.dO + ((long long)b * a.Sq * a.H + h) * a.hd,
             (long long)a.H * a.hd, q0, BQ, a.Sq, a.hd, a.vo);
  float lr[2], dr[2];                   // rows g, g + 8: lse (log2), D
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = q0 + r0 + g + 8 * hr;
    lr[hr] = i < a.Sq ? a.lse[(long long)bh * a.Sq + i] : 0.f;
    dr[hr] = i < a.Sq ? a.dd[(long long)bh * a.Sq + i] : 0.f;
  }
  const bf16* kbase = a.k + b * a.sk[0] + kvh * a.sk[2];
  const bf16* vbase = a.v + b * a.sv[0] + kvh * a.sv[2];
  int t_lo, t_hi;
  key_tiles(a, q0, BQ, BK, t_lo, t_hi);
  auto load_kv = [&](int t, int buf) {
    stage<256>(ks + buf * BK * P, P, kbase, a.sk[1], t * BK, BK, a.Sk, a.hd,
               a.vk);
    stage<256>(vs + buf * BK * P, P, vbase, a.sv[1], t * BK, BK, a.Sk, a.hd,
               a.vv);
  };
  // an NS-stage pipeline of key tiles: one cp.async group a tile (Q and dO
  // ride in the first)
  for (int t = t_lo; t < t_lo + NS - 1; ++t) {
    if (t < t_hi) load_kv(t, t - t_lo);
    cp_commit();
  }
  const float sl2 = a.scale * kLog2e;
  float dq[NC][4];
#pragma unroll
  for (int x = 0; x < NC; ++x) dq[x][0] = dq[x][1] = dq[x][2] = dq[x][3] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) % NS;
    if (t + NS - 1 < t_hi) load_kv(t + NS - 1, (t + NS - 1 - t_lo) % NS);
    cp_commit();
    cp_wait_stage<NS>();
    __syncthreads();
    const bf16* kt = ks + buf * BK * P;
    const bf16* vt = vs + buf * BK * P;
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int x = 0; x < DM / 16; ++x) {
      const int kk = 16 * x;
      if (kk >= a.Dp) break;
      uint32_t aq[4], ado[4];
      frag_a(aq, qs, P, r0, kk, lane);
      frag_a(ado, dos, P, r0, kk, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4], bv[4];
        frag_b_nk(bk, kt, P, n * 8, kk, lane);
        frag_b_nk(bv, vt, P, n * 8, kk, lane);
        mma16(s[n], aq, bk[0], bk[1]);
        mma16(s[n + 1], aq, bk[2], bk[3]);
        mma16(dp[n], ado, bv[0], bv[1]);
        mma16(dp[n + 1], ado, bv[2], bv[3]);
      }
    }
    const bool full = tile_full(a, q0 + r0, 16, t * BK, BK);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1, i = q0 + r0 + g + 8 * hr;
        const int j = t * BK + n * 8 + 2 * t4 + (e & 1);
        const float p = full || kept(a, i, j)
                            ? ex2(s[n][e] * sl2 - lr[hr]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dr[hr]);
      }
    uint32_t dsa[NT / 2][4];
    to_a<NT>(dsa, dp);
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
      for (int x = 0; x < NC; x += 2) {
        if (8 * x >= a.Dp) break;
        uint32_t bk[4];
        frag_b_kn(bk, kt, P, kc * 16, 8 * x, lane);
        mma16(dq[x], dsa[kc], bk[0], bk[1]);
        mma16(dq[x + 1], dsa[kc], bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  cp_wait_all();
  const long long rs = (long long)a.H * a.hd;
  float* dqb = a.dq + ((long long)b * a.Sq * a.H + h) * a.hd +
               (long long)q0 * rs;
#pragma unroll
  for (int x = 0; x < NC; ++x) {
    if (8 * x >= a.Dp) break;
    store_c(dqb, rs, dq[x], r0, 8 * x, a.Sq - q0, a.hd, a.scale, lane);
  }
}

// --- (d) the GQA / MQA group sum ------------------------------------------------
// dk[b, s, kvh, :] = Σ_{g < H/KV} ws[b, s, kvh·G + g, :], in head order

__global__ void swa_bwd_tc_group_sum_kernel(const float* wk, const float* wv,
                                            float* dk, float* dv,
                                            long long rows, int KV, int G,
                                            int hd) {
  const long long n = rows * KV * hd;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(e % hd);
    const long long rk = e / hd;          // (b·Sk + s)·KV + kvh
    const int kvh = (int)(rk % KV);
    const long long src = ((rk / KV) * KV * G + (long long)kvh * G) * hd + d;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += wk[src + (long long)g * hd];
      sv += wv[src + (long long)g * hd];
    }
    dk[e] = sk;
    dv[e] = sv;
  }
}

// shared-memory bytes of each pass at row pitch P (bf16 elements)
template <int DM>
int rows_smem(int P) {
  return (128 + (DM == 256 ? 2 : 3) * 64) * P * 2;
}
template <int DM>
int dkv_smem(int P) {
  using C = KvCfg<DM>;
  return (2 * C::BK + 6 * C::BQ) * P * 2 + 6 * C::BQ * 4 +
         (C::DSPLIT == 2 ? C::WARPS * 2 * (C::BQ / 8) * 128 * 4 : 0);
}
template <int DM>
int dq_smem(int P) {
  return (2 * QCfg<DM>::BQ + 2 * QCfg<DM>::NS * QCfg<DM>::BK) * P * 2;
}

// cudaFuncSetAttribute once per device, for DM's largest pitch (DM + 8)
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long& configured) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && (configured >> dev & 1)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) configured |= 1ull << dev;
  return e;
}

// A second stream per device, and two events, for running (b) beside (c):
// both only read what (a) wrote, so running them together changes no bit
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t rows_done = nullptr, dkv_done = nullptr;
};

cudaError_t side_of(Side*& out) {
  static Side sides[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  Side& sd = sides[dev];
  if (!sd.stream) {
    e = cudaStreamCreateWithFlags(&sd.stream, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.rows_done, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&sd.dkv_done, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
  }
  out = &sd;
  return cudaSuccess;
}

template <int DM>
cudaError_t launch_d(const Args& a, int B, const float* wk, const float* wv,
                     float* dk, float* dv, cudaStream_t stream) {
  static unsigned long long ca = 0, cb = 0, cc = 0;
  cudaError_t e = allow_smem(swa_bwd_tc_rows_kernel<DM>,
                             rows_smem<DM>(DM + 8), ca);
  if (e == cudaSuccess)
    e = allow_smem(swa_bwd_tc_dkv_kernel<DM>, dkv_smem<DM>(DM + 8), cb);
  if (e == cudaSuccess)
    e = allow_smem(swa_bwd_tc_dq_kernel<DM>, dq_smem<DM>(DM + 8), cc);
  if (e != cudaSuccess) return e;
  const int sa = rows_smem<DM>(a.P), sb = dkv_smem<DM>(a.P),
            sc = dq_smem<DM>(a.P);
  const int nq = (a.Sq + 127) / 128;     // (a) and (c): 128-row tiles
  const int nk = (a.Sk + KvCfg<DM>::BK - 1) / KvCfg<DM>::BK;
  Side* sd = nullptr;
  e = side_of(sd);
  if (e != cudaSuccess) return e;
  swa_bwd_tc_rows_kernel<DM><<<dim3(nq, B * a.H), kRowThreads, sa,
                               stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // (b) on the side stream once (a) is done, (c) on the caller's; the
  // caller's stream then waits for (b)
  e = cudaEventRecord(sd->rows_done, stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(sd->stream, sd->rows_done, 0);
  if (e != cudaSuccess) return e;
  swa_bwd_tc_dkv_kernel<DM><<<dim3(nk, B * a.H), 32 * KvCfg<DM>::WARPS, sb,
                              sd->stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  swa_bwd_tc_dq_kernel<DM><<<dim3(nq, B * a.H), 256, sc, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(sd->dkv_done, sd->stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(stream, sd->dkv_done, 0);
  if (e != cudaSuccess || a.ws_heads == a.KV) return e;
  const long long rows = (long long)B * a.Sk;
  const long long n = rows * a.KV * a.hd;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  swa_bwd_tc_group_sum_kernel<<<blocks, 256, 0, stream>>>(
      wk, wv, dk, dv, rows, a.KV, a.H / a.KV, a.hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared-memory bytes of pass (a), (b) or (c) (pass 0, 1, 2) at head
// dim hd (0 outside 1..256).
int swa_attention_bwd_tc_smem(int hd, int pass) {
  if (hd <= 0 || hd > 256 || pass < 0 || pass > 2) return 0;
  const int Dp = (hd + 15) / 16 * 16, P = Dp + 8;
  auto of = [&](auto dm) {
    constexpr int DM = decltype(dm)::value;
    return pass == 0 ? rows_smem<DM>(P) : pass == 1 ? dkv_smem<DM>(P)
                                                    : dq_smem<DM>(P);
  };
  if (Dp <= 64) return of(std::integral_constant<int, 64>());
  if (Dp <= 80) return of(std::integral_constant<int, 80>());
  if (Dp <= 128) return of(std::integral_constant<int, 128>());
  return of(std::integral_constant<int, 256>());
}

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd) bf16, last dim contiguous;
// dO (B, Sq, H, hd) bf16 and o (B, Sq, H, hd) fp32, contiguous; lse and
// dd: B·H·Sq floats each; dq (B, Sq, H, hd), dk and dv (B, Sk, KV, hd)
// fp32 contiguous; wk and wv: B·Sk·H·hd floats each when H > KV (the
// per-query-head partials), else unused. prm: element strides (b, s, h)
// of q [0..2], k [3..5], v [6..8], then B, Sq, Sk, H, KV, hd, window
// (<= 0: none), causal. The scale is 1/sqrt(hd). Returns the CUDA error
// of the launches.
int swa_attention_bwd_tc_launch(const void* q, const void* k, const void* v,
                                const void* dO, const void* o, void* lse,
                                void* dd, void* dq, void* dk, void* dv,
                                void* wk, void* wv, const long long* prm,
                                void* stream) {
  const int B = (int)prm[9], Sq = (int)prm[10], Sk = (int)prm[11],
            H = (int)prm[12], KV = (int)prm[13], hd = (int)prm[14];
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dO = static_cast<const bf16*>(dO);
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<float*>(lse);
  a.dd = static_cast<float*>(dd);
  a.dq = static_cast<float*>(dq);
  const bool grouped = H != KV;
  a.dk = static_cast<float*>(grouped ? wk : dk);
  a.dv = static_cast<float*>(grouped ? wv : dv);
  a.ws_heads = grouped ? H : KV;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = prm[i];
    a.sk[i] = prm[3 + i];
    a.sv[i] = prm[6 + i];
  }
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.hd = hd;
  a.Dp = (hd + 15) / 16 * 16;
  a.P = a.Dp + 8;                         // rows 16·odd bytes apart
  a.window = (int)prm[15];
  a.causal = (int)prm[16];
  a.scale = (float)(1.0 / sqrt((double)hd));
  const long long dstride[1] = {(long long)H * hd};
  a.vq = tf32x3::copy_width(q, a.sq, 3, hd * 2, 2);
  a.vk = tf32x3::copy_width(k, a.sk, 3, hd * 2, 2);
  a.vv = tf32x3::copy_width(v, a.sv, 3, hd * 2, 2);
  a.vo = tf32x3::copy_width(dO, dstride, 1, hd * 2, 2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fwk = static_cast<const float*>(wk);
  const float* fwv = static_cast<const float*>(wv);
  float* fdk = static_cast<float*>(dk);
  float* fdv = static_cast<float*>(dv);
  if (a.Dp <= 64) return (int)launch_d<64>(a, B, fwk, fwv, fdk, fdv, s);
  if (a.Dp <= 80) return (int)launch_d<80>(a, B, fwk, fwv, fdk, fdv, s);
  if (a.Dp <= 128) return (int)launch_d<128>(a, B, fwk, fwv, fdk, fdv, s);
  return (int)launch_d<256>(a, B, fwk, fwv, fdk, fdv, s);
}

}  // extern "C"
