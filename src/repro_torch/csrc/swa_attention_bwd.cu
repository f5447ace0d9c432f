// Sliding-window flash attention, backward, for Hopper (sm_90a): the
// backward of `kernels/swa_attention.py`'s `SwaAttentionFn`.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// attention (`jax.vjp` of src/repro/kernels/ref.py:23, `swa_attention_ref`),
// while the port's forward on the card is a kernel whose output has no
// autograd graph. This computes the same gradients:
//   S = scale · Q Kᵀ (masked -1e30), P = exp(S - lse), D_i = Σ_d dO_i O_i,
//   dP = dO Vᵀ, dS = P ⊙ (dP - D),
//   dQ = scale · dS K, dK = scale · dSᵀ Q, dV = Pᵀ dO,
// with query i at qpos = i + (Sk - Sq), key j kept where j <= qpos
// (causal) and j > qpos - window (window > 0), and dK, dV summed over the
// H/KV query heads of each kv head. Inputs q (fp32 or bf16), k and v (one
// type, fp32 or bf16), o and dO fp32; every output fp32, every sum fp32.
//
// What bounds it on this card: operations. At Zamba2's shape (B = 4,
// S = 2048, H = 32, hd = 64, causal) the least work is the four products
// of a backward, 2.5 × the forward's 68.7 GFLOP = 172 GFLOP: 0.17 ms at
// the 989 TFLOP/s of bf16 tensor cores, 2.6 ms at the 67 TFLOP/s of fp32
// on the CUDA cores. This first version is plain SIMT fp32 (FFMA), with
// no tensor cores; it recomputes S three times and dP twice (16·hd FLOPs
// per kept pair instead of 10·hd) so that no kernel needs another's
// partial sums, and it uses no atomics: every output element is summed
// by one thread in a fixed order, so a call is repeatable bit for bit.
//
// Three kernels, one stream, in order:
// (a) per (query tile, batch·head): the row log-sum-exp of the masked
//     scores (one thread a row, over the tile's scores staged in shared
//     memory) and D (a warp a row);
// (b) per (key tile, batch·kv head): loops over the H/KV query heads of
//     the group and the query tiles that see the key tile, and keeps
//     that tile's dK and dV in registers: this sums GQA / MQA groups
//     without atomics;
// (c) per (query tile, batch·head): loops over the key tiles the tile
//     sees and keeps its dQ in registers.
// Tiles (query rows BQ x keys BK) shrink with the padded head dim D
// (64, 128 or 256), so a thread holds at most 32 accumulators of dK and
// dV together: a 64-row fp32 tile of dK alone at hd 256 would be 64
// registers a thread. Shared memory holds fp32 rows at a pitch of D + 1
// words, so a warp's column reads fall in distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;             // 16 x 16 thread grid

struct Strides {                          // element strides of (b, s, h)
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* o;                         // (B, Sq, H, hd) contiguous
  const float* dO;                        // (B, Sq, H, hd) contiguous
  float* lse;                             // (B·H, Sq) workspace
  float* dd;                              // (B·H, Sq) workspace: D
  float* dq;                              // (B, Sq, H, hd) contiguous
  float* dk;                              // (B, Sk, KV, hd) contiguous
  float* dv;                              // (B, Sk, KV, hd) contiguous
  Strides sq, sk, sv;
  int H, KV, Sq, Sk, hd, window, causal, q_bf16, kv_bf16;
  float scale;
};

template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BQ = 64, BK = 64;
};
template <>
struct Tile<128> {
  static constexpr int BQ = 64, BK = 32;
};
template <>
struct Tile<256> {
  static constexpr int BQ = 32, BK = 16;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// rows [r0, r0 + R) of a (rows, hd) slab at `base` (row stride `rs`) into
// dst[R][D + 1] as fp32; rows past `nrows` and columns past hd are 0
__device__ __forceinline__ void stage(float* dst, int D, const void* src,
                                      int bf16, long long base, long long rs,
                                      int r0, int R, int nrows, int hd) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D, row = r0 + r;
    dst[r * (D + 1) + d] =
        (row < nrows && d < hd) ? ld(src, base + row * rs + d, bf16) : 0.f;
  }
}

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
  if (i >= a.Sq || j >= a.Sk) return false;
  const int qp = i + a.Sk - a.Sq;
  if (a.causal && j > qp) return false;
  return a.window <= 0 || j > qp - a.window;
}

// key tiles [t_lo, t_hi) holding a kept key for some row of [q0, q0 + BQ)
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

// S (and dP) of a (BQ x BK) tile: thread (rg, cg) holds rows rg + 16r and
// keys cg + 16c
template <int D, bool DP>
__device__ __forceinline__ void scores(const Args& a, const float* qs,
                                       const float* dos, const float* ks,
                                       const float* vs,
                                       float (&s)[Tile<D>::BQ / 16]
                                                 [Tile<D>::BK / 16],
                                       float (&dp)[Tile<D>::BQ / 16]
                                                  [Tile<D>::BK / 16]) {
  constexpr int TR = Tile<D>::BQ / 16, TC = Tile<D>::BK / 16, P = D + 1;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < a.hd; ++d) {
    float qa[TR], kb[TC];
#pragma unroll
    for (int r = 0; r < TR; ++r) qa[r] = qs[(rg + 16 * r) * P + d];
#pragma unroll
    for (int c = 0; c < TC; ++c) kb[c] = ks[(cg + 16 * c) * P + d];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) s[r][c] = fmaf(qa[r], kb[c], s[r][c]);
    if (DP) {
#pragma unroll
      for (int r = 0; r < TR; ++r) qa[r] = dos[(rg + 16 * r) * P + d];
#pragma unroll
      for (int c = 0; c < TC; ++c) kb[c] = vs[(cg + 16 * c) * P + d];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) dp[r][c] = fmaf(qa[r], kb[c], dp[r][c]);
    }
  }
}

// P and dS of a tile into ps / dss ([BQ][BK + 1]; ps may be null)
template <int D>
__device__ __forceinline__ void probs(const Args& a, int q0, int k0,
                                      const float* ls, const float* dds,
                                      const float* qs, const float* dos,
                                      const float* ks, const float* vs,
                                      float* ps, float* dss) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int TR = BQ / 16, TC = BK / 16;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  float s[TR][TC], dp[TR][TC];
  scores<D, true>(a, qs, dos, ks, vs, s, dp);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = rg + 16 * r;
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = cg + 16 * c;
      const float p = kept(a, q0 + row, k0 + col)
                          ? expf(s[r][c] * a.scale - ls[row])
                          : 0.f;
      if (ps) ps[row * (BK + 1) + col] = p;
      dss[row * (BK + 1) + col] = p * (dp[r][c] - dds[row]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_bwd_lse_kernel(Args a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, P = D + 1;
  constexpr int TR = BQ / 16, TC = BK / 16;
  extern __shared__ float sm[];
  float* qs = sm;                         // [BQ][P]
  float* ks = qs + BQ * P;                // [BK][P]
  float* ss = ks + BK * P;                // [BQ][BK + 1]
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV), q0 = blockIdx.x * BQ;
  stage(qs, D, a.q, a.q_bf16, b * a.sq.b + h * a.sq.h, a.sq.s, q0, BQ, a.Sq,
        a.hd);
  float m = kNeg, l = 0.f;                // the row's, for tid < BQ
  int t_lo, t_hi;
  key_tiles(a, q0, BQ, BK, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();
    stage(ks, D, a.k, a.kv_bf16, b * a.sk.b + kvh * a.sk.h, a.sk.s, t * BK,
          BK, a.Sk, a.hd);
    __syncthreads();
    float s[TR][TC], unused[TR][TC];
    scores<D, false>(a, qs, nullptr, ks, nullptr, s, unused);
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int row = rg + 16 * r, col = cg + 16 * c;
        ss[row * (BK + 1) + col] =
            kept(a, q0 + row, t * BK + col) ? s[r][c] * a.scale : kNeg;
      }
    __syncthreads();
    if (tid < BQ) {
      for (int c = 0; c < BK; ++c) {
        const float x = ss[tid * (BK + 1) + c];
        if (x <= 0.5f * kNeg) continue;
        if (x > m) {
          l = l * expf(m - x) + 1.f;
          m = x;
        } else {
          l += expf(x - m);
        }
      }
    }
  }
  if (tid < BQ && q0 + tid < a.Sq)
    a.lse[(long long)bh * a.Sq + q0 + tid] = l > 0.f ? m + logf(l) : 0.f;
  // D_i = Σ_d dO_i · O_i: a warp a row, lanes over d
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    const int i = q0 + r;
    if (i >= a.Sq) break;
    const long long base = ((long long)(b * a.Sq + i) * a.H + h) * a.hd;
    float acc = 0.f;
    for (int d = lane; d < a.hd; d += 32) acc += a.dO[base + d] * a.o[base + d];
#pragma unroll
    for (int w = 16; w > 0; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) a.dd[(long long)bh * a.Sq + i] = acc;
  }
}

// the lse and D of rows [q0, q0 + BQ) into ls, dds (0 past Sq)
template <int D>
__device__ __forceinline__ void stage_rows(const Args& a, long long bh,
                                           int q0, float* ls, float* dds) {
  constexpr int BQ = Tile<D>::BQ;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int i = q0 + r;
    ls[r] = i < a.Sq ? a.lse[bh * a.Sq + i] : 0.f;
    dds[r] = i < a.Sq ? a.dd[bh * a.Sq + i] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dkv_kernel(Args a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, P = D + 1;
  constexpr int KJ = BK / 16, KD = D / 16;
  extern __shared__ float sm[];
  float* qs = sm;                         // [BQ][P]
  float* dos = qs + BQ * P;               // [BQ][P]
  float* ks = dos + BQ * P;               // [BK][P]
  float* vs = ks + BK * P;                // [BK][P]
  float* ps = vs + BK * P;                // [BQ][BK + 1]
  float* dss = ps + BQ * (BK + 1);        // [BQ][BK + 1]
  float* ls = dss + BQ * (BK + 1);        // [BQ]
  float* dds = ls + BQ;                   // [BQ]
  const int tid = threadIdx.x, jg = tid / 16, dg = tid % 16;
  const int bkv = blockIdx.y, b = bkv / a.KV, kvh = bkv % a.KV;
  const int k0 = blockIdx.x * BK, G = a.H / a.KV;
  stage(ks, D, a.k, a.kv_bf16, b * a.sk.b + kvh * a.sk.h, a.sk.s, k0, BK,
        a.Sk, a.hd);
  stage(vs, D, a.v, a.kv_bf16, b * a.sv.b + kvh * a.sv.h, a.sv.s, k0, BK,
        a.Sk, a.hd);
  float dk[KJ][KD], dv[KJ][KD];
#pragma unroll
  for (int j = 0; j < KJ; ++j)
#pragma unroll
    for (int m = 0; m < KD; ++m) dk[j][m] = dv[j][m] = 0.f;
  int i_lo, i_hi;
  query_rows(a, k0, BK, i_lo, i_hi);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long bh = (long long)b * a.H + h;
    for (int q0 = i_lo / BQ * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();
      stage(qs, D, a.q, a.q_bf16, b * a.sq.b + h * a.sq.h, a.sq.s, q0, BQ,
            a.Sq, a.hd);
      stage(dos, D, a.dO, 0, ((long long)b * a.Sq * a.H + h) * a.hd,
            (long long)a.H * a.hd, q0, BQ, a.Sq, a.hd);
      stage_rows<D>(a, bh, q0, ls, dds);
      __syncthreads();
      probs<D>(a, q0, k0, ls, dds, qs, dos, ks, vs, ps, dss);
      __syncthreads();
      // dV += Pᵀ dO, dK += dSᵀ Q over the tile's rows
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pj[KJ], sj[KJ];
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          pj[j] = ps[r * (BK + 1) + jg + 16 * j];
          sj[j] = dss[r * (BK + 1) + jg + 16 * j];
        }
#pragma unroll
        for (int m = 0; m < KD; ++m) {
          const float o = dos[r * P + dg + 16 * m], x = qs[r * P + dg + 16 * m];
#pragma unroll
          for (int j = 0; j < KJ; ++j) {
            dv[j][m] = fmaf(pj[j], o, dv[j][m]);
            dk[j][m] = fmaf(sj[j], x, dk[j][m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KJ; ++j) {
    const int key = k0 + jg + 16 * j;
    if (key >= a.Sk) continue;
    const long long base = ((long long)(b * a.Sk + key) * a.KV + kvh) * a.hd;
#pragma unroll
    for (int m = 0; m < KD; ++m) {
      const int d = dg + 16 * m;
      if (d < a.hd) {
        a.dk[base + d] = dk[j][m] * a.scale;
        a.dv[base + d] = dv[j][m];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dq_kernel(Args a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, P = D + 1;
  constexpr int QI = BQ / 16, QD = D / 16;
  extern __shared__ float sm[];
  float* qs = sm;                         // [BQ][P]
  float* dos = qs + BQ * P;               // [BQ][P]
  float* ks = dos + BQ * P;               // [BK][P]
  float* vs = ks + BK * P;                // [BK][P]
  float* dss = vs + BK * P;               // [BQ][BK + 1]
  float* ls = dss + BQ * (BK + 1);        // [BQ]
  float* dds = ls + BQ;                   // [BQ]
  const int tid = threadIdx.x, ig = tid / 16, dg = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV), q0 = blockIdx.x * BQ;
  stage(qs, D, a.q, a.q_bf16, b * a.sq.b + h * a.sq.h, a.sq.s, q0, BQ, a.Sq,
        a.hd);
  stage(dos, D, a.dO, 0, ((long long)b * a.Sq * a.H + h) * a.hd,
        (long long)a.H * a.hd, q0, BQ, a.Sq, a.hd);
  stage_rows<D>(a, bh, q0, ls, dds);
  float dq[QI][QD];
#pragma unroll
  for (int i = 0; i < QI; ++i)
#pragma unroll
    for (int m = 0; m < QD; ++m) dq[i][m] = 0.f;
  int t_lo, t_hi;
  key_tiles(a, q0, BQ, BK, t_lo, t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    __syncthreads();
    stage(ks, D, a.k, a.kv_bf16, b * a.sk.b + kvh * a.sk.h, a.sk.s, t * BK,
          BK, a.Sk, a.hd);
    stage(vs, D, a.v, a.kv_bf16, b * a.sv.b + kvh * a.sv.h, a.sv.s, t * BK,
          BK, a.Sk, a.hd);
    __syncthreads();
    probs<D>(a, q0, t * BK, ls, dds, qs, dos, ks, vs, nullptr, dss);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[QI];
#pragma unroll
      for (int i = 0; i < QI; ++i) sv[i] = dss[(ig + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int m = 0; m < QD; ++m) {
        const float kv = ks[c * P + dg + 16 * m];
#pragma unroll
        for (int i = 0; i < QI; ++i) dq[i][m] = fmaf(sv[i], kv, dq[i][m]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QI; ++i) {
    const int row = q0 + ig + 16 * i;
    if (row >= a.Sq) continue;
    const long long base = ((long long)(b * a.Sq + row) * a.H + h) * a.hd;
#pragma unroll
    for (int m = 0; m < QD; ++m) {
      const int d = dg + 16 * m;
      if (d < a.hd) a.dq[base + d] = dq[i][m] * a.scale;
    }
  }
}

template <int D>
constexpr int lse_floats() {
  return (Tile<D>::BQ + Tile<D>::BK) * (D + 1) +
         Tile<D>::BQ * (Tile<D>::BK + 1);
}
template <int D>
constexpr int dkv_floats() {
  return 2 * (Tile<D>::BQ + Tile<D>::BK) * (D + 1) +
         2 * Tile<D>::BQ * (Tile<D>::BK + 1) + 2 * Tile<D>::BQ;
}
template <int D>
constexpr int dq_floats() {
  return 2 * (Tile<D>::BQ + Tile<D>::BK) * (D + 1) +
         Tile<D>::BQ * (Tile<D>::BK + 1) + 2 * Tile<D>::BQ;
}

// cudaFuncSetAttribute once per device for a kernel above 48 KB
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

template <int D>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int la = 4 * lse_floats<D>(), lb = 4 * dkv_floats<D>(),
                lc = 4 * dq_floats<D>();
  static unsigned long long ca = 0, cb = 0, cc = 0;
  cudaError_t e = allow_smem(swa_bwd_lse_kernel<D>, la, ca);
  if (e == cudaSuccess) e = allow_smem(swa_bwd_dkv_kernel<D>, lb, cb);
  if (e == cudaSuccess) e = allow_smem(swa_bwd_dq_kernel<D>, lc, cc);
  if (e != cudaSuccess) return e;
  const int nqt = (a.Sq + BQ - 1) / BQ, nkt = (a.Sk + BK - 1) / BK;
  swa_bwd_lse_kernel<D><<<dim3(nqt, B * a.H), kThreads, la, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  swa_bwd_dkv_kernel<D><<<dim3(nkt, B * a.KV), kThreads, lb, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  swa_bwd_dq_kernel<D><<<dim3(nqt, B * a.H), kThreads, lc, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), o and dO (B, Sq, H, hd) fp32
// contiguous; dq (B, Sq, H, hd), dk and dv (B, Sk, KV, hd) fp32 contiguous;
// lse and dd: B·H·Sq floats each. prm: element strides (b, s, h) of q
// [0..2], k [3..5], v [6..8] (the d stride is 1), then B, Sq, Sk, H, KV,
// hd, window (<= 0: none), causal, q_bf16, kv_bf16. The scale is
// 1/sqrt(hd). Returns the CUDA error of the launches.
int swa_attention_bwd_launch(const void* q, const void* k, const void* v,
                             const void* o, const void* dO, void* lse,
                             void* dd, void* dq, void* dk, void* dv,
                             const long long* prm, void* stream) {
  const int B = (int)prm[9], Sq = (int)prm[10], Sk = (int)prm[11],
            H = (int)prm[12], KV = (int)prm[13], hd = (int)prm[14];
  if (B <= 0 || Sq <= 0 || Sk < Sq || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = static_cast<const float*>(o);
  a.dO = static_cast<const float*>(dO);
  a.lse = static_cast<float*>(lse);
  a.dd = static_cast<float*>(dd);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.sq = {prm[0], prm[1], prm[2]};
  a.sk = {prm[3], prm[4], prm[5]};
  a.sv = {prm[6], prm[7], prm[8]};
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.hd = hd;
  a.window = (int)prm[15];
  a.causal = (int)prm[16];
  a.q_bf16 = (int)prm[17];
  a.kv_bf16 = (int)prm[18];
  a.scale = (float)(1.0 / sqrt((double)hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return (int)launch_d<64>(a, B, s);
  if (hd <= 128) return (int)launch_d<128>(a, B, s);
  return (int)launch_d<256>(a, B, s);
}

}  // extern "C"
