// Sliding-window flash attention, forward, for Hopper (sm_90a): the fp32
// route of `kernels/swa_attention.py`.
//
// Replaces the Pallas TPU kernel `swa_attention` (src/repro/kernels/
// swa_attention.py:73, body `_kernel` :26) for every input the bf16
// tensor-core route (swa_attention_tc.cu) does not take: fp32, or mixed
// fp32/bf16 q vs k/v, or a head dim other than 64/128, up to 256.
//   out[b, i, h] = softmax_k(q_i · k_k / sqrt(hd), masked) · v
// with query i at absolute position qpos = i + (Sk - Sq), key k kept where
// k < Sk, k <= qpos (causal) and k > qpos - window (window > 0). Output
// fp32, within 3e-5 of the plain version (fp32 arithmetic throughout).
//
// What bounds it on this card: operations. At Zamba2's fp32 prefill (B = 4,
// S = 2048, H = 32, hd = 64, causal) the two products are 4·hd FLOPs per
// kept (query, key) pair, 68.7 GFLOP: 1.03 ms at the 67 TFLOP/s of fp32 on
// the CUDA cores, where the first version of this kernel ran at 37 % of
// that and lost to PyTorch's SDPA.
//
// Units: the tensor cores, at fp32 accuracy by three TF32 terms per product
// (tf32x3.cuh): 3 x 68.7 GFLOP at 495 TFLOP/s TF32 is 0.42 ms, so even at a
// third of the TF32 rate the products beat the CUDA cores' peak. The
// operands are split in registers as they are read from shared memory, so
// shared memory holds the inputs as they come (fp32 or bf16). `mma.sync`
// m16n8k8 rather than `wgmma`: wgmma reads TF32 only K-major from shared
// memory, which V (keys x hd) is not, and its operands would have to be
// split into shared memory first; mma.sync takes both from registers.
//
// Design (FlashAttention-2's split of rows over warps):
// - A CTA of 8 warps owns 128 query rows (16 a warp) of one batch·head and
//   walks a range of key tiles (64 keys at hd <= 64, 32 to 192, else 16;
//   two CTAs an SM at hd <= 64; 4-warp CTAs of 64 rows were slower on the
//   card, also where the grid is small). K and V
//   tiles come by cp.async into a double buffer, so the next tile loads
//   while this one is computed; Q is staged once. k/v with KV < H heads are
//   read in place at kv head h / (H / KV).
// - S = Q·Kᵀ per warp (16 x BK) in fp32 registers; within a tile, the
//   8-key column groups that no row of the warp keeps (above its diagonal,
//   before its window) are skipped.
// - Mask (-1e30, never -inf) and an online softmax in base 2 (scores
//   scaled by scale·log2 e, ex2.approx); a masked key's p is 0, so a row
//   that has seen no kept key yet has l = 0 and acc = 0. Row max and sum
//   reduce over the 4 lanes of a row.
// - O += P·V: P's accumulator tile is the A operand of the next product
//   (the k permutation of tf32x3.cuh); V is read at rows 2t, 2t + 1.
// - Split-KV (flash-decoding): when the (query tile, batch·head) grid would
//   not fill the card (Zamba2's fp32 forward: 2 x 32 = 64 CTAs, the last
//   query tile walking 4 key tiles), the host picks `chunk` key tiles per
//   CTA (kernels/swa_attention.py, `swa_plan`); a query tile with more than
//   one chunk writes (m, l, acc) partials and a second kernel combines
//   them, 8 rows a CTA. (Combining in the tile's last CTA instead, behind
//   an atomic counter, saved the launch but was slower on the card: one
//   CTA then combines a whole tile.) The grid is (query tiles x most
//   chunks, batch·head); CTAs past their tile's chunk count exit at once.
#include <math.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr float kNeg = -1e30f;
constexpr int kMaxSplit = 64;             // chunks of one query tile, at most
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;          // query rows per CTA

struct Strides {                          // element strides of (b, s, h)
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  float* part;                            // partials, or null
  Strides sq, sk, sv, so;
  int H, KV, Sq, Sk, hd, window, causal;
  int chunk, nsplit, vq, vk;              // key tiles per CTA, most chunks
  float c;                                // scale · log2(e)
};

__host__ __device__ constexpr int block_k(int D) {
  return D == 64 ? 64 : D <= 192 ? 32 : 16;
}
// Row pitches (elements) that make the fragment reads conflict-free: Q and
// K are read two adjacent head-dim elements a lane (pitch ≡ 8 words mod
// 32), V one element from each of two rows (pitch ≡ 4 words mod 32 fp32).
__host__ __device__ constexpr int pitch_qk(int D) { return D + 8; }
template <typename T>
__host__ __device__ constexpr int pitch_v(int D) {
  return D + 16 / (int)sizeof(T);
}
template <typename TQ, typename TK>
__host__ __device__ constexpr int smem_bytes(int D) {
  return kBQ * pitch_qk(D) * (int)sizeof(TQ) +
         2 * block_k(D) * (pitch_qk(D) + pitch_v<TK>(D)) * (int)sizeof(TK);
}

// x0, x1 = p[0], p[1] (8 bytes fp32, 4 bytes bf16, aligned)
__device__ __forceinline__ void load2(const float* p, float& x0, float& x1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x0 = v.x;
  x1 = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& x0,
                                      float& x1) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  x0 = v.x;
  x1 = v.y;
}

// Key tiles [t_lo, t_hi) that hold a kept key for some row of query tile qt.
__device__ __forceinline__ void tile_range(const Args& a, int qt, int BK,
                                           int& t_lo, int& t_hi) {
  const int off = a.Sk - a.Sq, q0 = qt * kBQ;
  const int pmin = q0 + off, pmax = min(q0 + kBQ, a.Sq) - 1 + off;
  const int k_lo = a.window > 0 ? max(0, pmin - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Sk, pmax + 1) : a.Sk;
  t_lo = k_lo / BK;
  t_hi = max(t_lo + 1, (k_hi + BK - 1) / BK);
}

// Partials of (bh, qt, split): [kBQ][hd] acc, then [kBQ][2] (m, l).
__device__ __forceinline__ float* part_at(const Args& a, int bh, int qt,
                                          int sp) {
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const long long item = ((long long)bh * nqt + qt) * a.nsplit + sp;
  return a.part + item * kBQ * (a.hd + 2);
}

template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
swa_kernel(Args a) {
  constexpr int BK = block_k(D), NT = BK / 8, DT = D / 8;
  constexpr int PQ = pitch_qk(D), PK = pitch_qk(D), PV = pitch_v<TK>(D);
  extern __shared__ float4 smem4[];
  TQ* qs = reinterpret_cast<TQ*>(smem4);                      // [kBQ][PQ]
  TK* kbuf = reinterpret_cast<TK*>(qs + kBQ * PQ);            // [2][BK][PK]
  TK* vbuf = kbuf + 2 * BK * PK;                              // [2][BK][PV]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nsplit = a.nsplit;
  const int qt = blockIdx.x / nsplit, sp = blockIdx.x % nsplit;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = qt * kBQ, off = a.Sk - a.Sq;

  int t_lo, t_hi;
  tile_range(a, qt, BK, t_lo, t_hi);
  const int nchunks = (t_hi - t_lo + a.chunk - 1) / a.chunk;
  if (sp >= nchunks) return;
  const int c_lo = t_lo + sp * a.chunk;
  const int c_hi = min(t_hi, c_lo + a.chunk);

  const TQ* qg = static_cast<const TQ*>(a.q) + b * a.sq.b + h * a.sq.h;
  const TK* kg = static_cast<const TK*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const TK* vg = static_cast<const TK*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  auto ks_at = [&](int buf) { return kbuf + buf * BK * PK; };
  auto vs_at = [&](int buf) { return vbuf + buf * BK * PV; };

  // zero the columns [hd, D) that cp.async never writes: Q's and K's are
  // contracted over; V's only reach output columns that are not stored
  const int hd8 = (a.hd + 7) / 8 * 8;
  if (hd8 > a.hd) {
    for (int e = tid; e < kBQ * (hd8 - a.hd); e += kThreads)
      qs[(e / (hd8 - a.hd)) * PQ + a.hd + e % (hd8 - a.hd)] = TQ(0.f);
    for (int e = tid; e < 2 * BK * (hd8 - a.hd); e += kThreads)
      kbuf[(e / (hd8 - a.hd)) * PK + a.hd + e % (hd8 - a.hd)] = TK(0.f);
  }

  stage_rows<TQ, kThreads>(qs, PQ, qg, a.sq.s, q0, kBQ, a.Sq, a.hd, a.vq,
                           tid);
  auto stage_kv = [&](int tile, int buf) {
    stage_rows<TK, kThreads>(ks_at(buf), PK, kg, a.sk.s, tile * BK, BK,
                             a.Sk, a.hd, a.vk, tid);
    stage_rows<TK, kThreads>(vs_at(buf), PV, vg, a.sv.s, tile * BK, BK,
                             a.Sk, a.hd, a.vk, tid);
  };
  stage_kv(c_lo, 0);
  cp_commit();

  // this warp's rows and the positions they keep
  const int wrow = q0 + 16 * warp;
  const bool wactive = wrow < a.Sq;
  const int qmin = wrow + off, qmax = min(wrow + 15, a.Sq - 1) + off;
  const int pos0 = wrow + g + off, pos1 = pos0 + 8;

  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  for (int tile = c_lo; tile < c_hi; ++tile) {
    const int buf = (tile - c_lo) & 1;
    if (tile + 1 < c_hi) {
      stage_kv(tile + 1, buf ^ 1);
      cp_commit();
      cp_wait_1();
    } else {
      cp_wait_all();
    }
    __syncthreads();

    const int k0 = tile * BK;
    // does this warp keep any key of the tile (all of its 16 rows)?
    bool keeps = wactive;
    if (a.causal) keeps = keeps && k0 <= qmax;
    if (a.window > 0) keeps = keeps && k0 + BK - 1 > qmin - a.window;
    if (keeps) {
      const TK* ks = ks_at(buf);
      const TK* vs = vs_at(buf);
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;

      // S = Q·Kᵀ over the head dim, 8 at a time; within a k-step,
      // logical k = t is column 2t and k = t + 4 column 2t + 1, so each
      // lane reads its two values of a row in one load
      for (int d0 = 0; d0 < hd8; d0 += 8) {
        const TQ* qr = qs + (16 * warp + g) * PQ + d0 + 2 * t;
        float q0, q1, q2, q3;
        load2(qr, q0, q2);
        load2(qr + 8 * PQ, q1, q3);
        const FragA fa = frag_a(q0, q1, q2, q3);
        FragB fb[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float k0v, k1v;
          load2(ks + (8 * j + g) * PK + d0 + 2 * t, k0v, k1v);
          fb[j] = frag_b(k0v, k1v);
        }
        mma3_row(s, 0, fa, fb);
      }

      // mask and online softmax (rows g: e = 0, 1; g + 8: e = 2, 3); a
      // tile whose every key every row of the warp keeps skips the mask
      bool inner = k0 + BK <= a.Sk;
      if (a.causal) inner = inner && k0 + BK - 1 <= qmin;
      if (a.window > 0) inner = inner && k0 > qmax - a.window;
      float mx0 = kNeg, mx1 = kNeg;
      if (inner) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= a.c;
            if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
            else mx1 = fmaxf(mx1, s[j][e]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            bool ok = key < a.Sk;
            if (a.causal) ok = ok && key <= pos;
            if (a.window > 0) ok = ok && key > pos - a.window;
            s[j][e] = ok ? s[j][e] * a.c : kNeg;
            if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
            else mx1 = fmaxf(mx1, s[j][e]);
          }
      }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float corr0 = ex2(m0 - n0), corr1 = ex2(m1 - n1);
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[j][e] == kNeg ? 0.f
                                           : ex2(s[j][e] - (e < 2 ? n0 : n1));
          s[j][e] = p;
          if (e < 2) r0 += p;
          else r1 += p;
        }
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        r0 += __shfl_xor_sync(0xffffffffu, r0, sh);
        r1 += __shfl_xor_sync(0xffffffffu, r1, sh);
      }
      l0 = l0 * corr0 + r0;
      l1 = l1 * corr1 + r1;
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][0] *= corr0;
        o[i][1] *= corr0;
        o[i][2] *= corr1;
        o[i][3] *= corr1;
      }

      // O += P·V: k-step j is S's column group j, keys permuted; the
      // head dim in groups of 8 tiles
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const FragA fa = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
        const TK* vr = vs + (8 * j + 2 * t) * PV + g;
#pragma unroll
        for (int i0 = 0; i0 < DT; i0 += 8) {
          FragB fb[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            fb[i] = frag_b(to_f(vr[8 * (i0 + i)]),
                           to_f(vr[PV + 8 * (i0 + i)]));
          mma3_row(o, i0, fa, fb);
        }
      }
    }
    __syncthreads();                  // this buffer is refilled next tile
  }

  const int row0 = wrow + g, row1 = row0 + 8;
  float* og = a.out + b * a.so.b + h * a.so.h;
  if (nchunks == 1) {
    if (!wactive) return;
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int i = 0; i < DT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 8 * i + 2 * t + (e & 1), row = e < 2 ? row0 : row1;
        if (d < a.hd && row < a.Sq)
          og[row * a.so.s + d] = o[i][e] * (e < 2 ? i0 : i1);
      }
    return;
  }

  // split query tile: this chunk's (acc, m, l), combined by
  // swa_combine_kernel
  if (!wactive) return;
  float* pg = part_at(a, bh, qt, sp);
  float* ml = pg + kBQ * a.hd;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * i + 2 * t + (e & 1);
      if (d < a.hd) pg[(e < 2 ? r0 : r1) * a.hd + d] = o[i][e];
    }
  if (t == 0) {
    ml[2 * r0] = m0;
    ml[2 * r0 + 1] = l0;
    ml[2 * r1] = m1;
    ml[2 * r1 + 1] = l1;
  }
}

// out = Σ_j acc_j · 2^(m_j - M) / Σ_j l_j · 2^(m_j - M), M = max_j m_j,
// over the chunks of query tiles that had more than one. A CTA per (query
// tile, batch·head, 8 rows), so a small grid still spreads: 8 threads take
// a row's (m, l) pairs in one online pass into per-chunk weights in shared
// memory, then all 256 sum the partials of 8 rows x hd, coalesced along
// hd, each element's chunks independent loads.
constexpr int kCombineRows = 8;

__global__ void __launch_bounds__(256)
swa_combine_kernel(Args a, int BK) {
  __shared__ float wts[kMaxSplit][kCombineRows];
  const int qt = blockIdx.x, bh = blockIdx.y;
  const int r0 = blockIdx.z * kCombineRows;
  const int b = bh / a.H, h = bh % a.H;
  int t_lo, t_hi;
  tile_range(a, qt, BK, t_lo, t_hi);
  const int nchunks = (t_hi - t_lo + a.chunk - 1) / a.chunk;
  if (nchunks <= 1 || qt * kBQ + r0 >= a.Sq) return;
  const float* p0 = part_at(a, bh, qt, 0);
  const long long step = (long long)kBQ * (a.hd + 2);
  const float* ml0 = p0 + kBQ * a.hd;
  if (threadIdx.x < kCombineRows) {
    const int r = r0 + threadIdx.x;
    float M = kNeg, L = 0.f;
#pragma unroll 4
    for (int j = 0; j < nchunks; ++j) {
      const float2 ml = *reinterpret_cast<const float2*>(ml0 + j * step +
                                                         2 * r);
      wts[j][threadIdx.x] = ml.x;
      const float Mn = fmaxf(M, ml.x);
      L = L * ex2(M - Mn) + ml.y * ex2(ml.x - Mn);
      M = Mn;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int j = 0; j < nchunks; ++j)
      wts[j][threadIdx.x] = ex2(wts[j][threadIdx.x] - M) * inv;
  }
  __syncthreads();
  float* og = a.out + b * a.so.b + h * a.so.h;
  for (int e = threadIdx.x; e < kCombineRows * a.hd; e += blockDim.x) {
    const int r = e / a.hd, d = e - r * a.hd, row = qt * kBQ + r0 + r;
    if (row >= a.Sq) break;
    const float* pe = p0 + (r0 + r) * a.hd + d;
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < nchunks; ++j) acc += pe[j * step] * wts[j][r];
    og[row * a.so.s + d] = acc;
  }
}

template <typename TQ, typename TK, int D>
cudaError_t launch_d(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<TQ, TK>(D);
  static unsigned long long configured = 0;   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(configured >> dev & 1)) {
    e = cudaFuncSetAttribute(swa_kernel<TQ, TK, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) configured |= 1ull << dev;
  }
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  swa_kernel<TQ, TK, D>
      <<<dim3(nqt * a.nsplit, B * a.H), kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.nsplit == 1) return e;
  swa_combine_kernel<<<dim3(nqt, B * a.H, kBQ / kCombineRows), 256, 0,
                       stream>>>(a, block_k(D));
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t launch_t(const Args& a, int B, cudaStream_t stream) {
  switch ((a.hd + 63) / 64) {
    case 1: return launch_d<TQ, TK, 64>(a, B, stream);
    case 2: return launch_d<TQ, TK, 128>(a, B, stream);
    case 3: return launch_d<TQ, TK, 192>(a, B, stream);
    case 4: return launch_d<TQ, TK, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd); out (B, Sq, H, hd) fp32.
// prm: element strides (b, s, h) of q [0..2], k [3..5], v [6..8], out
// [9..11] (the d stride is 1 for all four), then B, Sq, Sk, H, KV, hd,
// window (<= 0: none), causal, q_bf16, kv_bf16 (1 for bf16, 0 for fp32; k
// and v share a type), chunk (key tiles per CTA), nsplit (the most chunks
// of any query tile, at most 64; 1: no split, part unused); part:
// swa_attention_part_floats(...) floats. The scale is 1/sqrt(hd). Returns
// the CUDA error of the launches.
int swa_attention_launch(const void* q, const void* k, const void* v,
                         void* out, void* part, const long long* prm,
                         void* stream) {
  const long long* st = prm;
  const int B = (int)prm[12], Sq = (int)prm[13], Sk = (int)prm[14],
            H = (int)prm[15], KV = (int)prm[16], hd = (int)prm[17],
            window = (int)prm[18], causal = (int)prm[19],
            q_bf16 = (int)prm[20], kv_bf16 = (int)prm[21],
            chunk = (int)prm[22], nsplit = (int)prm[23];
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || B * H > 65535 || chunk <= 0 || nsplit <= 0 ||
      nsplit > kMaxSplit || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.sq = {st[0], st[1], st[2]};
  a.sk = {st[3], st[4], st[5]};
  a.sv = {st[6], st[7], st[8]};
  a.so = {st[9], st[10], st[11]};
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.hd = hd;
  a.window = window;
  a.causal = causal;
  a.chunk = chunk;
  a.nsplit = nsplit;
  a.c = (float)(1.0 / sqrt((double)hd)) * 1.4426950408889634f;
  const int eq = q_bf16 ? 2 : 4, ek = kv_bf16 ? 2 : 4;
  a.vq = tf32x3::copy_width(q, st, 3, hd * eq, eq);
  const int vk = tf32x3::copy_width(k, st + 3, 3, hd * ek, ek);
  const int vv = tf32x3::copy_width(v, st + 6, 3, hd * ek, ek);
  a.vk = vk < vv ? vk : vv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_bf16 && kv_bf16)
    e = launch_t<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  else if (q_bf16)
    e = launch_t<__nv_bfloat16, float>(a, B, s);
  else if (kv_bf16)
    e = launch_t<float, __nv_bfloat16>(a, B, s);
  else
    e = launch_t<float, float>(a, B, s);
  return (int)e;
}

// Floats of the partials buffer for nsplit > 1.
long long swa_attention_part_floats(int B, int H, int Sq, int hd,
                                    int nsplit) {
  return (long long)B * H * ((Sq + kBQ - 1) / kBQ) * nsplit * kBQ *
         (hd + 2);
}

}  // extern "C"
