// Sliding-window flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `swa_attention` (src/repro/kernels/
// swa_attention.py:73, body `_kernel` :26):
//   out[b, i, h] = softmax_k(q_i · k_k / sqrt(hd), masked) · v
// with query i at absolute position qpos = i + (Sk - Sq), key k kept where
// k < Sk, k <= qpos (causal) and k > qpos - window (window > 0).
//
// What bounds it on this card: operations. At Zamba2's prefill (B = 4,
// S = 2048, H = 32, hd = 64, causal) q/k/v in bf16 and the fp32 output are
// ~168 MB (0.05 ms at 3.35 TB/s), while the two products need
// 4·hd FLOPs per kept (query, key) pair, ~69 GFLOP. This first version runs
// them on the CUDA cores in fp32, so its ceiling is the 67 TFLOP/s fp32
// rate, not the tensor cores'; wgmma/TMA are a later step.
//
// Design: one 256-thread block per (query tile of 64 rows, batch·head).
// The block stages its Q tile once, transposed in shared memory (qs[d][r]),
// then walks the key tiles of 64 that hold at least one kept key for some
// row of the tile (tiles wholly before the window or after the diagonal are
// skipped; their scores would all be masked). Per key tile:
//   1. K is staged transposed (ks[d][c]) and V row-major (vs[c][d]);
//   2. each thread computes a 4x4 block of S = Q·Kᵀ (rows 4·ty.., columns
//      4·tx..) from float4 reads of qs and ks;
//   3. masked scores become -1e30 (not -inf); each row's running max,
//      denominator and the rescale corr = exp(m_prev - m_new) are kept in
//      fp32, reduced over the 16 threads of a row with shuffles. A row whose
//      first visited tile is all masked gets p = exp(0) = 1 there; the
//      first kept key later makes corr = exp(-1e30 - m) = 0, which wipes
//      it, so no NaN and no trace remains;
//   4. P goes to shared memory transposed (ps[c][r]) and each thread adds
//      its 4 rows x (4 columns per 64 of head dim) of P·V.
// The probabilities stay fp32 (the JAX `sdpa` casts them to the activation
// dtype; the TPU kernel keeps them fp32, as here). hd <= 256 is padded to
// D = 64·NC with zeros. k/v may have KV < H heads: head h reads kv head
// h / (H / KV), so no repeated copy of k/v is made. q, k, v may each be
// fp32 or bf16; all arithmetic is fp32; the output is fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPad = 4;             // keeps float4 alignment of padded rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Strides {                    // element strides of (b, s, h); d is 1
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  Strides sq, sk, sv, so;
  int H, KV, Sq, Sk, hd, window, causal;
  float scale;
};

// Shared-memory floats for head dim D = 64·NC.
__host__ __device__ constexpr int smem_floats(int D) {
  return D * (kBQ + kPad) + D * (kBK + kPad) + kBK * D + kBK * (kBQ + kPad);
}

template <typename TQ, typename TK, int NC>
__global__ void __launch_bounds__(kThreads)
swa_kernel(Args a) {
  constexpr int D = 64 * NC;
  constexpr int LQ = kBQ + kPad, LK = kBK + kPad;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [D][LQ]
  float* ks = qs + D * LQ;                       // [D][LK]
  float* vs = ks + D * LK;                       // [kBK][D]
  float* ps = vs + kBK * D;                      // [kBK][LQ]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * kBQ;
  const int off = a.Sk - a.Sq;

  const TQ* qg = static_cast<const TQ*>(a.q) + b * a.sq.b + h * a.sq.h;
  const TK* kg = static_cast<const TK*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const TK* vg = static_cast<const TK*>(a.v) + b * a.sv.b + kvh * a.sv.h;

  // Q tile, transposed, zero-padded (rows >= Sq and d >= hd)
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    qs[d * LQ + r] = (qi < a.Sq && d < a.hd) ? to_f(qg[qi * a.sq.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }

  // key range that holds a kept key for some row of this tile
  const int qlast = min(q0 + kBQ, a.Sq) - 1;
  const int pmin = q0 + off, pmax = qlast + off;
  int k_lo = 0, k_hi = a.Sk;
  if (a.window > 0) k_lo = max(0, pmin - a.window + 1);
  if (a.causal) k_hi = min(a.Sk, pmax + 1);
  const int t_lo = k_lo / kBK * kBK;

  for (int k0 = t_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();                  // previous tile's ks/vs/ps are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D, kj = k0 + c;
      const bool in = kj < a.Sk && d < a.hd;
      ks[d * LK + c] = in ? to_f(kg[kj * a.sk.s + d]) : 0.f;
      vs[c * D + d] = in ? to_f(vg[kj * a.sv.s + d]) : 0.f;
    }
    __syncthreads();

    // S = Q·Kᵀ, 4x4 per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[d * LQ + 4 * ty]);
      const float4 kb = *reinterpret_cast<const float4*>(&ks[d * LK + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax (rows 4·ty + i; 16 threads share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + off;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        bool ok = kpos < a.Sk;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= corr;
    }

    // P to shared memory, transposed: ps[c][r], four rows per float4
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&ps[(4 * tx + j) * LQ + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P·V: rows 4·ty + i, columns 64·c + 4·tx + j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(&ps[kk * LQ + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vb =
            *reinterpret_cast<const float4*>(&vs[kk * D + 64 * c + 4 * tx]);
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][4 * c + j] = fmaf(pv[i], vv[j], acc[i][4 * c + j]);
      }
    }
  }

  // out = acc / l (rows with no kept key at all have l = 0 and give 0)
  float* og = a.out + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 64 * c + 4 * tx + j;
        if (d < a.hd) og[qi * a.so.s + d] = acc[i][4 * c + j] * inv;
      }
  }
}

template <typename TQ, typename TK, int NC>
cudaError_t launch_nc(const Args& a, int B, cudaStream_t stream) {
  const int bytes = smem_floats(64 * NC) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      swa_kernel<TQ, TK, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, B * a.H);
  swa_kernel<TQ, TK, NC><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t launch_t(const Args& a, int B, cudaStream_t stream) {
  switch ((a.hd + 63) / 64) {
    case 1: return launch_nc<TQ, TK, 1>(a, B, stream);
    case 2: return launch_nc<TQ, TK, 2>(a, B, stream);
    case 3: return launch_nc<TQ, TK, 3>(a, B, stream);
    case 4: return launch_nc<TQ, TK, 4>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), each with element strides
// st[0..2] = (b, s, h) for q, st[3..5] for k, st[6..8] for v, st[9..11]
// for out (B, Sq, H, hd) fp32; the d stride is 1 for all four.
// q_bf16 / kv_bf16 = 1 for bf16, 0 for fp32 (k and v share a type).
// window <= 0 means none. Returns the CUDA error of the launch.
int swa_attention_launch(const void* q, const void* k, const void* v,
                         void* out, const long long* st, int B, int Sq,
                         int Sk, int H, int KV, int hd, int window,
                         int causal, float scale, int q_bf16, int kv_bf16,
                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0 ||
      hd <= 0 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = static_cast<float*>(out);
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
  a.scale = scale;
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

}  // extern "C"
