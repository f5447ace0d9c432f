// Mamba2 SSD intra-chunk block, backward, for Hopper (sm_90a): the
// backward of `kernels/ssd_chunk.py`'s `SsdIntraChunkFn`.
//
// Replaces no Pallas kernel: the JAX package differentiates steps 1-2 of
// its jnp `ssd_chunked` (src/repro/models/ssm.py:86), while the port's
// forward on the card is a kernel whose outputs have no autograd graph.
// Per (batch, chunk, head) cell, with G = C Bᵀ, L_ij = exp(a_i - a_j) for
// j <= i (else 0), M = G ⊙ L, dM = dY Xᵀ (kept where j <= i), W = dM ⊙ L
// and decay_k = exp(a_Q - a_k):
//   dX = Mᵀ dY + decay ⊙ (B dSᵀ)
//   dC = W B
//   dB = Wᵀ C + decay ⊙ (X dS)
//   dA = rowsum(dM ⊙ M) - colsum(dM ⊙ M) - h, plus Σ_k h_k at the last
//        position, where h_k = decay_k · X_kᵀ dS B_k (the state's share).
// L is never formed above the diagonal, where exp(a_i - a_j) overflows.
// X, B, C fp32 or bf16 at any strides with the last dim contiguous (B and
// C may be one group expanded over the heads with stride 0: dB and dC
// are then written dense per head, and the expand's backward sums them);
// A_cs, dY, dS fp32; every output fp32, every sum fp32.
//
// What bounds it on this card: operations. At Zamba2's shape (b = 4, 16
// chunks, 64 heads, Q = 128, P = N = 64) the products above, over the
// causal triangle, are Q²·(3N + 2P) + 4·Q·P·N FLOPs a cell: 30 GFLOP a
// call, 0.45 ms at fp32's 67 TFLOP/s on the CUDA cores (in bf16 the
// 0.6 GB of fp32 gradients it reads and writes bound it instead). This
// first version is plain SIMT fp32 (FFMA), no tensor cores.
//
// Design: one CTA of 256 threads (8 warps) a cell. X, B and dS are staged
// whole in shared memory (fp32, odd pitches); the rows i walk in blocks
// of 32: C and dY of the block are staged, each warp computes G and dM
// for 4 rows against all keys j < the block's end, forms M, W and the dA
// row sums (a warp reduction) and column sums (per-warp partials summed
// by one thread a column in warp order), writes the block's rows of dC,
// and adds the block's share to dB and dX, which stay in registers (a
// thread owns 16 rows j = warp + 8·a and the columns lane + 32·c). No
// atomics: every output element is summed by one thread in a fixed
// order, so a call is repeatable bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;                   // the most rows of a chunk
constexpr int kIB = 32;                   // rows i a block
constexpr int kQP = kQ + 1;               // pitch of M, W

struct Args {
  const void* X;
  const float* A;
  const void* B;
  const void* C;
  const float* dY;                        // (b, c, Q, h, p) contiguous
  const float* dS;                        // (b, c, h, p, n) contiguous
  float* dX;                              // (b, c, Q, h, p) contiguous
  float* dA;                              // (b, h, c, Q) contiguous
  float* dB;                              // (b, c, Q, h, n) contiguous
  float* dC;                              // (b, c, Q, h, n) contiguous
  long long sx[4], sa[4], sb[4], sc[4];   // X, B, C (b, c, q, h); A (b, h, c, q)
  int nb, nc, Q, h, p, n, bf16;
};

__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w /= 2) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

template <int NC, int PC>
__host__ __device__ constexpr int smem_floats() {
  return kQ * (32 * PC + 1) + kQ * (32 * NC + 1) + kIB * (32 * NC + 1) +
         kIB * (32 * PC + 1) + 32 * PC * (32 * NC + 1) + 2 * kIB * kQP +
         5 * kQ + 8 * kQ;
}

template <int NC, int PC>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(Args a) {
  constexpr int NP = 32 * NC + 1, PP = 32 * PC + 1;
  extern __shared__ float sm[];
  float* xs = sm;                         // [kQ][PP]
  float* bs = xs + kQ * PP;               // [kQ][NP]
  float* cs = bs + kQ * NP;               // [kIB][NP]
  float* dys = cs + kIB * NP;             // [kIB][PP]
  float* dsm = dys + kIB * PP;            // [32·PC][NP]: dS (p, n)
  float* ms = dsm + 32 * PC * NP;         // [kIB][kQP]
  float* ws = ms + kIB * kQP;             // [kIB][kQP]
  float* as_ = ws + kIB * kQP;            // [kQ]: a = A_cs of the cell
  float* dec = as_ + kQ;                  // [kQ]: exp(a_Q - a_k)
  float* rowacc = dec + kQ;               // [kQ]
  float* colacc = rowacc + kQ;            // [kQ]
  float* hs = colacc + kQ;                // [kQ]
  float* colp = hs + kQ;                  // [8][kQ]

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const long long cell = blockIdx.x;
  const int hi = (int)(cell % a.h);
  const long long bcix = cell / a.h;
  const int ci = (int)(bcix % a.nc), bi = (int)(bcix / a.nc);
  const int Q = a.Q, p = a.p, n = a.n;

  const long long xb = bi * a.sx[0] + ci * a.sx[1] + hi * a.sx[3];
  const long long bb = bi * a.sb[0] + ci * a.sb[1] + hi * a.sb[3];
  const long long cb = bi * a.sc[0] + ci * a.sc[1] + hi * a.sc[3];
  for (int e = tid; e < kQ * 32 * PC; e += kThreads) {
    const int r = e / (32 * PC), d = e % (32 * PC);
    xs[r * PP + d] =
        (r < Q && d < p) ? ld(a.X, xb + r * a.sx[2] + d, a.bf16) : 0.f;
  }
  for (int e = tid; e < kQ * 32 * NC; e += kThreads) {
    const int r = e / (32 * NC), d = e % (32 * NC);
    bs[r * NP + d] =
        (r < Q && d < n) ? ld(a.B, bb + r * a.sb[2] + d, a.bf16) : 0.f;
  }
  const long long sbase = (((long long)bi * a.nc + ci) * a.h + hi) * p * n;
  for (int e = tid; e < 32 * PC * 32 * NC; e += kThreads) {
    const int r = e / (32 * NC), d = e % (32 * NC);
    dsm[r * NP + d] = (r < p && d < n) ? a.dS[sbase + r * n + d] : 0.f;
  }
  const long long abase = bi * a.sa[0] + hi * a.sa[1] + ci * a.sa[2];
  for (int j = tid; j < kQ; j += kThreads) {
    as_[j] = j < Q ? a.A[abase + j * a.sa[3]] : 0.f;
    rowacc[j] = colacc[j] = hs[j] = 0.f;
  }
  __syncthreads();
  for (int j = tid; j < kQ; j += kThreads)
    dec[j] = j < Q ? expf(as_[Q - 1] - as_[j]) : 0.f;

  // (b, c, row, h) row offset of the contiguous dY, dX, dB, dC
  const long long rows0 = ((long long)bi * a.nc + ci) * Q;
  float dbacc[16][NC], dxacc[16][PC];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dbacc[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < PC; ++c) dxacc[r][c] = 0.f;
  }

  for (int i0 = 0; i0 < Q; i0 += kIB) {
    __syncthreads();
    for (int e = tid; e < kIB * 32 * NC; e += kThreads) {
      const int r = e / (32 * NC), d = e % (32 * NC), i = i0 + r;
      cs[r * NP + d] =
          (i < Q && d < n) ? ld(a.C, cb + i * a.sc[2] + d, a.bf16) : 0.f;
    }
    for (int e = tid; e < kIB * 32 * PC; e += kThreads) {
      const int r = e / (32 * PC), d = e % (32 * PC), i = i0 + r;
      dys[r * PP + d] = (i < Q && d < p)
                            ? a.dY[((rows0 + i) * a.h + hi) * p + d]
                            : 0.f;
    }
    __syncthreads();
    const int jmax = min(Q, i0 + kIB);    // keys j < jmax can be kept

    // G and dM: rows i0 + w + 8·r, keys lane + 32·c
    float g[4][4], dm[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) g[r][c] = dm[r][c] = 0.f;
    for (int k = 0; k < n; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = cs[(w + 8 * r) * NP + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bs[(lane + 32 * c) * NP + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (32 * c >= jmax) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
      }
    }
    for (int k = 0; k < p; ++k) {
      float yv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = dys[(w + 8 * r) * PP + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xs[(lane + 32 * c) * PP + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (32 * c >= jmax) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) dm[r][c] = fmaf(yv[r], xv[c], dm[r][c]);
      }
    }
    float rowp[4], colq[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rowp[r] = colq[r] = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + w + 8 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = lane + 32 * c;
        float m = 0.f, wv = 0.f;
        if (i < Q && j <= i) {
          const float L = expf(as_[i] - as_[j]);
          m = g[r][c] * L;
          wv = dm[r][c] * L;
          const float t = dm[r][c] * m;
          rowp[r] += t;
          colq[c] += t;
        }
        ms[(w + 8 * r) * kQP + j] = m;
        ws[(w + 8 * r) * kQP + j] = wv;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = warp_sum(rowp[r]);
      const int i = i0 + w + 8 * r;
      if (lane == 0 && i < Q) rowacc[i] = v;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) colp[w * kQ + lane + 32 * c] = colq[c];
    __syncthreads();
    if (tid < kQ) {
      float s = 0.f;
#pragma unroll
      for (int ww = 0; ww < 8; ++ww) s += colp[ww * kQ + tid];
      colacc[tid] += s;
    }

    // dC of the block's rows: W B over j < jmax
    {
      float acc[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float wv[4], bv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = ws[(w + 8 * r) * kQP + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) bv[c] = bs[j * NP + lane + 32 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(wv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + w + 8 * r;
        if (i >= Q) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int k = lane + 32 * c;
          if (k < n) a.dC[((rows0 + i) * a.h + hi) * n + k] = acc[r][c];
        }
      }
    }

    // dB += Wᵀ C and dX += Mᵀ dY over the block's rows
    const int rmax = min(kIB, Q - i0);
    for (int r = 0; r < rmax; ++r) {
      float cv[NC], yv[PC];
#pragma unroll
      for (int c = 0; c < NC; ++c) cv[c] = cs[r * NP + lane + 32 * c];
#pragma unroll
      for (int c = 0; c < PC; ++c) yv[c] = dys[r * PP + lane + 32 * c];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int j = w + 8 * t;
        if (j < jmax) {
          const float wv = ws[r * kQP + j], mv = ms[r * kQP + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) dbacc[t][c] = fmaf(wv, cv[c], dbacc[t][c]);
#pragma unroll
          for (int c = 0; c < PC; ++c) dxacc[t][c] = fmaf(mv, yv[c], dxacc[t][c]);
        }
      }
    }
  }
  __syncthreads();

  // the state's terms: dX += decay ⊙ (B dSᵀ), dB += decay ⊙ (X dS), h
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int j = w + 8 * t;
    if (j >= Q) continue;
    float u[PC], xd[NC];
#pragma unroll
    for (int c = 0; c < PC; ++c) u[c] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) xd[c] = 0.f;
    for (int k = 0; k < n; ++k) {
      const float bj = bs[j * NP + k];
#pragma unroll
      for (int c = 0; c < PC; ++c) u[c] = fmaf(bj, dsm[(lane + 32 * c) * NP + k], u[c]);
    }
    for (int k = 0; k < p; ++k) {
      const float xj = xs[j * PP + k];
#pragma unroll
      for (int c = 0; c < NC; ++c) xd[c] = fmaf(xj, dsm[k * NP + lane + 32 * c], xd[c]);
    }
    float hp = 0.f;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      dxacc[t][c] = fmaf(dec[j], u[c], dxacc[t][c]);
      hp = fmaf(xs[j * PP + lane + 32 * c], u[c], hp);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) dbacc[t][c] = fmaf(dec[j], xd[c], dbacc[t][c]);
    hp = warp_sum(hp);
    if (lane == 0) hs[j] = dec[j] * hp;
  }
  __syncthreads();

  if (tid < Q) {
    float v = rowacc[tid] - colacc[tid] - hs[tid];
    if (tid == Q - 1) {
      float s = 0.f;
      for (int k = 0; k < Q; ++k) s += hs[k];
      v += s;
    }
    a.dA[(((long long)bi * a.h + hi) * a.nc + ci) * Q + tid] = v;
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int j = w + 8 * t;
    if (j >= Q) continue;
    const long long row = (rows0 + j) * a.h + hi;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int k = lane + 32 * c;
      if (k < p) a.dX[row * p + k] = dxacc[t][c];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int k = lane + 32 * c;
      if (k < n) a.dB[row * n + k] = dbacc[t][c];
    }
  }
}

template <int NC, int PC>
cudaError_t launch_t(const Args& a, long long cells, cudaStream_t stream) {
  constexpr int bytes = 4 * smem_floats<NC, PC>();
  static unsigned long long configured = 0;   // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !(configured >> dev & 1)) {
    e = cudaFuncSetAttribute(ssd_bwd_kernel<NC, PC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) configured |= 1ull << dev;
  }
  ssd_bwd_kernel<NC, PC><<<(unsigned)cells, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int PC>
cudaError_t launch_p(const Args& a, long long cells, cudaStream_t stream) {
  switch ((a.n + 31) / 32) {
    case 1: return launch_t<1, PC>(a, cells, stream);
    case 2: return launch_t<2, PC>(a, cells, stream);
    case 3: return launch_t<3, PC>(a, cells, stream);
    case 4: return launch_t<4, PC>(a, cells, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// X (b, c, Q, h, p), B and C (b, c, Q, h, n) fp32 or bf16 (alike, bf16 =
// 1), A_cs (b, h, c, Q) fp32; dY (b, c, Q, h, p) and dS (b, c, h, p, n)
// fp32 contiguous; dX, dA, dB, dC fp32 contiguous in the layouts of X,
// A_cs, B, C. st: element strides (b, c, q, h) of X [0..3], B [4..7],
// C [8..11] (the last dim's stride is 1), then (b, h, c, q) of A_cs
// [12..15]. Q <= 128, p <= 64, n <= 128. Returns the CUDA error.
int ssd_intra_chunk_bwd_launch(const void* X, const void* A, const void* B,
                               const void* C, const void* dY, const void* dS,
                               void* dX, void* dA, void* dB, void* dC,
                               const long long* st, int b, int c, int Q,
                               int h, int p, int n, int bf16, void* stream) {
  const long long cells = (long long)b * c * h;
  if (b <= 0 || c <= 0 || h <= 0 || Q <= 0 || Q > kQ || p <= 0 || p > 64 ||
      n <= 0 || n > 128 || cells >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.X = X;
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.dY = static_cast<const float*>(dY);
  a.dS = static_cast<const float*>(dS);
  a.dX = static_cast<float*>(dX);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  for (int i = 0; i < 4; ++i) {
    a.sx[i] = st[i];
    a.sb[i] = st[4 + i];
    a.sc[i] = st[8 + i];
    a.sa[i] = st[12 + i];
  }
  a.nb = b;
  a.nc = c;
  a.Q = Q;
  a.h = h;
  a.p = p;
  a.n = n;
  a.bf16 = bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(p <= 32 ? launch_p<1>(a, cells, s) : launch_p<2>(a, cells, s));
}

}  // extern "C"
