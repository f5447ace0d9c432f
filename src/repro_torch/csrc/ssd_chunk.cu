// Mamba2 SSD intra-chunk block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` (src/repro/kernels/
// ssd_chunk.py:49, body `_kernel` :26). For each (batch, chunk, head) cell,
// with a the inclusive cumsum of dt·A over the chunk (fp32, computed
// outside):
//   Y_diag = (C Bᵀ ⊙ L) X,   L[i][j] = exp(a_i - a_j) for j <= i, else 0
//   state  = Σ_k exp(a_last - a_k) X_k ⊗ B_k           (the chunk's input
//                                                      to the inter-chunk
//                                                      recurrence)
// L is a select: for j > i, a_i - a_j > 0 and exp overflows, so a 0/1
// multiply would give inf·0 = NaN.
//
// What bounds it on this card: bytes, narrowly. At Zamba2's prefill (B = 4,
// S = 2048, 64 heads, Q = 128, P = N = 64) X in bf16 is 67 MB, Y_diag in
// fp32 134 MB and the states 67 MB; B and C are read per group (1 MB each)
// rather than head-expanded. That is ~0.08 ms at 3.35 TB/s, against
// ~13 GFLOP of products that the causal lower triangle needs (~0.013 ms at
// the bf16 tensor-core peak). This first version runs the products on the
// CUDA cores in fp32 (67 TFLOP/s), so in practice operations bound it;
// tensor cores are a later step.
//
// Design: one 256-thread block (16 x 16) per cell. X (Q x P), Bᵀ and Cᵀ
// (N x Q, rows padded to Q+1 floats against bank conflicts) and a are
// staged in shared memory as fp32. The Q x Q score matrix is built in
// column tiles of 64: each thread computes rows ty + 16r (r < 8) x columns
// tx + 16s (s < 4) of C·Bᵀ, applies L as a select, and writes the tile to
// shared memory transposed; then each thread adds its rows x columns
// tx + 16s of P of (C Bᵀ ⊙ L)·X. The state is a third product,
// n = tx + 16s by p = ty + 16r, summed over the chunk with the decay
// weights exp(a_last - a_k) precomputed once per cell. All arithmetic is
// fp32; inputs are fp32 or bf16.
//
// Layout: every tensor is addressed through element strides, so the model
// passes its own (b, l, h, ·) layout (the chunk split is a view) and B/C
// expanded over heads with stride 0 (one group), and the Pallas kernel's
// (BH, NC, Q, ·) layout is the same call with b = BH and one head. Limits:
// Q <= 128, P <= 64, N <= 128; the last dimension of X, B, C is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 x 16
constexpr int kQR = 8;            // rows per thread: Q <= 16 * 8
constexpr int kPR = 4;            // columns per thread: P <= 16 * 4
constexpr int kNR = 8;            // state rows per thread: N <= 16 * 8
constexpr int kJT = 64;           // score columns per tile
constexpr int kPP = 16 * kPR;     // X staged with P padded to 64

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* X;
  const float* A;
  const void* B;
  const void* C;
  float* Y;
  float* S;
  long long sx[4], sa[4], sb[4], sc[4], sy[4];   // (b, c, q, h) / a: (b, h, c, q)
  long long ss[5];                               // state (b, c, h, p, n)
  int H, NC, Q, P, N, Qp;
};

__host__ __device__ inline int smem_floats(int Qp, int N) {
  return 2 * Qp + Qp * kPP + 2 * N * (Qp + 1) + kJT * (Qp + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(Args a) {
  extern __shared__ float smem[];
  const int Qp = a.Qp, LQ = Qp + 1, Q = a.Q, P = a.P, N = a.N;
  float* as = smem;                    // [Qp]   cumsum a
  float* ws = as + Qp;                 // [Qp]   exp(a_last - a_k)
  float* xs = ws + Qp;                 // [Qp][kPP]
  float* bt = xs + Qp * kPP;           // [N][LQ]   Bᵀ
  float* ct = bt + N * LQ;             // [N][LQ]   Cᵀ
  float* st = ct + N * LQ;             // [kJT][LQ] masked scores, transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long cell = blockIdx.x;
  const int h = (int)(cell % a.H);
  const int c = (int)((cell / a.H) % a.NC);
  const long long b = cell / ((long long)a.H * a.NC);

  const T* xg = static_cast<const T*>(a.X) + b * a.sx[0] + c * a.sx[1] +
                h * a.sx[3];
  const T* bg = static_cast<const T*>(a.B) + b * a.sb[0] + c * a.sb[1] +
                h * a.sb[3];
  const T* cg = static_cast<const T*>(a.C) + b * a.sc[0] + c * a.sc[1] +
                h * a.sc[3];
  const float* ag = a.A + b * a.sa[0] + h * a.sa[1] + c * a.sa[2];

  for (int q = tid; q < Qp; q += kThreads)
    as[q] = q < Q ? ag[q * a.sa[3]] : 0.f;
  for (int e = tid; e < Qp * kPP; e += kThreads) {
    const int q = e / kPP, p = e % kPP;
    xs[e] = (q < Q && p < P) ? to_f(xg[q * a.sx[2] + p]) : 0.f;
  }
  for (int e = tid; e < Qp * N; e += kThreads) {
    const int q = e / N, n = e % N;
    const bool in = q < Q;
    bt[n * LQ + q] = in ? to_f(bg[q * a.sb[2] + n]) : 0.f;
    ct[n * LQ + q] = in ? to_f(cg[q * a.sc[2] + n]) : 0.f;
  }
  __syncthreads();
  const float a_last = as[Q - 1];
  for (int q = tid; q < Qp; q += kThreads)
    ws[q] = q < Q ? expf(a_last - as[q]) : 0.f;

  // --- Y_diag = (C Bᵀ ⊙ L) X, in column tiles of the score matrix
  float y[kQR][kPR];
#pragma unroll
  for (int r = 0; r < kQR; ++r)
#pragma unroll
    for (int s = 0; s < kPR; ++s) y[r][s] = 0.f;

  for (int j0 = 0; j0 < Qp; j0 += kJT) {
    float sc[kQR][4];
#pragma unroll
    for (int r = 0; r < kQR; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) sc[r][s] = 0.f;
    const int jn = min(kJT, Qp - j0);
    for (int n = 0; n < N; ++n) {
      const float* crow = ct + n * LQ;
      const float* brow = bt + n * LQ + j0;
      float cv[kQR], bv[4];
#pragma unroll
      for (int r = 0; r < kQR; ++r) cv[r] = crow[min(ty + 16 * r, Qp - 1)];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = brow[min(tx + 16 * s, jn - 1)];
#pragma unroll
      for (int r = 0; r < kQR; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) sc[r][s] = fmaf(cv[r], bv[s], sc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < kQR; ++r) {
      const int i = ty + 16 * r;
      if (i >= Qp) continue;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int jj = tx + 16 * s, j = j0 + jj;
        if (jj >= jn) continue;
        const bool keep = j <= i && i < Q;
        st[jj * LQ + i] = keep ? sc[r][s] * expf(as[i] - as[j]) : 0.f;
      }
    }
    __syncthreads();
    for (int jj = 0; jj < jn; ++jj) {
      const float* srow = st + jj * LQ;
      const float* xrow = xs + (j0 + jj) * kPP;
      float sv[kQR], xv[kPR];
#pragma unroll
      for (int r = 0; r < kQR; ++r) sv[r] = srow[min(ty + 16 * r, Qp - 1)];
#pragma unroll
      for (int s = 0; s < kPR; ++s) xv[s] = xrow[tx + 16 * s];
#pragma unroll
      for (int r = 0; r < kQR; ++r)
#pragma unroll
        for (int s = 0; s < kPR; ++s) y[r][s] = fmaf(sv[r], xv[s], y[r][s]);
    }
    __syncthreads();                   // st is rewritten by the next tile
  }

  float* yg = a.Y + b * a.sy[0] + c * a.sy[1] + h * a.sy[3];
#pragma unroll
  for (int r = 0; r < kQR; ++r) {
    const int i = ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int s = 0; s < kPR; ++s) {
      const int p = tx + 16 * s;
      if (p < P) yg[i * a.sy[2] + p] = y[r][s];
    }
  }

  // --- state[p][n] = Σ_k w_k X[k][p] B[k][n]; n = tx + 16s, p = ty + 16r
  float sacc[kPR][kNR];
#pragma unroll
  for (int r = 0; r < kPR; ++r)
#pragma unroll
    for (int s = 0; s < kNR; ++s) sacc[r][s] = 0.f;
  for (int k = 0; k < Q; ++k) {
    const float wk = ws[k];
    float bw[kNR], xv[kPR];
#pragma unroll
    for (int s = 0; s < kNR; ++s)
      bw[s] = bt[min(tx + 16 * s, N - 1) * LQ + k] * wk;
#pragma unroll
    for (int r = 0; r < kPR; ++r) xv[r] = xs[k * kPP + ty + 16 * r];
#pragma unroll
    for (int r = 0; r < kPR; ++r)
#pragma unroll
      for (int s = 0; s < kNR; ++s)
        sacc[r][s] = fmaf(xv[r], bw[s], sacc[r][s]);
  }
  float* sg = a.S + b * a.ss[0] + c * a.ss[1] + h * a.ss[2];
#pragma unroll
  for (int r = 0; r < kPR; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int s = 0; s < kNR; ++s) {
      const int n = tx + 16 * s;
      if (n < N) sg[p * a.ss[3] + n * a.ss[4]] = sacc[r][s];
    }
  }
}

template <typename T>
cudaError_t launch_t(const Args& a, long long cells, cudaStream_t stream) {
  const int bytes = smem_floats(a.Qp, a.N) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  ssd_kernel<T><<<(unsigned)cells, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Cells (b, c, h); X, B, C addressed as (b, c, q, h, ·) with element
// strides st[0..3], st[8..11], st[12..15] (last dim contiguous); A as
// (b, h, c, q) with st[4..7]; Y_diag (b, c, q, h, p) fp32 with st[16..19];
// states (b, c, h, p, n) fp32 with st[20..24]. bf16 = 1 when X, B and C
// are bf16, 0 when fp32. Returns the CUDA error of the launch.
int ssd_intra_chunk_launch(const void* X, const void* A, const void* B,
                           const void* C, void* Y, void* S,
                           const long long* st, int nb, int NC, int Q,
                           int H, int P, int N, int bf16, void* stream) {
  if (nb <= 0 || NC <= 0 || H <= 0 || Q <= 0 || Q > 16 * kQR || P <= 0 ||
      P > 16 * kPR || N <= 0 || N > 16 * kNR)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.X = X;
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.Y = static_cast<float*>(Y);
  a.S = static_cast<float*>(S);
  for (int i = 0; i < 4; ++i) {
    a.sx[i] = st[i];
    a.sa[i] = st[4 + i];
    a.sb[i] = st[8 + i];
    a.sc[i] = st[12 + i];
    a.sy[i] = st[16 + i];
  }
  for (int i = 0; i < 5; ++i) a.ss[i] = st[20 + i];
  a.H = H;
  a.NC = NC;
  a.Q = Q;
  a.P = P;
  a.N = N;
  a.Qp = (Q + 15) / 16 * 16;
  const long long cells = (long long)nb * NC * H;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_t<__nv_bfloat16>(a, cells, s)
                    : launch_t<float>(a, cells, s));
}

}  // extern "C"
