// Mamba2 SSD intra-chunk block for Hopper (sm_90a): the fp32 route of
// `kernels/ssd_chunk.py`.
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk` (src/repro/kernels/
// ssd_chunk.py:49, body `_kernel` :26) for every input the bf16
// tensor-core route (ssd_chunk_tc.cu) does not take: fp32, or Q other than
// 64/128, P or N other than 64. For each (batch, chunk, head) cell, with a
// the inclusive cumsum of dt·A over the chunk (fp32, computed outside):
//   Y_diag = (C Bᵀ ⊙ L) X,   L[i][j] = exp(a_i - a_j) for j <= i, else 0
//   state  = Σ_k exp(a_last - a_k) X_k ⊗ B_k
// L is a select: for j > i, a_i - a_j > 0 and exp overflows, so a 0/1
// multiply would give inf·0 = NaN. Outputs fp32, within 2e-4 of the plain
// version (fp32 arithmetic throughout).
//
// What bounds it on this card: at Zamba2's fp32 prefill in the model's
// layout (b = 4, 16 chunks, 64 heads, Q = 128, P = N = 64, one B/C group)
// X is 134 MB, Y_diag 134 MB and the states 67 MB (0.10 ms at 3.35 TB/s),
// against 8.7 GFLOP of the causal triangle with C·Bᵀ once per group
// (0.13 ms at the 67 TFLOP/s of fp32 on the CUDA cores): operations,
// narrowly, and the kernel has to stream as well as compute.
//
// Units: the tensor cores, at fp32 accuracy by three TF32 terms per product
// (tf32x3.cuh); X, B and C are split as well as S, since they arrive in
// fp32. Three products per term pair at 495 TFLOP/s TF32 is 0.05 ms for
// the prefill's products, under the bytes. `mma.sync` m16n8k8, as in
// swa_attention.cu: the G tile in registers is the A operand of S·X.
//
// Design:
// - A CTA of 4 warps per (batch, chunk, block of heads). When B and C are
//   one group (expanded over the heads with stride 0, or one head), G =
//   C·Bᵀ is computed once per CTA and kept in registers across its heads;
//   when they differ per head the host gives each CTA one head. The head
//   block is picked from the cell count (kernels/ssd_chunk.py,
//   `ssd_heads_per_cta`): the largest power of two whose grid still gives
//   every SM a CTA (16 at Zamba2's fp32 prefill), else 1 (Zamba2's fp32
//   forward has 2 (batch, chunk) pairs: 128 cells).
// - Only the causal triangle: rows are 8 blocks of 16; warp w owns blocks
//   w and 7 - w (2w + 2 and 16 - 2w column tiles of 8: 18 for every warp),
//   and its G is those 18 tiles, 72 registers a thread.
// - Per head, S = G ⊙ L in registers (ex2.approx, relative error ~2^-22),
//   then Y_diag rows = S·X over the row block's columns only; the state
//   (P x N) = (X ⊙ w)ᵀ B with warp w owning p rows 16w..16w+15, N in
//   halves of 64. Both contractions over keys use the k permutation of
//   tf32x3.cuh, so every shared-memory read is bank-conflict free.
// - Shared memory: B, C and X tiles of Q x (64 or 128) as they come (fp32
//   or bf16) by cp.async, and a; once G is built, C's tile is X's second
//   buffer, so the next head's X loads while this head is computed.
//   105 KB at fp32, N <= 64: two CTAs per SM (224 registers a thread: a
//   cap of 168 for three spilled and was slower on the card).
// - One head a CTA (B/C per head, the Pallas layout, or a grid too small
//   to share G, as Zamba2's fp32 forward's 128 cells): `ssd_cell_kernel`,
//   8 warps. Warps 0-3 build G a group of 8 column tiles at a time and use
//   each group at once in S·X, so G takes 32 registers, not 72; warps 4-7
//   build the state meanwhile. Two such CTAs fit an SM (16 warps, where
//   the head-block kernel has 8).
//
// Layout: every tensor is addressed through element strides, so the model
// passes its own (b, l, h, ·) layout (the chunk split is a view) and B/C
// expanded over heads with stride 0, and the Pallas kernel's (BH, NC, Q, ·)
// layout is the same call with b = BH and one head. Limits: Q <= 128,
// P <= 64, N <= 128; the last dimension of X, B, C is contiguous.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 128;             // the head-block kernel
constexpr int kCellThreads = 256;         // the one-cell kernel
constexpr int kQB = 128;                  // chunk rows, padded
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* X;
  const float* A;
  const void* B;
  const void* C;
  float* Y;
  float* S;
  long long sx[4], sa[4], sb[4], sc[4], sy[4];   // (b, c, q, h) / a: (b, h, c, q)
  long long ss[5];                               // state (b, c, h, p, n)
  int H, NC, Q, P, N, NP, R, hb, n_hb, vx, vbc;
};

template <typename T>
__host__ __device__ inline int pitch_of(int NP) {
  return NP + 16 / (int)sizeof(T);
}
template <typename T>
__host__ __device__ inline int smem_bytes(int NP) {
  return 3 * kQB * pitch_of<T>(NP) * (int)sizeof(T) + 2 * kQB * 4;
}

__device__ __forceinline__ void store2(float* p, float x0, float x1,
                                       bool ok1, bool pair) {
  if (pair && ok1) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    return;
  }
  p[0] = x0;
  if (ok1) p[1] = x1;
}

// B and C columns [N, N8) are contracted over in G: zero them.
template <typename T, int NTHREADS>
__device__ __forceinline__ void zero_bc_pad(T* bs, T* cs, int R, int N,
                                            int tid) {
  const int N8 = (N + 7) / 8 * 8;
  if (N8 > N)
    for (int e = tid; e < kQB * (N8 - N); e += NTHREADS) {
      const int r = e / (N8 - N), col = N + e % (N8 - N);
      bs[r * R + col] = T(0.f);
      cs[r * R + col] = T(0.f);
    }
}

// S·X for the column tiles kt of row block rb (rows i0 = 16rb + g and
// i0 + 8), S = G ⊙ L from this warp's G tiles g_(kt); acc += S·X.
template <typename T, int M>
__device__ __forceinline__ void sx_step(float (&acc)[8][4],
                                        const float (&gt)[4], int kt, int i0,
                                        float ai0, float ai1, const float* ap,
                                        const T* xs, int R, int g, int t) {
  const int i1 = i0 + 8;
  const int j0 = 8 * kt + 2 * t, j1 = j0 + 1;
  const float aj0 = ap[j0], aj1 = ap[j1];
  const float s0 = j0 <= i0 ? gt[0] * ex2((ai0 - aj0) * kLog2e) : 0.f;
  const float s1 = j1 <= i0 ? gt[1] * ex2((ai0 - aj1) * kLog2e) : 0.f;
  const float s2 = j0 <= i1 ? gt[2] * ex2((ai1 - aj0) * kLog2e) : 0.f;
  const float s3 = j1 <= i1 ? gt[3] * ex2((ai1 - aj1) * kLog2e) : 0.f;
  const FragA fa = frag_a(s0, s2, s1, s3);
  const T* xr = xs + j0 * R + g;
#pragma unroll
  for (int h = 0; h < 8; h += M) {
    FragB fb[M];
#pragma unroll
    for (int n = 0; n < M; ++n)
      fb[n] = frag_b(to_f(xr[8 * (h + n)]), to_f(xr[R + 8 * (h + n)]));
    mma3_row(acc, h, fa, fb);
  }
}

// Y_diag rows i0, i0 + 8 (< Q), columns < P, from the accumulators.
__device__ __forceinline__ void store_y(float* yg, long long row_stride,
                                        const float (&acc)[8][4], int i0,
                                        int Q, int P, int t, bool pair) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= P) continue;
    if (i0 < Q)
      store2(yg + i0 * row_stride + col, acc[n][0], acc[n][1], col + 1 < P,
             pair);
    if (i0 + 8 < Q)
      store2(yg + (i0 + 8) * row_stride + col, acc[n][2], acc[n][3],
             col + 1 < P, pair);
  }
}

// state rows p of block pw (P x N) = (X ⊙ w)ᵀ B, w_k = exp(a_last - a_k)
// scaling the A operand (4 values a k-step, not B's 16), N in halves of
// 64, written to sg.
template <typename T>
__device__ __forceinline__ void state_rows(float* sg, const Args& a, int pw,
                                           const float* ap, const T* xs,
                                           const T* bs, int g, int t) {
  const int R = a.R, Q = a.Q, P = a.P, N = a.N;
  const bool pair = (N % 2) == 0 && a.ss[4] == 1;
  const float a_last = ap[Q - 1];
  const int p0 = 16 * pw + g, p1 = p0 + 8;
  for (int nb = 0; nb < N; nb += 64) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int k0 = 0; k0 < Q; k0 += 8) {
      const int j0 = k0 + 2 * t, j1 = j0 + 1;
      const float w0 = j0 < Q ? ex2((a_last - ap[j0]) * kLog2e) : 0.f;
      const float w1 = j1 < Q ? ex2((a_last - ap[j1]) * kLog2e) : 0.f;
      const T* xr = xs + j0 * R + p0;
      const FragA fa = frag_a(to_f(xr[0]) * w0, to_f(xr[8]) * w0,
                              to_f(xr[R]) * w1, to_f(xr[R + 8]) * w1);
      const T* br = bs + j0 * R + nb + g;
      FragB fb[8];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        fb[n] = frag_b(to_f(br[8 * n]), to_f(br[R + 8 * n]));
      mma3_row(acc, 0, fa, fb);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = nb + 8 * n + 2 * t;
      if (col >= N) continue;
      if (p0 < P)
        store2(sg + p0 * a.ss[3] + col * a.ss[4], acc[n][0], acc[n][1],
               col + 1 < N, pair);
      if (p1 < P)
        store2(sg + p1 * a.ss[3] + col * a.ss[4], acc[n][2], acc[n][3],
               col + 1 < N, pair);
    }
  }
}

// --- a block of heads that share B and C: G once, in registers ----------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_kernel(Args a) {
  const int R = a.R, Q = a.Q, P = a.P;
  extern __shared__ float4 smem4[];
  T* bs = reinterpret_cast<T*>(smem4);          // [kQB][R] B
  T* r1 = bs + kQB * R;                         // [kQB][R] C, then X stage 1
  T* x0 = r1 + kQB * R;                         // [kQB][R] X stage 0
  float* as = reinterpret_cast<float*>(x0 + kQB * R);   // [2][kQB] a

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hbi = blockIdx.x % a.n_hb;
  const long long bc = blockIdx.x / a.n_hb;
  const int c = (int)(bc % a.NC);
  const long long b = bc / a.NC;
  const int h0 = hbi * a.hb, nh = min(a.hb, a.H - h0);

  const T* xg = static_cast<const T*>(a.X) + b * a.sx[0] + c * a.sx[1];
  const T* bg = static_cast<const T*>(a.B) + b * a.sb[0] + c * a.sb[1];
  const T* cg = static_cast<const T*>(a.C) + b * a.sc[0] + c * a.sc[1];
  const float* ag = a.A + b * a.sa[0] + c * a.sa[2];
  auto stage_head = [&](int h, T* xs, float* ap) {
    stage_rows<T, kThreads>(xs, R, xg + h * a.sx[3], a.sx[2], 0, kQB, Q, P,
                            a.vx, tid);
    stage_rows<float, kThreads>(ap, 1, ag + h * a.sa[1], a.sa[3], 0, kQB, Q,
                                1, 4, tid);
  };

  zero_bc_pad<T, kThreads>(bs, r1, R, a.N, tid);
  stage_rows<T, kThreads>(bs, R, bg, a.sb[2], 0, kQB, Q, a.N, a.vbc, tid);
  stage_rows<T, kThreads>(r1, R, cg, a.sc[2], 0, kQB, Q, a.N, a.vbc, tid);
  stage_head(h0, x0, as);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // G = C·Bᵀ on this warp's 18 tiles: slot u < 2w + 2 is row block w,
  // column tile u; the rest row block 7 - w, column tile u - (2w + 2).
  // Rows past Q give G rows that no stored output reads.
  const int rbA = w, rbB = 7 - w, baseB = 2 * w + 2;
  const bool okA = 16 * rbA < Q, okB = 16 * rbB < Q;
  const int N8 = (a.N + 7) / 8 * 8;
  float gr[18][4];
#pragma unroll
  for (int u = 0; u < 18; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) gr[u][e] = 0.f;
  for (int k0 = 0; k0 < N8; k0 += 8) {
    const T* ca = r1 + (16 * rbA + g) * R + k0 + t;
    const T* cb = r1 + (16 * rbB + g) * R + k0 + t;
    const FragA fA = frag_a(to_f(ca[0]), to_f(ca[8 * R]), to_f(ca[4]),
                            to_f(ca[8 * R + 4]));
    const FragA fB = frag_a(to_f(cb[0]), to_f(cb[8 * R]), to_f(cb[4]),
                            to_f(cb[8 * R + 4]));
    // three rows of 8 slots, each slot's products predicated on its part
#pragma unroll
    for (int grp = 0; grp < 3; ++grp) {
      const int off = grp == 0 ? 0 : 8 * grp - 6;      // 0, 2, 10
      FragB fb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int u = off + i;
        const int jt = grp == 0 ? u : max(u - baseB, 0);
        const T* br = bs + (8 * jt + g) * R + k0 + t;
        fb[i] = frag_b(to_f(br[0]), to_f(br[4]));
      }
      if (grp == 0)
        mma3_row_in(gr, off, 0, baseB, fA, fb);
      else
        mma3_row_in(gr, off, baseB, 18, fB, fb);
    }
  }
  __syncthreads();                              // C's tile is free now

  const bool yPair = (P % 2) == 0;
  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const T* xs = (i & 1) ? r1 : x0;
    const float* ap = as + (i & 1) * kQB;
    if (i + 1 < nh) {
      stage_head(h + 1, (i & 1) ? x0 : r1, as + ((i + 1) & 1) * kQB);
      cp_commit();
    }
    float* yg = a.Y + b * a.sy[0] + c * a.sy[1] + h * a.sy[3];
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int rb = part == 0 ? rbA : rbB;
      if (!(part == 0 ? okA : okB)) continue;
      const int base = part == 0 ? 0 : baseB;
      const int i0 = 16 * rb + g;
      const float ai0 = ap[i0], ai1 = ap[i0 + 8];
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int u = part == 0 ? 0 : 2; u < (part == 0 ? 8 : 18); ++u) {
        const int kt = u - base;
        if (kt < 0 || kt >= 2 * rb + 2 || 8 * kt >= Q) continue;
        sx_step<T, 8>(acc, gr[u], kt, i0, ai0, ai1, ap, xs, R, g, t);
      }
      store_y(yg, a.sy[2], acc, i0, Q, P, t, yPair);
    }
    if (16 * w < P)
      state_rows<T>(a.S + b * a.ss[0] + c * a.ss[1] + h * a.ss[2], a, w, ap,
                    xs, bs, g, t);
    cp_wait_all();
    __syncthreads();                  // this head's X buffer is refilled next
  }
}

// --- one cell a CTA (B and C per head, the Pallas layout, small grids) ---
// Warps 0-3 build G a group of 8 column tiles at a time, fused into S·X
// (32 registers of G, not 72: two 8-warp CTAs fit an SM); warps 4-7 build
// the state meanwhile.
template <typename T>
__global__ void __launch_bounds__(kCellThreads, 2)
ssd_cell_kernel(Args a) {
  const int R = a.R, Q = a.Q, P = a.P;
  extern __shared__ float4 smem4[];
  T* bs = reinterpret_cast<T*>(smem4);          // [kQB][R] B
  T* cs = bs + kQB * R;                         // [kQB][R] C
  T* xs = cs + kQB * R;                         // [kQB][R] X
  float* ap = reinterpret_cast<float*>(xs + kQB * R);   // [kQB] a

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x % a.H;
  const long long bc = blockIdx.x / a.H;
  const int c = (int)(bc % a.NC);
  const long long b = bc / a.NC;

  zero_bc_pad<T, kCellThreads>(bs, cs, R, a.N, tid);
  stage_rows<T, kCellThreads>(
      bs, R, static_cast<const T*>(a.B) + b * a.sb[0] + c * a.sb[1] +
      h * a.sb[3], a.sb[2], 0, kQB, Q, a.N, a.vbc, tid);
  stage_rows<T, kCellThreads>(
      cs, R, static_cast<const T*>(a.C) + b * a.sc[0] + c * a.sc[1] +
      h * a.sc[3], a.sc[2], 0, kQB, Q, a.N, a.vbc, tid);
  stage_rows<T, kCellThreads>(
      xs, R, static_cast<const T*>(a.X) + b * a.sx[0] + c * a.sx[1] +
      h * a.sx[3], a.sx[2], 0, kQB, Q, P, a.vx, tid);
  stage_rows<float, kCellThreads>(
      ap, 1, a.A + b * a.sa[0] + h * a.sa[1] + c * a.sa[2], a.sa[3], 0, kQB,
      Q, 1, 4, tid);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  if (w >= 4) {
    if (16 * (w - 4) < P)
      state_rows<T>(a.S + b * a.ss[0] + c * a.ss[1] + h * a.ss[2], a, w - 4,
                    ap, xs, bs, g, t);
    return;
  }
  const int N8 = (a.N + 7) / 8 * 8;
  float* yg = a.Y + b * a.sy[0] + c * a.sy[1] + h * a.sy[3];
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int rb = part == 0 ? w : 7 - w, ntile = 2 * rb + 2;
    if (16 * rb >= Q) continue;
    const int i0 = 16 * rb + g;
    const float ai0 = ap[i0], ai1 = ap[i0 + 8];
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int j8 = 0; j8 < ntile; j8 += 8) {
      // G tiles j8 .. j8 + 7 of row block rb (those < ntile)
      float gg[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) gg[i][e] = 0.f;
      for (int k0 = 0; k0 < N8; k0 += 8) {
        const T* cr = cs + i0 * R + k0 + t;
        const FragA fa = frag_a(to_f(cr[0]), to_f(cr[8 * R]), to_f(cr[4]),
                                to_f(cr[8 * R + 4]));
#pragma unroll
        for (int hh = 0; hh < 8; hh += 4) {
          FragB fb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const T* br = bs + (8 * (j8 + hh + i) + g) * R + k0 + t;
            fb[i] = frag_b(to_f(br[0]), to_f(br[4]));
          }
          mma3_row_in(gg, hh, 0, ntile - j8, fa, fb);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kt = j8 + i;
        if (kt >= ntile || 8 * kt >= Q) continue;
        sx_step<T, 4>(acc, gg[i], kt, i0, ai0, ai1, ap, xs, R, g, t);
      }
    }
    store_y(yg, a.sy[2], acc, i0, Q, P, t, (P % 2) == 0);
  }
}

// Sets the dynamic shared memory limit of a kernel once per device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (done >> dev & 1))) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

template <typename T>
cudaError_t launch_t(const Args& a, long long ctas, cudaStream_t stream) {
  static unsigned long long done_heads = 0, done_cell = 0;
  const int bytes = smem_bytes<T>(a.NP);
  cudaError_t e;
  if (a.hb == 1) {
    e = allow_smem(ssd_cell_kernel<T>, smem_bytes<T>(128), done_cell);
    if (e != cudaSuccess) return e;
    ssd_cell_kernel<T><<<(unsigned)ctas, kCellThreads, bytes, stream>>>(a);
  } else {
    e = allow_smem(ssd_kernel<T>, smem_bytes<T>(128), done_heads);
    if (e != cudaSuccess) return e;
    ssd_kernel<T><<<(unsigned)ctas, kThreads, bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Cells (b, c, h). prm: element strides of X, B, C as (b, c, q, h, ·)
// [0..3], [8..11], [12..15] (last dim contiguous); of A as (b, h, c, q)
// [4..7]; of Y_diag (b, c, q, h, p) fp32 [16..19]; of the states
// (b, c, h, p, n) fp32 [20..24]; then b, NC, Q, H, P, N, bf16 (1 when X, B
// and C are bf16, 0 when fp32), hb, the heads per CTA, which share one
// G: hb > 1 only when B and C are the same for every head (stride 0 over
// heads); hb = 1 runs the one-cell kernel. Returns the CUDA error of the
// launch.
int ssd_intra_chunk_launch(const void* X, const void* A, const void* B,
                           const void* C, void* Y, void* S,
                           const long long* prm, void* stream) {
  const long long* st = prm;
  const int nb = (int)prm[25], NC = (int)prm[26], Q = (int)prm[27],
            H = (int)prm[28], P = (int)prm[29], N = (int)prm[30],
            bf16 = (int)prm[31], hb = (int)prm[32];
  if (nb <= 0 || NC <= 0 || H <= 0 || Q <= 0 || Q > kQB || P <= 0 ||
      P > 64 || N <= 0 || N > 128 || hb <= 0 || hb > H)
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
  a.NP = N <= 64 ? 64 : 128;
  a.R = bf16 ? pitch_of<__nv_bfloat16>(a.NP) : pitch_of<float>(a.NP);
  a.hb = hb;
  a.n_hb = (H + hb - 1) / hb;
  const int es = bf16 ? 2 : 4;
  a.vx = tf32x3::copy_width(X, st, 4, P * es, es);
  const int vb = tf32x3::copy_width(B, st + 8, 4, N * es, es);
  const int vc = tf32x3::copy_width(C, st + 12, 4, N * es, es);
  a.vbc = vb < vc ? vb : vc;
  const long long ctas = (long long)nb * NC * a.n_hb;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_t<__nv_bfloat16>(a, ctas, s)
                    : launch_t<float>(a, ctas, s));
}

}  // extern "C"
