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
// B and C come by group, (b, c, Q, g, n) with g dividing h (head j reads
// group j / (h/g)), and dB, dC go out by group, summed over the group's
// heads: dC = (Σ_h W_h) B and dB = (Σ_h W_h)ᵀ C + Σ_h decay_h ⊙ (X_h dS_h).
// L is never formed above the diagonal, where exp(a_i - a_j) overflows.
// X, B, C fp32 or bf16 at any strides with the last dim contiguous; A_cs,
// dY, dS fp32; every output fp32, every sum fp32.
//
// What bounds it on this card: at Zamba2's shape (b = 4, 16 chunks, 64
// heads, one group, Q = 128, P = N = 64) the products are ~30 GFLOP, three
// TF32 products each, 0.18 ms at 495 TFLOP/s; the bytes (X, dY, dS, dX in,
// out, the rest small) ~0.41 GB, 0.12 ms at 3.35 TB/s: operations.
//
// Units: the tensor cores (mma.sync m16n8k8 TF32, tf32x3.cuh's mma) at
// fp32 accuracy or better. Each operand is split into K TF32 terms rounded
// to nearest (`OpA`, `OpB`): bf16 data (X, B, C) are exact in one term, so
// a product with one of them takes the fp32 side in three terms, exact to
// ~2^-33 in three mma; two fp32 operands take six; the dX product Mᵀ dY
// takes two terms each (three mma, ~2^-22 a product, as `ssd_chunk.cu`).
// The decays of the state's terms scale the products' sums, in fp32, not
// an operand, so those products stay exact. Two things made a first
// version miss the fp32 plain version by 20x on dB: tf32x3.cuh's split
// truncates, so its dropped terms always shrink a product's magnitude
// (biased over dB's 64 heads x 128 rows of sums), and the tensor cores'
// fp32 accumulator truncates as it adds, so a long chain of mma into one
// accumulator drifts by ~1 ulp of the running sum a step. Here every
// chain is 16 of k in a fresh accumulator, and the partial sums add up in
// fp32 registers (round to nearest). L and the decays are expf: an
// ex2.approx of x·log2(e) is off by ~|x|·6e-8 from the argument's
// rounding alone, which dA's cancelling sums show.
//
// Two kernels, one stream, in order; no atomics, every output element
// summed by one thread in a fixed order (a call repeats bit for bit):
// (a) `ssd_bwd_kernel`, one CTA of 4 warps per (batch, chunk, block of hb
//     heads of one group; `kernels/ssd_chunk.py` picks hb so the grid still
//     fills the SMs). Everything is in the transposed orientation, rows j
//     (keys) x columns i >= j (queries), so Mᵀ and Wᵀ leave the
//     accumulators as A operands of dX = Mᵀ dY without a shuffle (the k
//     permutation of tf32x3.cuh). Warp w owns row blocks w and 7 - w of 16
//     (18 column tiles of 8 of the causal triangle either way). The CTA
//     forms Gᵀ = B Cᵀ once and keeps its tiles in shared memory in
//     fragment order; per head it stages X, dY, dS and a (double-buffered
//     by cp.async where shared memory allows), forms dX's state term
//     (decay ⊙ B) dSᵀ and h from it, then per column tile dMᵀ, Mᵀ, Wᵀ and
//     the dA sums, and dX += Mᵀ dY; it writes dX and dA per head, and adds
//     Wᵀ to the block's Σ_h Wᵀ, kept in fragment order in a workspace (L2)
//     that only its own thread touches.
// (b) `ssd_bwd_group_kernel`, one CTA of 8 warps per (batch, chunk, group,
//     32 columns of N): sums the head blocks' Σ Wᵀ in block order into
//     shared memory, then dB = (ΣW)ᵀ C + Σ_h (decay_h ⊙ X_h) dS_h (the
//     heads in order, up to 4 staged ahead by cp.async: one head's
//     products are too short to hide a load) and dC = (ΣW) B, each
//     written once per group.
// Shared-memory pitches are ≡ 4 words mod 32 (fp32) or 8 elements mod 64
// (bf16) where rows are read as fragments, ≡ 8 mod 32 where rows are read
// as k, so every fragment read is free of bank conflicts.
#include <math.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kThreads = 128;             // (a)
constexpr int kGroupThreads = 256;        // (b)
constexpr int kQB = 128;                  // chunk rows, padded
constexpr int kSlots = 18;                // column tiles a warp owns
constexpr int kPartFloats = 4 * kSlots * 4 * 32;   // Σ Wᵀ of one CTA
constexpr int kNC = 32;                   // (b): columns of N a CTA
constexpr int kWP = kQB + 8;              // (b): Σ W pitch
constexpr int kCP = kNC + 8;              // (b): B, C, dS chunk pitch

struct Args {
  const void* X;
  const float* A;
  const void* B;
  const void* C;
  const float* dY;                        // (b, c, Q, h, p) contiguous
  const float* dS;                        // (b, c, h, p, n) contiguous
  float* dX;                              // (b, c, Q, h, p) contiguous
  float* dA;                              // (b, h, c, Q) contiguous
  float* dB;                              // (b, c, Q, g, n) contiguous
  float* dC;                              // (b, c, Q, g, n) contiguous
  float* part;                            // Σ Wᵀ per CTA of (a)
  long long sx[4], sa[4], sb[4], sc[4];   // X, B, C (b, c, q, h|g); A (b, h, c, q)
  int nc, Q, h, g, p, n, hb, nblk, nbuf, nwg;
  int P8, N8, PB, PX, PY, PS;             // padded dims and pitches
  int vx, vb, vc, vy, vs, vs2;            // copy widths
};

__host__ __device__ inline int pitch_f32(int n) { return (n + 31) / 32 * 32 + 4; }
template <typename T>
__host__ __device__ inline int pitch_of(int n) {
  return sizeof(T) == 4 ? pitch_f32(n) : (n + 63) / 64 * 64 + 8;
}

// shared-memory layout of (a), in bytes: B; a region that holds C while
// Gᵀ is formed, then each warp group's nbuf head buffers; Gᵀ; each warp
// group's dA sums (hs, rows, colp)
struct Layout {
  int bs, region, cs_bytes, buf_bytes, x, y, s, a, gs, misc, misc_bytes,
      hs, rows, colp, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int PB, int PX, int PY, int PS,
                                         int P8, int nbuf, int nwg) {
  Layout l;
  l.bs = 0;
  l.region = kQB * PB * (int)sizeof(T);
  l.cs_bytes = kQB * PB * (int)sizeof(T);
  l.x = 0;
  l.y = kQB * PX * (int)sizeof(T);
  l.s = l.y + kQB * PY * 4;
  l.a = l.s + P8 * PS * 4;
  l.buf_bytes = l.a + kQB * 4;
  const int heads = nwg * nbuf * l.buf_bytes;
  l.gs = l.region + (heads > l.cs_bytes ? heads : l.cs_bytes);
  l.misc = l.gs + kPartFloats * 4;
  l.hs = 0;                               // offsets within a group's misc
  l.rows = kQB * 4;
  l.colp = 2 * kQB * 4;
  l.misc_bytes = 10 * kQB * 4;
  l.total = l.misc + nwg * l.misc_bytes;
  return l;
}

// a barrier of one warp group's 128 threads (ids 1, 2; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// --- products at fp32 accuracy ----------------------------------------------
// An operand as K TF32 terms, each rounded to nearest (an integer add
// before the mask): x ~ t0 + t1 + .., the error ~2^-11 of the last term.
// K = 1 for bf16 data, exact in TF32; 2 (~2^-22) for the dX product's M
// and dY; 3 (~2^-33) elsewhere. A product keeps the term pairs (i, j) with
// i + j < max(KA, KB), smallest first: one mma for two bf16 operands,
// three with one, six for two fp32 ones. Rounded terms have residuals of
// random sign, so long sums do not drift.
template <int K>
struct OpA {
  uint32_t t[K][4];
};
template <int K>
struct OpB {
  uint32_t t[K][2];
};

__device__ __forceinline__ uint32_t tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int K, int E, int W>
__device__ __forceinline__ void split_k(float x, uint32_t (&t)[K][W]) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    t[i][E] = tf32_rn(x);
    x -= __uint_as_float(t[i][E]);
  }
}

// A fragment (16 x 8) from its four values: (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)
template <int K>
__device__ __forceinline__ OpA<K> op_a(float x0, float x1, float x2,
                                       float x3) {
  OpA<K> o;
  split_k<K, 0>(x0, o.t);
  split_k<K, 1>(x1, o.t);
  split_k<K, 2>(x2, o.t);
  split_k<K, 3>(x3, o.t);
  return o;
}

// B fragment (8 x 8) from its two values: (t, g), (t + 4, g)
template <int K>
__device__ __forceinline__ OpB<K> op_b(float x0, float x1) {
  OpB<K> o;
  split_k<K, 0>(x0, o.t);
  split_k<K, 1>(x1, o.t);
  return o;
}

// d[off + m] += A·B_m for m < M (only the tiles in [lo, hi) when PRED),
// term-major over the row so consecutive mma do not wait on each other
template <int M, int N, int KA, int KB, bool PRED = false>
__device__ __forceinline__ void mma_row(float (&d)[N][4], int off,
                                        const OpA<KA>& a,
                                        const OpB<KB> (&b)[M], int lo = 0,
                                        int hi = M) {
  constexpr int KM = KA > KB ? KA : KB;
#pragma unroll
  for (int sum = KM - 1; sum >= 0; --sum)
#pragma unroll
    for (int i = 0; i < KA; ++i) {
      const int j = sum - i;
      if (j < 0 || j >= KB) continue;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if constexpr (PRED)
          mma_if(d[off + m], a.t[i], b[m].t[j][0], b[m].t[j][1],
                 m >= lo && m < hi);
        else
          mma(d[off + m], a.t[i], b[m].t[j][0], b[m].t[j][1]);
      }
    }
}

// d[i] += t[i] for the first n tiles, t then zeroed: a short mma chain's
// partial sum added in fp32 (round to nearest)
template <int N>
__device__ __forceinline__ void flush(float (&d)[N][4], float (&t)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      d[i][e] += t[i][e];
      t[i][e] = 0.f;
    }
}

// d += t with rows g and g + 8 of every tile scaled by s0, s1 (a decay
// applied in fp32 to a product's partial sum), t then zeroed
template <int N>
__device__ __forceinline__ void flush_rows(float (&d)[N][4],
                                           float (&t)[N][4], float s0,
                                           float s1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i][0] += s0 * t[i][0];
    d[i][1] += s0 * t[i][1];
    d[i][2] += s1 * t[i][2];
    d[i][3] += s1 * t[i][3];
    t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
  }
}

// cp.async.wait_group n for a run-time n in 0..3
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the slot of column tile `it` in row block jb of warp w (phase 0: jb = w,
// phase 1: jb = 7 - w)
__host__ __device__ inline int slot_of(int w, int jb, int it) {
  return jb < 4 ? it - 2 * jb : 16 - 2 * w + it - 2 * jb;
}

// the A fragment of rows r0 + g, r0 + g + 8 and columns k0 + t, k0 + t + 4
// of a row-major tile, as K terms
template <int K, typename T>
__device__ __forceinline__ OpA<K> op_rows(const T* t, int pitch, int r0,
                                          int k0, int g, int q) {
  const T* r = t + (r0 + g) * pitch + k0 + q;
  const T* r8 = r + 8 * pitch;
  return op_a<K>(to_f(r[0]), to_f(r8[0]), to_f(r[4]), to_f(r8[4]));
}

// --- (a) per head block -------------------------------------------------------

template <typename T, int NWG>
__global__ void __launch_bounds__(kThreads * NWG, 1) ssd_bwd_kernel(Args a) {
  constexpr int NTH = kThreads * NWG;
  constexpr int KD = sizeof(T) == 4 ? 3 : 1;   // terms of X, B, C
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T>(a.PB, a.PX, a.PY, a.PS, a.P8, a.nbuf, NWG);
  const int tid = threadIdx.x, wg = tid / kThreads, tl = tid % kThreads;
  const int w = tl / 32, lane = tid % 32;   // w: the warp within its group
  const int gq = lane / 4, tq = lane % 4;
  T* bs = reinterpret_cast<T*>(smem + L.bs);
  T* cs = reinterpret_cast<T*>(smem + L.region);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  unsigned char* misc = smem + L.misc + wg * L.misc_bytes;
  float* hs = reinterpret_cast<float*>(misc + L.hs);
  float* rowts = reinterpret_cast<float*>(misc + L.rows);
  float* colp = reinterpret_cast<float*>(misc + L.colp);   // [jb][i]

  const int cta = blockIdx.x;
  const int blk = cta % a.nblk;
  const int cell = cta / a.nblk;          // (b·nc + c)·g + group
  const int gi = cell % a.g, bc = cell / a.g;
  const int ci = bc % a.nc, bi = bc / a.nc;
  const int rep = a.h / a.g, h0 = gi * rep + blk * a.hb;
  const int Q = a.Q, nb = (Q + 15) / 16;
  // this warp group's Σ Wᵀ (the groups take alternate heads)
  float* part = a.part + ((long long)cta * NWG + wg) * kPartFloats +
                w * kSlots * 128;

  // B and C of the group; the pad columns N..N8 zeroed
  const long long bb = bi * a.sb[0] + ci * a.sb[1] + gi * a.sb[3];
  const long long cb = bi * a.sc[0] + ci * a.sc[1] + gi * a.sc[3];
  if (a.N8 > a.n)
    for (int e = tid; e < kQB * (a.N8 - a.n); e += NTH) {
      const int r = e / (a.N8 - a.n), col = a.n + e % (a.N8 - a.n);
      bs[r * a.PB + col] = T(0.f);
      cs[r * a.PB + col] = T(0.f);
    }
  stage_rows<T, NTH>(bs, a.PB, static_cast<const T*>(a.B) + bb, a.sb[2], 0,
                     kQB, Q, a.n, a.vb, tid);
  stage_rows<T, NTH>(cs, a.PB, static_cast<const T*>(a.C) + cb, a.sc[2], 0,
                     kQB, Q, a.n, a.vc, tid);
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // Gᵀ tiles (16 rows j x 8 columns i) into gs, in fragment order (with two
  // warp groups, each forms one of the two row blocks of its warp index)
  for (int ph = NWG == 2 ? wg : 0; ph < 2; ph += NWG) {
    const int jb = ph == 0 ? w : 7 - w;
    if (jb >= nb) continue;
    for (int it = 2 * jb; it < 2 * nb; it += 2) {
      float acc[2][4] = {}, part_[2][4] = {};
      for (int k = 0; k < a.N8; k += 8) {
        const OpA<KD> fa = op_rows<KD>(bs, a.PB, 16 * jb, k, gq, tq);
        OpB<KD> fb[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const T* cr = cs + (8 * (it + u) + gq) * a.PB + k + tq;
          fb[u] = op_b<KD>(to_f(cr[0]), to_f(cr[4]));
        }
        mma_row<2, 2>(part_, 0, fa, fb);
        if (k % 16 == 8 || k + 8 >= a.N8) flush<2>(acc, part_);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float* gp = gs + (w * kSlots + slot_of(w, jb, it + u)) * 128 + lane;
#pragma unroll
        for (int e = 0; e < 4; ++e) gp[32 * e] = acc[u][e];
      }
    }
  }
  __syncthreads();                        // cs is dead: the head buffers

  // the head buffers' pad columns (P..P8 of X and dY, N..N8 of dS) and
  // their pad rows of dS (P..P8) stay zero: cp.async never writes them
  for (int buf = 0; buf < NWG * a.nbuf; ++buf) {
    unsigned char* base = smem + L.region + buf * L.buf_bytes;
    T* xs = reinterpret_cast<T*>(base + L.x);
    float* ys = reinterpret_cast<float*>(base + L.y);
    float* ss = reinterpret_cast<float*>(base + L.s);
    if (a.P8 > a.p)
      for (int e = tid; e < kQB * (a.P8 - a.p); e += NTH) {
        const int r = e / (a.P8 - a.p), col = a.p + e % (a.P8 - a.p);
        xs[r * a.PX + col] = T(0.f);
        ys[r * a.PY + col] = 0.f;
      }
    if (a.N8 > a.n)
      for (int e = tid; e < a.P8 * (a.N8 - a.n); e += NTH) {
        const int r = e / (a.N8 - a.n), col = a.n + e % (a.N8 - a.n);
        ss[r * a.PS + col] = 0.f;
      }
  }
  __syncthreads();
  unsigned char* heads = smem + L.region + wg * a.nbuf * L.buf_bytes;

  auto stage_head = [&](int s, int buf) {
    const int hh = h0 + s;
    unsigned char* base = heads + buf * L.buf_bytes;
    const long long xb = bi * a.sx[0] + ci * a.sx[1] + hh * a.sx[3];
    stage_rows<T, kThreads>(reinterpret_cast<T*>(base + L.x), a.PX,
                            static_cast<const T*>(a.X) + xb, a.sx[2], 0, kQB,
                            Q, a.p, a.vx, tl);
    const long long yb = (((long long)bi * a.nc + ci) * Q * a.h + hh) * a.p;
    stage_rows<float, kThreads>(reinterpret_cast<float*>(base + L.y), a.PY,
                                a.dY + yb, (long long)a.h * a.p, 0, kQB, Q,
                                a.p, a.vy, tl);
    const long long sb_ =
        (((long long)bi * a.nc + ci) * a.h + hh) * (long long)a.p * a.n;
    stage_rows<float, kThreads>(reinterpret_cast<float*>(base + L.s), a.PS,
                                a.dS + sb_, a.n, 0, a.P8, a.p, a.n, a.vs,
                                tl);
    float* as_ = reinterpret_cast<float*>(base + L.a);
    const long long ab = bi * a.sa[0] + hh * a.sa[1] + ci * a.sa[2];
    for (int j = tl; j < kQB; j += kThreads)
      as_[j] = j < Q ? a.A[ab + j * a.sa[3]] : 0.f;
  };

  // this warp group's heads s = wg, wg + NWG, ..., nbuf - 1 of them staged
  // ahead of the one computed
  const int NPT = a.P8 / 8;               // column tiles of p
  const int nh = (a.hb - wg + NWG - 1) / NWG, NB = a.nbuf;
  for (int li = 0; li < NB - 1 && li < nh; ++li) {
    stage_head(wg + li * NWG, li);
    cp_commit();
  }
  for (int li = 0; li < nh; ++li) {
    const int s = wg + li * NWG, hh = h0 + s, buf = li % NB;
    if (li + NB - 1 < nh)
      stage_head(wg + (li + NB - 1) * NWG, (li + NB - 1) % NB);
    cp_commit();
    cp_wait_n(NB - 1);
    wg_sync(wg);
    unsigned char* base = heads + buf * L.buf_bytes;
    const T* xs = reinterpret_cast<const T*>(base + L.x);
    const float* ys = reinterpret_cast<const float*>(base + L.y);
    const float* ss = reinterpret_cast<const float*>(base + L.s);
    const float* as_ = reinterpret_cast<const float*>(base + L.a);
    const float alast = as_[Q - 1];
    float* dxh = a.dX + (((long long)bi * a.nc + ci) * Q * a.h + hh) * a.p;

    for (int ph = 0; ph < 2; ++ph) {
      const int jb = ph == 0 ? w : 7 - w;
      if (jb >= nb) continue;
      const int j0 = 16 * jb;
      const float aj0 = as_[j0 + gq], aj1 = as_[j0 + gq + 8];
      const float dj0 = expf(alast - aj0), dj1 = expf(alast - aj1);
      float dx[8][4], dxt[8][4];
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) dx[x][e] = dxt[x][e] = 0.f;
      // the state's term: dX = decay ⊙ (B dSᵀ), 2 p-tiles a step, 16 of n
      // a chain, the decay applied to each chain's sum
      for (int k = 0; k < a.N8; k += 8) {
        const OpA<KD> fa = op_rows<KD>(bs, a.PB, j0, k, gq, tq);
#pragma unroll
        for (int x = 0; x < 8; x += 2) {
          if (x >= NPT) break;
          OpB<3> fb[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float* sr = ss + (8 * (x + u) + gq) * a.PS + k + tq;
            fb[u] = op_b<3>(sr[0], sr[4]);
          }
          mma_row<2, 8>(dxt, x, fa, fb);
        }
        if (k % 16 == 8 || k + 8 >= a.N8) flush_rows<8>(dx, dxt, dj0, dj1);
      }
      // h_j = Σ_p X_jp · (decay_j U_jp), the rows g and g + 8
      {
        float h0s = 0.f, h1s = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (x >= NPT) break;
          const T* xr = xs + (j0 + gq) * a.PX + 8 * x + 2 * tq;
          h0s += to_f(xr[0]) * dx[x][0] + to_f(xr[1]) * dx[x][1];
          h1s += to_f(xr[8 * a.PX]) * dx[x][2] +
                 to_f(xr[8 * a.PX + 1]) * dx[x][3];
        }
        h0s += __shfl_xor_sync(0xffffffffu, h0s, 1);
        h0s += __shfl_xor_sync(0xffffffffu, h0s, 2);
        h1s += __shfl_xor_sync(0xffffffffu, h1s, 1);
        h1s += __shfl_xor_sync(0xffffffffu, h1s, 2);
        if (tq == 0) {
          hs[j0 + gq] = h0s;
          hs[j0 + gq + 8] = h1s;
        }
      }
      float rt0 = 0.f, rt1 = 0.f;         // Σ_i Tᵀ of rows g, g + 8
      // column tiles in runs of 4 (2 at the end of an odd pair count): the
      // workspace's Σ Wᵀ of the run is read first, so its latency hides
      // behind the products
      for (int it = 2 * jb; it < 2 * nb; it += 4) {
        const int i0 = 8 * it, nt = min(4, 2 * nb - it);
        float wprev[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* wp = part + slot_of(w, jb, it + u) * 128 + lane;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            wprev[u][e] = (li > 0 && u < nt) ? wp[32 * e] : 0.f;
        }
        float dm[4][4] = {}, dmt[4][4] = {};
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          if (x >= NPT) break;
          const OpA<KD> xa = op_rows<KD>(xs, a.PX, j0, 8 * x, gq, tq);
          OpB<3> fb[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* yr = ys + (i0 + 8 * u + gq) * a.PY + 8 * x + tq;
            fb[u] = u < nt ? op_b<3>(yr[0], yr[4]) : OpB<3>{};
          }
          mma_row<4, 4, KD, 3, true>(dmt, 0, xa, fb, 0, nt);
          if (x % 2 == 1 || x + 1 >= NPT) flush<4>(dm, dmt);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= nt) break;
          const int slot = slot_of(w, jb, it + u);
          const float* gp = gs + (w * kSlots + slot) * 128 + lane;
          float* wp = part + slot * 128 + lane;
          float m[4], ct[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + gq + 8 * (e >> 1);
            const int i = i0 + 8 * u + 2 * tq + (e & 1);
            float mv = 0.f, wv = 0.f;
            if (i >= j && i < Q) {
              const float l = expf(as_[i] - as_[j]);
              mv = gp[32 * e] * l;
              wv = dm[u][e] * l;
              const float tv = dm[u][e] * mv;
              if (e < 2) rt0 += tv; else rt1 += tv;
              ct[e & 1] += tv;
            }
            m[e] = mv;
            wp[32 * e] = wprev[u][e] + wv;
          }
          // Σ_j Tᵀ of the tile's columns 2t, 2t + 1, over the 8 row pairs
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            ct[c] += __shfl_xor_sync(0xffffffffu, ct[c], 4);
            ct[c] += __shfl_xor_sync(0xffffffffu, ct[c], 8);
            ct[c] += __shfl_xor_sync(0xffffffffu, ct[c], 16);
          }
          if (gq == 0) {
            colp[jb * kQB + i0 + 8 * u + 2 * tq] = ct[0];
            colp[jb * kQB + i0 + 8 * u + 2 * tq + 1] = ct[1];
          }
          // dX += Mᵀ dY over the tile's 8 columns i (k permuted: k = t is
          // column 2t, k = t + 4 column 2t + 1)
          const OpA<2> fm = op_a<2>(m[0], m[2], m[1], m[3]);
          const float* yr = ys + (i0 + 8 * u + 2 * tq) * a.PY + gq;
#pragma unroll
          for (int x = 0; x < 8; x += 2) {
            if (x >= NPT) break;
            OpB<2> fb[2];
#pragma unroll
            for (int v = 0; v < 2; ++v)
              fb[v] = op_b<2>(yr[8 * (x + v)], yr[a.PY + 8 * (x + v)]);
            mma_row<2, 8>(dxt, x, fm, fb);
          }
        }
        flush<8>(dx, dxt);                // a run: 32 of i
      }
      rt0 += __shfl_xor_sync(0xffffffffu, rt0, 1);
      rt0 += __shfl_xor_sync(0xffffffffu, rt0, 2);
      rt1 += __shfl_xor_sync(0xffffffffu, rt1, 1);
      rt1 += __shfl_xor_sync(0xffffffffu, rt1, 2);
      if (tq == 0) {
        rowts[j0 + gq] = rt0;
        rowts[j0 + gq + 8] = rt1;
      }
      // dX of the row block
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        if (x >= NPT) break;
        const int col = 8 * x + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = j0 + gq + 8 * hr;
          if (j >= Q) continue;
          float* o = dxh + (long long)j * a.h * a.p + col;
          if (col < a.p) o[0] = dx[x][2 * hr];
          if (col + 1 < a.p) o[1] = dx[x][2 * hr + 1];
        }
      }
    }
    wg_sync(wg);
    // dA of the head: Σ_j T[i, j] (column sums of Tᵀ, row blocks in
    // order) - Σ_i T[i, j] - h, plus Σ h at the last position
    for (int q = tl; q < Q; q += kThreads) {
      float cs_ = 0.f;
      for (int jb = 0; jb <= q / 16; ++jb) cs_ += colp[jb * kQB + q];
      float v = cs_ - rowts[q] - hs[q];
      if (q == Q - 1) {
        float sh = 0.f;
        for (int k = 0; k < Q; ++k) sh += hs[k];
        v += sh;
      }
      a.dA[(((long long)bi * a.h + hh) * a.nc + ci) * Q + q] = v;
    }
  }
  cp_wait_all();
}

// --- (b) per group ------------------------------------------------------------

template <typename T>
__host__ __device__ inline int group_smem(int PX, int P8, int nbuf) {
  return (kQB * kWP + 2 * kQB * kCP) * 4 +
         nbuf * (kQB * PX * (int)sizeof(T) + P8 * kCP * 4 + kQB * 4);
}

template <typename T>
__global__ void __launch_bounds__(kGroupThreads, 1)
ssd_bwd_group_kernel(Args a) {
  constexpr int KD = sizeof(T) == 4 ? 3 : 1;   // terms of X, B, C
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);           // [kQB][kWP]: ΣWᵀ
  float* csm = wt + kQB * kWP;                          // [kQB][kCP]
  float* bsm = csm + kQB * kCP;                         // [kQB][kCP]
  unsigned char* bufs = reinterpret_cast<unsigned char*>(bsm + kQB * kCP);
  const int xbytes = kQB * a.PX * (int)sizeof(T);
  const int buf_bytes = xbytes + a.P8 * kCP * 4 + kQB * 4;

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int cell = blockIdx.x;            // (b·nc + c)·g + group
  const int gi = cell % a.g, bc = cell / a.g;
  const int ci = bc % a.nc, bi = bc / a.nc;
  const int n0 = blockIdx.y * kNC, ncols = min(kNC, a.n - n0);
  const int Q = a.Q, nb = (Q + 15) / 16, QP = 16 * nb;
  const int rep = a.h / a.g;

  // Σ Wᵀ over the head blocks, in block order, on the blocks jb <= ib
  const int nparts = a.nblk * a.nwg;       // in block order, then group
  const float* part = a.part + (long long)cell * nparts * kPartFloats;
  for (int e = tid; e < QP * QP; e += kGroupThreads) {
    const int j = e / QP, i = e % QP, jb = j / 16;
    if (jb > i / 16) continue;
    const int ww = jb < 4 ? jb : 7 - jb;
    const int off = (ww * kSlots + slot_of(ww, jb, i / 8)) * 128 +
                    32 * (((j & 15) >> 3) * 2 + (i & 1)) + (j & 7) * 4 +
                    ((i & 7) >> 1);
    float s = 0.f;
    for (int k = 0; k < nparts; ++k) s += part[(long long)k * kPartFloats + off];
    wt[j * kWP + i] = s;
  }
  // this CTA's columns of B and C, in fp32; columns past N and rows past Q
  // zero
  const long long bb = bi * a.sb[0] + ci * a.sb[1] + gi * a.sb[3] + n0;
  const long long cb = bi * a.sc[0] + ci * a.sc[1] + gi * a.sc[3] + n0;
  for (int e = tid; e < kQB * kNC; e += kGroupThreads) {
    const int r = e / kNC, col = e % kNC;
    const bool ok = r < Q && col < ncols;
    bsm[r * kCP + col] =
        ok ? ldv(static_cast<const T*>(a.B) + bb + r * a.sb[2] + col) : 0.f;
    csm[r * kCP + col] =
        ok ? ldv(static_cast<const T*>(a.C) + cb + r * a.sc[2] + col) : 0.f;
  }
  // the head buffers' pad columns and rows stay zero
  for (int buf = 0; buf < a.nbuf; ++buf) {
    T* xs = reinterpret_cast<T*>(bufs + buf * buf_bytes);
    float* ss = reinterpret_cast<float*>(bufs + buf * buf_bytes + xbytes);
    if (a.P8 > a.p)
      for (int e = tid; e < kQB * (a.P8 - a.p); e += kGroupThreads)
        xs[(e / (a.P8 - a.p)) * a.PX + a.p + e % (a.P8 - a.p)] = T(0.f);
    if (ncols < kNC)
      for (int e = tid; e < a.P8 * (kNC - ncols); e += kGroupThreads)
        ss[(e / (kNC - ncols)) * kCP + ncols + e % (kNC - ncols)] = 0.f;
  }
  __syncthreads();

  auto stage_head = [&](int s, int buf) {
    const int hh = gi * rep + s;
    unsigned char* base = bufs + buf * buf_bytes;
    const long long xb = bi * a.sx[0] + ci * a.sx[1] + hh * a.sx[3];
    stage_rows<T, kGroupThreads>(reinterpret_cast<T*>(base), a.PX,
                                 static_cast<const T*>(a.X) + xb, a.sx[2], 0,
                                 kQB, Q, a.p, a.vx, tid);
    const long long sb_ =
        (((long long)bi * a.nc + ci) * a.h + hh) * (long long)a.p * a.n + n0;
    stage_rows<float, kGroupThreads>(
        reinterpret_cast<float*>(base + xbytes), kCP, a.dS + sb_, a.n, 0,
        a.P8, a.p, ncols, a.vs2, tid);
    float* as_ = reinterpret_cast<float*>(base + xbytes + a.P8 * kCP * 4);
    const long long ab = bi * a.sa[0] + hh * a.sa[1] + ci * a.sa[2];
    for (int j = tid; j < kQB; j += kGroupThreads)
      as_[j] = j < Q ? a.A[ab + j * a.sa[3]] : 0.f;
  };
  // a pipeline of nbuf head buffers: nbuf - 1 heads in flight ahead of
  // the one computed (one cp.async group a head, empty past the last)
  const int NB = a.nbuf;
  for (int s = 0; s < NB - 1 && s < rep; ++s) {
    stage_head(s, s);
    cp_commit();
  }
  const int j0 = 16 * w;
  const bool live = w < nb;
  float acc[4][4] = {}, tmp[4][4] = {};
  for (int s = 0; s < rep; ++s) {
    const int buf = s % NB;
    if (s + NB - 1 < rep) stage_head(s + NB - 1, (s + NB - 1) % NB);
    cp_commit();
    cp_wait_n(NB - 1);
    __syncthreads();
    if (live) {
      const unsigned char* base = bufs + buf * buf_bytes;
      const T* xs = reinterpret_cast<const T*>(base);
      const float* ss = reinterpret_cast<const float*>(base + xbytes);
      const float* as_ =
          reinterpret_cast<const float*>(base + xbytes + a.P8 * kCP * 4);
      const float alast = as_[Q - 1];
      const float d0 = expf(alast - as_[j0 + gq]);
      const float d1 = expf(alast - as_[j0 + gq + 8]);
      // acc += decay ⊙ (X dS) over p, the decay applied to each chain's sum
      for (int k = 0; k < a.P8; k += 8) {
        const OpA<KD> fa = op_rows<KD>(xs, a.PX, j0, k, gq, tq);
        OpB<3> fb[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float* sr = ss + (k + tq) * kCP + 8 * x + gq;
          fb[x] = op_b<3>(sr[0], sr[4 * kCP]);
        }
        mma_row<4, 4>(tmp, 0, fa, fb);
        if (k % 16 == 8 || k + 8 >= a.P8) flush_rows<4>(acc, tmp, d0, d1);
      }
    }
    __syncthreads();
  }
  cp_wait_all();
  if (!live) return;
  // dB += (ΣW)ᵀ C over the columns i >= the row block
  for (int k = j0; k < QP; k += 8) {
    const float* wr = wt + (j0 + gq) * kWP + k + tq;
    const OpA<3> fa = op_a<3>(wr[0], wr[8 * kWP], wr[4], wr[8 * kWP + 4]);
    OpB<KD> fb[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* cr = csm + (k + tq) * kCP + 8 * x + gq;
      fb[x] = op_b<KD>(cr[0], cr[4 * kCP]);
    }
    mma_row<4, 4>(tmp, 0, fa, fb);
    if ((k - j0) % 16 == 8 || k + 8 >= QP) flush<4>(acc, tmp);
  }
  const long long orow = ((long long)bi * a.nc + ci) * Q;
  auto store = [&](float* out, const float (&c)[4][4], int r0) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = 8 * x + 2 * tq;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = r0 + gq + 8 * hr;
        if (r >= Q) continue;
        float* o = out + ((orow + r) * a.g + gi) * a.n + n0 + col;
        if (col < ncols) o[0] = c[x][2 * hr];
        if (col + 1 < ncols) o[1] = c[x][2 * hr + 1];
      }
    }
  };
  store(a.dB, acc, j0);
  // dC = (ΣW) B over the rows j <= the row block: A[i][j] = ΣWᵀ[j][i]
  float dc[4][4] = {};
  for (int k = 0; k < j0 + 16; k += 8) {
    const float* wr = wt + (k + tq) * kWP + j0 + gq;
    const OpA<3> fa = op_a<3>(wr[0], wr[8], wr[4 * kWP], wr[4 * kWP + 8]);
    OpB<KD> fb[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float* br = bsm + (k + tq) * kCP + 8 * x + gq;
      fb[x] = op_b<KD>(br[0], br[4 * kCP]);
    }
    mma_row<4, 4>(tmp, 0, fa, fb);
    if (k % 16 == 8) flush<4>(dc, tmp);
  }
  store(a.dC, dc, j0);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  // set on every launch: the bytes depend on the shapes (a cheap call)
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

constexpr int kSmemCap = 232448 - 1024;

template <typename T>
cudaError_t launch_t(Args a, int b, cudaStream_t stream) {
  a.PB = pitch_of<T>(a.N8);
  a.PX = pitch_of<T>(a.P8);
  a.PY = pitch_f32(a.P8);
  a.PS = pitch_f32(a.N8);
  // two warp groups (8 warps an SM) on alternate heads where two head
  // buffers fit, else one group with two buffers (one staged ahead) or one
  a.nwg = 2;
  a.nbuf = 1;
  Layout l = layout<T>(a.PB, a.PX, a.PY, a.PS, a.P8, 1, 2);
  if (a.hb < 2 || l.total > kSmemCap) {
    a.nwg = 1;
    a.nbuf = 2;
    l = layout<T>(a.PB, a.PX, a.PY, a.PS, a.P8, 2, 1);
    if (a.hb < 2 || l.total > kSmemCap) {
      a.nbuf = 1;
      l = layout<T>(a.PB, a.PX, a.PY, a.PS, a.P8, 1, 1);
    }
  }
  if (l.total > kSmemCap) return cudaErrorInvalidValue;
  const long long ctas = (long long)b * a.nc * a.g * a.nblk;
  cudaError_t e;
  if (a.nwg == 2) {
    e = allow_smem(ssd_bwd_kernel<T, 2>, l.total);
    if (e != cudaSuccess) return e;
    ssd_bwd_kernel<T, 2><<<(unsigned)ctas, 2 * kThreads, l.total, stream>>>(a);
  } else {
    e = allow_smem(ssd_bwd_kernel<T, 1>, l.total);
    if (e != cudaSuccess) return e;
    ssd_bwd_kernel<T, 1><<<(unsigned)ctas, kThreads, l.total, stream>>>(a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rep = a.h / a.g;
  a.nbuf = 1;                             // up to 4 buffers that fit
  while (a.nbuf < 4 && a.nbuf < rep &&
         group_smem<T>(a.PX, a.P8, a.nbuf + 1) <= kSmemCap)
    ++a.nbuf;
  const int gbytes = group_smem<T>(a.PX, a.P8, a.nbuf);
  e = allow_smem(ssd_bwd_group_kernel<T>, gbytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_group_kernel<T>
      <<<dim3((unsigned)((long long)b * a.nc * a.g), (a.n + kNC - 1) / kNC),
         kGroupThreads, gbytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The floats of the Σ Wᵀ workspace a CTA of (a) may write (one partial a
// warp group): the wrapper sizes the workspace as b·c·h/hb of them.
int ssd_intra_chunk_bwd_part_floats() { return 2 * kPartFloats; }

// X (b, c, Q, h, p) fp32 or bf16, B and C (b, c, Q, g, n) alike (bf16 =
// 1), g dividing h; A_cs (b, h, c, Q) fp32; dY (b, c, Q, h, p) and dS
// (b, c, h, p, n) fp32 contiguous; dX, dA fp32 contiguous in the layouts
// of X, A_cs; dB, dC (b, c, Q, g, n) fp32 contiguous; part: the Σ Wᵀ
// workspace, b·c·(h/hb)·part_floats floats. st: element strides (b, c,
// q, h) of X [0..3], (b, c, q, g) of B [4..7] and C [8..11] (the last
// dim's stride is 1), then (b, h, c, q) of A_cs [12..15]. hb: heads a CTA
// of (a), dividing h/g. Q <= 128, p <= 64, n <= 128. Returns the CUDA
// error.
int ssd_intra_chunk_bwd_launch(const void* X, const void* A, const void* B,
                               const void* C, const void* dY, const void* dS,
                               void* dX, void* dA, void* dB, void* dC,
                               void* part, const long long* st, int b, int c,
                               int Q, int h, int g, int p, int n, int hb,
                               int bf16, void* stream) {
  if (b <= 0 || c <= 0 || h <= 0 || g <= 0 || h % g != 0 || hb <= 0 ||
      (h / g) % hb != 0 || Q <= 0 || Q > kQB || p <= 0 || p > 64 || n <= 0 ||
      n > 128 || (long long)b * c * h >= (1ll << 31))
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
  a.part = static_cast<float*>(part);
  for (int i = 0; i < 4; ++i) {
    a.sx[i] = st[i];
    a.sb[i] = st[4 + i];
    a.sc[i] = st[8 + i];
    a.sa[i] = st[12 + i];
  }
  a.nc = c;
  a.Q = Q;
  a.h = h;
  a.g = g;
  a.p = p;
  a.n = n;
  a.hb = hb;
  a.nblk = h / g / hb;
  a.P8 = (p + 7) / 8 * 8;
  a.N8 = (n + 7) / 8 * 8;
  const int es = bf16 ? 2 : 4;
  a.vx = copy_width(X, a.sx, 4, p * es, es);
  a.vb = copy_width(B, a.sb, 4, n * es, es);
  a.vc = copy_width(C, a.sc, 4, n * es, es);
  const long long ys[2] = {(long long)h * p, p};
  a.vy = copy_width(dY, ys, 2, p * 4, 4);
  const long long ss[2] = {n, (long long)p * n};
  a.vs = copy_width(dS, ss, 2, n * 4, 4);
  // (b) copies dS in chunks of kNC columns (the last one n % kNC wide)
  const long long ss2[3] = {n, (long long)p * n, kNC};
  a.vs2 = copy_width(dS, ss2, 3, (n % kNC ? n % kNC : kNC) * 4, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_t<__nv_bfloat16>(a, b, s)
                    : launch_t<float>(a, b, s));
}

}  // extern "C"
