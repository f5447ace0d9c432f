// EDC cosine block E = K(ΔW, Vᵀ) (paper eq. 8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `edc_cosine` (src/repro/kernels/
// edc_cosine.py:49, body `_kernel` :27):
//   E[i, j] = <ΔW_i, V_:,j> / max(||ΔW_i|| * max(||V_:,j||, eps), eps).
//
// What bounds it on this card: memory, up to m ~ 38. ΔW is tall and thin
// (n = α·m rows, tens to hundreds; d = d_w columns, ~4e5 for MLP-512), so
// the kernel does 2(m+1) flops per 4-byte ΔW element against the ~20
// flops a byte where fp32 CUDA cores, not HBM, would set the pace. The
// least time is ΔW's and V's bytes over 3.35 TB/s.
//
// Design: a split-d reduction in two kernels, no float atomics, so
// repeated runs agree bit for bit. The plan (slice length, row blocks,
// column tiles) comes from the wrapper (kernels/edc_cosine.py, `plan`),
// which sizes the slices from the card's SM count so that the grid is a
// whole number of waves of two CTAs an SM, every CTA the same work; this
// file checks it.
//   edc_part_kernel   one CTA of 8 warps per (d-slice, block of up to 256
//       rows, column tile of MB <= 16 of V's columns). V is read once per
//       CTA: its tile is staged by cp.async into shared memory as
//       vs[c][k] with a row stride S ≡ 4 (mod 8), so the float4 reads of
//       a quarter warp hit 32 banks. A step is 4 rows × kStep columns; a
//       row group's steps follow each other, and the CTA's steps are split
//       evenly over the warps, so no warp idles while another finishes a
//       row group. In a step a lane loads ΔW at columns lane + 32u
//       (coalesced) of the 4 rows, the next step's loads in flight while
//       it uses this one's; every V value read from shared memory feeds
//       4 FMAs, every ΔW value MB + 1 (the tile's dots and the sum of
//       squares). The first step's loads are issued before V is staged.
//       At the end of a row group (or of its steps) a warp reduces its
//       sums across lanes with a fixed shuffle tree and writes them; a
//       row group split between two warps is summed head + tail after a
//       barrier. The CTAs of row block 0 also write the slice's column
//       sums of squares of V. For m > 16 the column tiles of one slice
//       and row block are consecutive CTAs, so ΔW comes from HBM once
//       and from L2 for the other tiles.
//   edc_finalize_kernel  one CTA per row, a warp per column of V, sums
//       the per-slice partials in a fixed order (lanes strided over the
//       slices, then a shuffle tree) and normalises with the reference's
//       two eps clamps (edc_cosine.py:63-64 and :43-44). Launched with
//       programmatic dependent launch, so its launch overlaps the partial
//       kernel's tail.
//   edc_sums_kernel  the partial-sum entry's second kernel (a d-block of
//       ΔW on a model axis): the same sums in the same order, written
//       undivided as one packed buffer [dots (n, m) | row squares (n) |
//       V's column squares (m)], which the caller all-reduces over the
//       model axis before it divides. One CTA per row, one more for V.
// ΔW and V may each be fp32 or bf16; all arithmetic is fp32. Rows past n
// and columns past d or m are read as zeros (or clamped) and never
// written. The TPU kernel's 128-lane padding of m and its VMEM scratch
// carried across grid steps have no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kR = 4;                       // rows per warp and step
constexpr int kRowsMax = 256;               // rows per CTA
constexpr int kSmemMax = 113 * 1024;        // two CTAs an SM
constexpr float kEps = 1e-12f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A column tile of MB of V's columns: vs's row stride S ≡ 4 (mod 8)
// floats, so the float4 reads of 8 consecutive columns by a quarter warp
// hit 32 banks; U ΔW loads per lane and row a step (kStep columns: 8
// loads measured slower, their registers spill beside the MB·4 sums); NV
// sums a warp keeps (a row's MB dots and its sum of squares, 4 rows).
template <int MB>
struct Tile {
  static constexpr int S = (MB % 8 == 4) ? MB : MB + 4;
  static constexpr int Q = MB / 4;
  static constexpr int U = MB <= 12 ? 4 : 2;
  static constexpr int kStep = 32 * U;
  static constexpr int NV = kR * (MB + 1);
};

struct Args {
  int n, d, m, slice, ns, nrb, rows, ncb;
};

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Floats of shared memory: V's tile (the slice rounded up to whole steps)
// and the pieces of the row groups two warps share.
template <int MB>
long long smem_floats(int slice) {
  using T = Tile<MB>;
  return cdiv(slice, T::kStep) * T::kStep * T::S + 2LL * kWarps * T::NV;
}

// part[(r * (m + 1) + j) * ns + s]: slice s's dot of row r with V's column
// j (j < m) or its sum of squares (j = m); then vpart[k * ns + s].
template <typename TW, typename TV, int MB>
__global__ void __launch_bounds__(kThreads, 2)
edc_part_kernel(const TW* __restrict__ dW, const TV* __restrict__ V,
                float* __restrict__ part, Args a) {
  using T = Tile<MB>;
  constexpr int S = T::S, Q = T::Q, U = T::U, kStep = T::kStep, NV = T::NV;
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x % a.ncb;
  const int rb = (blockIdx.x / a.ncb) % a.nrb;
  const int s = blockIdx.x / (a.ncb * a.nrb);
  const long long c0 = (long long)s * a.slice;
  const int cw = (int)min((long long)a.slice, (long long)a.d - c0);
  const int nb = (cw + kStep - 1) / kStep;    // steps a row group
  const int lp = ((a.slice + kStep - 1) / kStep) * kStep;
  float* vs = reinterpret_cast<float*>(smem4);         // vs[c * S + k]
  float* head = vs + (long long)lp * S;                 // [warp][NV]
  float* tail = head + kWarps * NV;
  const int kb = b * MB, m = a.m, ns = a.ns;
  const int row0 = rb * a.rows;
  const int rows = min(a.rows, a.n - row0);
  const int G = (rows + kR - 1) / kR;         // row groups of this CTA
  const int steps = G * nb;                   // split over the warps
  const int aw = min(kWarps, G);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto first = [&](int w) { return (int)((long long)w * steps / aw); };
  const int t0 = warp < aw ? first(warp) : 0;
  const int t1 = warp < aw ? first(warp + 1) : 0;

  // a segment: the steps [ja, jb) of row group g that this warp owns
  // (whole row groups, or a head or a tail piece of one)
  int g = t0 / nb, ja = t0 - g * nb;
  const TW* rp[kR];
  auto set_rows = [&]() {
#pragma unroll
    for (int i = 0; i < kR; ++i)
      rp[i] = dW + c0 + (long long)(row0 + min(kR * g + i, rows - 1)) * a.d;
  };
  float wa[kR][U], wb[kR][U];
  auto load = [&](float (&w)[kR][U], int j) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = j * kStep + lane + 32 * u;
#pragma unroll
      for (int i = 0; i < kR; ++i) w[i][u] = c < cw ? to_f(rp[i][c]) : 0.f;
    }
  };
  set_rows();
  if (t0 < t1) load(wa, ja);                  // in flight while V stages

  // stage V[c0 : c0 + lp, kb : kb + MB], zeros past d and m, element by
  // element in V's row-major order (runs of MB consecutive floats): fp32
  // by cp.async (no registers), bf16 through registers (converted)
#pragma unroll 4
  for (int e = threadIdx.x; e < lp * MB; e += kThreads) {
    const int c = e / MB, k = e % MB;
    const bool ok = c < cw && kb + k < m;
    if constexpr (std::is_same<TV, float>::value) {
      const float* src = ok ? V + (c0 + c) * m + kb + k : V;
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(vs + c * S + k);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
    } else {
      vs[c * S + k] = ok ? to_f(V[(c0 + c) * m + kb + k]) : 0.f;
    }
  }
  if constexpr (std::is_same<TV, float>::value)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (rb == 0) {                              // V's column sums of squares
    float* vpart = part + (long long)a.n * (m + 1) * ns;
    for (int k = warp; k < MB && kb + k < m; k += kWarps) {
      float q = 0.f;
      for (int c = lane; c < cw; c += 32)
        q = fmaf(vs[c * S + k], vs[c * S + k], q);
      q = warp_sum(q);
      if (lane == 0) vpart[(long long)(kb + k) * ns + s] = q;
    }
  }

  float acc[kR][MB], sq[kR];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      sq[i] = 0.f;
#pragma unroll
      for (int k = 0; k < MB; ++k) acc[i][k] = 0.f;
    }
  };
  zero();
  auto fma_step = [&](const float (&w)[kR][U], int j) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float4* vr = smem4 + ((j * kStep + lane + 32 * u) * S) / 4;
#pragma unroll
      for (int i = 0; i < kR; ++i) sq[i] = fmaf(w[i][u], w[i][u], sq[i]);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 v = vr[q];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          acc[i][4 * q] = fmaf(w[i][u], v.x, acc[i][4 * q]);
          acc[i][4 * q + 1] = fmaf(w[i][u], v.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(w[i][u], v.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(w[i][u], v.w, acc[i][4 * q + 3]);
        }
      }
    }
  };
  // each segment: its steps with the next one's loads in flight, then
  // its sums reduced across lanes; a whole row group is written, a piece
  // of one kept for the combine below (a head: the group's first steps,
  // the warp's last segment; a tail: the rest, the next warp's first)
#pragma unroll 1
  for (int t = t0; t < t1;) {
    const int jb = min(nb, ja + (t1 - t));
    if (t != t0) {
      set_rows();
      load(wa, ja);
    }
#pragma unroll 1
    for (int j = ja; j < jb; j += 2) {
      if (j + 1 < jb) load(wb, j + 1);
      fma_step(wa, j);
      if (j + 1 >= jb) break;
      if (j + 2 < jb) load(wa, j + 2);
      fma_step(wb, j + 1);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int k = 0; k < MB; ++k) acc[i][k] = warp_sum(acc[i][k]);
      sq[i] = warp_sum(sq[i]);
    }
    if (lane == 0 && ja == 0 && jb == nb) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        if (kR * g + i >= rows) break;
        float* p = part + (long long)(row0 + kR * g + i) * (m + 1) * ns + s;
#pragma unroll
        for (int k = 0; k < MB; ++k)
          if (kb + k < m) p[(long long)(kb + k) * ns] = acc[i][k];
        if (b == 0) p[(long long)m * ns] = sq[i];
      }
    } else if (lane == 0) {
      float* piece = (ja == 0 ? head : tail) + warp * NV;
#pragma unroll
      for (int i = 0; i < kR; ++i) {
#pragma unroll
        for (int k = 0; k < MB; ++k) piece[i * (MB + 1) + k] = acc[i][k];
        piece[i * (MB + 1) + MB] = sq[i];
      }
    }
    zero();
    t += jb - ja;
    ++g;
    ja = 0;
  }
  __syncthreads();

  // a row group split between warps w - 1 and w: head + tail, in order;
  // value v = i * (MB + 1) + k of the group (k = MB: the squares)
  for (int x = threadIdx.x; x < (aw - 1) * NV; x += kThreads) {
    const int w = 1 + x / NV, v = x % NV;
    const int tw = first(w);
    const int gs = tw / nb, i = v / (MB + 1), k = v % (MB + 1);
    if (tw % nb == 0 || kR * gs + i >= rows) continue;
    float* p = part + (long long)(row0 + kR * gs + i) * (m + 1) * ns + s;
    const float sum = head[(w - 1) * NV + v] + tail[w * NV + v];
    if (k < MB && kb + k < m) p[(long long)(kb + k) * ns] = sum;
    else if (k == MB && b == 0) p[(long long)m * ns] = sum;
  }
}

__global__ void __launch_bounds__(kThreads)
edc_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n, int m, int ns) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* p = part + (long long)r * (m + 1) * ns;
  const float* psq = p + (long long)m * ns;
  const float* vpart = part + (long long)n * (m + 1) * ns;
  // a warp per column k sums its dot, the row's squares (every warp, in
  // the same order) and V's column squares together: three loads in
  // flight per lane and step
  for (int k = warp; k < m; k += kWarps) {
    const float* pd = p + (long long)k * ns;
    const float* pv = vpart + (long long)k * ns;
    float dot = 0.f, sq = 0.f, vq = 0.f;
#pragma unroll 8
    for (int x = lane; x < ns; x += 32) {
      dot += pd[x];
      sq += psq[x];
      vq += pv[x];
    }
    dot = warp_sum(dot);
    sq = warp_sum(sq);
    vq = warp_sum(vq);
    const float vn = fmaxf(sqrtf(vq), kEps);
    if (lane == 0)
      out[(long long)r * m + k] = dot / fmaxf(sqrtf(sq) * vn, kEps);
  }
}

// out = [dots (n, m) | row sums of squares (n) | V's column sums of
// squares (m)]: edc_finalize_kernel's sums, nothing divided. CTA r < n
// sums row r (a warp per dot, k = m its squares); CTA n sums V's columns.
__global__ void __launch_bounds__(kThreads)
edc_sums_kernel(const float* __restrict__ part, float* __restrict__ out,
                int n, int m, int ns) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool vrow = r == n;
  const float* p = vrow ? part + (long long)n * (m + 1) * ns
                        : part + (long long)r * (m + 1) * ns;
  for (int k = warp; k < (vrow ? m : m + 1); k += kWarps) {
    const float* pk = p + (long long)k * ns;
    float sum = 0.f;
#pragma unroll 8
    for (int x = lane; x < ns; x += 32) sum += pk[x];
    sum = warp_sum(sum);
    if (lane == 0)
      out[vrow ? (long long)n * m + n + k
               : (k < m ? (long long)r * m + k : (long long)n * m + r)] = sum;
  }
}

template <typename TW, typename TV, int MB>
cudaError_t run(const void* dW, const void* V, float* out, float* part,
                const Args& a, bool sums, cudaStream_t st) {
  const long long smem = smem_floats<MB>(a.slice) * (long long)sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kern = edc_part_kernel<TW, TV, MB>;
  static bool attr[kMaxDevices] = {};        // once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !attr[dev]) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) attr[dev] = true;
  }
  kern<<<(unsigned)((long long)a.ns * a.nrb * a.ncb), kThreads, (size_t)smem,
         st>>>(static_cast<const TW*>(dW), static_cast<const TV*>(V), part,
               a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.n + (sums ? 1u : 0u));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sums ? edc_sums_kernel : edc_finalize_kernel,
                            static_cast<const float*>(part), out, a.n, a.m,
                            a.ns);
}

template <typename TW, typename TV>
cudaError_t run_mb(int MB, const void* dW, const void* V, float* out,
                   float* part, const Args& a, bool sums, cudaStream_t st) {
  switch (MB) {
    case 4: return run<TW, TV, 4>(dW, V, out, part, a, sums, st);
    case 8: return run<TW, TV, 8>(dW, V, out, part, a, sums, st);
    case 12: return run<TW, TV, 12>(dW, V, out, part, a, sums, st);
    case 16: return run<TW, TV, 16>(dW, V, out, part, a, sums, st);
    default: return cudaErrorInvalidValue;
  }
}

// prm = {n, d, m, dw_bf16, v_bf16, slice, ns, rows per CTA, nrb, MB, ncb}:
// the wrapper's plan, checked here.
int launch(const void* dW, const void* V, void* out, void* scratch,
           const long long* prm, bool sums, void* stream) {
  const Args a = {(int)prm[0], (int)prm[1], (int)prm[2], (int)prm[5],
                  (int)prm[6], (int)prm[8], (int)prm[7], (int)prm[10]};
  const int dw_bf16 = (int)prm[3], v_bf16 = (int)prm[4], MB = (int)prm[9];
  if (a.n <= 0 || a.d <= 0 || a.m <= 0 || a.slice <= 0 || a.slice % 32 ||
      a.ns != cdiv(a.d, a.slice) || a.rows <= 0 || a.rows % kR ||
      a.rows > kRowsMax || a.nrb != cdiv(a.n, a.rows) ||
      (long long)a.ncb * MB < a.m || (long long)(a.ncb - 1) * MB >= a.m)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(scratch);
  cudaError_t e;
  if (dw_bf16 && v_bf16)
    e = run_mb<__nv_bfloat16, __nv_bfloat16>(MB, dW, V, o, p, a, sums, st);
  else if (dw_bf16)
    e = run_mb<__nv_bfloat16, float>(MB, dW, V, o, p, a, sums, st);
  else if (v_bf16)
    e = run_mb<float, __nv_bfloat16>(MB, dW, V, o, p, a, sums, st);
  else
    e = run_mb<float, float>(MB, dW, V, o, p, a, sums, st);
  return (int)e;
}

}  // namespace

extern "C" {

// Floats of scratch a launch with this plan writes (per-slice partials of
// the n·(m+1) row sums and of V's m column sums of squares).
long long edc_cosine_scratch(int n, int m, int ns) {
  return ((long long)n * (m + 1) + m) * ns;
}

// dW (n, d) and V (d, m), row-major; out (n, m) fp32 cosines. prm: the
// plan (see `launch`). Returns cudaGetLastError() after the launches.
int edc_cosine_launch(const void* dW, const void* V, void* out,
                      void* scratch, const long long* prm, void* stream) {
  return launch(dW, V, out, scratch, prm, false, stream);
}

// The partial-sum entry: the same first kernel, then edc_sums_kernel;
// out (n·m + n + m) fp32 = [dots | row squares | V's column squares].
int edc_cosine_sums_launch(const void* dW, const void* V, void* out,
                           void* scratch, const long long* prm,
                           void* stream) {
  return launch(dW, V, out, scratch, prm, true, stream);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
