// EDC cosine block E = K(ΔW, Vᵀ) (paper eq. 8) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `edc_cosine` (src/repro/kernels/
// edc_cosine.py:49, body `_kernel` :27):
//   E[i, j] = <ΔW_i, V_:,j> / max(||ΔW_i|| * max(||V_:,j||, eps), eps).
//
// What bounds it on this card: memory. ΔW is tall and thin (n = α·m rows,
// tens to hundreds; d = d_w columns, up to ~4e5 for MLP-512; m <= 16), so
// the kernel does ~2(m+1) flops per ΔW element it reads — far below the
// ~20 flops/byte where fp32 CUDA cores, not HBM, would be the limit. The
// least time is the ΔW bytes over 3.35 TB/s.
//
// Design: a split-d reduction in two passes, no float atomics, so repeated
// runs agree bit for bit.
//   pass 1  one block per d-chunk of C columns. It stages V[chunk, :m]
//           in shared memory, transposed (vs[k][c], so a warp reading
//           consecutive columns hits consecutive banks), then each warp
//           streams whole rows of ΔW over the chunk, coalesced, keeping
//           m dot products and one sum of squares in registers, and
//           reduces them across the warp with a fixed shuffle tree. ΔW is
//           read exactly once and V exactly once. The block also writes
//           the chunk's sums of squares of V's columns.
//   pass 2  one block per row sums the per-chunk partials in a fixed
//           order (strided per thread, then a shared-memory tree), and
//           normalises with the reference's two eps clamps
//           (edc_cosine.py:63-64 and :43-44).
// ΔW and V may each be fp32 or bf16; all arithmetic is fp32. m is padded
// to a compile-time M in {4, 8, 16}; padded columns are zeros and never
// written. The TPU kernel's 128-lane padding of m and its VMEM scratch
// carried across grid steps have no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinThreads = 128;
constexpr float kEps = 1e-12f;

template <int M>
struct Chunk {
  static constexpr int value = (M <= 8) ? 1024 : 512;   // M*C*4 B <= 32 KB
};

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

template <typename TW, typename TV, int M>
__global__ void __launch_bounds__(kThreads)
edc_partial_kernel(const TW* __restrict__ dW, const TV* __restrict__ V,
                   float* __restrict__ part, float* __restrict__ vpart,
                   int n, int d, int m) {
  constexpr int C = Chunk<M>::value;
  __shared__ float vs[M * C];                 // vs[k * C + c]
  const int ch = blockIdx.x;
  const long long c0 = (long long)ch * C;
  const int cw = (int)min((long long)C, (long long)d - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int e = threadIdx.x; e < C * M; e += kThreads) {
    const int c = e / M, k = e % M;
    float v = 0.f;
    if (c < cw && k < m) v = to_f(V[(c0 + c) * m + k]);
    vs[k * C + c] = v;
  }
  __syncthreads();

  // column sums of squares of this chunk of V: one warp per column
  for (int k = warp; k < M; k += kWarps) {
    float s = 0.f;
    for (int c = lane; c < cw; c += 32) s = fmaf(vs[k * C + c], vs[k * C + c], s);
    s = warp_sum(s);
    if (lane == 0) vpart[(long long)ch * M + k] = s;
  }

  // one warp per row of ΔW, streaming the chunk
  for (int r = warp; r < n; r += kWarps) {
    const TW* row = dW + (long long)r * d + c0;
    float acc[M];
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] = 0.f;
    float sq = 0.f;
#pragma unroll 8
    for (int c = lane; c < cw; c += 32) {
      const float w = to_f(row[c]);
      sq = fmaf(w, w, sq);
#pragma unroll
      for (int k = 0; k < M; ++k) acc[k] = fmaf(w, vs[k * C + c], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] = warp_sum(acc[k]);
    sq = warp_sum(sq);
    if (lane == 0) {
      float* p = part + ((long long)ch * n + r) * (M + 1);
#pragma unroll
      for (int k = 0; k < M; ++k) p[k] = acc[k];
      p[M] = sq;
    }
  }
}

template <int M>
__global__ void __launch_bounds__(kFinThreads)
edc_finalize_kernel(const float* __restrict__ part,
                    const float* __restrict__ vpart, float* __restrict__ out,
                    int n, int m, int nch) {
  __shared__ float red[kFinThreads][M + 1];   // dots, then the row's sq
  __shared__ float vred[kFinThreads][M + 1];  // V column sums of squares
  const int r = blockIdx.x, t = threadIdx.x;
  float a[M + 1], v[M];
#pragma unroll
  for (int k = 0; k <= M; ++k) a[k] = 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) v[k] = 0.f;
  for (int ch = t; ch < nch; ch += kFinThreads) {
    const float* p = part + ((long long)ch * n + r) * (M + 1);
#pragma unroll
    for (int k = 0; k <= M; ++k) a[k] += p[k];
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += vpart[(long long)ch * M + k];
  }
#pragma unroll
  for (int k = 0; k <= M; ++k) red[t][k] = a[k];
#pragma unroll
  for (int k = 0; k < M; ++k) vred[t][k] = v[k];
  __syncthreads();
  for (int s = kFinThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k <= M; ++k) red[t][k] += red[t + s][k];
#pragma unroll
      for (int k = 0; k < M; ++k) vred[t][k] += vred[t + s][k];
    }
    __syncthreads();
  }
  if (t < m) {
    const float rn = sqrtf(red[0][M]);
    const float vn = fmaxf(sqrtf(vred[0][t]), kEps);
    out[(long long)r * m + t] = red[0][t] / fmaxf(rn * vn, kEps);
  }
}

int padded_m(int m) {
  if (m <= 4) return 4;
  if (m <= 8) return 8;
  if (m <= 16) return 16;
  return -1;
}

template <int M>
long long chunks(int d) {
  constexpr int C = Chunk<M>::value;
  return (d + (long long)C - 1) / C;
}

long long chunks_for(int d, int M) {
  switch (M) {
    case 4: return chunks<4>(d);
    case 8: return chunks<8>(d);
    default: return chunks<16>(d);
  }
}

template <typename TW, typename TV, int M>
cudaError_t run(const void* dW, const void* V, float* out, float* scratch,
                int n, int d, int m, cudaStream_t s) {
  const long long nch = chunks<M>(d);
  float* part = scratch;
  float* vpart = scratch + nch * n * (M + 1);
  edc_partial_kernel<TW, TV, M><<<(unsigned)nch, kThreads, 0, s>>>(
      static_cast<const TW*>(dW), static_cast<const TV*>(V), part, vpart,
      n, d, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  edc_finalize_kernel<M><<<n, kFinThreads, 0, s>>>(part, vpart, out, n, m,
                                                   (int)nch);
  return cudaGetLastError();
}

template <typename TW, typename TV>
cudaError_t run_m(const void* dW, const void* V, float* out, float* scratch,
                  int n, int d, int m, cudaStream_t s) {
  switch (padded_m(m)) {
    case 4: return run<TW, TV, 4>(dW, V, out, scratch, n, d, m, s);
    case 8: return run<TW, TV, 8>(dW, V, out, scratch, n, d, m, s);
    case 16: return run<TW, TV, 16>(dW, V, out, scratch, n, d, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Floats of scratch the launch needs (per-chunk partials), -1 if m > 16.
long long edc_cosine_scratch(int n, int d, int m) {
  const int M = padded_m(m);
  if (M < 0) return -1;
  const long long nch = chunks_for(d, M);
  return nch * n * (M + 1) + nch * M;
}

// dW (n, d) and V (d, m), row-major; *_bf16 = 1 for bf16, 0 for fp32.
// out (n, m) fp32. Returns cudaGetLastError() after the launches.
int edc_cosine_launch(const void* dW, const void* V, void* out,
                      void* scratch, int n, int d, int m, int dw_bf16,
                      int v_bf16, void* stream) {
  if (n <= 0 || d <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  cudaError_t e;
  if (dw_bf16 && v_bf16)
    e = run_m<__nv_bfloat16, __nv_bfloat16>(dW, V, o, sc, n, d, m, s);
  else if (dw_bf16)
    e = run_m<__nv_bfloat16, float>(dW, V, o, sc, n, d, m, s);
  else if (v_bf16)
    e = run_m<float, __nv_bfloat16>(dW, V, o, sc, n, d, m, s);
  else
    e = run_m<float, float>(dW, V, o, sc, n, d, m, s);
  return (int)e;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
