// Blocked MADC proximity (paper eq. 7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `madc_block` (src/repro/kernels/madc.py:78,
// body `_kernel` :46, tiles `madc_tiles` :31):
//   MADC(i, j) = sum_{z != i, j} |M_iz - M_jz| / max(n - 2, 1).
//
// What bounds it on this card: operations. M is n*n fp32 (4 MB at n=1024)
// and is read a few times from L2, but the work is ~3 n^3 fp32 operations
// (subtract, absolute value, add) — 3.2 G at n=1024, ~48 us at 67 TFLOP/s.
// An absolute difference is not a dot product, so the tensor cores cannot
// take it: this runs on the CUDA cores. At the main path's n = α·m = 100
// the kernel is bound by launch latency instead.
//
// Design: each 256-thread block computes one 64x64 output tile; each
// thread owns a 4x4 register tile of it (rows ty+16p, columns tx+16q). The
// block walks z in steps of 32, staging the i-rows and j-rows of M for that
// z-slice in shared memory (rows padded to 33 floats, so the 16 column
// owners of a warp hit 16 different banks). The z = i and z = j exclusions
// are a select inside the accumulation; z >= n and rows >= n are staged as
// zeros and contribute |0 - 0| = 0. No (n, n, n) difference cube exists:
// live memory is the two 64x32 slices. Every tile is computed (symmetry is
// not used yet).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kBz = 32;        // z-slice per shared-memory stage
constexpr int kDim = 16;       // threads per tile edge
constexpr int kReg = kTile / kDim;   // 4x4 outputs per thread

__global__ void __launch_bounds__(kDim * kDim)
madc_kernel(const float* __restrict__ M, float* __restrict__ out, int n) {
  __shared__ float si[kTile][kBz + 1];
  __shared__ float sj[kTile][kBz + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDim + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  int gi[kReg], gj[kReg];
  float acc[kReg][kReg];
#pragma unroll
  for (int p = 0; p < kReg; ++p) {
    gi[p] = i0 + ty + kDim * p;
    gj[p] = j0 + tx + kDim * p;
#pragma unroll
    for (int q = 0; q < kReg; ++q) acc[p][q] = 0.f;
  }

  for (int z0 = 0; z0 < n; z0 += kBz) {
    for (int e = tid; e < kTile * kBz; e += kDim * kDim) {
      const int r = e / kBz, c = e % kBz, z = z0 + c;
      const bool zin = z < n;
      si[r][c] = (zin && i0 + r < n) ? M[(long long)(i0 + r) * n + z] : 0.f;
      sj[r][c] = (zin && j0 + r < n) ? M[(long long)(j0 + r) * n + z] : 0.f;
    }
    __syncthreads();
    const int zn = min(kBz, n - z0);
    for (int c = 0; c < zn; ++c) {
      const int z = z0 + c;
      float a[kReg], b[kReg];
#pragma unroll
      for (int p = 0; p < kReg; ++p) {
        a[p] = si[ty + kDim * p][c];
        b[p] = sj[tx + kDim * p][c];
      }
#pragma unroll
      for (int p = 0; p < kReg; ++p)
#pragma unroll
        for (int q = 0; q < kReg; ++q) {
          const float dlt = fabsf(a[p] - b[q]);
          acc[p][q] += (z != gi[p] && z != gj[q]) ? dlt : 0.f;
        }
    }
    __syncthreads();
  }

  const float denom = (float)max(n - 2, 1);
#pragma unroll
  for (int p = 0; p < kReg; ++p)
#pragma unroll
    for (int q = 0; q < kReg; ++q)
      if (gi[p] < n && gj[q] < n)
        out[(long long)gi[p] * n + gj[q]] = acc[p][q] / denom;
}

}  // namespace

extern "C" {

// M (n, n) fp32 row-major -> out (n, n) fp32. Returns cudaGetLastError().
int madc_launch(const void* M, void* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (n + kTile - 1) / kTile;
  madc_kernel<<<dim3(tiles, tiles), dim3(kDim, kDim), 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(M), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
