// Blocked MADC proximity (paper eq. 7) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `madc_block` (src/repro/kernels/madc.py:78,
// body `_kernel` :46, tiles `madc_tiles` :31):
//   MADC(i, j) = sum_{z != i, j} |M_iz - M_jz| / max(n - 2, 1).
//
// What bounds it on this card: operations. M is n*n fp32 (4 MB at n=1024)
// and is read a few times from L2, but the function needs 3 operations
// (subtract, absolute value, add) per z for each of the n(n-1)/2 distinct
// pairs — 1.6 G at n=1024, ~24 us at 67 TFLOP/s. An absolute difference is
// not a dot product, so the tensor cores cannot take it: this runs on the
// CUDA cores. At the main path's n = α·m = 100 (1.5 M operations) the
// launch and the host's call cost bound it instead.
//
// Design: MADC(i, j) = MADC(j, i), so only the output tiles with j-tile >=
// i-tile are computed, one block each, from a 1-D grid that walks the upper
// triangle column by column: block t is j-tile a = the largest a with
// a(a+1)/2 <= t, i-tile t - a(a+1)/2 (`madc_tile_of` in kernels/madc.py
// mirrors it). The tile edge (16, 32 or 64) comes from n (`madc_tiles` in
// kernels/madc.py): small tiles put enough blocks on the 132 SMs at small
// n, 64 keeps the register tile's arithmetic density at large n. Each of
// the 256 threads owns a (TILE/16)² register tile (rows ty + 16p, columns
// tx + 16q). The block walks z in slices of 32, staging the slice's i-rows
// and j-rows of M in shared memory (rows padded to 33 floats, so the 16
// column owners of a warp hit 16 banks) with cp.async, double-buffered:
// slice s + 1 is in flight while slice s is summed. The z = i and z = j
// exclusions are a select; z >= n and rows >= n are staged as zeros
// (cp.async's zero fill) and add |0 - 0| = 0. No (n, n, n) cube exists.
// An off-diagonal tile is written twice, as (i, j) and mirrored as (j, i),
// both through shared memory so that both writes are coalesced; the result
// is exactly symmetric (|a - b| = |b - a| and z runs in one order), with a
// zero diagonal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBz = 32;                 // z-slice per shared-memory stage
constexpr int kDim = 16;                // threads per tile edge
constexpr int kThreads = kDim * kDim;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
madc_kernel(const float* __restrict__ M, float* __restrict__ out, int n) {
  constexpr int R = TILE / kDim;        // R x R outputs per thread
  constexpr int LD = kBz + 1;
  constexpr int kSlice = TILE * LD;     // floats of one staged row block
  // [buffer][i rows, j rows] slices; reused as the [TILE][TILE + 1] output
  __shared__ float sm[2 * 2 * kSlice];
  static_assert(TILE * (TILE + 1) <= 4 * kSlice, "output tile fits");

  // the block's tile: column-major walk of the upper triangle
  const long long t = blockIdx.x;
  long long a = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while ((a + 1) * (a + 2) / 2 <= t) ++a;
  while (a * (a + 1) / 2 > t) --a;
  const int i0 = static_cast<int>(t - a * (a + 1) / 2) * TILE;
  const int j0 = static_cast<int>(a) * TILE;

  const int tid = threadIdx.x, tx = tid % kDim, ty = tid / kDim;
  int gi[R], gj[R];
  float acc[R][R];
#pragma unroll
  for (int p = 0; p < R; ++p) {
    gi[p] = i0 + ty + kDim * p;
    gj[p] = j0 + tx + kDim * p;
#pragma unroll
    for (int q = 0; q < R; ++q) acc[p][q] = 0.f;
  }

  auto stage = [&](int buf, int z0) {
    float* si = sm + buf * 2 * kSlice;
    float* sj = si + kSlice;
    for (int e = tid; e < TILE * kBz; e += kThreads) {
      const int r = e / kBz, c = e % kBz, z = z0 + c;
      const bool iin = z < n && i0 + r < n, jin = z < n && j0 + r < n;
      cp_async4(si + r * LD + c, iin ? M + (long long)(i0 + r) * n + z : M,
                iin);
      cp_async4(sj + r * LD + c, jin ? M + (long long)(j0 + r) * n + z : M,
                jin);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int nz = (n + kBz - 1) / kBz;
  stage(0, 0);
  for (int s = 0; s < nz; ++s) {
    if (s + 1 < nz) {
      stage((s + 1) & 1, (s + 1) * kBz);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* si = sm + (s & 1) * 2 * kSlice;
    const float* sj = si + kSlice;
    const int z0 = s * kBz, zn = min(kBz, n - z0);
    for (int c = 0; c < zn; ++c) {
      const int z = z0 + c;
      float av[R], bv[R];
#pragma unroll
      for (int p = 0; p < R; ++p) {
        av[p] = si[(ty + kDim * p) * LD + c];
        bv[p] = sj[(tx + kDim * p) * LD + c];
      }
#pragma unroll
      for (int p = 0; p < R; ++p)
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float dlt = fabsf(av[p] - bv[q]);
          acc[p][q] += (z != gi[p] && z != gj[q]) ? dlt : 0.f;
        }
    }
    __syncthreads();                    // the buffer is refilled next
  }

  // the tile through shared memory: (i, j) row by row, and for an
  // off-diagonal tile (j, i) from the transposed reads, both coalesced
  constexpr int LO = TILE + 1;
  const float denom = (float)max(n - 2, 1);
#pragma unroll
  for (int p = 0; p < R; ++p)
#pragma unroll
    for (int q = 0; q < R; ++q)
      sm[(ty + kDim * p) * LO + tx + kDim * q] = acc[p][q] / denom;
  __syncthreads();
  const bool diag = i0 == j0;
  for (int e = tid; e < TILE * TILE; e += kThreads) {
    const int r = e / TILE, c = e % TILE;
    if (i0 + r < n && j0 + c < n)
      out[(long long)(i0 + r) * n + j0 + c] = sm[r * LO + c];
    if (!diag && j0 + r < n && i0 + c < n)
      out[(long long)(j0 + r) * n + i0 + c] = sm[c * LO + r];
  }
}

}  // namespace

extern "C" {

// M (n, n) fp32 row-major -> out (n, n) fp32, output tiles of tile x tile
// (16, 32 or 64). Returns cudaGetLastError().
int madc_launch(const void* M, void* out, int n, int tile, void* stream) {
  if (n <= 0 || (tile != 16 && tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  const long long T = (n + tile - 1) / tile;
  const long long blocks = T * (T + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(M);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 16)
    madc_kernel<16><<<(unsigned)blocks, kThreads, 0, s>>>(m, o, n);
  else if (tile == 32)
    madc_kernel<32><<<(unsigned)blocks, kThreads, 0, s>>>(m, o, n);
  else
    madc_kernel<64><<<(unsigned)blocks, kThreads, 0, s>>>(m, o, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
