// Position resolution over perspective-visible segment lengths (K1).
//
// Replaces the Pallas TPU kernel fluidframework_tpu/ops/pallas_kernels.py
// (_resolve_kernel, launched by resolve_positions_pallas): for every query
// q, the segment i with 0 <= q - prefix[i] < lens[i], where prefix is the
// exclusive prefix sum of lens, reported as (index, offset, hit); a miss
// (negative or past-the-end q, or an all-invisible run) reports (0, 0, 0).
//
// Design.  The TPU kernel walks the segment axis as a SEQUENTIAL grid,
// carrying the output block from one grid step to the next.  Hopper blocks
// run in no fixed order, so nothing is carried: the grid is 2-D over
// (segment tiles x query tiles), plus the doc axis of the batched form.
// A block stages its query tile in shared memory; each thread owns
// SEGS_PER_THREAD segments (neighbouring threads read neighbouring
// segments, so the prefix/lens loads coalesce) and tests them against
// every query of the tile.  Visible segments are disjoint intervals of the
// visible coordinate line, so at most one segment in the whole grid
// contains a given query: the hit is a plain store into outputs the
// wrapper zeroed first, with no atomics and no cross-block reduction.
// The exclusive prefix is computed by the wrapper (torch.cumsum), as the
// JAX form computes it outside the kernel body.
//
// Bound.  At the long-document size (S = 262,144 segments, Q = 256
// queries) the function reads about 1 MB (lens once, queries once) and
// writes 3 KB: about 0.3 us at 3.35 TB/s.  The function needs only about
// Q log2 S compares, so its bound is those bytes.  This simple design
// does far more work than that: it tests all Q x S pairs (about 67 M pair
// tests of two integer compares each), and those compares, not the
// bytes, set its time.  A binary search over the prefix is the later
// redesign that brings it toward the bytes bound.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libresolve_positions.so resolve_positions.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SEGS_PER_THREAD = 4;
constexpr int SEG_TILE = THREADS * SEGS_PER_THREAD;
constexpr int Q_TILE = 256;
constexpr int MAX_GRID_YZ = 65535;

// int32 wraparound add (the torch/jnp semantics of prefix + lens).
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void __launch_bounds__(THREADS)
resolve_positions_kernel(const int32_t* __restrict__ prefix,
                         const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ q,
                         int32_t* __restrict__ idx,
                         int32_t* __restrict__ off,
                         int32_t* __restrict__ hit,
                         int D, int S, int Q) {
  __shared__ int32_t sq[Q_TILE];
  const int q0 = blockIdx.y * Q_TILE;
  const int nq = min(Q_TILE, Q - q0);
  const int s0 = blockIdx.x * SEG_TILE;
  for (int d = blockIdx.z; d < D; d += gridDim.z) {
    const int64_t qrow = static_cast<int64_t>(d) * Q + q0;
    const int64_t srow = static_cast<int64_t>(d) * S;
    __syncthreads();  // the previous doc's readers are done with sq
    for (int i = threadIdx.x; i < nq; i += THREADS) sq[i] = q[qrow + i];
    __syncthreads();
    int32_t lo[SEGS_PER_THREAD];
    int32_t hi[SEGS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < SEGS_PER_THREAD; ++j) {
      const int s = s0 + j * THREADS + threadIdx.x;
      if (s < S) {
        lo[j] = prefix[srow + s];
        hi[j] = add32(lo[j], lens[srow + s]);
      } else {
        lo[j] = 1;  // empty interval: no q has q >= 1 and q < 0
        hi[j] = 0;
      }
    }
    for (int i = 0; i < nq; ++i) {
      const int32_t qv = sq[i];
#pragma unroll
      for (int j = 0; j < SEGS_PER_THREAD; ++j) {
        if (qv >= lo[j] && qv < hi[j]) {
          idx[qrow + i] = s0 + j * THREADS + threadIdx.x;
          off[qrow + i] = static_cast<int32_t>(
              static_cast<uint32_t>(qv) - static_cast<uint32_t>(lo[j]));
          hit[qrow + i] = 1;
        }
      }
    }
  }
}

}  // namespace

// prefix/lens: int32[D, S]; q: int32[D, Q]; idx/off/hit: int32[D, Q],
// zeroed by the caller.  All contiguous, on the device.  Launches on
// ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int resolve_positions_launch(const void* prefix, const void* lens,
                                        const void* q, void* idx, void* off,
                                        void* hit, int D, int S, int Q,
                                        void* stream) {
  if (D <= 0 || S <= 0 || Q <= 0) return 0;
  const int q_tiles = (Q + Q_TILE - 1) / Q_TILE;
  if (q_tiles > MAX_GRID_YZ) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + SEG_TILE - 1) / SEG_TILE, q_tiles, D < MAX_GRID_YZ ? D : MAX_GRID_YZ);
  resolve_positions_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(prefix), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(q), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(off), static_cast<int32_t*>(hit), D, S, Q);
  return static_cast<int>(cudaGetLastError());
}
