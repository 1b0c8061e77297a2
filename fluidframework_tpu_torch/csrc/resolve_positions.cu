// Position resolution over perspective-visible segment lengths (K1).
//
// Replaces the Pallas TPU kernel fluidframework_tpu/ops/pallas_kernels.py:65
// (resolve_positions_pallas, kernel body _resolve_kernel at :30): for every
// query q, the segment i with 0 <= q - prefix[i] < lens[i], where prefix is
// the exclusive prefix sum of lens, reported as (index, offset, hit); a miss
// (q < 0 or q >= total) reports (0, 0, 0).
//
// Precondition (every caller's lens is a visible length): lens[i] >= 0 and
// each row's total is below 2^31.  The prefix is then non-decreasing, and
// the containing segment is the first i whose INCLUSIVE prefix exceeds q, so
// a search gives exactly what the TPU kernel's [Q, BLOCK] membership test
// gives.  All arithmetic is int32 (wrapping adds); under the precondition
// nothing wraps.
//
// Bound.  At the long-document size (S = 262,144 segments, Q = 256 queries)
// the function must read lens and the queries once and write three int32
// outputs per query: 1,052,672 B, 0.000314 ms at 3.35 TB/s.  It needs only
// about Q log2 S compares, so bytes bound it.
//
// Design: two kernels, issued back to back on the caller's stream by one
// entry point.  Nothing tests (query, segment) pairs.
//
//   1. resolve_positions_tile_sums, grid (tiles, docs): each block reduces
//      one tile of `tile` segments to one int32 sum (16-byte loads,
//      neighbouring threads on neighbouring addresses, warp-shuffle
//      reduction) into the caller's scratch tile_sum[D, n_tiles].  This is
//      the one pass over lens from device memory: the bytes bound.
//   2. resolve_positions_search, grid (query chunks, docs): each block
//      stages its doc's tile sums in shared memory and block-scans them into
//      the inclusive tile prefix and the total.  Each warp then takes one
//      query at a time: a miss writes (0, 0, 0); a hit binary-searches the
//      tile prefix for the first tile past q and walks that tile, which is
//      still in L2 after pass 1, in steps of 32 lanes x 64 contiguous
//      segments (one step for a 2,048-segment tile; each lane's sixteen
//      16-byte loads in flight at once): a warp inclusive scan of the lane
//      sums with a running base, __ballot_sync for the first lane whose
//      prefix passes q, and that lane's search of its own 64 segments in
//      registers.  About Q * tile reads from L2 in all.
//
// Every output element is written exactly once, hit or miss, so the caller
// allocates the outputs uninitialised.  The tile size is the caller's
// `tile` argument (the Python wrapper holds its one value).  A grid with
// more than 65,535 docs loops over them in y.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libresolve_positions.so resolve_positions.cu

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int SUM_THREADS = 256;
constexpr int SEARCH_THREADS = 128;
constexpr int WARPS = SEARCH_THREADS / 32;
constexpr int QUERIES_PER_BLOCK = WARPS;  // one query per warp
constexpr int LANE_SEGS = 64;             // contiguous segments per lane
constexpr int GROUPS = LANE_SEGS / 4;      // 16-byte loads per lane
constexpr int WALK = 32 * LANE_SEGS;       // segments one warp walks per step
constexpr int MAX_GRID_Y = 65535;
constexpr int STATIC_SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// int32 wraparound add and subtract (the torch/jnp semantics of int32 sums).
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// End of the tile that starts at `begin` in a row of S segments.
__device__ __forceinline__ int64_t tile_end(int64_t begin, int tile, int S) {
  return begin + tile < S ? begin + tile : static_cast<int64_t>(S);
}

// row[e .. e+3], entries at or past `end` reading as 0.  One 16-byte load
// when the row is 16-byte aligned (e is always a multiple of 4) and all four
// entries are in range.
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ row,
                                      bool aligned, int64_t e, int64_t end) {
  if (aligned && e + 4 <= end) {
    return __ldg(reinterpret_cast<const int4*>(row + e));
  }
  int4 v;
  v.x = e < end ? __ldg(row + e) : 0;
  v.y = e + 1 < end ? __ldg(row + e + 1) : 0;
  v.z = e + 2 < end ? __ldg(row + e + 2) : 0;
  v.w = e + 3 < end ? __ldg(row + e + 3) : 0;
  return v;
}

__device__ __forceinline__ bool is_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(SUM_THREADS)
resolve_positions_tile_sums(const int32_t* __restrict__ lens,
                            int32_t* __restrict__ tile_sum,
                            int D, int S, int tile, int n_tiles) {
  __shared__ uint32_t warp_sum[SUM_THREADS / 32];
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t end = tile_end(begin, tile, S);
  for (int d = blockIdx.y; d < D; d += gridDim.y) {
    const int32_t* row = lens + static_cast<int64_t>(d) * S;
    const bool aligned = is_aligned16(row);
    uint32_t sum = 0;
#pragma unroll 4
    for (int64_t e = begin + 4 * threadIdx.x; e < end; e += 4 * SUM_THREADS) {
      const int4 v = load4(row, aligned, e, end);
      sum += static_cast<uint32_t>(v.x) + static_cast<uint32_t>(v.y) +
             static_cast<uint32_t>(v.z) + static_cast<uint32_t>(v.w);
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    __syncthreads();  // the previous doc's reader of warp_sum is done
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t total = 0;
      for (int w = 0; w < SUM_THREADS / 32; ++w) total += warp_sum[w];
      tile_sum[static_cast<int64_t>(d) * n_tiles + blockIdx.x] =
          static_cast<int32_t>(total);
    }
  }
}

__global__ void __launch_bounds__(SEARCH_THREADS)
resolve_positions_search(const int32_t* __restrict__ lens,
                         const int32_t* __restrict__ tile_sum,
                         const int32_t* __restrict__ q,
                         int32_t* __restrict__ out,
                         int D, int S, int Q, int tile, int n_tiles) {
  extern __shared__ int32_t incl[];  // [n_tiles] inclusive tile prefix
  __shared__ uint32_t warp_total[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Thread i scans the contiguous run [t0, t1) of tiles.
  const int per_thread = (n_tiles + SEARCH_THREADS - 1) / SEARCH_THREADS;
  const int t0 = min(static_cast<int>(threadIdx.x) * per_thread, n_tiles);
  const int t1 = min(t0 + per_thread, n_tiles);
  int32_t* idx = out;
  int32_t* off = out + static_cast<int64_t>(D) * Q;
  int32_t* hit = off + static_cast<int64_t>(D) * Q;
  const int q0 = blockIdx.x * QUERIES_PER_BLOCK;
  const int q1 = min(q0 + QUERIES_PER_BLOCK, Q);
  for (int d = blockIdx.y; d < D; d += gridDim.y) {
    const int32_t* row = lens + static_cast<int64_t>(d) * S;
    const bool aligned = is_aligned16(row);
    const int32_t* sums = tile_sum + static_cast<int64_t>(d) * n_tiles;

    // Block scan of the tile sums.
    __syncthreads();  // the previous doc's readers of incl are done
    for (int t = threadIdx.x; t < n_tiles; t += SEARCH_THREADS) incl[t] = sums[t];
    __syncthreads();
    uint32_t own = 0;
    for (int t = t0; t < t1; ++t) own += static_cast<uint32_t>(incl[t]);
    uint32_t x = own;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_total[warp] = x;
    __syncthreads();
    uint32_t run = x - own;
    for (int w = 0; w < warp; ++w) run += warp_total[w];
    for (int t = t0; t < t1; ++t) {
      run += static_cast<uint32_t>(incl[t]);
      incl[t] = static_cast<int32_t>(run);
    }
    __syncthreads();
    const int32_t total = n_tiles > 0 ? incl[n_tiles - 1] : 0;

    for (int i = q0 + warp; i < q1; i += WARPS) {
      const int64_t at = static_cast<int64_t>(d) * Q + i;
      const int32_t qv = q[at];
      int32_t r_idx = 0, r_off = 0, r_hit = 0;
      int writer = 0;  // the lane that writes this query's outputs
      if (qv >= 0 && qv < total) {
        // First tile whose inclusive prefix passes qv (the last one does).
        int lo = 0, hi = n_tiles - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (incl[mid] > qv) hi = mid; else lo = mid + 1;
        }
        const int64_t begin = static_cast<int64_t>(lo) * tile;
        const int64_t end = tile_end(begin, tile, S);
        int32_t base = lo > 0 ? incl[lo - 1] : 0;  // prefix before the step
        bool found = false;
        for (int64_t c = begin; c < end && !found; c += WALK) {
          // This lane's LANE_SEGS contiguous segments, all loads in flight.
          const int64_t first = c + LANE_SEGS * lane;
          int4 v[GROUPS];
          int32_t g[GROUPS];  // sums of the groups of four
#pragma unroll
          for (int k = 0; k < GROUPS; ++k) v[k] = load4(row, aligned, first + 4 * k, end);
          int32_t s = 0;
#pragma unroll
          for (int k = 0; k < GROUPS; ++k) {
            g[k] = add32(add32(v[k].x, v[k].y), add32(v[k].z, v[k].w));
            s = add32(s, g[k]);
          }
          int32_t incl_lane = s;  // inclusive scan of the lane sums
          for (int o = 1; o < 32; o <<= 1) {
            const int32_t y = __shfl_up_sync(FULL, incl_lane, o);
            if (lane >= o) incl_lane = add32(incl_lane, y);
          }
          const unsigned passes = __ballot_sync(FULL, add32(base, incl_lane) > qv);
          if (passes) {
            writer = __ffs(passes) - 1;
            if (lane == writer) {
              // From this lane's exclusive prefix: the first group of four,
              // then the first segment in it, whose inclusive prefix passes
              // qv (predicated selects: no dynamic register indexing).
              int32_t e = sub32(add32(base, incl_lane), s);
              int grp = GROUPS - 1;
              int4 w = v[GROUPS - 1];
              bool done = false;
#pragma unroll
              for (int k = 0; k < GROUPS; ++k) {
                if (!done) {
                  if (add32(e, g[k]) > qv) {
                    grp = k;
                    w = v[k];
                    done = true;
                  } else {
                    e = add32(e, g[k]);
                  }
                }
              }
              int j = 3;
              if (add32(e, w.x) > qv) {
                j = 0;
              } else {
                e = add32(e, w.x);
                if (add32(e, w.y) > qv) {
                  j = 1;
                } else {
                  e = add32(e, w.y);
                  if (add32(e, w.z) > qv) {
                    j = 2;
                  } else {
                    e = add32(e, w.z);
                  }
                }
              }
              r_idx = static_cast<int32_t>(first + 4 * grp + j);
              r_off = sub32(qv, e);
              r_hit = 1;
            }
            found = true;
          } else {
            base = add32(base, __shfl_sync(FULL, incl_lane, 31));
          }
        }
      }
      if (lane == writer) {
        idx[at] = r_idx;
        off[at] = r_off;
        hit[at] = r_hit;
      }
    }
  }
}

}  // namespace

// lens: int32[D, S]; q: int32[D, Q]; out: int32[3, D, Q], the planes idx,
// off and hit (written in full, any initial contents); tile_sum:
// int32[D, ceil(S / tile)] scratch.  All contiguous, on the device; tile > 0
// and a multiple of 4.  Launches both kernels on ``stream`` without
// synchronising; returns the first CUDA error.
extern "C" int resolve_positions_launch(const void* lens, const void* q,
                                        void* out, void* tile_sum, int D,
                                        int S, int Q, int tile, void* stream) {
  if (D <= 0 || Q <= 0) return 0;
  if (S < 0 || tile <= 0 || tile % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = S / tile + (S % tile != 0);
  const unsigned grid_y = D < MAX_GRID_Y ? D : MAX_GRID_Y;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    resolve_positions_tile_sums<<<dim3(n_tiles, grid_y), SUM_THREADS, 0, st>>>(
        static_cast<const int32_t*>(lens), static_cast<int32_t*>(tile_sum),
        D, S, tile, n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(n_tiles) * sizeof(int32_t);
  if (smem > STATIC_SMEM_LIMIT) {
    const cudaError_t err = cudaFuncSetAttribute(
        resolve_positions_search, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned q_blocks = (Q + QUERIES_PER_BLOCK - 1) / QUERIES_PER_BLOCK;
  resolve_positions_search<<<dim3(q_blocks, grid_y), SEARCH_THREADS, smem, st>>>(
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(tile_sum),
      static_cast<const int32_t*>(q), static_cast<int32_t*>(out), D, S, Q,
      tile, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
