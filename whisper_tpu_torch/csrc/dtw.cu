// DTW trace table of a cost matrix: one block per matrix, a wavefront
// pipelined through warps, a lane per row.
//
// Replaces: whisper_tpu/ops/pallas_kernels.py:dtw_trace_pallas (body
// _dtw_kernel). Computes, for x (N, M) f32, the (N+1, M+1) int8 trace of the
// cumulative-cost recursion cost[i, j] = x[i-1, j-1] + min(diag, up, left)
// with cost[0, 0] = 0 and infinite borders: 0 when the diagonal is strictly
// least, else 1 when up is strictly least, else 2 (left); -1 on the borders.
// The cost is accumulated in double: the JAX package's default word-timing
// path runs its DTW in float64 (whisper_tpu/ops/dtw.py:dtw_np), and near-ties
// in a sum of ~1,700 steps decide the path, so only float64 gives its path.
//
// Bound on this card: the dependency chain, not bytes or operations. The
// least traffic is 4·N·M bytes read plus (N+1)(M+1) written (about 1.9 MB at
// N = 252, M = 1500: under a microsecond at 3.35 TB/s), but every cell waits
// on its left and upper neighbours, so the table is a chain of N + M - 1
// dependent anti-diagonals, each "compare three doubles, select, add". A
// block-wide barrier per anti-diagonal (one thread per row) cost ~0.42 µs a
// step on the H100; one thread alone runs the chain's arithmetic in ~17 ns
// a step (chip_smoke.py's chain floor).
//
// Design: warp w owns the strip of table rows 32w+1 .. 32w+32, lane l one
// row; at step s lane l computes column s - l + 1, a wavefront inside the
// warp with no barrier. The left neighbour is the lane's own last cost, in a
// register; up comes from lane l-1 by one __shfl_sync, and the diagonal is
// the up of the step before. The shuffle's source lane wraps, so lane 0
// takes its up from lane 31, which sends the row above the strip instead of
// its own cost: it reads it from a ring of kRing doubles in shared memory
// (ring 0 holds the border row 0, ring w the last row of strip w-1). Lane
// 31 of warp w-1 writes each cost of its row into ring w and publishes how
// far it has written after every tile of kTile steps (fence, then a
// volatile flag); warp w waits at the start of a tile until the tile's
// columns are there, and frees the slots of the tile before with a flag of
// its own. So warps meet once per tile, each ~3 tiles behind the one above.
// Before a lane's first column its x is +inf, so its cost stays +inf
// without a mask on the chain; past column M its costs are never read.
// x comes in a tile ahead by cp.async: a tile of the strip's 32 rows, each
// row's kTile columns skewed by its lane (the columns the wavefront reaches
// in that tile), a row per half-warp per instruction, into registers at the
// tile's start. The int8 trace of a tile collects in shared memory and goes
// out a row per half-warp per instruction. Up to kMaxHelped strips (N <=
// 480, the word-timing path's windows) each get an I/O warp that does the
// strip's loads and trace stores, a tile ahead and a tile behind, and meets
// its compute warp once per tile at a named barrier; above that the compute
// warps do their own. The only __syncthreads is before the loop. What paces
// it now: a step's chain is a shuffle of a double as well as the cell's
// arithmetic; the hand-off at each tile; and the ~48 steps by which each
// strip trails the one above (32 for the lanes' skew, 16 for the tile).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace wtt {

constexpr int kMaxRows = 1024;     // N + 1
constexpr int kStrip = 32;         // table rows per warp, one per lane
constexpr int kMaxWarps = kMaxRows / kStrip;
constexpr int kMaxHelped = 15;     // strips that get an I/O warp (one named barrier each)
constexpr int kTile = 16;          // steps per tile: x load, trace flush, hand-off
constexpr int kRing = 64;          // boundary costs in flight between two strips
constexpr int kXPitch = kTile + 1; // floats per row of an x tile (no bank conflicts)
constexpr int kTPitch = 36;        // bytes per column of a trace tile (no bank conflicts)
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr size_t dtw_smem_bytes(int nw) {
  return (size_t)nw * kRing * sizeof(double)            // rings: border row 0, strip boundaries
         + 2 * nw * sizeof(int)                          // produced, consumed
         + (size_t)nw * 2 * kStrip * kXPitch * sizeof(float)  // x tiles, two per warp
         + (size_t)nw * 2 * kTile * kTPitch;             // trace tiles, two per warp
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// release / acquire between the warps of the block, for the ring's flags
__device__ __forceinline__ void fence_cta() { asm volatile("fence.acq_rel.cta;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// the rendezvous of a strip's compute warp and its I/O warp, named barrier id
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(2 * kStrip) : "memory");
}

__global__ void __launch_bounds__(kMaxRows)
dtw_trace_kernel(const float* __restrict__ x, signed char* __restrict__ trace, int N, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (N + kStrip - 1) / kStrip;                 // strips
  const bool helped = blockDim.x == 2 * nw * kStrip;        // an I/O warp per strip
  double* ring = reinterpret_cast<double*>(smem);
  unsigned char* flags = smem + nw * kRing * sizeof(double);
  volatile int* produced = reinterpret_cast<volatile int*>(flags);
  volatile int* consumed = produced + nw;
  float* xt_all = reinterpret_cast<float*>(flags + 2 * nw * sizeof(int));
  signed char* tt_all = reinterpret_cast<signed char*>(xt_all + nw * 2 * kStrip * kXPitch);

  const int l = threadIdx.x % kStrip;
  const bool io_warp = (int)threadIdx.x >= nw * kStrip;
  const int w = threadIdx.x / kStrip - (io_warp ? nw : 0);  // the strip
  const int ld = M + 1;
  // borders: row 0 and column 0 of the trace are -1
  for (int j = threadIdx.x; j <= M; j += blockDim.x) trace[j] = -1;
  for (int i = threadIdx.x; i <= N; i += blockDim.x) trace[(size_t)i * ld] = -1;
  if (threadIdx.x < nw) {
    produced[threadIdx.x] = 0;  // columns of the strip's last row in the ring
    consumed[threadIdx.x] = 0;  // columns of the row above read from the ring
  }
  for (int k = threadIdx.x; k < kRing; k += blockDim.x) ring[k] = CUDART_INF;  // ring 0: row 0
  __syncthreads();

  const int row0 = kStrip * w;  // x row of lane 0 (table row row0 + 1)
  float* xt = xt_all + w * 2 * kStrip * kXPitch;
  signed char* tt = tt_all + w * 2 * kTile * kTPitch;
  const int rows = min(kStrip, N - row0);
  const int tiles = (M + rows - 1 + kTile - 1) / kTile;  // the last lane's last step is M + rows - 2

  // lane l moves, for q < kTile, cell (r, c) = (2q + l/16, l%16) of a tile
  // (a half-warp per row): x[row0 + r, kTile*t - r + c] in, trace[row0 + r
  // + 1, kTile*t - r + c + 1] out; both step by a constant in q
  const int half = l / (kStrip / 2), cl = l % kTile;
  const float* xsrc = x + (size_t)(row0 + half) * M + (cl - half);
  signed char* tdst = trace + (size_t)(row0 + half + 1) * ld + (cl - half + 1);
  auto load_tile = [&](int t) {  // x tile t into buffer t & 1
    float* dst = xt + (t & 1) * kStrip * kXPitch + half * kXPitch + cl;
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int col = kTile * t + cl - half - 2 * q;
      const bool ok = row0 + half + 2 * q < N && col >= 0 && col < M;
      const float* src = xsrc + kTile * t + (size_t)q * (2 * M - 2);
      cp_async4(dst + q * 2 * kXPitch, ok ? src : x, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  auto flush_tile = [&](int t) {  // trace tile t from buffer t & 1: all reads, then the stores
    const signed char* src = tt + (t & 1) * kTile * kTPitch + cl * kTPitch + half;
    signed char tv[kTile];
#pragma unroll
    for (int q = 0; q < kTile; ++q) tv[q] = src[2 * q];
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int j = kTile * t + cl - half + 1 - 2 * q;
      if (row0 + half + 2 * q < N && j >= 1 && j <= M) tdst[kTile * t + (size_t)q * (2 * ld - 2)] = tv[q];
    }
  };

  if (io_warp) {
    // x a tile ahead and the trace a tile behind the strip's compute warp,
    // meeting it once per tile
    load_tile(0);
    cp_async_wait0();
    pair_sync(1 + w);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) load_tile(t + 1);
      if (t > 0) flush_tile(t - 1);  // while the loads are in flight
      cp_async_wait0();
      pair_sync(1 + w);
    }
    flush_tile(tiles - 1);
    return;
  }

  const bool feeds = w + 1 < nw;  // lane 31's row is the next strip's up
  const double* in_ring = ring + w * kRing;  // the row above the strip
  double* out_ring = ring + (w + 1) * kRing;
  double left = CUDART_INF;                              // cost[i, j-1]
  double diag = (w == 0 && l == 0) ? 0.0 : CUDART_INF;  // cost[i-1, j-1]
  if (helped) {
    pair_sync(1 + w);
  } else {
    load_tile(0);
  }
  for (int t = 0; t < tiles; ++t) {
    if (!helped) {
      if (t + 1 < tiles) {
        load_tile(t + 1);  // a tile ahead
      } else {
        cp_async_commit();
      }
      cp_async_wait1();
    }
    __syncwarp();
    // the lane's x of this tile, in registers before the chain starts (the
    // loads overlap the waits below); +inf before the lane's first column,
    // so that its cost stays +inf there
    float xv[kTile];
    const float* xrow = xt + (t & 1) * kStrip * kXPitch + l * kXPitch;
#pragma unroll
    for (int c = 0; c < kTile; ++c) xv[c] = kTile * t + c - l >= 0 ? xrow[c] : CUDART_INF_F;
    if (w > 0) {
      // the row above, columns up to kTile*t + kTile, in the ring
      const int need = min(M, kTile * t + kTile);
      while (produced[w - 1] < need) {
      }
      // one fence both acquires the row above and releases the slots that
      // lane 31, the ring's only reader, read in the last tile
      fence_cta();
      if (l == kStrip - 1) consumed[w] = kTile * t;  // this tile reads up to kTile*t + kTile
    }
    // ring slot of column j: (j + kStrip - 2) % kRing, so that a tile's
    // columns take kTile consecutive slots on both sides of the ring
    const double* above_t = in_ring + (kTile * t + 2 * kTile) % kRing;  // columns 16t+2 ..
    double* below_t = out_ring + (kTile * t) % kRing;                     // columns 16t-30 ..
    const int last_c = M + kStrip - 2 - kTile * t;  // lane 31's steps up to column M
    // lane 31 sends lane 0 the row above (the shuffle's source lane wraps)
    double send = l == kStrip - 1 ? in_ring[(kTile * t + kStrip - 1) % kRing] : left;
    if (feeds) {
      // this tile, lane 31 writes columns up to kTile*t - 15 into the ring:
      // wait until the next strip has read what they overwrite
      const int need = kTile * t - (kStrip - 1) + kTile - kRing;
      while (consumed[w + 1] < need) {
      }
    }
    signed char* ttw = tt + (t & 1) * kTile * kTPitch + l;
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const double up = __shfl_sync(kFull, send, (l + kStrip - 1) % kStrip);
      const double c0 = diag, c1 = up, c2 = left;
      // diagonal if strictly least, else up if strictly least, else left
      const bool take0 = (c0 < c1) & (c0 < c2);
      const bool take1 = (c1 < c0) & (c1 < c2);
      // past column M a lane's costs are never read: no mask on the chain
      left = (double)xv[c] + (take0 ? c0 : take1 ? c1 : c2);
      diag = up;
      const double above = c + 1 < kTile ? above_t[c] : 0.0;
      send = l == kStrip - 1 ? above : left;
      // (before its first column lane 31 writes slots no column holds yet)
      if (feeds && l == kStrip - 1 && c <= last_c) below_t[c] = left;
      ttw[c * kTPitch] = take0 ? 0 : take1 ? 1 : 2;
    }
    if (feeds && l == kStrip - 1) {
      fence_cta();
      produced[w] = min(M, kTile * t + kTile - (kStrip - 1));
    }
    if (helped) {
      pair_sync(1 + w);  // x of tile t+1 in; the trace of tile t to the I/O warp
    } else {
      __syncwarp();
      flush_tile(t);
      __syncwarp();
    }
  }
}

}  // namespace wtt

extern "C" int wtt_dtw_trace(const float* x, signed char* trace, int N, int M,
                             cudaStream_t stream) {
  if (N < 1 || N + 1 > wtt::kMaxRows || M < 1) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wtt::dtw_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)wtt::dtw_smem_bytes(wtt::kMaxWarps));
  if (attr != cudaSuccess) return (int)attr;
  // a compute warp per strip of 32 rows and, while the block has room and
  // named barriers are left (15 besides __syncthreads'), an I/O warp beside it
  const int nw = (N + wtt::kStrip - 1) / wtt::kStrip;
  const int warps = nw <= wtt::kMaxHelped ? 2 * nw : nw;
  wtt::dtw_trace_kernel<<<1, warps * wtt::kStrip, wtt::dtw_smem_bytes(nw), stream>>>(x, trace, N, M);
  return (int)cudaGetLastError();
}
