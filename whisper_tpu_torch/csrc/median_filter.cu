// Median filter of odd width over each row, reflect padding at a boundary
// column: row tiles in shared memory, four outputs a thread.
//
// Replaces: whisper_tpu/ops/pallas_kernels.py:median_filter_pallas (body
// _median_kernel). For x (R, T) f32 rows, out[r, j] for j < n_valid is the
// median of x[r, j-w/2 .. j+w/2] with the columns reflected at 0 and at
// n_valid - 1 (np.pad's "reflect" at the edge of x[:, :n_valid]);
// out[r, j] = x[r, j] for j >= n_valid. The word-timing cost matrix holds
// NaN in its columns past n_valid; no output below n_valid reads them. The
// order is torch.sort's and jnp.sort's: NaN above every number, so a window
// with more than w/2 NaNs has a NaN median.
//
// Bound on this card: bytes. The least traffic is R·T·4 bytes read and the
// same written, 108 MB at 40 heads × 224 rows × 1500 frames, or ~32 µs at
// 3.35 TB/s; a thread-per-output sort (42 min/max, seven scalar loads and a
// 64-bit division per output) made the instructions, not the bytes, the
// limit.
//
// Design: a block takes one tile of 512 columns of a row (blockIdx.x the
// tile, blockIdx.y the row, and every 4096th row after it: no division, and
// fewer blocks to launch than rows) and reads it, with a halo of
// w/2 columns rounded up to whole float4s, into shared memory once, in
// float4 loads where the row and the output are 16-byte aligned (else a
// scalar-load build). Each value enters shared memory as an int key whose
// signed order is the NaN-last order (every NaN becomes INT_MAX), so the
// networks below are integer min/max, one instruction each. A thread makes
// four consecutive outputs from 4 + 2·halo keys (int4 reads of shared
// memory) and writes them with one float4 store. For width 7 a selection
// network shares work between the four windows: the four keys they all hold
// are sorted once (5 compare-exchanges), each pair of windows takes the
// 3rd and 4th smallest of its six shared keys from that and one sorted pair,
// and each window's median is then max(s2, min(extra, s3)): 38 min/max for
// four outputs, against 4 × 42 for the full sorts. Widths 3, 5 and 13 keep
// the transposition sort on keys. Only a thread whose windows cross column
// 0 or n_valid - 1 gathers the reflected columns one by one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace wtt {

constexpr int kMedianThreads = 128;
constexpr int kOuts = 4;                                 // outputs per thread
constexpr int kMedianTile = kMedianThreads * kOuts;      // columns per block
constexpr int kMaxGridY = 4096;  // rows at once; a block takes every 4096th row after its first

// The int key of a float: signed order = NaN-last order (negative floats
// get their magnitude bits flipped; every NaN, of either sign, is INT_MAX,
// above +inf). from_key inverts it (a NaN comes back as 0x7fffffff).
__device__ __forceinline__ int to_key(float f) {
  const int b = __float_as_int(f);
  return f != f ? 0x7fffffff : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float from_key(int k) { return __int_as_float(k ^ ((k >> 31) & 0x7fffffff)); }

__device__ __forceinline__ void cswap(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// medians of the kOuts windows v[H-pad+o .. H-pad+o+WIDTH-1], o < kOuts
template <int WIDTH, int H>
__device__ __forceinline__ void medians(const int* v, int* r) {
  constexpr int pad = WIDTH / 2;
  const int* u = v + H - pad;  // window o is u[o .. o + WIDTH - 1]
  if constexpr (WIDTH == 7) {
    // the four keys all windows hold, sorted
    int a0 = u[3], a1 = u[4], a2 = u[5], a3 = u[6];
    cswap(a0, a1);
    cswap(a2, a3);
    cswap(a0, a2);
    cswap(a1, a3);
    cswap(a1, a2);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      // windows 2p and 2p+1 share u[2p+1 .. 2p+6]: the sorted four and the
      // pair u[2p+1], u[2p+2] (before) or u[7], u[8] (after)
      int b0 = p == 0 ? u[1] : u[7], b1 = p == 0 ? u[2] : u[8];
      cswap(b0, b1);
      // 3rd and 4th smallest of the six: min over the splits of a and b
      const int s2 = min(a2, min(max(a1, b0), max(a0, b1)));
      const int s3 = min(a3, min(max(a2, b0), max(a1, b1)));
      // each window adds one key to the six; its median is the 4th of 7
      const int e0 = p == 0 ? u[0] : u[2], e1 = p == 0 ? u[7] : u[9];
      r[2 * p] = max(s2, min(e0, s3));
      r[2 * p + 1] = max(s2, min(e1, s3));
    }
  } else {
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      int w[WIDTH];
#pragma unroll
      for (int k = 0; k < WIDTH; ++k) w[k] = u[o + k];
#pragma unroll
      for (int p = 0; p < WIDTH; ++p) {
#pragma unroll
        for (int i = p % 2; i < WIDTH - 1; i += 2) cswap(w[i], w[i + 1]);
      }
      r[o] = w[pad];
    }
  }
}

template <int WIDTH, bool VEC>
__global__ void __launch_bounds__(kMedianThreads)
median_filter_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int T,
                     int n_valid) {
  constexpr int pad = WIDTH / 2;
  constexpr int H = (pad + 3) / 4 * 4;       // halo, in whole float4s
  constexpr int SPAN = kMedianTile + 2 * H;  // columns in shared memory
  constexpr int NV = kOuts + 2 * H;          // keys a thread reads
  __shared__ __align__(16) int s[SPAN];
  const int lo = blockIdx.x * kMedianTile - H;  // the column of s[0]
  const int t4 = kOuts * threadIdx.x;           // s[t4 + H] is the thread's first output column
  const int j0 = lo + H + t4;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* xr = x + (size_t)row * T;
    float* outr = out + (size_t)row * T;
    if constexpr (VEC) {
      // T % 4 == 0 and lo % 4 == 0: a float4 is wholly inside the row or out
      for (int q = threadIdx.x; q < SPAN / 4; q += kMedianThreads) {
        const int c = lo + 4 * q;
        int4 k = make_int4(0, 0, 0, 0);
        if (c >= 0 && c < T) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(xr + c));
          k = make_int4(to_key(f.x), to_key(f.y), to_key(f.z), to_key(f.w));
        }
        reinterpret_cast<int4*>(s)[q] = k;
      }
    } else {
      for (int q = threadIdx.x; q < SPAN; q += kMedianThreads) {
        const int c = lo + q;
        s[q] = (c >= 0 && c < T) ? to_key(__ldg(xr + c)) : 0;
      }
    }
    __syncthreads();
    if (j0 < T) {
      int v[NV], r[kOuts];
      if (j0 - pad >= 0 && j0 + kOuts - 1 + pad < n_valid) {
#pragma unroll
        for (int q = 0; q < NV / 4; ++q) {
          const int4 k = reinterpret_cast<const int4*>(s + t4)[q];
          v[4 * q] = k.x;
          v[4 * q + 1] = k.y;
          v[4 * q + 2] = k.z;
          v[4 * q + 3] = k.w;
        }
      } else {
        // a window crosses column 0 or n_valid - 1: gather each column
        // reflected into [0, n_valid); the windows of outputs at or past
        // n_valid are never used, their indices only kept inside s
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          int c = j0 - H + q;
          c = c < 0 ? -c : c;
          c = c >= n_valid ? 2 * n_valid - 2 - c : c;
          v[q] = s[min(max(c - lo, 0), SPAN - 1)];
        }
      }
      medians<WIDTH, H>(v, r);
      float res[kOuts];
#pragma unroll
      for (int o = 0; o < kOuts; ++o) res[o] = from_key(j0 + o < n_valid ? r[o] : s[t4 + H + o]);
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(outr + j0) = make_float4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int o = 0; o < kOuts; ++o) {
          if (j0 + o < T) outr[j0 + o] = res[o];
        }
      }
    }
    __syncthreads();
  }
}

template <int WIDTH>
static void launch(const float* x, float* out, int rows, int T, int n_valid, cudaStream_t stream) {
  const dim3 grid((T + kMedianTile - 1) / kMedianTile, rows < kMaxGridY ? rows : kMaxGridY);
  const bool vec = T % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec) {
    median_filter_kernel<WIDTH, true><<<grid, kMedianThreads, 0, stream>>>(x, out, rows, T, n_valid);
  } else {
    median_filter_kernel<WIDTH, false><<<grid, kMedianThreads, 0, stream>>>(x, out, rows, T, n_valid);
  }
}

}  // namespace wtt

extern "C" int wtt_median_filter(const float* x, float* out, int rows, int T, int width,
                                 int n_valid, cudaStream_t stream) {
  if ((long long)rows * T <= 0) return 0;
  if (n_valid <= width / 2 || n_valid > T) return (int)cudaErrorInvalidValue;
  // 7 is the word-timing path's width; 3, 5 and 13 are the JAX package's
  // test widths, held against the plain version on the card as well
  switch (width) {
    case 3: wtt::launch<3>(x, out, rows, T, n_valid, stream); break;
    case 5: wtt::launch<5>(x, out, rows, T, n_valid, stream); break;
    case 7: wtt::launch<7>(x, out, rows, T, n_valid, stream); break;
    case 13: wtt::launch<13>(x, out, rows, T, n_valid, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
