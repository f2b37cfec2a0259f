// Median filter of odd width over each row, reflect padding at a boundary
// column, one thread per output element.
//
// Replaces: whisper_tpu/ops/pallas_kernels.py:median_filter_pallas (body
// _median_kernel). For x (R, T) f32 rows, out[r, j] for j < n_valid is the
// median of x[r, j-w/2 .. j+w/2] with the columns reflected at 0 and at
// n_valid - 1 (np.pad's "reflect" at the edge of x[:, :n_valid]);
// out[r, j] = x[r, j] for j >= n_valid. The word-timing cost matrix holds
// NaN in its columns past n_valid; no output below n_valid reads them.
//
// Bound on this card: bytes. Each output takes WIDTH loads (neighbouring
// threads read neighbouring columns, so the overlap comes from L1/L2) and
// about WIDTH^2/2 min/max operations; the least traffic is R·T·4 bytes read
// and the same written, 108 MB at 40 heads × 224 rows × 1500 frames, or
// ~32 µs at 3.35 TB/s.
//
// Design: the window sits in registers (WIDTH is a template argument) and an
// odd-even transposition network of WIDTH passes sorts it with fminf/fmaxf,
// as _median_kernel does over its WIDTH shifted copies; only min and max are
// used, so the median is exact. Reading each row tile once into shared
// memory, and a selection network in place of the full sort, are left for
// later work.
#include <cuda_runtime.h>

namespace wtt {

constexpr int kMedianThreads = 256;

template <int WIDTH>
__global__ void __launch_bounds__(kMedianThreads)
median_filter_kernel(const float* __restrict__ x, float* __restrict__ out, long long total, int T,
                     int n_valid) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % T);
  if (j >= n_valid) {
    out[idx] = x[idx];
    return;
  }
  const float* row = x + (idx - j);
  constexpr int pad = WIDTH / 2;
  float v[WIDTH];
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) {
    int c = j + k - pad;
    c = c < 0 ? -c : c;
    c = c >= n_valid ? 2 * n_valid - 2 - c : c;
    v[k] = row[c];
  }
#pragma unroll
  for (int p = 0; p < WIDTH; ++p) {
#pragma unroll
    for (int i = p % 2; i < WIDTH - 1; i += 2) {
      const float lo = fminf(v[i], v[i + 1]);
      const float hi = fmaxf(v[i], v[i + 1]);
      v[i] = lo;
      v[i + 1] = hi;
    }
  }
  out[idx] = v[pad];
}

template <int WIDTH>
static void launch(const float* x, float* out, long long total, int T, int n_valid,
                   cudaStream_t stream) {
  const long long blocks = (total + kMedianThreads - 1) / kMedianThreads;
  median_filter_kernel<WIDTH><<<(unsigned)blocks, kMedianThreads, 0, stream>>>(x, out, total, T,
                                                                              n_valid);
}

}  // namespace wtt

extern "C" int wtt_median_filter(const float* x, float* out, int rows, int T, int width,
                                 int n_valid, cudaStream_t stream) {
  const long long total = (long long)rows * T;
  if (total <= 0) return 0;
  if (n_valid <= width / 2 || n_valid > T) return (int)cudaErrorInvalidValue;
  // 7 is the word-timing path's width; 3, 5 and 13 are the JAX package's
  // test widths, held against the plain version on the card as well
  switch (width) {
    case 3: wtt::launch<3>(x, out, total, T, n_valid, stream); break;
    case 5: wtt::launch<5>(x, out, total, T, n_valid, stream); break;
    case 7: wtt::launch<7>(x, out, total, T, n_valid, stream); break;
    case 13: wtt::launch<13>(x, out, total, T, n_valid, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
