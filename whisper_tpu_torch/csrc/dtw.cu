// DTW trace table of a cost matrix, one block per matrix, one thread per row.
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
// Bound on this card: neither bytes nor operations. The least traffic is
// 4·N·M bytes read plus (N+1)(M+1) written (about 1.9 MB at N = 252,
// M = 1500: well under a microsecond at 3.35 TB/s). The real limit is the
// dependency chain: N+M-1 anti-diagonals, each waiting on the last, so one
// block-wide barrier per diagonal.
//
// Design: thread i owns row i. The last two cost diagonals live in shared
// memory (three rotating buffers, so one __syncthreads() per diagonal
// suffices); each thread loads its next cell of x one diagonal ahead, so the
// global load's latency hides behind the barrier. The Pallas kernel's
// diagonal-major skew exists only for Mosaic and is not copied. Running
// several matrices at once, or several rows per thread with fewer barriers,
// is left for later work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace wtt {

constexpr int kMaxRows = 1024;  // N + 1 threads

__global__ void __launch_bounds__(kMaxRows)
dtw_trace_kernel(const float* __restrict__ x, signed char* __restrict__ trace, int N, int M) {
  __shared__ double diag[3][kMaxRows];
  const int i = threadIdx.x;  // row of the table, 0..N
  const int ld = M + 1;

  // borders: row 0 and column 0 of the trace are -1
  for (int j = i; j <= M; j += blockDim.x) trace[j] = -1;
  trace[(size_t)i * ld] = -1;
  // diagonal 0 holds cost[0, 0] = 0; diagonal 1 holds only border cells
  diag[0][i] = i == 0 ? 0.0 : CUDART_INF;
  diag[1][i] = CUDART_INF;

  // x[i-1, d-i-1] for diagonal d, loaded one diagonal ahead
  auto load = [&](int d) -> float {
    const int j = d - i;
    return (i >= 1 && j >= 1 && j <= M) ? x[(size_t)(i - 1) * M + (j - 1)] : 0.0f;
  };
  float next = load(2);
  __syncthreads();

  for (int d = 2; d <= N + M; ++d) {
    const float xv = next;
    next = load(d + 1);
    const double* prev2 = diag[(d - 2) % 3];
    const double* prev1 = diag[(d - 1) % 3];
    const int j = d - i;
    double cost = CUDART_INF;
    if (i >= 1 && j >= 1 && j <= M) {
      const double c0 = prev2[i - 1];  // cost[i-1, j-1]
      const double c1 = prev1[i - 1];  // cost[i-1, j]
      const double c2 = prev1[i];      // cost[i, j-1]
      signed char t;
      double c;
      if (c0 < c1 && c0 < c2) {
        t = 0;
        c = c0;
      } else if (c1 < c0 && c1 < c2) {
        t = 1;
        c = c1;
      } else {
        t = 2;
        c = c2;
      }
      cost = (double)xv + c;
      trace[(size_t)i * ld + j] = t;
    }
    diag[d % 3][i] = cost;
    __syncthreads();
  }
}

}  // namespace wtt

extern "C" int wtt_dtw_trace(const float* x, signed char* trace, int N, int M,
                             cudaStream_t stream) {
  if (N < 1 || N + 1 > wtt::kMaxRows || M < 1) return (int)cudaErrorInvalidValue;
  wtt::dtw_trace_kernel<<<1, N + 1, 0, stream>>>(x, trace, N, M);
  return (int)cudaGetLastError();
}
