// Filtered greedy argmax and its log-probability, one thread-block cluster
// per row.
//
// Replaces: whisper_tpu/ops/beam_kernel.py:greedy_argmax_pallas (body
// _greedy_argmax_kernel, region sweeps at K=1). Computes, per row, the
// SuppressBlank / SuppressTokens penalties, the timestamp rules read from
// the token history, the timestamp-mass rule, the argmax with ties to the
// lowest id, and logit - logsumexp of the filtered row.
//
// Bound on this card: bytes, in principle. The least traffic is the (B, V)
// f32 logits plus the penalty vectors, about 0.4 MB at B = 1, V = 51866:
// 0.12 us at 3.35 TB/s, below the latency of any launch. What one row costs
// is latency: of the launch, of a few rounds of loads, of the reductions.
//
// Design: the row's vocabulary is split into C contiguous chunks, one per
// CTA of a cluster of C CTAs (C = 16 where the card holds such clusters,
// else the largest that fits; see fit_chunks). Each CTA computes the row's
// timestamp flags itself while its first loads are in flight, sweeps its
// chunk (float2 loads where V is even and the inputs are 8-byte aligned)
// into a text and a timestamp region (split per id), reduces them to a
// Sweep<1> and stores it into the rank-0 CTA's shared memory. After one
// cluster barrier, one warp of rank 0 merges
// the C partials (update_common.cuh: the top-1 by better(), the sums by a
// fixed butterfly over the ranks) and applies the timestamp-mass rule. The
// other CTAs exit at the barrier: nobody reads their shared memory. The
// begin penalty is read only at the first sampled position.
//
// Per-row lengths (wtt_greedy_argmax_rows): each CTA reads its row's length
// from memory, alongside its first loads; it then loads the begin vector for
// every row and adds it where the row is at sample_begin, and reads the
// row's timestamp history up to its own length. The scalar launch is a
// separate instantiation, unchanged.
#include "update_common.cuh"

namespace wtt {

// kRows: row r's length is n_rows[r] (the speculative engine's draft steps
// and verify pass); otherwise every row is at n_tokens.
template <int W, bool kRows>
__global__ void __launch_bounds__(kThreads)
greedy_argmax_kernel(const float* __restrict__ logits, const int* __restrict__ tokens,
                     const int* __restrict__ n_rows, const float* __restrict__ suppress,
                     const float* __restrict__ begin, int* __restrict__ out_tok,
                     float* __restrict__ out_lp, int V, int T, int n_tokens, int sample_begin,
                     int use_ts, int eot, int ts_begin) {
  __shared__ TsFlags flags;
  __shared__ Scratch<1> scratch;
  __shared__ Sweep<1> parts[kMaxCluster];  // rank 0's: the chunks' partials
  __shared__ Sweep<1> row_sweep;
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster.num_blocks();
  const int c = cluster.block_rank();
  const int row = blockIdx.x / C;

  int lo, hi;
  chunk_bounds<W>(V, C, c, lo, hi);
  const float* beg = kRows || n_tokens == sample_begin ? begin : nullptr;
  RowSrc src{logits + (size_t)row * V, suppress, beg};
  const int* n_row = kRows ? n_rows + row : nullptr;
  sweep_chunk<1, W, kRows>(src, tokens + (size_t)row * T, n_tokens, sample_begin, use_ts, eot,
                           ts_begin, use_ts ? ts_begin : V, lo, hi, flags, scratch,
                           cluster.map_shared_rank(&parts[c], 0), n_row, T);
  cluster_arrive();
  cluster_wait();

  if (c == 0 && threadIdx.x < 32) {
    merge_row<1>(parts, C, row_sweep);
    if (threadIdx.x == 0) {
      float lp;
      int tok;
      row_candidates<1>(row_sweep, use_ts, &lp, &tok);
      out_tok[row] = tok;
      out_lp[row] = lp;
    }
  }
}

template <int W, bool kRows>
int launch_greedy(const float* logits, const int* tokens, const int* n_rows,
                  const float* suppress, const float* begin, int* out_tok, float* out_lp, int B,
                  int V, int T, int n_tokens, int sample_begin, int use_ts, int eot,
                  int ts_begin, cudaStream_t stream) {
  int C = fit_chunks<greedy_argmax_kernel<W, kRows>>(1);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  return (int)launch_clusters(greedy_argmax_kernel<W, kRows>, B * C, C, stream, logits, tokens,
                              n_rows, suppress, begin, out_tok, out_lp, V, T, n_tokens,
                              sample_begin, use_ts, eot, ts_begin);
}

}  // namespace wtt

extern "C" int wtt_greedy_argmax(const float* logits, const int* tokens, const float* suppress,
                                 const float* begin, int* out_tok, float* out_lp, int B, int V,
                                 int T, int n_tokens, int sample_begin, int use_ts, int eot,
                                 int ts_begin, cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin) ? wtt::launch_greedy<2, false>
                                                             : wtt::launch_greedy<1, false>;
  return launch(logits, tokens, nullptr, suppress, begin, out_tok, out_lp, B, V, T, n_tokens,
                sample_begin, use_ts, eot, ts_begin, stream);
}

// Per-row lengths: row r of the (B, T) history is at length n_rows[r].
extern "C" int wtt_greedy_argmax_rows(const float* logits, const int* tokens, const int* n_rows,
                                      const float* suppress, const float* begin, int* out_tok,
                                      float* out_lp, int B, int V, int T, int sample_begin,
                                      int use_ts, int eot, int ts_begin, cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin) ? wtt::launch_greedy<2, true>
                                                             : wtt::launch_greedy<1, true>;
  return launch(logits, tokens, n_rows, suppress, begin, out_tok, out_lp, B, V, T, 0,
                sample_begin, use_ts, eot, ts_begin, stream);
}

// Chunks per row (the cluster size) that the greedy kernel uses on the
// current device, 0 if none fits.
extern "C" int wtt_greedy_argmax_chunks(int V) {
  return V % 2 ? wtt::fit_chunks<wtt::greedy_argmax_kernel<1, false>>(1)
               : wtt::fit_chunks<wtt::greedy_argmax_kernel<2, false>>(1);
}
