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
//
// Loop state (wtt_greedy_argmax_state, the captured decode loop's launch):
// n_tokens, sample_begin and the live flag are read from a device int32
// array (update_common.cuh, LoopState) that the loop advances on the card, so
// that one captured launch serves every step. Each CTA loads them at entry;
// the begin vector is then loaded only where n_tokens == sample_begin, as in
// the scalar launch. When live is 0, every CTA returns at the cluster
// barrier, before any store of a result: a replay after every row is done
// writes nothing. CTA 0 adds one to `launches`, a device counter, whether
// live or not: the count of the launches a captured graph really made.
//
// Per-row lengths at the loop state (wtt_greedy_argmax_rows_state, the
// captured speculative round's draft and verify launches): each row's length
// comes from the per-row array as in the kRows form, and sample_begin and
// live from the round's LoopState array, loaded at entry. When live is 0
// every CTA returns at the cluster barrier, as above, and CTA 0 counts the
// launch on its own device counter.
#include "update_common.cuh"

namespace wtt {

// kLen: kScalarLen, every row at n_tokens; kRowLens, row r's length is
// lens[r] (the speculative engine's draft steps and verify pass);
// kStateLens, lens is the loop's LoopState array; kRowStateLens, row r's
// length is lens[r] and `state` is the LoopState array (sample_begin, live).
template <int W, int kLen>
__global__ void __launch_bounds__(kThreads)
greedy_argmax_kernel(const float* __restrict__ logits, const int* __restrict__ tokens,
                     const int* __restrict__ lens, const int* __restrict__ state,
                     const float* __restrict__ suppress,
                     const float* __restrict__ begin, int* __restrict__ out_tok,
                     float* __restrict__ out_lp, unsigned long long* __restrict__ launches,
                     int V, int T, int n_tokens, int sample_begin, int use_ts, int eot,
                     int ts_begin) {
  int loop_live = 1;
  if constexpr (kLen == kStateLens) {
    n_tokens = min(max(__ldg(lens + kNTokens), 0), T);
    sample_begin = __ldg(lens + kSampleBegin);
    loop_live = __ldg(lens + kLive);
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  }
  if constexpr (kLen == kRowStateLens) {
    sample_begin = __ldg(state + kSampleBegin);
    loop_live = __ldg(state + kLive);
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(launches, 1ull);
  }
  constexpr bool kRows = kLen == kRowLens || kLen == kRowStateLens;
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
  sweep_chunk<1, W, kRows>(src, tokens + (size_t)row * T, n_tokens, sample_begin, use_ts, eot,
                           ts_begin, use_ts ? ts_begin : V, lo, hi, flags, scratch,
                           cluster.map_shared_rank(&parts[c], 0), kRows ? lens + row : nullptr,
                           T);
  cluster_arrive();
  cluster_wait();
  if (!loop_live) return;  // every CTA of the cluster read the same flag

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

template <int W, int kLen>
int launch_greedy(const float* logits, const int* tokens, const int* lens, const int* state,
                  const float* suppress, const float* begin, int* out_tok, float* out_lp,
                  unsigned long long* launches, int B, int V, int T, int n_tokens,
                  int sample_begin, int use_ts, int eot, int ts_begin, cudaStream_t stream) {
  int C = fit_chunks<greedy_argmax_kernel<W, kLen>>(1);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  return (int)launch_clusters(greedy_argmax_kernel<W, kLen>, B * C, C, stream, logits, tokens,
                              lens, state, suppress, begin, out_tok, out_lp, launches, V, T,
                              n_tokens, sample_begin, use_ts, eot, ts_begin);
}

}  // namespace wtt

extern "C" int wtt_greedy_argmax(const float* logits, const int* tokens, const float* suppress,
                                 const float* begin, int* out_tok, float* out_lp, int B, int V,
                                 int T, int n_tokens, int sample_begin, int use_ts, int eot,
                                 int ts_begin, cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin)
                    ? wtt::launch_greedy<2, wtt::kScalarLen>
                    : wtt::launch_greedy<1, wtt::kScalarLen>;
  return launch(logits, tokens, nullptr, nullptr, suppress, begin, out_tok, out_lp, nullptr, B, V,
                T, n_tokens, sample_begin, use_ts, eot, ts_begin, stream);
}

// Per-row lengths: row r of the (B, T) history is at length n_rows[r].
extern "C" int wtt_greedy_argmax_rows(const float* logits, const int* tokens, const int* n_rows,
                                      const float* suppress, const float* begin, int* out_tok,
                                      float* out_lp, int B, int V, int T, int sample_begin,
                                      int use_ts, int eot, int ts_begin, cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin)
                    ? wtt::launch_greedy<2, wtt::kRowLens>
                    : wtt::launch_greedy<1, wtt::kRowLens>;
  return launch(logits, tokens, n_rows, nullptr, suppress, begin, out_tok, out_lp, nullptr, B, V,
                T, 0, sample_begin, use_ts, eot, ts_begin, stream);
}

// Loop state: n_tokens, sample_begin and the live flag read from
// state[kNTokens], state[kSampleBegin], state[kLive]; nothing is written
// when live is 0. Each launch adds one to *launches (a device counter).
extern "C" int wtt_greedy_argmax_state(const float* logits, const int* tokens, const int* state,
                                       const float* suppress, const float* begin, int* out_tok,
                                       float* out_lp, unsigned long long* launches, int B, int V,
                                       int T, int use_ts, int eot, int ts_begin,
                                       cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin)
                    ? wtt::launch_greedy<2, wtt::kStateLens>
                    : wtt::launch_greedy<1, wtt::kStateLens>;
  return launch(logits, tokens, state, nullptr, suppress, begin, out_tok, out_lp, launches, B, V,
                T, 0, 0, use_ts, eot, ts_begin, stream);
}

// Per-row lengths at the loop state: row r of the (B, T) history is at
// length n_rows[r]; sample_begin and the live flag are read from
// state[kSampleBegin] and state[kLive]; nothing is written when live is 0.
// Each launch adds one to *launches (a device counter).
extern "C" int wtt_greedy_argmax_rows_state(const float* logits, const int* tokens,
                                            const int* n_rows, const int* state,
                                            const float* suppress, const float* begin,
                                            int* out_tok, float* out_lp,
                                            unsigned long long* launches, int B, int V, int T,
                                            int use_ts, int eot, int ts_begin,
                                            cudaStream_t stream) {
  auto launch = wtt::pair_loads(V, logits, suppress, begin)
                    ? wtt::launch_greedy<2, wtt::kRowStateLens>
                    : wtt::launch_greedy<1, wtt::kRowStateLens>;
  return launch(logits, tokens, n_rows, state, suppress, begin, out_tok, out_lp, launches, B, V,
                T, 0, 0, use_ts, eot, ts_begin, stream);
}

// Chunks per row (the cluster size) that the greedy kernel uses on the
// current device, 0 if none fits.
extern "C" int wtt_greedy_argmax_chunks(int V) {
  return V % 2 ? wtt::fit_chunks<wtt::greedy_argmax_kernel<1, wtt::kScalarLen>>(1)
               : wtt::fit_chunks<wtt::greedy_argmax_kernel<2, wtt::kScalarLen>>(1);
}
