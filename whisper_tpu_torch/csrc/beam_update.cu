// One beam-search update for A audios of G beams each, one thread-block
// cluster per audio.
//
// Replaces: whisper_tpu/ops/beam_kernel.py:beam_update_pallas (body
// _beam_update_kernel with _region_sweep / _merge_topk). The Pallas kernel
// takes one audio; this one takes (A*G, V) logits and (A, MC, T+1) finished
// pools, the semantics of engine_fused._apply_filters + _beam_update:
//   * the filters of greedy_argmax.cu, per beam;
//   * per beam, the top-(G+1) log-probs (ties to the lower id);
//   * ranking of the audio's G*(G+1) candidates by score, ties by the flat
//     (beam, rank) id; at step 0 only beam 0's candidates compete;
//   * EOT candidates are collected only ahead of the G-th live candidate,
//     into the patience-capped pool while it has room (the pool rows,
//     scores, lengths and counts are updated in place);
//   * the first G live candidates become the new beams: their source rows
//     are gathered into a fresh token buffer and the new token appended.
//
// Bound on this card: bytes, in principle. The least traffic is the (G, V)
// f32 logits, the penalty vectors and the token rows, about 1.3 MB at G = 5
// and V = 51866: 0.38 us at 3.35 TB/s, below the latency of any launch.
// What an update costs is latency: of the launch, of the loads, of the
// reductions and of the serial selection.
//
// Design: the audio's cluster holds G*C CTAs, one per (beam g, chunk c) at
// cluster rank g*C + c, with C = 16 / G chunks per row where the card holds
// such clusters (else the largest that fits; see fit_chunks), so the G rows
// are swept at the same time. Each CTA sweeps its chunk as the greedy kernel
// does, into a Sweep<G+1>, and stores it into the rank-0 CTA's shared
// memory. After a cluster barrier, rank 0 merges each row's C partials
// (warp g: row g; merge_row, in an order fixed by the chunk ranks), applies
// the timestamp-mass rule, ranks the
// G*(G+1) candidates (each thread counts the candidates better than its
// own), and walks the ranking in parallel (each candidate counts the live
// and the collected EOT candidates ahead of it): it writes the new scores,
// sources and the pool's scores, lengths and count, and copies the
// selection into every CTA's shared memory. After a second cluster barrier,
// which also keeps every CTA alive until rank 0 is done with the cluster's
// shared memory, all G*C CTAs gather the new token rows and the pool rows
// taken, each a slice of them.
#include "update_common.cuh"

namespace wtt {

// What rank 0 decided, copied into every CTA of the cluster.
template <int G>
struct Selection {
  int src[G];        // the new beams' source beams
  int tok[G];        // and their new tokens
  int n_take;        // EOT candidates put into the pool (at most one per beam)
  int take_src[G];   // their source beams
  int take_slot[G];  // and their pool slots
};

template <int G, int W>
__global__ void __launch_bounds__(kThreads)
beam_update_kernel(const float* __restrict__ logits, const int* __restrict__ tokens,
                   const float* __restrict__ sum_lp, int* __restrict__ pool_tokens,
                   float* __restrict__ pool_scores, int* __restrict__ pool_lengths,
                   int* __restrict__ pool_count, const float* __restrict__ suppress,
                   const float* __restrict__ begin, int* __restrict__ out_tokens,
                   int* __restrict__ out_src, float* __restrict__ out_sum_lp, int V, int T,
                   int MC, int n_tokens, int sample_begin, int step, int use_ts, int eot,
                   int ts_begin) {
  constexpr int K = G + 1;
  constexpr int NC = G * K;
  __shared__ TsFlags flags;
  __shared__ Scratch<K> scratch;
  __shared__ Sweep<K> parts[kMaxCluster];  // rank 0's: the (beam, chunk) partials
  __shared__ Sweep<K> row_sweep[G];        // rank 0's: the merged rows
  __shared__ float cand_lp[NC];
  __shared__ int cand_tok[NC];
  __shared__ float cand_score[NC];
  __shared__ float o_score[NC];
  __shared__ int o_tok[NC];
  __shared__ int o_src[NC];
  __shared__ Selection<G> sel;
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int N = cluster.num_blocks();
  const int C = N / G;
  const int rank = cluster.block_rank();
  const int a = blockIdx.x / N;
  const int row0 = a * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  {
    const int g = rank / C;
    int lo, hi;
    chunk_bounds<W>(V, C, rank % C, lo, hi);
    RowSrc src{logits + (size_t)(row0 + g) * V, suppress,
               n_tokens == sample_begin ? begin : nullptr};
    sweep_chunk<K, W>(src, tokens + (size_t)(row0 + g) * T, n_tokens, sample_begin, use_ts, eot,
                      ts_begin, use_ts ? ts_begin : V, lo, hi, flags, scratch,
                      cluster.map_shared_rank(&parts[rank], 0));
  }
  cluster_arrive();
  cluster_wait();

  if (rank == 0) {
    const int fc = pool_count[a];  // read before thread NC-1 writes it
    if (warp < G) {
      merge_row<K>(parts + warp * C, C, row_sweep[warp]);
      if ((tid & 31) == 0)
        row_candidates<K>(row_sweep[warp], use_ts, cand_lp + warp * K, cand_tok + warp * K);
    }
    __syncthreads();
    if (tid < NC) {
      int g = tid / K;
      float s = sum_lp[row0 + g] + cand_lp[tid];
      // step 0: all beams are identical; only beam 0's candidates count
      cand_score[tid] = (step == 0 && g > 0) ? -CUDART_INF_F : s;
    }
    __syncthreads();
    if (tid < NC) {
      int r = 0;
      float s = cand_score[tid];
      for (int j = 0; j < NC; ++j) r += better(cand_score[j], j, s, tid);
      o_score[r] = s;
      o_tok[r] = cand_tok[tid];
      o_src[r] = tid / K;
    }
    __syncthreads();
    if (tid < NC) {  // thread r walks to its own place in the ranking
      int live = 0, coll = 0;  // live / collected EOT candidates ahead of r
      for (int j = 0; j < tid; ++j) {
        if (o_tok[j] == eot) coll += live < G;
        else ++live;
      }
      const int tok = o_tok[tid];
      if (tok == eot) {
        int slot = fc + coll;
        if (live < G && slot < MC) {  // finished ahead of the G-th live candidate
          pool_scores[a * MC + slot] = o_score[tid];
          pool_lengths[a * MC + slot] = n_tokens + 1;
          sel.take_src[coll] = o_src[tid];
          sel.take_slot[coll] = slot;
        }
      } else if (live < G) {
        sel.src[live] = o_src[tid];
        sel.tok[live] = tok;
        out_src[row0 + live] = row0 + o_src[tid];
        out_sum_lp[row0 + live] = o_score[tid];
      }
      if (tid == NC - 1) {
        int collected = coll + (tok == eot && live < G);
        int taken = min(collected, max(MC - fc, 0));
        sel.n_take = taken;
        pool_count[a] = fc + taken;
      }
    }
    __syncthreads();
    constexpr int kWords = sizeof(Selection<G>) / sizeof(int);
    const int* from = reinterpret_cast<const int*>(&sel);
    for (int i = kWords + tid; i < N * kWords; i += kThreads) {
      int* to = reinterpret_cast<int*>(cluster.map_shared_rank(&sel, i / kWords));
      to[i % kWords] = from[i % kWords];
    }
  }
  cluster_arrive();
  cluster_wait();

  // the gather, a slice per CTA
  const int stride = N * kThreads;
  for (int i = rank * kThreads + tid; i < G * T; i += stride) {
    int b = i / T, p = i - b * T;
    out_tokens[(size_t)(row0 + b) * T + p] =
        p == n_tokens ? sel.tok[b] : tokens[(size_t)(row0 + sel.src[b]) * T + p];
  }
  for (int q = 0; q < sel.n_take; ++q) {
    const int* from = tokens + (size_t)(row0 + sel.take_src[q]) * T;
    int* to = pool_tokens + ((size_t)a * MC + sel.take_slot[q]) * (T + 1);
    for (int p = rank * kThreads + tid; p <= T; p += stride)
      to[p] = p == n_tokens ? eot : (p < T ? from[p] : 0);
  }
}

template <int G, int W>
int launch_beam(const float* logits, const int* tokens, const float* sum_lp, int* pool_tokens,
                float* pool_scores, int* pool_lengths, int* pool_count, const float* suppress,
                const float* begin, int* out_tokens, int* out_src, float* out_sum_lp, int A,
                int V, int T, int MC, int n_tokens, int sample_begin, int step, int use_ts,
                int eot, int ts_begin, cudaStream_t stream) {
  int C = fit_chunks<beam_update_kernel<G, W>>(G);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  return (int)launch_clusters(beam_update_kernel<G, W>, A * G * C, G * C, stream, logits,
                              tokens, sum_lp, pool_tokens, pool_scores, pool_lengths,
                              pool_count, suppress, begin, out_tokens, out_src, out_sum_lp, V,
                              T, MC, n_tokens, sample_begin, step, use_ts, eot, ts_begin);
}

template <int G>
int chunks(int V) {
  return V % 2 ? fit_chunks<beam_update_kernel<G, 1>>(G) : fit_chunks<beam_update_kernel<G, 2>>(G);
}

}  // namespace wtt

extern "C" int wtt_beam_update(const float* logits, const int* tokens, const float* sum_lp,
                               int* pool_tokens, float* pool_scores, int* pool_lengths,
                               int* pool_count, const float* suppress, const float* begin,
                               int* out_tokens, int* out_src, float* out_sum_lp, int A, int G,
                               int V, int T, int MC, int n_tokens, int sample_begin, int step,
                               int use_ts, int eot, int ts_begin, cudaStream_t stream) {
  const bool vec = wtt::pair_loads(V, logits, suppress, begin);
#define WTT_CASE(g)                                                                          \
  case g:                                                                                    \
    return (vec ? wtt::launch_beam<g, 2> : wtt::launch_beam<g, 1>)(                          \
        logits, tokens, sum_lp, pool_tokens, pool_scores, pool_lengths, pool_count, suppress, \
        begin, out_tokens, out_src, out_sum_lp, A, V, T, MC, n_tokens, sample_begin, step,    \
        use_ts, eot, ts_begin, stream);
  switch (G) {
    WTT_CASE(1)
    WTT_CASE(2)
    WTT_CASE(3)
    WTT_CASE(4)
    WTT_CASE(5)
    WTT_CASE(6)
    WTT_CASE(7)
    WTT_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WTT_CASE
}

// Chunks per row that the beam kernel uses for groups of G on the current
// device (its clusters hold G times as many CTAs), 0 if none fits or G is
// out of range.
extern "C" int wtt_beam_update_chunks(int G, int V) {
  switch (G) {
    case 1: return wtt::chunks<1>(V);
    case 2: return wtt::chunks<2>(V);
    case 3: return wtt::chunks<3>(V);
    case 4: return wtt::chunks<4>(V);
    case 5: return wtt::chunks<5>(V);
    case 6: return wtt::chunks<6>(V);
    case 7: return wtt::chunks<7>(V);
    case 8: return wtt::chunks<8>(V);
    default: return 0;
  }
}
