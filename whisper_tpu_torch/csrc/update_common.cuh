// Device and launch helpers shared by the two per-token update kernels
// (greedy_argmax.cu, beam_update.cu): the timestamp-rule flags read from a
// row's token history, the filtered logits of a vocabulary id, the sweep of
// one chunk of a row by one CTA into a Sweep (top-K and online log-sum-exp
// of the text ids [0, split) and of the timestamp ids [split, V)), the merge
// of a row's chunk Sweeps on the cluster's rank-0 CTA, and the cluster
// launch.
//
// The split: a row's vocabulary is cut into C contiguous chunks, one per CTA
// of a thread-block cluster. Each CTA leaves its chunk's Sweep in the rank-0
// CTA's shared memory (a distributed shared-memory store, `parts[rank]`);
// after a cluster barrier rank 0 merges a row's C partials. The top-K merge
// ranks the C*K entries by better(), a total order on (value, id), so the
// ids are exactly those of a single pass; the log-sum-exps are combined by a
// fixed butterfly over the chunk ranks (rank r with r^1, then r^2, ...),
// never in arrival order, so a row's value is the same from run to run. No
// state lives outside the launch: no workspace, no counter.
//
// Semantics are those of whisper_tpu/engine_fused.py:_apply_filters (the
// SuppressBlank / SuppressTokens / ApplyTimestampRules filters), expressed
// through the two penalty vectors of build_penalty_vectors: `suppress` is
// added at every step, `begin` only at the first sampled position.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace wtt {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;       // load units in flight per thread
constexpr int kMaxCluster = 16;  // the largest (non-portable) cluster on sm_90
constexpr unsigned kFull = 0xffffffffu;

// Where a launch reads its lengths: scalar arguments, a per-row array, the
// decode loop's state array on the device, or a per-row array with the first
// sampled position and the live flag from the state array (the speculative
// round's launches).
enum { kScalarLen = 0, kRowLens = 1, kStateLens = 2, kRowStateLens = 3 };

// The decode loop's state, a device int32 array the captured loop advances
// (whisper_tpu_torch/engine.py): the tokens so far, the first sampled
// position, the loop step, and whether any row is still decoding.
enum LoopState { kNTokens = 0, kSampleBegin = 1, kStep = 2, kLive = 3 };

// (value desc, id asc): the order of a stable descending sort, i.e. ties go
// to the lower id, as jax.lax.top_k and the reference's dict order do.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The timestamp rules that depend on a row's sampled history.
struct TsFlags {
  int force_non_ts;     // a timestamp pair just closed: no timestamp next
  int force_ts_or_eot;  // mid-pair: no text token next
  int has_ts;           // some sampled token is a timestamp
  int ts_floor;         // timestamps below this id are forbidden
};

// Called by one full warp; every lane returns the flags of `row`.
__device__ inline TsFlags warp_ts_flags(const int* row, int n_tokens, int sample_begin,
                                        int ts_begin) {
  int lane = threadIdx.x & 31;
  // timestamps never decrease, so the largest sampled one is the latest
  int last_ts = -1;
  for (int p = sample_begin + lane; p < n_tokens; p += 32) {
    int t = row[p];
    if (t >= ts_begin) last_ts = max(last_ts, t);
  }
  for (int o = 16; o; o >>= 1) last_ts = max(last_ts, __shfl_xor_sync(kFull, last_ts, o));
  int seq_len = n_tokens - sample_begin;
  int last_tok = row[max(n_tokens - 1, 0)];
  int penult_tok = row[max(n_tokens - 2, 0)];
  bool last_was_ts = seq_len >= 1 && last_tok >= ts_begin;
  bool penult_was_ts = seq_len < 2 || penult_tok >= ts_begin;
  TsFlags f;
  f.force_non_ts = last_was_ts && penult_was_ts;
  f.force_ts_or_eot = last_was_ts && !penult_was_ts;
  f.has_ts = last_ts >= 0;
  f.ts_floor = f.force_ts_or_eot ? last_ts : last_ts + 1;
  return f;
}

// One row's inputs: the logits row and the penalty vectors.
struct RowSrc {
  const float* logits;    // the row
  const float* suppress;  // (V,)
  const float* begin;     // (V,), or nullptr past the first sampled position
};

// The raw inputs of W consecutive ids [id, id + W), loaded without any
// arithmetic, so that the loads stay in flight across a barrier. W = 2 loads
// float2: V even and 8-byte aligned base pointers keep every row and every
// even id 8-byte aligned (a row of V = 51866 floats is 16-byte aligned only
// at even rows). W = 1 serves an odd V or an unaligned base (pair_loads).
template <int W>
struct Unit {
  float l[W], s[W], b[W];

  __device__ __forceinline__ void load(const RowSrc& src, int id) {
    if constexpr (W == 2) {
      float2 l2 = __ldg(reinterpret_cast<const float2*>(src.logits + id));
      float2 s2 = __ldg(reinterpret_cast<const float2*>(src.suppress + id));
      l[0] = l2.x, l[1] = l2.y, s[0] = s2.x, s[1] = s2.y;
      if (src.begin) {
        float2 b2 = __ldg(reinterpret_cast<const float2*>(src.begin + id));
        b[0] = b2.x, b[1] = b2.y;
      }
    } else {
      l[0] = __ldg(src.logits + id);
      s[0] = __ldg(src.suppress + id);
      if (src.begin) b[0] = __ldg(src.begin + id);
    }
  }
};

// The timestamp rules applied to the penalised logit v of vocabulary id `id`.
struct RowFilter {
  int use_ts, eot, ts_begin;
  TsFlags f;

  __device__ __forceinline__ float operator()(float v, int id) const {
    if (use_ts) {
      if (f.force_non_ts && id >= ts_begin) v = -CUDART_INF_F;
      if (f.force_ts_or_eot && id < eot) v = -CUDART_INF_F;
      if (f.has_ts && id >= ts_begin && id < f.ts_floor) v = -CUDART_INF_F;
    }
    return v;
  }
};

// A sorted (better() order) list of the K best (value, id) pairs seen.
template <int K>
struct TopK {
  float v[K];
  int id[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = -CUDART_INF_F;
      id[k] = INT_MAX;  // sentinel: worse than any real entry
    }
  }
  __device__ __forceinline__ void push(float x, int i) {
    if (!better(x, i, v[K - 1], id[K - 1])) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (better(x, i, v[k], id[k])) {
        float tv = v[k];
        int ti = id[k];
        v[k] = x;
        id[k] = i;
        x = tv;
        i = ti;
      }
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) {
      v[k] = v[k + 1];
      id[k] = id[k + 1];
    }
    v[K - 1] = -CUDART_INF_F;
    id[K - 1] = INT_MAX;
  }
};

// Online log-sum-exp: running max m and sum s of exp(x - m).
struct Lse {
  float m, s;

  __device__ __forceinline__ void init() {
    m = -CUDART_INF_F;
    s = 0.f;
  }
  __device__ __forceinline__ void push(float x) {
    if (x == -CUDART_INF_F) return;
    if (x > m) {
      s = s * expf(m - x) + 1.f;
      m = x;
    } else {
      s += expf(x - m);
    }
  }
  // An empty side (m = -inf: a chunk with no finite logit) is skipped, so
  // -inf - -inf is never formed.
  __device__ __forceinline__ void merge(float om, float os) {
    if (om == -CUDART_INF_F) return;
    if (m == -CUDART_INF_F) {
      m = om;
      s = os;
      return;
    }
    float M = fmaxf(m, om);
    s = s * expf(m - M) + os * expf(om - M);
    m = M;
  }
  __device__ __forceinline__ float value() const {
    return m == -CUDART_INF_F ? -CUDART_INF_F : m + logf(s);
  }
};

// Butterfly merge of the text and timestamp sums across the warp: a fixed
// order (lane l with l^1, then l^2, ...), so lane 0's result is
// deterministic. Every lane gets a result.
__device__ __forceinline__ void warp_lse2(Lse& a, Lse& b) {
  for (int o = 1; o < 32; o <<= 1) {
    float am = __shfl_xor_sync(kFull, a.m, o), as = __shfl_xor_sync(kFull, a.s, o);
    float bm = __shfl_xor_sync(kFull, b.m, o), bs = __shfl_xor_sync(kFull, b.s, o);
    a.merge(am, as);
    b.merge(bm, bs);
  }
}

// K rounds of warp argmax over the lanes' list heads, for two lists at
// once (the text and the timestamp region, two independent shuffle chains).
// Lane k < K receives the k-th entry of each warp-wide list.
template <int K>
__device__ __forceinline__ void warp_topk2(TopK<K>& a, TopK<K>& b, float& av, int& ai,
                                           float& bv, int& bi) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v1 = a.v[0], v2 = b.v[0];
    int i1 = a.id[0], i2 = b.id[0];
    for (int o = 16; o; o >>= 1) {
      float ov1 = __shfl_xor_sync(kFull, v1, o), ov2 = __shfl_xor_sync(kFull, v2, o);
      int oi1 = __shfl_xor_sync(kFull, i1, o), oi2 = __shfl_xor_sync(kFull, i2, o);
      if (better(ov1, oi1, v1, i1)) v1 = ov1, i1 = oi1;
      if (better(ov2, oi2, v2, i2)) v2 = ov2, i2 = oi2;
    }
    if (i1 != INT_MAX && a.id[0] == i1) a.pop();  // ids are unique
    if (i2 != INT_MAX && b.id[0] == i2) b.pop();
    if (lane == k) av = v1, ai = i1, bv = v2, bi = i2;
  }
}

// The result of sweeping one chunk of a row, or, after the merge, the row.
template <int K>
struct Sweep {
  float tv[K];  // best K of the text region [0, split)
  int ti[K];
  float sv[K];  // best K of the timestamp region [split, V)
  int si[K];
  Lse txt, ts;  // the regions' log-sum-exp; txt.m is the largest text logit
};

// Per-warp partials of the block reduction.
template <int K>
struct Scratch {
  float tv[kWarps][K], sv[kWarps][K];
  int ti[kWarps][K], si[kWarps][K];
  Lse txt[kWarps], ts[kWarps];
};

// Thread-block cluster barriers. arrive_relaxed + wait at the start of a
// kernel only ensures that every CTA of the cluster has started (its shared
// memory may then be written); arrive + wait orders the shared-memory
// stores before it, local and remote, before the loads after it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One CTA sweeps ids [lo, hi) of one row (lo, hi multiples of W) and stores
// the chunk's Sweep into `dst`, a slot of the rank-0 CTA's shared memory.
// The first kUnroll units per thread are loaded before the row's flags are
// read from its history (warp 0), so the two latencies overlap. Every thread
// of the CTA must call; the call includes the wait on the cluster arrival
// that the kernel made at its start.
//
// kRows: the row's length is read from `n_row` (n_tokens is ignored). Its
// load is issued with the first units, which then load the begin vector
// whatever the length (src.begin must be set); the begin penalty is added
// where the row is at sample_begin. The history is read up to
// min(length, T).
template <int K, int W, bool kRows = false>
__device__ void sweep_chunk(const RowSrc& src, const int* hist, int n_tokens, int sample_begin,
                            int use_ts, int eot, int ts_begin, int split, int lo, int hi,
                            TsFlags& flags, Scratch<K>& scratch, Sweep<K>* dst,
                            const int* n_row = nullptr, int T = 0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_units = (hi - lo) / W;
  if constexpr (kRows) n_tokens = __ldg(n_row);
  Unit<W> u[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    int j = tid + k * kThreads;
    if (j < n_units) u[k].load(src, lo + j * W);
  }
  if (warp == 0) {
    TsFlags f = {0, 0, 0, 0};
    if (use_ts) {
      if constexpr (kRows) {
        f = warp_ts_flags(hist, min(max(n_tokens, 0), T), sample_begin, ts_begin);
      } else {
        f = warp_ts_flags(hist, n_tokens, sample_begin, ts_begin);
      }
    }
    if (lane == 0) flags = f;
  }
  __syncthreads();
  const RowFilter rf{use_ts, eot, ts_begin, flags};
  const bool add_begin = kRows ? n_tokens == sample_begin : src.begin != nullptr;

  TopK<K> txt, ts;
  txt.init();
  ts.init();
  Lse lt, ls;
  lt.init();
  ls.init();
  for (int base = tid;;) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int j = base + k * kThreads;
      if (j >= n_units) break;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        int id = lo + j * W + w;
        float x = u[k].l[w] + u[k].s[w];
        if (add_begin) x += u[k].b[w];
        x = rf(x, id);
        if (id < split) {  // the region is per id: split may fall inside a chunk
          txt.push(x, id);
          lt.push(x);
        } else {
          ts.push(x, id);
          ls.push(x);
        }
      }
    }
    base += kUnroll * kThreads;
    if (base >= n_units) break;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      int j = base + k * kThreads;
      if (j < n_units) u[k].load(src, lo + j * W);
    }
  }

  // the block's reduction: per warp, then warp 0 over the warps
  float tv = -CUDART_INF_F, sv = -CUDART_INF_F;
  int ti = INT_MAX, si = INT_MAX;
  warp_topk2<K>(txt, ts, tv, ti, sv, si);
  warp_lse2(lt, ls);
  if (lane < K) {
    scratch.tv[warp][lane] = tv, scratch.ti[warp][lane] = ti;
    scratch.sv[warp][lane] = sv, scratch.si[warp][lane] = si;
  }
  if (lane == 0) scratch.txt[warp] = lt, scratch.ts[warp] = ls;
  __syncthreads();
  if (warp == 0) {
    txt.init();
    ts.init();
    lt.init();
    ls.init();
    if (lane < kWarps) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        txt.v[k] = scratch.tv[lane][k], txt.id[k] = scratch.ti[lane][k];
        ts.v[k] = scratch.sv[lane][k], ts.id[k] = scratch.si[lane][k];
      }
      lt = scratch.txt[lane];
      ls = scratch.ts[lane];
    }
    warp_topk2<K>(txt, ts, tv, ti, sv, si);
    warp_lse2(lt, ls);
  }
  cluster_wait();  // every CTA of the cluster has started: dst may be written
  if (warp == 0) {
    if (lane < K) {
      dst->tv[lane] = tv, dst->ti[lane] = ti;
      dst->sv[lane] = sv, dst->si[lane] = si;
    }
    if (lane == 0) dst->txt = lt, dst->ts = ls;
  }
}

// Merges a row's C <= 32 / K chunk partials (in the calling CTA's shared
// memory, chunk order) into `out`. Called by one full warp. Each of the C*K
// entries of a region goes to one lane, which counts the entries better
// than its own (lane order breaks the ties between sentinels): its rank is
// its place in the merged list. The sums merge by warp_lse2 over lanes
// 0..C-1, lane c holding chunk c.
template <int K>
__device__ void merge_row(const Sweep<K>* parts, int C, Sweep<K>& out) {
  const int lane = threadIdx.x & 31;
  const int n = C * K;
  float tv = -CUDART_INF_F, sv = -CUDART_INF_F;
  int ti = INT_MAX, si = INT_MAX;
  if (lane < n) {
    const Sweep<K>& p = parts[lane / K];
    int k = lane % K;
    tv = p.tv[k], ti = p.ti[k], sv = p.sv[k], si = p.si[k];
  }
  int rt = 0, rs = 0;
  for (int j = 0; j < 32; ++j) {
    float otv = __shfl_sync(kFull, tv, j), osv = __shfl_sync(kFull, sv, j);
    int oti = __shfl_sync(kFull, ti, j), osi = __shfl_sync(kFull, si, j);
    rt += better(otv, oti, tv, ti) || (otv == tv && oti == ti && j < lane);
    rs += better(osv, osi, sv, si) || (osv == sv && osi == si && j < lane);
  }
  if (rt < K) out.tv[rt] = tv, out.ti[rt] = ti;
  if (rs < K) out.sv[rs] = sv, out.si[rs] = si;
  Lse lt, ls;
  lt.init();
  ls.init();
  if (lane < C) lt = parts[lane].txt, ls = parts[lane].ts;
  warp_lse2(lt, ls);
  if (lane == 0) out.txt = lt, out.ts = ls;
  __syncwarp();
}

// The candidates of one row after the timestamp-mass rule, as log-probs:
// the K best of the whole filtered row, unless the timestamp mass beats
// every text logit — then text ids are -inf and the K best are the finite
// timestamps followed by the lowest text ids at -inf (the order a stable
// descending sort of the filtered row gives). Called by one thread.
template <int K>
__device__ void row_candidates(const Sweep<K>& sw, int use_ts, float* lp, int* tok) {
  Lse all = sw.txt;
  all.merge(sw.ts.m, sw.ts.s);
  float lse_all = all.value();
  if (use_ts) {
    float lse_ts = sw.ts.value();
    if (lse_ts > sw.txt.m) {  // raw-logit form of logsumexp_ts(lp) > max_text(lp)
      int n = 0;
      for (int k = 0; k < K; ++k) {
        if (sw.sv[k] > -CUDART_INF_F) {
          lp[n] = sw.sv[k] - lse_ts;
          tok[n] = sw.si[k];
          ++n;
        }
      }
      for (int fill = 0; n < K; ++fill, ++n) {
        lp[n] = -CUDART_INF_F;
        tok[n] = fill;
      }
      return;
    }
  }
  // merge the two sorted lists (all text ids precede the timestamp ids)
  int i = 0, j = 0;
  for (int k = 0; k < K; ++k) {
    bool take_ts = better(sw.sv[j], sw.si[j], sw.tv[i], sw.ti[i]);
    float v = take_ts ? sw.sv[j] : sw.tv[i];
    tok[k] = take_ts ? sw.si[j] : sw.ti[i];
    if (take_ts) ++j; else ++i;
    float x = v - lse_all;
    lp[k] = x > -CUDART_INF_F ? x : -CUDART_INF_F;  // -inf - -inf guard
  }
}

// Chunk c of C over [0, V): lengths a multiple of W, the last one shorter
// (or empty).
template <int W>
__device__ __forceinline__ void chunk_bounds(int V, int C, int c, int& lo, int& hi) {
  int len = ((V + C - 1) / C + W - 1) / W * W;
  lo = min(c * len, V);
  hi = min(lo + len, V);
}

// ---- host side -------------------------------------------------------------

// Chunks per row: the largest C <= kMaxCluster / rows_per_cluster whose
// cluster of rows_per_cluster * C CTAs fits on the card
// (cudaOccupancyMaxActiveClusters > 0), halving C until it does (on an
// H100, C = 16 / rows_per_cluster always fits). Cached per kernel and
// device: the occupancy query costs host time, and the host paces the
// decode loop. Returns 0 if not even C = 1 fits.
template <auto kernel>
int fit_chunks(int rows_per_cluster) {
  static int cache[64];  // [device] -> C (0: not asked yet)
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cache[dev]) return cache[dev];
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int C = kMaxCluster / rows_per_cluster;
  for (; C >= 1; C = C == 1 ? 0 : (C + 1) / 2) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = rows_per_cluster * C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(rows_per_cluster * C);
    cfg.blockDim = dim3(kThreads);
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess && n > 0) break;
  }
  cudaGetLastError();  // a refused size leaves its error behind
  if (C > 0 && dev < 64) cache[dev] = C;
  return C;
}

// W = 2 (float2 loads) where V is even and the logits and both penalty
// vectors are 8-byte aligned, else W = 1 (a contiguous view may start at
// any float).
__host__ inline bool pair_loads(int V, const float* logits, const float* suppress,
                                const float* begin) {
  auto al8 = [](const float* p) { return reinterpret_cast<size_t>(p) % 8 == 0; };
  return V % 2 == 0 && al8(logits) && al8(suppress) && al8(begin);
}

// One launch of `kernel` on `grid` CTAs of kThreads in clusters of `cluster`.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int grid, int cluster,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace wtt
