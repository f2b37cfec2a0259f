// wtt_transcribe: native end-to-end transcription on the card, with no
// Python in the loop (the counterpart of runtime/wtpu_transcribe.cpp and
// runtime/pjrt_runner.cpp; libtorch takes the place of the PJRT C API).
//
// It reads a directory written by whisper_tpu_torch.export.export_pipeline:
//
//   encoder / cross_kv / prefill / filters, step_greedy / step_beam and
//   their windows step_greedy_w128 / _w256, step_beam_w128 / _w256
//       .aoti.pt2 (AOTInductor packages) + .spec.txt (I/O manifest)
//   encoder.params.bin, decoder.params.bin (decoder_int8.params.bin)
//   suppress_pen.bin / begin_pen.bin, <vocab>.tiktoken, pipeline.txt,
//   loop.txt (the loop's phases, their step packages, the done lag)
//
// and runs audio decode -> log-mel (runtime/audioio.cpp) -> encoder ->
// cross-K/V -> prefill and step 0 (the update kernels' scalar launches) ->
// the decode loop -> ranking -> detokenization, with the temperature ladder
// and the quality gates of the JAX binary. The loop is engine.FusedEngine's
// program (the counterpart of the JAX export's fused_greedy / fused_beam):
// one loop body on static buffers (the step package at the cache phase's
// window 128, 256 or 448, the update kernels' loop-state launches
// wtt_greedy_argmax_state / wtt_beam_update_state through their C ABI, or at
// T > 0 the filters package and the engine's draw; the live-masked token,
// source and score writes; the loop state's advance; a pinned copy of the
// live flag), captured as a CUDA graph once per (mode, window) at first use
// (csrc/wtt_graph.cpp) and replayed once per token. The host knows how many
// tokens it has decoded, so it stops at sample_len, at 448 and at each
// phase's edge without reading the card; the one read between tokens is the
// live flag as the pass done_lag back left it, after that pass's CUDA event.
// --no-capture runs the same body uncaptured. Everything runs on a side
// stream (no graph is captured on the legacy default stream). Weights are
// uploaded to the card once, checked against the spec, and one copy of the
// decoder serves every decoder graph.
//
// Usage:
//   wtt_transcribe <pipeline_dir> <audio> [--max-windows N] [--tokens]
//       [--beam] [--no-fallback] [--no-capture]
//   wtt_transcribe <pipeline_dir> --serve SOCK [--no-capture]
//
// The transcript goes to stdout; per-window lines ("[wtt] {json}") go to
// stderr, with the update launches, replays, captures, done reads and ms
// per token. Build: whisper_tpu_torch.runtime.build.build_runner().

#include <ATen/ATen.h>
#include <c10/core/Event.h>
#include <c10/core/InferenceMode.h>
#include <c10/core/impl/VirtualGuardImpl.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <vector>

extern "C" {
// runtime/audioio.cpp (linked into this binary)
const char* audioio_last_error();
int audioio_decode(const char* path, int target_sr, float** out_samples, int64_t* out_n);
int audioio_log_mel(const float* audio, int64_t n_samples, int n_mels, int64_t padding,
                    float** out, int64_t* out_frames);
void audioio_free(float* p);
// whisper_tpu_torch/csrc: the update kernels' C ABI (the kernels' library)
int wtt_greedy_argmax(const float* logits, const int* tokens, const float* suppress,
                      const float* begin, int* out_tok, float* out_lp, int B, int V, int T,
                      int n_tokens, int sample_begin, int use_ts, int eot, int ts_begin,
                      void* stream);
int wtt_beam_update(const float* logits, const int* tokens, const float* sum_lp, int* pool_tokens,
                    float* pool_scores, int* pool_lengths, int* pool_count, const float* suppress,
                    const float* begin, int* out_tokens, int* out_src, float* out_sum_lp, int A,
                    int G, int V, int T, int MC, int n_tokens, int sample_begin, int step,
                    int use_ts, int eot, int ts_begin, void* stream);
int wtt_greedy_argmax_state(const float* logits, const int* tokens, const int* state,
                            const float* suppress, const float* begin, int* out_tok,
                            float* out_lp, unsigned long long* launches, int B, int V, int T,
                            int use_ts, int eot, int ts_begin, void* stream);
int wtt_beam_update_state(const float* logits, const int* tokens, const float* sum_lp,
                          int* pool_tokens, float* pool_scores, int* pool_lengths, int* pool_count,
                          const float* suppress, const float* begin, const int* state,
                          unsigned long long* launches, int* out_tokens, int* out_src,
                          float* out_sum_lp, int A, int G, int V, int T, int MC, int use_ts,
                          int eot, int ts_begin, void* stream);
// whisper_tpu_torch/csrc/wtt_graph.cpp: CUDA graphs and the side stream
const char* wtt_graph_last_error();
int wtt_graph_side_stream(int device, void** stream);
int wtt_graph_new(void** graph);
int wtt_graph_register_generator(void* graph);
int wtt_graph_capture_begin(void* graph);
int wtt_graph_capture_end(void* graph);
int wtt_graph_replay(void* graph);
void wtt_graph_destroy(void* graph);
}

namespace {

constexpr int kCacheSlots = 448;  // n_text_ctx
constexpr int kWindowFrames = 3000;
// the loop state's fields (csrc/update_common.cuh LoopState)
enum { kNTokens = 0, kSampleBegin = 1, kStep = 2, kLive = 3 };
enum Mode { kGreedy = 0, kSample = 1, kBeam = 2 };

double now_s() {
  return std::chrono::duration<double>(std::chrono::steady_clock::now().time_since_epoch()).count();
}

[[noreturn]] void die(const std::string& msg) {
  fprintf(stderr, "wtt_transcribe: %s\n", msg.c_str());
  exit(1);
}

std::string read_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) die("cannot read " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

bool file_exists(const std::string& path) { return std::ifstream(path).good(); }

// ---- spec.txt (export.py _spec_txt) ----
struct TensorSpec {
  int scalar_type = 0;  // c10::ScalarType
  std::string dtype;
  std::vector<int64_t> dims;
};

struct GraphSpec {
  int n_params = 0;
  std::vector<TensorSpec> inputs, outputs;
};

GraphSpec parse_spec(const std::string& path) {
  std::ifstream f(path);
  if (!f) die("cannot read " + path);
  GraphSpec g;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    std::string kind;
    ss >> kind;
    if (kind == "n_params") {
      ss >> g.n_params;
    } else if (kind == "input" || kind == "output") {
      TensorSpec t;
      int64_t nbytes = 0;
      ss >> t.scalar_type >> t.dtype;
      if (kind == "output") ss >> nbytes;
      int ndim = 0;
      ss >> ndim;
      t.dims.resize((size_t)ndim);
      for (int i = 0; i < ndim; i++) ss >> t.dims[(size_t)i];
      (kind == "input" ? g.inputs : g.outputs).push_back(std::move(t));
    }
  }
  return g;
}

// ---- pipeline.txt (the JAX export's manifest; its sot_index and
// max_initial_ts_index are baked into the prefill graph and the penalties) ----
struct Pipeline {
  int n_mels = 128, sample_rate = 16000;
  int64_t n_vocab = 0, n_text_tokens = 0, eot = 0, timestamp_begin = 0;
  int sample_begin = 0, sample_len = 446, beam_size = 5;
  std::string tiktoken_file;
  std::vector<int32_t> initial_tokens;
};

Pipeline parse_pipeline(const std::string& path) {
  std::ifstream f(path);
  if (!f) die("cannot read " + path);
  Pipeline p;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    std::string key;
    ss >> key;
    if (key == "n_mels") ss >> p.n_mels;
    else if (key == "sample_rate") ss >> p.sample_rate;
    else if (key == "n_vocab") ss >> p.n_vocab;
    else if (key == "n_text_tokens") ss >> p.n_text_tokens;
    else if (key == "eot") ss >> p.eot;
    else if (key == "timestamp_begin") ss >> p.timestamp_begin;
    else if (key == "sample_begin") ss >> p.sample_begin;
    else if (key == "sample_len") ss >> p.sample_len;
    else if (key == "beam_size") ss >> p.beam_size;
    else if (key == "tiktoken") ss >> p.tiktoken_file;
    else if (key == "initial_tokens") {
      int32_t t;
      while (ss >> t) p.initial_tokens.push_back(t);
    }
  }
  if ((int)p.initial_tokens.size() != p.sample_begin) die("pipeline.txt: initial_tokens != sample_begin");
  return p;
}

// ---- loop.txt (export.loop_manifest): the done flag's lag in passes, then
// the phases a decode of sample_len runs through, in order, each with its
// cache window and its greedy and beam step packages; the last phase writes
// up to the whole cache ----
struct Phase {
  int window = 0;
  std::string greedy, beam;
};

struct Loop {
  int done_lag = -1;
  std::vector<Phase> phases;
};

Loop parse_loop(const std::string& path) {
  std::ifstream f(path);
  if (!f) die("cannot read " + path);
  Loop loop;
  std::string line;
  while (std::getline(f, line)) {
    std::istringstream ss(line);
    std::string key;
    ss >> key;
    if (key == "done_lag") ss >> loop.done_lag;
    else if (key == "phase") {
      Phase ph;
      ss >> ph.window >> ph.greedy >> ph.beam;
      int before = loop.phases.empty() ? 0 : loop.phases.back().window;
      if (!ss || ph.window <= before || ph.window > kCacheSlots) die(path + ": bad phase line: " + line);
      loop.phases.push_back(ph);
    }
  }
  if (loop.done_lag < 0 || loop.phases.empty()) die(path + ": no done_lag or no phase");
  return loop;
}

// ---- tiktoken ranks: "<base64 token bytes> <rank>" per line ----
std::vector<std::string> load_tiktoken(const std::string& path, int64_t n_text) {
  std::vector<std::string> table((size_t)n_text);
  int8_t inv[256];
  memset(inv, -1, sizeof(inv));
  const char* alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  for (int i = 0; i < 64; i++) inv[(uint8_t)alphabet[i]] = (int8_t)i;
  std::ifstream f(path);
  if (!f) die("cannot read " + path);
  std::string line;
  while (std::getline(f, line)) {
    size_t sp = line.find(' ');
    if (sp == std::string::npos) continue;
    long rank = strtol(line.c_str() + sp + 1, nullptr, 10);
    if (rank < 0 || rank >= n_text) continue;
    std::string bytes;
    uint32_t acc = 0;
    int nbits = 0;
    for (size_t i = 0; i < sp; i++) {
      int8_t v = inv[(uint8_t)line[i]];
      if (v < 0) continue;  // '=' padding
      acc = (acc << 6) | (uint32_t)v;
      nbits += 6;
      if (nbits >= 8) {
        nbits -= 8;
        bytes.push_back((char)((acc >> nbits) & 0xFF));
      }
    }
    table[(size_t)rank] = std::move(bytes);
  }
  return table;
}

// ---- text: Python's bytes.decode("utf-8", errors="replace"), str.strip() ----
void put_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back((char)cp);
  } else if (cp < 0x800) {
    out->push_back((char)(0xC0 | (cp >> 6)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back((char)(0xE0 | (cp >> 12)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    out->push_back((char)(0xF0 | (cp >> 18)));
    out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// Code points of UTF-8 bytes, each maximal invalid subpart replaced by one
// U+FFFD, as CPython's decoder does.
std::vector<uint32_t> decode_utf8(const std::string& s) {
  std::vector<uint32_t> cps;
  size_t i = 0, n = s.size();
  while (i < n) {
    uint8_t c = (uint8_t)s[i];
    if (c < 0x80) {
      cps.push_back(c);
      i++;
      continue;
    }
    int need;
    uint32_t cp;
    uint8_t lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) {
      need = 1, cp = c & 0x1F;
    } else if (c >= 0xE0 && c <= 0xEF) {
      need = 2, cp = c & 0x0F;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      need = 3, cp = c & 0x07;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
    } else {
      cps.push_back(0xFFFD);
      i++;
      continue;
    }
    size_t j = i + 1;
    int k = 0;
    for (; k < need && j < n; k++, j++) {
      uint8_t b = (uint8_t)s[j];
      if (b < lo || b > hi) break;
      cp = (cp << 6) | (b & 0x3F);
      lo = 0x80, hi = 0xBF;
    }
    cps.push_back(k == need ? cp : 0xFFFD);
    i = j;
  }
  return cps;
}

bool py_isspace(uint32_t c) {
  return (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x20) || c == 0x85 || c == 0xA0 ||
         c == 0x1680 || (c >= 0x2000 && c <= 0x200A) || c == 0x2028 || c == 0x2029 ||
         c == 0x202F || c == 0x205F || c == 0x3000;
}

std::string encode_utf8(const std::vector<uint32_t>& cps, size_t begin, size_t end) {
  std::string out;
  for (size_t i = begin; i < end; i++) put_utf8(cps[i], &out);
  return out;
}

// utils/helpers.compression_ratio of the decoding task's text: the window's
// text tokens decoded (invalid UTF-8 replaced) and stripped; 0 when empty
double compression_ratio(const std::vector<uint32_t>& cps) {
  size_t b = 0, e = cps.size();
  while (b < e && py_isspace(cps[b])) b++;
  while (e > b && py_isspace(cps[e - 1])) e--;
  std::string text = encode_utf8(cps, b, e);
  uLongf cap = compressBound((uLong)text.size());
  std::vector<Bytef> buf((size_t)cap);
  if (compress(buf.data(), &cap, (const Bytef*)text.data(), (uLong)text.size()) != Z_OK)
    die("zlib compress failed");
  return (double)text.size() / (double)cap;
}

// ---- graphs ----
at::ScalarType scalar_type(const TensorSpec& t) { return static_cast<at::ScalarType>(t.scalar_type); }

struct Graph {
  std::string name;
  GraphSpec spec;
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::vector<at::Tensor> params;  // the leading n_params inputs, on the card
};

// Upload a weight blob once, one CUDA tensor per leaf (shapes and types from
// the leading n_params input specs, which must account for every byte).
std::vector<at::Tensor> upload_params(const GraphSpec& spec, const std::string& blob_path) {
  std::string blob = read_file(blob_path);
  std::vector<at::Tensor> out;
  size_t off = 0;
  for (int i = 0; i < spec.n_params; i++) {
    const TensorSpec& t = spec.inputs[(size_t)i];
    at::Tensor host = at::empty(t.dims, at::TensorOptions().dtype(scalar_type(t)));
    size_t nbytes = (size_t)host.nbytes();
    if (off + nbytes > blob.size()) die("params blob too small for its spec: " + blob_path);
    memcpy(host.data_ptr(), blob.data() + off, nbytes);
    out.push_back(host.to(at::kCUDA));
    off += nbytes;
  }
  if (off != blob.size()) die("params blob larger than its spec: " + blob_path);
  return out;
}

void check_input(const Graph& g, size_t i, const at::Tensor& t) {
  const TensorSpec& s = g.spec.inputs[i];
  if (t.scalar_type() != scalar_type(s) || t.sizes().vec() != s.dims || !t.is_contiguous() ||
      !t.is_cuda())
    die(g.name + ": input " + std::to_string(i) + " is " + t.toString() +
        std::string(" ") + c10::str(t.sizes()) + ", the spec wants " + s.dtype + " " +
        c10::str(c10::IntArrayRef(s.dims)));
}

// What a window's decode did: scalar launches (step 0, counted at the
// call), loop-state launches (counted by the kernels on the card), replays
// of a captured body, uncaptured passes (--no-capture, capture warm-ups),
// captures and their host seconds, host reads of the done flag.
struct Counts {
  int64_t greedy_launches = 0, beam_launches = 0, greedy_state_launches = 0, beam_state_launches = 0;
  int64_t replays = 0, bodies = 0, captures = 0, done_reads = 0;
  double capture_s = 0.0;

  void add(const Counts& o, int sign = 1) {
    greedy_launches += sign * o.greedy_launches, beam_launches += sign * o.beam_launches;
    greedy_state_launches += sign * o.greedy_state_launches;
    beam_state_launches += sign * o.beam_state_launches;
    replays += sign * o.replays, bodies += sign * o.bodies, captures += sign * o.captures;
    done_reads += sign * o.done_reads, capture_s += sign * o.capture_s;
  }
};

// The static buffers of one step mode (greedy and sampling share G = 1;
// beam search has G = beam_size rows) that the loop body reads and writes
// (engine._Program), and the body's graphs by (mode, window). A graph
// replays at the buffers' addresses, so each window copies its inputs in.
struct Program {
  int G = 0, MC = 0;
  at::Tensor tokens, cache, sum_lp, pool_tokens, pool_scores, pool_lengths, pool_count;
  at::Tensor state;      // int32 [n_tokens, sample_begin, step, live]
  at::Tensor live_host;  // pinned: each pass's copy of live
  at::Tensor pos, last, src, identity, advance, t_scale, ck, cv;
  // the update's outputs (a replay writes the same addresses)
  at::Tensor tok_out, lp_out, new_tokens, src_out, new_lp;
  struct Captured {
    void* graph = nullptr;
    std::vector<at::Tensor> outputs;  // the packages' outputs in the graph's pool, kept with it
  };
  std::map<std::pair<int, int>, Captured> graphs;  // (mode, window)

  Program() = default;
  Program(const Program&) = delete;
  Program& operator=(const Program&) = delete;
  ~Program() {
    for (auto& kv : graphs) {
      kv.second.outputs.clear();
      wtt_graph_destroy(kv.second.graph);
    }
  }
};

struct Engine {
  std::string dir;
  Pipeline p;
  Loop loop;
  std::vector<std::string> vocab;
  std::map<std::string, Graph> graphs;
  std::map<std::string, std::vector<at::Tensor>> blobs;  // one upload per blob
  at::Tensor suppress_pen, begin_pen, first;
  void* stream = nullptr;  // the side stream every call and launch runs on
  std::unique_ptr<c10::Stream> side;
  std::vector<c10::Event> pass_events;  // one per pass in flight behind the done read
  bool capture = true;                  // --no-capture: the body runs uncaptured
  // the loop-state kernels count their launches on the card (greedy, beam),
  // read after each window
  at::Tensor state_counters;
  Counts totals;
  std::map<bool, std::unique_ptr<Program>> programs;  // by beam

  Graph& load(const std::string& name, const std::string& blob) {
    Graph& g = graphs[name];
    g.name = name;
    g.spec = parse_spec(dir + "/" + name + ".spec.txt");
    std::string pkg = dir + "/" + name + ".aoti.pt2";
    if (!file_exists(pkg))
      die("missing " + pkg + ": compile the pipeline (export_pipeline(..., compile=True))");
    double t0 = now_s();
    // single-threaded: a run takes no model from the container's pool and
    // waits on no event, so a CUDA graph can capture it
    g.loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(pkg, "model", true);
    fprintf(stderr, "[wtt] %s: loaded in %.2f s\n", name.c_str(), now_s() - t0);
    if (g.spec.n_params > 0) {
      auto it = blobs.find(blob);
      if (it == blobs.end()) it = blobs.emplace(blob, upload_params(g.spec, dir + "/" + blob)).first;
      if ((int)it->second.size() != g.spec.n_params) die(name + ": n_params differs from " + blob);
      for (int i = 0; i < g.spec.n_params; i++) {
        const at::Tensor& w = it->second[(size_t)i];
        check_input(g, (size_t)i, w);
      }
      g.params = it->second;
    }
    return g;
  }

  std::vector<at::Tensor> run(const std::string& name, const std::vector<at::Tensor>& rt) {
    Graph& g = graphs.at(name);
    std::vector<at::Tensor> args = g.params;
    args.insert(args.end(), rt.begin(), rt.end());
    if (args.size() != g.spec.inputs.size())
      die(name + ": " + std::to_string(args.size()) + " inputs, the spec has " +
          std::to_string(g.spec.inputs.size()));
    for (size_t i = (size_t)g.spec.n_params; i < args.size(); i++) check_input(g, i, args[i]);
    std::vector<at::Tensor> out = g.loader->run(args, stream);
    if (out.size() != g.spec.outputs.size()) die(name + ": output count differs from the spec");
    return out;
  }

  Program& program(bool beam);
};

at::Tensor read_f32(const std::string& path, int64_t n) {
  std::string raw = read_file(path);
  if ((int64_t)raw.size() != n * 4) die(path + ": expected " + std::to_string(n) + " float32");
  at::Tensor t = at::empty({n}, at::kFloat);
  memcpy(t.data_ptr(), raw.data(), raw.size());
  return t.to(at::kCUDA);
}

void check_graph(int rc, const char* what) {
  if (rc != 0) die(std::string(what) + " failed: " + wtt_graph_last_error());
}

void engine_init(Engine& e, const std::string& dir, bool load_beam) {
  if (!torch::cuda::is_available()) die("no CUDA device: the runner runs only on a card");
  e.dir = dir;
  e.p = parse_pipeline(dir + "/pipeline.txt");
  e.loop = parse_loop(dir + "/loop.txt");
  e.vocab = load_tiktoken(dir + "/" + e.p.tiktoken_file, e.p.n_text_tokens);
  check_graph(wtt_graph_side_stream(0, &e.stream), "making the side stream current");
  c10::Device dev(c10::DeviceType::CUDA, 0);
  e.side = std::make_unique<c10::Stream>(c10::impl::VirtualGuardImpl(c10::DeviceType::CUDA).getStream(dev));
  for (int i = 0; i <= e.loop.done_lag; i++) e.pass_events.emplace_back(c10::DeviceType::CUDA);
  e.load("encoder", "encoder.params.bin");
  int n_dec = e.load("cross_kv", "decoder.params.bin").spec.n_params;
  // an int8 export's prefill and steps read the quantized tree from its own blob
  std::string step_blob = parse_spec(dir + "/prefill.spec.txt").n_params == n_dec
                              ? "decoder.params.bin"
                              : "decoder_int8.params.bin";
  e.load("prefill", step_blob);
  e.load("filters", "");
  // the step packages of the loop's phases
  for (const Phase& ph : e.loop.phases) {
    e.load(ph.greedy, step_blob);
    if (load_beam) e.load(ph.beam, step_blob);
  }
  e.suppress_pen = read_f32(dir + "/suppress_pen.bin", e.p.n_vocab);
  e.begin_pen = read_f32(dir + "/begin_pen.bin", e.p.n_vocab);
  std::vector<int32_t> initial(kCacheSlots, 0);
  std::copy(e.p.initial_tokens.begin(), e.p.initial_tokens.end(), initial.begin());
  e.first = at::from_blob(initial.data(), {1, kCacheSlots}, at::kInt).to(at::kCUDA);
  e.state_counters = at::zeros({2}, at::TensorOptions().dtype(at::kLong).device(at::kCUDA));
}

// The buffers of a mode, made at its first use from the step package's
// spec (the cache's and cross-K/V's shapes and types).
Program& Engine::program(bool beam) {
  std::unique_ptr<Program>& slot = programs[beam];
  if (slot) return *slot;
  slot = std::make_unique<Program>();
  Program& q = *slot;
  const Phase& ph = loop.phases[0];  // every phase's step takes the same inputs
  const GraphSpec& spec = graphs.at(beam ? ph.beam : ph.greedy).spec;
  const std::vector<TensorSpec>& in = spec.inputs;
  size_t n = (size_t)spec.n_params;
  auto cuda = [](at::ScalarType t) { return at::TensorOptions().dtype(t).device(at::kCUDA); };
  auto zeros_of = [&](const TensorSpec& t) { return at::zeros(t.dims, cuda(scalar_type(t))); };
  q.G = beam ? p.beam_size : 1, q.MC = q.G;
  const int G = q.G;
  q.last = zeros_of(in[n]);     // (G,) the tokens the step embeds
  q.pos = zeros_of(in[n + 1]);  // 0-d: the slot it writes
  q.cache = zeros_of(in[n + 2]);
  q.ck = zeros_of(in[in.size() - 2]);
  q.cv = zeros_of(in[in.size() - 1]);
  q.tokens = at::zeros({G, kCacheSlots}, cuda(at::kInt));
  q.sum_lp = at::zeros({G}, cuda(at::kFloat));
  q.pool_tokens = at::zeros({1, q.MC, kCacheSlots + 1}, cuda(at::kInt));
  q.pool_scores = at::zeros({1, q.MC}, cuda(at::kFloat));
  q.pool_lengths = at::zeros({1, q.MC}, cuda(at::kInt));
  q.pool_count = at::zeros({1}, cuda(at::kInt));
  q.state = at::zeros({4}, cuda(at::kInt));
  q.live_host = at::zeros({1}, at::TensorOptions().dtype(at::kInt).pinned_memory(true));
  q.identity = at::arange(G, cuda(at::kInt));
  q.src = q.identity.clone();
  q.advance = at::tensor({1, 0, 1, 0}, at::kInt).to(at::kCUDA);  // + live: n_tokens and step
  q.t_scale = at::ones({1}, cuda(at::kFloat));
  q.tok_out = at::zeros({G}, cuda(at::kInt));
  q.lp_out = at::zeros({G}, cuda(at::kFloat));
  q.new_tokens = at::zeros_like(q.tokens);
  q.src_out = at::zeros({G}, cuda(at::kInt));
  q.new_lp = at::zeros({G}, cuda(at::kFloat));
  return q;
}

// ---- one window decode ----
struct WindowResult {
  std::vector<int32_t> seq;  // sampled tokens, eot excluded
  double sum_lp = 0.0, no_speech = 0.0;
  int steps = 0;
  Counts n;
  // host seconds: the whole decode, the waits for the done flag
  double seconds = 0.0, read_s = 0.0;
};

void check_rc(int rc, const char* what) {
  if (rc != 0) die(std::string(what) + " kernel launch failed: CUDA error " + std::to_string(rc));
}

unsigned long long* state_counter(Engine& e, int which) {
  return reinterpret_cast<unsigned long long*>(e.state_counters.data_ptr<int64_t>() + which);
}

// This window's inputs into the buffers (engine._Program.start): tokens,
// the prefill's K/V in every row, zeroed sums and pools, the loop state at
// step 0, the cross-K/V, 1/T.
void start(Engine& e, Program& q, const at::Tensor& kv, const at::Tensor& ck,
           const at::Tensor& cv, float temperature) {
  const int P = e.p.sample_begin, G = q.G;
  q.tokens.copy_(e.first.expand({G, kCacheSlots}));
  q.cache.zero_();
  q.cache.narrow(3, 0, P).copy_(kv.expand({kv.size(0), 2, G, P, kv.size(4)}));
  q.sum_lp.zero_();
  q.pool_tokens.zero_();
  q.pool_scores.fill_(-INFINITY);
  q.pool_lengths.zero_();
  q.pool_count.zero_();
  q.src.copy_(q.identity);
  q.state.copy_(at::tensor({P, P, 0, 1}, at::kInt));
  q.ck.copy_(ck);
  q.cv.copy_(cv);
  // the sampled logits are scaled by this device value, so one capture
  // serves every temperature of the ladder
  q.t_scale.fill_((double)(1.0f / std::max(temperature, 1e-6f)));
}

// GreedyDecoder.update's tail where live (engine._greedy_tail): rows that
// already ended stay at EOT, the log-probability adds up, the token goes to
// slot n_tokens. Returns the rows' done flags.
at::Tensor greedy_tail(Program& q, const at::Tensor& tok, const at::Tensor& lp, const at::Tensor& live,
                       int eot) {
  at::Tensor nt = q.state.narrow(0, kNTokens, 1).to(at::kLong).expand({q.G}).unsqueeze(1);
  at::Tensor already = q.tokens.gather(1, nt - 1).select(1, 0).eq(eot);
  q.sum_lp.copy_(at::where(live, q.sum_lp + at::where(already, 0.0, lp), q.sum_lp));
  at::Tensor next = at::where(already, eot, tok);
  next = at::where(live, next, q.tokens.gather(1, nt).select(1, 0));
  q.tokens.scatter_(1, nt, next.unsqueeze(1));
  return next.eq(eot);
}

// The update on `logits`, the writes where live, the loop state's advance
// and the pinned live flag (engine._update). first_n >= 0: step 0, the
// kernels' scalar launches at that length; -1: their loop-state launches.
void update(Engine& e, Program& q, Mode mode, const at::Tensor& logits, int first_n,
            std::vector<at::Tensor>* outputs, WindowResult* res) {
  const Pipeline& p = e.p;
  const int G = q.G, V = (int)p.n_vocab, eot = (int)p.eot, ts = (int)p.timestamp_begin;
  const int P = p.sample_begin;
  at::Tensor live = q.state.narrow(0, kLive, 1).ne(0);
  const float* sup = e.suppress_pen.data_ptr<float>();
  const float* beg = e.begin_pen.data_ptr<float>();
  at::Tensor done;
  if (mode == kBeam) {
    int* pools[] = {q.pool_tokens.data_ptr<int>(), q.pool_lengths.data_ptr<int>(),
                    q.pool_count.data_ptr<int>()};
    if (first_n >= 0) {
      check_rc(wtt_beam_update(logits.data_ptr<float>(), q.tokens.data_ptr<int>(), q.sum_lp.data_ptr<float>(),
                               pools[0], q.pool_scores.data_ptr<float>(), pools[1], pools[2], sup, beg,
                               q.new_tokens.data_ptr<int>(), q.src_out.data_ptr<int>(),
                               q.new_lp.data_ptr<float>(), 1, G, V, kCacheSlots, q.MC, first_n, P,
                               0, 1, eot, ts, e.stream),
               "beam_update");
      res->n.beam_launches++;
    } else {
      check_rc(wtt_beam_update_state(logits.data_ptr<float>(), q.tokens.data_ptr<int>(),
                                     q.sum_lp.data_ptr<float>(), pools[0], q.pool_scores.data_ptr<float>(),
                                     pools[1], pools[2], sup, beg, q.state.data_ptr<int>(),
                                     state_counter(e, 1), q.new_tokens.data_ptr<int>(),
                                     q.src_out.data_ptr<int>(), q.new_lp.data_ptr<float>(), 1, G, V,
                                     kCacheSlots, q.MC, 1, eot, ts, e.stream),
               "beam_update_state");
    }
    q.tokens.copy_(at::where(live.unsqueeze(1), q.new_tokens, q.tokens));
    q.src.copy_(at::where(live, q.src_out, q.identity));
    q.sum_lp.copy_(at::where(live, q.new_lp, q.sum_lp));
    done = q.pool_count.ge(q.MC);
  } else {
    at::Tensor tok = q.tok_out, lp = q.lp_out;
    if (mode == kGreedy && first_n >= 0) {
      check_rc(wtt_greedy_argmax(logits.data_ptr<float>(), q.tokens.data_ptr<int>(), sup, beg,
                                 q.tok_out.data_ptr<int>(), q.lp_out.data_ptr<float>(), G, V,
                                 kCacheSlots, first_n, P, 1, eot, ts, e.stream),
               "greedy_argmax");
      res->n.greedy_launches++;
    } else if (mode == kGreedy) {
      check_rc(wtt_greedy_argmax_state(logits.data_ptr<float>(), q.tokens.data_ptr<int>(),
                                       q.state.data_ptr<int>(), sup, beg, q.tok_out.data_ptr<int>(),
                                       q.lp_out.data_ptr<float>(), state_counter(e, 0), G, V,
                                       kCacheSlots, 1, eot, ts, e.stream),
               "greedy_argmax_state");
    } else {
      // the filters package at n_tokens = a view of the state, then the
      // engine's draw (torch.multinomial's: argmax of probs over Exp(1)
      // noise) from the default generator, without host-side checks
      at::Tensor filtered = e.run("filters", {logits, q.tokens, q.state.narrow(0, kNTokens, 1),
                                              e.suppress_pen, e.begin_pen})[0];
      outputs->push_back(filtered);
      at::Tensor probs = at::softmax(filtered * q.t_scale, -1);
      at::Generator gen = at::globalContext().defaultGenerator(at::Device(at::kCUDA, 0));
      at::Tensor noise = at::empty_like(probs).exponential_(1, gen);
      tok = (probs / noise).argmax(-1).to(at::kInt);
      lp = at::log_softmax(filtered, -1).gather(1, tok.unsqueeze(1).to(at::kLong)).select(1, 0);
    }
    done = greedy_tail(q, tok, lp, live, eot);
  }
  // one more token where live; live stays while some row is not done
  at::Tensor live_now = q.state.narrow(0, kLive, 1);
  q.state.add_(q.advance * live_now);
  live_now.mul_(done.all().logical_not().to(at::kInt));
  q.live_host.copy_(live_now, /*non_blocking=*/true);
}

// One pass of the loop body in a phase (engine._step + _update): pos =
// n_tokens - 1 and the last tokens from the state, the phase's step
// package, the update at the loop state.
void body(Engine& e, Program& q, Mode mode, const Phase& ph, std::vector<at::Tensor>* outputs,
          WindowResult* res) {
  q.pos.copy_(q.state.select(0, kNTokens) - 1);
  q.last.copy_(q.tokens.gather(1, q.pos.to(at::kLong).reshape({1, 1}).expand({q.G, 1})).select(1, 0));
  std::vector<at::Tensor> in = {q.last, q.pos, q.cache};
  if (mode == kBeam) in.push_back(q.src);
  in.push_back(q.ck);
  in.push_back(q.cv);
  at::Tensor logits = e.run(mode == kBeam ? ph.beam : ph.greedy, in)[0];
  outputs->push_back(logits);
  update(e, q, mode, logits, -1, outputs, res);
}

// The body's graph of (mode, phase window), captured at first use (engine
// FusedEngine._capture): a warm-up on the side stream at live = 0, which
// writes nothing but slot n_tokens - 1's K/V (the next pass rewrites it) and
// applies the pending beam reorder (src is the identity after it), runs each
// package once before the capture; then the loop state, the pinned flag and
// the generator are put back.
void* body_graph(Engine& e, Program& q, Mode mode, const Phase& ph, WindowResult* res) {
  auto key = std::make_pair((int)mode, ph.window);
  auto it = q.graphs.find(key);
  if (it != q.graphs.end()) return it->second.graph;
  double t0 = now_s();
  at::Tensor saved = q.state.clone();
  at::Generator gen = at::globalContext().defaultGenerator(at::Device(at::kCUDA, 0));
  at::Tensor gen_state;
  if (mode == kSample) {
    std::lock_guard<std::mutex> lock(gen.mutex());
    gen_state = gen.get_state();
  }
  q.state.narrow(0, kLive, 1).fill_(0);
  Program::Captured& c = q.graphs[key];
  try {  // nothing falls back to the uncaptured body, --serve included
    std::vector<at::Tensor> warm;
    body(e, q, mode, ph, &warm, res);
    res->n.bodies++;
    check_graph(wtt_graph_new(&c.graph), "creating a CUDA graph");
    if (mode == kSample) check_graph(wtt_graph_register_generator(c.graph), "registering the generator");
    check_graph(wtt_graph_capture_begin(c.graph), "beginning the loop body's capture");
    body(e, q, mode, ph, &c.outputs, res);
    check_graph(wtt_graph_capture_end(c.graph), "capturing the loop body");
  } catch (const std::exception& ex) {
    die(std::string("capturing the loop body failed: ") + ex.what());
  }
  q.state.copy_(saved);
  // the warm-up's flag (0) would reach the host's next read of an earlier
  // pass's flag: put back the live flag it replaced
  q.live_host.copy_(saved.narrow(0, kLive, 1));
  if (mode == kSample) {
    std::lock_guard<std::mutex> lock(gen.mutex());
    gen.set_state(gen_state);
  }
  res->n.captures++;
  res->n.capture_s += now_s() - t0;
  return c.graph;
}

// FusedEngine.run for one audio: greedy (G = 1) or beam search over G =
// beam_size rows; at T > 0 the filters package and the engine's draw.
// Prefill and step 0 run eagerly; then the body once per token, phase by
// phase, replayed from its graph (or uncaptured with --no-capture).
WindowResult decode_window(Engine& e, bool use_beam, const at::Tensor& ck, const at::Tensor& cv,
                           float temperature, int32_t seed) {
  const Pipeline& p = e.p;
  const Mode mode = use_beam ? kBeam : temperature > 0 ? kSample : kGreedy;
  const int P = p.sample_begin, V = (int)p.n_vocab, eot = (int)p.eot;
  WindowResult res;
  double t0 = now_s();
  Program& q = e.program(use_beam);
  const int G = q.G;
  std::vector<at::Tensor> pre = e.run("prefill", {e.first.narrow(1, 0, P).contiguous(), ck, cv});
  start(e, q, pre[2], ck, cv, temperature);
  if (mode == kSample) {
    // the engine's torch.Generator(device).manual_seed(seed): seed set,
    // Philox offset 0; a replay reads and advances the generator's state
    at::Generator gen = at::globalContext().defaultGenerator(at::Device(at::kCUDA, 0));
    std::lock_guard<std::mutex> lock(gen.mutex());
    gen.set_current_seed((uint64_t)seed);
  }
  std::vector<at::Tensor> step0;
  update(e, q, mode, pre[0].expand({G, V}).contiguous(), P, &step0, &res);

  const std::vector<Phase>& phases = e.loop.phases;
  const int lag = e.loop.done_lag;
  int n = P + 1, step = 1, pending = 0;
  bool done = false;
  for (size_t i = 0; i < phases.size() && !done; i++) {
    // a phase writes the slots below its window; the last up to the whole cache
    const int limit = i + 1 < phases.size() ? phases[i].window : kCacheSlots;
    if (!(step < p.sample_len && n < limit)) continue;
    void* graph = e.capture ? body_graph(e, q, mode, phases[i], &res) : nullptr;
    while (step < p.sample_len && n < limit) {
      if (graph) {
        check_graph(wtt_graph_replay(graph), "replaying the loop body");
        res.n.replays++;
      } else {
        std::vector<at::Tensor> outputs;
        body(e, q, mode, phases[i], &outputs, &res);
        res.n.bodies++;
      }
      n++, step++;
      // the done flag as the pass `lag` back left it, after its event
      e.pass_events[(size_t)(pending % (lag + 1))].record(*e.side);
      if (pending++ < lag) continue;
      double t_read = now_s();
      e.pass_events[(size_t)((pending - 1 - lag) % (lag + 1))].synchronize();
      done = q.live_host.data_ptr<int32_t>()[0] == 0;
      res.read_s += now_s() - t_read;
      res.n.done_reads++;
      if (done) break;
    }
  }

  const int n_final = q.state.select(0, kNTokens).item<int>();
  res.steps = n_final - P;
  res.no_speech = pre[1].item<float>();
  at::Tensor counters = e.state_counters.cpu();
  res.n.greedy_state_launches = counters.data_ptr<int64_t>()[0] - e.totals.greedy_state_launches;
  res.n.beam_state_launches = counters.data_ptr<int64_t>()[1] - e.totals.beam_state_launches;
  e.totals.add(res.n);
  at::Tensor htoks = q.tokens.cpu(), hlp = q.sum_lp.cpu();
  const int32_t* tk = htoks.data_ptr<int32_t>();
  const float* lp = hlp.data_ptr<float>();
  if (!use_beam) {
    res.sum_lp = lp[0];
    for (int i = P; i < n_final && tk[i] != eot; i++) res.seq.push_back(tk[i]);
  } else {
    // FusedEngine's finalize + MaximumLikelihoodRanker (wtpu_transcribe.cpp):
    // finished candidates topped up with live beams by sum_logprob, ranked
    // by score / length (length_penalty None)
    at::Tensor ftok = q.pool_tokens.cpu(), fscore = q.pool_scores.cpu(), flen = q.pool_lengths.cpu();
    int fcount = std::min(q.pool_count.item<int>(), q.MC);
    struct Cand {
      std::vector<int32_t> seq;
      double score;
    };
    std::vector<Cand> cands;
    for (int i = 0; i < fcount; i++) {
      Cand c;
      const int32_t* row = ftok.data_ptr<int32_t>() + (size_t)i * (kCacheSlots + 1);
      for (int j = P; j < flen.data_ptr<int32_t>()[i] - 1; j++) c.seq.push_back(row[j]);
      c.score = fscore.data_ptr<float>()[i];
      cands.push_back(std::move(c));
    }
    std::vector<int> order((size_t)G);
    for (int b = 0; b < G; b++) order[(size_t)b] = b;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) { return lp[a] > lp[b]; });
    for (int b : order) {
      if ((int)cands.size() >= G) break;
      Cand c;
      for (int j = P; j < n_final; j++) c.seq.push_back(tk[(size_t)b * kCacheSlots + j]);
      c.score = lp[b];
      cands.push_back(std::move(c));
    }
    size_t best = 0;
    double best_score = -1e30;
    for (size_t i = 0; i < cands.size(); i++) {
      double len = cands[i].seq.empty() ? 1.0 : (double)cands[i].seq.size();
      if (cands[i].score / len > best_score) best_score = cands[i].score / len, best = i;
    }
    res.seq = cands[best].seq;
    res.sum_lp = cands[best].score;
  }
  res.seconds = now_s() - t0;
  return res;
}

std::string json_escape(const std::string& s) {
  std::string o;
  for (unsigned char c : s) {
    if (c == '"' || c == '\\') {
      o += '\\';
      o += (char)c;
    } else if (c == '\n') {
      o += "\\n";
    } else if (c < 0x20) {
      char b[8];
      snprintf(b, sizeof(b), "\\u%04x", c);
      o += b;
    } else {
      o += (char)c;
    }
  }
  return o;
}

std::string json_ints(const std::vector<int32_t>& v) {
  std::string s = "[";
  for (size_t i = 0; i < v.size(); i++) s += (i ? "," : "") + std::to_string(v[i]);
  return s + "]";
}

// Transcribe one file with the temperature ladder and quality gates
// (transcribe.py: compression ratio > 2.4 or avg logprob < -1.0 retry at the
// next temperature; a window with no-speech probability > 0.6 and avg
// logprob < -1.0 is skipped). The next window starts at the last timestamp,
// or 3000 frames on without one. Returns false with *err on failure.
bool transcribe_file(Engine& e, const std::string& audio_path, bool beam, int max_windows,
                     bool print_tokens, bool no_fallback, std::string* text_out,
                     std::vector<int32_t>* tokens_out, std::string* err) {
  const Pipeline& p = e.p;
  float* samples = nullptr;
  int64_t n_samples = 0;
  if (audioio_decode(audio_path.c_str(), p.sample_rate, &samples, &n_samples)) {
    *err = std::string("audio decode failed: ") + audioio_last_error();
    return false;
  }
  float* mel = nullptr;
  int64_t n_frames = 0;
  if (audioio_log_mel(samples, n_samples, p.n_mels, 480000, &mel, &n_frames)) {
    audioio_free(samples);
    *err = std::string("log-mel failed: ") + audioio_last_error();
    return false;
  }
  audioio_free(samples);
  at::Tensor host_mel = at::from_blob(mel, {p.n_mels, n_frames}, at::kFloat).clone();
  audioio_free(mel);
  const int64_t content_frames = n_frames - kWindowFrames;

  static const float kTemps[] = {0.0f, 0.2f, 0.4f, 0.6f, 0.8f, 1.0f};
  const double kCompressionThreshold = 2.4, kLogprobThreshold = -1.0, kNoSpeechThreshold = 0.6;
  std::string text;
  int64_t seek = 0;
  int n_windows = 0;
  const Counts before = e.totals;
  double t_loop = now_s();
  while (seek < content_frames && n_windows < max_windows) {
    at::Tensor window =
        host_mel.narrow(1, seek, kWindowFrames).unsqueeze(0).contiguous().to(at::kCUDA);
    at::Tensor xa = e.run("encoder", {window})[0];
    std::vector<at::Tensor> kv = e.run("cross_kv", {xa});
    WindowResult res;
    double avg_lp = 0.0;
    std::string wtext;
    size_t n_temps = no_fallback ? 1 : sizeof(kTemps) / sizeof(kTemps[0]);
    bool skipped = false;
    for (size_t ti = 0; ti < n_temps; ti++) {
      float temp = kTemps[ti];
      int32_t seed = temp > 0 ? (int32_t)(n_windows * 6 + (int)ti) : 0;
      res = decode_window(e, beam && temp == 0.0f, kv[0], kv[1], temp, seed);
      std::string raw;
      for (int32_t tok : res.seq)
        if (tok < (int32_t)p.n_text_tokens) raw += e.vocab[(size_t)tok];
      std::vector<uint32_t> cps = decode_utf8(raw);
      wtext = encode_utf8(cps, 0, cps.size());
      double ratio = compression_ratio(cps);
      avg_lp = res.sum_lp / (double)(res.seq.size() + 1);
      bool needs_fallback = ratio > kCompressionThreshold || avg_lp < kLogprobThreshold;
      skipped = res.no_speech > kNoSpeechThreshold && avg_lp < kLogprobThreshold;
      if (skipped) needs_fallback = false;  // silence: accepted, then skipped below
      bool accepted = !needs_fallback || ti + 1 == n_temps;
      double per = 1e3 / (res.steps ? res.steps : 1);
      fprintf(stderr,
              "[wtt] {\"window\": %d, \"seek\": %lld, \"temperature\": %.1f, \"seed\": %d, "
              "\"beam\": %s, \"accepted\": %s, \"skipped\": %s, \"tokens\": %zu, \"steps\": %d, "
              "\"avg_logprob\": %.6f, \"no_speech_prob\": %.6f, \"compression_ratio\": %.6f, "
              "\"loop\": \"%s\", \"decode_ms\": %.3f, \"ms_per_token\": %.4f, "
              "\"read_ms_per_token\": %.4f, \"replays\": %lld, \"bodies\": %lld, "
              "\"captures\": %lld, \"capture_s\": %.4f, \"done_reads\": %lld, "
              "\"greedy_launches\": %lld, \"beam_launches\": %lld, "
              "\"greedy_state_launches\": %lld, \"beam_state_launches\": %lld%s%s}\n",
              n_windows, (long long)seek, temp, seed, beam && temp == 0.0f ? "true" : "false",
              accepted ? "true" : "false", accepted && skipped ? "true" : "false", res.seq.size(),
              res.steps, avg_lp, res.no_speech, ratio, e.capture ? "captured" : "body",
              res.seconds * 1e3, res.seconds * per, res.read_s * per, (long long)res.n.replays,
              (long long)res.n.bodies, (long long)res.n.captures, res.n.capture_s,
              (long long)res.n.done_reads, (long long)res.n.greedy_launches,
              (long long)res.n.beam_launches, (long long)res.n.greedy_state_launches,
              (long long)res.n.beam_state_launches,
              print_tokens ? ", \"token_ids\": " : "", print_tokens ? json_ints(res.seq).c_str() : "");
      if (accepted) break;
    }
    if (skipped) {
      seek += kWindowFrames;
      n_windows++;
      continue;
    }
    int64_t last_ts = -1;
    for (int32_t t : res.seq) {
      if (t >= (int32_t)p.timestamp_begin) last_ts = t - (int64_t)p.timestamp_begin;
      if (tokens_out) tokens_out->push_back(t);
    }
    text += wtext;
    seek += (last_ts > 0) ? last_ts * 2 : kWindowFrames;  // a timestamp unit is 2 mel frames
    n_windows++;
  }
  double loop_s = now_s() - t_loop;
  Counts file = e.totals;  // this file's counts
  file.add(before, -1);
  fprintf(stderr,
          "[wtt] {\"file\": \"%s\", \"windows\": %d, \"seconds\": %.3f, \"audio_s\": %.3f, "
          "\"greedy_launches\": %lld, \"beam_launches\": %lld, \"greedy_state_launches\": %lld, "
          "\"beam_state_launches\": %lld, \"replays\": %lld, \"bodies\": %lld, \"captures\": %lld, "
          "\"capture_s\": %.4f, \"done_reads\": %lld}\n",
          json_escape(audio_path).c_str(), n_windows, loop_s, (double)n_samples / p.sample_rate,
          (long long)file.greedy_launches, (long long)file.beam_launches,
          (long long)file.greedy_state_launches, (long long)file.beam_state_launches,
          (long long)file.replays, (long long)file.bodies, (long long)file.captures, file.capture_s,
          (long long)file.done_reads);
  *text_out = text;
  return true;
}

// Serve mode (wtpu_transcribe.cpp's protocol): one request line per
// connection, "<audio_path> [beam]\n"; the reply is one JSON line
// {"text": ..., "tokens": [...]} or {"error": ...}; "shutdown" ends the loop.
int serve(Engine& e, const std::string& sock_path) {
  unlink(sock_path.c_str());
  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) die("socket() failed");
  sockaddr_un addr;
  memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  if (sock_path.size() >= sizeof(addr.sun_path)) die("socket path too long: " + sock_path);
  strncpy(addr.sun_path, sock_path.c_str(), sizeof(addr.sun_path) - 1);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0) die("bind() failed on " + sock_path);
  if (listen(fd, 8) != 0) die("listen() failed");
  fprintf(stderr, "[wtt] serving on %s\n", sock_path.c_str());
  for (;;) {
    int c = accept(fd, nullptr, nullptr);
    if (c < 0) continue;
    std::string req;
    char buf[512];
    ssize_t n;
    while ((n = read(c, buf, sizeof(buf))) > 0) {
      req.append(buf, (size_t)n);
      if (req.find('\n') != std::string::npos) break;
    }
    size_t nl = req.find('\n');
    if (nl != std::string::npos) req.resize(nl);
    while (!req.empty() && (req.back() == '\r' || req.back() == ' ')) req.pop_back();
    if (req == "shutdown") {
      std::string resp = "{\"ok\": true}\n";
      (void)!write(c, resp.data(), resp.size());
      close(c);
      break;
    }
    bool beam = false;
    size_t sp = req.rfind(' ');
    if (sp != std::string::npos && req.substr(sp + 1) == "beam") beam = true, req.resize(sp);
    std::string text, err, resp;
    std::vector<int32_t> toks;
    bool ok = false;
    try {
      ok = transcribe_file(e, req, beam, 1 << 30, false, false, &text, &toks, &err);
    } catch (const std::exception& ex) {
      err = ex.what();
    }
    if (ok)
      resp = "{\"text\": \"" + json_escape(text) + "\", \"tokens\": " + json_ints(toks) + "}\n";
    else
      resp = "{\"error\": \"" + json_escape(err) + "\"}\n";
    (void)!write(c, resp.data(), resp.size());
    close(c);
  }
  close(fd);
  unlink(sock_path.c_str());
  return 0;
}

int run_main(int argc, char** argv) {
  std::string dir, audio_path, serve_path;
  int max_windows = 1 << 30;
  bool print_tokens = false, beam = false, no_fallback = false, no_capture = false;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--max-windows" && i + 1 < argc) max_windows = atoi(argv[++i]);
    else if (a == "--tokens") print_tokens = true;
    else if (a == "--beam") beam = true;
    else if (a == "--serve" && i + 1 < argc) serve_path = argv[++i];
    else if (a == "--no-fallback") no_fallback = true;  // pin T = 0 (parity checks)
    else if (a == "--no-capture") no_capture = true;    // the loop body uncaptured
    else if (dir.empty()) dir = a;
    else audio_path = a;
  }
  if (dir.empty() || (audio_path.empty() && serve_path.empty()))
    die("usage: wtt_transcribe <pipeline_dir> <audio> [--max-windows N] [--tokens] [--beam] "
        "[--no-fallback] [--no-capture] | <pipeline_dir> --serve SOCK [--no-capture]");
  c10::InferenceMode guard;
  // float32 products and convolutions in full float32 (the port's parity
  // rule); a bf16 pipeline is unaffected
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  Engine e;
  e.capture = !no_capture;
  engine_init(e, dir, /*load_beam=*/beam || !serve_path.empty());
  if (!serve_path.empty()) return serve(e, serve_path);
  std::string text, err;
  if (!transcribe_file(e, audio_path, beam, max_windows, print_tokens, no_fallback, &text, nullptr,
                       &err))
    die(err);
  printf("%s\n", text.c_str());
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  try {
    return run_main(argc, argv);
  } catch (const std::exception& ex) {
    die(std::string("error: ") + ex.what());
  }
}
