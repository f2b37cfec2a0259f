// wtt_transcribe: native end-to-end transcription on the card, with no
// Python in the loop (the counterpart of runtime/wtpu_transcribe.cpp and
// runtime/pjrt_runner.cpp; libtorch takes the place of the PJRT C API).
//
// It reads a directory written by whisper_tpu_torch.export.export_pipeline:
//
//   encoder / cross_kv / prefill / step_greedy / step_beam / filters
//       .aoti.pt2 (AOTInductor packages) + .spec.txt (I/O manifest)
//   encoder.params.bin, decoder.params.bin (decoder_int8.params.bin)
//   suppress_pen.bin / begin_pen.bin, <vocab>.tiktoken, pipeline.txt
//
// and runs audio decode -> log-mel (runtime/audioio.cpp) -> encoder ->
// cross-K/V -> prefill -> per token: the fixed-shape step graph, then the
// hand-written update kernel (wtt_greedy_argmax at T = 0, wtt_beam_update
// with --beam) through its C ABI on PyTorch's current stream, or at T > 0 the
// filters graph and the engine's draw in ATen -> ranking -> detokenization,
// with the temperature ladder and the quality gates of the JAX binary.
// Weights are uploaded to the card once, checked against the spec, and one
// copy of the decoder serves every decoder graph; xa, the cross-K/V and the
// KV cache are CUDA tensors the runner owns. The step graph writes the cache
// in place. The done flag is read once a step, as the port's engine reads it.
//
// Usage:
//   wtt_transcribe <pipeline_dir> <audio> [--max-windows N] [--tokens]
//       [--beam] [--no-fallback]
//   wtt_transcribe <pipeline_dir> --serve SOCK
//
// The transcript goes to stdout; per-window lines ("[wtt] {json}") go to
// stderr, with the update launches the runner made and its ms per token.
// Build: whisper_tpu_torch.runtime.build.build_runner().

#include <ATen/ATen.h>
#include <c10/core/InferenceMode.h>
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
// libtorch_cuda: PyTorch's current stream of a device (AOTInductor's C shim)
int32_t aoti_torch_get_current_cuda_stream(int32_t device_index, void** ret_stream);
}

namespace {

constexpr int kCacheSlots = 448;  // n_text_ctx
constexpr int kWindowFrames = 3000;

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

struct Engine {
  std::string dir;
  Pipeline p;
  std::vector<std::string> vocab;
  std::map<std::string, Graph> graphs;
  std::map<std::string, std::vector<at::Tensor>> blobs;  // one upload per blob
  at::Tensor suppress_pen, begin_pen;
  void* stream = nullptr;
  int64_t greedy_launches = 0, beam_launches = 0;

  Graph& load(const std::string& name, const std::string& blob) {
    Graph& g = graphs[name];
    g.name = name;
    g.spec = parse_spec(dir + "/" + name + ".spec.txt");
    std::string pkg = dir + "/" + name + ".aoti.pt2";
    if (!file_exists(pkg))
      die("missing " + pkg + ": compile the pipeline (export_pipeline(..., compile=True))");
    double t0 = now_s();
    g.loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(pkg);
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
};

at::Tensor read_f32(const std::string& path, int64_t n) {
  std::string raw = read_file(path);
  if ((int64_t)raw.size() != n * 4) die(path + ": expected " + std::to_string(n) + " float32");
  at::Tensor t = at::empty({n}, at::kFloat);
  memcpy(t.data_ptr(), raw.data(), raw.size());
  return t.to(at::kCUDA);
}

void engine_init(Engine& e, const std::string& dir, bool load_beam) {
  if (!torch::cuda::is_available()) die("no CUDA device: the runner runs only on a card");
  e.dir = dir;
  e.p = parse_pipeline(dir + "/pipeline.txt");
  e.vocab = load_tiktoken(dir + "/" + e.p.tiktoken_file, e.p.n_text_tokens);
  if (aoti_torch_get_current_cuda_stream(0, &e.stream) != 0) die("cannot read the current CUDA stream");
  e.load("encoder", "encoder.params.bin");
  int n_dec = e.load("cross_kv", "decoder.params.bin").spec.n_params;
  // an int8 export's prefill and steps read the quantized tree from its own blob
  std::string step_blob = parse_spec(dir + "/prefill.spec.txt").n_params == n_dec
                              ? "decoder.params.bin"
                              : "decoder_int8.params.bin";
  e.load("prefill", step_blob);
  e.load("step_greedy", step_blob);
  e.load("filters", "");
  if (load_beam) e.load("step_beam", step_blob);
  e.suppress_pen = read_f32(dir + "/suppress_pen.bin", e.p.n_vocab);
  e.begin_pen = read_f32(dir + "/begin_pen.bin", e.p.n_vocab);
}

// ---- one window decode ----
struct WindowResult {
  std::vector<int32_t> seq;  // sampled tokens, eot excluded
  double sum_lp = 0.0, no_speech = 0.0;
  int steps = 0;
  int64_t greedy_launches = 0, beam_launches = 0;
  // host seconds: the whole decode, and per token the step graph's call,
  // the update (kernel or filters and draw), and the read of the done flag
  double seconds = 0.0, graph_s = 0.0, update_s = 0.0, read_s = 0.0;
};

void check_rc(int rc, const char* what) {
  if (rc != 0) die(std::string(what) + " kernel launch failed: CUDA error " + std::to_string(rc));
}

// FusedEngine.run for one audio: greedy (G = 1) or beam search over G =
// beam_size rows; at T > 0 the filters graph and the engine's draw.
WindowResult decode_window(Engine& e, bool use_beam, const at::Tensor& ck, const at::Tensor& cv,
                           float temperature, int32_t seed) {
  const Pipeline& p = e.p;
  const int G = use_beam ? p.beam_size : 1, MC = use_beam ? p.beam_size : 1;
  const int P = p.sample_begin, V = (int)p.n_vocab, eot = (int)p.eot;
  const int ts = (int)p.timestamp_begin;
  auto cuda_i32 = at::TensorOptions().dtype(at::kInt).device(at::kCUDA);
  auto cuda_f32 = at::TensorOptions().dtype(at::kFloat).device(at::kCUDA);
  double t0 = now_s();

  std::vector<int32_t> initial(kCacheSlots, 0);
  std::copy(p.initial_tokens.begin(), p.initial_tokens.end(), initial.begin());
  at::Tensor first = at::from_blob(initial.data(), {1, kCacheSlots}, at::kInt).to(at::kCUDA);
  std::vector<at::Tensor> pre = e.run("prefill", {first.narrow(1, 0, P).contiguous(), ck, cv});
  at::Tensor logits = pre[0].expand({G, V}).contiguous();
  at::Tensor kv = pre[2];  // (L, 2, 1, P, d)
  at::Tensor cache = at::zeros({kv.size(0), 2, G, kCacheSlots, kv.size(4)}, kv.options());
  cache.narrow(3, 0, P).copy_(kv.expand({kv.size(0), 2, G, P, kv.size(4)}));
  at::Tensor toks = first.expand({G, kCacheSlots}).contiguous();
  at::Tensor sum_lp = at::zeros({G}, cuda_f32);
  at::Tensor pool_tokens = at::zeros({1, MC, kCacheSlots + 1}, cuda_i32);
  at::Tensor pool_scores = at::full({1, MC}, -INFINITY, cuda_f32);
  at::Tensor pool_lengths = at::zeros({1, MC}, cuda_i32);
  at::Tensor pool_count = at::zeros({1}, cuda_i32);
  at::Tensor pos = at::zeros({}, cuda_i32);
  at::Tensor src;
  at::Generator gen;
  if (!use_beam && temperature > 0) {
    // the engine's torch.Generator(device).manual_seed(seed): seed set,
    // Philox offset 0
    gen = at::globalContext().defaultGenerator(at::Device(at::kCUDA, 0));
    std::lock_guard<std::mutex> lock(gen.mutex());
    gen.set_current_seed((uint64_t)seed);
  }

  WindowResult res;
  int n = P, step = 0;
  for (;;) {
    double t_step = now_s();
    if (step > 0) {
      at::Tensor last = toks.select(1, n - 1).clone();  // a fresh, aligned (G,) buffer
      pos.fill_(n - 1);
      logits = use_beam ? e.run("step_beam", {last, pos, cache, src, ck, cv})[0]
                        : e.run("step_greedy", {last, pos, cache, ck, cv})[0];
    }
    double t_update = now_s();
    res.graph_s += t_update - t_step;
    at::Tensor done;
    if (use_beam) {
      at::Tensor new_toks = at::empty_like(toks), new_src = at::empty({G}, cuda_i32);
      at::Tensor new_lp = at::empty({G}, cuda_f32);
      check_rc(wtt_beam_update(logits.data_ptr<float>(), toks.data_ptr<int>(), sum_lp.data_ptr<float>(),
                               pool_tokens.data_ptr<int>(), pool_scores.data_ptr<float>(),
                               pool_lengths.data_ptr<int>(), pool_count.data_ptr<int>(),
                               e.suppress_pen.data_ptr<float>(), e.begin_pen.data_ptr<float>(),
                               new_toks.data_ptr<int>(), new_src.data_ptr<int>(),
                               new_lp.data_ptr<float>(), 1, G, V, kCacheSlots, MC, n, P, step, 1,
                               eot, ts, e.stream),
               "beam_update");
      res.beam_launches++;
      toks = new_toks, src = new_src, sum_lp = new_lp;
      done = pool_count.ge(MC);
    } else {
      at::Tensor next, current;
      if (temperature == 0) {
        next = at::empty({1}, cuda_i32), current = at::empty({1}, cuda_f32);
        check_rc(wtt_greedy_argmax(logits.data_ptr<float>(), toks.data_ptr<int>(),
                                   e.suppress_pen.data_ptr<float>(), e.begin_pen.data_ptr<float>(),
                                   next.data_ptr<int>(), current.data_ptr<float>(), 1, V,
                                   kCacheSlots, n, P, 1, eot, ts, e.stream),
                 "greedy_argmax");
        res.greedy_launches++;
      } else {
        at::Tensor filtered = e.run("filters", {logits, toks, at::full({1}, n, cuda_i32),
                                                e.suppress_pen, e.begin_pen})[0];
        at::Tensor probs = at::softmax(filtered / (double)temperature, -1);
        next = at::multinomial(probs, 1, false, gen).select(1, 0).to(at::kInt);
        current = at::log_softmax(filtered, -1).gather(1, next.unsqueeze(1).to(at::kLong)).select(1, 0);
      }
      // GreedyDecoder.update's tail: rows that already ended stay at EOT
      at::Tensor already = toks.select(1, n - 1).eq(eot);
      sum_lp = sum_lp + at::where(already, 0.0, current);
      next = at::where(already, eot, next);
      toks.select(1, n).copy_(next);
      done = next.eq(eot);
    }
    n++, step++;
    double t_read = now_s();
    res.update_s += t_read - t_update;
    bool finished = done.all().item<bool>();
    res.read_s += now_s() - t_read;
    if (finished || step >= p.sample_len || n >= kCacheSlots) break;
  }
  e.greedy_launches += res.greedy_launches;
  e.beam_launches += res.beam_launches;
  res.steps = step;
  res.no_speech = pre[1].item<float>();
  at::Tensor htoks = toks.cpu(), hlp = sum_lp.cpu();
  const int32_t* tk = htoks.data_ptr<int32_t>();
  const float* lp = hlp.data_ptr<float>();
  if (!use_beam) {
    res.sum_lp = lp[0];
    for (int i = P; i < n && tk[i] != eot; i++) res.seq.push_back(tk[i]);
  } else {
    // FusedEngine's finalize + MaximumLikelihoodRanker (wtpu_transcribe.cpp):
    // finished candidates topped up with live beams by sum_logprob, ranked
    // by score / length (length_penalty None)
    at::Tensor ftok = pool_tokens.cpu(), fscore = pool_scores.cpu(), flen = pool_lengths.cpu();
    int fcount = std::min(pool_count.item<int>(), MC);
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
      for (int j = P; j < n; j++) c.seq.push_back(tk[(size_t)b * kCacheSlots + j]);
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
  const int64_t greedy0 = e.greedy_launches, beam0 = e.beam_launches;
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
              "\"decode_ms\": %.3f, \"ms_per_token\": %.4f, \"graph_ms_per_token\": %.4f, "
              "\"update_ms_per_token\": %.4f, \"read_ms_per_token\": %.4f, "
              "\"greedy_launches\": %lld, \"beam_launches\": %lld%s%s}\n",
              n_windows, (long long)seek, temp, seed, beam && temp == 0.0f ? "true" : "false",
              accepted ? "true" : "false", accepted && skipped ? "true" : "false", res.seq.size(),
              res.steps, avg_lp, res.no_speech, ratio, res.seconds * 1e3, res.seconds * per,
              res.graph_s * per, res.update_s * per, res.read_s * per,
              (long long)res.greedy_launches, (long long)res.beam_launches,
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
  fprintf(stderr,
          "[wtt] {\"file\": \"%s\", \"windows\": %d, \"seconds\": %.3f, \"audio_s\": %.3f, "
          "\"greedy_launches\": %lld, \"beam_launches\": %lld}\n",
          json_escape(audio_path).c_str(), n_windows, loop_s, (double)n_samples / p.sample_rate,
          (long long)(e.greedy_launches - greedy0), (long long)(e.beam_launches - beam0));
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
  bool print_tokens = false, beam = false, no_fallback = false;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--max-windows" && i + 1 < argc) max_windows = atoi(argv[++i]);
    else if (a == "--tokens") print_tokens = true;
    else if (a == "--beam") beam = true;
    else if (a == "--serve" && i + 1 < argc) serve_path = argv[++i];
    else if (a == "--no-fallback") no_fallback = true;  // pin T = 0 (parity checks)
    else if (dir.empty()) dir = a;
    else audio_path = a;
  }
  if (dir.empty() || (audio_path.empty() && serve_path.empty()))
    die("usage: wtt_transcribe <pipeline_dir> <audio> [--max-windows N] [--tokens] [--beam] "
        "[--no-fallback] | <pipeline_dir> --serve SOCK");
  c10::InferenceMode guard;
  // float32 products and convolutions in full float32 (the port's parity
  // rule); a bf16 pipeline is unaffected
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  Engine e;
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
