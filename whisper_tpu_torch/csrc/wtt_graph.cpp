// wtt_graph: the CUDA graphs of the native runner's decode loop, behind a
// small C ABI that csrc/wtt_transcribe.cpp declares by hand (the runner
// includes no CUDA header, so its source compiles on a machine without the
// toolkit). It wraps at::cuda::CUDAGraph and c10::cuda's streams, as
// torch.cuda.CUDAGraph and torch.cuda.Stream do for engine.FusedEngine.
//
//   wtt_graph_side_stream   a stream of PyTorch's pool made the current
//                           stream (no graph is captured on the legacy
//                           default stream); the runner runs everything on it
//   wtt_graph_new           an empty graph
//   wtt_graph_register_generator
//                           the default CUDA generator's state registered, so
//                           a replay draws from its seed and offset of the
//                           moment and advances the offset as eager calls do
//   wtt_graph_capture_begin / _end
//                           capture the current stream (thread-local mode),
//                           allocations into one memory pool that every graph
//                           of the process shares
//   wtt_graph_replay, wtt_graph_destroy
//
// Each returns 0, or 1 with the exception's text in wtt_graph_last_error().
// Build: runtime/build.py compiles this unit with the CUDA toolkit's headers
// beside the runner.

#include <ATen/ATen.h>
#include <ATen/cuda/CUDAGeneratorImpl.h>
#include <ATen/cuda/CUDAGraph.h>
#include <c10/cuda/CUDAStream.h>

#include <exception>
#include <string>

namespace {

std::string g_error;
bool g_have_pool = false;
decltype(at::cuda::graph_pool_handle()) g_pool;  // the memory pool every graph shares

template <typename F>
int guarded(F&& f) {
  try {
    f();
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
  } catch (...) {
    g_error = "unknown exception";
  }
  return 1;
}

at::cuda::CUDAGraph* as_graph(void* graph) { return static_cast<at::cuda::CUDAGraph*>(graph); }

}  // namespace

extern "C" {

const char* wtt_graph_last_error() { return g_error.c_str(); }

int wtt_graph_side_stream(int device, void** stream) {
  return guarded([&] {
    c10::cuda::CUDAStream s = c10::cuda::getStreamFromPool(/*isHighPriority=*/false,
                                                           (c10::DeviceIndex)device);
    c10::cuda::setCurrentCUDAStream(s);
    *stream = (void*)s.stream();
  });
}

int wtt_graph_new(void** graph) {
  return guarded([&] { *graph = new at::cuda::CUDAGraph(); });
}

int wtt_graph_register_generator(void* graph) {
  return guarded([&] { as_graph(graph)->register_generator_state(at::cuda::detail::getDefaultCUDAGenerator()); });
}

int wtt_graph_capture_begin(void* graph) {
  return guarded([&] {
    if (!g_have_pool) {
      g_pool = at::cuda::graph_pool_handle();
      g_have_pool = true;
    }
    as_graph(graph)->capture_begin(g_pool, cudaStreamCaptureModeThreadLocal);
  });
}

int wtt_graph_capture_end(void* graph) {
  return guarded([&] { as_graph(graph)->capture_end(); });
}

int wtt_graph_replay(void* graph) {
  return guarded([&] { as_graph(graph)->replay(); });
}

void wtt_graph_destroy(void* graph) { delete as_graph(graph); }

}  // extern "C"
