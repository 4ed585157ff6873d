// Device marks of the program's spans: one empty kernel per span name of
// `avsync_torch/train/lipnet_trainer.SPAN_MARKS`, in that order (a mark's
// id is its index in this list, which `utils/profiling.mark_ids` reads;
// tests/test_torch_spans.py keeps the two lists equal).
//
// A CUDA graph replays kernels and runs no host code, so a host range
// opened around a captured step is not around its replayed kernels. A mark
// is a kernel: a graph captured around it keeps it, in stream order between
// the layers it separates, and a profiler trace names it
// `avs_mark__<span>` (`.` of the span's name as `_`). Each mark opens a
// span on its stream that lasts until the next mark.
//
// One block of one thread that does nothing: about a microsecond of device
// time in a graph, a launch on the host in an eager step.

#include <cuda_runtime.h>

#define AVS_SPAN_MARKS(X) \
  X(gather)               \
  X(conv1_fwd)            \
  X(conv2_fwd)            \
  X(conv3_fwd)            \
  X(gru1_fwd)             \
  X(gru2_fwd)             \
  X(gru3_fwd)             \
  X(gru4_fwd)             \
  X(lstm1_fwd)            \
  X(lstm2_fwd)            \
  X(lstm3_fwd)            \
  X(lstm4_fwd)            \
  X(head_ctc_fwd)         \
  X(conv1_bwd)            \
  X(conv2_bwd)            \
  X(conv3_bwd)            \
  X(gru1_bwd)             \
  X(gru2_bwd)             \
  X(gru3_bwd)             \
  X(gru4_bwd)             \
  X(lstm1_bwd)            \
  X(lstm2_bwd)            \
  X(lstm3_bwd)            \
  X(lstm4_bwd)            \
  X(head_ctc_bwd)         \
  X(reduce)               \
  X(update)               \
  X(tail)

#define AVS_DEFINE_MARK(name) \
  extern "C" __global__ void avs_mark__##name() {}
AVS_SPAN_MARKS(AVS_DEFINE_MARK)
#undef AVS_DEFINE_MARK

namespace {

#define AVS_MARK_ENTRY(name) reinterpret_cast<const void*>(&avs_mark__##name),
const void* const kMarks[] = {AVS_SPAN_MARKS(AVS_MARK_ENTRY)};
#undef AVS_MARK_ENTRY
constexpr int kNumMarks = static_cast<int>(sizeof(kMarks) / sizeof(kMarks[0]));

}  // namespace

extern "C" int avs_span_mark_count() { return kNumMarks; }

// Launch mark `id` on `stream` of `device`.
extern "C" int avs_span_mark(int id, int device, void* stream) {
  if (id < 0 || id >= kNumMarks) return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* no_args[] = {nullptr};
  e = cudaLaunchKernel(kMarks[id], dim3(1), dim3(1), no_args, 0,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
