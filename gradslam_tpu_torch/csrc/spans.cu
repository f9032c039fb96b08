// Span marks: one empty kernel for each end of each device span of
// utils/profiling.py, named after it (gs_span_begin_<span>, gs_span_end_<span>,
// a dot of the span's name written "__"). A mark reads and writes nothing;
// launched on a stream, it shows in a device trace between the kernels
// launched before and after it, and launched while a CUDA graph is captured
// it becomes a node of the graph, which every replay runs in capture order.
//
// GS_SPANS lists the spans in profiling.DEVICE_SPANS's order, each followed
// by its ".backward" span; a mark's id is its index in kMarks, which is the
// index of its name in profiling.MARKS.

#include <cuda_runtime.h>

#define GS_SPANS(X)                                                        \
  X(init_state) X(init_state__backward)                                    \
  X(odometry) X(odometry__backward)                                        \
  X(odometry__targets) X(odometry__targets__backward)                      \
  X(mapping) X(mapping__backward)                                          \
  X(carry) X(carry__backward)                                              \
  X(loop_closure) X(loop_closure__backward)                                \
  X(loop_closure__verify) X(loop_closure__verify__backward)                \
  X(loop_closure__pose_graph) X(loop_closure__pose_graph__backward)

#define GS_DEFINE(n)                                 \
  extern "C" __global__ void gs_span_begin_##n() {}  \
  extern "C" __global__ void gs_span_end_##n() {}

GS_SPANS(GS_DEFINE)

#define GS_ENTRY(n) reinterpret_cast<const void*>(&gs_span_begin_##n), \
                    reinterpret_cast<const void*>(&gs_span_end_##n),

namespace {
const void* const kMarks[] = {GS_SPANS(GS_ENTRY)};
constexpr int kCount = static_cast<int>(sizeof(kMarks) / sizeof(kMarks[0]));
}  // namespace

// The number of marks, which the wrapper checks against its table.
extern "C" int gst_span_marks() { return kCount; }

// One launch of mark `id` (one block of one thread) on `stream`; returns its
// cudaError_t.
extern "C" int gst_span_mark(int id, void* stream) {
  if (id < 0 || id >= kCount) return static_cast<int>(cudaErrorInvalidValue);
  void* args[1] = {nullptr};
  return static_cast<int>(cudaLaunchKernel(kMarks[id], dim3(1), dim3(1), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
