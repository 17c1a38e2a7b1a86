// K11, the live-bound launch probe, for sm_90a.
//
// Replaces tools/probe_dyngrid.py::run (pl.pallas_call at
// probe_dyngrid.py:20), which asks whether a Pallas TPU grid can be sized
// by a count traced on the device. The same question on the card: how is a
// grid bounded by a count that lives in device memory (here an int32 of
// live blocks), the shape of K1, K2 and K7's `total`? The body is the
// probe's: out = x + 1 over blocks of `block_elems` f32 (the TPU probe's
// [8, 128] blocks are 1024; the rasterizer's tiles 256). Three forms:
//
//   capacity       a grid over every capacity block; blocks at or past the
//                  live count return at once (the form K1, K2, K7 use);
//   readback       the host reads the count (one sync), then launches a
//                  grid of the live blocks;
//   device_launch  a one-thread parent kernel reads the count and launches
//                  the child grid from the device (dynamic parallelism:
//                  this file is compiled with -rdc=true and linked with
//                  cudadevrt, into a library of its own).
//
// Every form writes only the live prefix; the rest of `out` is untouched.
// What bounds it: memory, 4 B read and 4 B written per live element.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_child_kernel(const float* __restrict__ x, float* __restrict__ out,
                   const int* __restrict__ live_blocks, int block_elems) {
  if (static_cast<int>(blockIdx.x) >= __ldg(live_blocks)) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * block_elems;
  for (int e = threadIdx.x; e < block_elems; e += kThreads) {
    out[base + e] = __ldg(x + base + e) + 1.0f;
  }
}

__global__ void probe_parent_kernel(const float* __restrict__ x,
                                    float* __restrict__ out,
                                    const int* __restrict__ live_blocks,
                                    int cap_blocks, int block_elems) {
  const int blocks = min(*live_blocks, cap_blocks);
  if (blocks > 0) {
    probe_child_kernel<<<blocks, kThreads>>>(x, out, live_blocks,
                                             block_elems);
  }
}

}  // namespace

GS_EXPORT const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: f32 [cap_blocks * block_elems]; live_blocks: int32 on the device
// (blocks past cap_blocks do not exist). cap_blocks > 0.
GS_EXPORT int gs_probe_capacity(const float* x, float* out,
                                const int* live_blocks, int cap_blocks,
                                int block_elems, void* stream) {
  probe_child_kernel<<<cap_blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, out, live_blocks, block_elems);
  return static_cast<int>(cudaGetLastError());
}

// As above, with the live count read on the host: a grid of `blocks` (> 0,
// the value of *live_blocks).
GS_EXPORT int gs_probe_readback(const float* x, float* out,
                                const int* live_blocks, int blocks,
                                int block_elems, void* stream) {
  probe_child_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      x, out, live_blocks, block_elems);
  return static_cast<int>(cudaGetLastError());
}

// As gs_probe_capacity, the child grid launched from the device.
GS_EXPORT int gs_probe_device_launch(const float* x, float* out,
                                     const int* live_blocks, int cap_blocks,
                                     int block_elems, void* stream) {
  probe_parent_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, live_blocks, cap_blocks, block_elems);
  return static_cast<int>(cudaGetLastError());
}
