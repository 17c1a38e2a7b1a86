// K8, the kernel-bundle launcher: a generic 1-D map over `count` items,
// for sm_90a. Replaces wgpu_3dgs_core_tpu/ops/kernel_bundle.py::
// KernelBundle._build_dispatch (pl.pallas_call at kernel_bundle.py:172).
//
// What it computes: item i of every resource is the row i of a row-major
// [count, width] array; the bundle's per-item __device__ function gets a
// pointer to item i's row of each resource (in resource-group order), then
// a pointer to item i's row of each output, and writes the outputs. The
// TPU version hands a Pallas body [block, F] tiles and zero-pads the tail
// block; here one thread runs one item and threads at or past `count` run
// nothing, which gives a map the same outputs without the padding copy.
//
// What bounds it on the card: memory, for the maps a bundle runs (casts,
// unpacking, elementwise arithmetic): every resource byte read once and
// every output byte written once. One thread per item, blocks of the
// bundle's block_size (the reference's workgroup_size), grid
// ceil(count / block_size). Where some row is wider than 4 bytes, a
// thread reading or writing its own row would put a warp's accesses a
// row apart (a 45-float SH row: 32 sectors per access, each used for 4
// bytes); so the block stages its rows through shared memory instead: it
// copies each resource's [block, width] tile in with asynchronous 16-byte
// copies (cp.async), every
// thread runs its item on the shared rows, and the block copies each
// output tile out the same way. Rows of at most 4 bytes, and tiles too
// large for shared memory, take the direct kernel.
//
// ops/kernel_bundle.py generates one small .cu per bundle signature: the
// layout's feature macros, `#include`s of gaussian.cuh and this header,
// the bundle's constants as constexpr values, the user's __device__
// function, a functor calling it, and one extern "C" entry that calls
// gs::launch_map and returns the launch's CUDA error.
#pragma once

#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>
#include <utility>

#include "common.cuh"

GS_EXPORT const char* gs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace gs {

// One resource (T const) or output: its base pointer and its row width in
// elements.
template <typename T>
struct Rows {
  using elem = T;
  T* base;
  long long width;
  __host__ __device__ __forceinline__ T* row(long long i) const {
    return base + i * width;
  }
  __host__ __device__ __forceinline__ long long row_bytes() const {
    return width * static_cast<long long>(sizeof(T));
  }
};

// The direct map: one thread per item; items at or past `count` are
// masked.
template <typename Fn, typename... R>
__global__ void bundle_map_kernel(int count, R... rows) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  Fn()(rows.row(i)...);
}

// n bytes between global and shared memory, by the whole block: 16-byte
// words where both ends and n allow, else 4-byte words, else bytes.
__device__ __forceinline__ void block_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           long long n) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(dst) |
                          reinterpret_cast<uintptr_t>(src) |
                          static_cast<uintptr_t>(n);
  if ((align & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long k = threadIdx.x; k < n / 16; k += blockDim.x) d[k] = s[k];
  } else if ((align & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    for (long long k = threadIdx.x; k < n / 4; k += blockDim.x) d[k] = s[k];
  } else {
    for (long long k = threadIdx.x; k < n; k += blockDim.x) dst[k] = src[k];
  }
}

__host__ __device__ __forceinline__ long long round16(long long n) {
  return (n + 15) & ~15LL;
}

// Shared bytes of a block of `items` items: each tile rounded up to 16.
template <typename... R>
__host__ __device__ inline long long staged_bytes(int items, R... rows) {
  return (0LL + ... + round16(rows.row_bytes() * items));
}

// A resource's tile (its element type is const) in, an output's tile out;
// the other direction does nothing. The copy in issues its 16-byte words
// as asynchronous copies (cp.async), so a thread keeps all of them in
// flight; the caller waits for them (__pipeline_wait_prior).
template <typename T>
__device__ __forceinline__ void stage_in(const Rows<T>& r, unsigned char* tile,
                                         long long first, long long n) {
  if constexpr (std::is_const<T>::value) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(r.row(first));
    if (((reinterpret_cast<uintptr_t>(tile) |
          reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(n)) &
         15) == 0) {
      for (long long k = threadIdx.x; k < n / 16; k += blockDim.x) {
        __pipeline_memcpy_async(tile + 16 * k, src + 16 * k, 16);
      }
    } else {
      block_copy(tile, src, n);
    }
  }
}
template <typename T>
__device__ __forceinline__ void stage_out(const Rows<T>& r,
                                          const unsigned char* tile,
                                          long long first, long long n) {
  if constexpr (!std::is_const<T>::value) {
    block_copy(reinterpret_cast<unsigned char*>(r.row(first)), tile, n);
  }
}

template <typename Fn, typename... R, size_t... I>
__device__ __forceinline__ void staged_map(int count,
                                           std::index_sequence<I...>,
                                           R... rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTiles = sizeof...(R);
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x;
  const int items =
      static_cast<int>(min(static_cast<long long>(blockDim.x), count - first));
  const long long bytes[kTiles] = {rows.row_bytes() * items...};
  long long off[kTiles];
  long long at = 0;
  for (int k = 0; k < kTiles; ++k) {
    off[k] = at;
    at += round16(bytes[k]);
  }
  (stage_in(rows, smem + off[I], first, bytes[I]), ...);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (threadIdx.x < items) {
    Fn()((reinterpret_cast<typename R::elem*>(smem + off[I]) +
          threadIdx.x * rows.width)...);
  }
  __syncthreads();
  (stage_out(rows, smem + off[I], first, bytes[I]), ...);
}

template <typename Fn, typename... R>
__global__ void bundle_staged_kernel(int count, R... rows) {
  staged_map<Fn>(count, std::index_sequence_for<R...>{}, rows...);
}

constexpr int kMaxDevices = 64;
constexpr long long kDefaultSharedBytes = 48 * 1024;

// Whether the staged kernel may take `smem` bytes of shared memory on the
// current device (its opt-in maximum), raising the kernel's dynamic
// shared memory attribute to `smem` where it is above the default. Per
// device, the limit is asked once and the attribute set only when a
// launch needs more than it was last raised to. The state must belong to
// one kernel: the generated source puts its functor in an unnamed
// namespace, so this instantiation and its static are internal to the
// bundle's library (a static of an instantiation with external linkage
// is one object across every library loaded in the process, and the
// libraries' functors share one name).
template <typename Fn, typename... R>
inline cudaError_t staged_fits(long long smem, bool* fits) {
  struct State {
    std::atomic<int> limit;      // 0: not asked yet
    std::atomic<long long> raised;  // 0: the default
  };
  static State state[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  State& st = state[device];
  int limit = st.limit.load();
  if (limit == 0) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    st.limit = limit;
  }
  *fits = smem <= limit;
  if (*fits && smem > kDefaultSharedBytes && smem > st.raised.load()) {
    auto kernel = bundle_staged_kernel<Fn, R...>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    st.raised = smem;
  }
  return cudaSuccess;
}

// Launch the map on `stream` (count > 0; the wrapper launches nothing for
// no items) and return the launch's CUDA error code.
template <typename Fn, typename... R>
inline int launch_map(int count, int block, void* stream, R... rows) {
  const int grid = (count + block - 1) / block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((false || ... || (rows.row_bytes() > 4))) {
    const long long smem = staged_bytes(block, rows...);
    bool fits = false;
    const cudaError_t err = staged_fits<Fn, R...>(smem, &fits);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fits) {
      bundle_staged_kernel<Fn, R...>
          <<<grid, block, static_cast<size_t>(smem), s>>>(count, rows...);
      return static_cast<int>(cudaGetLastError());
    }
  }
  bundle_map_kernel<Fn, R...><<<grid, block, 0, s>>>(count, rows...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gs
