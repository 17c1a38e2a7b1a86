// K8, the kernel-bundle launcher: a generic 1-D map over `count` items,
// for sm_90a. Replaces wgpu_3dgs_core_tpu/ops/kernel_bundle.py::
// KernelBundle._build_dispatch (pl.pallas_call at kernel_bundle.py:172).
//
// What it computes: item i of every resource is the row i of a row-major
// [count, width] array; the bundle's per-item __device__ function gets a
// pointer to item i's row of each resource (in resource-group order), then
// a pointer to item i's row of each output, and writes the outputs. The
// TPU version hands a Pallas body [block, F] tiles and zero-pads the tail
// block; here a thread runs an item and nothing runs past `count`, which
// gives a map the same outputs without the padding copy.
//
// What bounds it on the card: memory, for the maps a bundle runs (casts,
// unpacking, elementwise arithmetic): every resource byte read once and
// every output byte written once.
//
// Design (tiled_map): a thread reading its own row would put a warp's
// accesses a row apart (a 45-float SH row: 32 sectors per access, each
// used for 4 bytes), so rows go through shared memory in tiles of `tile`
// items, a multiple of 16 so that a tile of any row width is whole
// 16-byte words. A block takes one tile: one thread brings its resource
// rows in by Hopper's bulk async copy (cp.async.bulk, completed on an
// mbarrier), the block runs the items on shared rows, and one thread
// sends each output tile out by a bulk store. The overlap of one tile's
// copies with another's items comes from the blocks an SM holds at once
// (four, at the host's tile of at most 52 KB): a persistent grid whose
// blocks walked their tiles through two to four stages was measured
// slower on the card, for both the unpack and map_add (PERF.md).
// Narrow rows take the same tiles, so a map of 4-byte items moves whole
// tiles, not 4 bytes a thread. A resource whose base is not 16-byte
// aligned, and the ragged last tile, go through the block instead
// (cp.async in, plain stores out). The host chooses the tile per
// signature from the row bytes (ops/kernel_bundle.py::tile_plan); a row
// too wide for 16 items in shared memory takes the direct kernel, one
// thread per item on global rows.
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

// Shared bytes of a tile of `items` items: each array's tile rounded up
// to 16.
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

// ------------------------------------------ Hopper's bulk async copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Orders this thread's shared-memory accesses with the async proxy's
// (the bulk copies'), both ways.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// A resource's tile into shared memory by one bulk copy, counted on `bar`;
// an output's tile out by one bulk store. The other direction does
// nothing. Both ends 16-byte aligned, n a multiple of 16.
template <typename T>
__device__ __forceinline__ void bulk_in(const Rows<T>& r, unsigned char* tile,
                                        long long first, long long n,
                                        uint64_t* bar) {
  if constexpr (std::is_const<T>::value) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(tile)),
        "l"(r.row(first)), "r"(static_cast<uint32_t>(n)), "r"(smem_u32(bar))
        : "memory");
  }
}
template <typename T>
__device__ __forceinline__ void bulk_out(const Rows<T>& r,
                                         const unsigned char* tile,
                                         long long first, long long n) {
  if constexpr (!std::is_const<T>::value) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            r.row(first)),
        "r"(smem_u32(tile)), "r"(static_cast<uint32_t>(n))
        : "memory");
  }
}

template <typename T>
__host__ __device__ __forceinline__ long long in_bytes(const Rows<T>& r,
                                                       int items) {
  return std::is_const<T>::value ? r.row_bytes() * items : 0;
}

// ------------------------------------------------ the tiled map

// One block per tile of `tile` items: the resources' rows in, the items
// run on shared rows, the outputs' rows out. A full tile whose arrays all
// start 16-byte aligned moves by bulk copies, issued by one thread (in,
// completed on an mbarrier; out, waited on before the block exits); the
// ragged last tile and unaligned arrays go through the block (cp.async
// in, plain stores out).
template <typename Fn, typename... R, size_t... I>
__device__ __forceinline__ void tiled_map(int count, int tile,
                                          std::index_sequence<I...>,
                                          R... rows) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  unsigned char* smem = tile_smem;
  constexpr int kArrays = sizeof...(R);
  const long long first = static_cast<long long>(blockIdx.x) * tile;
  const int items =
      static_cast<int>(min(static_cast<long long>(tile), count - first));
  const long long bytes[kArrays] = {rows.row_bytes() * items...};
  const long long tile_bytes[kArrays] = {rows.row_bytes() * tile...};
  long long off[kArrays];
  long long at = 0;
  for (int k = 0; k < kArrays; ++k) {
    off[k] = at;
    at += round16(tile_bytes[k]);
  }
  // A tile's offset in its array is a multiple of 16 bytes (tile is a
  // multiple of 16 items), so the bases decide whether the ends align.
  const bool bulk =
      items == tile &&
      ((0 | ... | reinterpret_cast<uintptr_t>(rows.base)) & 15) == 0;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + at);
  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      fence_proxy_async();
      mbar_expect_tx(bar, static_cast<uint32_t>((0LL + ... +
                                                 in_bytes(rows, tile))));
      (bulk_in(rows, smem + off[I], first, bytes[I], bar), ...);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    mbar_wait(bar, 0);
  } else {
    (stage_in(rows, smem + off[I], first, bytes[I]), ...);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    Fn()((reinterpret_cast<typename R::elem*>(smem + off[I]) +
          i * rows.width)...);
  }
  if (bulk) fence_proxy_async();  // the outputs, for the bulk store
  __syncthreads();
  if (bulk) {
    if (threadIdx.x == 0) {
      (bulk_out(rows, smem + off[I], first, bytes[I]), ...);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    }
  } else {
    (stage_out(rows, smem + off[I], first, bytes[I]), ...);
  }
}

template <typename Fn, typename... R>
__global__ void bundle_tiled_kernel(int count, int tile, R... rows) {
  tiled_map<Fn>(count, tile, std::index_sequence_for<R...>{}, rows...);
}

constexpr int kMaxDevices = 64;
constexpr long long kDefaultSharedBytes = 48 * 1024;
constexpr long long kBarrierBytes = 8;  // the tile's mbarrier

// Per device and per kernel: the opt-in shared-memory limit and the
// dynamic shared memory the kernel's attribute was raised to. The state
// must belong to one kernel: the generated source puts its functor in an
// unnamed namespace, so each instantiation and its static are internal
// to the bundle's library (a static of an instantiation with external
// linkage is one object across every library loaded in the process, and
// the libraries' functors share one name).
struct LaunchState {
  std::atomic<int> limit{0};         // 0: not asked yet
  std::atomic<long long> raised{0};  // 0: the default
};

// Raise `kernel`'s dynamic shared memory attribute to `smem` where it is
// above the default and above what it was raised to. `fits` says whether
// `smem` is within the device's opt-in limit.
template <typename K>
inline cudaError_t allow_smem(LaunchState& st, K kernel, int device,
                              long long smem, bool* fits) {
  int limit = st.limit.load();
  if (limit == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    st.limit = limit;
  }
  *fits = smem <= limit;
  if (*fits && smem > kDefaultSharedBytes && smem > st.raised.load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    st.raised = smem;
  }
  return cudaSuccess;
}

inline cudaError_t current_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  return *device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// Launch the map on `stream` (count > 0; the wrapper launches nothing for
// no items) and return the launch's CUDA error code: the tiled kernel, a
// block of `block` threads per tile of `tile` items (a multiple of 16),
// or the direct kernel in blocks of `block` where `tile` is 0.
template <typename Fn, typename... R>
inline int launch_map(int count, int block, int tile, void* stream,
                      R... rows) {
  static LaunchState state[kMaxDevices];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile > 0) {
    if (tile % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = staged_bytes(tile, rows...) + kBarrierBytes;
    int device = 0;
    cudaError_t err = current_device(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    bool fits = false;
    err = allow_smem(state[device], bundle_tiled_kernel<Fn, R...>, device,
                     smem, &fits);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!fits) return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = (static_cast<long long>(count) + tile - 1) / tile;
    bundle_tiled_kernel<Fn, R...>
        <<<static_cast<unsigned>(grid), block, static_cast<size_t>(smem), s>>>(
            count, tile, rows...);
    return static_cast<int>(cudaGetLastError());
  }
  const int grid = (count + block - 1) / block;
  bundle_map_kernel<Fn, R...><<<grid, block, 0, s>>>(count, rows...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gs
