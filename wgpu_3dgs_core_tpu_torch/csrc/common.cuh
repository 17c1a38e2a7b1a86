// Shared helpers of the port's CUDA kernels (compiled for sm_90a).
#pragma once

#include <cuda_runtime.h>

#define GS_EXPORT extern "C" __attribute__((visibility("default")))

// Segment table rows (int32 [GS_TAB_ROWS, n], row-major): row i of the
// table owns output slots [off[i], off[i] + cnt[i]). Must match
// ops/expand.py (TAB_OFF .. TAB_GID).
#define GS_TAB_OFF 0
#define GS_TAB_CNT 1
#define GS_TAB_SPAN 2
#define GS_TAB_X0 3
#define GS_TAB_Y0 4
#define GS_TAB_GID 5
#define GS_TAB_ROWS 6

// Owner of output slot `slot` in a table with nondecreasing offsets: the
// last row whose offset is <= slot (an upper-bound binary search, the
// device form of torch.searchsorted(off, slot, right=True) - 1). Rows with
// zero count share their successor's offset and are skipped by it.
__device__ __forceinline__ int gs_owner(const int* __restrict__ off, int n,
                                        int slot) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(off + mid) <= slot) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo - 1;
}

// First index in the ascending a[0, n) whose value is >= v (the device
// form of torch.searchsorted(a, v)).
__device__ __forceinline__ int gs_lower_bound(const int* __restrict__ a,
                                              int n, int v) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}
