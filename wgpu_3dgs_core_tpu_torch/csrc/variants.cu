// The measurement kernels of the rasterizer (K9) and of the segment sums
// (K10), for sm_90a.
//
// K9 replaces tools/bench_kernel_variants.py::run_variant (pl.pallas_call
//    at bench_kernel_variants.py:239, level bodies in _mk_kernel): K3
//    stripped one ingredient per level, timed over K3's arguments, so the
//    step from one level to the next prices that ingredient. Its levels
//    are instantiations of K3's own body (csrc/rasterize_fwd.cuh, where
//    they are listed): v0_stage, v1_cull, v2_q, v3_alpha, v4_trans,
//    v5_color, v6_full (K3 itself, compiled from the same source) and
//    v7_notrans. The TPU tool's v3_alpha_mxu, v4/v5_cumsum,
//    v6_full_mxuacc and v9_nosum price MXU matmuls and lane-tree sums
//    that K3 does not do: no level here.
//
// K10 replaces tools/bench_segsum.py::run_variant (pl.pallas_call at
//    bench_segsum.py:104, level bodies in _mk_kernel): K5 stripped the
//    same way, over K5's arguments. Its levels are instantiations of K5's
//    own kernels (csrc/segsum.cuh): s0_prep, s1_scan, s2_gather (K5
//    itself) and s2_nostage. The TPU tool's key transpose, one-hot build
//    and HIGHEST contraction have no counterpart on the card.
//
// What bounds them: K9's full level is K3's work (per-(pixel, fragment)
// arithmetic, ~20 flops to evaluate and ~9 to blend); K10's full level is
// K5's work (48 B per drawn slot, 36 B per row). Every level writes a
// result that depends on all the work it did, so nvcc cannot drop any of
// it.

#include "common.cuh"
#include "rasterize_fwd.cuh"
#include "segsum.cuh"

// K9 level `level` (0-7, csrc/rasterize_fwd.cuh; 6 is K3) over K3's
// arguments: frags f32 [9, f_stride] tile-sorted, x/y tile-local;
// tile_start, tile_len int32 [n_tiles]; out f32 [n_tiles, 4, 256]; boxes
// uint32 [f_stride], where level 0 writes the box word of each slot it
// stages (the other levels leave it alone). n_tiles > 0: the caller
// launches nothing for an empty grid. An unknown level returns
// cudaErrorInvalidValue.
GS_EXPORT int gs_raster_level(int level, const float* frags, int f_stride,
                              const int* tile_start, const int* tile_len,
                              int n_tiles, float bg_r, float bg_g,
                              float bg_b, float cutoff_sq, int mode,
                              float* out, unsigned* boxes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
#define GS_RASTER_LEVEL(L)                                                  \
  case L:                                                                   \
    return static_cast<int>(launch_rasterize_fwd<L>(                       \
        frags, f_stride, tile_start, tile_len, n_tiles, bg_r, bg_g, bg_b,  \
        cutoff_sq, mode, out, L == kV0Stage ? boxes : nullptr, s));
    GS_RASTER_LEVEL(kV0Stage)
    GS_RASTER_LEVEL(kV1Cull)
    GS_RASTER_LEVEL(kV2Q)
    GS_RASTER_LEVEL(kV3Alpha)
    GS_RASTER_LEVEL(kV4Trans)
    GS_RASTER_LEVEL(kV5Color)
    GS_RASTER_LEVEL(kV6Full)
    GS_RASTER_LEVEL(kV7NoTrans)
#undef GS_RASTER_LEVEL
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K10 level `level` (0-3, csrc/segsum.cuh; 2 is K5) over K5's arguments
// (as gs_segment_sums takes them; grad in key order, grad[:, perm], for
// level 1; grad_t unused by level 3, which may pass null). Level 0 writes
// only grad_t, row_of and the zeroed out. An unknown level returns
// cudaErrorInvalidValue.
GS_EXPORT int gs_segsum_level(int level, const int* keys,
                              const long long* perm, const float* grad, int f,
                              const int* gid_col, int n_rows, int n,
                              float* out, float* grad_t, int* row_of,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (level) {
#define GS_SEGSUM_LEVEL(L)                                                  \
  case segsum::L:                                                           \
    return static_cast<int>(segsum::launch_segment_sums<segsum::L>(        \
        keys, perm, grad, f, gid_col, n_rows, n, out, grad_t, row_of, s));
    GS_SEGSUM_LEVEL(kS0Prep)
    GS_SEGSUM_LEVEL(kS1Scan)
    GS_SEGSUM_LEVEL(kS2Gather)
    GS_SEGSUM_LEVEL(kS2NoStage)
#undef GS_SEGSUM_LEVEL
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
