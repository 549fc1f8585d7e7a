// Kernel B2: listed 8 x 128 output sub-tiles, each computed from its own
// source window staged in shared memory.
//
// It replaces the JAX package's two compact rescue launches:
// - K2, the pass-2 rescue (image_lens_reproject_tpu/ops/pallas/
//   remap_kernel.py, _make_kernel(compact=True), pallas_call at :2191):
//   one window per sub-tile;
// - K3, the pass-2b split rescue (_make_kernel(compact=True, split=True),
//   pallas_call at :2296): two windows per sub-tile, one for each 8 x 64
//   half, for sub-tiles whose taps jump between two clusters that no one
//   window covers.
// Both recomputed listed sub-tiles and scattered them into the output; B2
// writes them into the existing (B, band_rows, out_w, C) output in place,
// in a band of the frame's rows as K2 ran at a mesh band's row0
// (RemapParams::row0 / band_rows, B1's band mode; the whole frame: 0 and
// out_h). The
// lists and windows come from ops/plan.py, which takes them from the plain
// path's own coordinate and tap math on the card, with one texel of slack
// per side.
//
// The kernel (rescue_windows.cu, compiled once for each input lens): one
// CTA of 128 x 2 threads per listed sub-tile and group of images (the
// whole batch where its windows fit, else one image), each thread computing
// 4 rows of its column:
// - start copying the group's windows (rows x cols x C float32, columns
//   taken modulo W when the input wraps) into dynamic shared memory with
//   16-byte cp.async, one commit group a window;
// - meanwhile compute the source coordinates of the thread's 4 pixels,
//   which need no window, once for every image of the group;
// - wait for the copies, __syncthreads(), then take each pixel's taps and
//   weights and sample every image of the group from its window with
//   kernel B1's per-pixel code (remap_device.cuh). The output is the same
//   float32 operations as B1's, so it equals B1's bit for bit.
// A tap outside its window is never read out of bounds: its index is
// clamped into the window and the read is counted in a device counter
// (`misses`), which the caller checks; the plan's windows make it 0.
//
// What bounds it: the per-pixel arithmetic it shares with B1 (issued
// instructions: B1's own bound, see remap_kernel.cu), plus the staging of
// every window, and the CTAs an SM can hold, which each CTA's registers and
// shared memory decide. The design answers each (PERF.md):
// - the plan sorts each list into size classes, and one launch a class
//   reserves only that class's largest window (BASELINE config 2's
//   windows run from about 15 KB to 97.6 KB, median 35 KB: one size for
//   all would fit two CTAs an SM);
// - B1's specialisations on the channel count (3, 4, any) and the
//   supersample count (1, any), picked by the same rule
//   (remap_kernel.specialisation);
// - a batch's images share one CTA where their windows fit, so each
//   pixel's trigonometry is computed once for the batch, as in B1's frame;
// - the copies are 16-byte and asynchronous, mapped to (row, 16-byte
//   chunk) without a division per float, and overlap the coordinates. TMA
//   is not used: its box is fixed in the tensor map, and these windows
//   change size from sub-tile to sub-tile;
// - a tap's out-of-window check neither branches nor waits on an atomic:
//   each thread counts its misses and adds them once, so a pixel's
//   shared-memory loads issue together.
// On an H100 each step paid (PERF.md): config 2's 7654-sub-tile
// rescue list went from 0.632 to 0.169 ms, the headline's 8100 sub-tiles
// from 0.359 to 0.231 ms, and from 0.353 to 0.117 ms a frame at batch 4.

#include "lens_dispatch.cuh"

extern "C" {

// B2's launchers, one for each input lens (rescue_windows.cu).
#define ILR_WINDOWS_ARGS                                                                      \
    const float*, float*, const float*, const int32_t*, int, int, int, int, const RemapParams*, \
        unsigned long long*, void*
int ilr_remap_windows_in0(ILR_WINDOWS_ARGS);
int ilr_remap_windows_in1(ILR_WINDOWS_ARGS);
int ilr_remap_windows_in2(ILR_WINDOWS_ARGS);
int ilr_remap_windows_in3(ILR_WINDOWS_ARGS);
int ilr_remap_windows_in4(ILR_WINDOWS_ARGS);

}  // extern "C"

namespace {

// One a LensCode (by_in_lens).
int (*const kWindows[5])(ILR_WINDOWS_ARGS) = {ilr_remap_windows_in0, ilr_remap_windows_in1,
                                              ilr_remap_windows_in2, ilr_remap_windows_in3,
                                              ilr_remap_windows_in4};
#undef ILR_WINDOWS_ARGS

}  // namespace

extern "C" {

// Launches B2 on `stream` of `device` over n_entries listed sub-tiles
// (`entries`, a device pointer to int32 rows of 6, or of 10 when `split`)
// of one size class, writing into the existing output `dst` in place.
// window_bytes is the dynamic shared memory one image's windows take (the
// class's bound, ops/plan.py); `images` is the images a CTA computes: 1, or
// the whole batch. `misses` is a device pointer to one uint64 counter that
// out-of-window reads add to. Returns cudaGetLastError() after the launch:
// 0 when it was accepted.
int ilr_remap_windows(const float* src, float* dst, const float* rotation,
                      const int32_t* entries, int n_entries, int split, int window_bytes,
                      int images, const RemapParams* p, unsigned long long* misses, int device,
                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_entries <= 0) return 0;
    if (images < 1 || p->batch % images != 0 || window_bytes <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    return by_in_lens(p, kWindows, src, dst, rotation, entries, n_entries, split, window_bytes,
                      images, p, misses, stream);
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ilr_params_size(void) { return (int)sizeof(RemapParams); }

}  // extern "C"
