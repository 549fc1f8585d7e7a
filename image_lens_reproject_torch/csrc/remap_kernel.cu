// Kernel B1: reprojection of a batch of HWC float32 images from any input
// lens to any output lens (rectilinear, equidistant, equisolid and
// stereographic fisheye, equirectangular), with nearest, bilinear or
// bicubic sampling, n x n supersampling and the exposure /
// extended-Reinhard epilogue, in one launch.
//
// It replaces the JAX package's main Pallas tile kernel,
// image_lens_reproject_tpu/ops/pallas/remap_kernel.py::_make_kernel (the
// pallas_call at remap_kernel.py:2127, in all three of its bodies),
// together with the XLA epilogue ops/color.py::post_process that ran after
// it. Its plain version is this package's ops/remap.py::remap_batch followed
// by ops/color.py::post_process, and it computes the same float32
// operations in the same order (remap_device.cuh):
//   pixel -> ray (output lens) -> rotate -> source pixel (input lens)
//   -> taps (truncate toward zero, wrap or clamp) -> the sampler's combine
//   -> sum over the supersample offsets (x outer, y inner) -> times 1/n^2
//   -> tonemap.
// Built with -fmad=false so that no a*b+c is contracted into an FMA.
//
// One kernel thread (remap_frame.cu, built once for each input lens and
// specialised on the channel count, 3, 4 or any, and the supersample
// count, 1 or any) serves three entry points, each with instances of its
// own, one thread an output pixel, 32 x 8 threads a block:
// - the full frame, or a band of its rows (RemapParams::row0, band_rows:
//   K1's row0 / band_rows, the unit of parallel/batch.py's rows axis);
// - list mode: four blocks a listed 8 x 128 output sub-tile, writing into
//   an existing output (of the frame, or of a band of its rows) in place
//   and clipping at its right and bottom edges. It serves the sub-tiles whose source window is too large for
//   kernel B2 (rescue_kernel.cu), as the JAX package's XLA patch served
//   the sub-tiles no Pallas window took. Sharing the frame's instances
//   gives it their specialisations, and a thread a pixel fills the card
//   with a short list (PERF.md).
// - view mode (remap_views): the full frame under several rotations in
//   one launch, blockIdx.z the view, the source read in place by every
//   view; a stack of up to kMaxViewsByValue rotations by value in
//   RemapParams::rotation, a larger one through a device pointer.
// - the coordinate field: the frame or band of a configuration that a
//   caller remaps again and again, its source coordinates computed once
//   into a field (coord_field) and read back by the frame's read instances
//   (remap_frame<IN, kFromField, ...>) in place of the lens and rotation
//   arithmetic (remap_device.cuh; the launch wrapper decides when).
// A thread computes its pixel's coordinates, taps and weights once and
// then samples every image of the batch with them.
//
// What bounds it on an H100: issued instructions, not HBM bytes. A 4K frame
// (3840x1920 RGB in, 3840x2160 RGB out) must move about 102 MB, some 30 us
// at 3.35 TB/s. Timed ablations on the card (PERF.md) priced the parts of
// the earlier one-size kernel, 0.31 ms a headline frame: the run-time
// channel count about 15 % of its time, the horizontal wrap's two integer
// % about 15 %, the tap loads about 13 %, the double-precision supersample
// offsets about 6 %, the libm trigonometry about 5 % and the IEEE
// division and square root about 3 %. The last two
// are what bit parity with the plain path requires; the design removes the
// rest of what parity does not need: one conditional add or subtract for
// the wrap, offsets rounded on the host, the channel count and the
// one-sample case as template parameters with one texel offset a tap (one
// 16-byte load for 4 channels), and the batch looped inside the thread.
// That takes the headline to 0.18 ms a frame, 0.11 ms a frame at batch 4:
// about half of it is the coordinates, taps and weights, shared by the
// batch, and half the sampling of each image (48 tap loads, 96 float32
// operations and the tonemap's division a pixel), both still bound by
// issue. Staging the source in shared memory does not pay for B1 (kernel
// B2 stages windows and is slower, PERF.md); TMA copies tiles, and the taps
// are data-dependent gathers; there is no matrix product for the tensor
// cores.

#include "lens_dispatch.cuh"

// The launchers of the full frame, list mode and view mode, one for each
// input lens (remap_frame.cu): tiles null but in list mode, views 0 but in
// view mode.
extern "C" {
int ilr_remap_frame_in0(const float*, float*, const float*, const int32_t*, int, int,
                        const RemapParams*, void*);
int ilr_remap_frame_in1(const float*, float*, const float*, const int32_t*, int, int,
                        const RemapParams*, void*);
int ilr_remap_frame_in2(const float*, float*, const float*, const int32_t*, int, int,
                        const RemapParams*, void*);
int ilr_remap_frame_in3(const float*, float*, const float*, const int32_t*, int, int,
                        const RemapParams*, void*);
int ilr_remap_frame_in4(const float*, float*, const float*, const int32_t*, int, int,
                        const RemapParams*, void*);
int ilr_coord_field_in0(float2*, const RemapParams*, void*);
int ilr_coord_field_in1(float2*, const RemapParams*, void*);
int ilr_coord_field_in2(float2*, const RemapParams*, void*);
int ilr_coord_field_in3(float2*, const RemapParams*, void*);
int ilr_coord_field_in4(float2*, const RemapParams*, void*);
int ilr_remap_field_in0(const float*, float*, const float2*, const RemapParams*, void*);
int ilr_remap_field_in1(const float*, float*, const float2*, const RemapParams*, void*);
int ilr_remap_field_in2(const float*, float*, const float2*, const RemapParams*, void*);
int ilr_remap_field_in3(const float*, float*, const float2*, const RemapParams*, void*);
int ilr_remap_field_in4(const float*, float*, const float2*, const RemapParams*, void*);
}

namespace {

// Each entry point's launchers, one a LensCode (by_in_lens).
int (*const kFrame[5])(const float*, float*, const float*, const int32_t*, int, int,
                       const RemapParams*, void*) = {
    ilr_remap_frame_in0, ilr_remap_frame_in1, ilr_remap_frame_in2, ilr_remap_frame_in3,
    ilr_remap_frame_in4};
int (*const kFieldFill[5])(float2*, const RemapParams*, void*) = {
    ilr_coord_field_in0, ilr_coord_field_in1, ilr_coord_field_in2, ilr_coord_field_in3,
    ilr_coord_field_in4};
int (*const kFieldRead[5])(const float*, float*, const float2*, const RemapParams*, void*) = {
    ilr_remap_field_in0, ilr_remap_field_in1, ilr_remap_field_in2, ilr_remap_field_in3,
    ilr_remap_field_in4};

}  // namespace

extern "C" {

// Launches B1 over the band of the frame that p->row0 and p->band_rows
// give (the whole frame: 0 and out_h; `dst` holds band_rows rows) on
// `stream` of `device`. `rotation` is a device pointer to a row-major 3x3
// float32 matrix, read only when p->has_rotation is kRotationOnDevice.
// Returns cudaGetLastError() after the launch: 0 when the launch was
// accepted.
int ilr_remap_frame(const float* src, float* dst, const float* rotation, const RemapParams* p,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return by_in_lens(p, kFrame, src, dst, rotation, nullptr, 0, 0, p, stream);
}

// Launches B1's list mode: `tiles` is a device pointer to n_tiles rows of
// (sub-tile row, sub-tile column) int32, the rows counted from the band's
// first row p->row0; `dst` is the existing (B, p->band_rows, out_w, C)
// output (the whole frame: row0 0, band_rows out_h), written in place at
// those sub-tiles only.
int ilr_remap_list(const float* src, float* dst, const float* rotation, const int32_t* tiles,
                   int n_tiles, const RemapParams* p, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles <= 0) return 0;
    return by_in_lens(p, kFrame, src, dst, rotation, tiles, n_tiles, 0, p, stream);
}

// Launches B1's view mode: `views` views of the full frame into the
// (B, views, out_h, out_w, C) `dst`, view v under rotation v of a stack
// of row-major 3x3 float32: p->rotation[9 * v] when p->has_rotation is
// kRotationByValue (at most kMaxViewsByValue views), else the device
// pointer `rotations`.
int ilr_remap_views(const float* src, float* dst, const float* rotations, int views,
                    const RemapParams* p, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (views < 1 || p->row0 != 0 || p->band_rows != p->out_h) return (int)cudaErrorInvalidValue;
    return by_in_lens(p, kFrame, src, dst, rotations, nullptr, 0, views, p, stream);
}

// Fills `field`, a device pointer to band_rows x out_w float2, with the
// source coordinate (sx, sy) of every pixel of p's band (the coordinate
// field, remap_device.cuh); the rotation by value or none.
int ilr_coord_field(float2* field, const RemapParams* p, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return by_in_lens(p, kFieldFill, field, p, stream);
}

// Launches B1 over p's band as ilr_remap_frame does, each pixel's source
// coordinate read from `field`, which ilr_coord_field filled with the same
// p (all but batch, channels, interp, tonemap and their specialisation);
// one supersample only.
int ilr_remap_field(const float* src, float* dst, const float2* field, const RemapParams* p,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return by_in_lens(p, kFieldRead, src, dst, field, p, stream);
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ilr_params_size(void) { return (int)sizeof(RemapParams); }

}  // extern "C"
