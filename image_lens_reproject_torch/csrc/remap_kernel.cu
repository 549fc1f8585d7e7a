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
// Two entry points share that per-pixel code:
// - full frame: one thread per output pixel, 32 x 8 threads a block;
// - list mode: one CTA per listed 8 x 128 output sub-tile, writing into an
//   existing output in place and clipping at its right and bottom edges.
//   It serves the sub-tiles whose source window is too large for kernel B2
//   (rescue_kernel.cu), as the JAX package's XLA patch served the
//   sub-tiles no Pallas window took.
//
// What bounds it on an H100: not HBM bytes. A 4K frame (3840x1920 RGB in,
// 3840x2160 RGB out) reads about 88 MB and writes about 100 MB, some 60 us at
// 3.35 TB/s. Each output pixel issues up to 16 tap loads per channel,
// served mostly from L1/L2 because neighbouring threads sample neighbouring
// source texels, and the accurate libm trigonometry and IEEE division (no
// --use_fast_math) go through long instruction sequences and the SFU. So the
// tap gathers and the transcendental math bound it. One thread per output
// pixel, a warp along a row, keeps the taps of a warp within a few cache
// lines. Kernel B2 asks whether staging each sub-tile's source window in
// shared memory beats these direct __ldg taps.

#include "remap_device.cuh"

namespace {

template <int IN, int OUT, int INTERP>
__global__ void __launch_bounds__(256)
remap_frame(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ rotation, const RemapParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.out_w || y >= p.out_h) return;
    // Per-image base pointers in 64-bit arithmetic: b*H*W*C passes int32
    // for large 4K batches.
    const GlobalFetch fetch{src + (size_t)blockIdx.z * p.in_h * p.in_w * p.channels, p.in_w,
                            p.channels};
    float* out = dst + (((size_t)blockIdx.z * p.out_h + y) * p.out_w + x) * p.channels;
    float r[9];
    load_rotation(p, rotation, r);
    remap_pixel<IN, OUT, INTERP>(p, r, x, y, fetch, out);
}

// tiles: (n, 2) int32 rows of (sub-tile row, sub-tile column); grid (n, B).
template <int IN, int OUT, int INTERP>
__global__ void __launch_bounds__(kTileW * kListThreadsY)
remap_list(const float* __restrict__ src, float* __restrict__ dst,
           const float* __restrict__ rotation, const int32_t* __restrict__ tiles,
           const RemapParams p) {
    const int tile_row = tiles[2 * blockIdx.x];
    const int tile_col = tiles[2 * blockIdx.x + 1];
    const int x = tile_col * kTileW + threadIdx.x;
    if (tile_row < 0 || tile_col < 0 || x >= p.out_w) return;
    const int y0 = tile_row * kTileH;
    const GlobalFetch fetch{src + (size_t)blockIdx.y * p.in_h * p.in_w * p.channels, p.in_w,
                            p.channels};
    float r[9];
    load_rotation(p, rotation, r);
    for (int dy = threadIdx.y; dy < kTileH; dy += kListThreadsY) {
        const int y = y0 + dy;
        if (y >= p.out_h) break;
        float* out = dst + (((size_t)blockIdx.y * p.out_h + y) * p.out_w + x) * p.channels;
        remap_pixel<IN, OUT, INTERP>(p, r, x, y, fetch, out);
    }
}

}  // namespace

extern "C" {

// Launches B1 over the whole frame on `stream` of `device`. `rotation` is a
// device pointer to a row-major 3x3 float32 matrix, read only when
// p->has_rotation. Returns cudaGetLastError() after the launch: 0 when the
// launch was accepted.
int ilr_remap_frame(const float* src, float* dst, const float* rotation, const RemapParams* p,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(32, 8);
    const dim3 grid((p->out_w + block.x - 1) / block.x, (p->out_h + block.y - 1) / block.y,
                    p->batch);
    return dispatch_kernel(*p, [&](auto in, auto out, auto interp) {
        remap_frame<decltype(in)::value, decltype(out)::value, decltype(interp)::value>
            <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, *p);
        return (int)cudaGetLastError();
    });
}

// Launches B1's list mode: `tiles` is a device pointer to n_tiles rows of
// (sub-tile row, sub-tile column) int32; `dst` is the existing
// (B, out_h, out_w, C) output, written in place at those sub-tiles only.
int ilr_remap_list(const float* src, float* dst, const float* rotation, const int32_t* tiles,
                   int n_tiles, const RemapParams* p, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles <= 0) return 0;
    const dim3 block(kTileW, kListThreadsY);
    const dim3 grid(n_tiles, p->batch);
    return dispatch_kernel(*p, [&](auto in, auto out, auto interp) {
        remap_list<decltype(in)::value, decltype(out)::value, decltype(interp)::value>
            <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, tiles, *p);
        return (int)cudaGetLastError();
    });
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ilr_params_size(void) { return (int)sizeof(RemapParams); }

}  // extern "C"
