// Kernel B1 for one input lens: the instances of remap_frame whose input
// lens is ILR_IN_LENS (a LensCode), for every output lens, sampler and
// specialisation, for the full frame (or a band of its rows) and for list
// mode, and of remap_views, view mode (75 x 6 x 3 instances in all, 270 a
// lens); and the coordinate field's kernels: coord_field for every output
// lens (5 a lens) and the frame's read instances for every sampler and
// channel specialisation (9 a lens). The build compiles this file once
// for each input lens, in parallel (ops/cuda/remap_kernel.py::SOURCES),
// and links the five objects with remap_kernel.cu, whose ilr_remap_frame,
// ilr_remap_list and ilr_remap_views call ilr_remap_frame_in<lens>, and
// ilr_coord_field and ilr_remap_field ilr_coord_field_in<lens> and
// ilr_remap_field_in<lens>. The kernel and its design are described in
// remap_kernel.cu.

#include <climits>

#include "remap_device.cuh"

#ifndef ILR_IN_LENS
#error "compile with -DILR_IN_LENS=<LensCode of the input lens>"
#endif

#define ILR_PASTE2(a, b) a##b
#define ILR_PASTE(a, b) ILR_PASTE2(a, b)

namespace {

// One thread per output pixel, a block of kBlockW x kTileH threads for one
// kBlockW x kTileH piece of the output; each thread computes its pixel of
// every image of the batch. Both modes work in a band of the frame's rows
// (RemapParams::row0 / band_rows; the whole frame is the band of row0 = 0,
// band_rows = out_h): the thread of band row y computes frame row row0 + y
// and writes row y of a (batch, band_rows, out_w, C) output. A band may
// run past out_h: those rows are computed as any other, as the JAX
// package's K1 pads its last band (row0 / band_rows of
// ops/pallas/remap_kernel.py::_remap_pallas_one). The full frame takes
// piece (blockIdx.x, blockIdx.y) of its band. List mode (LIST) takes piece
// blockIdx.x % kPieces of listed sub-tile blockIdx.x / kPieces (tiles:
// (n, 2) int32 rows of sub-tile row and column, the rows counted from the
// band's first row; a negative entry is skipped), so that a short list
// still gives every pixel its own thread; in a mesh band it fills the
// band's direct sub-tiles (K2's row0 inside each band). The list's
// instances are apart from the frame's: a run-time branch on tiles cost
// the frame about 1 % (PERF.md). View mode (VIEWS, the kernel remap_views)
// is the full frame with blockIdx.z the view: the view's rotation at
// 9 * view of RemapParams::rotation or of the rotation pointer, its
// (band_rows, out_w, C) image at view * out_image of each image's
// (gridDim.z, band_rows, out_w, C) output. Blocks are issued x first, then
// y, then z, so one view's blocks run together (PERF.md). Its instances
// are apart from the frame's too: the frame taking the view from
// blockIdx.z cost it 3-5 % (PERF.md).
constexpr int kBlockW = 32;
constexpr int kPieces = kTileW / kBlockW;
static_assert(kTileW % kBlockW == 0, "a sub-tile is whole pieces");

template <int IN, int OUT, int INTERP, int CH, int NS, bool LIST, bool VIEWS>
__device__ __forceinline__ void frame_thread(const float* __restrict__ src,
                                             float* __restrict__ dst,
                                             const float* __restrict__ rotation,
                                             const int32_t* __restrict__ tiles,
                                             const RemapParams& p) {
    int piece_x = blockIdx.x, piece_y = blockIdx.y;
    if constexpr (LIST) {
        const int entry = blockIdx.x / kPieces;
        const int tile_col = tiles[2 * entry + 1];
        piece_y = tiles[2 * entry];
        if (piece_y < 0 || tile_col < 0) return;
        piece_x = tile_col * kPieces + blockIdx.x % kPieces;
    }
    const int x = piece_x * kBlockW + threadIdx.x;
    const int y = piece_y * kTileH + threadIdx.y;  // the row of dst
    if (x >= p.out_w || y >= p.band_rows) return;
    const int C = CH == kAnyChannels ? p.channels : CH;
    const long long out_image = (long long)p.band_rows * p.out_w * C;
    float r[9];
    if constexpr (VIEWS) {
        const int view = blockIdx.z;
        load_rotation(p, rotation, r, view);
        remap_pixel<IN, OUT, INTERP, CH, NS>(
            p, r, x, p.row0 + y, GlobalFetch<CH>(src, p), p.batch,
            dst + view * out_image + ((long long)y * p.out_w + x) * C, out_image * gridDim.z);
    } else {
        load_rotation(p, rotation, r);
        remap_pixel<IN, OUT, INTERP, CH, NS>(p, r, x, p.row0 + y, GlobalFetch<CH>(src, p),
                                             p.batch, dst + ((long long)y * p.out_w + x) * C,
                                             out_image);
    }
}

template <int IN, int OUT, int INTERP, int CH, int NS, bool LIST>
__global__ void __launch_bounds__(kBlockW * kTileH)
remap_frame(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ rotation, const int32_t* __restrict__ tiles,
            const RemapParams p) {
    frame_thread<IN, OUT, INTERP, CH, NS, LIST, false>(src, dst, rotation, tiles, p);
}

// p is a __grid_constant__, so that a view's rotation is read from the
// launch constants at a run-time index without a copy of p.
template <int IN, int OUT, int INTERP, int CH, int NS>
__global__ void __launch_bounds__(kBlockW * kTileH)
remap_views(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ rotation, const __grid_constant__ RemapParams p) {
    frame_thread<IN, OUT, INTERP, CH, NS, false, true>(src, dst, rotation, nullptr, p);
}

// The coordinate field of a band (remap_device.cuh): thread (x, y) writes
// the (sx, sy) that the frame's thread of band row y computes for its one
// supersample (remap_pixel, NS = 1), with the same operations, at
// field[y * out_w + x]. The rotation is by value or none.
template <int IN, int OUT>
__global__ void __launch_bounds__(kBlockW * kTileH)
coord_field(float2* __restrict__ field, const RemapParams p) {
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y = blockIdx.y * kTileH + threadIdx.y;
    if (x >= p.out_w || y >= p.band_rows) return;
    float r[9];
    load_rotation(p, nullptr, r);
    float cx, cy;
    pixel_centre(p, x, p.row0 + y, cx, cy);
    const float o = p.offsets[0];
    float sx, sy;
    source_coord<IN, OUT>(p, r, cx + o, cy + o, sx, sy);
    field[(long long)y * p.out_w + x] = make_float2(sx, sy);
}

// Rows a thread of a read instance takes, kTileH apart. Bicubic's sixteen
// taps a pixel keep a thread waiting on its gathers, and four pixels'
// field loads and taps in flight at once hide that: 1.15-1.17x on four of
// five bicubic configurations, at batch 4 too. The other samplers' mixed
// readings keep one (PERF.md).
template <int INTERP>
constexpr int kFieldRows = INTERP == kBicubic ? 4 : 1;

// The frame's read instances: the frame's pixels with their (sx, sy)
// loaded from a coordinate field that coord_field filled for the same band
// (a coalesced 8-byte load a pixel, streamed past L2's source texels) in
// place of source_coord, then located and sampled as the frame's thread
// does; one supersample. A block takes kBlockW x (kTileH x kFieldRows)
// pixels. They overload remap_frame with OUT = kFromField, so that the
// profiler names them as it names the frame's instances (remap_frame<...,
// false>), and the frame's own instances are untouched.
template <int IN, int OUT, int INTERP, int CH, int NS, bool LIST>
__global__ void __launch_bounds__(kBlockW * kTileH)
remap_frame(const float* __restrict__ src, float* __restrict__ dst,
            const float2* __restrict__ field, const RemapParams p) {
    static_assert(OUT == kFromField && NS == 1 && !LIST, "a read instance of the frame");
    constexpr int kRows = kFieldRows<INTERP>;
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y0 = blockIdx.y * (kTileH * kRows) + threadIdx.y;
    if (x >= p.out_w || y0 >= p.band_rows) return;
    const int C = CH == kAnyChannels ? p.channels : CH;
    float2 s[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int y = y0 + k * kTileH;
        if (k == 0 || y < p.band_rows) s[k] = __ldcs(field + (long long)y * p.out_w + x);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int y = y0 + k * kTileH;
        if (k == 0 || y < p.band_rows) {
            const long long pixel = (long long)y * p.out_w + x;
            sample_images<INTERP, CH>(p, locate_at<IN, INTERP>(p, s[k].x, s[k].y),
                                      GlobalFetch<CH>(src, p), p.batch, dst + pixel * C,
                                      (long long)p.band_rows * p.out_w * C);
        }
    }
}

}  // namespace

// Launches the full frame's band (tiles null, views 0), list mode over
// n_tiles listed sub-tiles (tiles a device pointer, views 0) or view mode
// over `views` views of the full frame (tiles null).
extern "C" int ILR_PASTE(ilr_remap_frame_in, ILR_IN_LENS)(const float* src, float* dst,
                                                            const float* rotation,
                                                            const int32_t* tiles, int n_tiles,
                                                            int views, const RemapParams* p,
                                                            void* stream) {
    if (tiles != nullptr && n_tiles > INT_MAX / kPieces) return (int)cudaErrorInvalidValue;
    if (views < 0 || views > 65535 || (views > 0 && tiles != nullptr) ||
        (views > kMaxViewsByValue && p->has_rotation == kRotationByValue)) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 block(kBlockW, kTileH);
    const dim3 grid = tiles == nullptr
        ? dim3((p->out_w + kBlockW - 1) / kBlockW, (p->band_rows + kTileH - 1) / kTileH,
               views > 0 ? views : 1)
        : dim3(n_tiles * kPieces);
    auto launch = [&](auto in, auto out, auto interp) {
        return dispatch_spec(*p, [&](auto channels, auto samples) {
            constexpr int IN = decltype(in)::value, OUT = decltype(out)::value;
            constexpr int INTERP = decltype(interp)::value, CH = decltype(channels)::value;
            constexpr int NS = decltype(samples)::value;
            if (views > 0) {
                remap_views<IN, OUT, INTERP, CH, NS>
                    <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, *p);
            } else if (tiles == nullptr) {
                remap_frame<IN, OUT, INTERP, CH, NS, false>
                    <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, tiles, *p);
            } else {
                remap_frame<IN, OUT, INTERP, CH, NS, true>
                    <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, tiles, *p);
            }
            return (int)cudaGetLastError();
        });
    };
    return dispatch_out<ILR_IN_LENS>(*p, launch);
}

// Fills the (band_rows, out_w) float2 coordinate field of p's band.
extern "C" int ILR_PASTE(ilr_coord_field_in, ILR_IN_LENS)(float2* field, const RemapParams* p,
                                                            void* stream) {
    if (p->has_rotation == kRotationOnDevice) return (int)cudaErrorInvalidValue;
    const dim3 block(kBlockW, kTileH);
    const dim3 grid((p->out_w + kBlockW - 1) / kBlockW, (p->band_rows + kTileH - 1) / kTileH);
    auto launch = [&](auto in, auto out, auto) {
        constexpr int IN = decltype(in)::value, OUT = decltype(out)::value;
        coord_field<IN, OUT><<<grid, block, 0, (cudaStream_t)stream>>>(field, *p);
        return (int)cudaGetLastError();
    };
    return dispatch_out<ILR_IN_LENS>(*p, launch);
}

// Launches the frame's band sampling from `field`, which coord_field filled
// for this band, lenses, sizes and rotation; one supersample only.
extern "C" int ILR_PASTE(ilr_remap_field_in, ILR_IN_LENS)(const float* src, float* dst,
                                                            const float2* field,
                                                            const RemapParams* p, void* stream) {
    const dim3 block(kBlockW, kTileH);
    auto launch = [&](auto in, auto, auto interp) {
        return dispatch_spec(*p, [&](auto channels, auto samples) {
            constexpr int IN = decltype(in)::value, INTERP = decltype(interp)::value;
            constexpr int CH = decltype(channels)::value, kRows = kFieldRows<INTERP>;
            const dim3 grid((p->out_w + kBlockW - 1) / kBlockW,
                            (p->band_rows + kTileH * kRows - 1) / (kTileH * kRows));
            if constexpr (decltype(samples)::value != 1) {
                return (int)cudaErrorInvalidValue;
            } else {
                remap_frame<IN, kFromField, INTERP, CH, 1, false>
                    <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, field, *p);
                return (int)cudaGetLastError();
            }
        });
    };
    return dispatch_interp<ILR_IN_LENS, kFromField>(p->interp, launch);
}
