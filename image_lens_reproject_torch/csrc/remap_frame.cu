// Kernel B1 for one input lens: the instances of remap_frame whose input
// lens is ILR_IN_LENS (a LensCode), for every output lens, sampler and
// specialisation, for the full frame (or a band of its rows) and for list
// mode, and of remap_views, view mode (75 x 6 x 3 instances in all, 270 a
// lens). The build compiles this file once for each input lens, in
// parallel (ops/cuda/remap_kernel.py::SOURCES), and links the five objects
// with remap_kernel.cu, whose ilr_remap_frame, ilr_remap_list and
// ilr_remap_views call ilr_remap_frame_in<lens>. The kernel and its design
// are described in remap_kernel.cu.

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
