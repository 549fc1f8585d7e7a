// Kernel B2 for one input lens: the instances of remap_windows whose input
// lens is ILR_IN_LENS (a LensCode), for every output lens, sampler and
// specialisation (75 x 6 instances in all, 90 a lens). The build compiles
// this file once for each input lens, in parallel
// (ops/cuda/rescue_kernel.py::SOURCES), and links the five objects with
// rescue_kernel.cu, whose ilr_remap_windows calls ilr_remap_windows_in<lens>.
// The kernel and its design are described in rescue_kernel.cu.

#include "remap_device.cuh"

#ifndef ILR_IN_LENS
#error "compile with -DILR_IN_LENS=<LensCode of the input lens>"
#endif

#define ILR_PASTE2(a, b) a##b
#define ILR_PASTE(a, b) ILR_PASTE2(a, b)

namespace {

// CTAs of 256 threads that __launch_bounds__ asks to fit an SM: it caps the
// registers of every instance at 65536 / (256 x kMinBlocks).
constexpr int kMinBlocks = 4;

struct Window {
    int row0, rows, col0, cols;
};

// Where a window's copy lies in shared memory: window row r at r * pitch
// floats, its first texel `shift` floats into the row. The copy of a row
// starts at the 16-byte boundary at or below the row's first float, so
// shift is that float's offset from it (0 when copying 4 bytes at a time).
struct Staged {
    int pitch, shift, floats;
};

// vec: floats a copy moves, 4 (16 bytes) or 1. ops/plan.py sizes a window
// as rows x round_up(cols x C + 3, 4) floats, which bounds this.
__device__ __forceinline__ Staged staged(const Window& w, int channels, int vec) {
    const int n = w.cols * channels;
    if (vec == 4) {
        const int shift = (w.col0 * channels) & 3;
        const int pitch = (shift + n + 3) & ~3;
        return {pitch, shift, w.rows * pitch};
    }
    return {n, 0, w.rows * n};
}

template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (V == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
    }
}

// Starts the copy of window w of `img` (one HWC image of the source) to
// `dst`, laid out as `s` says, V floats a copy, then commits it as one
// group. The threads take (row, chunk) pairs 256 apart, stepped without a
// division. A window row is contiguous in the source except where a
// wrapping window passes column in_w - 1 and continues at column 0: the
// chunks from `seam` on read from the row's start. With V = 4 the source
// rows are 16-byte aligned (the launcher checks), so the seam falls on a
// chunk boundary and no chunk reads past the end of a row. Rows are
// clamped for memory safety only.
template <int V>
__device__ __forceinline__ void stage(const float* __restrict__ img, float* dst, const Window& w,
                                      const Staged& s, const RemapParams& p) {
    const int C = p.channels;
    const long long line = (long long)p.in_w * C;
    const int start = w.col0 * C - s.shift;
    const int seam = (p.in_w - w.col0) * C + s.shift;
    const int chunks = s.pitch / V;
    const int threads = kTileW * kListThreadsY;
    const int tid = threadIdx.y * kTileW + threadIdx.x;
    int r = tid / chunks;
    int j = tid - r * chunks;
    const int dr = threads / chunks;
    const int dj = threads - dr * chunks;
    while (r < w.rows) {
        const int o = j * V;
        const float* row = img + min(w.row0 + r, p.in_h - 1) * line;
        copy_async<V>(dst + r * s.pitch + o, o < seam ? row + start + o : row + (o - seam));
        r += dr;
        j += dj;
        if (j >= chunks) {
            j -= chunks;
            ++r;
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_window(const float* img, float* dst, const Window& w,
                                             const Staged& s, const RemapParams& p, int vec) {
    if (vec == 4) {
        stage<4>(img, dst, w, s, p);
    } else {
        stage<1>(img, dst, w, s, p);
    }
}

// Taps read from the windows of `images` images staged in shared memory
// (remap_pixel's Fetch interface: image, texel, read, read4). A tap outside
// its window reads the window's nearest texel and adds its `nc` channel
// reads to `missed`, as the plain version counts them; the kernel adds the
// thread's count to the device counter once, at its end. No tap's address
// waits on a branch or an atomic, so a pixel's shared-memory loads issue
// together.
template <int CH>
struct WindowFetch {
    const float* win;  // image 0's copy of the window, at its first texel
    int image_floats;  // floats from one image's windows to the next image's
    Window w;
    int pitch;  // floats from one window row to the next
    int in_w, channels;
    bool wrap;
    mutable unsigned long long missed;
    __device__ __forceinline__ const float* image(int b) const { return win + b * image_floats; }
    __device__ __forceinline__ const float* texel(const float* img, int yi, int xi, int nc) const {
        const int ly = yi - w.row0;
        int lx = xi - w.col0;
        // Wrapped taps and window starts both lie in [0, in_w).
        if (wrap && lx < 0) lx += in_w;
        const bool out = (unsigned)ly >= (unsigned)w.rows || (unsigned)lx >= (unsigned)w.cols;
        missed += out ? (unsigned long long)nc : 0ull;
        return img + clamp_i(ly, w.rows - 1) * pitch +
               clamp_i(lx, w.cols - 1) * (CH == kAnyChannels ? channels : CH);
    }
    __device__ __forceinline__ float read(const float* texel, int c) const { return texel[c]; }
    // A C = 4 window's texels are 16-byte aligned: shift 0, pitch 4 x cols.
    __device__ __forceinline__ float4 read4(const float* texel) const {
        return *reinterpret_cast<const float4*>(texel);
    }
};

// entries: rows of (sub-tile row, sub-tile column, row0, rows, col0, cols),
// and in split mode a second window (row0, rows, col0, cols) for the right
// 8 x 64 half. The sub-tile rows count from the first row of the band of
// the frame that RemapParams::row0 / band_rows give (the whole frame: 0
// and out_h), as in B1's band mode: the pixel of band row y is frame row
// p.row0 + y and goes to row y of a (batch, band_rows, out_w, C) output;
// the windows are in the whole source's coordinates. grid (n, B / images):
// CTA (i, j) computes listed sub-tile i
// of images j * images .. (j + 1) * images - 1, whose windows it stages one
// after another in its dynamic shared memory. `split` is the same for
// every thread of a launch: a template parameter would double the
// instances to build.
template <int IN, int OUT, int INTERP, int CH, int NS>
__global__ void __launch_bounds__(kTileW * kListThreadsY, kMinBlocks)
remap_windows(const float* __restrict__ src, float* __restrict__ dst,
              const float* __restrict__ rotation, const int32_t* __restrict__ entries,
              const int split, const int images, const int vec, const RemapParams p,
              unsigned long long* misses) {
    extern __shared__ __align__(16) float win[];
    const int32_t* e = entries + (size_t)blockIdx.x * (split ? 10 : 6);
    if (e[0] < 0 || e[1] < 0) return;  // the whole block: before any barrier
    const Window left{e[2], e[3], e[4], e[5]};
    const Window right = split ? Window{e[6], e[7], e[8], e[9]} : left;
    const Staged sl = staged(left, p.channels, vec);
    const Staged sr = split ? staged(right, p.channels, vec) : Staged{0, 0, 0};
    const int image_floats = sl.floats + sr.floats;
    const int b0 = blockIdx.y * images;
    const long long in_image = (long long)p.in_h * p.in_w * p.channels;
    for (int i = 0; i < images; ++i) {
        const float* img = src + (b0 + i) * in_image;
        stage_window(img, win + i * image_floats, left, sl, p, vec);
        if (split) stage_window(img, win + i * image_floats + sl.floats, right, sr, p, vec);
    }

    // This thread's pixels: rows y0, y0 + 2, y0 + 4, y0 + 6 of column x.
    // Their source coordinates need no window, so with one supersample they
    // are computed while the copies land.
    constexpr int kRows = kTileH / kListThreadsY;
    const int x = e[1] * kTileW + threadIdx.x;
    const int y0 = e[0] * kTileH + threadIdx.y;
    float r[9];
    load_rotation(p, rotation, r);
    float sx[kRows], sy[kRows];
    if constexpr (NS == 1) {
        const float o = p.offsets[0];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            float cx, cy;
            pixel_centre(p, x, p.row0 + y0 + k * kListThreadsY, cx, cy);
            source_coord<IN, OUT>(p, r, cx + o, cy + o, sx[k], sy[k]);
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (x >= p.out_w) return;
    const bool use_right = split && threadIdx.x >= kTileW / 2;
    const Staged& s = use_right ? sr : sl;
    const WindowFetch<CH> fetch{win + (use_right ? sl.floats : 0) + s.shift,
                                image_floats,
                                use_right ? right : left,
                                s.pitch,
                                p.in_w,
                                p.channels,
                                p.wrap != 0,
                                0ull};
    const int C = CH == kAnyChannels ? p.channels : CH;
    const long long out_image = (long long)p.band_rows * p.out_w * C;
    float* out = dst + b0 * out_image + (long long)x * C;
    if constexpr (NS == 1) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const int y = y0 + k * kListThreadsY;
            if (y >= p.band_rows) break;
            sample_images<INTERP, CH>(p, locate_at<IN, INTERP>(p, sx[k], sy[k]), fetch, images,
                                      out + (long long)y * p.out_w * C, out_image);
        }
    } else {
        for (int y = y0; y < e[0] * kTileH + kTileH && y < p.band_rows; y += kListThreadsY) {
            remap_pixel<IN, OUT, INTERP, CH, NS>(p, r, x, p.row0 + y, fetch, images,
                                                 out + (long long)y * p.out_w * C, out_image);
        }
    }
    if (fetch.missed) atomicAdd(misses, fetch.missed);
}

}  // namespace

// Launches B2 for an input lens of ILR_IN_LENS: n_entries listed sub-tiles
// of `images` images a CTA (1, or the whole batch), each image's windows
// taking window_bytes of dynamic shared memory (ops/plan.py's bound for the
// list's size class). Staged with 16-byte copies when the source rows are
// 16-byte aligned, else 4-byte ones.
extern "C" int ILR_PASTE(ilr_remap_windows_in, ILR_IN_LENS)(
    const float* src, float* dst, const float* rotation, const int32_t* entries, int n_entries,
    int split, int window_bytes, int images, const RemapParams* p, unsigned long long* misses,
    void* stream) {
    const int smem = images * window_bytes;
    const int vec = ((uintptr_t)src % 16 == 0 && (p->in_w * p->channels) % 4 == 0) ? 4 : 1;
    const dim3 block(kTileW, kListThreadsY);
    const dim3 grid(n_entries, p->batch / images);
    auto launch = [&](auto in, auto out, auto interp) {
        return dispatch_spec(*p, [&](auto channels, auto samples) {
            auto kernel = remap_windows<decltype(in)::value, decltype(out)::value,
                                        decltype(interp)::value, decltype(channels)::value,
                                        decltype(samples)::value>;
            // Above 48 KB a block gets dynamic shared memory only after this opt-in.
            cudaError_t err =
                cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return (int)err;
            kernel<<<grid, block, smem, (cudaStream_t)stream>>>(src, dst, rotation, entries, split,
                                                               images, vec, *p, misses);
            return (int)cudaGetLastError();
        });
    };
    return dispatch_out<ILR_IN_LENS>(*p, launch);
}
