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
// writes them into the existing (B, out_h, out_w, C) output in place. The
// lists and windows come from ops/plan.py, which takes them from the plain
// path's own coordinate and tap math on the card, with one texel of slack
// per side.
//
// One CTA per listed sub-tile and image (grid (n, B)), 128 x 2 threads:
// - stage the window (rows x cols x C float32, columns taken modulo W when
//   the input wraps) from global into dynamic shared memory with
//   cooperative loads, then __syncthreads();
// - compute the sub-tile's pixels with kernel B1's per-pixel code
//   (remap_device.cuh), every tap read from the window. The output is the
//   same float32 operations as B1's, so it equals B1's bit for bit.
// A tap outside its window is never read out of bounds: its index is
// clamped into the window and the read is counted in a device counter
// (`misses`), which the caller checks; the plan's windows make it 0.
//
// What bounds it: the per-pixel arithmetic it shares with B1 (issued
// instructions: B1's own bound, see remap_kernel.cu), plus the staging copy
// of rows x cols x C loads per CTA (at most the window budget of
// ops/plan.py), and every CTA reserves the largest window of its list,
// which caps the CTAs resident on an SM. In return the 4 to 16 taps a
// pixel are read from shared memory instead of through L1/L2. B2 runs B1's
// generic per-pixel path (channel and supersample counts from RemapParams),
// so B1's cuts of the per-pixel work (the wrap's one conditional add, the
// offsets rounded on the host, one window offset a tap) shrink it too.
// Windows sized per CTA and cp.async / TMA double buffering of the next
// window are later work.

#include "remap_device.cuh"

namespace {

struct Window {
    int row0, rows, col0, cols;
};

// Taps read from a window of the source staged in shared memory, one
// image's (remap_pixel's Fetch interface: image, texel, read). The window
// offset and the miss check are computed once a tap; a miss counts the
// tap's `nc` channel reads, as the plain version counts them.
struct WindowFetch {
    const float* win;  // (rows, cols, C)
    Window w;
    int in_w, channels;
    bool wrap;
    unsigned long long* misses;
    __device__ __forceinline__ const float* image(int) const { return win; }
    __device__ __forceinline__ const float* texel(const float* img, int yi, int xi, int nc) const {
        int ly = yi - w.row0;
        int lx = xi - w.col0;
        // Wrapped taps and window starts both lie in [0, in_w).
        if (wrap && lx < 0) lx += in_w;
        if ((unsigned)ly >= (unsigned)w.rows || (unsigned)lx >= (unsigned)w.cols) {
            atomicAdd(misses, (unsigned long long)nc);
            ly = clamp_i(ly, w.rows - 1);
            lx = clamp_i(lx, w.cols - 1);
        }
        return img + (ly * w.cols + lx) * channels;
    }
    __device__ __forceinline__ float read(const float* texel, int c) const { return texel[c]; }
};

// Cooperative copy of one window of `img` into shared memory, row-major
// (rows, cols, C). A wrapping window's columns run past in_w and continue
// at column 0; rows are clamped for memory safety only.
__device__ __forceinline__ void stage(const float* __restrict__ img, float* win, const Window& w,
                                      const RemapParams& p) {
    const int C = p.channels;
    const int line = w.cols * C;
    const int total = w.rows * line;
    const int step = blockDim.x * blockDim.y;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < total; i += step) {
        const int r = i / line;
        const int rem = i - r * line;
        const int lc = rem / C;
        const int ch = rem - lc * C;
        int gc = w.col0 + lc;
        if (gc >= p.in_w) gc -= p.in_w;
        const int gr = min(w.row0 + r, p.in_h - 1);
        win[i] = __ldg(img + ((size_t)gr * p.in_w + gc) * C + ch);
    }
}

// entries: n rows of (sub-tile row, sub-tile column, row0, rows, col0,
// cols), and in split mode a second window (row0, rows, col0, cols) for
// the right 8 x 64 half. grid (n, B); dynamic shared memory holds the
// largest window (pair) of the list. `split` is the same for every thread
// of a launch: a template parameter would double the instances to build.
template <int IN, int OUT, int INTERP>
__global__ void __launch_bounds__(kTileW * kListThreadsY)
remap_windows(const float* __restrict__ src, float* __restrict__ dst,
              const float* __restrict__ rotation, const int32_t* __restrict__ entries,
              const int split, const RemapParams p, unsigned long long* misses) {
    extern __shared__ float win[];
    const int32_t* e = entries + (size_t)blockIdx.x * (split ? 10 : 6);
    if (e[0] < 0 || e[1] < 0) return;  // the whole block: before any barrier
    const float* img = src + (size_t)blockIdx.y * p.in_h * p.in_w * p.channels;
    const Window left{e[2], e[3], e[4], e[5]};
    stage(img, win, left, p);
    Window right = left;
    float* win_right = win;
    if (split) {
        right = Window{e[6], e[7], e[8], e[9]};
        win_right = win + left.rows * left.cols * p.channels;
        stage(img, win_right, right, p);
    }
    __syncthreads();

    const int x = e[1] * kTileW + threadIdx.x;
    if (x >= p.out_w) return;
    const bool use_right = split && threadIdx.x >= kTileW / 2;
    const WindowFetch fetch{use_right ? win_right : win, use_right ? right : left, p.in_w,
                            p.channels, p.wrap != 0, misses};
    float r[9];
    load_rotation(p, rotation, r);
    const int y0 = e[0] * kTileH;
    for (int dy = threadIdx.y; dy < kTileH; dy += kListThreadsY) {
        const int y = y0 + dy;
        if (y >= p.out_h) break;
        float* out = dst + (((long long)blockIdx.y * p.out_h + y) * p.out_w + x) * p.channels;
        remap_pixel<IN, OUT, INTERP, kAnyChannels, kAnySamples>(p, r, x, y, fetch, 1, out, 0);
    }
}

template <int IN, int OUT, int INTERP>
int launch(const float* src, float* dst, const float* rotation, const int32_t* entries,
           int n_entries, int split, int smem_bytes, const RemapParams* p,
           unsigned long long* misses, cudaStream_t stream) {
    auto kernel = remap_windows<IN, OUT, INTERP>;
    // Above 48 KB a block gets dynamic shared memory only after this opt-in.
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(kTileW, kListThreadsY);
    const dim3 grid(n_entries, p->batch);
    kernel<<<grid, block, smem_bytes, stream>>>(src, dst, rotation, entries, split, *p, misses);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches B2 on `stream` of `device` over n_entries listed sub-tiles
// (`entries`, a device pointer to int32 rows of 6, or of 10 when `split`),
// writing into the existing output `dst` in place. smem_bytes is the
// largest window (pair) of the list in bytes; `misses` is a device pointer
// to one uint64 counter that out-of-window reads add to. Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int ilr_remap_windows(const float* src, float* dst, const float* rotation,
                      const int32_t* entries, int n_entries, int split, int smem_bytes,
                      const RemapParams* p, unsigned long long* misses, int device,
                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_entries <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    return dispatch_kernel(*p, [&](auto in, auto out, auto interp) {
        return launch<decltype(in)::value, decltype(out)::value, decltype(interp)::value>(
            src, dst, rotation, entries, n_entries, split, smem_bytes, p, misses, s);
    });
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ilr_params_size(void) { return (int)sizeof(RemapParams); }

}  // extern "C"
