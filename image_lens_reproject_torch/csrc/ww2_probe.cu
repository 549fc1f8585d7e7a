// Probe kernel window_gather: a windowed tap gather, the inner step of a
// kernel that reads each pixel's taps from a source window staged in
// shared memory (kernel B2's rescue windows).
//
// For n_sub sub-tiles of 8 x 128 pixels, each with its window
// win[s] (rows, cols) float32 holding `channels` interleaved channels:
//   out[c, s, r, p] = sum over n < taps, m < taps of
//       (wx[m, s, r, p] * wy[n, s, r, p]) *
//       win[s, clamp(y0 + n, 0, rows - 1), clamp((x0 + m) * channels + c, 0, cols - 1)]
// with (y0, x0) = (y0[s, r, p], x0[s, r, p]), summed from 0 in the order
// n outer, m inner.
//
// It replaces both pallas_calls of the JAX package's two-step gather probe,
// K8 (bench/ww2_probe.py: `run_case`, pallas_call at :121, and
// `run_drift_case`, at :201). The TPU needed the two-step factorisation (a
// lane gather per window row, then a sublane gather per output row), and
// the +-1 drift correction, because its gathers index lanes per selecting
// row. A Hopper thread reads its own pixel's taps from shared memory, so on
// the inputs the probe admits (x0 the same on a sub-tile's 8 rows, or
// drifting by at most 1) one kernel computes what both do.
//
// What bounds it on this card: bytes. Per pixel it reads 2 + 2 * taps
// values and writes `channels`; the window is a small share, and the
// arithmetic (3 operations a tap) is far below the card's rate. Its taps,
// taps^2 * channels shared-memory loads a pixel at addresses the data
// picks, come next: about 3 of the 32 lanes of a random load meet in one
// bank.
//
// Design: one CTA of 256 threads a sub-tile, 4 neighbouring pixels a
// thread. The CTA stages its window with 16-byte cp.async from the 16-byte
// aligned floor below it and reads it at that shift, so every base and
// size takes the same path. Every thread issues its pixels' 16-byte loads
// (y0, x0, wx, wy) before the window is waited for, sums from shared
// memory (each tap's weight product computed where it is used, so that 3
// CTAs fit an SM), and stores each channel's 4 pixels with one 16-byte
// store. Indices are 32-bit: the wrapper checks that they fit, and the
// origins are clamped first to a range where the clamp of every tap is
// unchanged. On an H100 80GB HBM3 at 700 W, at the probe's timed shape,
// persistent CTAs that kept 1-3 windows in flight ahead of their sums (a
// producer warp beside 8 consumer warps, full / empty mbarriers a stage)
// took 0.1927 ms against 0.1898 ms for one CTA a sub-tile, the 8100 CTAs
// overlapping one another's staging as well; one bulk copy a window
// (cp.async.bulk on an mbarrier) in place of the cp.async took the same
// time within 1 %, faster in some calls and slower in others.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// --- asynchronous copies into shared memory --------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `p`'s distance in floats above the 16-byte aligned address below it.
__device__ __forceinline__ int floor_shift(const float* p) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

constexpr int kPixels = 8 * 128;
constexpr int kThreads = kPixels / 4;  // 4 neighbouring pixels a thread

// a * b rounded once (as -fmad=false rounds it), computed where it is used:
// kept across the channel loop, a pixel's taps^2 weight products (64
// registers for 4 pixels) made the kernel spill at 2 CTAs an SM.
__device__ __forceinline__ float product(float a, float b) {
    float p;
    asm volatile("mul.rn.f32 %0, %1, %2;\n" : "=f"(p) : "f"(a), "f"(b));
    return p;
}

template <int TAPS>
__global__ void __launch_bounds__(kThreads, 3)
window_gather(const float* __restrict__ win, const int32_t* __restrict__ y0,
              const int32_t* __restrict__ x0, const float* __restrict__ wx,
              const float* __restrict__ wy, int n_sub, int rows, int cols, int channels,
              float* __restrict__ out) {
    extern __shared__ __align__(16) float window[];  // 16-byte copies land in it
    const int s = blockIdx.x;
    const int total = rows * cols;
    const float* src = win + s * total;
    const int plane = n_sub * kPixels;  // one tap's or channel's (n_sub, 8, 128)
    const int pix = s * kPixels + 4 * threadIdx.x;

    // The pixels' loads first: they do not wait for the window.
    const int4 yv = __ldg(reinterpret_cast<const int4*>(y0 + pix));
    const int4 xv = __ldg(reinterpret_cast<const int4*>(x0 + pix));
    float a[TAPS][4], b[TAPS][4];
#pragma unroll
    for (int m = 0; m < TAPS; ++m) {
        const float4 va = __ldg(reinterpret_cast<const float4*>(wx + m * plane + pix));
        const float4 vb = __ldg(reinterpret_cast<const float4*>(wy + m * plane + pix));
        a[m][0] = va.x, a[m][1] = va.y, a[m][2] = va.z, a[m][3] = va.w;
        b[m][0] = vb.x, b[m][1] = vb.y, b[m][2] = vb.z, b[m][3] = vb.w;
    }
    const int shift = floor_shift(src);
    const float* base = src - shift;
    const int chunks = (shift + total + 3) >> 2;
    for (int q = threadIdx.x; q < chunks; q += kThreads) cp_async16(window + 4 * q, base + 4 * q);
    cp_async_wait_all();
    __syncthreads();  // every thread's copies landed
    const float* w = window + shift;

    // Origins clamped where every tap's clamp stays the same: y0 + n below 0
    // or above rows - 1 for every n, (x0 + m) * channels + c below 0 or
    // above cols - 1 for every m and c.
    const int yy[4] = {min(max(yv.x, -TAPS), rows), min(max(yv.y, -TAPS), rows),
                       min(max(yv.z, -TAPS), rows), min(max(yv.w, -TAPS), rows)};
    const int xx[4] = {min(max(xv.x, -TAPS - 1), cols), min(max(xv.y, -TAPS - 1), cols),
                       min(max(xv.z, -TAPS - 1), cols), min(max(xv.w, -TAPS - 1), cols)};
    for (int c = 0; c < channels; ++c) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int col[TAPS];
#pragma unroll
            for (int m = 0; m < TAPS; ++m) col[m] = min(max((xx[j] + m) * channels + c, 0), cols - 1);
            float acc = 0.0f;
#pragma unroll
            for (int n = 0; n < TAPS; ++n) {
                const int row = min(max(yy[j] + n, 0), rows - 1) * cols;
#pragma unroll
                for (int m = 0; m < TAPS; ++m) {
                    acc = acc + w[row + col[m]] * product(a[m][j], b[n][j]);
                }
            }
            o[j] = acc;
        }
        *reinterpret_cast<float4*>(out + c * plane + pix) = make_float4(o[0], o[1], o[2], o[3]);
    }
}

template <int TAPS>
int launch(const float* win, const int32_t* y0, const int32_t* x0, const float* wx,
           const float* wy, int n_sub, int rows, int cols, int channels, float* out,
           cudaStream_t stream) {
    auto kernel = window_gather<TAPS>;
    // Up to 3 floats of shift, in 16-byte chunks.
    const int smem = ((rows * cols + 6) & ~3) * (int)sizeof(float);
    // Above 48 KB a block gets dynamic shared memory only after this opt-in.
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_sub, kThreads, smem, stream>>>(win, y0, x0, wx, wy, n_sub, rows, cols, channels,
                                              out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches window_gather on `stream` of `device`: `win` (n_sub, rows, cols)
// float32, `y0` and `x0` (n_sub, 8, 128) int32, `wx` and `wy` (taps, n_sub,
// 8, 128) float32 with taps 2 (bilinear) or 4 (bicubic), `out` (channels,
// n_sub, 8, 128) float32, all device pointers, every one but `win` 16-byte
// aligned. Every index must fit 32 bits (the wrapper checks).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// another tap count).
int ilr_window_gather(const float* win, const int32_t* y0, const int32_t* x0, const float* wx,
                      const float* wy, int n_sub, int rows, int cols, int taps, int channels,
                      float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_sub <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (taps) {
        case 2: return launch<2>(win, y0, x0, wx, wy, n_sub, rows, cols, channels, out, s);
        case 4: return launch<4>(win, y0, x0, wx, wy, n_sub, rows, cols, channels, out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
