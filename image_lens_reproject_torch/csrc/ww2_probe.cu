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
// One CTA of 128 x 8 threads per sub-tile: stage the window with
// cooperative coalesced loads, a barrier, then one pixel a thread, its
// 2 * taps weights and two indices loaded coalesced, its channels x taps^2
// taps read from shared memory.
//
// What bounds it on this card: bytes. Per pixel it reads 2 + 2 * taps
// values and writes `channels`; the window is a small share, and the
// arithmetic (3 operations a tap) is far below the card's rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;
constexpr int kRows = 8;
constexpr int kPixels = kRows * kCols;

template <int TAPS>
__global__ void __launch_bounds__(kPixels)
window_gather(const float* __restrict__ win, const int32_t* __restrict__ y0,
              const int32_t* __restrict__ x0, const float* __restrict__ wx,
              const float* __restrict__ wy, int n_sub, int rows, int cols, int channels,
              float* __restrict__ out) {
    extern __shared__ float window[];
    const int s = blockIdx.x;
    const int tid = threadIdx.y * kCols + threadIdx.x;
    const int total = rows * cols;
    const float* w_s = win + (size_t)s * total;
    for (int i = tid; i < total; i += kPixels) window[i] = __ldg(w_s + i);
    __syncthreads();

    const size_t plane = (size_t)n_sub * kPixels;  // one tap's or channel's (n_sub, 8, 128)
    const size_t pix = (size_t)s * kPixels + tid;
    const long long yy = y0[pix];
    const long long xx = x0[pix];
    float a[TAPS], b[TAPS];
    int row[TAPS];
#pragma unroll
    for (int m = 0; m < TAPS; ++m) {
        a[m] = wx[m * plane + pix];
        b[m] = wy[m * plane + pix];
        row[m] = (int)min(max(yy + m, 0ll), (long long)rows - 1) * cols;
    }
    for (int c = 0; c < channels; ++c) {
        int col[TAPS];
#pragma unroll
        for (int m = 0; m < TAPS; ++m) {
            col[m] = (int)min(max((xx + m) * channels + c, 0ll), (long long)cols - 1);
        }
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < TAPS; ++n) {
#pragma unroll
            for (int m = 0; m < TAPS; ++m) acc = acc + window[row[n] + col[m]] * (a[m] * b[n]);
        }
        out[c * plane + pix] = acc;
    }
}

template <int TAPS>
int launch(const float* win, const int32_t* y0, const int32_t* x0, const float* wx,
           const float* wy, int n_sub, int rows, int cols, int channels, float* out,
           cudaStream_t stream) {
    auto kernel = window_gather<TAPS>;
    const int smem = rows * cols * (int)sizeof(float);
    // Above 48 KB a block gets dynamic shared memory only after this opt-in.
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<n_sub, dim3(kCols, kRows), smem, stream>>>(win, y0, x0, wx, wy, n_sub, rows, cols,
                                                         channels, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches window_gather on `stream` of `device`: `win` (n_sub, rows, cols)
// float32, `y0` and `x0` (n_sub, 8, 128) int32, `wx` and `wy` (taps, n_sub,
// 8, 128) float32 with taps 2 (bilinear) or 4 (bicubic), `out` (channels,
// n_sub, 8, 128) float32, all device pointers; rows * cols * 4 bytes of
// shared memory.
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
