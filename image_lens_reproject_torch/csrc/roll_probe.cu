// Probe kernel lane_roll: every tile of an (n, h, w) float32 tensor rolled
// left along its last axis by its own dynamic shift,
// out[t, r, j] = x[t, r, (j + sh[t]) mod w].
//
// It replaces the JAX package's lane-roll probe, K7 (bench/roll_probe.py,
// `build`, pallas_call at :49), which rolled each (80, 256) tile with
// pltpu.roll(x, w - sh, axis=lanes), the shift read by scalar prefetch.
//
// A CTA of 256 threads covers kRows rows of one tile (grid (n, rows / kRows));
// each thread reads the tile's shift itself, then for each of its columns j
// loads x[t, r, (j + sh) mod w] and stores out[t, r, j]. Neighbouring threads
// load neighbouring addresses (one wrap per row at most) and store
// neighbouring addresses, so both streams are coalesced; the kRows loads of
// a column are independent and in flight together.
//
// What bounds it on this card: bytes. Each element is read once and written
// once (336 MB at the probe's 2048 (80, 256) tiles), with no arithmetic but
// the index.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kThreads)
lane_roll(const float* __restrict__ x, const int32_t* __restrict__ shifts, int h, int w,
          float* __restrict__ out) {
    const int t = blockIdx.x;
    int sh = shifts[t] % w;
    if (sh < 0) sh += w;
    const int r0 = blockIdx.y * kRows;
    const size_t base = ((size_t)t * h + r0) * w;
    for (int j = threadIdx.x; j < w; j += kThreads) {
        int from = j + sh;
        if (from >= w) from -= w;
        float v[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            if (r0 + k < h) v[k] = __ldg(x + base + (size_t)k * w + from);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            if (r0 + k < h) out[base + (size_t)k * w + j] = v[k];
        }
    }
}

}  // namespace

extern "C" {

// Launches lane_roll on `stream` of `device`: `x` and `out` (n, h, w)
// float32, `shifts` (n,) int32, all device pointers. Returns
// cudaGetLastError() after the launch.
int ilr_lane_roll(const float* x, const int32_t* shifts, int n, int h, int w, float* out,
                  int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || h <= 0 || w <= 0) return 0;
    const dim3 grid(n, (h + kRows - 1) / kRows);
    lane_roll<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, shifts, h, w, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
