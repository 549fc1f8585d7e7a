// Probe kernels: a 16 x 128 window of a float32 source fetched at a
// dynamic offset into shared memory with cp.async, once per tile
// (window_copy) or as a double-buffered scan of n_steps windows
// (window_scan_db).
//
// They replace the JAX package's DMA probes (bench/dma_probe.py):
// - window_copy: K4, `build` (pallas_call at bench/dma_probe.py:69),
//   out[t] = 2 * src[r0 : r0+16, c0 : c0+128] with (r0, c0) = offs[t];
// - window_scan_db: K5, `build_db` (pallas_call at :133),
//   out[t] = sum over s < n_steps of src[r0+8s : +16, c0+128s : +128],
//   summed from 0 in the order s = 0, 1, ..., with the copy of step s+1
//   issued before step s is summed.
// A window's start below 0 counts from the end, as Python indexing does,
// and is then clamped so that the window lies inside the source, as the TPU
// kernels' interpret mode reads it; the probe's tables lie inside.
//
// One CTA of 256 threads per tile reads its own (r0, c0) from the table
// (Hopper has no scalar prefetch). Each thread issues 4-byte cp.async
// copies of 8 of the window's 2048 floats, neighbouring threads on
// neighbouring columns: c0 need not be a multiple of 4 (the probe sets
// (8, 5) and (16, 129) on purpose), so the 16-byte form does not apply.
// Then cp.async.commit_group / wait_group, a barrier, and a coalesced store.
// window_scan_db keeps two shared-memory stages: step s+1's copy is
// committed before step s is waited for (wait_group 1) and summed.
//
// What bounds it on this card: bytes. A tile writes 8 KB and reads 8 KB a
// step from a 2 MB source that stays in the 50 MB L2, so the output stream
// to device memory is the floor; at the probe's 2048 tiles the latency of
// one window round trip per CTA (two stages in flight for the scan) and the
// launch itself weigh as much. The design keeps one small CTA per tile so
// that many windows are in flight on every SM at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWinH = 16;
constexpr int kWinW = 128;
constexpr int kWin = kWinH * kWinW;
constexpr int kThreads = 256;
constexpr int kPerThread = kWin / kThreads;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues and commits the copy of the window at (r, c), moved into the
// (h, w) source, into `win`.
__device__ __forceinline__ void fetch(const float* __restrict__ src, int h, int w, int r, int c,
                                      float* win) {
    r = min(max(r < 0 ? r + h : r, 0), h - kWinH);
    c = min(max(c < 0 ? c + w : c, 0), w - kWinW);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int e = threadIdx.x + k * kThreads;
        cp_async4(win + e, src + (size_t)(r + e / kWinW) * w + c + e % kWinW);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
window_copy(const float* __restrict__ src, int h, int w, const int32_t* __restrict__ offs,
            float* __restrict__ out) {
    __shared__ float win[kWin];
    const int t = blockIdx.x;
    fetch(src, h, w, offs[2 * t], offs[2 * t + 1], win);
    cp_async_wait<0>();
    __syncthreads();
    float* o = out + (size_t)t * kWin;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int e = threadIdx.x + k * kThreads;
        o[e] = win[e] * 2.0f;
    }
}

__global__ void __launch_bounds__(kThreads)
window_scan_db(const float* __restrict__ src, int h, int w, const int32_t* __restrict__ offs,
               int n_steps, float* __restrict__ out) {
    __shared__ float win[2][kWin];
    const int t = blockIdx.x;
    const int r0 = offs[2 * t];
    const int c0 = offs[2 * t + 1];
    float acc[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;
    fetch(src, h, w, r0, c0, win[0]);
    for (int s = 0; s < n_steps; ++s) {
        if (s + 1 < n_steps) {
            fetch(src, h, w, r0 + 8 * (s + 1), c0 + kWinW * (s + 1), win[(s + 1) & 1]);
            cp_async_wait<1>();  // step s landed; step s+1 stays in flight
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* cur = win[s & 1];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) acc[k] = acc[k] + cur[threadIdx.x + k * kThreads];
        __syncthreads();  // every thread has read this stage before step s+2 refills it
    }
    float* o = out + (size_t)t * kWin;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) o[threadIdx.x + k * kThreads] = acc[k];
}

}  // namespace

extern "C" {

// Launches window_copy on `stream` of `device`: `src` (h, w) float32 with
// h >= 16 and w >= 128, `offs` (n_tiles, 2) int32, `out` (n_tiles, 16, 128)
// float32, all device pointers. Returns cudaGetLastError() after the launch.
int ilr_window_copy(const float* src, int h, int w, const int32_t* offs, int n_tiles, float* out,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles <= 0) return 0;
    window_copy<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(src, h, w, offs, out);
    return (int)cudaGetLastError();
}

// Launches window_scan_db (n_steps >= 1); otherwise as ilr_window_copy.
int ilr_window_scan_db(const float* src, int h, int w, const int32_t* offs, int n_tiles,
                       int n_steps, float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles <= 0) return 0;
    window_scan_db<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(src, h, w, offs, n_steps, out);
    return (int)cudaGetLastError();
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
