// Probe kernels: a 16 x 128 window of a float32 source fetched at a
// dynamic offset, once per tile into shared memory (window_copy), or as a
// scan of n_steps windows summed (window_scan_db).
//
// They replace the JAX package's DMA probes (bench/dma_probe.py):
// - window_copy: K4, `build` (pallas_call at bench/dma_probe.py:69),
//   out[t] = 2 * src[r0 : r0+16, c0 : c0+128] with (r0, c0) = offs[t];
// - window_scan_db: K5, `build_db` (pallas_call at :133),
//   out[t] = sum over s < n_steps of src[r0+8s : +16, c0+128s : +128],
//   summed from 0 in the order s = 0, 1, ..., later steps' loads in
//   flight while a step is summed.
// A window's start below 0 counts from the end, as Python indexing does,
// and is then clamped so that the window lies inside the source, as the TPU
// kernels' interpret mode reads it; the probe's tables lie inside.
//
// window_copy: one CTA of 256 threads per tile reads its own (r0, c0) from
// the table (Hopper has no scalar prefetch). Each thread issues 4-byte
// cp.async copies of 8 of the window's 2048 floats, neighbouring threads on
// neighbouring columns: c0 need not be a multiple of 4 (the probe sets
// (8, 5) and (16, 129) on purpose), so the 16-byte form does not apply.
// Then cp.async.commit_group / wait_group, a barrier, and a coalesced store.
//
// window_scan_db: one CTA a tile; each thread reads its 8 elements of the
// tile's windows straight into registers through L1 (__ldg), the loads of 4
// steps in flight at once, and stores its 8 sums. Each value of a window is
// used once, so staging it in shared memory buys no reuse, and without
// shared memory L1 keeps its whole 256 KB an SM for the windows that tiles
// on one SM share.
// On an H100 80GB HBM3 at 700 W, at the probe's timed shape (2048 tiles x 4
// steps), the earlier two-stage cp.async scan took 0.0148 ms; staged designs
// took longer: one producer warp issuing every copy for 8 consumer warps on
// mbarriers 0.0202 ms (one warp could not issue the copies fast enough), a
// ring of 4 stages a warp with 16-byte cp.async 0.0182 ms (0.0156 ms with
// the copies cached in L1), the same rings with a 1-d bulk copy
// (cp.async.bulk) a window row 0.0241 ms; these loads 0.0113 ms, whether
// one CTA takes a tile or persistent CTAs walk over them. So this scan
// prices reading the windows through L1, not staging them; the staged
// designs' times are the price of staging. A scan staged with the 2-d TMA
// load, at the probe's window origins, stopped with an illegal-instruction
// error; tools/tma_repro.py bisects that fault (PERF.md, section 7).
//
// What bounds them on this card: bytes. A tile writes 8 KB and reads 8 KB a
// step from a 2 MB source that stays in the 50 MB L2, so the output stream
// to device memory is the floor; the scan's reads of its windows from L2
// and L1 (n_steps times the output's bytes) come next.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWinH = 16;
constexpr int kWinW = 128;
constexpr int kWin = kWinH * kWinW;
constexpr int kRowStep = 8;  // rows the scan's window moves down a step
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

// --- window_scan_db ----------------------------------------------------------

// A window's first row or column: below 0 counts from the end, then clamped
// so that the window lies inside; 64-bit, as the plain version computes it.
__device__ __forceinline__ int window_start(long long first, int size, int win) {
    if (first < 0) first += size;
    return (int)min(max(first, 0ll), (long long)(size - win));
}

// One CTA of 256 threads a tile. A thread sums the same 8 elements of
// every window of its tile (rows threadIdx.x / 128 + 2k, column
// threadIdx.x % 128), read through L1 with __ldg, neighbouring threads on
// neighbouring columns; the step loop is unrolled by 4, so that 4 windows'
// loads are in flight at once.
__global__ void __launch_bounds__(kThreads)
window_scan_db(const float* __restrict__ src, int h, int w, const int32_t* __restrict__ offs,
               int n_steps, float* __restrict__ out) {
    const int t = blockIdx.x;
    const long long r0 = offs[2 * t], c0 = offs[2 * t + 1];
    const int row0 = threadIdx.x / kWinW;
    const int col = threadIdx.x % kWinW;
    float acc[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_steps; ++s) {
        const int r = window_start(r0 + (long long)kRowStep * s, h, kWinH);
        const int c = window_start(c0 + (long long)kWinW * s, w, kWinW);
        const float* p = src + (size_t)(r + row0) * w + c + col;
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
            acc[k] = acc[k] + __ldg(p + (size_t)(k * kThreads / kWinW) * w);
        }
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

// Launches window_scan_db (n_steps >= 1); otherwise as ilr_window_copy
// (cudaErrorInvalidValue for n_steps < 1).
int ilr_window_scan_db(const float* src, int h, int w, const int32_t* offs, int n_tiles,
                       int n_steps, float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n_tiles <= 0) return 0;
    if (n_steps < 1) return (int)cudaErrorInvalidValue;
    window_scan_db<<<n_tiles, kThreads, 0, (cudaStream_t)stream>>>(src, h, w, offs, n_steps, out);
    return (int)cudaGetLastError();
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
