// Probe kernel op_cost<OP>: the cost of one class of tile operation on an
// SM, the ops a windowed kernel body is made of.
//
// For each (8, 128) float32 tile t of x, with its int32 index tile idx[t]:
// kChains = 4 independent chains start at x[t] + c (c = 0..3); each trip i
// of `iters` applies the op kUnroll = 16 times to every chain and then adds
// float(i) * 1e-30 (so no trip can be hoisted); out[t] is the sum of the
// chains, ((v0 + v1) + v2) + v3. The op classes, with k = idx[t, r, j]:
//   fma            v * 1.000001f + 0.5f (a multiply and an add, each
//                  rounded: the library is built with -fmad=false, which is
//                  what the plain version's two operations compute)
//   select         k > 64 ? v : v + 1
//   lane_roll      v[r, j] <- v[r, (j - 1) mod 128]
//   sublane_gather v[r, j] <- v[k mod 8, j]
//   lane_gather    v[r, j] <- v[r, k mod 128]
//
// It replaces the JAX package's per-op cost probe, K6
// (bench/gather_cost_probe.py, `make_kernel`, pallas_call at :96), which
// timed the same chains on one (8, 128) vreg tile of a TPU core.
//
// One tile per CTA of 128 threads; thread j keeps column j's 8 values of
// each chain in registers (32 floats), so 4 chains x 16 ops a trip give the
// warp scheduler independent work. fma and select stay in the thread.
// sublane_gather picks among the thread's 8 registers with a select tree on
// the bits of k mod 8 (7 selects a value, no local-memory array).
// lane_roll and lane_gather cross warps (a permutation of 128 lanes), so
// __shfl_sync alone cannot do them: all 4 chains go through shared memory,
// one store, a barrier and one load a value, in two buffers used in turn so
// that one barrier an op suffices. 37 j mod 128, the probe's permutation,
// hits 32 distinct banks in every warp.
//
// What bounds it on this card: operations, one SM's issue rate for the op
// class. To fill the card the caller launches `copies` identical tiles; the
// probe reports ns per tile-op per SM from the difference of two trip
// counts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kChains = 4;
constexpr int kUnroll = 16;

enum OpClass { kFma = 0, kSelect = 1, kLaneRoll = 2, kSublaneGather = 3, kLaneGather = 4 };

// v[k] for k in [0, 8), from registers: three levels of selects.
__device__ __forceinline__ float pick8(const float (&v)[kRows], int k) {
    const bool b0 = k & 1, b1 = k & 2, b2 = k & 4;
    const float a0 = b0 ? v[1] : v[0];
    const float a1 = b0 ? v[3] : v[2];
    const float a2 = b0 ? v[5] : v[4];
    const float a3 = b0 ? v[7] : v[6];
    const float c0 = b1 ? a1 : a0;
    const float c1 = b1 ? a3 : a2;
    return b2 ? c1 : c0;
}

template <int OP>
__global__ void __launch_bounds__(kLanes)
op_cost(const float* __restrict__ x, const int32_t* __restrict__ idx, int iters,
        float* __restrict__ out) {
    __shared__ float ex[2][kChains][kRows][kLanes];  // lane exchanges only
    const int j = threadIdx.x;
    const size_t tile = (size_t)blockIdx.x * kRows * kLanes;
    float v[kChains][kRows];
    int key[kRows];
    bool keep[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const float xv = x[tile + r * kLanes + j];
        const int k = idx[tile + r * kLanes + j];
        keep[r] = k > 64;
        key[r] = OP == kSublaneGather ? (k & (kRows - 1))
                 : OP == kLaneRoll    ? ((j + kLanes - 1) & (kLanes - 1))
                                      : (k & (kLanes - 1));
#pragma unroll
        for (int c = 0; c < kChains; ++c) v[c][r] = xv + (float)c;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if constexpr (OP == kFma) {
#pragma unroll
                for (int c = 0; c < kChains; ++c)
#pragma unroll
                    for (int r = 0; r < kRows; ++r) v[c][r] = v[c][r] * 1.000001f + 0.5f;
            } else if constexpr (OP == kSelect) {
#pragma unroll
                for (int c = 0; c < kChains; ++c)
#pragma unroll
                    for (int r = 0; r < kRows; ++r) v[c][r] = keep[r] ? v[c][r] : v[c][r] + 1.0f;
            } else if constexpr (OP == kSublaneGather) {
#pragma unroll
                for (int c = 0; c < kChains; ++c) {
                    float g[kRows];
#pragma unroll
                    for (int r = 0; r < kRows; ++r) g[r] = pick8(v[c], key[r]);
#pragma unroll
                    for (int r = 0; r < kRows; ++r) v[c][r] = g[r];
                }
            } else {
                // kUnroll is even, so buffer u & 1 alternates across trips too.
                float (*e)[kRows][kLanes] = ex[u & 1];
#pragma unroll
                for (int c = 0; c < kChains; ++c)
#pragma unroll
                    for (int r = 0; r < kRows; ++r) e[c][r][j] = v[c][r];
                __syncthreads();
#pragma unroll
                for (int c = 0; c < kChains; ++c)
#pragma unroll
                    for (int r = 0; r < kRows; ++r) v[c][r] = e[c][r][key[r]];
            }
        }
        const float fold = (float)i * 1e-30f;
#pragma unroll
        for (int c = 0; c < kChains; ++c)
#pragma unroll
            for (int r = 0; r < kRows; ++r) v[c][r] = v[c][r] + fold;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        out[tile + r * kLanes + j] = ((v[0][r] + v[1][r]) + v[2][r]) + v[3][r];
    }
}

template <int OP>
int launch(const float* x, const int32_t* idx, int n, int iters, float* out, cudaStream_t s) {
    op_cost<OP><<<n, kLanes, 0, s>>>(x, idx, iters, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches op_cost<op> on `stream` of `device` over n tiles: `x` and `out`
// (n, 8, 128) float32, `idx` (n, 8, 128) int32, all device pointers; `op`
// in 0..4 (fma, select, lane_roll, sublane_gather, lane_gather). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another op).
int ilr_op_cost(const float* x, const int32_t* idx, int n, int op, int iters, float* out,
                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (op) {
        case kFma: return launch<kFma>(x, idx, n, iters, out, s);
        case kSelect: return launch<kSelect>(x, idx, n, iters, out, s);
        case kLaneRoll: return launch<kLaneRoll>(x, idx, n, iters, out, s);
        case kSublaneGather: return launch<kSublaneGather>(x, idx, n, iters, out, s);
        case kLaneGather: return launch<kLaneGather>(x, idx, n, iters, out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
