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
// One tile per CTA of 128 threads, 32 floats a thread, so 4 chains x 16
// ops a trip give the warp scheduler independent work. The layout depends
// on the class:
// - fma, select, sublane_gather, lane_gather: thread j keeps column j's 8
//   values of each chain. fma and select stay in the thread.
//   sublane_gather moves each value through shared memory: the thread
//   stores its column's 8 rows of a chain at [chain][row][j] and loads row
//   k mod 8 back for each row, one 4-byte store and one 4-byte load an
//   element, free of bank conflicts (lane j reads bank j whatever the row)
//   and with no barrier (a thread reads only what it wrote): shared
//   memory's 128 bytes a clock, 7/8 of the bound's 7 selects at the float32
//   rate. A select tree in registers compiles to integer-pipe instructions,
//   issued at half that rate: 11.6 an element (5 selects, 2 levels as bit
//   selects, the 24 key-bit predicates rebuilt at every op, 7 predicate
//   registers being too few), or 7 byte permutes with loop-invariant
//   selectors; they reach 27 % and 42 % of the bound (PERF.md).
//   lane_gather permutes 128 lanes across 4 warps: all 4 chains
//   go through shared memory, one store, a barrier and one load a value,
//   in two buffers used in turn so that one barrier an op suffices; 37 j
//   mod 128, the probe's permutation, hits 32 distinct banks in every warp.
// - lane_roll: warp c keeps chain c of the whole tile, lane l columns l,
//   l + 32, l + 64 and l + 96 of the 8 rows. A roll by one lane is one
//   __shfl_sync from lane l - 1 (mod 32) an element, lane 31 sending its
//   previous column register (one select) so that lane 0 receives column
//   32m - 1. No roll crosses a warp, so there is no barrier an op; the
//   chains are summed through shared memory once, at the end. Holding
//   neighbouring columns in one thread would need fewer exchanges, but
//   then the probe would price register renaming, not a lane exchange.
//
// What bounds it on this card: operations, one SM's issue rate for the op
// class, or shared memory's and the shuffle unit's 32 lanes a clock for
// the lane classes. To fill the card the caller launches `copies`
// identical tiles; the probe reports ns per tile-op per SM from the
// difference of two trip counts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;
constexpr int kChains = 4;
constexpr int kUnroll = 16;
constexpr int kWarp = 32;
constexpr int kCols = kLanes / kWarp;  // columns a lane holds in lane_roll's layout
constexpr unsigned kFullMask = 0xffffffffu;

enum OpClass { kFma = 0, kSelect = 1, kLaneRoll = 2, kSublaneGather = 3, kLaneGather = 4 };

// lane_roll's layout: v[r][m] holds column kWarp * m + lane of chain
// threadIdx.x / kWarp. Returns after writing out[tile].
__device__ __forceinline__ void roll_chains(const float* __restrict__ x, int iters,
                                            float* __restrict__ out, size_t tile,
                                            float (&ex)[kChains][kRows][kLanes]) {
    const int lane = threadIdx.x % kWarp;
    const int c = threadIdx.x / kWarp;
    const int from = (lane + kWarp - 1) % kWarp;
    const bool last = lane == kWarp - 1;
    float v[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int m = 0; m < kCols; ++m)
            v[r][m] = x[tile + r * kLanes + m * kWarp + lane] + (float)c;
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                float send[kCols];
#pragma unroll
                for (int m = 0; m < kCols; ++m)
                    send[m] = last ? v[r][(m + kCols - 1) % kCols] : v[r][m];
#pragma unroll
                for (int m = 0; m < kCols; ++m) v[r][m] = __shfl_sync(kFullMask, send[m], from);
            }
        }
        const float fold = (float)i * 1e-30f;
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int m = 0; m < kCols; ++m) v[r][m] = v[r][m] + fold;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int m = 0; m < kCols; ++m) ex[c][r][m * kWarp + lane] = v[r][m];
    __syncthreads();
    const int j = threadIdx.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        out[tile + r * kLanes + j] = ((ex[0][r][j] + ex[1][r][j]) + ex[2][r][j]) + ex[3][r][j];
    }
}

template <int OP>
__global__ void __launch_bounds__(kLanes)
op_cost(const float* __restrict__ x, const int32_t* __restrict__ idx, int iters,
        float* __restrict__ out) {
    // lane_gather: two buffers used in turn; sublane_gather and lane_roll's
    // final sum: the first.
    __shared__ float ex[OP == kLaneGather ? 2 : 1][kChains][kRows][kLanes];
    const size_t tile = (size_t)blockIdx.x * kRows * kLanes;
    if constexpr (OP == kLaneRoll) {
        roll_chains(x, iters, out, tile, ex[0]);
        return;
    }
    const int j = threadIdx.x;
    float v[kChains][kRows];
    int key[kRows];
    bool keep[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const float xv = x[tile + r * kLanes + j];
        const int k = idx[tile + r * kLanes + j];
        keep[r] = k > 64;
        key[r] = OP == kSublaneGather ? (k & (kRows - 1)) : (k & (kLanes - 1));
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
                float (*e)[kRows][kLanes] = ex[0];
#pragma unroll
                for (int c = 0; c < kChains; ++c) {
#pragma unroll
                    for (int r = 0; r < kRows; ++r) e[c][r][j] = v[c][r];
#pragma unroll
                    for (int r = 0; r < kRows; ++r) v[c][r] = e[c][key[r]][j];
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
