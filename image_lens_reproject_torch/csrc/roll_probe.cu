// Probe kernel lane_roll: every tile of an (n, h, w) float32 tensor rolled
// left along its last axis by its own dynamic shift,
// out[t, r, j] = x[t, r, (j + sh[t]) mod w], for any int32 shift.
//
// It replaces the JAX package's lane-roll probe, K7 (bench/roll_probe.py,
// `build`, pallas_call at :49), which rolled each (80, 256) tile with
// pltpu.roll(x, w - sh, axis=lanes), the shift read by scalar prefetch.
//
// What bounds it on this card: bytes. Each element is read once and written
// once (336 MB at the probe's 2048 (80, 256) tiles), with no arithmetic but
// the index, so the design is a copy at the memory's rate:
// - The work is cut into units of kRows rows x 32 elements of one tile, a
//   warp a unit (10,240 CTAs at the probe's shape).
// - kVec (w % 4 == 0, x and out on 16-byte boundaries, chosen on the host):
//   an element is a float4. Lane l of a unit loads the aligned float4 that
//   holds its first value, (l + q) mod w/4 with q = sh / 4, as one streaming
//   16-byte load (__ldcs: each byte is read once); the kRows rows' loads are
//   in flight together. Its other values lie in the next float4, which lane
//   l + 1 loaded: one __shfl_down_sync a component brings it over, and only
//   the lane with no right-hand neighbour in its row (lane 31, a row's last
//   float4) loads it itself, so device memory and L2 see each byte once.
//   Selects by sh mod 4 (warp-uniform, no branch) funnel the two float4s
//   into the output's, stored with one streaming 16-byte store (__stcs).
// - Otherwise (the general instance): an element is a float, each lane
//   loads its value at (j + sh) mod w and stores it, 4 bytes at a time.
// On an H100 80GB HBM3 at 700 W, at the probe's shape, in turns
// (tools/b1_breakdown.py --probes): 0.116 ms, 98 % of the card's own copy
// of the same bytes (out.copy_(x), 0.1135 ms), against the first design
// (a CTA of 256 threads a block of 8 rows, 4-byte loads and stores) 0.180
// ms.
// Units of 1, 2 and 8 rows took the same to within 1 %. Tried and slower,
// each at a persistent grid of 4 CTAs an SM where this kernel took
// 0.118-0.120 ms: two float4 loads a lane through L1 in place of the
// shuffle, +1.7 %; rows staged in shared memory by 16-byte cp.async in two
// stages, then read rotated, +5.7 %; cached loads and stores in place of
// the streaming ones, +2.5 %. The persistent grids themselves (4, 8, 16
// CTAs an SM) were 3-7 % slower than a warp a unit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows of a unit: a lane's loads in flight together
constexpr unsigned kFullMask = 0xffffffffu;

// (a, b)[i + m] for i < 4: the four floats that start m into a, m in 0..3,
// by selects (two halvings of the shift).
__device__ __forceinline__ float4 funnel(float4 a, float4 b, int m) {
    const bool two = m & 2, one = m & 1;
    const float c0 = two ? a.z : a.x, c1 = two ? a.w : a.y, c2 = two ? b.x : a.z,
                c3 = two ? b.y : a.w, c4 = two ? b.z : b.x;
    return make_float4(one ? c1 : c0, one ? c2 : c1, one ? c3 : c2, one ? c4 : c3);
}

__device__ __forceinline__ float4 shfl_down(float4 v) {
    return make_float4(__shfl_down_sync(kFullMask, v.x, 1), __shfl_down_sync(kFullMask, v.y, 1),
                       __shfl_down_sync(kFullMask, v.z, 1), __shfl_down_sync(kFullMask, v.w, 1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
lane_roll(const float* __restrict__ x, const int32_t* __restrict__ shifts, int n, int h, int w,
          float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int cols = kVec ? w / 4 : w;          // a row's elements: float4s or floats
    const int segs = (cols + 31) / 32;          // a row's units across
    const int blocks = (h + kRows - 1) / kRows;  // a tile's units down
    const int units = n * blocks * segs;        // below 2**31: the wrapper checks
    // One unit a warp; counted in 64 bits, as the last CTA's warps pass `units`.
    const long long unit = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (unit >= units) return;
    const int u = (int)unit;
    const int tb = u / segs;
    const int t = tb / blocks;
    const int r0 = (tb - t * blocks) * kRows;
    const int rows = min(kRows, h - r0);
    const int j = (u - tb * segs) * 32 + lane;  // the lane's output element
    const bool on = j < cols;
    int sh = __ldg(shifts + t) % w;
    if (sh < 0) sh += w;
    const size_t base = ((size_t)t * h + r0) * cols;
    if constexpr (kVec) {
        const int m = sh & 3;
        int from = j + (sh >> 2);
        if (from >= cols) from -= cols;
        const int next = from + 1 == cols ? 0 : from + 1;
        const bool own = lane == 31 || j + 1 >= cols;  // no right-hand lane holds `next`
        const float4* src = reinterpret_cast<const float4*>(x) + base;
        float4* dst = reinterpret_cast<float4*>(out) + base;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 a[kRows], b[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            a[k] = on && k < rows ? __ldcs(src + (size_t)k * cols + from) : zero;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            b[k] = on && own && m && k < rows ? __ldcs(src + (size_t)k * cols + next) : zero;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const float4 right = shfl_down(a[k]);
            const float4 v = funnel(a[k], own ? b[k] : right, m);
            if (on && k < rows) __stcs(dst + (size_t)k * cols + j, v);
        }
    } else {
        int from = j + sh;  // below 2 w, which the wrapper keeps to 2**31
        if (from >= w) from -= w;
        float v[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            v[k] = on && k < rows ? __ldcs(x + base + (size_t)k * w + from) : 0.f;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            if (on && k < rows) __stcs(out + base + (size_t)k * w + j, v[k]);
    }
}

}  // namespace

extern "C" {

// Launches lane_roll on `stream` of `device`: `x` and `out` (n, h, w)
// float32, `shifts` (n,) int32, all device pointers; `vec` picks the
// float4 instance (w % 4 == 0 and x, out 16-byte aligned). Returns
// cudaGetLastError() after the launch.
int ilr_lane_roll(const float* x, const int32_t* shifts, int n, int h, int w, int vec,
                  float* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || h <= 0 || w <= 0) return 0;
    if (vec && w % 4) return (int)cudaErrorInvalidValue;
    const long long segs = ((vec ? w / 4 : w) + 31) / 32;
    const long long units = (long long)n * ((h + kRows - 1) / kRows) * segs;
    if (units >= (1ll << 31) || w > (1 << 30)) return (int)cudaErrorInvalidValue;
    const unsigned ctas = (unsigned)((units + kWarps - 1) / kWarps);
    if (vec) {
        lane_roll<true><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(x, shifts, n, h, w, out);
    } else {
        lane_roll<false><<<ctas, kThreads, 0, (cudaStream_t)stream>>>(x, shifts, n, h, w, out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
