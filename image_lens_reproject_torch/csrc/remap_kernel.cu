// Kernel B1: equirectangular -> rectilinear reprojection of a batch of HWC
// float32 images with bicubic sampling, n x n supersampling and the
// exposure / extended-Reinhard epilogue, in one launch.
//
// It replaces the JAX package's main Pallas tile kernel,
// image_lens_reproject_tpu/ops/pallas/remap_kernel.py::_make_kernel (the
// pallas_call at remap_kernel.py:2127, in all three of its bodies),
// together with the XLA epilogue ops/color.py::post_process that ran after
// it. Its plain version is this package's ops/remap.py::remap_batch followed
// by ops/color.py::post_process, and it computes the same float32
// operations in the same order:
//   pixel -> ray (rectilinear) -> rotate -> -atan2(-x, -z), asin(y / |v|)
//   -> source coordinate -> 4x4 taps (truncate toward zero, wrap or clamp)
//   -> x-weighted row sums, times wy, summed over rows -> sum over the
//   supersample offsets (x outer, y inner) -> times 1/n^2 -> tonemap.
// Built with -fmad=false so that no a*b+c is contracted into an FMA.
//
// What bounds it on an H100: not HBM bytes. A 4K frame (3840x1920 RGB in,
// 3840x2160 RGB out) reads about 88 MB and writes about 100 MB, some 60 us at
// 3.35 TB/s. Each output pixel issues 16 tap loads per channel, served
// mostly from L1/L2 because neighbouring threads sample neighbouring source
// texels, and the accurate libm atan2f/asinf/sqrtf and IEEE division (no
// --use_fast_math) go through long instruction sequences and the SFU. So the
// tap gathers and the transcendental math bound it. One thread per output
// pixel, a warp along a row, keeps the taps of a warp within a few cache
// lines. Staging the tile's source window in shared memory (TMA/cp.async)
// is left for a later change (ROADMAP B5): with direct loads there is no
// window, so nothing can overflow and the TPU's overflow cascade has no
// counterpart here.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Mirrored field for field by RemapParams in ops/cuda/remap_kernel.py.
// Every float is rounded to float32 once on the host from a double
// expression, as the JAX package's xp.float32(expr) constants are.
struct RemapParams {
    int32_t batch, in_h, in_w, channels, out_h, out_w;
    int32_t n_samples, wrap, has_rotation, tonemap;
    float out_half_w, out_half_h;  // f32(out_w * 0.5), f32(out_h * 0.5)
    float ray_fx, ray_fy;          // rectilinear pixel -> ray scale
    float lon_min, inv_lon_span, lat_min, inv_lat_span;
    float in_w_f, in_h_f;          // f32(in_w), f32(in_h)
    float in_half_w, in_half_h;    // f32(in_w * 0.5), f32(in_h * 0.5)
    float normalize;               // f32(1 / n^2)
    float exposure, inv_max2;      // f32(exposure), f32(1 / reinhard^2)
};

namespace {

constexpr int kChannelsPerPass = 4;

// C's (int) cast as the reference paths give it: truncate toward zero,
// saturate to the int32 range, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int trunc_i32(float v) { return __float2int_rz(v); }

// (i + w) % w with the add in wrapping int32 arithmetic and a floor modulo:
// C's % truncates, so fold the remainder back into [0, w).
__device__ __forceinline__ int wrap_w(int i, int w) {
    const int j = (int)((unsigned)i + (unsigned)w);
    return ((j % w) + w) % w;
}

__device__ __forceinline__ int clamp_i(int i, int hi) { return min(max(i, 0), hi); }

// clip(t, 0, 1) that passes NaN through, as jnp.clip and torch.clamp do
// (fminf/fmaxf alone would drop it).
__device__ __forceinline__ float clip01(float t) {
    return t != t ? t : fminf(fmaxf(t, 0.0f), 1.0f);
}

__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
    const float t2 = t * t;
    const float t3 = t2 * t;
    w[0] = 0.5f * (-t + 2.0f * t2 - t3);
    w[1] = 1.0f + 0.5f * (-5.0f * t2 + 3.0f * t3);
    w[2] = 0.5f * (t + 4.0f * t2 - 3.0f * t3);
    w[3] = 0.5f * (-t2 + t3);
}

// Stratified sub-pixel offset, computed in double and rounded once, as
// ops/remap.py::supersample_offsets does on the host.
__device__ __forceinline__ float supersample_offset(int ss, int n) {
    return (float)((ss + 1.0) / (n + 1.0) - 0.5);
}

// Output-pixel-centered (cx, cy) -> top-left-aligned source (sx, sy).
__device__ __forceinline__ void source_coord(const RemapParams& p, const float r[9],
                                             float cx, float cy, float& sx, float& sy) {
    float vx = cx * p.ray_fx;
    float vy = cy * p.ray_fy;
    float vz = -1.0f;
    if (p.has_rotation) {
        const float nx = r[0] * vx + r[1] * vy + r[2] * vz;
        const float ny = r[3] * vx + r[4] * vy + r[5] * vz;
        const float nz = r[6] * vx + r[7] * vy + r[8] * vz;
        vx = nx;
        vy = ny;
        vz = nz;
    }
    // atan2f keeps the sign of a -0.0 first argument: x = +0.0 at the
    // seam takes the -pi branch, as the reference paths do.
    const float theta = -atan2f(-vx, -vz);
    const float phi = asinf(vy / sqrtf(vx * vx + vy * vy + vz * vz));
    const float ex = ((theta - p.lon_min) * p.inv_lon_span - 0.5f) * p.in_w_f;
    const float ey = ((phi - p.lat_min) * p.inv_lat_span - 0.5f) * p.in_h_f;
    sx = (ex - 0.5f) + p.in_half_w;
    sy = (ey - 0.5f) + p.in_half_h;
}

__global__ void __launch_bounds__(256)
remap_equirect_rect_bicubic(const float* __restrict__ src, float* __restrict__ dst,
                            const float* __restrict__ rotation, const RemapParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.out_w || y >= p.out_h) return;
    const int C = p.channels;
    const int n = p.n_samples;
    // Per-image base pointers in 64-bit arithmetic: b*H*W*C passes int32
    // for large 4K batches.
    const float* img = src + (size_t)blockIdx.z * p.in_h * p.in_w * C;
    float* out = dst + (((size_t)blockIdx.z * p.out_h + y) * p.out_w + x) * C;

    float r[9];
    if (p.has_rotation) {
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = __ldg(rotation + i);
    }
    const float cx = ((float)x + 0.5f) - p.out_half_w;
    const float cy = ((float)y + 0.5f) - p.out_half_h;

    for (int c0 = 0; c0 < C; c0 += kChannelsPerPass) {
        float acc[kChannelsPerPass];
        for (int si = 0; si < n; ++si) {
            const float ox = supersample_offset(si, n);
            for (int sj = 0; sj < n; ++sj) {
                const float oy = supersample_offset(sj, n);
                float sx, sy;
                source_coord(p, r, cx + ox, cy + oy, sx, sy);

                size_t col[4], row[4];
                int xs1 = 0, ys1 = 0;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    int xi = trunc_i32(sx + (float)(k - 1));
                    xi = p.wrap ? wrap_w(xi, p.in_w) : clamp_i(xi, p.in_w - 1);
                    const int yi = clamp_i(trunc_i32(sy + (float)(k - 1)), p.in_h - 1);
                    if (k == 1) {
                        xs1 = xi;
                        ys1 = yi;
                    }
                    col[k] = (size_t)xi * C;
                    row[k] = (size_t)yi * p.in_w * C;
                }
                float wx[4], wy[4];
                cubic_weights(clip01(sx - (float)xs1), wx);
                cubic_weights(clip01(sy - (float)ys1), wy);

#pragma unroll
                for (int k = 0; k < kChannelsPerPass; ++k) {
                    const int c = c0 + k;
                    if (c >= C) break;
                    float v = 0.0f;
#pragma unroll
                    for (int yi = 0; yi < 4; ++yi) {
                        const float* line = img + row[yi] + c;
                        float rs = __ldg(line + col[0]) * wx[0];
#pragma unroll
                        for (int xi = 1; xi < 4; ++xi) rs = rs + __ldg(line + col[xi]) * wx[xi];
                        rs = rs * wy[yi];
                        v = yi == 0 ? rs : v + rs;
                    }
                    acc[k] = (si == 0 && sj == 0) ? v : acc[k] + v;
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kChannelsPerPass; ++k) {
            const int c = c0 + k;
            if (c >= C) break;
            float v = acc[k] * p.normalize;
            if (p.tonemap && c < 3) {
                v = v * p.exposure;
                v = v * (1.0f + v * p.inv_max2) / (1.0f + v);
            }
            out[c] = v;
        }
    }
}

}  // namespace

extern "C" {

// Launches B1 on `stream` of `device`. `rotation` is a device pointer to a
// row-major 3x3 float32 matrix, read only when p->has_rotation. Returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
int ilr_remap_equirect_rect_bicubic(const float* src, float* dst, const float* rotation,
                                    const RemapParams* p, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(32, 8);
    const dim3 grid((p->out_w + block.x - 1) / block.x, (p->out_h + block.y - 1) / block.y,
                    p->batch);
    remap_equirect_rect_bicubic<<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, *p);
    return (int)cudaGetLastError();
}

const char* ilr_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ilr_params_size(void) { return (int)sizeof(RemapParams); }

}  // extern "C"
