// Device functions shared by kernel B1 (remap_kernel.cu: full frame and
// list mode) and kernel B2 (rescue_kernel.cu: windowed sub-tiles).
//
// They compute, for one output pixel, what the plain path computes for it:
// ops/remap.py::remap_batch over models/projections.py and ops/sampling.py,
// then ops/color.py::post_process. Every function mirrors its plain
// counterpart operation for operation and in the same order, quirks
// included (fisheye z = +cos(theta), the non-unit equirect ray, the signed
// zero at the equirect seam, the unguarded /(-z), the centre guards written
// as selects), so that with -fmad=false and the same libm the kernels give
// the plain path's float32 values bit for bit.
//
// The lens on either side and the sampler are template parameters: every
// kernel is instantiated for each of the 5 x 5 lens pairs and 3 samplers,
// and the host picks the instance from RemapParams' codes
// (dispatch_kernel). Switching on the lens codes at run time instead cost
// about 20 % at the headline on an H100 (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// Lens and sampler codes; mirrored by LENS_CODES and INTERP_CODES in
// ops/cuda/remap_kernel.py.
enum LensCode : int32_t {
    kRectilinear = 0,
    kEquidistant = 1,
    kEquisolid = 2,
    kStereographic = 3,
    kEquirectangular = 4,
};
enum InterpCode : int32_t { kNearest = 0, kBilinear = 1, kBicubic = 2 };

// Mirrored field for field by RemapParams in ops/cuda/remap_kernel.py.
// Every float is rounded to float32 once on the host from a double
// expression, as the plain path's _f32(expr) constants are. The meaning of
// out_k (the output lens, pixel -> ray) and in_k (the input lens, ray ->
// source pixel) depends on the lens code; see to_vec and to_source.
struct RemapParams {
    int32_t batch, in_h, in_w, channels, out_h, out_w;
    int32_t n_samples, wrap, has_rotation, tonemap;
    int32_t out_lens, in_lens, interp;
    float out_half_w, out_half_h;  // f32(out_w * 0.5), f32(out_h * 0.5)
    float in_half_w, in_half_h;    // f32(in_w * 0.5), f32(in_h * 0.5)
    float normalize;               // f32(1 / n^2)
    float exposure, inv_max2;      // f32(exposure), f32(1 / reinhard^2)
    float out_k[6];
    float in_k[6];
};

// Output sub-tile of the list modes: the unit of the JAX package's rescue
// lists (remap_kernel.py's 8-row sub-tiles of 128-lane tiles).
constexpr int kTileH = 8;
constexpr int kTileW = 128;
// A list-mode CTA: 128 x 2 threads, each computing 4 rows of its column.
constexpr int kListThreadsY = 2;

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

// clamp(v, lo, hi) that passes NaN through, as torch.clamp does (fminf and
// fmaxf alone would drop it).
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
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

// Pixel -> ray of the output lens (models/projections.py::*_to_vec).
template <int LENS>
__device__ __forceinline__ void to_vec(const float k[6], float cx, float cy, float& x, float& y,
                                       float& z) {
    if constexpr (LENS == kRectilinear) {
        // k: sw/(w f), sh/(h f)
        x = cx * k[0];
        y = cy * k[1];
        z = -1.0f;
    } else if constexpr (LENS == kEquirectangular) {
        // k: 1/w, lon span, lon min, 1/h, lat span, lat min
        const float lon = (cx * k[0] + 0.5f) * k[1] + k[2];
        const float lat = (cy * k[3] + 0.5f) * k[4] + k[5];
        x = sinf(lon);
        y = sinf(lat);
        z = -cosf(lon);
    } else {
        const float r_px = sqrtf(cx * cx + cy * cy);
        float theta, centre;
        if constexpr (LENS == kEquidistant) {
            // k: fov/w (theta scale and centre slope)
            theta = r_px * k[0];
            centre = k[0];
        } else {
            // k: sw/w, 1/(2 f), sw/(f w)
            const float r_mm = r_px * k[0];
            if constexpr (LENS == kEquisolid) {
                theta = 2.0f * asinf(clamp_nan(r_mm * k[1], -1.0f, 1.0f));
            } else {  // kStereographic
                theta = 2.0f * atanf(r_mm * k[1]);
            }
            centre = k[2];
        }
        const float safe_r = r_px > 0.0f ? r_px : 1.0f;
        const float q = sinf(theta) / safe_r;
        const float s = r_px > 0.0f ? q : centre;
        x = s * cx;
        y = s * cy;
        z = cosf(theta);
    }
}

// Ray -> centred source pixel of the input lens
// (models/projections.py::vec_to_*).
template <int LENS>
__device__ __forceinline__ void to_source(const float k[6], float x, float y, float z, float& sx,
                                          float& sy) {
    if constexpr (LENS == kEquirectangular) {
        // k: lon min, 1/lon span, w, lat min, 1/lat span, h.
        // atan2f keeps the sign of a -0.0 first argument: x = +0.0 at the
        // seam takes the -pi branch, as the plain path does.
        const float theta = -atan2f(-x, -z);
        const float phi = asinf(y / sqrtf(x * x + y * y + z * z));
        sx = ((theta - k[0]) * k[1] - 0.5f) * k[2];
        sy = ((phi - k[3]) * k[4] - 0.5f) * k[5];
    } else {
        const float xn = x / -z;
        const float yn = y / -z;
        if constexpr (LENS == kRectilinear) {
            // k: w f/sw, h f/sh
            sx = xn * k[0];
            sy = yn * k[1];
        } else {
            const float r = sqrtf(xn * xn + yn * yn);
            const float theta = atanf(r);
            float r_px;
            if constexpr (LENS == kEquidistant) {
                // k: w/fov (radius scale and centre slope)
                r_px = theta * k[0];
            } else if constexpr (LENS == kEquisolid) {
                // k: 2 f, w/sw, f w/sw
                r_px = (k[0] * sinf(0.5f * theta)) * k[1];
            } else {  // kStereographic, same constants
                r_px = (k[0] * tanf(0.5f * theta)) * k[1];
            }
            const float safe_r = r > 0.0f ? r : 1.0f;
            const float q = r_px / safe_r;
            const float scale = r > 0.0f ? q : (LENS == kEquidistant ? k[0] : k[2]);
            sx = xn * scale;
            sy = yn * scale;
        }
    }
}

// Output-pixel-centred (cx, cy) -> top-left-aligned source (sx, sy):
// ops/remap.py::source_coords.
template <int IN, int OUT>
__device__ __forceinline__ void source_coord(const RemapParams& p, const float r[9], float cx,
                                             float cy, float& sx, float& sy) {
    float vx, vy, vz;
    to_vec<OUT>(p.out_k, cx, cy, vx, vy, vz);
    if (p.has_rotation) {
        const float nx = r[0] * vx + r[1] * vy + r[2] * vz;
        const float ny = r[3] * vx + r[4] * vy + r[5] * vz;
        const float nz = r[6] * vx + r[7] * vy + r[8] * vz;
        vx = nx;
        vy = ny;
        vz = nz;
    }
    float ex, ey;
    to_source<IN>(p.in_k, vx, vy, vz, ex, ey);
    sx = (ex - 0.5f) + p.in_half_w;
    sy = (ey - 0.5f) + p.in_half_h;
}

// Taps of one axis (ops/sampling.py::x_taps / y_taps): indices after wrap
// or clamp, and the fraction the weights are made from.
template <int INTERP>
struct Taps {
    static constexpr int K = INTERP == kNearest ? 1 : (INTERP == kBilinear ? 2 : 4);
    int idx[K];
    float frac;
};

template <int INTERP>
__device__ __forceinline__ float tap_offset(int k) {
    return INTERP == kNearest ? 0.5f : (INTERP == kBilinear ? (float)k : (float)(k - 1));
}

template <int INTERP>
__device__ __forceinline__ Taps<INTERP> axis_taps(float s, int size, bool wrap) {
    Taps<INTERP> t;
#pragma unroll
    for (int k = 0; k < Taps<INTERP>::K; ++k) {
        const int i = trunc_i32(s + tap_offset<INTERP>(k));
        t.idx[k] = wrap ? wrap_w(i, size) : clamp_i(i, size - 1);
    }
    // Measured against the already wrapped or clamped low tap: idx[0] for
    // bilinear, idx[1] for bicubic; nearest has no weights.
    if constexpr (INTERP == kNearest) {
        t.frac = 0.0f;
    } else {
        t.frac = clamp_nan(s - (float)t.idx[INTERP == kBicubic ? 1 : 0], 0.0f, 1.0f);
    }
    return t;
}

// One channel sampled at one source coordinate
// (ops/sampling.py::sample_nearest / sample_bilinear / sample_bicubic, in
// their combine order). fetch(yi, xi, c) returns source texel (yi, xi, c).
template <int INTERP, class Fetch>
__device__ __forceinline__ float sample(const Taps<INTERP>& tx, const Taps<INTERP>& ty,
                                        const float wx[4], const float wy[4],
                                        const Fetch& fetch, int c) {
    if constexpr (INTERP == kNearest) {
        return fetch(ty.idx[0], tx.idx[0], c);
    } else if constexpr (INTERP == kBilinear) {
        const float fx = tx.frac;
        const float fy = ty.frac;
        const float ll = fetch(ty.idx[0], tx.idx[0], c);
        const float lu = fetch(ty.idx[0], tx.idx[1], c);
        const float ul = fetch(ty.idx[1], tx.idx[0], c);
        const float uu = fetch(ty.idx[1], tx.idx[1], c);
        const float lo = fx * lu + (1.0f - fx) * ll;
        const float up = fx * uu + (1.0f - fx) * ul;
        return fy * up + (1.0f - fy) * lo;
    } else {
        // The x-weighted sum along a row, times wy, summed over rows.
        float v = 0.0f;
#pragma unroll
        for (int yi = 0; yi < 4; ++yi) {
            float rs = fetch(ty.idx[yi], tx.idx[0], c) * wx[0];
#pragma unroll
            for (int xi = 1; xi < 4; ++xi) rs = rs + fetch(ty.idx[yi], tx.idx[xi], c) * wx[xi];
            rs = rs * wy[yi];
            v = yi == 0 ? rs : v + rs;
        }
        return v;
    }
}

// Output pixel (x, y) of one image: n x n supersampling (offsets x outer,
// y inner, summed, times 1/n^2), then exposure and extended Reinhard on the
// first three channels; written to out[0 .. C).
template <int IN, int OUT, int INTERP, class Fetch>
__device__ __forceinline__ void remap_pixel(const RemapParams& p, const float r[9], int x, int y,
                                            const Fetch& fetch, float* __restrict__ out) {
    const int C = p.channels;
    const int n = p.n_samples;
    const float cx = ((float)x + 0.5f) - p.out_half_w;
    const float cy = ((float)y + 0.5f) - p.out_half_h;

    for (int c0 = 0; c0 < C; c0 += kChannelsPerPass) {
        float acc[kChannelsPerPass];
        for (int si = 0; si < n; ++si) {
            const float ox = supersample_offset(si, n);
            for (int sj = 0; sj < n; ++sj) {
                const float oy = supersample_offset(sj, n);
                float sx, sy;
                source_coord<IN, OUT>(p, r, cx + ox, cy + oy, sx, sy);
                const Taps<INTERP> tx = axis_taps<INTERP>(sx, p.in_w, p.wrap != 0);
                const Taps<INTERP> ty = axis_taps<INTERP>(sy, p.in_h, false);
                float wx[4], wy[4];
                if constexpr (INTERP == kBicubic) {
                    cubic_weights(tx.frac, wx);
                    cubic_weights(ty.frac, wy);
                }
#pragma unroll
                for (int k = 0; k < kChannelsPerPass; ++k) {
                    const int c = c0 + k;
                    if (c >= C) break;
                    const float v = sample<INTERP>(tx, ty, wx, wy, fetch, c);
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

// Taps read straight from the (H, W, C) source image in global memory.
struct GlobalFetch {
    const float* img;
    int in_w, channels;
    __device__ __forceinline__ float operator()(int yi, int xi, int c) const {
        return __ldg(img + ((size_t)yi * in_w + xi) * channels + c);
    }
};

__device__ __forceinline__ void load_rotation(const RemapParams& p, const float* rotation,
                                              float r[9]) {
    if (p.has_rotation) {
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = __ldg(rotation + i);
    }
}

// Calls launch(lens_in, lens_out, interp), three std::integral_constant
// values, for the kernel instance of p's lens codes and sampler: a generic
// lambda that launches a kernel templated on <IN, OUT, INTERP>.
template <int IN, int OUT, class Launch>
inline int dispatch_interp(int interp, Launch& launch) {
    using std::integral_constant;
    switch (interp) {
        case kNearest:
            return launch(integral_constant<int, IN>(), integral_constant<int, OUT>(),
                          integral_constant<int, kNearest>());
        case kBilinear:
            return launch(integral_constant<int, IN>(), integral_constant<int, OUT>(),
                          integral_constant<int, kBilinear>());
        case kBicubic:
            return launch(integral_constant<int, IN>(), integral_constant<int, OUT>(),
                          integral_constant<int, kBicubic>());
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int IN, class Launch>
inline int dispatch_out(const RemapParams& p, Launch& launch) {
    switch (p.out_lens) {
        case kRectilinear: return dispatch_interp<IN, kRectilinear>(p.interp, launch);
        case kEquidistant: return dispatch_interp<IN, kEquidistant>(p.interp, launch);
        case kEquisolid: return dispatch_interp<IN, kEquisolid>(p.interp, launch);
        case kStereographic: return dispatch_interp<IN, kStereographic>(p.interp, launch);
        case kEquirectangular: return dispatch_interp<IN, kEquirectangular>(p.interp, launch);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <class Launch>
inline int dispatch_kernel(const RemapParams& p, Launch&& launch) {
    switch (p.in_lens) {
        case kRectilinear: return dispatch_out<kRectilinear>(p, launch);
        case kEquidistant: return dispatch_out<kEquidistant>(p, launch);
        case kEquisolid: return dispatch_out<kEquisolid>(p, launch);
        case kStereographic: return dispatch_out<kStereographic>(p, launch);
        case kEquirectangular: return dispatch_out<kEquirectangular>(p, launch);
        default: return (int)cudaErrorInvalidValue;
    }
}
