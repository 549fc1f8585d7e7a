// Device functions shared by kernel B1 (remap_kernel.cu and remap_frame.cu:
// full frame, view and list mode) and kernel B2 (rescue_kernel.cu and
// rescue_windows.cu: windowed sub-tiles).
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
// and the host picks the instance from RemapParams' codes (the input lens's
// unit, then dispatch_out). Switching on the lens codes at run time
// instead cost about 20 % at the headline on an H100 (PERF.md). Kernels B1
// (full frame, list and view mode) and B2 are also specialised on the channel
// count and the supersample count (dispatch_spec): work that a run-time
// count cannot unroll or fold.
//
// A pixel's coordinates, taps and weights are computed once for all the
// images of a launch (remap_pixel loops over them), and each tap hands the
// sampler one texel offset, with the channels read at fixed offsets from it
// (the Fetch interface: image, texel, read).
//
// The coordinate field (B1's frame and band, remap_frame.cu): a pixel's
// source coordinate (sx, sy) depends only on the lenses' constants, the
// sizes, the band and the rotation, never on the images. coord_field
// writes source_coord's (sx, sy) of every pixel of a band as a float2, 8
// bytes an output pixel (66 MB at the 3840 x 2160 headline), and the read
// instances (remap_frame<IN, kFromField, ...>) load that float2 in place of
// source_coord, then locate_at and sample_images as the frame does: the
// same float32 bits, so the same output. The launch wrapper
// (ops/cuda/remap_kernel.py) keeps fields per configuration under a byte
// cap (FIELD_CACHE_BYTES), fills one at the second call of a configuration
// and samples from it at every later one; list mode, view mode, kernel
// B2, n x n supersampling and a rotation on the card never use one.

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
// Not a lens: the output-lens argument of B1's read instances, whose
// coordinates come from a coordinate field (remap_frame.cu).
constexpr int kFromField = 5;
// How the rotation reaches a kernel (RemapParams::has_rotation), mirrored by
// NO_ROTATION, ROTATION_BY_VALUE and ROTATION_ON_DEVICE in
// ops/cuda/remap_kernel.py: none, by value in RemapParams::rotation (a
// rotation the caller holds on the host), or through the kernel's device
// pointer (a rotation on the card).
enum RotationCode : int32_t { kNoRotation = 0, kRotationByValue = 1, kRotationOnDevice = 2 };

// Specialisation codes (RemapParams::spec_channels / spec_samples), picked
// by ops/cuda/remap_kernel.py::specialisation from the shapes: the channel
// count when it is 3 or 4 (offsets inside an image in 32 bits, which the
// wrapper allows only where in_h * in_w * C < 2^31; for 4, one 16-byte
// load a tap from a 16-byte aligned source), else any (64-bit offsets);
// one supersample, else any.
constexpr int kAnyChannels = 0;
constexpr int kAnySamples = 0;

// Supersample offsets carried in RemapParams; a larger n computes the rest.
constexpr int kMaxOffsets = 16;
// Rotations carried in RemapParams, a row-major 3x3 a view: B1's view mode
// takes a stack of up to this many by value (blockIdx.z the view); mirrored
// by MAX_VIEWS_BY_VALUE in ops/cuda/remap_kernel.py.
constexpr int kMaxViewsByValue = 16;

// Mirrored field for field by RemapParams in ops/cuda/remap_kernel.py.
// Every float is rounded to float32 once on the host from a double
// expression, as the plain path's _f32(expr) constants are. The meaning of
// out_k (the output lens, pixel -> ray) and in_k (the input lens, ray ->
// source pixel) depends on the lens code; see to_vec and to_source.
// row0 and band_rows are the band mode of the full frame, of list mode
// (remap_frame.cu) and of kernel B2 (rescue_windows.cu): rows
// [row0, row0 + band_rows) of the out_h x out_w frame, the band's row k at
// row k of the output; the full frame is row0 = 0, band_rows = out_h.
// rotation is read when has_rotation is kRotationByValue: view v's matrix
// at rotation[9 * v] (one view outside view mode). Fields are only
// ever added at the end, so that an older kernel reading a prefix of this
// struct still finds its fields (tools/b1_breakdown.py --old).
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
    float offsets[kMaxOffsets];    // f32((s + 1) / (n + 1) - 0.5), s < min(n, kMaxOffsets)
    int32_t spec_channels, spec_samples;
    int32_t row0, band_rows;
    float rotation[9 * kMaxViewsByValue];  // row-major, the host's float32 values
};

// Output sub-tile of the list modes: the unit of the JAX package's rescue
// lists (remap_kernel.py's 8-row sub-tiles of 128-lane tiles).
constexpr int kTileH = 8;
constexpr int kTileW = 128;
// Kernel B2's CTA: 128 x 2 threads, each computing 4 rows of its column.
constexpr int kListThreadsY = 2;

// Channels sampled together when C is known only at run time.
constexpr int kChannelsPerPass = 4;

// C's (int) cast as the reference paths give it: truncate toward zero,
// saturate to the int32 range, NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int trunc_i32(float v) { return __float2int_rz(v); }

// (i + w) % w with the add in wrapping int32 arithmetic and a floor modulo,
// as ops/sampling.py::_wrap_w gives it. For i in [-w, 2w), which holds the
// taps of every finite coordinate of a full-360 input, that is one
// conditional add or subtract; the two run-time-divisor % (each a long
// integer sequence: the card has no divider) stay only for the rest, the
// saturated ints of non-finite coordinates.
__device__ __forceinline__ int wrap_w(int i, int w) {
    int j = i;
    if (j < 0) {
        j += w;
    } else if (j >= w) {
        j -= w;
    }
    if ((unsigned)j >= (unsigned)w) {
        j = (int)((unsigned)i + (unsigned)w);
        j = ((j % w) + w) % w;
    }
    return j;
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

// Stratified sub-pixel offset s of n (ops/remap.py::supersample_offsets):
// from RemapParams, where the host rounded it; past kMaxOffsets computed
// here the same way, in double and rounded once.
__device__ __forceinline__ float supersample_offset(const RemapParams& p, int s) {
    return s < kMaxOffsets ? p.offsets[s] : (float)((s + 1.0) / (p.n_samples + 1.0) - 0.5);
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
    if (p.has_rotation != kNoRotation) {
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

// Each tap is its own trunc(s + k): trunc(s) + k differs where s + k rounds.
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

// Where one supersample of a pixel reads: its taps on both axes and, for
// bicubic, the weights of each axis. The same for every image and channel.
template <int INTERP>
struct Located {
    Taps<INTERP> tx, ty;
    float wx[4], wy[4];
};

// The taps and weights of source coordinate (sx, sy).
template <int IN, int INTERP>
__device__ __forceinline__ Located<INTERP> locate_at(const RemapParams& p, float sx, float sy) {
    Located<INTERP> s;
    // Only a full-360 equirect input wraps (models/lens.py::wrap_mode_for_input).
    s.tx = axis_taps<INTERP>(sx, p.in_w, IN == kEquirectangular && p.wrap != 0);
    s.ty = axis_taps<INTERP>(sy, p.in_h, false);
    if constexpr (INTERP == kBicubic) {
        cubic_weights(s.tx.frac, s.wx);
        cubic_weights(s.ty.frac, s.wy);
    }
    return s;
}

template <int IN, int OUT, int INTERP>
__device__ __forceinline__ Located<INTERP> locate(const RemapParams& p, const float r[9], float cx,
                                                  float cy) {
    float sx, sy;
    source_coord<IN, OUT>(p, r, cx, cy, sx, sy);
    return locate_at<IN, INTERP>(p, sx, sy);
}

// Channels c0 .. c0 + NC of one image sampled at a located supersample
// (ops/sampling.py::sample_nearest / sample_bilinear / sample_bicubic, in
// their combine order), those with k < nc only: nc is NC where the channel
// count is known, and the guards fold away. Each tap asks the fetch for its
// texel once; VEC4 reads the texel's 4 channels with one 16-byte load
// (GlobalFetch::read4).
template <int INTERP, int NC, bool VEC4, class Fetch>
__device__ __forceinline__ void sample_pass(const Located<INTERP>& s, const Fetch& fetch,
                                            const float* image, int c0, int nc, float v[NC]) {
    auto tap = [&](int yi, int xi, float t[NC]) {
        const float* texel = fetch.texel(image, s.ty.idx[yi], s.tx.idx[xi], nc);
        if constexpr (VEC4) {
            static_assert(NC == 4, "a 16-byte tap holds 4 channels");
            const float4 q = fetch.read4(texel);
            t[0] = q.x;
            t[1] = q.y;
            t[2] = q.z;
            t[3] = q.w;
        } else {
#pragma unroll
            for (int k = 0; k < NC; ++k) t[k] = k < nc ? fetch.read(texel, c0 + k) : 0.0f;
        }
    };
    if constexpr (INTERP == kNearest) {
        tap(0, 0, v);
    } else if constexpr (INTERP == kBilinear) {
        const float fx = s.tx.frac;
        const float fy = s.ty.frac;
        float ll[NC], lu[NC], ul[NC], uu[NC];
        tap(0, 0, ll);
        tap(0, 1, lu);
        tap(1, 0, ul);
        tap(1, 1, uu);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            const float lo = fx * lu[k] + (1.0f - fx) * ll[k];
            const float up = fx * uu[k] + (1.0f - fx) * ul[k];
            v[k] = fy * up + (1.0f - fy) * lo;
        }
    } else {
        // The x-weighted sum along a row, times wy, summed over rows.
#pragma unroll
        for (int yi = 0; yi < 4; ++yi) {
            float rs[NC], t[NC];
            tap(yi, 0, t);
#pragma unroll
            for (int k = 0; k < NC; ++k) rs[k] = t[k] * s.wx[0];
#pragma unroll
            for (int xi = 1; xi < 4; ++xi) {
                tap(yi, xi, t);
#pragma unroll
                for (int k = 0; k < NC; ++k) rs[k] = rs[k] + t[k] * s.wx[xi];
            }
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                rs[k] = rs[k] * s.wy[yi];
                v[k] = yi == 0 ? rs[k] : v[k] + rs[k];
            }
        }
    }
}

// Exposure and extended Reinhard on the first three channels
// (ops/color.py::post_process).
__device__ __forceinline__ float finish(const RemapParams& p, float v, int c) {
    if (p.tonemap && c < 3) {
        v = v * p.exposure;
        v = v * (1.0f + v * p.inv_max2) / (1.0f + v);
    }
    return v;
}

// The centred coordinate of output pixel (x, y) (ops/remap.py::pixel_centres).
__device__ __forceinline__ void pixel_centre(const RemapParams& p, int x, int y, float& cx,
                                             float& cy) {
    cx = ((float)x + 0.5f) - p.out_half_w;
    cy = ((float)y + 0.5f) - p.out_half_h;
}

// One supersample (n = 1), located at s, of `images` images: sampled, times
// 1/n^2, tonemapped and written to out + b * out_image for image b.
template <int INTERP, int CH, class Fetch>
__device__ __forceinline__ void sample_images(const RemapParams& p, const Located<INTERP>& s,
                                              const Fetch& fetch, int images,
                                              float* __restrict__ out, long long out_image) {
    constexpr int NC = CH == kAnyChannels ? kChannelsPerPass : CH;
    constexpr bool VEC4 = CH == 4;
    const int C = CH == kAnyChannels ? p.channels : CH;
    for (int b = 0; b < images; ++b) {
        const float* image = fetch.image(b);
        float* px = out + b * out_image;
        for (int c0 = 0; c0 < C; c0 += NC) {
            float v[NC];
            sample_pass<INTERP, NC, VEC4>(s, fetch, image, c0, min(NC, C - c0), v);
#pragma unroll
            for (int k = 0; k < NC; ++k) v[k] = finish(p, v[k] * p.normalize, c0 + k);
            if constexpr (VEC4) {
                *reinterpret_cast<float4*>(px) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int k = 0; k < NC; ++k) {
                    if (c0 + k < C) px[c0 + k] = v[k];
                }
            }
        }
    }
}

// Output pixel (x, y) of `images` images: n x n supersampling (offsets x
// outer, y inner, summed, times 1/n^2), then exposure and extended
// Reinhard on the first three channels. Image b's pixel is written to
// out + b * out_image. CH and NS are the specialisation: the channel count
// (3 or 4) or kAnyChannels, and 1 or kAnySamples.
//
// The coordinates, taps and weights of each supersample are computed once
// and serve every image. With one supersample each image's sums stay in
// registers; with n x n they are summed in the output pixel itself, which
// only this thread writes (float32 stores and loads are exact, so the sums
// are the plain path's), and the last supersample writes the finished
// value. Sums kept in registers for one image instead gained 9-11 % at
// batch 1 but cost batches 13-15 % in the same kernel, and as an instance
// of their own lost 2 % (a register spill) and doubled nvcc's time
// (PERF.md).
template <int IN, int OUT, int INTERP, int CH, int NS, class Fetch>
__device__ __forceinline__ void remap_pixel(const RemapParams& p, const float r[9], int x, int y,
                                            const Fetch& fetch, int images,
                                            float* __restrict__ out, long long out_image) {
    constexpr int NC = CH == kAnyChannels ? kChannelsPerPass : CH;
    constexpr bool VEC4 = CH == 4;
    const int C = CH == kAnyChannels ? p.channels : CH;
    float cx, cy;
    pixel_centre(p, x, y, cx, cy);

    if constexpr (NS == 1) {
        const float o = p.offsets[0];
        sample_images<INTERP, CH>(p, locate<IN, OUT, INTERP>(p, r, cx + o, cy + o), fetch, images,
                                  out, out_image);
    } else {
        const int n = p.n_samples;
        for (int si = 0; si < n; ++si) {
            const float ox = supersample_offset(p, si);
            for (int sj = 0; sj < n; ++sj) {
                const float oy = supersample_offset(p, sj);
                const Located<INTERP> s = locate<IN, OUT, INTERP>(p, r, cx + ox, cy + oy);
                const bool first = si == 0 && sj == 0;
                const bool last = si == n - 1 && sj == n - 1;
                for (int b = 0; b < images; ++b) {
                    const float* image = fetch.image(b);
                    float* px = out + b * out_image;
                    for (int c0 = 0; c0 < C; c0 += NC) {
                        float v[NC];
                        sample_pass<INTERP, NC, VEC4>(s, fetch, image, c0, min(NC, C - c0), v);
#pragma unroll
                        for (int k = 0; k < NC; ++k) {
                            const int c = c0 + k;
                            if (c >= C) break;
                            const float sum = first ? v[k] : px[c] + v[k];
                            px[c] = last ? finish(p, sum * p.normalize, c) : sum;
                        }
                    }
                }
            }
        }
    }
}

// Taps read straight from the (B, H, W, C) source in global memory. With
// CH known (3 or 4) the offsets inside an image are 32-bit; with
// kAnyChannels they are 64-bit. Image bases are 64-bit either way: b * H * W
// * C passes int32 for large 4K batches.
template <int CH>
struct GlobalFetch {
    using Offset = std::conditional_t<CH == kAnyChannels, long long, int>;
    const float* src;
    long long image_floats;
    Offset row;  // in_w * C
    int channels;

    __device__ __forceinline__ GlobalFetch(const float* s, const RemapParams& p)
        : src(s),
          image_floats((long long)p.in_h * p.in_w * p.channels),
          row((Offset)p.in_w * p.channels),
          channels(p.channels) {}

    __device__ __forceinline__ const float* image(int b) const { return src + b * image_floats; }
    // Texel (yi, xi) of an image: the address of its channel 0.
    __device__ __forceinline__ const float* texel(const float* img, int yi, int xi, int) const {
        const Offset c = CH == kAnyChannels ? channels : CH;
        return img + ((Offset)yi * row + (Offset)xi * c);
    }
    __device__ __forceinline__ float read(const float* texel, int c) const {
        return __ldg(texel + c);
    }
    // The 4 channels of a 16-byte aligned texel.
    __device__ __forceinline__ float4 read4(const float* texel) const {
        return __ldg(reinterpret_cast<const float4*>(texel));
    }
};

// source_coord's rotation, view `view`'s of a stack (0 for one rotation):
// from the launch constants, or through the device pointer `rotation`.
// Every thread of a launch takes the same branch.
__device__ __forceinline__ void load_rotation(const RemapParams& p, const float* rotation,
                                              float r[9], int view = 0) {
    if (p.has_rotation == kRotationByValue) {
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = p.rotation[9 * view + i];
    } else if (p.has_rotation == kRotationOnDevice) {
#pragma unroll
        for (int i = 0; i < 9; ++i) r[i] = __ldg(rotation + 9 * view + i);
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

// Calls launch(channels, samples), two std::integral_constant values, for
// p's specialisation codes.
template <class Launch>
inline int dispatch_spec(const RemapParams& p, Launch&& launch) {
    using std::integral_constant;
    auto samples = [&](auto channels) {
        switch (p.spec_samples) {
            case kAnySamples: return launch(channels, integral_constant<int, kAnySamples>());
            case 1: return launch(channels, integral_constant<int, 1>());
            default: return (int)cudaErrorInvalidValue;
        }
    };
    switch (p.spec_channels) {
        case kAnyChannels: return samples(integral_constant<int, kAnyChannels>());
        case 3: return samples(integral_constant<int, 3>());
        case 4: return samples(integral_constant<int, 4>());
        default: return (int)cudaErrorInvalidValue;
    }
}
