// Kernel B1's full frame for one input lens: the instances of remap_frame
// whose input lens is ILR_IN_LENS (a LensCode), for every output lens,
// sampler and specialisation (75 x 6 instances in all, 90 a lens). The
// build compiles this file once for each input lens, in parallel
// (ops/cuda/remap_kernel.py::SOURCES), and links the five objects with
// remap_kernel.cu, whose ilr_remap_frame calls ilr_remap_frame_in<lens>.
// The kernel and its design are described in remap_kernel.cu.

#include "remap_device.cuh"

#ifndef ILR_IN_LENS
#error "compile with -DILR_IN_LENS=<LensCode of the input lens>"
#endif

#define ILR_PASTE2(a, b) a##b
#define ILR_PASTE(a, b) ILR_PASTE2(a, b)

namespace {

// One thread per output pixel, 32 x 8 threads a block; each thread computes
// its pixel of every image of the batch.
template <int IN, int OUT, int INTERP, int CH, int NS>
__global__ void __launch_bounds__(256)
remap_frame(const float* __restrict__ src, float* __restrict__ dst,
            const float* __restrict__ rotation, const RemapParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.out_w || y >= p.out_h) return;
    const int C = CH == kAnyChannels ? p.channels : CH;
    const long long out_image = (long long)p.out_h * p.out_w * C;
    float r[9];
    load_rotation(p, rotation, r);
    remap_pixel<IN, OUT, INTERP, CH, NS>(p, r, x, y, GlobalFetch<CH>(src, p), p.batch,
                                         dst + ((long long)y * p.out_w + x) * C, out_image);
}

}  // namespace

extern "C" int ILR_PASTE(ilr_remap_frame_in, ILR_IN_LENS)(const float* src, float* dst,
                                                            const float* rotation,
                                                            const RemapParams* p, void* stream) {
    const dim3 block(32, 8);
    const dim3 grid((p->out_w + block.x - 1) / block.x, (p->out_h + block.y - 1) / block.y);
    auto launch = [&](auto in, auto out, auto interp) {
        return dispatch_spec(*p, [&](auto channels, auto samples) {
            remap_frame<decltype(in)::value, decltype(out)::value, decltype(interp)::value,
                        decltype(channels)::value, decltype(samples)::value>
                <<<grid, block, 0, (cudaStream_t)stream>>>(src, dst, rotation, *p);
            return (int)cudaGetLastError();
        });
    };
    return dispatch_out<ILR_IN_LENS>(*p, launch);
}
