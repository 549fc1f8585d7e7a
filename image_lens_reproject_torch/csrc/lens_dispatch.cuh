// Host code of the C entry points of kernels B1 (remap_kernel.cu) and B2
// (rescue_kernel.cu): the pick of the input lens's launcher. Kept out of
// remap_device.cuh, which the kernels' own units compile, so that those
// units' text does not change with it.

#pragma once

#include "remap_device.cuh"

// Calls the launcher of `fns` (one a LensCode, in its order: each input
// lens's unit of remap_frame.cu or rescue_windows.cu exports its own) for
// p's input lens with `args`; cudaErrorInvalidValue for another code.
template <class... Params, class... Args>
inline int by_in_lens(const RemapParams* p, int (*const (&fns)[5])(Params...), Args... args) {
    if (p->in_lens < kRectilinear || p->in_lens > kEquirectangular) {
        return (int)cudaErrorInvalidValue;
    }
    return fns[p->in_lens](args...);
}
