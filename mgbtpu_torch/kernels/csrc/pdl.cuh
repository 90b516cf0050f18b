// Programmatic dependent launch (Hopper, sm_90): a kernel launched by
// launch_pdl may be scheduled while the kernel before it on the stream is
// still running, so the two launches' latencies overlap. Such a kernel calls
// pdl_wait() before it touches device memory (it returns once the kernel
// before it has finished and its writes are visible), and pdl_trigger() to
// let the next kernel on the stream be scheduled early. A kernel before
// which nothing is launched this way runs exactly as with <<<>>>.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ void pdl_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename... Params, typename... Args>
static inline cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid,
                                     dim3 block, size_t smem,
                                     cudaStream_t stream, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}
