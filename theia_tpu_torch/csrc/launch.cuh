// Programmatic dependent launches (Hopper's griddepcontrol) for kernels that
// follow one another in a stream: a kernel launched by pdl::launch may be
// scheduled before the kernel ahead of it in the stream has finished, so
// its launch overlaps that kernel's tail; its blocks call wait_for_previous
// before their first device-memory access, which returns once that kernel
// has completed and its writes are visible, so no order that a plain launch
// gives is lost. No kernel here triggers its dependents early
// (griddepcontrol.launch_dependents): measured on the records and the sort,
// an early trigger let waiting blocks crowd the running kernel and was
// slower than none.

#pragma once

#include <cuda_runtime.h>

namespace pdl {

__device__ __forceinline__ void wait_for_previous() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace pdl
