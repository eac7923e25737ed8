// What the fused step kernel's grid sync costs on the card: a cooperative
// launch of `nsteps` empty steps, each a counter add a block and a barrier
// (what fused_steps_kernel does at a step with no tile left, csrc/
// fused_fourstep.cu), with a grid sync between two steps. Timing launches
// of 1, 2 and 4 steps gives one sync's cost as the slope (python -m
// ntt_aie_tpu_torch.scripts.fused_turns --sync, which builds this file).
// Not part of the package: no plan launches it.

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;  // csrc/fused_fourstep.cu kThreads
constexpr int kMaxSteps = 8;

__global__ void __launch_bounds__(kThreads)
    empty_steps_kernel(int* counters, int nsteps) {
  __shared__ int slot;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int k = 1; k < nsteps; ++k) atomicExch(counters + k, 0);
  for (int k = 0; k < nsteps; ++k) {
    if (k > 0) {
      cooperative_groups::this_grid().sync();
      if (k == 1 && blockIdx.x == 0 && threadIdx.x == 0)
        atomicExch(counters, 0);
    }
    if (threadIdx.x == 0) slot = atomicAdd(counters + k, 1);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches nsteps (1 .. 8) empty steps over `grid` blocks of 256 threads,
// cooperatively, on `stream`. counters: nsteps int32 on the device.
// Returns 0 when launched, else a cudaError_t.
int grid_sync_steps(int* counters, int nsteps, int grid, void* stream) {
  if (!counters || nsteps < 1 || nsteps > kMaxSteps || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&counters, &nsteps};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(empty_steps_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* grid_sync_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
