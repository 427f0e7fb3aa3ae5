// Occupancy variants of the fan-ablation kernels K5 and K7: the kernels of
// ablate.cu, included as they are, launched with unused dynamic shared
// memory in every block, so that at most `blocks` blocks fit an SM. A mode
// whose time falls as the SM holds more warps waits on latency that the
// warps hide; one whose time does not runs at issue rate.
//
// Built apart from the kernel library (its symbols would clash there) by
// scripts/ablate_occupancy.py, which runs the sweep.

#include "ablate.cu"

namespace {

// Dynamic shared memory a block that leaves room for at most `blocks`
// blocks an SM; 0 for blocks <= 0 (the kernel's own occupancy).
int padding(int blocks) {
  if (blocks <= 0) return 0;
  int dev, per_sm, reserved, per_block;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                         dev);
  cudaDeviceGetAttribute(&per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int pad = per_sm / blocks - reserved;
  return pad < per_block ? pad : per_block;
}

// launch_warps with the padding of `blocks`; *warps: the warps an SM holds
// at that padding, by the CUDA occupancy calculator. An invalid value
// where `kernel` is null.
template <typename K, typename... Args>
int launch_padded(K kernel, int blocks, int* warps, int B, int fan,
                  void* stream, Args... args) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int shmem = padding(blocks);
  const int threads = 32 * cmvs::kFanWarps;
  int resident = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      threads, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  *warps = resident * cmvs::kFanWarps;
  const long long probes = static_cast<long long>(B) * fan;
  kernel<<<static_cast<unsigned>((probes + cmvs::kFanWarps - 1) /
                                 cmvs::kFanWarps),
           threads, shmem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cmvs_fan_abl with at most `blocks` blocks an SM (0: as cmvs_fan_abl).
extern "C" int cmvs_occ_fan_abl(const void* atlas, int N, int H, int WA,
                                const void* tilemap, const void* geom,
                                void* out, int B, int T, int fan, int wsize,
                                int mode, int blocks, int* warps,
                                void* stream) {
  return launch_padded(k5_select(H, WA, T, wsize, mode), blocks, warps,
                       B, fan, stream, static_cast<const uint8_t*>(atlas), N,
                       H, WA, static_cast<const int*>(tilemap),
                       static_cast<const float*>(geom),
                       static_cast<float*>(out), B, T, fan, wsize,
                       /*sink=*/0);
}

// cmvs_moments_abl with at most `blocks` blocks an SM (0: as
// cmvs_moments_abl).
extern "C" int cmvs_occ_moments_abl(const void* atlas, int N, int H, int WA,
                                    const void* tilemap, const void* frames,
                                    void* out, int B, int T, int fan,
                                    int wsize, int ppv, int lead, int mode,
                                    int blocks, int* warps,
                                    void* stream) {
  return launch_padded(k7_select(H, WA, T, wsize, ppv, mode), blocks,
                       warps, B, fan, stream,
                       static_cast<const uint8_t*>(atlas), N, H, WA,
                       static_cast<const int*>(tilemap),
                       static_cast<const float*>(frames),
                       static_cast<float*>(out), B, T, fan, wsize, ppv, lead,
                       /*sink=*/0);
}
