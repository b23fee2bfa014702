// Persistent lanes: a grid that stays resident, and lanes that take their
// next item from a counter as soon as their current one ends.
//
// A launch of one thread per item leaves a warp's lanes idle from the
// moment each item ends until its longest item ends (a path's bounces,
// csrc/bounce.cuh).  Here the grid is as many blocks as fit on the card at
// once, and each lane loops: while its item runs it steps it; when it
// ends, the lane writes the result and takes the next index.  The indices
// come from one int counter in device memory, which the wrapper allocates
// and the C entry zeroes on the stream before the launch; a warp takes
// them for all of its idle lanes with one atomicAdd (__ballot_sync, then
// __popc for each lane's rank), so a warp stays full until the items run
// out.  Which lane runs which item, and in which order, changes no item's
// result.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <algorithm>

namespace gopbrt {

constexpr unsigned FULL_MASK = 0xffffffffu;

// Called by every lane of the warp at once.  Lanes with `idle` get the next
// item index, or -1 once the n items are handed out; other lanes get -1.
// `drained` (the same in every lane) turns true once the warp has seen the
// counter reach n, after which the warp asks no more.
__device__ __forceinline__ int take_next(bool idle, int n, int* next, bool& drained) {
  const unsigned want = __ballot_sync(FULL_MASK, idle && !drained);
  if (want == 0) return -1;
  const int me = threadIdx.x & 31;
  const int leader = __ffs(want) - 1;
  int base = 0;
  if (me == leader) base = atomicAdd(next, __popc(want));
  base = __shfl_sync(FULL_MASK, base, leader);
  drained = base + __popc(want) >= n;
  if (((want >> me) & 1u) == 0) return -1;
  const int i = base + __popc(want & ((1u << me) - 1u));
  return i < n ? i : -1;
}

// Blocks of `threads` threads that `kernel` keeps resident on the current
// device at once (its occupancy times the SMs), at most those n items need.
template <class K>
cudaError_t persistent_blocks(K kernel, int threads, int n, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  blocks = std::max(1, std::min(per_sm * sms, (n + threads - 1) / threads));
  return err;
}

}  // namespace gopbrt

#endif  // __CUDACC__
