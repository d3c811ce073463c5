// Packing the flagged lanes of a thread block, in lane order, shared by the
// sphere sweeps (fused_hit.cu: the live rays of A1, A2, A5 and A6) and the
// pair hits (mesh_pairs.cu: A8's valid slots and the pairs that open a row).

#pragma once

#include <cuda_runtime.h>

namespace qtrt_pack {

// Each lane of a block of NT threads that has `flag` writes `value` to
// list[k], k its rank among the flagged lanes in lane order (a ballot per
// warp and a prefix over the warps' counts in warp_cnt, NT / 32 ints of
// shared memory); returns the count of flagged lanes, the same on every
// thread. Every thread of the block must call it: it synchronises the
// block twice, the second time after the list is written.
template <int NT>
__device__ __forceinline__ int block_pack(bool flag, int value,
                                          int* __restrict__ list,
                                          int* __restrict__ warp_cnt) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = warp_cnt[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (flag) list[before + __popc(ballot & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return total;
}

}  // namespace qtrt_pack
