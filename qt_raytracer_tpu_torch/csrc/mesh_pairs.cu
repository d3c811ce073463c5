// Pair-wavefront triangle-mesh search for Hopper (sm_90a): kernels A7 and A8.
//
// The clustered search (mesh_intersect.cu, A3) makes a warp run the union
// of its 32 lanes' cluster visits. The pair search turns the traversal
// inside out: A7 lists, per ray, the clusters its ray segment crosses; the
// wrapper (kernels/mesh_pairs.py) groups the (ray, cluster) pairs by
// cluster into tiles of 128 pairs; A8 sweeps each tile's one cluster for
// every pair of the tile. Every visit is then productive and no lane waits
// on a neighbour's cluster. The result equals A3's bit for bit on live
// lanes: both kernels take their slab test, their cap slack and their
// Moller-Trumbore from mesh_common.cuh.
//
// A7, qtrt_mesh_crossing_lists, replaces
// qt_raytracer_tpu/kernels/mesh_pairs.py::_clists_kernel: per ray the
// ascending list of the first c_max cluster ids whose slacked, capped slab
// test passes (the gate bits of A4 and of A3's first look at a cluster),
// filled with k, and the count of all such clusters. The TPU kernel writes
// a (128, K_pad) id-or-sentinel scratch per ray row and extracts the list
// in c_max masked-min passes, because it has no per-lane append; a CUDA
// thread has one. One thread per ray walks the boxes in ascending id, staged
// in shared tiles as in A4, appends while its list has room and counts on:
// no early exit, the count needs every box. The list is plane-major
// ([c_max, n]), so a warp's stores of one plane are coalesced. Bound: 20
// operations per (live ray, box) against 33 + 4 (c_max + 1) bytes per ray:
// operations from some 30 boxes on.
//
// A8, qtrt_mesh_pairs, replaces _pairs_kernel: for each (ray, cluster) pair
// the closest triangle of that cluster strictly below the pair's cap, ties
// to the lowest triangle id; (BIG, 0) where none beats the cap and on
// invalid slots. One block of 128 threads per 128-pair tile; the tile's
// cluster id is gmap[blockIdx.x]. The block stages the cluster's g x 9
// floats (18 KB at g = 512) in shared memory once, and each thread sweeps
// them in ascending triangle id with a strict '<' update of its running
// minimum, which is the TPU's per-row min, lowest id at the min and strict
// 'better' cascade. Every lane of a warp reads the same triangle at once,
// so a shared load is one broadcast. No gate inside: A7 admitted the pair.
// A tile with no valid pair returns at once. Each thread fetches its own
// ray by the slot's ray id (the TPU kernel is handed a packed [B, 8] row
// gather made by XLA, 32 bytes per slot through device memory; a CUDA
// thread gathers for itself, from ray arrays that stay in L2). Bound: 45
// operations per (valid pair, triangle of its cluster), far above its 44
// bytes per valid pair and 16 per slot.

#include <cuda_runtime.h>

#include "mesh_common.cuh"

namespace {

using namespace qtrt_mesh;

constexpr int MAX_G = 512;  // triangles per cluster the shared stage holds

__global__ void __launch_bounds__(BLOCK) crossing_lists_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ boxes, int k, int k_stride, float t_min, int n,
    int c_max, int* __restrict__ lists, int* __restrict__ ncross) {
  __shared__ float tile[6][TILE_K];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n && alive[i];
  const bool block_live = __syncthreads_or(live);

  Ray r = {};
  float d[3] = {0.f, 0.f, 1.f};
  float cap = 0.f;
  if (live) {
    r = load_ray(i, ox, oy, oz, dx, dy, dz, d);
    cap = gate_cap(t_cap[i]);
  }
  int count = 0;
  if (block_live) {
    for (int base = 0; base < k; base += TILE_K) {
      const int m = min(TILE_K, k - base);
      __syncthreads();
      stage_boxes(tile, boxes, k_stride, base, m);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < m; ++j) {
        float enter;
        if (slab(tile, j, r, t_min, enter) && enter <= cap) {
          if (count < c_max)
            lists[static_cast<size_t>(count) * n + i] = base + j;
          ++count;
        }
      }
    }
  }
  if (i >= n) return;
  for (int j = min(count, c_max); j < c_max; ++j)
    lists[static_cast<size_t>(j) * n + i] = k;
  ncross[i] = count;
}

__global__ void __launch_bounds__(BLOCK) pair_hits_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_cap, const long long* __restrict__ ray_buf,
    const int* __restrict__ gmap, const float* __restrict__ tris,
    int p_stride, int g, float t_min, int n, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  __shared__ float tri[9][MAX_G];
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  const long long ray = ray_buf[b];
  const bool ok_pair = ray >= 0 && ray < n;  // no read beyond the rays
  if (!__syncthreads_or(ok_pair)) {
    t_out[b] = BIG;
    idx_out[b] = 0;
    return;
  }
  const int lo = gmap[blockIdx.x] * g;
  for (int p = threadIdx.x; p < g; p += BLOCK) {
#pragma unroll
    for (int a = 0; a < 9; ++a)
      tri[a][p] = tris[static_cast<size_t>(a) * p_stride + lo + p];
  }
  __syncthreads();

  float cap = BIG;
  float t_best = BIG;
  int best = 0;
  if (ok_pair) {
    const float o[3] = {ox[ray], oy[ray], oz[ray]};
    const float d[3] = {dx[ray], dy[ray], dz[ray]};
    cap = t_cap[ray];
    t_best = cap;
    for (int p = 0; p < g; ++p) {
      const float v0[3] = {tri[0][p], tri[1][p], tri[2][p]};
      const float e1[3] = {tri[3][p], tri[4][p], tri[5][p]};
      const float e2[3] = {tri[6][p], tri[7][p], tri[8][p]};
      float t;
      if (moller_trumbore(o, d, v0, e1, e2, t_min, t_best, t)) {
        t_best = t;
        best = lo + p;
      }
    }
  }
  const bool won = t_best < cap;
  t_out[b] = won ? t_best : BIG;
  idx_out[b] = won ? best : 0;
}

}  // namespace

// Kernel A7. Ray operands: [n] f32 components, [n] bool alive, [n] f32
// t_cap (BIG for no cap); boxes: [6, k_stride] f32. lists: [c_max, n] i32,
// plane j holding each ray's j-th crossed cluster id in ascending order, k
// beyond its last; ncross: [n] i32, the count of all crossed clusters (it
// may exceed c_max). Dead lanes: count 0, list all k. Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_crossing_lists(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const bool* alive, const float* t_cap,
    const float* boxes, int k, int k_stride, float t_min, int n, int c_max,
    int* lists, int* ncross, void* stream) {
  if (n <= 0 || k <= 0 || k_stride < k || c_max <= 0 || c_max > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  crossing_lists_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, t_min, n,
      c_max, lists, ncross);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A8. Ray operands: [n] f32 components and [n] f32 t_cap; ray_buf:
// [b] i64, each slot's ray id in [0, n), or negative for a padding slot (an
// id from n on is taken for padding too);
// gmap: [b / 128] i32, the cluster of each 128-slot tile; tris:
// [9, p_stride] f32 with p_stride >= (max gmap + 1) * g; g: triangles per
// cluster, at most 512. b must be a multiple of 128. t_out: [b] f32 (BIG
// where no triangle of the cluster beat the cap, and on padding slots);
// idx_out: [b] i32 (the winner's BVH-order id, else 0). Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_pairs(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* t_cap, const long long* ray_buf,
                               const int* gmap, const float* tris,
                               int p_stride, int g, float t_min, int n,
                               int b, float* t_out, int* idx_out,
                               void* stream) {
  if (n <= 0 || b <= 0 || b % BLOCK != 0 || g <= 0 || g > MAX_G ||
      p_stride < g)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_hits_kernel<<<b / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, t_cap, ray_buf, gmap, tris, p_stride, g, t_min,
      n, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
