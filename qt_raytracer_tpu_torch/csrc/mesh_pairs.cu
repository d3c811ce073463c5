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
// qt_raytracer_tpu/kernels/mesh_pairs.py::_clists_kernel (:136,
// crossing_lists :200): per ray the ascending list of the first c_max
// cluster ids whose slacked, capped slab test passes (the gate bits of A4
// and of A3's first look at a cluster), filled with k, and the count of
// all such clusters. The TPU kernel writes a (128, K_pad) id-or-sentinel
// scratch per ray row and extracts the list in c_max masked-min passes,
// because it has no per-lane append; a CUDA thread has one. Its plain
// versions are crossing_lists_plain (ungated) and
// mesh_intersect.crossing_walk_gated_plain (the walk below, counting its
// tests).
//   - What bounded it. The parent kernel, one thread a ray, tested all k
//     boxes (the count needs every crossing): 195 tests a live ray on the
//     1080p terrain, which crosses 5-7; instructions.
//   - What the design does. A4's two-level walk (mesh_common.cuh,
//     crossing_walk: group boxes of GROUP_C clusters, members only of the
//     groups that pass, which drops no id; live lanes packed), counting
//     every id it visits. The first STAGE ids of each ray wait in shared
//     memory and go out plane by plane at the end, so the lanes of a warp
//     store a plane ([c_max, n]) together. A live terrain ray tests some
//     58-62 boxes, the 13 group boxes among them; what bounds the kernel is
//     then its bytes, 33 + 4 (c_max + 1) a ray, or on the primary
//     wavefront its operations.
//   - Measured (chip_ab.py --parts boxes against the parent kernel on the
//     same inputs, in turns, one call between two CUDA events, the
//     wrapper's host time included; NVIDIA H100 80GB HBM3 at 700 W),
//     c_max = 6, ms against the parent's: the terrain's bounce-2
//     wavefront (193,363 live of 414,720) 0.145-0.147 against
//     0.191-0.196; its primary wavefront of chunk 2 0.153-0.155 against
//     0.168-0.176 (sorted 0.118-0.121 against 0.151-0.161), of chunk 0
//     0.092-0.094 against 0.174-0.175; a one-cluster true-Cornell step
//     wavefront 0.055-0.058 against 0.054-0.064, mostly host time.
//
// A8, qtrt_mesh_pairs, replaces _pairs_kernel: for each (ray, cluster) pair
// the closest triangle of that cluster strictly below the pair's cap, ties
// to the lowest triangle id; (BIG, 0) where none beats the cap and on
// invalid slots. One block of 128 threads per 128-pair tile; the tile's
// cluster id is gmap[blockIdx.x]. What bounds it: Moller-Trumbore, some 45
// single-rounded FP32 operations (a divide among them) per (pair,
// triangle), against 44 bytes per valid pair and 16 per slot: the
// instruction rate. Every add and multiply is its own instruction, kept so
// for the bits, so the one lever is to test fewer (pair, triangle)
// combinations. The parent kernel swept all g triangles of the cluster for
// every pair, though a pair's ray meets few of the cluster's 128-triangle
// rows. What the design does:
//   - Row gate per pair. A pair sweeps row r of its cluster only when the
//     slab test of the row's epsilon-padded box (prep_row_boxes, the boxes
//     of A3's ROWGATE instance) passes with an entry at most
//     gate_cap(t_best) of its running hit, tested at the row's turn, rows
//     in ascending order. t_best only shrinks, so a row that fails could
//     never pass later, and a triangle the ray hits lies inside its row's
//     box by the padding: the gate drops no winner, and the result is the
//     ungated sweep's bit for bit (pair_hits_gated_plain runs the gate).
//   - The tile by rows. The tile's valid slots are packed first (a ballot
//     and a prefix over the warps; a tile without one writes (BIG, 0) and
//     returns before it stages anything), and thread q holds pair q: its
//     ray, and its running (t_best, best) in shared memory. Row by row,
//     each thread tests its pair's gate, the open pairs are packed, and the
//     groups of PAIR_LANES consecutive lanes take them one at a time; a
//     barrier ends the row. So the block sweeps exactly the (pair, row)
//     combinations the gates open, 1.3 rows of 4 per valid pair on the
//     terrain wavefronts, and not the union of a warp's pairs' rows.
//   - Lanes per pair. A group of L lanes splits a row's 128 triangles
//     between its lanes (lane j takes j, j + L, ...), each lane with its own
//     strict-'<' (t, id) from the pair's t_best; a butterfly of
//     __shfl_xor_sync within the group takes the lexicographic minimum,
//     which becomes the pair's hit when it beats t_best, as A3's warp does
//     (tests/test_torch_hit_order.py). With L = PAIR_LANES = 8 a row that
//     a third of the tile's pairs open still keeps the block's 128 threads
//     busy. The cluster (g x 9 floats, 18 KB at g = 512) is staged in
//     shared memory once; the lanes of a group read neighbouring triangles,
//     the groups of a warp mostly the same ones.
// Each thread fetches its own ray by the slot's ray id (the TPU kernel is
// handed a packed [B, 8] row gather made by XLA, 32 bytes per slot through
// device memory; a CUDA thread gathers for itself, from ray arrays that stay
// in L2). Bound: 45 operations per (valid pair, triangle of a row its gate
// opens), 20 per row gate test. Measured, with chip_ab.py against the
// parent kernel on the same inputs (H100 80GB HBM3 at 700 W): the terrain
// bounce-2 wavefront (741,909 valid pairs in 2,513,920 slots, 1.31 rows a
// pair) 0.46-0.52 ms against 1.11-1.20; its primary wavefront (1,816,192
// pairs) 0.96-1.03 against 2.52-2.63; a wavefront of the true-Cornell step
// (one cluster of one row, 36 triangles) 0.12-0.14 against 0.10-0.14,
// slower: there the gate cannot skip and the packing costs. Tried and not kept
// (PERF.md §6): each pair's rows in a loop, a warp sweeping the union of its
// pairs' open rows (bounce 2 0.79-0.85 ms); 1, 4, 16 and 32 lanes a pair;
// the lane count as a run-time argument, one lane on single-row clusters
// (Cornell 9% faster, terrain 5-10% slower).

#include <cuda_runtime.h>

#include "block_pack.cuh"
#include "mesh_common.cuh"

namespace {

using namespace qtrt_mesh;
using qtrt_pack::block_pack;

constexpr int MAX_G = 512;  // triangles per cluster the shared stage holds
constexpr int PAIR_LANES = 8;  // lanes per pair in A8 (divides 32)
constexpr int STAGE = 8;       // list entries per ray A7 stages in shared

// A7: thread t walks the ray take_ray gives it (the block's live rays
// packed where there is more than one group) and counts every id it
// visits. Its first STAGE ids wait in shared memory and go out plane by
// plane at the end, so the lanes of a warp store one plane together; ids
// from STAGE on (c_max > STAGE) are stored as they come. A dead lane writes
// its k's and count 0 where it lies.
__global__ void __launch_bounds__(BLOCK) crossing_lists_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ boxes, int k, int k_stride,
    const float* __restrict__ groups, int ng, float t_min, int n,
    int c_max, int* __restrict__ lists, int* __restrict__ ncross) {
  __shared__ int staged[STAGE][BLOCK];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool pack = ng > 1;
  if (pack && i < n && !alive[i]) {
    for (int j = 0; j < c_max; ++j) lists[static_cast<size_t>(j) * n + i] = k;
    ncross[i] = 0;
  }
  int ray;
  Ray r = {};
  float cap = 0.f;
  const bool mine = take_ray(pack, n, ox, oy, oz, dx, dy, dz, alive, t_cap,
                             ray, r, cap);
  int count = 0;
  if (k == 1) {
    // One cluster, whose box is the one group's: one test decides.
    if (mine && gate_box(boxes, static_cast<size_t>(k_stride), 0, r, t_min,
                         cap)) {
      staged[0][threadIdx.x] = 0;
      count = 1;
    }
  } else {
    crossing_walk(mine, r, t_min, cap, groups, ng, boxes,
                  static_cast<size_t>(k_stride), k, [&](int c) {
                    if (count < STAGE)
                      staged[count][threadIdx.x] = c;
                    else if (count < c_max)
                      lists[static_cast<size_t>(count) * n + ray] = c;
                    ++count;
                    return false;
                  });
  }
  if (pack ? !mine : i >= n) return;  // unpacked, a dead lane writes k here
  for (int j = 0; j < c_max; ++j) {
    if (j < STAGE || j >= count)
      lists[static_cast<size_t>(j) * n + ray] =
          j < count ? staged[j][threadIdx.x] : k;
  }
  ncross[ray] = count;
}

constexpr int NO_ID = 0x7fffffff;

// A8: one block of BLOCK threads per 128-slot tile, the tile's pairs taken
// row by row (the header comment). Thread q holds pair q of the packed
// list; per row, the pairs whose gate passes under their running hit (kept
// in shared memory) are packed, and the groups of L lanes sweep them, one
// pair at a time, each group updating its pair's running hit; a barrier
// ends the row.
template <int L>
__global__ void __launch_bounds__(BLOCK) pair_hits_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ t_cap, const long long* __restrict__ ray_buf,
    const int* __restrict__ gmap, const float* __restrict__ tris,
    int p_stride, const float* __restrict__ rows, int r_stride, int g,
    float t_min, int n, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  static_assert(L >= 1 && L <= WARP && (WARP % L) == 0, "L divides a warp");
  __shared__ float tri[9][MAX_G];
  __shared__ float ray_s[6][BLOCK];  // o xyz, d xyz of each packed pair
  __shared__ float t_best_s[BLOCK];
  __shared__ int best_s[BLOCK];
  __shared__ int slots[BLOCK];
  __shared__ int items[BLOCK];       // the pairs that sweep the current row
  __shared__ int warp_cnt[BLOCK / WARP];
  const int b0 = blockIdx.x * BLOCK;

  // --- padding slots get (BIG, 0); valid slots are packed ---
  const long long ray0 = ray_buf[b0 + threadIdx.x];
  const bool ok0 = ray0 >= 0 && ray0 < n;  // no read beyond the rays
  if (!ok0) {
    t_out[b0 + threadIdx.x] = BIG;
    idx_out[b0 + threadIdx.x] = 0;
  }
  const int total =
      block_pack<BLOCK>(ok0, static_cast<int>(threadIdx.x), slots, warp_cnt);
  if (total == 0) return;  // a tile without a valid pair

  const int lo = gmap[blockIdx.x] * g;
  for (int p = threadIdx.x; p < g; p += BLOCK) {
#pragma unroll
    for (int a = 0; a < 9; ++a)
      tri[a][p] = tris[static_cast<size_t>(a) * p_stride + lo + p];
  }
  __syncthreads();

  // Thread q holds pair q: its ray (for the gate) and its cap.
  const bool mine = threadIdx.x < total;
  Ray r = {};
  float cap = 0.f;
  int slot = 0;
  if (mine) {
    slot = slots[threadIdx.x];
    const int ray = static_cast<int>(ray_buf[b0 + slot]);
    float d[3];
    r = load_ray(ray, ox, oy, oz, dx, dy, dz, d);
    cap = t_cap[ray];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ray_s[a][threadIdx.x] = r.o[a];
      ray_s[3 + a][threadIdx.x] = d[a];
    }
    t_best_s[threadIdx.x] = cap;
    best_s[threadIdx.x] = 0;
  }

  const int sub = threadIdx.x % L;  // the lane's place in its group
  const size_t rs = static_cast<size_t>(r_stride);
  const int row0 = lo / ROW;
  for (int row = 0; row < g / ROW; ++row) {
    // The gate of pair q at the row's turn, under its running hit (the
    // barrier at the end of the row before made the hit visible).
    const int rb = row0 + row;
    float enter = 0.f;
    const bool open =
        mine &&
        slab_box(__ldg(rows + rb), __ldg(rows + rs + rb),
                 __ldg(rows + 2 * rs + rb), __ldg(rows + 3 * rs + rb),
                 __ldg(rows + 4 * rs + rb), __ldg(rows + 5 * rs + rb), r,
                 t_min, enter) &&
        enter <= gate_cap(t_best_s[threadIdx.x]);
    const int m = block_pack<BLOCK>(open, static_cast<int>(threadIdx.x),
                                    items, warp_cnt);
    // Pairs [i0, i0 + BLOCK / L) of the row's list per round, one a group.
    for (int i0 = 0; i0 < m; i0 += BLOCK / L) {
      const int it = i0 + threadIdx.x / L;
      const bool has = it < m;
      if (!__any_sync(FULL, has)) break;
      const int q = has ? items[it] : 0;
      const float o[3] = {ray_s[0][q], ray_s[1][q], ray_s[2][q]};
      const float d[3] = {ray_s[3][q], ray_s[4][q], ray_s[5][q]};
      const float tb = t_best_s[q];
      float t = tb;
      int id = NO_ID;
      if (has) {
        for (int p = row * ROW + sub; p < (row + 1) * ROW; p += L) {
          const float v0[3] = {tri[0][p], tri[1][p], tri[2][p]};
          const float e1[3] = {tri[3][p], tri[4][p], tri[5][p]};
          const float e2[3] = {tri[6][p], tri[7][p], tri[8][p]};
          float t_hit;
          if (moller_trumbore(o, d, v0, e1, e2, t_min, t, t_hit)) {
            t = t_hit;
            id = lo + p;
          }
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        const float t2 = __shfl_xor_sync(FULL, t, off);
        const int id2 = __shfl_xor_sync(FULL, id, off);
        if (t2 < t || (t2 == t && id2 < id)) {
          t = t2;
          id = id2;
        }
      }
      if (has && sub == 0 && t < tb) {
        t_best_s[q] = t;
        best_s[q] = id;
      }
    }
    __syncthreads();
  }
  if (mine) {
    const bool won = t_best_s[threadIdx.x] < cap;
    t_out[b0 + slot] = won ? t_best_s[threadIdx.x] : BIG;
    idx_out[b0 + slot] = won ? best_s[threadIdx.x] : 0;
  }
}

}  // namespace

// Kernel A7. Ray operands: [n] f32 components, [n] bool alive, [n] f32
// t_cap (BIG for no cap); boxes: [6, k_stride] f32; groups: [6, ng] f32,
// the union of the boxes of each run of GROUP_C consecutive clusters
// (mesh_common.cuh), ng = ceil(k / GROUP_C). lists: [c_max, n] i32, plane j
// holding each ray's j-th crossed cluster id in ascending order, k beyond
// its last; ncross: [n] i32, the count of all crossed clusters (it may
// exceed c_max). Dead lanes: count 0, list all k. Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_crossing_lists(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const bool* alive, const float* t_cap,
    const float* boxes, int k, int k_stride, const float* groups, int ng,
    float t_min, int n, int c_max, int* lists, int* ncross, void* stream) {
  if (n <= 0 || k <= 0 || k_stride < k || c_max <= 0 || c_max > k ||
      ng != k / GROUP_C + (k % GROUP_C != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  crossing_lists_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, groups, ng,
      t_min, n, c_max, lists, ncross);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A8. Ray operands: [n] f32 components and [n] f32 t_cap; ray_buf:
// [b] i64, each slot's ray id in [0, n), or negative for a padding slot (an
// id from n on is taken for padding too);
// gmap: [b / 128] i32, the cluster of each 128-slot tile; tris:
// [9, p_stride] f32 with p_stride >= (max gmap + 1) * g; rows: [6,
// r_stride] f32, the epsilon-padded AABB of each 128-triangle row
// (prep_row_boxes), r_stride >= p_stride / 128; g: triangles per cluster, a
// multiple of 128 and at most 512. b must be a multiple of 128. t_out: [b]
// f32 (BIG where no triangle of the cluster beat the cap, and on padding
// slots); idx_out: [b] i32 (the winner's BVH-order id, else 0). Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_pairs(const float* ox, const float* oy,
                               const float* oz, const float* dx,
                               const float* dy, const float* dz,
                               const float* t_cap, const long long* ray_buf,
                               const int* gmap, const float* tris,
                               int p_stride, const float* rows, int r_stride,
                               int g, float t_min, int n, int b,
                               float* t_out, int* idx_out, void* stream) {
  if (n <= 0 || b <= 0 || b % BLOCK != 0 || g <= 0 || g > MAX_G ||
      g % ROW != 0 || p_stride < g ||
      static_cast<long long>(r_stride) * ROW < p_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_hits_kernel<PAIR_LANES>
      <<<b / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          ox, oy, oz, dx, dy, dz, t_cap, ray_buf, gmap, tris, p_stride, rows,
          r_stride, g, t_min, n, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
