// The escape-index BVH walk for Hopper (sm_90a): qtrt_bvh_walk.
//
// It has no TPU kernel to replace. It is the counterpart of
// qt_raytracer_tpu/accel/traverse.py::intersect_mesh (:56-125), the JAX
// package's portable mesh search (intersector="xla"), which XLA runs as a
// lockstep masked while loop: every lane carries one node pointer through
// the flattened tree (accel/bvh.py: hit an inner box -> i + 1, miss or
// finish a leaf -> escape[i]), and the loop ends when every lane has walked
// off the end. Mosaic cannot index a lane's own node on the TPU, so the
// TPU took the clustered search (kernel A3) instead; a GPU thread can walk
// its own ray's nodes, so here the walk is a kernel of its own. The plain
// PyTorch version is bvh_walk_plain in
// qt_raytracer_tpu_torch/kernels/bvh_walk.py, the same lockstep walk.
//
// Semantics, step by step as traverse.py:88-122 takes them, per live ray:
//   - inv_d = 1 / (|d| < 1e-30 ? (d < 0 ? -1e-30 : 1e-30) : d), -0.0
//     taking +1e-30 (qtrt_mesh::slab_inv);
//   - the slab test of node ptr: exit > enter, with enter the largest
//     per-axis min(t0, t1) and t_min, exit the smallest per-axis
//     max(t0, t1) and min(t_best, t_max);
//   - at a leaf whose box passes, triangles min(start + k, T - 1) for
//     k < min(count, max_leaf), each through Moller-Trumbore (_tri_hit_one)
//     under the inclusive cap min(t_best, t_max) of that moment, taken on
//     a strict t_k < t_best (the first triangle visited wins a tie) and
//     only when it is not the lane's excluded triangle;
//   - then ptr + 1 after an inner box that passes, escape[ptr] otherwise.
// A dead lane starts at ptr = M and reads (BIG, 0), as in JAX.
//
// Numerics. Every add, multiply and divide is rounded on its own
// (qtrt_mesh::mul/add/sub, __fdiv_rn; no FMA contraction), cross products
// as a1*b2 - a2*b1 in jnp.cross's component order and three-term dots
// summed left to right, so the kernel rounds as its plain version does, op
// by op, and equals it bit for bit on live lanes.
//
// What bounds it on the H100. A live ray tests some tens to hundreds of
// node boxes and a few tens of triangles (a terrain ray of the 1080p frame,
// 99,458 triangles: chip_smoke.py counts them), each a dependent gather:
// the next node is known only after the box test of this one. The node
// (36 bytes) and triangle (36 bytes) tables fit the 50 MB L2, so the walk
// is bound by the latency of those dependent loads and by the divergence
// of a warp's 32 walks, not by bandwidth or arithmetic (20 operations a box
// test, 45 a triangle).
//
// What the design does about it, simply. One thread per ray and 128 rays a
// block, so many warps are resident on each SM to hide the gathers'
// latency; every table read goes through the read-only cache (__ldg); the
// ray's origin, reciprocal direction, cap and best stay in registers. The
// exclude operand is a template parameter (bvh_walk_kernel<EXCL>), so the
// plain walk pays nothing for it. Packing a node into two 16-byte loads,
// or a wider tree, is later speed work.

#include <cuda_runtime.h>

#include "mesh_common.cuh"

namespace {

using qtrt_mesh::add;
using qtrt_mesh::BIG;
using qtrt_mesh::mul;
using qtrt_mesh::slab_inv;
using qtrt_mesh::sub;

constexpr int WALK_BLOCK = 128;   // rays per block, one per thread

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// traverse.py::_tri_hit_one for one triangle: t, or BIG where the hit is
// not valid under [t_min, t_max] (both inclusive).
__device__ __forceinline__ float tri_hit(const float* __restrict__ v0s,
                                         const float* __restrict__ e1s,
                                         const float* __restrict__ e2s,
                                         int tri, const V3& o, const V3& d,
                                         float t_min, float t_max) {
  const V3 v0 = load3(v0s, tri), e1 = load3(e1s, tri), e2 = load3(e2s, tri);
  const float px = sub(mul(d.y, e2.z), mul(d.z, e2.y));
  const float py = sub(mul(d.z, e2.x), mul(d.x, e2.z));
  const float pz = sub(mul(d.x, e2.y), mul(d.y, e2.x));
  const float det = add(add(mul(px, e1.x), mul(py, e1.y)), mul(pz, e1.z));
  const bool ok_det = fabsf(det) > 1e-12f;
  const float inv_det = ok_det ? __fdiv_rn(1.f, det) : 0.f;
  const float sx = sub(o.x, v0.x), sy = sub(o.y, v0.y), sz = sub(o.z, v0.z);
  const float u =
      mul(add(add(mul(sx, px), mul(sy, py)), mul(sz, pz)), inv_det);
  const float qx = sub(mul(sy, e1.z), mul(sz, e1.y));
  const float qy = sub(mul(sz, e1.x), mul(sx, e1.z));
  const float qz = sub(mul(sx, e1.y), mul(sy, e1.x));
  const float v =
      mul(add(add(mul(qx, d.x), mul(qy, d.y)), mul(qz, d.z)), inv_det);
  const float t =
      mul(add(add(mul(qx, e2.x), mul(qy, e2.y)), mul(qz, e2.z)), inv_det);
  const bool ok = ok_det && u >= 0.f && v >= 0.f && add(u, v) <= 1.f &&
                  t >= t_min && t <= t_max;
  return ok ? t : BIG;
}

template <bool EXCL>
__global__ void __launch_bounds__(WALK_BLOCK)
    bvh_walk_kernel(const float* __restrict__ origins,
                    const float* __restrict__ directions,
                    const bool* __restrict__ alive,
                    const int* __restrict__ excl,
                    const float* __restrict__ bmin,
                    const float* __restrict__ bmax,
                    const int* __restrict__ escape,
                    const int* __restrict__ start,
                    const int* __restrict__ count, int m,
                    const float* __restrict__ v0,
                    const float* __restrict__ e1,
                    const float* __restrict__ e2, int num_tris, int max_leaf,
                    float t_min, float t_max, int n, float* __restrict__ t_out,
                    int* __restrict__ idx_out) {
  const int i = blockIdx.x * WALK_BLOCK + threadIdx.x;
  if (i >= n) return;
  float t_best = BIG;
  int best = 0;
  if (alive[i]) {
    const V3 o = load3(origins, i), d = load3(directions, i);
    const float o3[3] = {o.x, o.y, o.z};
    const float inv[3] = {slab_inv(d.x), slab_inv(d.y), slab_inv(d.z)};
    const int ex = EXCL ? excl[i] : -1;
    int ptr = 0;
    while (ptr < m) {
      const float cap = fminf(t_best, t_max);
      float enter = -BIG, exit_ = BIG;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t0 = mul(sub(__ldg(bmin + 3 * ptr + a), o3[a]), inv[a]);
        const float t1 = mul(sub(__ldg(bmax + 3 * ptr + a), o3[a]), inv[a]);
        enter = fmaxf(enter, fminf(t0, t1));
        exit_ = fminf(exit_, fmaxf(t0, t1));
      }
      const bool box_ok = fminf(exit_, cap) > fmaxf(enter, t_min);
      const int cnt = __ldg(count + ptr);
      if (box_ok && cnt > 0) {
        const int s = __ldg(start + ptr);
        const int k_end = min(cnt, max_leaf);
        for (int k = 0; k < k_end; ++k) {
          const int tri = min(s + k, num_tris - 1);
          const float t_k =
              tri_hit(v0, e1, e2, tri, o, d, t_min, fminf(t_best, t_max));
          if (t_k < t_best && (!EXCL || tri != ex)) {
            t_best = t_k;
            best = tri;
          }
        }
      }
      ptr = (box_ok && cnt <= 0) ? ptr + 1 : __ldg(escape + ptr);
    }
  }
  t_out[i] = t_best;
  idx_out[i] = best;
}

}  // namespace

// origins, directions: [n, 3] f32 rows; alive: [n] bool; excl: [n] i32
// excluded triangle id per lane (-1: none), or null for no exclude
// operand; bmin, bmax: [m, 3] f32 node boxes; escape, start, count: [m] i32
// (TriangleMesh.bvh_*); v0, e1, e2: [num_tris, 3] f32; t_out [n] f32,
// idx_out [n] i32. Returns the launch's cudaError_t.
extern "C" int qtrt_bvh_walk(const float* origins, const float* directions,
                             const bool* alive, const int* excl,
                             const float* bmin, const float* bmax,
                             const int* escape, const int* start,
                             const int* count, int m, const float* v0,
                             const float* e1, const float* e2, int num_tris,
                             int max_leaf, float t_min, float t_max, int n,
                             float* t_out, int* idx_out, void* stream) {
  if (n <= 0 || m <= 0 || num_tris <= 0 || max_leaf <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / WALK_BLOCK + (n % WALK_BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  if (excl != nullptr) {
    bvh_walk_kernel<true><<<grid, WALK_BLOCK, 0, st>>>(
        origins, directions, alive, excl, bmin, bmax, escape, start, count, m,
        v0, e1, e2, num_tris, max_leaf, t_min, t_max, n, t_out, idx_out);
  } else {
    bvh_walk_kernel<false><<<grid, WALK_BLOCK, 0, st>>>(
        origins, directions, alive, nullptr, bmin, bmax, escape, start, count,
        m, v0, e1, e2, num_tris, max_leaf, t_min, t_max, n, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
