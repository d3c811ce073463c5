// What the mesh kernels share (mesh_intersect.cu: A3, A4; mesh_pairs.cu:
// A7, A8): the single-rounded arithmetic, the slab test with its slacked
// cap, the two-level crossing walk of A4 and A7, and the Moller-Trumbore
// accept tests. One copy, so that the pair-wavefront search gates on the
// bits the clustered search gates on and accepts the triangles it accepts
// (the two are held bitwise equal on live lanes), and so that A3's row gate
// rounds as its cluster gate does.
//
// Numerics. Every add, multiply and divide is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; no FMA contraction), with
// the expression tree of the TPU kernel's visit_vpu
// (qt_raytracer_tpu/kernels/mesh_intersect.py:360-410): cross products as
// a1*b2 - a2*b1, dot products left to right; and for the bilinear form,
// that of visit_mxu (:308-342) with its products summed left to right. So
// a kernel rounds as its plain PyTorch version does, op by op.

#pragma once

#include <cuda_runtime.h>

#include "block_pack.cuh"

namespace qtrt_mesh {

constexpr float BIG = 3.0e38f;
constexpr int BLOCK = 128;   // rays (or pairs) per block, one per thread
constexpr int ROW = 128;     // triangles per row of A3's row gate
constexpr int MT_FEATURES = 19;  // bilinear-form factors per triangle
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// Clusters per group box of A4's and A7's walk (divides WARP); the group
// boxes come from mesh_intersect.prep_group_boxes at its GROUP_C, which must
// be this.
constexpr int GROUP_C = 16;
static_assert(WARP % GROUP_C == 0, "a group's members fit a warp evenly");

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Slab reciprocal of one direction component, as the TPU kernels take it:
// 1 / (|d| < 1e-30 ? (d < 0 ? -1e-30 : 1e-30) : d). d = -0.0 takes +1e-30.
__device__ __forceinline__ float slab_inv(float d) {
  const float c = fabsf(d) < 1e-30f ? (d < 0.f ? -1e-30f : 1e-30f) : d;
  return __fdiv_rn(1.f, c);
}

// The slacked gate cap: min(t * 1.0001 + 1e-4, 1e37).
__device__ __forceinline__ float gate_cap(float t) {
  return fminf(add(mul(t, 1.0001f), 1e-4f), 1e37f);
}

struct Ray {
  float o[3], inv[3];
};

// Slab test of the box lo = (lx, ly, lz), hi = (hx, hy, hz): true when
// exit > enter, with enter = max(t_min, min(t0, t1) over the axes) and
// exit = min(BIG, max(t0, t1) over the axes), in the TPU's axis order.
__device__ __forceinline__ bool slab_box(float lx, float ly, float lz,
                                         float hx, float hy, float hz,
                                         const Ray& r, float t_min,
                                         float& enter) {
  const float lo[3] = {lx, ly, lz};
  const float hi[3] = {hx, hy, hz};
  float en = t_min, ex = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = mul(sub(lo[a], r.o[a]), r.inv[a]);
    const float t1 = mul(sub(hi[a], r.o[a]), r.inv[a]);
    en = fmaxf(en, fminf(t0, t1));
    ex = fminf(ex, fmaxf(t0, t1));
  }
  enter = en;
  return ex > en;
}

// Capped slab test of column j of a [6, stride] box table read with
// __ldg: exit > enter and enter <= cap. The address is the same on every
// lane of a warp that tests one box, so each plane is one broadcast load.
__device__ __forceinline__ bool gate_box(const float* __restrict__ planes,
                                         size_t stride, int j, const Ray& r,
                                         float t_min, float cap) {
  float enter;
  return slab_box(__ldg(planes + j), __ldg(planes + stride + j),
                  __ldg(planes + 2 * stride + j),
                  __ldg(planes + 3 * stride + j),
                  __ldg(planes + 4 * stride + j),
                  __ldg(planes + 5 * stride + j), r, t_min, enter) &&
         enter <= cap;
}

// The two-level crossing walk of A4 and A7, one thread a ray: visit(c)
// for each cluster c whose capped slab test passes, in ascending c, until
// visit returns true. Group box j (groups, [6, ng]: the exact union of the
// boxes of clusters [j * GROUP_C, min(j * GROUP_C + GROUP_C, k))) is tested
// first, and its members only when it passes. Every sub and mul of the
// slab test rounds monotonically, so a member's rounded interval lies
// inside its group's on each axis: a member that passes makes its group
// pass, and the walk visits exactly the ids the ungated walk over all k
// boxes visits.
//
// The warp tests group j for its 32 rays at once (one box, a uniform
// address), then the members for the lanes whose group opened, in one of
// two ways that visit the same ids:
//   - one member at a time, every lane on its own ray (a uniform address):
//     a round a member, whatever the number of open lanes;
//   - shared rounds: a round takes the next WARP / GROUP_C open lanes in
//     lane order, lane l testing member l % GROUP_C of the
//     (l / GROUP_C)-th on that lane's ray (fetched by shuffles); each owner
//     reads its group's bits of the round's ballot and visits them in
//     ascending order.
// A shared round costs about two of the first kind (the shuffles and the
// owner's search), so the warp takes shared rounds when fewer than half as
// many of them do: on a coherent wavefront most lanes open the same
// groups, on a scattered one each group opens for a few. Every lane of
// the warp calls it, with want false where it has no ray. (With k = 1 the
// one group box is the cluster's box: A4 and A7 take that one test
// instead.)
template <class Visit>
__device__ __forceinline__ void crossing_walk(
    bool want, const Ray& r, float t_min, float cap,
    const float* __restrict__ groups, int ng,
    const float* __restrict__ boxes, size_t ks, int k, Visit visit) {
  const int lane = threadIdx.x & (WARP - 1);
  constexpr int per = WARP / GROUP_C;    // owners a shared round
  const int slot = lane / GROUP_C;       // this lane's owner in a round
  const int member = lane % GROUP_C;     // and member of that owner's group
  const unsigned below = (1u << lane) - 1u;
  constexpr unsigned field = GROUP_C == WARP ? FULL : (1u << GROUP_C) - 1u;
  for (int j = 0; j < ng; ++j) {
    if (!__any_sync(FULL, want)) return;
    const bool open =
        gate_box(groups, static_cast<size_t>(ng), j, r, t_min, cap) && want;
    unsigned todo = __ballot_sync(FULL, open);
    if (!todo) continue;
    const int lo = j * GROUP_C;
    const int m = min(GROUP_C, k - lo);  // members of group j
    if (m <= 2 * ((__popc(todo) + per - 1) / per)) {
      for (int c = lo; c < lo + m; ++c) {
        if (!__any_sync(FULL, open && want)) break;
        if (gate_box(boxes, ks, c, r, t_min, cap) && open && want)
          want = !visit(c);
      }
      continue;
    }
    while (todo) {
      // Owner `slot` of this round: the slot-th lane left in todo.
      unsigned rest = todo;
      for (int s = 0; s < slot && rest; ++s) rest &= rest - 1u;
      const int src = rest ? __ffs(rest) - 1 : lane;
      Ray o;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        o.o[a] = __shfl_sync(FULL, r.o[a], src);
        o.inv[a] = __shfl_sync(FULL, r.inv[a], src);
      }
      const float o_cap = __shfl_sync(FULL, cap, src);
      const bool pass =
          rest && member < m && gate_box(boxes, ks, lo + member, o, t_min,
                                         o_cap);
      const unsigned bits = __ballot_sync(FULL, pass);
      // This lane's turn: its rank among the owners left.
      const int rank = __popc(todo & below);
      if (((todo >> lane) & 1u) && rank < per) {
        for (unsigned mine = (bits >> (rank * GROUP_C)) & field; mine && want;
             mine &= mine - 1u)
          want = !visit(lo + __ffs(mine) - 1);
      }
      for (int s = 0; s < per && todo; ++s) todo &= todo - 1u;
    }
  }
}

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        const float* __restrict__ dx,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ dz,
                                        float d[3]) {
  Ray r;
  r.o[0] = ox[i]; r.o[1] = oy[i]; r.o[2] = oz[i];
  d[0] = dx[i]; d[1] = dy[i]; d[2] = dz[i];
#pragma unroll
  for (int a = 0; a < 3; ++a) r.inv[a] = slab_inv(d[a]);
  return r;
}

// The ray that thread t walks in A4 and A7, if any. With pack, the live
// rays of the block's BLOCK are packed in lane order (block_pack.cuh) and
// thread q takes the q-th, so that dead lanes hold no place in a warp;
// without, thread t takes ray t of the block, live or not, where it lies.
// Returns whether the thread has a live ray; if so sets ray (its index), r
// and cap (gate_cap of its t_cap). Every thread of the block calls it with
// the same pack.
__device__ __forceinline__ bool take_ray(
    bool pack, int n, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const bool* __restrict__ alive,
    const float* __restrict__ t_cap, int& ray, Ray& r, float& cap) {
  __shared__ int items[BLOCK];
  __shared__ int warp_cnt[BLOCK / WARP];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  bool mine = i < n && alive[i];
  ray = i;
  if (pack) {
    const int total = qtrt_pack::block_pack<BLOCK>(mine, i, items, warp_cnt);
    mine = static_cast<int>(threadIdx.x) < total;
    ray = mine ? items[threadIdx.x] : 0;
  }
  if (mine) {
    float d[3];
    r = load_ray(ray, ox, oy, oz, dx, dy, dz, d);
    cap = gate_cap(t_cap[ray]);
  }
  return mine;
}

// Moller-Trumbore of ray (o, d) against triangle (v0, e1, e2): true when
// the ray hits it at a t in [t_min, t_best), which it writes to t_hit.
__device__ __forceinline__ bool moller_trumbore(
    const float o[3], const float d[3], const float v0[3], const float e1[3],
    const float e2[3], float t_min, float t_best, float& t_hit) {
  // pv = d x e2, det = pv . e1
  const float pv0 = sub(mul(d[1], e2[2]), mul(d[2], e2[1]));
  const float pv1 = sub(mul(d[2], e2[0]), mul(d[0], e2[2]));
  const float pv2 = sub(mul(d[0], e2[1]), mul(d[1], e2[0]));
  const float det = add(add(mul(pv0, e1[0]), mul(pv1, e1[1])),
                        mul(pv2, e1[2]));
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv_det = __fdiv_rn(1.f, det);
  const float s0 = sub(o[0], v0[0]);
  const float s1 = sub(o[1], v0[1]);
  const float s2 = sub(o[2], v0[2]);
  const float u = mul(add(add(mul(s0, pv0), mul(s1, pv1)),
                          mul(s2, pv2)), inv_det);
  // qv = s x e1
  const float qv0 = sub(mul(s1, e1[2]), mul(s2, e1[1]));
  const float qv1 = sub(mul(s2, e1[0]), mul(s0, e1[2]));
  const float qv2 = sub(mul(s0, e1[1]), mul(s1, e1[0]));
  const float v = mul(add(add(mul(qv0, d[0]), mul(qv1, d[1])),
                          mul(qv2, d[2])), inv_det);
  const float t = mul(add(add(mul(qv0, e2[0]), mul(qv1, e2[1])),
                          mul(qv2, e2[2])), inv_det);
  t_hit = t;
  return u >= 0.f && v >= 0.f && add(u, v) <= 1.f && t >= t_min &&
         t < t_best;
}

// The ray-side factor of the bilinear forms, built once per ray: m = o x d,
// as visit_mxu builds it (o1*d2 - o2*d1, ...).
__device__ __forceinline__ void ray_moment(const float o[3], const float d[3],
                                           float m[3]) {
  m[0] = sub(mul(o[1], d[2]), mul(o[2], d[1]));
  m[1] = sub(mul(o[2], d[0]), mul(o[0], d[2]));
  m[2] = sub(mul(o[0], d[1]), mul(o[1], d[0]));
}

// Moller-Trumbore as bilinear forms of the ray's (d, m = o x d, o, 1) and
// the triangle's 19 factors f (build_mt_features: -n | e2, c2 | -e1, -c1 |
// n, -v0.n with n = e1 x e2, c1 = v0 x e1, c2 = v0 x e2):
//   det = d . f[0:3], det*u = (m, d) . f[3:9], det*v = (m, d) . f[9:15],
//   det*t = o . f[15:18] + f[18],
// each product rounded, each sum left to right; then moller_trumbore's
// accept test. Padding triangles have f = 0, so det = 0 rejects them.
// Operations when det passes its test: 7 (det and the test), 1 divide, 22
// (u and v numerators), 6 (t numerator), 3 (u, v, t), 6 (accept) = 45;
// 7 when it fails (padding triangles, rays in a triangle's plane).
__device__ __forceinline__ bool moller_trumbore_bilinear(
    const float o[3], const float d[3], const float m[3],
    const float f[MT_FEATURES], float t_min, float t_best, float& t_hit) {
  const float det = add(add(mul(d[0], f[0]), mul(d[1], f[1])),
                        mul(d[2], f[2]));
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv_det = __fdiv_rn(1.f, det);
  const float md[6] = {m[0], m[1], m[2], d[0], d[1], d[2]};
  float uu = mul(md[0], f[3]);
  float vv = mul(md[0], f[9]);
#pragma unroll
  for (int a = 1; a < 6; ++a) {
    uu = add(uu, mul(md[a], f[3 + a]));
    vv = add(vv, mul(md[a], f[9 + a]));
  }
  const float tt = add(add(add(mul(o[0], f[15]), mul(o[1], f[16])),
                           mul(o[2], f[17])), f[18]);
  const float u = mul(uu, inv_det);
  const float v = mul(vv, inv_det);
  const float t = mul(tt, inv_det);
  t_hit = t;
  return u >= 0.f && v >= 0.f && add(u, v) <= 1.f && t >= t_min &&
         t < t_best;
}

}  // namespace qtrt_mesh
