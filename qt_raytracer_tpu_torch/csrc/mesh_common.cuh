// What the mesh kernels share (mesh_intersect.cu: A3, A4; mesh_pairs.cu:
// A7, A8): the single-rounded arithmetic, the slab test with its slacked
// cap, the staging of cluster boxes in shared memory, and the
// Moller-Trumbore accept test. One copy, so that the pair-wavefront search
// gates on the bits the clustered search gates on and accepts the triangles
// it accepts: the two are held bitwise equal on live lanes.
//
// Numerics. Every add, multiply and divide is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn; no FMA contraction), with
// the expression tree of the TPU kernel's visit_vpu
// (qt_raytracer_tpu/kernels/mesh_intersect.py:360-410): cross products as
// a1*b2 - a2*b1, dot products left to right. So a kernel rounds as its
// plain PyTorch version does, op by op.

#pragma once

#include <cuda_runtime.h>

namespace qtrt_mesh {

constexpr float BIG = 3.0e38f;
constexpr int BLOCK = 128;   // rays (or pairs) per block, one per thread
constexpr int TILE_K = 256;  // cluster boxes per shared-memory tile (6 KB)

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

// Slab test of box j of the shared tile: true when exit > enter, with
// enter = max(t_min, min(t0, t1) over the axes) and
// exit = min(BIG, max(t0, t1) over the axes), in the TPU's axis order.
__device__ __forceinline__ bool slab(float (*box)[TILE_K], int j,
                                     const Ray& r, float t_min,
                                     float& enter) {
  float en = t_min, ex = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = mul(sub(box[a][j], r.o[a]), r.inv[a]);
    const float t1 = mul(sub(box[3 + a][j], r.o[a]), r.inv[a]);
    en = fmaxf(en, fminf(t0, t1));
    ex = fminf(ex, fmaxf(t0, t1));
  }
  enter = en;
  return ex > en;
}

// Stage boxes [base, base + m) into the shared tile.
__device__ __forceinline__ void stage_boxes(float (*tile)[TILE_K],
                                            const float* __restrict__ boxes,
                                            int k_stride, int base, int m) {
  for (int j = threadIdx.x; j < m; j += BLOCK) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
      tile[r][j] = boxes[static_cast<size_t>(r) * k_stride + base + j];
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

}  // namespace qtrt_mesh
