// What the mesh kernels share (mesh_intersect.cu: A3, A4; mesh_pairs.cu:
// A7, A8): the single-rounded arithmetic, the slab test with its slacked
// cap, the staging of cluster boxes in shared memory, and the
// Moller-Trumbore accept tests. One copy, so that the pair-wavefront search
// gates on the bits the clustered search gates on and accepts the triangles
// it accepts (the two are held bitwise equal on live lanes), and so that
// A3's row gate rounds as its cluster gate does.
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

namespace qtrt_mesh {

constexpr float BIG = 3.0e38f;
constexpr int BLOCK = 128;   // rays (or pairs) per block, one per thread
constexpr int TILE_K = 256;  // cluster boxes per shared-memory tile (6 KB)
constexpr int ROW = 128;     // triangles per row of A3's row gate
constexpr int MT_FEATURES = 19;  // bilinear-form factors per triangle

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

// Slab test of box j of the shared tile.
__device__ __forceinline__ bool slab(float (*box)[TILE_K], int j,
                                     const Ray& r, float t_min,
                                     float& enter) {
  return slab_box(box[0][j], box[1][j], box[2][j], box[3][j], box[4][j],
                  box[5][j], r, t_min, enter);
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
