// One differentiable sphere bounce, forward and backward, for Hopper
// (sm_90a): diff_bounce_shadow_kernel (F1), diff_bounce_kernel (F2) and
// diff_bounce_backward_kernel (B, with its fixed-order reduction).
//
// Replaces no TPU kernel. The JAX package differentiates this step with
// jax.grad through XLA's fusions; on the card the PyTorch route of
// qt_raytracer_tpu_torch/core/integrator_flat.py::bounce(diff=True)
// (_rederive_hits_flat, _emit_weight_flat, _shade_plain with _nee_flat)
// issues some 760 kernels forward and 800 in autograd's backward a bounce,
// and the host's launch rate paces the train step. Here, around A2's two
// calls (the winner's selection, the NEE shadow rays), per ray lane in
// registers:
//   F1 re-derives the winner's hit (Citardauq roots, hit point, normal,
//      front face) from its params row, and casts NEE's shadow ray: the
//      light pick and the cone sample. It writes the rays (origin, [3, n]
//      direction) and `cand` for A2.
//   F2 does the whole forward of the bounce: the re-derivation, the
//      emitter's MIS weight, the bounce's hash uniforms, the scatter of the
//      four materials, sky and emission, NEE's MIS contribution with A2's
//      `lit`, `continues`, the throughput, Russian roulette, prev_pdf and
//      the continuing ray. It writes the new ox..rz and prev_pdf as a
//      [13, n] f32 block and alive as [n] bool. Without NEE there is no F1,
//      no shadow call, and prev_pdf passes through.
//   B recomputes F2's intermediates and applies their adjoints in reverse:
//      the pathwise derivatives with every decision held fixed, the ones
//      autograd takes through the route's torch.where (the unselected branch
//      and a masked lane get zero; torch.maximum's ties split the gradient;
//      a clamp passes it at its bounds). It writes the carry's gradients
//      (ox..dz, tx..tz, prev_pdf; the radiance's is the identity) as a
//      [10, n] block, and the params table's gradient, [S, 16], from the
//      winner's row and the light's row.
// The wrapper, the autograd.Function and the route rule are in
// kernels/diff_bounce.py; the plain version is the PyTorch route above,
// unchanged.
//
// Forward: the bits of the PyTorch route on every lane, dead lanes
// included, with shade_kernel's discipline (shade_math.cuh), and two more
// rules of PyTorch on the card: a tensor divided by a Python number is a
// product with its float reciprocal (x / n_lights), and a Python number
// divided by a tensor is the tensor's reciprocal times the number
// (-1.0 / (sign + wz)).
//
// Backward: the forward values are recomputed in float, bit for bit; the
// adjoints are taken in double from those values and rounded to float once,
// at the end. The params gradient is deterministic: each block stages its
// lanes' row gradients (12 of the row's 16 columns: center, radius,
// albedo, fuzz, ior, emission) in shared memory, finds each row's first
// record in the tile (an atomicMin on shared ints, whose result is order
// free), and that record's warp sums the row's records in a fixed order
// into the block's partial; the blocks' partials are then summed in block
// order, in double, by a second kernel. The grid is
// bounded (2 blocks an SM), so the partials stay near 2 MB at 128 rows
// whatever n is.
//
// What bounds it on the H100: memory for F1 and F2, latency for B, not
// arithmetic. F2 moves 130 bytes a lane (the carry, t, the shadow t and
// ids, alive and the key in; the new carry and alive out; the two params
// rows come from L2): at 414,720 lanes 54 MB, 16 us at 3.35 TB/s. B moves
// 157 (F2's operands but the radiance and 13 upstream gradients in, 10
// gradients out), but holds the forward's intermediates and its FP64
// adjoints in registers, 250 a thread, so one 256-thread block an SM, and
// waits on its dependent chains. So one thread a lane, 256 threads a
// block, every field a coalesced load of its own [n] row.

#include "shade_math.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int ROW = 16;      // floats in a params row (packed_param_table)
constexpr int REC = 12;      // a row's columns the bounce differentiates
constexpr int TILE_RECS = 2 * BLOCK;   // a lane's winner and light records
constexpr int NO_RECORD = 0x7FFFFFFF;  // a row without a record in the tile
constexpr float EPS_PDF = static_cast<float>(1e-12);
constexpr float EPS_DEN = static_cast<float>(1e-30);
constexpr float OUTSIDE = static_cast<float>(1.0001);

// Per-lane operand rows in the order of kernels/diff_bounce.py's OPERANDS;
// the wrapper passes one device pointer each (null where a kernel reads
// none).
enum Op {
  O_X, O_Y, O_Z, D_X, D_Y, D_Z, T_X, T_Y, T_Z, R_X, R_Y, R_Z, PREV, T_SEL,
  SH_T, N_FLOATS
};
enum OpOther { P_ALIVE = N_FLOATS, P_KEYS, P_IDX, P_SH_IDX, N_OPS };
struct Operands {
  const float* f[N_FLOATS];
  const bool* alive;
  const long long* keys;
  const int* idx;
  const int* sh_idx;
};
struct Setup {
  const float* params;      // [S, 16]
  const int* light_idx;     // [n_lights]
  int n_lights;
  float inv_n;              // 1.0f / n_lights, as PyTorch's x / n rounds it
  float t_min;
  unsigned stream_word;     // (STREAM_BOUNCE0 + depth) * GOLDEN
  int rr;                   // Russian roulette on this bounce
  int nee;
};

// ------------------------------------------------------- forward pieces
// _safe_rsqrt_len2: inv = 1 / sqrt(n2), or 0 where n2 <= 1e-20.
struct InvLen {
  float n2, sq, inv;
  bool ok;
};
__device__ __forceinline__ InvLen inv_len_core(float x, float y, float z) {
  InvLen v;
  v.n2 = dot3(x, y, z, x, y, z);
  v.ok = v.n2 > EPS_LEN2;
  v.sq = v.ok ? __fsqrt_rn(v.n2) : 1.f;
  v.inv = v.ok ? __fdiv_rn(1.f, v.sq) : 0.f;
  return v;
}

// _rederive_hits_flat on one lane's winner row (center c, radius r).
struct Rederived {
  float oc[3], a1, hb, c1, disc, sqrtd, q1, q1s, ra, rb, near, far;
  bool hpos, qz, nok, fok, sel;
  float t, t_safe, ph[3], r_safe, num[3], ow[3], sgn, n[3];
  bool ff;
};
__device__ __forceinline__ void rederive(const float o[3], const float d[3],
                                         const float c[3], float r,
                                         float t_sel, float t_min,
                                         Rederived& h) {
  for (int k = 0; k < 3; ++k) h.oc[k] = sub(o[k], c[k]);
  h.a1 = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
  h.hb = dot3(h.oc[0], h.oc[1], h.oc[2], d[0], d[1], d[2]);
  h.c1 = sub(dot3(h.oc[0], h.oc[1], h.oc[2], h.oc[0], h.oc[1], h.oc[2]),
             mul(r, r));
  h.disc = sub(mul(h.hb, h.hb), mul(h.a1, h.c1));
  h.sqrtd = safe_sqrt(h.disc);
  h.hpos = h.hb >= 0.f;
  h.q1 = sub(-h.hb, h.hpos ? h.sqrtd : -h.sqrtd);
  h.qz = h.q1 == 0.f;
  h.q1s = h.qz ? 1.f : h.q1;
  h.ra = __fdiv_rn(h.q1, h.a1);
  h.rb = h.qz ? 0.f : __fdiv_rn(h.c1, h.q1s);
  h.near = h.hpos ? h.ra : h.rb;
  h.far = h.hpos ? h.rb : h.ra;
  h.nok = h.near >= t_min;
  h.fok = h.disc >= 0.f && (h.nok || h.far >= t_min);
  h.sel = t_sel < BIG;
  h.t = h.sel && h.fok ? (h.nok ? h.near : h.far) : t_sel;
  h.t_safe = h.sel ? h.t : 1.f;
  h.r_safe = r == 0.f ? 1.f : r;
  for (int k = 0; k < 3; ++k) {
    h.ph[k] = add(o[k], mul(h.t_safe, d[k]));
    h.num[k] = sub(h.ph[k], c[k]);
    h.ow[k] = __fdiv_rn(h.num[k], h.r_safe);
  }
  h.ff = dot3(d[0], d[1], d[2], h.ow[0], h.ow[1], h.ow[2]) < 0.f;
  h.sgn = h.ff ? 1.f : -1.f;
  for (int k = 0; k < 3; ++k) h.n[k] = mul(h.sgn, h.ow[k]);
}

// _sphere_pdf_flat: the cone pdf of a sphere light (lc, lr) seen from p.
struct Pdf {
  float to[3], dist2, lr2, dcl, q, sin2, oms, cos_max, opc, omc, tpo, den,
      pdf;
  bool outside, ok;
};
__device__ __forceinline__ void sphere_pdf(const float lc[3], float lr,
                                           const float p[3], Pdf& s) {
  for (int k = 0; k < 3; ++k) s.to[k] = sub(lc[k], p[k]);
  s.dist2 = dot3(s.to[0], s.to[1], s.to[2], s.to[0], s.to[1], s.to[2]);
  s.lr2 = mul(lr, lr);
  s.outside = s.dist2 > mul(s.lr2, OUTSIDE);
  s.dcl = clamp_min(s.dist2, EPS_PDF);
  s.q = __fdiv_rn(s.lr2, s.dcl);
  s.sin2 = clamp(s.q, 0.f, 1.f);
  s.oms = sub(1.f, s.sin2);
  s.cos_max = safe_sqrt(s.oms);
  s.opc = add(1.f, s.cos_max);
  s.omc = __fdiv_rn(s.sin2, s.opc);
  s.ok = s.outside && s.omc > EPS_PDF;
  s.tpo = mul(TWO_PI, s.omc);
  s.den = s.ok ? clamp_min(s.tpo, EPS_DEN) : 1.f;
  s.pdf = s.ok ? __fdiv_rn(1.f, s.den) : 0.f;
}

// _cone_sample: a direction toward the sphere light, uniform in its cone,
// with the branchless ONB.
struct Cone {
  Pdf pdf;
  InvLen wl;
  float w[3], cos_s, sss, sin_s, cph, sph, sign, ainv, a, wxy, b, s1, s2,
      wyy, t1[3], t2[3], sc, ss, ld[3];
};
__device__ __forceinline__ void cone_sample(const float lc[3], float lr,
                                            const float p[3], float u5,
                                            float u6, Cone& c) {
  sphere_pdf(lc, lr, p, c.pdf);
  c.wl = inv_len_core(c.pdf.to[0], c.pdf.to[1], c.pdf.to[2]);
  for (int k = 0; k < 3; ++k) c.w[k] = mul(c.pdf.to[k], c.wl.inv);
  c.cos_s = sub(1.f, mul(u5, sub(1.f, c.pdf.cos_max)));
  c.sss = sub(1.f, mul(c.cos_s, c.cos_s));
  c.sin_s = safe_sqrt(c.sss);
  const float phi = mul(TWO_PI, u6);
  c.cph = cosf(phi);
  c.sph = sinf(phi);
  c.sign = c.w[2] >= 0.f ? 1.f : -1.f;
  c.ainv = __fdiv_rn(1.f, add(c.sign, c.w[2]));
  c.a = mul(c.ainv, -1.f);
  c.wxy = mul(c.w[0], c.w[1]);
  c.b = mul(c.wxy, c.a);
  c.s1 = mul(c.sign, c.w[0]);
  c.s2 = mul(c.s1, c.w[0]);
  c.wyy = mul(c.w[1], c.w[1]);
  c.t1[0] = add(1.f, mul(c.s2, c.a));
  c.t1[1] = mul(c.sign, c.b);
  c.t1[2] = mul(-c.sign, c.w[0]);
  c.t2[0] = c.b;
  c.t2[1] = add(c.sign, mul(c.wyy, c.a));
  c.t2[2] = -c.w[1];
  c.sc = mul(c.sin_s, c.cph);
  c.ss = mul(c.sin_s, c.sph);
  for (int k = 0; k < 3; ++k)
    c.ld[k] = add(add(mul(c.sc, c.t1[k]), mul(c.ss, c.t2[k])),
                  mul(c.cos_s, c.w[k]));
}

// _scatter_flat for a live hit, in its own material's branch (a lane
// computes only what its outputs read).
struct Scatter {
  float ru[3], rucb[3];
  InvLen dl;
  float u[3], din, two_din, rf[3];
  float ratio, x_cos, cos_t, inner[3], rp[3], v, av, s, par;
  bool reflect;
  float sd[3], at[3];
  bool ok, white;
};
__device__ __forceinline__ void scatter(int mat, const float alb[3],
                                        float fuzz, float ior, bool ff,
                                        const float d[3], const float n[3],
                                        unsigned key, unsigned sw,
                                        Scatter& s) {
  s.ok = true;
  s.white = mat == DIELECTRIC || mat == EMISSIVE;
  for (int k = 0; k < 3; ++k) s.at[k] = s.white ? 1.f : alb[k];
  if (mat == LAMBERTIAN || mat == METAL) {
    const float zc = sub(1.f, mul(2.f, uniform(key, sw, 0)));
    const float rr = __fsqrt_rn(clamp_min(sub(1.f, mul(zc, zc)), EPS_LEN2));
    const float phi = mul(TWO_PI, uniform(key, sw, 1));
    s.ru[0] = mul(rr, cosf(phi));
    s.ru[1] = mul(rr, sinf(phi));
    s.ru[2] = zc;
  }
  if (mat == LAMBERTIAN) {
    float l[3];
    for (int k = 0; k < 3; ++k) l[k] = add(n[k], s.ru[k]);
    const bool degen = dot3(l[0], l[1], l[2], l[0], l[1], l[2]) < EPS_DEGEN;
    for (int k = 0; k < 3; ++k) s.sd[k] = degen ? n[k] : l[k];
    return;
  }
  if (mat == EMISSIVE) {
    s.ok = false;   // absorbed: the direction is never read
    return;
  }
  s.dl = inv_len_core(d[0], d[1], d[2]);
  for (int k = 0; k < 3; ++k) s.u[k] = mul(d[k], s.dl.inv);
  s.din = dot3(s.u[0], s.u[1], s.u[2], n[0], n[1], n[2]);
  s.two_din = mul(2.f, s.din);
  for (int k = 0; k < 3; ++k) s.rf[k] = sub(s.u[k], mul(s.two_din, n[k]));
  if (mat == METAL) {
    const float cb = powf(uniform(key, sw, 2), THIRD);
    for (int k = 0; k < 3; ++k) {
      s.rucb[k] = mul(s.ru[k], cb);
      s.sd[k] = add(s.rf[k], mul(fuzz, s.rucb[k]));
    }
    s.ok = dot3(s.sd[0], s.sd[1], s.sd[2], n[0], n[1], n[2]) > 0.f;
    return;
  }
  // Dielectric, and any other material id (_scatter_flat's last where).
  s.ratio = ff ? __fdiv_rn(1.f, ior) : ior;
  s.x_cos = dot3(-s.u[0], -s.u[1], -s.u[2], n[0], n[1], n[2]);
  s.cos_t = clamp_max(s.x_cos, 1.f);
  const float sin_t = safe_sqrt(sub(1.f, mul(s.cos_t, s.cos_t)));
  const bool cannot = mul(s.ratio, sin_t) > 1.f;
  float r0 = __fdiv_rn(sub(1.f, s.ratio), add(1.f, s.ratio));
  r0 = mul(r0, r0);
  const float om = sub(1.f, s.cos_t);
  const float om2 = mul(om, om);
  const float om5 = mul(om, mul(om2, om2));
  const float refl = add(r0, mul(sub(1.f, r0), om5));
  s.reflect = cannot || refl > uniform(key, sw, 3);
  for (int k = 0; k < 3; ++k) {
    s.inner[k] = add(s.u[k], mul(s.cos_t, n[k]));
    s.rp[k] = mul(s.ratio, s.inner[k]);
  }
  s.v = sub(1.f, dot3(s.rp[0], s.rp[1], s.rp[2], s.rp[0], s.rp[1], s.rp[2]));
  s.av = fabsf(s.v);
  s.s = safe_sqrt(s.av);
  s.par = -s.s;
  for (int k = 0; k < 3; ++k)
    s.sd[k] = s.reflect ? s.rf[k] : add(s.rp[k], mul(s.par, n[k]));
}

// One lane's forward, every value the outputs or the backward read.
struct Lane {
  float o[3], d[3], tp[3], prev;
  bool alive;
  unsigned key;
  int idx, mat;
  float c[3], r, alb[3], fuzz, ior, e[3];
  Rederived h;
  bool hit, emit;
  // the emitter's MIS weight (NEE)
  Pdf pe;
  float rs, lce[3], pdf_nee_e, denom_e, emit_w;
  bool use;
  Scatter sc;
  bool diffuse;
  // NEE
  int light;
  float lc[3], lr, le[3], u5, u6;
  Cone cone;
  float cos_surf, pdf_nee, num, denom, den_f, factor;
  bool cand, lit;
  // continues, throughput, roulette, prev_pdf
  bool c0, adj, cont;
  float t1[3], m1, m, pc, t2[3];
  InvLen sl;
  float dotn, cos_next;
};

// shadow: false for F1 (no shadow result yet: cand and the shadow ray for
// every lane), true for F2 and B (lit from A2's t and idx).
__device__ __forceinline__ void forward_lane(const Operands& a,
                                             const Setup& st, int i,
                                             bool shadow, Lane& L) {
  const auto ld = [&](int k) { return __ldg(a.f[k] + i); };
  for (int k = 0; k < 3; ++k) {
    L.o[k] = ld(O_X + k);
    L.d[k] = ld(D_X + k);
  }
  L.alive = a.alive[i];
  L.idx = __ldg(a.idx + i);
  const float* row = st.params + static_cast<size_t>(L.idx) * ROW;
  for (int k = 0; k < 3; ++k) {
    L.c[k] = __ldg(row + k);
    L.alb[k] = __ldg(row + 4 + k);
    L.e[k] = __ldg(row + 10 + k);
  }
  L.r = __ldg(row + 3);
  L.fuzz = __ldg(row + 7);
  L.ior = __ldg(row + 8);
  L.mat = static_cast<int>(__ldg(row + 9));
  rederive(L.o, L.d, L.c, L.r, ld(T_SEL), st.t_min, L.h);
  L.hit = L.h.t < BIG;
  L.emit = L.mat == EMISSIVE;
  L.key = static_cast<unsigned>(__ldg(a.keys + i));
  const bool live_hit = L.alive && L.hit;
  L.diffuse = live_hit && L.mat == LAMBERTIAN;
  L.cand = L.lit = false;
  if (st.nee && (L.diffuse || !shadow)) {
    const int pick = min(max(static_cast<int>(mul(
        uniform(L.key, st.stream_word, 4), static_cast<float>(st.n_lights))),
        0), st.n_lights - 1);
    L.light = __ldg(st.light_idx + pick);
    const float* lrow = st.params + static_cast<size_t>(L.light) * ROW;
    for (int k = 0; k < 3; ++k) {
      L.lc[k] = __ldg(lrow + k);
      L.le[k] = __ldg(lrow + 10 + k);
    }
    L.lr = __ldg(lrow + 3);
    L.u5 = uniform(L.key, st.stream_word, 5);
    L.u6 = uniform(L.key, st.stream_word, 6);
    cone_sample(L.lc, L.lr, L.h.ph, L.u5, L.u6, L.cone);
    L.cos_surf = dot3(L.h.n[0], L.h.n[1], L.h.n[2], L.cone.ld[0],
                      L.cone.ld[1], L.cone.ld[2]);
    L.cand = L.diffuse && L.cone.pdf.ok && L.cos_surf > 0.f;
  }
  if (!shadow) return;

  for (int k = 0; k < 3; ++k) L.tp[k] = ld(T_X + k);
  L.prev = ld(PREV);
  if (L.cand)
    L.lit = ld(SH_T) < BIG && __ldg(a.sh_idx + i) == L.light;
  if (st.nee && L.cand) {
    L.pdf_nee = mul(L.cone.pdf.pdf, st.inv_n);
    L.num = mul(L.cos_surf, INV_PI);
    L.denom = add(L.pdf_nee, L.num);
    L.den_f = clamp_min(L.denom, EPS_DEN);
    L.factor = __fdiv_rn(L.num, L.den_f);
  }
  L.emit_w = 1.f;
  L.use = false;
  if (st.nee && live_hit) {
    L.rs = mul(L.r, L.h.sgn);
    for (int k = 0; k < 3; ++k) L.lce[k] = sub(L.h.ph[k], mul(L.rs, L.h.n[k]));
    sphere_pdf(L.lce, L.r, L.o, L.pe);
    L.pdf_nee_e = mul(L.pe.pdf, st.inv_n);
    L.use = L.prev > 0.f;
    L.denom_e = L.use ? add(L.prev, L.pdf_nee_e) : 1.f;
    L.emit_w = L.use ? __fdiv_rn(L.prev, L.denom_e) : 1.f;
  }
  L.sc.ok = false;
  if (live_hit)
    scatter(L.mat, L.alb, L.fuzz, L.ior, L.h.ff, L.d, L.h.n, L.key,
            st.stream_word, L.sc);
  L.c0 = live_hit && L.sc.ok;
  for (int k = 0; k < 3; ++k) L.t1[k] = L.c0 ? mul(L.tp[k], L.sc.at[k]) : L.tp[k];
  L.adj = L.c0;
  if (st.rr && L.c0) {
    L.m1 = maximum(L.t1[0], L.t1[1]);
    L.m = maximum(L.m1, L.t1[2]);
    L.pc = clamp(L.m, P_MIN, 1.f);
    L.adj = uniform(L.key, st.stream_word, 7) < L.pc;
  }
  for (int k = 0; k < 3; ++k)
    L.t2[k] = st.rr && L.adj ? __fdiv_rn(L.t1[k], L.pc) : L.t1[k];
  L.cont = L.adj;
  if (st.nee && L.cont) {
    L.sl = inv_len_core(L.sc.sd[0], L.sc.sd[1], L.sc.sd[2]);
    L.dotn = dot3(L.h.n[0], L.h.n[1], L.h.n[2], L.sc.sd[0], L.sc.sd[1],
                  L.sc.sd[2]);
    L.cos_next = mul(L.dotn, L.sl.inv);
  }
}

// The radiance after the bounce: rad plus the sky, the emission and NEE's
// term, in _shade_plain's order (a masked term adds 0.0).
__device__ __forceinline__ void radiance(const Lane& L, int nee,
                                         const float rad[3], float out[3]) {
  float sky[3] = {0.f, 0.f, 0.f};
  const bool miss = L.alive && !L.hit;
  if (miss) {
    const float inv = inv_len(L.d[0], L.d[1], L.d[2]);
    const float s = mul(0.5f, add(mul(L.d[1], inv), 1.f));
    const float one_s = mul(sub(1.f, s), 1.f);
    sky[0] = add(one_s, mul(s, 0.5f));
    sky[1] = add(one_s, mul(s, SKY_G));
    sky[2] = add(one_s, mul(s, 1.f));
  }
  for (int k = 0; k < 3; ++k) {
    float r = add(rad[k], miss ? mul(L.tp[k], sky[k]) : 0.f);
    r = add(r, L.alive && L.hit
                   ? mul(mul(L.tp[k], L.emit ? L.e[k] : 0.f), L.emit_w)
                   : 0.f);
    if (nee)
      r = add(r, L.lit ? mul(mul(mul(L.tp[k], L.alb[k]), L.factor), L.le[k])
                       : 0.f);
    out[k] = r;
  }
}

// F1: the shadow rays of NEE ([6, n]: origin, direction) and cand.
__global__ void __launch_bounds__(BLOCK) diff_bounce_shadow_kernel(
    Operands a, Setup st, int n, float* __restrict__ rays,
    bool* __restrict__ cand) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Lane L;
  forward_lane(a, st, i, false, L);
  const size_t row = static_cast<size_t>(n);
  for (int k = 0; k < 3; ++k) {
    rays[k * row + i] = L.h.ph[k];
    rays[(3 + k) * row + i] = L.cone.ld[k];
  }
  cand[i] = L.cand;
}

// F2: the bounce's new carry ([13, n]: ox..rz, prev_pdf) and alive.
__global__ void __launch_bounds__(BLOCK) diff_bounce_kernel(
    Operands a, Setup st, int n, float* __restrict__ out,
    bool* __restrict__ alive_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  Lane L;
  forward_lane(a, st, i, true, L);
  const float rad_in[3] = {__ldg(a.f[R_X] + i), __ldg(a.f[R_Y] + i),
                           __ldg(a.f[R_Z] + i)};
  float rad[3];
  radiance(L, st.nee, rad_in, rad);
  float prev = L.prev;
  if (st.nee && L.cont)
    prev = L.diffuse ? mul(clamp_min(L.cos_next, 0.f), INV_PI) : -1.f;
  float* f = out + i;
  const size_t row = static_cast<size_t>(n);
  for (int k = 0; k < 3; ++k) {
    f[k * row] = L.cont ? L.h.ph[k] : L.o[k];
    f[(3 + k) * row] = L.cont ? L.sc.sd[k] : L.d[k];
    f[(6 + k) * row] = L.t2[k];
    f[(9 + k) * row] = rad[k];
  }
  f[12 * row] = prev;
  alive_out[i] = L.cont;
}

// ------------------------------------------------------ backward pieces
// Adjoints in double of the forward values above; g* accumulate (+=).
using D = double;

__device__ __forceinline__ void inv_len_bwd(const float v[3], const InvLen& l,
                                            D g_inv, D gv[3]) {
  if (!l.ok) return;
  // where(ok, reciprocal(sqrt(where(ok, n2, 1))), 0)
  const D g_sq = -g_inv * (D(l.inv) * D(l.inv));
  const D g_n2 = g_sq / (2.0 * D(l.sq));
  for (int k = 0; k < 3; ++k) gv[k] += 2.0 * D(v[k]) * g_n2;
}

// torch.maximum's backward: a tie splits the gradient, NaN takes it all.
__device__ __forceinline__ void maximum_bwd(float a, float b, D g, D& ga,
                                            D& gb) {
  if (a == b) {
    ga += g / 2.0;
    gb += g / 2.0;
    return;
  }
  if (!(a < b)) ga += g;
  if (!(a > b)) gb += g;
}

// sphere_pdf's adjoint: g_pdf, g_cos_max and g_to in; lc, lr and p out.
__device__ __forceinline__ void sphere_pdf_bwd(const Pdf& s, float lr,
                                               D g_pdf, D g_cos_max,
                                               D g_to[3], D g_lc[3], D& g_lr,
                                               D g_p[3]) {
  D g_omc = 0.0;
  if (s.ok && s.tpo >= EPS_DEN) {
    const D g_den = -g_pdf * (D(s.pdf) * D(s.pdf));
    g_omc = D(TWO_PI) * g_den;
  }
  D g_sin2 = g_omc / D(s.opc);
  const D g_cm = g_cos_max - g_omc * D(s.sin2) / (D(s.opc) * D(s.opc));
  if (s.oms > 0.f) g_sin2 -= g_cm / (2.0 * D(s.cos_max));
  const D g_q = s.q >= 0.f && s.q <= 1.f ? g_sin2 : 0.0;
  g_lr += 2.0 * D(lr) * (g_q / D(s.dcl));
  const D g_dcl = -g_q * D(s.lr2) / (D(s.dcl) * D(s.dcl));
  const D g_dist2 = s.dist2 >= EPS_PDF ? g_dcl : 0.0;
  for (int k = 0; k < 3; ++k) {
    const D gt = g_to[k] + 2.0 * D(s.to[k]) * g_dist2;
    g_lc[k] += gt;
    g_p[k] -= gt;
  }
}

// cone_sample's adjoint: g_ld and g_pdf in; lc, lr and p out.
__device__ __forceinline__ void cone_bwd(const Cone& c, float u5, float lr,
                                         const D g_ld[3], D g_pdf, D g_lc[3],
                                         D& g_lr, D g_p[3]) {
  D g_sc = 0.0, g_ss = 0.0, g_cos_s = 0.0, g_w[3], g_t1[3], g_t2[3];
  for (int k = 0; k < 3; ++k) {
    g_sc += g_ld[k] * D(c.t1[k]);
    g_ss += g_ld[k] * D(c.t2[k]);
    g_cos_s += g_ld[k] * D(c.w[k]);
    g_w[k] = g_ld[k] * D(c.cos_s);
    g_t1[k] = g_ld[k] * D(c.sc);
    g_t2[k] = g_ld[k] * D(c.ss);
  }
  const D g_sin_s = g_sc * D(c.cph) + g_ss * D(c.sph);
  // t2 = (b, sign + (wy*wy)*a, -wy)
  D g_b = g_t2[0], g_a = g_t2[1] * D(c.wyy);
  g_w[1] += 2.0 * D(c.w[1]) * (g_t2[1] * D(c.a)) - g_t2[2];
  // t1 = (1 + ((sign*wx)*wx)*a, sign*b, (-sign)*wx)
  const D g_s2 = g_t1[0] * D(c.a);
  g_a += g_t1[0] * D(c.s2);
  const D g_s1 = g_s2 * D(c.w[0]);
  g_w[0] += g_s2 * D(c.s1) + g_s1 * D(c.sign) - g_t1[2] * D(c.sign);
  g_b += g_t1[1] * D(c.sign);
  // b = (wx*wy)*a
  g_a += g_b * D(c.wxy);
  const D g_wxy = g_b * D(c.a);
  g_w[0] += g_wxy * D(c.w[1]);
  g_w[1] += g_wxy * D(c.w[0]);
  // a = reciprocal(sign + wz) * -1
  const D g_ainv = -g_a;
  g_w[2] += -g_ainv * (D(c.ainv) * D(c.ainv));
  // sin_s = safe_sqrt(1 - cos_s^2); cos_s = 1 - u5*(1 - cos_max)
  if (c.sss > 0.f) g_cos_s += -2.0 * D(c.cos_s) * (g_sin_s / (2.0 * D(c.sin_s)));
  const D g_cos_max = g_cos_s * D(u5);
  // w = to * winv
  D g_to[3], g_winv = 0.0;
  for (int k = 0; k < 3; ++k) {
    g_to[k] = g_w[k] * D(c.wl.inv);
    g_winv += g_w[k] * D(c.pdf.to[k]);
  }
  inv_len_bwd(c.pdf.to, c.wl, g_winv, g_to);
  sphere_pdf_bwd(c.pdf, lr, g_pdf, g_cos_max, g_to, g_lc, g_lr, g_p);
}

// u = d * inv_len(d): its adjoint into d.
__device__ __forceinline__ void unit_bwd(const Scatter& s, const float d[3],
                                         const D g_u[3], D g_d[3]) {
  D g_inv = 0.0;
  for (int k = 0; k < 3; ++k) {
    g_d[k] += g_u[k] * D(s.dl.inv);
    g_inv += g_u[k] * D(d[k]);
  }
  inv_len_bwd(d, s.dl, g_inv, g_d);
}

// The scatter direction's adjoint (g_sd) into d, n, fuzz and ior.
__device__ __forceinline__ void scatter_bwd(const Lane& L, const D g_sd[3],
                                            D g_d[3], D g_n[3], D& g_fuzz,
                                            D& g_ior) {
  const Scatter& s = L.sc;
  const float* n = L.h.n;
  if (L.mat == LAMBERTIAN) {
    for (int k = 0; k < 3; ++k) g_n[k] += g_sd[k];
    return;
  }
  if (L.mat == EMISSIVE) return;
  D g_u[3] = {0.0, 0.0, 0.0}, g_rf[3] = {0.0, 0.0, 0.0};
  if (L.mat == METAL || s.reflect) {
    for (int k = 0; k < 3; ++k) g_rf[k] = g_sd[k];
    if (L.mat == METAL)
      for (int k = 0; k < 3; ++k) g_fuzz += g_sd[k] * D(s.rucb[k]);
  } else {
    // sd = rp + par * n; par = -safe_sqrt(|1 - |rp|^2|)
    D g_par = 0.0, g_rp[3];
    for (int k = 0; k < 3; ++k) {
      g_rp[k] = g_sd[k];
      g_par += g_sd[k] * D(n[k]);
      g_n[k] += g_sd[k] * D(s.par);
    }
    if (s.av > 0.f) {
      const D g_av = -g_par / (2.0 * D(s.s));
      const D g_v = s.v > 0.f ? g_av : -g_av;
      for (int k = 0; k < 3; ++k) g_rp[k] += -2.0 * D(s.rp[k]) * g_v;
    }
    // rp = ratio * (u + cos_t * n)
    D g_ratio = 0.0, g_cos = 0.0;
    for (int k = 0; k < 3; ++k) {
      g_ratio += g_rp[k] * D(s.inner[k]);
      const D g_in = g_rp[k] * D(s.ratio);
      g_u[k] += g_in;
      g_cos += g_in * D(n[k]);
      g_n[k] += g_in * D(s.cos_t);
    }
    // cos_t = clamp_max(dot(-u, n), 1)
    if (s.x_cos <= 1.f)
      for (int k = 0; k < 3; ++k) {
        g_u[k] -= g_cos * D(n[k]);
        g_n[k] -= g_cos * D(s.u[k]);
      }
    // ratio = ff ? 1 / ior : ior
    g_ior += L.h.ff ? -g_ratio * (D(s.ratio) * D(s.ratio)) : g_ratio;
  }
  // rf = u - (2 * din) * n, din = dot(u, n)
  D g_2din = 0.0;
  for (int k = 0; k < 3; ++k) {
    g_u[k] += g_rf[k];
    g_2din -= g_rf[k] * D(n[k]);
    g_n[k] -= g_rf[k] * D(s.two_din);
  }
  const D g_din = 2.0 * g_2din;
  for (int k = 0; k < 3; ++k) {
    g_u[k] += g_din * D(n[k]);
    g_n[k] += g_din * D(s.u[k]);
  }
  unit_bwd(s, L.d, g_u, g_d);
}

// The re-derivation's adjoint (g_ph, g_n) into o, d, the center and r.
__device__ __forceinline__ void rederive_bwd(const Lane& L, const D g_ph_in[3],
                                             const D g_n[3], D g_o[3],
                                             D g_d[3], D g_c[3], D& g_r) {
  const Rederived& h = L.h;
  D g_ph[3], g_rsafe = 0.0;
  for (int k = 0; k < 3; ++k) {
    const D g_ow = D(h.sgn) * g_n[k];
    g_ph[k] = g_ph_in[k] + g_ow / D(h.r_safe);
    g_c[k] -= g_ow / D(h.r_safe);
    g_rsafe -= g_ow * D(h.num[k]) / (D(h.r_safe) * D(h.r_safe));
  }
  if (L.r != 0.f) g_r += g_rsafe;
  D g_tsafe = 0.0;
  for (int k = 0; k < 3; ++k) {
    g_o[k] += g_ph[k];
    g_tsafe += g_ph[k] * D(L.d[k]);
    g_d[k] += g_ph[k] * D(h.t_safe);
  }
  if (!(h.sel && h.fok)) return;
  const D g_near = h.nok ? g_tsafe : 0.0, g_far = h.nok ? 0.0 : g_tsafe;
  const D g_ra = h.hpos ? g_near : g_far, g_rb = h.hpos ? g_far : g_near;
  D g_q1 = g_ra / D(h.a1);
  D g_a1 = -g_ra * D(h.q1) / (D(h.a1) * D(h.a1));
  D g_c1 = 0.0;
  if (!h.qz) {
    g_c1 += g_rb / D(h.q1s);
    g_q1 -= g_rb * D(h.c1) / (D(h.q1s) * D(h.q1s));
  }
  D g_hb = -g_q1;
  const D g_sqrtd = h.hpos ? -g_q1 : g_q1;
  if (h.disc > 0.f) {
    const D g_disc = g_sqrtd / (2.0 * D(h.sqrtd));
    g_hb += 2.0 * D(h.hb) * g_disc;
    g_a1 -= D(h.c1) * g_disc;
    g_c1 -= D(h.a1) * g_disc;
  }
  g_r -= 2.0 * D(L.r) * g_c1;
  for (int k = 0; k < 3; ++k) {
    const D g_oc = 2.0 * D(h.oc[k]) * g_c1 + g_hb * D(L.d[k]);
    g_d[k] += g_hb * D(h.oc[k]) + 2.0 * D(L.d[k]) * g_a1;
    g_o[k] += g_oc;
    g_c[k] -= g_oc;
  }
}

// Loads the upstream gradient k of lane i (0 where the pointer is null).
__device__ __forceinline__ D upstream(const float* const* g,
                                      const long long* stride, int k, int i) {
  return g[k] ? D(__ldg(g[k] + static_cast<long long>(i) * stride[k])) : 0.0;
}

struct Upstream {
  const float* g[13];   // grads of ox..rz, prev_pdf (null: zero)
  long long stride[13];
};

// B: the carry's gradients ([10, n]: ox..dz, tx..tz, prev_pdf) and, with
// partials, the block's share of the params gradient ([S, REC] a block).
__global__ void __launch_bounds__(BLOCK) diff_bounce_backward_kernel(
    Operands a, Setup st, Upstream up, int n, int slots,
    float* __restrict__ gout, float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* part = smem;                                   // [slots, REC]
  int* first = reinterpret_cast<int*>(part + slots * REC);   // [slots]
  int* rec_slot = first + slots;                        // [TILE_RECS]
  float* rec_val = reinterpret_cast<float*>(rec_slot + TILE_RECS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (partials) {
    for (int e = tid; e < slots * REC; e += BLOCK) part[e] = 0.f;
    for (int e = tid; e < slots; e += BLOCK) first[e] = NO_RECORD;
    __syncthreads();
  }
  const size_t row = static_cast<size_t>(n);
  for (int base = blockIdx.x * BLOCK; base < n; base += gridDim.x * BLOCK) {
    const int i = base + tid;
    int slot_w = -1, slot_l = -1;
    D gw[REC], gl[REC];
    for (int c = 0; c < REC; ++c) gw[c] = gl[c] = 0.0;
    if (i < n) {
      Lane L;
      forward_lane(a, st, i, true, L);
      D g_o[3], g_d[3], g_t[3], g_prev = 0.0;
      D g_ph[3] = {0.0, 0.0, 0.0}, g_n[3] = {0.0, 0.0, 0.0};
      D g_sd[3] = {0.0, 0.0, 0.0}, g_r1[3];
      for (int k = 0; k < 3; ++k) {
        const D go1 = upstream(up.g, up.stride, k, i);
        const D gd1 = upstream(up.g, up.stride, 3 + k, i);
        g_r1[k] = upstream(up.g, up.stride, 9 + k, i);
        g_o[k] = L.cont ? 0.0 : go1;
        g_d[k] = L.cont ? 0.0 : gd1;
        g_ph[k] = L.cont ? go1 : 0.0;
        g_sd[k] = L.cont ? gd1 : 0.0;
      }
      // prev_pdf = cont ? pdf_next : prev
      const D gp1 = upstream(up.g, up.stride, 12, i);
      if (!st.nee || !L.cont) {
        g_prev += gp1;
      } else if (L.diffuse && L.cos_next >= 0.f) {
        const D g_cn = gp1 * D(INV_PI);
        const D g_dotn = g_cn * D(L.sl.inv);
        for (int k = 0; k < 3; ++k) {
          g_n[k] += g_dotn * D(L.sc.sd[k]);
          g_sd[k] += g_dotn * D(L.h.n[k]);
        }
        inv_len_bwd(L.sc.sd, L.sl, g_cn * D(L.dotn), g_sd);
      }
      // roulette: t2 = adj ? t1 / pc : t1
      D g_t1[3];
      for (int k = 0; k < 3; ++k) g_t1[k] = upstream(up.g, up.stride, 6 + k, i);
      if (st.rr && L.adj) {
        D g_pc = 0.0;
        for (int k = 0; k < 3; ++k) {
          g_pc -= g_t1[k] * D(L.t1[k]) / (D(L.pc) * D(L.pc));
          g_t1[k] /= D(L.pc);
        }
        const D g_m = L.m >= P_MIN && L.m <= 1.f ? g_pc : 0.0;
        D g_m1 = 0.0;
        maximum_bwd(L.m1, L.t1[2], g_m, g_m1, g_t1[2]);
        maximum_bwd(L.t1[0], L.t1[1], g_m1, g_t1[0], g_t1[1]);
      }
      // t1 = c0 ? tp * at : tp
      D g_alb[3] = {0.0, 0.0, 0.0}, g_e[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < 3; ++k) {
        g_t[k] = L.c0 ? g_t1[k] * D(L.sc.at[k]) : g_t1[k];
        if (L.c0 && !L.sc.white) g_alb[k] += g_t1[k] * D(L.tp[k]);
      }
      D g_lc[3] = {0.0, 0.0, 0.0}, g_lr = 0.0, g_le[3] = {0.0, 0.0, 0.0};
      if (L.lit) {
        // ((tp * alb) * factor) * le
        D g_f = 0.0;
        for (int k = 0; k < 3; ++k) {
          const float x = mul(L.tp[k], L.alb[k]);
          const D g_y = g_r1[k] * D(L.le[k]);
          g_le[k] += g_r1[k] * D(mul(x, L.factor));
          g_f += g_y * D(x);
          const D g_x = g_y * D(L.factor);
          g_t[k] += g_x * D(L.alb[k]);
          g_alb[k] += g_x * D(L.tp[k]);
        }
        // factor = num / den_f; den_f = clamp_min(pdf_j / n + num, 1e-30)
        D g_num = g_f / D(L.den_f);
        const D g_den = L.denom >= EPS_DEN
            ? -g_f * D(L.num) / (D(L.den_f) * D(L.den_f)) : 0.0;
        g_num += g_den;
        const D g_cs = g_num * D(INV_PI);
        D g_ld[3];
        for (int k = 0; k < 3; ++k) {
          g_n[k] += g_cs * D(L.cone.ld[k]);
          g_ld[k] = g_cs * D(L.h.n[k]);
        }
        cone_bwd(L.cone, L.u5, L.lr, g_ld, g_den * D(st.inv_n), g_lc, g_lr,
                 g_ph);
      }
      D g_rad = 0.0;   // the winner's radius
      if (L.alive && L.hit) {
        // emission: (tp * emx) * emit_w
        D g_ew = 0.0;
        for (int k = 0; k < 3; ++k) {
          const float em = L.emit ? L.e[k] : 0.f;
          const D g_x = g_r1[k] * D(L.emit_w);
          g_ew += g_r1[k] * D(mul(L.tp[k], em));
          g_t[k] += g_x * D(em);
          if (L.emit) g_e[k] += g_x * D(L.tp[k]);
        }
        if (st.nee && L.use) {
          // emit_w = prev / (prev + pdf_sph / n)
          const D den = D(L.denom_e);
          g_prev += g_ew / den;
          const D g_den = -g_ew * D(L.prev) / (den * den);
          g_prev += g_den;
          D g_lce[3] = {0.0, 0.0, 0.0}, g_zero[3] = {0.0, 0.0, 0.0};
          sphere_pdf_bwd(L.pe, L.r, g_den * D(st.inv_n), 0.0, g_zero, g_lce,
                         g_rad, g_o);
          // lce = ph - (r * sgn) * n
          D g_rs = 0.0;
          for (int k = 0; k < 3; ++k) {
            g_ph[k] += g_lce[k];
            g_rs -= g_lce[k] * D(L.h.n[k]);
            g_n[k] -= g_lce[k] * D(L.rs);
          }
          g_rad += g_rs * D(L.h.sgn);
        }
        D g_fuzz = 0.0, g_ior = 0.0, g_c[3] = {0.0, 0.0, 0.0};
        if (L.cont) scatter_bwd(L, g_sd, g_d, g_n, g_fuzz, g_ior);
        rederive_bwd(L, g_ph, g_n, g_o, g_d, g_c, g_rad);
        slot_w = L.idx;
        for (int k = 0; k < 3; ++k) {
          gw[k] = g_c[k];
          gw[4 + k] = g_alb[k];
          gw[9 + k] = g_e[k];
        }
        gw[3] = g_rad;
        gw[7] = g_fuzz;
        gw[8] = g_ior;
      } else if (L.alive) {
        // A live miss: the sky, 0.5 * (dy * inv + 1) into (1 - s) + s * c.
        const InvLen il = inv_len_core(L.d[0], L.d[1], L.d[2]);
        const float s = mul(0.5f, add(mul(L.d[1], il.inv), 1.f));
        const float one_s = mul(sub(1.f, s), 1.f);
        const float sky_c[3] = {0.5f, SKY_G, 1.f};
        D g_s = 0.0;
        for (int k = 0; k < 3; ++k) {
          const float sky = add(one_s, mul(s, sky_c[k]));
          g_t[k] += g_r1[k] * D(sky);
          const D g_sky = g_r1[k] * D(L.tp[k]);
          g_s += -g_sky + g_sky * D(sky_c[k]);
        }
        const D g_dy = 0.5 * g_s;
        g_d[1] += g_dy * D(il.inv);
        inv_len_bwd(L.d, il, g_dy * D(L.d[1]), g_d);
      }
      if (L.lit) {
        slot_l = L.light;
        for (int k = 0; k < 3; ++k) {
          gl[k] = g_lc[k];
          gl[9 + k] = g_le[k];
        }
        gl[3] = g_lr;
        if (slot_l == slot_w) {
          for (int c = 0; c < REC; ++c) gw[c] += gl[c];
          slot_l = -1;
        }
      }
      float* g = gout + i;
      for (int k = 0; k < 3; ++k) {
        g[k * row] = static_cast<float>(g_o[k]);
        g[(3 + k) * row] = static_cast<float>(g_d[k]);
        g[(6 + k) * row] = static_cast<float>(g_t[k]);
      }
      g[9 * row] = static_cast<float>(g_prev);
    }
    if (!partials) continue;
    // Stage the tile's records; each row's first record sums the row.
    rec_slot[tid] = slot_w;
    rec_slot[BLOCK + tid] = slot_l;
    for (int c = 0; c < REC; ++c) {
      rec_val[c * TILE_RECS + tid] = static_cast<float>(gw[c]);
      rec_val[c * TILE_RECS + BLOCK + tid] = static_cast<float>(gl[c]);
    }
    if (slot_w >= 0) atomicMin(first + slot_w, tid);
    if (slot_l >= 0) atomicMin(first + slot_l, BLOCK + tid);
    __syncthreads();
    for (int half = 0; half < 2; ++half) {
      const int r0 = warp * 64 + half * 32;
      const int s0 = rec_slot[r0 + lane];
      unsigned leaders =
          __ballot_sync(0xFFFFFFFFu, s0 >= 0 && first[s0] == r0 + lane);
      while (leaders) {
        const int j = __ffs(leaders) - 1;
        leaders &= leaders - 1;
        const int s = rec_slot[r0 + j];
        float acc[REC];
        for (int c = 0; c < REC; ++c) acc[c] = 0.f;
        for (int q = lane; q < TILE_RECS; q += 32)
          if (rec_slot[q] == s)
            for (int c = 0; c < REC; ++c) acc[c] += rec_val[c * TILE_RECS + q];
        for (int off = 16; off > 0; off >>= 1)
          for (int c = 0; c < REC; ++c)
            acc[c] += __shfl_xor_sync(0xFFFFFFFFu, acc[c], off);
        if (lane == 0) {
          for (int c = 0; c < REC; ++c) part[s * REC + c] += acc[c];
          first[s] = NO_RECORD;
        }
      }
    }
    __syncthreads();
  }
  if (!partials) return;
  float* mine = partials + static_cast<size_t>(blockIdx.x) * slots * REC;
  for (int e = tid; e < slots * REC; e += BLOCK) mine[e] = part[e];
}

// The params gradient: the blocks' partials summed in block order, in
// double, into the table's columns (0 in the four it does not read).
__global__ void __launch_bounds__(BLOCK) diff_bounce_reduce_kernel(
    const float* __restrict__ partials, int blocks, int slots,
    float* __restrict__ gparams) {
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= slots * ROW) return;
  const int s = e / ROW, col = e % ROW;
  const int c = col < 9 ? col : col - 1;   // the record's column
  D sum = 0.0;
  if (col != 9 && col < 13)
    for (int b = 0; b < blocks; ++b)
      sum += D(partials[(static_cast<size_t>(b) * slots + s) * REC + c]);
  gparams[e] = static_cast<float>(sum);
}

Operands operands(const void* const* ptrs) {
  Operands a;
  for (int k = 0; k < N_FLOATS; ++k) a.f[k] = static_cast<const float*>(ptrs[k]);
  a.alive = static_cast<const bool*>(ptrs[P_ALIVE]);
  a.keys = static_cast<const long long*>(ptrs[P_KEYS]);
  a.idx = static_cast<const int*>(ptrs[P_IDX]);
  a.sh_idx = static_cast<const int*>(ptrs[P_SH_IDX]);
  return a;
}

Setup setup(const float* params, const int* light_idx, int n_lights,
            unsigned stream_id, int rr, float t_min) {
  Setup st;
  st.params = params;
  st.light_idx = light_idx;
  st.n_lights = n_lights;
  st.nee = n_lights > 0;
  st.inv_n = st.nee ? 1.f / static_cast<float>(n_lights) : 1.f;
  st.t_min = t_min;
  st.stream_word = stream_id * GOLDEN;
  st.rr = rr;
  return st;
}

int blocks_of(int n) { return n / BLOCK + (n % BLOCK != 0); }

// Shared memory of a backward block over `slots` params rows: the partial,
// the first-record ids, the tile's record ids and values.
int backward_smem(int slots) {
  return (slots * REC + slots + TILE_RECS + REC * TILE_RECS) * 4;
}

}  // namespace

// The C interface. ptrs: a host array of n_ptrs device pointers in the
// order of Op and OpOther ([n] f32 rows ox..rz, prev_pdf, t_sel and the
// shadow t; alive [n] bool, keys [n] int64 hash states, the winner's and the
// shadow ray's [n] i32 ids), null where the kernel reads none; params:
// [S, 16] f32; light_idx: [n_lights] i32, n_lights 0 for no NEE;
// stream_id: the bounce's RNG stream (STREAM_BOUNCE0 + depth); rr: nonzero
// for Russian roulette on this bounce. Each returns the cudaError_t of its
// launches.

// F1: rays [6, n] f32 (origin, direction) and cand [n] bool.
extern "C" int qtrt_diff_bounce_shadow(const void* const* ptrs, int n_ptrs,
                                       const float* params,
                                       const int* light_idx, int n_lights,
                                       unsigned stream_id, float t_min, int n,
                                       float* rays, bool* cand,
                                       void* stream) {
  if (n <= 0 || n_ptrs != N_OPS || ptrs == nullptr || n_lights <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Setup st = setup(params, light_idx, n_lights, stream_id, 0, t_min);
  diff_bounce_shadow_kernel<<<blocks_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(operands(ptrs), st, n, rays, cand);
  return static_cast<int>(cudaGetLastError());
}

// F2: out [13, n] f32 (ox..rz, prev_pdf) and alive_out [n] bool.
extern "C" int qtrt_diff_bounce(const void* const* ptrs, int n_ptrs,
                                const float* params, const int* light_idx,
                                int n_lights, unsigned stream_id, int rr,
                                float t_min, int n, float* out,
                                bool* alive_out, void* stream) {
  if (n <= 0 || n_ptrs != N_OPS || ptrs == nullptr || n_lights < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Setup st = setup(params, light_idx, n_lights, stream_id, rr, t_min);
  diff_bounce_kernel<<<blocks_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(operands(ptrs), st, n, out, alive_out);
  return static_cast<int>(cudaGetLastError());
}

// B: grads (a host array of 13 device pointers, the upstream gradients of
// ox..rz and prev_pdf, null for zero) with their strides in elements;
// gout [10, n] f32 (ox..dz, tx..tz, prev_pdf); with partials ([grid,
// slots, 12] f32 scratch) and gparams ([slots, 16] f32) also the params
// gradient, else both null. grid: the backward's blocks.
extern "C" int qtrt_diff_bounce_backward(
    const void* const* ptrs, int n_ptrs, const void* const* grads,
    const long long* strides, const float* params, const int* light_idx,
    int n_lights, int slots, unsigned stream_id, int rr, float t_min, int n,
    int grid, float* gout, float* partials, float* gparams, void* stream) {
  if (n <= 0 || n_ptrs != N_OPS || ptrs == nullptr || grads == nullptr ||
      strides == nullptr || n_lights < 0 || slots <= 0 || grid <= 0 ||
      (partials == nullptr) != (gparams == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Setup st = setup(params, light_idx, n_lights, stream_id, rr, t_min);
  Upstream up;
  for (int k = 0; k < 13; ++k) {
    up.g[k] = static_cast<const float*>(grads[k]);
    up.stride[k] = strides[k];
  }
  const int smem = partials ? backward_smem(slots) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(diff_bounce_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  diff_bounce_backward_kernel<<<grid, BLOCK, smem, st_>>>(operands(ptrs), st, up, n, slots, gout, partials);
  if (partials) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    diff_bounce_reduce_kernel<<<blocks_of(slots * 16), BLOCK, 0, st_>>>(partials, grid, slots, gparams);
  }
  return static_cast<int>(cudaGetLastError());
}
