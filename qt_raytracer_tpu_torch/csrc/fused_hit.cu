// Fused closest-hit query for sphere scenes, for Hopper (sm_90a).
//
// Replaces qt_raytracer_tpu/kernels/fused_hit.py::_fused_kernel in both of
// its modes (kernels A1 and A2 of ROADMAP Queue B), with and without the
// per-lane exclude operand. Full mode (A1, qtrt_fused_hit): per ray, sweep every sphere and
// keep the closest valid root (the lowest sphere id wins a tie), read the
// winner's 13 parameters, refine t with the stable root of the
// well-conditioned oc form, and emit the hit point, the front-face flag and
// the signed normal. Shadow mode (A2, qtrt_fused_hit_shadow, the TPU
// kernel's shadow_only=True): the same sweep, stopped after the
// min-then-match, emitting only the unrefined sweep minimum t and the lowest
// winning id (0 on a miss); next-event estimation feeds that t to the mesh
// search as its cap. The plain PyTorch version of both modes is
// fused_hit_plain in qt_raytracer_tpu_torch/kernels/fused_hit.py.
//
// Kernel A5 (qtrt_sphere_search) replaces
// qt_raytracer_tpu/kernels/sphere_intersect.py::_search_kernel_monolithic,
// the sphere search of the gradient integrator: the same sweep as A2 over
// the TPU kernel's table, padded to a multiple of 64 slots (padding at
// center 1e9 with |c|^2 - r^2 = BIG, ids at or above the scene's sphere
// count read back as 0), emitting (t, idx) with the same miss and dead-lane
// values. Its plain version is sphere_search_plain in
// qt_raytracer_tpu_torch/kernels/sphere_intersect.py. The TPU skips whole
// dead 128-ray rows and searches dead lanes of live rows; this kernel gates
// each lane, so every dead lane reads (BIG, 0).
//
// The exclude operand (A1, A2, A5; the edge-aware background re-trace of
// diff/edge.py): an optional [n] i32 array, one sphere id per lane in the
// sweep's own numbering, -1 for none. The excluded sphere is masked out of
// the candidates before the minimum, so the lowest-id tie rule holds among
// the rest; a lane whose only hit was its excluded sphere is a miss. It is a
// second template flag, so without the operand the instruction stream is
// the one measured before.
//
// Kernel A6 (qtrt_sphere_search_clustered) replaces
// sphere_intersect.py::_search_kernel, the cluster-culled sweep the TPU
// takes from 16 chunks of 64 Morton-ordered spheres (1,024 slots) on. Its
// result is the TPU kernel's lane for lane: a chunk is swept by a whole
// 128-ray row when any live lane of the row crosses the chunk's AABB (the
// TPU kernel's slab test, on boxes from the signed radius), so a lane's
// result depends on its row. The running (t_best, idx) starts at (BIG, 0)
// and updates on a strict '<' in ascending slot order, which is the TPU's
// per-chunk min-then-match followed by its strict 'better'. It takes no
// exclude operand, as on the TPU. Its plain version is
// sphere_search_clustered_plain; sphere_search_clustered_gated_plain
// runs its gates. A block is one row:
//   - The row's chunk mask, once. Every live lane slab-tests every chunk
//     box; each warp votes per chunk (__any_sync) and OR-s its bits into
//     ceil(K / 32) words in shared memory, in tiles of 2,048 chunks: one
//     barrier a tile, not one per chunk.
//   - Inside the opened chunks, A5's sweep: a warp takes a 32-slot group
//     when the group gate of one of its lanes passes under its running
//     t_best (boxes from |r|, prep_sphere_search builds them beside the
//     chunk boxes), with the root skip, __ldg broadcasts and no barrier.
//     The group gate keeps every candidate below t_best, and the slots stay
//     in ascending order, so the result is the row-gated sweep's bit for bit.
// Bound: 25 FLOPs per (live ray, slot of a group that its own gate opens in
// a chunk its row opens), 20 per group gate test and per chunk test.
// Measured, with chip_ab.py against the parent kernel on the same inputs
// (H100 80GB HBM3 at 700 W): the primary wavefront of chunk 2 of the 1080p
// clustered-scene frame (1,152 slots, 319,724 of 414,720 rays live, 6.4 of
// 36 groups swept a live lane) 0.18-0.21 ms against 0.43-0.47; a bounce-1
// wavefront (82,338 live) 0.21-0.24 against 0.51-0.56. A5's sweep of the
// same table takes 0.20-0.21 and 0.20-0.22 ms (chip_smoke.py): where few
// lanes of a row live, a block has about one busy warp.
//
// What bounds it on the H100. A swept pair costs about 25 single-rounded
// FP32 operations, and where its discriminant is not negative an IEEE
// square root, two roots and their compares: the instruction rate, not
// memory (a 414,720-ray launch moves some 41 MB). Every add and multiply
// is its own instruction (no FMA, for the bits), so the instruction rate
// sets the floor; the one lever is to test fewer pairs. On the book-cover
// scene a ray's segment meets few of the 487 spheres, the slots are in grid
// order (runs of consecutive slots are compact in space), and the bounce
// wavefronts are mostly dead lanes (the sphere path does not compact them).
//
// What the design does about it. Four things, none of which changes a bit:
//   - Group gate. prep_fused_spheres builds, per group of GROUP_S = 32
//     consecutive slots, the AABB of its active spheres and ext, the
//     largest |c|_1 + |r| among them (sweep_boxes; the sweep sees only
//     r^2, so a hollow sphere's negative r bounds the same sphere). A lane
//     opens a group when its segment [t_min, t_best] meets the box widened
//     by 2^-8 (|o|_1 + ext); a warp sweeps the group when one of its lanes
//     opens it. In f32 a root of the expanded form lies within |r| + 1.1e-3
//     (|o| + |c| + |r|) of its sphere's centre (the rounding of disc, some
//     20 ulps of a (|o| + |c| + |r|)^2, and of the root's own terms), so a
//     group the gate skips holds no candidate below t_best; slots stay in
//     ascending order, so the strict '<' keeps the lowest id on ties.
//   - Root skip. A warp takes the square root, the roots and their compares
//     of a slot only when one of its live lanes has disc >= 0
//     (__any_sync); the others' candidate is BIG, as before.
//   - Compaction. A block's live lanes are packed (a ballot and a prefix
//     over the warps in shared memory), so ceil(live / 32) warps sweep, each
//     with 32 live rays, and write their rays' outputs; the dead lanes get
//     their defaults first.
//   - No block barrier in the sweep. Sphere rows and group boxes are read
//     with __ldg at warp-uniform addresses (one broadcast from L1), so each
//     warp gates, skips and finishes on its own.
// Shadow mode (A2) and A5 run this sweep too: A2 writes 2 words a ray
// instead of 19 and skips the refinement; A5's table is padded to a
// multiple of 64 slots, and its group boxes leave the padding out.
// Measured, with chip_ab.py against the parent's one-thread-a-ray sweep on
// the same inputs (H100 80GB HBM3 at 700 W): A1 on the 414,720 primary rays
// of book-cover chunk 0 0.127 ms against 0.502 (74 of 512 slots swept per
// live ray); on its bounce-2 wavefront (7% live) 0.119 against 0.215; A5
// 0.111 against 0.489; A2 on the Cornell-mesh shadow rays 0.073 against
// 0.190. A sparse bounce wavefront leaves few warps with work, and those
// run one slot after another: latency, not the instruction rate, bounds it
// there. Tried and not kept (PERF.md §6): groups of 16 and 64 slots, blocks
// of 64 and 128 rays (no gain), and a power-of-two set of lanes per ray in
// sparse blocks, each lane taking every L-th slot of a group (faster on
// the sparsest wavefronts, 6-9% slower on the primary one).
//
// Numerics. Every add and multiply is rounded on its own (__fmul_rn and
// friends stop nvcc from contracting them into FMAs), and divides and square
// roots are IEEE-rounded (no --use_fast_math). So the kernel rounds as the
// plain PyTorch version does, op by op, and the refinement's cancelling
// |oc|^2 - r^2 (r = 1000 for the ground sphere) is not shifted by a
// contraction. The strict '<' of the running minimum, in ascending sphere
// order, gives the lowest index on ties, as the TPU kernel's min-then-match
// does. A dead lane gets the defaults the TPU kernel writes on a dead row; a
// live lane that misses carries sphere 0's parameters and t_safe = 1
// geometry, as there.

#include <cuda_runtime.h>

#include "block_pack.cuh"

namespace {

using qtrt_pack::block_pack;

constexpr float BIG = 3.0e38f;
constexpr int BLOCK = 256;     // rays per block
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
// The group gate's padding: 2^-8 of |o|_1 + max(|c|_1 + |r|) over the group,
// some 3.5 times the widest the expanded-form root can stray from its
// sphere in f32 (the header comment).
constexpr float GATE_PAD = 1.0f / 256.0f;

// Rows of the [16, n] float and [3, n] int outputs, in the order of the
// wrapper's NAMES.
enum FRow { F_T, F_PX, F_PY, F_PZ, F_NX, F_NY, F_NZ, F_AX, F_AY, F_AZ,
            F_FUZZ, F_IOR, F_EX, F_EY, F_EZ, F_RW, N_FROWS };
enum IRow { I_IDX, I_MAT, I_FF, N_IROWS };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// (ax*bx + ay*by) + az*bz, rounded as the plain version's tensor ops round.
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// Slab reciprocal of one direction component, as the TPU kernels take it:
// 1 / (|d| < 1e-30 ? (d < 0 ? -1e-30 : 1e-30) : d).
__device__ __forceinline__ float slab_inv(float d) {
  const float c = fabsf(d) < 1e-30f ? (d < 0.f ? -1e-30f : 1e-30f) : d;
  return __fdiv_rn(1.f, c);
}

// The group gate of one lane: true unless the ray's segment [t_min, t_best]
// misses the group's box widened by GATE_PAD * (|o|_1 + ext) (lo.w = ext, -1
// for a group without an active sphere, which is never opened).
__device__ __forceinline__ bool group_open(float4 lo, float4 hi,
                                           const float o[3],
                                           const float inv[3], float o_l1,
                                           float t_min, float t_best) {
  if (!(lo.w >= 0.f)) return false;
  const float pad = mul(add(o_l1, lo.w), GATE_PAD);
  const float l[3] = {sub(lo.x, pad), sub(lo.y, pad), sub(lo.z, pad)};
  const float h[3] = {add(hi.x, pad), add(hi.y, pad), add(hi.z, pad)};
  float en = t_min, ex = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = mul(sub(l[a], o[a]), inv[a]);
    const float t1 = mul(sub(h[a], o[a]), inv[a]);
    en = fmaxf(en, fminf(t0, t1));
    ex = fminf(ex, fmaxf(t0, t1));
  }
  return ex >= en && en <= t_best;
}

// Dead-lane values of full mode (the TPU kernel's dead-row defaults).
__device__ __forceinline__ void write_defaults(float* f, int* g, size_t row) {
  const float fdef[N_FROWS] = {BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f,
                               0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < N_FROWS; ++r) f[r * row] = fdef[r];
#pragma unroll
  for (int r = 0; r < N_IROWS; ++r) g[r * row] = 0;
}

// A ray as the sweep reads it: its origin and direction, and the terms of
// the expanded-form quadratic and of the group gate that depend on the ray
// alone. A lane without a ray gets o = 0, d = (0, 0, 1).
struct SweepRay {
  float o[3], d[3], inv[3];
  float a, o_dot_d, o2, inv_a, o_l1;
};

__device__ __forceinline__ SweepRay sweep_ray(
    bool live, int i, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz) {
  SweepRay r = {{0.f, 0.f, 0.f}, {0.f, 0.f, 1.f}};
  if (live) {
    r.o[0] = ox[i]; r.o[1] = oy[i]; r.o[2] = oz[i];
    r.d[0] = dx[i]; r.d[1] = dy[i]; r.d[2] = dz[i];
  }
  r.a = dot3(r.d[0], r.d[1], r.d[2], r.d[0], r.d[1], r.d[2]);
  r.o_dot_d = dot3(r.o[0], r.o[1], r.o[2], r.d[0], r.d[1], r.d[2]);
  r.o2 = dot3(r.o[0], r.o[1], r.o[2], r.o[0], r.o[1], r.o[2]);
  r.inv_a = __fdiv_rn(1.f, r.a);
#pragma unroll
  for (int k = 0; k < 3; ++k) r.inv[k] = slab_inv(r.d[k]);
  r.o_l1 = add(add(fabsf(r.o[0]), fabsf(r.o[1])), fabsf(r.o[2]));
  return r;
}

// Group gi of the sweep (slots [gi * group, min(s, gi * group + group))),
// on the warp that calls it: swept by every live lane when the group gate
// of one of them passes under its running minimum, with the strict '<'
// update of (t_best, best) in ascending slot order. EXCL: the slot ex is
// never a candidate. Every lane of the warp must call it.
template <bool EXCL>
__device__ __forceinline__ void sweep_group(
    const float4* __restrict__ spheres, const float4* __restrict__ boxes,
    int gi, int group, int s, const SweepRay& r, bool live, float t_min,
    int ex, float& t_best, int& best) {
  const bool open = live && group_open(__ldg(boxes + 2 * gi),
                                       __ldg(boxes + 2 * gi + 1), r.o, r.inv,
                                       r.o_l1, t_min, t_best);
  if (!__any_sync(FULL, open)) return;
  const int base = gi * group;
  const int end = min(s, base + group);
#pragma unroll 4
  for (int k = base; k < end; ++k) {
    const float4 c = __ldg(spheres + k);
    const float d_dot_c = dot3(c.x, c.y, c.z, r.d[0], r.d[1], r.d[2]);
    const float o_dot_c = dot3(c.x, c.y, c.z, r.o[0], r.o[1], r.o[2]);
    const float half_b = sub(r.o_dot_d, d_dot_c);
    const float cterm = add(sub(r.o2, mul(2.f, o_dot_c)), c.w);
    const float disc = sub(mul(half_b, half_b), mul(r.a, cterm));
    // A lane with disc < 0 has no candidate (BIG), whatever the roots:
    // the warp skips the root unless one of its lanes needs it.
    if (!__any_sync(FULL, live && disc >= 0.f)) continue;
    const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
    const float near = mul(sub(-half_b, sq), r.inv_a);
    const float far = mul(add(-half_b, sq), r.inv_a);
    const bool near_ok = near >= t_min && near <= BIG;
    const bool far_ok = far >= t_min && far <= BIG;
    const float root = near_ok ? near : far;
    bool valid = disc >= 0.f && (near_ok || far_ok);
    if constexpr (EXCL) valid = valid && k != ex;
    const float cand = valid ? root : BIG;
    if (cand < t_best) {
      t_best = cand;
      best = k;
    }
  }
}

// The body of A1, A2 and A5. SHADOW: stop after the sweep and write only
// rows F_T and I_IDX (the outputs are then [1, n] each, and params is not
// read); a winner id at or above num_ids (a padding slot of the
// sphere-search table) is written as 0. spheres: [s] float4 sweep rows;
// boxes: [ceil(s / group)] pairs of float4, the group boxes. Every thread
// of the block must call it: it synchronises the block.
template <bool SHADOW, bool EXCL>
__device__ __forceinline__ void fused_hit_body(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const int* __restrict__ excl,
    const float4* __restrict__ spheres, const float4* __restrict__ boxes,
    const float4* __restrict__ params, int s, int group, int num_ids,
    float t_min, int n, float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ int lanes[BLOCK];
  __shared__ int warp_live[WARPS];
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(n);

  // --- dead lanes get their defaults; live lanes are compacted ---
  const int i0 = blockIdx.x * BLOCK + threadIdx.x;
  const bool live0 = i0 < n && alive[i0];
  if (i0 < n && !live0) {
    if constexpr (SHADOW) {
      fout[i0] = BIG;
      iout[i0] = 0;
    } else {
      write_defaults(fout + i0, iout + i0, row);
    }
  }
  const int total = block_pack<BLOCK>(live0, i0, lanes, warp_live);
  // Warp w sweeps the live rays [32 w, 32 w + 32) of the block, in lane
  // order; a warp past them has nothing to do.
  if (warp * 32 >= total) return;
  const bool live = threadIdx.x < total;
  const int i = live ? lanes[threadIdx.x] : 0;

  // The lane's excluded sphere id (-1: none); read only when EXCL.
  int ex = -1;
  if constexpr (EXCL) {
    if (live) ex = excl[i];
  }
  const SweepRay r = sweep_ray(live, i, ox, oy, oz, dx, dy, dz);

  // --- closest-hit sweep (expanded-form quadratic, as the TPU sweep) ---
  float t_best = BIG;
  int best = 0;
  for (int gi = 0; gi * group < s; ++gi)
    sweep_group<EXCL>(spheres, boxes, gi, group, s, r, live, t_min, ex,
                      t_best, best);
  if (!live) return;

  float* f = fout + i;
  int* g = iout + i;
  if constexpr (SHADOW) {
    // Unrefined t_best and the lowest winning id (0 on a miss).
    f[0] = t_best;
    g[0] = best < num_ids ? best : 0;
    return;
  }
  const int idx = best;  // 0 on a miss: sphere 0's parameters, as in JAX
  // --- winner parameters: cx cy cz r | ax ay az fuzz | ior mat ex ey | ez ---
  const float4 p0 = params[4 * idx + 0];
  const float4 p1 = params[4 * idx + 1];
  const float4 p2 = params[4 * idx + 2];
  const float4 p3 = params[4 * idx + 3];
  const float cw_x = p0.x, cw_y = p0.y, cw_z = p0.z, r_w = p0.w;
  const float o_x = r.o[0], o_y = r.o[1], o_z = r.o[2];
  const float d_x = r.d[0], d_y = r.d[1], d_z = r.d[2];
  const float a = r.a;

  // --- refinement: well-conditioned oc form with stable roots ---
  const bool hit = t_best < BIG;
  const float oc_x = sub(o_x, cw_x), oc_y = sub(o_y, cw_y), oc_z = sub(o_z, cw_z);
  const float half_b1 = dot3(oc_x, oc_y, oc_z, d_x, d_y, d_z);
  const float c1 = sub(dot3(oc_x, oc_y, oc_z, oc_x, oc_y, oc_z), mul(r_w, r_w));
  const float disc1 = sub(mul(half_b1, half_b1), mul(a, c1));
  const float sq1 = disc1 > 0.f ? __fsqrt_rn(disc1) : 0.f;
  const float sq_signed = half_b1 >= 0.f ? sq1 : -sq1;
  const float q1 = sub(-half_b1, sq_signed);
  const float root_a = __fdiv_rn(q1, a);
  const float root_b = q1 == 0.f ? 0.f : __fdiv_rn(c1, q1);
  const float near1 = half_b1 >= 0.f ? root_a : root_b;
  const float far1 = half_b1 >= 0.f ? root_b : root_a;
  const bool near_ok1 = near1 >= t_min && near1 <= BIG;
  const float t_fine = near_ok1 ? near1 : far1;
  const bool fine_ok =
      disc1 >= 0.f && (near_ok1 || (far1 >= t_min && far1 <= BIG));
  const float t = (hit && fine_ok) ? t_fine : t_best;

  // --- geometry at the hit (miss lanes get benign finite values) ---
  const float t_safe = hit ? t : 1.f;
  const float p_x = add(o_x, mul(t_safe, d_x));
  const float p_y = add(o_y, mul(t_safe, d_y));
  const float p_z = add(o_z, mul(t_safe, d_z));
  const float r_safe = r_w == 0.f ? 1.f : r_w;
  const float ow_x = __fdiv_rn(sub(p_x, cw_x), r_safe);
  const float ow_y = __fdiv_rn(sub(p_y, cw_y), r_safe);
  const float ow_z = __fdiv_rn(sub(p_z, cw_z), r_safe);
  const bool ff = dot3(d_x, d_y, d_z, ow_x, ow_y, ow_z) < 0.f;
  const float sgn = ff ? 1.f : -1.f;

  f[F_T * row] = t;
  f[F_PX * row] = p_x;
  f[F_PY * row] = p_y;
  f[F_PZ * row] = p_z;
  f[F_NX * row] = sgn * ow_x;
  f[F_NY * row] = sgn * ow_y;
  f[F_NZ * row] = sgn * ow_z;
  f[F_AX * row] = p1.x;
  f[F_AY * row] = p1.y;
  f[F_AZ * row] = p1.z;
  f[F_FUZZ * row] = p1.w;
  f[F_IOR * row] = p2.x;
  f[F_EX * row] = p2.z;
  f[F_EY * row] = p2.w;
  f[F_EZ * row] = p3.x;
  f[F_RW * row] = r_w;
  g[I_IDX * row] = idx;
  g[I_MAT * row] = static_cast<int>(p2.y);
  g[I_FF * row] = ff ? 1 : 0;
}

// A1 (SHADOW = false) and A2 (SHADOW = true), each with (EXCL = true) or
// without the exclude operand.
template <bool SHADOW, bool EXCL>
__global__ void __launch_bounds__(BLOCK) fused_hit_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const int* __restrict__ excl,
    const float4* __restrict__ spheres, const float4* __restrict__ boxes,
    const float4* __restrict__ params, int s, int group, float t_min, int n,
    float* __restrict__ fout, int* __restrict__ iout) {
  fused_hit_body<SHADOW, EXCL>(ox, oy, oz, dx, dy, dz, alive, excl, spheres,
                               boxes, params, s, group, s, t_min, n, fout,
                               iout);
}

// A5: the sweep over a table padded to a multiple of 64 slots (padding ids
// read back as 0), emitting (t, idx) as A2 does.
template <bool EXCL>
__global__ void __launch_bounds__(BLOCK) sphere_search_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const int* __restrict__ excl,
    const float4* __restrict__ spheres, const float4* __restrict__ boxes,
    int s_pad, int group, int num_spheres, float t_min, int n,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  fused_hit_body<true, EXCL>(ox, oy, oz, dx, dy, dz, alive, excl, spheres,
                             boxes, nullptr, s_pad, group, num_spheres, t_min,
                             n, t_out, idx_out);
}

// ------------------------------------------------------------------ A6
constexpr int ROW = 128;      // rays per block: one TPU ray row, the gate's unit
constexpr int CHUNK_S = 64;   // spheres per Morton chunk
constexpr int MASK_WORDS = 64;  // chunk-mask words per tile: 2,048 chunks

// The TPU kernel's chunk gate of one lane: its segment crosses chunk ck's
// AABB (enter clamped at t_min, exit > enter strict), in the TPU's order.
__device__ __forceinline__ bool chunk_crossed(const float* __restrict__ cb,
                                              int ks, int ck,
                                              const SweepRay& r,
                                              float t_min) {
  const float t0x = mul(sub(__ldg(cb + ck), r.o[0]), r.inv[0]);
  const float t1x = mul(sub(__ldg(cb + 3 * ks + ck), r.o[0]), r.inv[0]);
  const float t0y = mul(sub(__ldg(cb + ks + ck), r.o[1]), r.inv[1]);
  const float t1y = mul(sub(__ldg(cb + 4 * ks + ck), r.o[1]), r.inv[1]);
  const float t0z = mul(sub(__ldg(cb + 2 * ks + ck), r.o[2]), r.inv[2]);
  const float t1z = mul(sub(__ldg(cb + 5 * ks + ck), r.o[2]), r.inv[2]);
  const float enter =
      fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
            fmaxf(fminf(t0z, t1z), t_min));
  const float exit_ =
      fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  return exit_ > enter;
}

// A6: one block per 128-ray row (the header comment). Per tile of up to
// 32 * MASK_WORDS chunks: the row's chunk mask (each warp's vote per
// chunk, OR-ed into shared words), one barrier, then each warp sweeps the
// opened chunks in ascending order with the gated sweep of A5.
__global__ void __launch_bounds__(ROW) sphere_search_clustered_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float4* __restrict__ spheres,
    const float4* __restrict__ boxes, int group,
    const float* __restrict__ chunk_boxes, int num_chunks, int k_stride,
    int num_spheres, float t_min, int n, float* __restrict__ t_out,
    int* __restrict__ idx_out) {
  __shared__ int lanes[ROW];
  __shared__ int warp_live[ROW / 32];
  __shared__ unsigned mask[MASK_WORDS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // --- dead lanes get the miss values; live lanes are compacted ---
  const int i0 = blockIdx.x * ROW + threadIdx.x;
  const bool live0 = i0 < n && alive[i0];
  if (i0 < n && !live0) {
    t_out[i0] = BIG;
    idx_out[i0] = 0;
  }
  const int total = block_pack<ROW>(live0, i0, lanes, warp_live);
  if (total == 0) return;  // a dead row: no search
  // Warps past the live rays take part in the barriers only.
  const bool busy = warp * 32 < total;
  const bool live = threadIdx.x < total;
  const int i = live ? lanes[threadIdx.x] : 0;
  const SweepRay r = sweep_ray(live, i, ox, oy, oz, dx, dy, dz);
  const int per_chunk = CHUNK_S / group;
  const int s = num_chunks * CHUNK_S;

  float t_best = BIG;
  int best = 0;
  for (int c0 = 0; c0 < num_chunks; c0 += 32 * MASK_WORDS) {
    const int nc = min(num_chunks - c0, 32 * MASK_WORDS);
    const int words = (nc + 31) / 32;
    for (int w = threadIdx.x; w < words; w += ROW) mask[w] = 0u;
    __syncthreads();
    if (busy) {
      for (int w = 0; w < words; ++w) {
        unsigned bits = 0u;
        const int m = min(32, nc - 32 * w);
        for (int b = 0; b < m; ++b) {
          const bool cross =
              live && chunk_crossed(chunk_boxes, k_stride, c0 + 32 * w + b,
                                    r, t_min);
          bits |= (__any_sync(FULL, cross) ? 1u : 0u) << b;
        }
        if (lane == 0 && bits != 0u) atomicOr(mask + w, bits);
      }
    }
    __syncthreads();
    if (busy) {
      for (int w = 0; w < words; ++w) {
        for (unsigned todo = mask[w]; todo; todo &= todo - 1) {
          const int ck = c0 + 32 * w + __ffs(todo) - 1;
          for (int gi = ck * per_chunk; gi < (ck + 1) * per_chunk; ++gi)
            sweep_group<false>(spheres, boxes, gi, group, s, r, live, t_min,
                               -1, t_best, best);
        }
      }
    }
    // The mask is cleared for the next tile only when every warp is done.
    __syncthreads();
  }
  if (!live) return;
  t_out[i] = t_best;
  idx_out[i] = best < num_spheres ? best : 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// excl: [n] i32 excluded sphere id per lane (-1: none), or null for no
// exclude operand; spheres: [s, 4] f32 rows (cx, cy, cz,
// |c|^2 - r^2 + BIG*inactive); boxes: [ceil(s / group), 8] f32 group boxes
// (lo xyz, ext | hi xyz, 0; ext = max |c|_1 + |r| over the group's active
// spheres, -1 for none); params: [s, 16] f32 rows of packed_param_table;
// fout: [16, n] f32; iout: [3, n] i32. All pointers are device pointers;
// spheres, boxes, params, fout and iout 16-byte aligned.
extern "C" int qtrt_fused_hit(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const bool* alive, const int* excl,
                              const float* spheres, const float* boxes,
                              const float* params, int s, int group,
                              float t_min, int n, float* fout, int* iout,
                              void* stream) {
  if (n <= 0 || s <= 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  const float4* sp = reinterpret_cast<const float4*>(spheres);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  const float4* pa = reinterpret_cast<const float4*>(params);
  if (excl != nullptr) {
    fused_hit_kernel<false, true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, excl, sp, bx, pa, s, group, t_min, n,
        fout, iout);
  } else {
    fused_hit_kernel<false, false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, nullptr, sp, bx, pa, s, group, t_min,
        n, fout, iout);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shadow mode (kernel A2). Same ray, exclude, sphere and box operands as
// qtrt_fused_hit, no parameter table; t_out: [n] f32 (unrefined sweep
// minimum, BIG on a miss or a dead lane); idx_out: [n] i32 (lowest winning
// id, 0 on a miss or a dead lane). Returns the cudaError_t of the launch.
extern "C" int qtrt_fused_hit_shadow(const float* ox, const float* oy,
                                     const float* oz, const float* dx,
                                     const float* dy, const float* dz,
                                     const bool* alive, const int* excl,
                                     const float* spheres, const float* boxes,
                                     int s, int group, float t_min, int n,
                                     float* t_out, int* idx_out,
                                     void* stream) {
  if (n <= 0 || s <= 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  const float4* sp = reinterpret_cast<const float4*>(spheres);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  if (excl != nullptr) {
    fused_hit_kernel<true, true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, excl, sp, bx, nullptr, s, group, t_min,
        n, t_out, idx_out);
  } else {
    fused_hit_kernel<true, false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, nullptr, sp, bx, nullptr, s, group,
        t_min, n, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sphere search (kernel A5). excl: [n] i32 excluded slot id per lane (-1:
// none) or null; spheres: [s_pad, 4] f32 rows from
// prep_sphere_search (inactive slots biased by +BIG, padding slots at
// center 1e9 with |c|^2 - r^2 = BIG); boxes: [ceil(s_pad / group), 8] f32
// group boxes as for qtrt_fused_hit; t_out: [n] f32 (unrefined sweep
// minimum, BIG on a miss or a dead lane); idx_out: [n] i32 (lowest winning
// id below num_spheres, 0 on a miss or a dead lane). Returns the
// cudaError_t of the launch.
extern "C" int qtrt_sphere_search(const float* ox, const float* oy,
                                  const float* oz, const float* dx,
                                  const float* dy, const float* dz,
                                  const bool* alive, const int* excl,
                                  const float* spheres, const float* boxes,
                                  int s_pad, int group, int num_spheres,
                                  float t_min, int n, float* t_out,
                                  int* idx_out, void* stream) {
  if (n <= 0 || s_pad <= 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  const float4* sp = reinterpret_cast<const float4*>(spheres);
  const float4* bx = reinterpret_cast<const float4*>(boxes);
  if (excl != nullptr) {
    sphere_search_kernel<true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, excl, sp, bx, s_pad, group,
        num_spheres, t_min, n, t_out, idx_out);
  } else {
    sphere_search_kernel<false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, nullptr, sp, bx, s_pad, group,
        num_spheres, t_min, n, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Cluster-culled sphere search (kernel A6). spheres: [num_chunks * 64, 4]
// f32 rows from prep_sphere_search; boxes: [num_chunks * 64 / group, 8] f32
// group boxes as for qtrt_sphere_search (group divides 64); chunk_boxes:
// [6, k_stride] f32 (lo xyz, hi xyz of each chunk's AABB over center +-
// radius of its active spheres; BIG/-BIG where a chunk has none), k_stride
// >= num_chunks. Outputs as A5. Returns the cudaError_t of the launch.
extern "C" int qtrt_sphere_search_clustered(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const bool* alive, const float* spheres,
    const float* boxes, int group, const float* chunk_boxes, int num_chunks,
    int k_stride, int num_spheres, float t_min, int n, float* t_out,
    int* idx_out, void* stream) {
  if (n <= 0 || num_chunks <= 0 || k_stride < num_chunks || group <= 0 ||
      CHUNK_S % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / ROW + (n % ROW != 0);
  sphere_search_clustered_kernel<<<grid, ROW, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, alive, reinterpret_cast<const float4*>(spheres),
      reinterpret_cast<const float4*>(boxes), group, chunk_boxes, num_chunks,
      k_stride, num_spheres, t_min, n, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
