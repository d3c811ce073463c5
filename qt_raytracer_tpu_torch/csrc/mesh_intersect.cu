// Clustered triangle-mesh search for Hopper (sm_90a): kernels A3 and A4.
//
// A3, qtrt_mesh_search, replaces
// qt_raytracer_tpu/kernels/mesh_intersect.py::_mesh_kernel with each of its
// visit bodies, and ::_mesh_kernel_rowgate, with and without the per-lane
// exclude operand: per ray, the closest triangle hit strictly below a
// per-lane cap, with ties going to the lowest BVH-order triangle id; a
// lane's excluded triangle (a BVH-order id, -1 for none; the edge-aware
// background re-trace of diff/edge.py) fails the accept test of every
// visit, as on the TPU (mesh_intersect.py:345-346, :470). The operand and
// the body are template parameters; VPU and ROWGATE run on the warp-per-ray
// search described below (mesh_search_kernel<EXCL, MODE>), MXU on a block
// kernel of its own (mesh_search_mxu_kernel<EXCL>, "A3m" below):
//   - VPU (mt="vpu", visit "full"; "subtile" and "sliced" too, see below):
//     Moller-Trumbore on the triangle planes (visit_vpu, :360).
//   - ROWGATE (visit="rowgate"; _mesh_kernel_rowgate :233, visit_rowgate
//     :499, prep_row_boxes :163): in a cluster that passes the lane's gate,
//     each 128-triangle row is slab-tested first against its own
//     epsilon-padded box under the lane's running cap at that moment, and
//     skipped when it fails. t_best only shrinks, so a row that fails could
//     never pass later: the same bits as VPU. Row boxes are 6 flat arrays
//     read from global memory (scalar prefetch to SMEM on the TPU), tested
//     by the very slab function that tests the cluster boxes.
//   - MXU (mt="mxu"; visit_mxu :324, build_mt_features :190): det, u*det,
//     v*det and t*det as bilinear forms of the ray's (d, o x d, o, 1) and
//     19 per-triangle factors. The candidates round otherwise than VPU's,
//     so it agrees with VPU without being bitwise equal. Its products run
//     on the tensor cores as a filter, and the scalar form decides (A3m,
//     after A3's notes).
// The TPU's visit_subtile (:484) and visit_sliced (:412) re-tile the visit
// into (SUBTILE_ROWS rays, 128 triangles) slices with the same expression
// tree, sliced also skipping slices that no lane's gate opened; both give
// full's bits. A warp gating each cluster on its one ray's own cap is at
// least as fine as any slice, so both run the VPU instance. The plain
// PyTorch version is mesh_search_plain in
// qt_raytracer_tpu_torch/kernels/mesh_intersect.py. A4 is described at the
// end of this comment.
//
// Layout (prep_mesh_clusters): triangles are BVH-ordered and packed into k
// clusters of g consecutive triangles (g = cluster_rows * 128, 512 by
// default, for multi-cluster meshes), padded with degenerate triangles;
// tris is [9, p_stride] f32 (v0, e1, e2, one component per row), or for
// MXU [19, p_stride] f32 (the factors, one per row); boxes is [6, k_stride]
// f32 (lo xyz, hi xyz), the epsilon-padded cluster AABBs; rows (ROWGATE) is
// [6, r_stride] f32, the epsilon-padded AABB of each 128-triangle row.
//
// What bounds it on the H100. Moller-Trumbore is some 45 single-rounded
// FP32 operations (a divide among them) and 9 loads per ray-triangle pair.
// A ray visits the clusters whose box its segment enters before its
// running hit: on the 1080p terrain (99,458 triangles, 195 clusters of
// 512) some 7 a primary ray, and a grazing ray up to 41. The parent kernel
// ran one thread per ray, so a warp ran the union of its 32 lanes' visits,
// 512 triangles each, one after the other: a warp with one grazing lane
// paid for 41 clusters while the other lanes idled (PERF.md §6: masking
// out all but the 0.4% of bounce rays that cross more than 24 clusters
// left the sorted sweep's time as it was). With that gone, what remains is
// the pairs themselves: instructions, and the bytes of the triangles each pair
// reads (36 a triangle, from L2 when L1 misses).
//
// What the design does about it. One warp per ray, the parallelism inside
// a visited cluster moved from rays to the (ray, triangle) pairs:
//   - The cluster gate. Lane j slab-tests cluster base + j, 32 clusters at
//     a time, under the ray's cap at the start of those 32 (a ballot); the
//     warp then visits the passing ones in ascending order, each tested
//     again under the cap of its turn, so the warp visits exactly the
//     clusters the parent's per-lane gate visited: the slab entry at most
//     t_best * 1.0001 + 1e-4 (clamped below 1e37), the TPU kernel's gate
//     (mesh_intersect.py:568-602) taken per ray. The slack and the
//     epsilon-padded boxes keep it conservative: a triangle the ray hits
//     lies inside its cluster's box by the padding on every axis, so the
//     gate never drops a winner.
//   - The visit. Lane l tests triangles lo + l, lo + l + 32, ... of the
//     cluster (under ROWGATE, of each row whose own gate passes at its
//     turn; lanes 0-3 test the row boxes at once): neighbouring lanes read
//     neighbouring triangles, 128 coalesced bytes a plane. Each lane keeps
//     its own strict-'<' (t, id) from the ray's cap; a butterfly of
//     __shfl_xor_sync takes the lexicographic minimum, which becomes the
//     ray's hit when it beats the cap. A candidate's t does not depend on
//     the cap, so this is the serial sweep's result, ties to the lowest id
//     (tests/test_torch_hit_order.py holds the argument on the CPU).
//   - A warp's time is its own ray's visits; a heavy ray costs 16
//     iterations a cluster (4 a row) instead of 512 (128). Blocks of 4
//     warps take 4 consecutive rays, and the block scheduler hands the
//     blocks out as SMs free up, so heavy rays do not hold an SM idle.
// Measured, with chip_ab.py against the parent's kernel on the same inputs
// (H100 80GB HBM3 at 700 W): the sorted primary wavefront of terrain chunk 2
// (414,720 rays) VPU 5.46 ms against 8.45, ROWGATE 2.73 against 3.50; its
// sorted bounce-2 wavefront (193,363 live) VPU 2.11 against 14.8, ROWGATE
// 1.13 against 8.85. On the primary wavefront every pair reads its own
// triangle, 18 KB a visit a ray where the parent read it once a warp: the
// L1 and L2 traffic of some 47 million warp-iterations is what takes the
// time there. Tried and not kept (PERF.md §6): a warp taking 4 or 16
// consecutive rays in turn, blocks of 8 warps, and a warp-wide skip of v,
// t and the accept test when no lane's u lies in [0, 1] (none faster on
// both wavefronts).
//
// Numerics: mesh_common.cuh (every op rounded on its own, the TPU kernel's
// expression tree). In ascending triangle order, the strict '<' update of
// the running minimum is the TPU's per-row min-then-match followed by its
// strict 'better'. A dead lane gets t = BIG and idx = 0 (the TPU leaves dead
// lanes unspecified; every caller masks them).
//
// A3m, the MXU instance (mesh_search_mxu_kernel<EXCL>), replaces visit_mxu
// (qt_raytracer_tpu/kernels/mesh_intersect.py:324, factors from
// build_mt_features :190): the TPU takes det, u*det, v*det and t*det as
// four [128 rays, q] @ [q, 128 triangles] products on its matrix unit.
// Its bits are those of the scalar bilinear form (moller_trumbore_bilinear,
// mesh_common.cuh), held against mesh_search_plain(mt="mxu").
//   - What bounded it. Run as scalar FP32 on the warp-per-ray search, every
//     (ray, triangle) pair loaded its triangle's 19 factors (76 bytes) from
//     L1/L2 and spent 45 operations on them; crossing-sorted neighbouring
//     rays visit the same clusters, but nothing shared the loads.
//   - What the design does. A block takes MXU_BLOCK_RAYS = 64 consecutive
//     (crossing-sorted) rays, whose A operands, exact-test data and running
//     hits it keeps in shared memory, and walks the clusters in ascending
//     order; each ray's gate is A3's (the slacked, capped slab test under
//     the ray's running cap at the cluster's turn). At a cluster's turn
//     the rays that pass are packed in slot order (block_pack) into tiles
//     of MXU_RAYS = 16, the M of mma.m16n8k8, which the four warps share
//     out; a cluster no ray passes is neither staged nor computed. Each
//     128-triangle row of a visited cluster goes to shared memory by
//     cp.async, its 19 factor planes at a stride of 136 floats (10.3 KB; two
//     buffers, the next row loading while this one computes), read there by
//     every warp with a tile. Per 8 triangles a warp takes det, u*det and
//     v*det for its tile's 16 rays as three tensor-core products (mma.sync
//     m16n8k4 for det, m16n8k8 for the two six-term forms; operands rounded
//     by cvt.rna.tf32.f32, FP32 accumulators), and beside each the same
//     product of the operands' magnitudes, which is its error margin E
//     (below). The epilogue (maybe_hit, 14 operations a pair; the rows of a
//     tile of at most 8 rays that hold no ray are skipped) rejects a pair
//     only where the exact test certainly rejects it; the pairs that pass
//     (about 3 of a visit's 512 on the terrain) take
//     moller_trumbore_bilinear, unchanged, and
//     the exclude test, with the 19 factors read from shared memory. Each
//     thread keeps a strict-'<' (t, id) per row over its pairs in
//     ascending id; the four threads that hold a row reduce it
//     lexicographically by shuffles after each cluster, and the result
//     becomes the ray's hit when it beats the ray's running one. A
//     candidate's t does not depend on the cap, the tile or the
//     neighbouring rays, so the result is the serial strict-'<' sweep's,
//     bit for bit, wherever a ray lands (tests/test_torch_hit_order.py
//     holds the reduce). The t*det product and the tests on t (t_min, the
//     running cap) are left to the exact test: they take away 0.14% of its
//     pairs on the terrain's sorted primary wavefront and 25% on its
//     bounce-2 wavefront, but a variant with them (two more products and
//     some 10 operations on every pair) ran 4.48-4.55 ms against 3.08 and
//     4.02-4.06 against 2.59-2.65 there (PERF.md §6).
//   - The error bound. For a form X = sum_k a_k b_k (a: the ray's features
//     d or (m, d), m = o x d as the exact test computes it; b: the FP32
//     factors), the exact test computes X_e with each product and sum
//     rounded: |X_e - X| <= g_K S, S = sum_k |a_k b_k|, g_K <= 6.1 * 2^-24.
//     The tensor core computes X_f from a~ = rna(a), b~ = rna(b), |a~ - a|
//     <= 2^-11 |a|: products exact (11-bit significands), so |a~ b~ - a b|
//     <= (2^-10 + 2^-22) |a b|; the FP32 accumulation, in an order and
//     rounding the hardware does not specify, is taken at <= 2^-19 of the
//     sum of the magnitudes it adds (16x the truncating adder's 8 * 2^-23).
//     So |X_f - X_e| <= 1.003 * 2^-10 S + A. The margin E is the tensor
//     core's product of c * max(|a~|, 2^-116) (c = 2^-9, MXU_C) with |b~|,
//     started at MXU_ABS * (sum |a_k| + 2K + 1): E >= 1.99 * 2^-10 S (1 -
//     2^-19), about twice what X_f can be off, and the rest covers the
//     epilogue's own FP32 roundings. A covers what leaves relative bounds:
//     operands or products below 2^-126 that the tensor core may flush to
//     zero (the 2^-116 floor for the ray's, the start for the factors'
//     and the products') and the exact form's underflow.
//   - The epilogue, with s = sign(D) and E_D, E_U, E_V the margins (E_U
//     and E_V started 2^-100 |D| higher, a floor that keeps a u or v it
//     rejects from underflowing to -0, which passes u >= 0): |D| + E_D <
//     1e-12 (1 - 2^-20) rejects by |det| <= 1e-12. Where |D| > E_D (det's
//     sign is D's): s U < -E_U rejects by u < 0, s V < -E_V by v < 0, and
//     (1 + 2^-19)(|D| + E_D) + E_U + E_V < s (U + V) by u + v > 1. A pair
//     it cannot decide, NaN among them, goes on.
//     kernels/mesh_intersect.py::mxu_filter_plain is this epilogue in plain
//     PyTorch, and tests/test_torch_mxu_filter.py holds it sound on seeded
//     and adversarial pairs at either sign of the accumulation error.
//   - What bounds it now: the FP32 epilogue (17.5 operations a visited
//     pair: maybe_hit's 14, the margins' start, the B operands' rounding
//     and sign masking). On the sorted primary wavefront of terrain chunk
//     2 (414,720 rays, 6.8 cluster visits a ray, 1.08 tile rows a visit)
//     the bound is 0.407 ms (the TF32 products 0.175; the FP32 form's
//     0.994); on its bounce-2 wavefront (193,363 live, 4.8 visits, 1.55
//     tile rows a visit) 0.139 (0.333).
//   - Measured (chip_ab.py against the scalar FP32 form, NVIDIA H100 80GB
//     HBM3 at 700 W): sorted primary 3.08-3.10 ms against 7.00-7.11 (A3,
//     the VPU instance, 5.31 on the same rays), bounce 2.70 against 2.69
//     (A3 2.07); unsorted bounce-2 rays 6.26-6.40 against 3.64-3.71, since
//     scattered rays share few cluster visits (past bounce 0 only a
//     wavefront under 2,048 rays goes unsorted). Tried and not kept
//     (PERF.md §6): a warp computing its own 16 rows unpacked, 128-ray
//     blocks, the 8-triangle loop unrolled 4, the exact tests taken 32 at
//     a time from a warp queue with (t, id) keys merged by atomicMin, and
//     the t tests above.
//
// A4, qtrt_mesh_first_cluster, replaces _c1_kernel
// (qt_raytracer_tpu/kernels/mesh_intersect.py:619, first_crossed_cluster
// :688): per ray, the lowest id of a cluster whose slacked, capped slab test
// passes (k when none), which keys the wavefront sort that runs before A3;
// with a second output (pair=True on the TPU, a template flag here) also
// the lowest crossed id above it, for the two-cluster sort key. Its plain
// versions are first_crossed_cluster_plain (ungated) and
// crossing_walk_gated_plain (the walk below, counting its tests).
//   - What bounded it. The parent kernel, one thread a ray, tested the
//     cluster boxes in ascending id up to the first that passed: on the
//     1080p terrain (195 clusters) that id averages about 100, and a ray
//     that crosses nothing tests all 195; 20 single-rounded operations a
//     test, so instructions, and a warp paid its slowest lane.
//   - What the design does. The two-level walk of mesh_common.cuh
//     (crossing_walk): the box of each run of GROUP_C = 16 clusters
//     (MeshClusters.group_boxes, their exact union) first, its members only
//     when it passes, which drops no id; the live lanes packed in lane
//     order (take_ray, block_pack.cuh) where there is more than one group;
//     with one cluster, its box is the one group's, and one test decides.
//     A live terrain ray then tests some 18-21 boxes (chip_smoke.py counts
//     them), and what bounds the kernel is its bytes: 33 a ray (37 with
//     the second output).
//   - Measured (chip_ab.py --parts boxes against the parent kernel on the
//     same inputs, in turns, one call between two CUDA events, the
//     wrapper's host time included; NVIDIA H100 80GB HBM3 at 700 W), ms
//     against the parent's: terrain chunk 2, 414,720 rays, 0.099-0.100
//     against 0.139-0.148 (sorted: 0.061-0.077 against 0.095-0.099);
//     chunk 0, whose rays mostly cross nothing, 0.054-0.057 against
//     0.146-0.149; the bounce-2 wavefront (193,363 live) 0.069 against
//     0.127-0.130; with the second output 0.094-0.097 and 0.116-0.117
//     against 0.143-0.156 and 0.182-0.187; a one-cluster Cornell
//     wavefront 0.066-0.067 against 0.067-0.069, mostly host time. In
//     turns over the four terrain wavefronts, groups of 16 took 5% less
//     time than groups of 8 and 11% less than groups of 32. Not kept
//     (PERF.md §6): one warp a ray, the walk with only one of its two
//     kinds of member round.

#include <cuda_runtime.h>

#include "mesh_common.cuh"

namespace {

using namespace qtrt_mesh;

// A4: thread t walks the ray take_ray gives it (the block's live rays
// packed where there is more than one group); c1, and for PAIR c2, are the
// first one or two ids the walk visits. A dead lane writes k where it
// lies.
template <bool PAIR>
__global__ void __launch_bounds__(BLOCK) first_cluster_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const float* __restrict__ boxes, int k, int k_stride,
    const float* __restrict__ groups, int ng, float t_min, int n,
    int* __restrict__ out, int* __restrict__ out2) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool pack = ng > 1;
  if (pack && i < n && !alive[i]) {
    out[i] = k;
    if constexpr (PAIR) out2[i] = k;
  }
  int ray;
  Ray r = {};
  float cap = 0.f;
  const bool mine = take_ray(pack, n, ox, oy, oz, dx, dy, dz, alive, t_cap,
                             ray, r, cap);
  int c1 = k;
  int c2 = k;  // the next crossed id above c1; sought only when PAIR
  if (k == 1) {
    // One cluster, whose box is the one group's: one test decides.
    if (mine && gate_box(boxes, static_cast<size_t>(k_stride), 0, r, t_min,
                         cap))
      c1 = 0;
  } else {
    crossing_walk(mine, r, t_min, cap, groups, ng, boxes,
                  static_cast<size_t>(k_stride), k, [&](int c) {
                    if (PAIR && c1 == k) {
                      c1 = c;
                      return false;
                    }
                    if (PAIR) c2 = c; else c1 = c;
                    return true;
                  });
  }
  if (pack ? !mine : i >= n) return;  // unpacked, a dead lane writes k here
  out[ray] = c1;
  if constexpr (PAIR) out2[ray] = c2;
}

// A3's bodies (the header comment).
enum SearchMode : int { VPU = 0, ROWGATE = 1, MXU = 2 };

constexpr int SEARCH_WARPS = 4;  // rays per block of A3, one warp each
constexpr int NO_ID = 0x7fffffff;

// One lane's share of triangles [lo, hi): lo + lane, lo + lane + 32, ...,
// in ascending order, with the strict '<' update of the lane's own (t, id),
// which starts at (the ray's t_best, NO_ID). It ends on the lexicographic
// minimum of (t, id) over the lane's triangles accepted below t_best.
template <bool EXCL>
__device__ __forceinline__ void lane_sweep(const float* __restrict__ tris,
                                           size_t ps, int lo, int hi,
                                           int lane, const Ray& r,
                                           const float d[3], float t_min,
                                           int ex, float& t, int& id) {
#pragma unroll 4
  for (int p = lo + lane; p < hi; p += WARP) {
    float t_hit;
    float v0[3], e1[3], e2[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v0[a] = __ldg(tris + a * ps + p);
      e1[a] = __ldg(tris + (3 + a) * ps + p);
      e2[a] = __ldg(tris + (6 + a) * ps + p);
    }
    bool ok = moller_trumbore(r.o, d, v0, e1, e2, t_min, t, t_hit);
    if constexpr (EXCL) ok = ok && p != ex;
    if (ok) {
      t = t_hit;
      id = p;
    }
  }
}

// Triangles [lo, hi) for the warp's ray: each lane sweeps its share, the
// warp takes the lexicographic minimum of the lanes' (t, id), and that
// becomes the ray's running hit when it beats t_best. A candidate's t does
// not depend on the cap, so this is the serial strict-'<' sweep's result.
// Every lane of the warp calls it and leaves with the same (t_best, best).
template <bool EXCL>
__device__ __forceinline__ void warp_sweep(const float* __restrict__ tris,
                                           size_t ps, int lo, int hi,
                                           int lane, const Ray& r,
                                           const float d[3], float t_min,
                                           int ex, float& t_best, int& best) {
  float t = t_best;
  int id = NO_ID;
  lane_sweep<EXCL>(tris, ps, lo, hi, lane, r, d, t_min, ex, t, id);
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(FULL, t, off);
    const int id2 = __shfl_xor_sync(FULL, id, off);
    if (t2 < t || (t2 == t && id2 < id)) {
      t = t2;
      id = id2;
    }
  }
  if (t < t_best) {
    t_best = t;
    best = id;
  }
}

// A3 for ray i, on the warp that calls it (the header comment). Lane j
// slab-tests clusters base + j; the warp visits, in ascending order, each
// cluster whose test passes under the ray's running cap at that moment,
// and under ROWGATE each of its rows whose own test passes so.
template <bool EXCL, int MODE>
__device__ __forceinline__ void search_ray(
    int i, int lane, const float* __restrict__ ox,
    const float* __restrict__ oy, const float* __restrict__ oz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, size_t ps,
    const float* __restrict__ rows, size_t rs,
    const float* __restrict__ boxes, int k, size_t ks, int g, float t_min,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  float d[3];
  const Ray r = load_ray(i, ox, oy, oz, dx, dy, dz, d);
  const float cap0 = t_cap[i];
  int ex = -1;  // the ray's excluded triangle id; read only when EXCL
  if constexpr (EXCL) ex = excl[i];
  float t_best = cap0;
  int best = 0;
  for (int base = 0; base < k; base += WARP) {
    const int j = base + lane;
    float enter = 0.f;
    // Under the cap at the start of these 32 clusters, which only shrinks:
    // each is tested again under the cap of its turn.
    const bool pass =
        j < k &&
        slab_box(__ldg(boxes + j), __ldg(boxes + ks + j),
                 __ldg(boxes + 2 * ks + j), __ldg(boxes + 3 * ks + j),
                 __ldg(boxes + 4 * ks + j), __ldg(boxes + 5 * ks + j), r,
                 t_min, enter) &&
        enter <= gate_cap(t_best);
    for (unsigned todo = __ballot_sync(FULL, pass); todo; todo &= todo - 1) {
      const int b = __ffs(todo) - 1;
      if (!(__shfl_sync(FULL, enter, b) <= gate_cap(t_best))) continue;
      const int lo = (base + b) * g;
      if constexpr (MODE == ROWGATE) {
        const int nrows = g / ROW;
        for (int rb = 0; rb < nrows; rb += WARP) {
          const int row = lo / ROW + rb + lane;
          float row_enter = 0.f;
          const bool row_pass =
              rb + lane < nrows &&
              slab_box(__ldg(rows + row), __ldg(rows + rs + row),
                       __ldg(rows + 2 * rs + row), __ldg(rows + 3 * rs + row),
                       __ldg(rows + 4 * rs + row), __ldg(rows + 5 * rs + row),
                       r, t_min, row_enter);
          for (unsigned rows_todo = __ballot_sync(FULL, row_pass); rows_todo;
               rows_todo &= rows_todo - 1) {
            const int c = __ffs(rows_todo) - 1;
            if (!(__shfl_sync(FULL, row_enter, c) <= gate_cap(t_best)))
              continue;
            const int p0 = lo + (rb + c) * ROW;
            warp_sweep<EXCL>(tris, ps, p0, p0 + ROW, lane, r, d, t_min, ex,
                             t_best, best);
          }
        }
      } else {
        warp_sweep<EXCL>(tris, ps, lo, lo + g, lane, r, d, t_min, ex,
                         t_best, best);
      }
    }
  }
  if (lane == 0) {
    // A mesh hit counts only when some triangle beat the ray's cap.
    const bool won = t_best < cap0;
    t_out[i] = won ? t_best : BIG;
    idx_out[i] = won ? best : 0;
  }
}

// A3: warp w of block b takes ray b * SEARCH_WARPS + w.
template <bool EXCL, int MODE>
__global__ void __launch_bounds__(SEARCH_WARPS * WARP) mesh_search_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, int p_stride,
    const float* __restrict__ rows, int r_stride,
    const float* __restrict__ boxes, int k, int k_stride, int g, float t_min,
    int n, float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x & (WARP - 1);
  const int i = blockIdx.x * SEARCH_WARPS + threadIdx.x / WARP;
  if (i >= n) return;
  if (!alive[i]) {
    if (lane == 0) {
      t_out[i] = BIG;
      idx_out[i] = 0;
    }
    return;
  }
  search_ray<EXCL, MODE>(i, lane, ox, oy, oz, dx, dy, dz, t_cap, excl, tris,
                         static_cast<size_t>(p_stride), rows,
                         static_cast<size_t>(r_stride), boxes, k,
                         static_cast<size_t>(k_stride), g, t_min, t_out,
                         idx_out);
}

// Launch instance MODE of A3, with the exclude operand when excl is set.
template <int MODE>
void launch_search(cudaStream_t st, const float* ox, const float* oy,
                   const float* oz, const float* dx, const float* dy,
                   const float* dz, const bool* alive, const float* t_cap,
                   const int* excl, const float* tris, int p_stride,
                   const float* rows, int r_stride, const float* boxes, int k,
                   int k_stride, int g, float t_min, int n, float* t_out,
                   int* idx_out) {
  const int grid = n / SEARCH_WARPS + (n % SEARCH_WARPS != 0);
  if (excl != nullptr) {
    mesh_search_kernel<true, MODE><<<grid, SEARCH_WARPS * WARP, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  } else {
    mesh_search_kernel<false, MODE><<<grid, SEARCH_WARPS * WARP, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, nullptr, tris, p_stride, rows,
        r_stride, boxes, k, k_stride, g, t_min, n, t_out, idx_out);
  }
}

// ------------------------------------------------------------------ A3m
constexpr int MXU_WARPS = 4;    // warps a block of A3m
constexpr int MXU_RAYS = 16;    // rows a tile: the M of mma.sync m16n8k*
constexpr int MXU_BLOCK_RAYS = MXU_WARPS * MXU_RAYS;   // a tile a warp
constexpr int MXU_THREADS = MXU_WARPS * WARP;
// The threads that gate each ray, each a share of the clusters.
constexpr int GATE_PHASES = MXU_THREADS / MXU_BLOCK_RAYS;
constexpr int MXU_TILE = 8;     // triangles a product: the N of mma.sync
// Floats a staged factor plane: 136 = 8 (mod 32), so the four rows a B
// fragment reads (threadID_in_group t) fall on four distinct runs of 8 banks.
constexpr int SROW = ROW + 8;
constexpr int STAGE_FLOATS = MT_FEATURES * SROW;
// The first factor plane of each B operand: det's k = 0..3 are planes 0-3
// (plane 3, under a zero ray feature, adds 0), u*det's k = 0..7 planes 3-10
// and v*det's planes 9-16 (the last two under zeros).
constexpr int F_DET = 0, F_U = 3, F_V = 9;
// The filter's margins (the header comment).
// E = c * sum |a~||b~|, with |a~| taken at least MXU_FLOOR, started at
// MXU_ABS * (sum |a| + 2K + 1).
constexpr float MXU_C = 0x1p-9f;
constexpr float MXU_FLOOR = 0x1p-116f;
constexpr float MXU_ABS = 0x1p-125f;
constexpr float MXU_TAU = 0x1p-100f;    // the underflow floor of u and v
constexpr float DET_LO = 1e-12f * (1.0f - 0x1p-20f);
constexpr float K_UV = 1.0f + 0x1p-19f;
constexpr unsigned SIGN = 0x80000000u;

// x rounded to TF32 (10 explicit significand bits), nearest, ties away.
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d = a b + c: a [16, 8] row-major TF32, b [8, 8] column-major TF32, c and
// d [16, 8] FP32, in the fragments of mma.sync m16n8k8: a0 (g, t), a1 (g +
// 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (t, g), b1 (t + 4, g); c0 and
// c1 (g, 2t and 2t + 1), c2 and c3 (g + 8, ...), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_k8(float d[4], const unsigned a[4],
                                       unsigned b0, unsigned b1,
                                       const float c[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The same for m16n8k4: a0 (g, t), a1 (g + 8, t); b0 (t, g).
__device__ __forceinline__ void mma_k4(float d[4], const unsigned a[2],
                                       unsigned b0, const float c[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The 19 factor planes of the 128 triangles from src (plane a at src + a *
// ps) into dst (plane a at dst + a * SROW), 16 bytes a copy, by the block.
__device__ __forceinline__ void stage_row(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          size_t ps) {
  constexpr int PIECES = ROW / 4;
  for (int q = threadIdx.x; q < MT_FEATURES * PIECES; q += MXU_THREADS) {
    const int a = q / PIECES, c = (q % PIECES) * 4;
    cp_async16(dst + a * SROW + c, src + a * ps + c);
  }
}

// False only where the exact test certainly rejects the pair, from the
// tensor core's D ~ det, U ~ u*det, V ~ v*det and their margins E_D, E_U,
// E_V, the last two started at 2^-100 |D| (the header comment). NaN
// anywhere leaves it true.
__device__ __forceinline__ bool maybe_hit(float D, float U, float V, float ED,
                                          float EU, float EV) {
  const float aD = fabsf(D);
  const float adE = add(aD, ED);
  // s U and s V, s = sign(D): one LOP3 each.
  const float sU = __uint_as_float(__float_as_uint(U) ^
                                   (__float_as_uint(D) & SIGN));
  const float sV = __uint_as_float(__float_as_uint(V) ^
                                   (__float_as_uint(D) & SIGN));
  const bool out = sU < -EU || sV < -EV ||
                   __fmaf_rn(adE, K_UV, add(EU, EV)) < add(sU, sV);
  return !(adE < DET_LO || (aD > ED && out));
}

// A ray's TF32 feature a~ as the magnitude operand: c * max(|a~|, floor),
// exact in TF32 (a power-of-two scale of a TF32 value).
__device__ __forceinline__ unsigned magnitude(unsigned a) {
  return __float_as_uint(
      mul(MXU_C, fmaxf(fabsf(__uint_as_float(a)), MXU_FLOOR)));
}

// What a warp holds of its packed tile: rows g and g + 8 of it, each a
// ray's slot in the block (-1 for an empty row, whose features are zero and
// whose pairs the det test rejects), its A operands (values a~, magnitudes
// c * max(|a~|, floor), the magnitude products' start) and the thread's
// strict-'<' running (t, id) over its pairs of the cluster being visited.
struct Tile {
  int slot[2];
  unsigned a_det[2], a_uv[4], m_det[2], m_uv[4];
  float c_det[4], c_uv[4];
  float t[2];
  int id[2];
};

// A block's rays in shared memory (slot s: ray ray0 + s): the A operands as
// the fragments take them (a~ of det's 4 and u, v's 8 features, then their
// magnitudes), the magnitude products' starts, the exact test's o, d, m,
// the running hit and the excluded id.
constexpr int FEAT_WORDS = 24;
struct BlockRays {
  unsigned feat[MXU_BLOCK_RAYS][FEAT_WORDS];
  float start[MXU_BLOCK_RAYS][2];
  float odm[MXU_BLOCK_RAYS][9];
  float t_best[MXU_BLOCK_RAYS];
  int best[MXU_BLOCK_RAYS];
  int ex[MXU_BLOCK_RAYS];
};

// Slot s's ray into the block's tables (all zero for a dead lane).
__device__ __forceinline__ void setup_ray(BlockRays& br, int s, bool live,
                                          const float o[3], const float d[3],
                                          float t_cap, int ex) {
  float m[3] = {0.f, 0.f, 0.f};
  if (live) ray_moment(o, d, m);
  const float det_f[4] = {d[0], d[1], d[2], 0.f};
  const float uv_f[8] = {m[0], m[1], m[2], d[0], d[1], d[2], 0.f, 0.f};
  unsigned* f = br.feat[s];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = tf32(det_f[k]);
    // Features past the form's K (det's 4th, u and v's 7th and 8th) and a
    // dead lane's stay 0.
    f[12 + k] = live && k < 3 ? magnitude(f[k]) : 0u;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    f[4 + k] = tf32(uv_f[k]);
    f[16 + k] = live && k < 6 ? magnitude(f[4 + k]) : 0u;
  }
  const float sd = add(add(fabsf(d[0]), fabsf(d[1])), fabsf(d[2]));
  const float sm = add(add(fabsf(m[0]), fabsf(m[1])), fabsf(m[2]));
  br.start[s][0] = live ? mul(MXU_ABS, add(sd, 7.f)) : 0.f;
  br.start[s][1] = live ? mul(MXU_ABS, add(add(sm, sd), 13.f)) : 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    br.odm[s][a] = o[a];
    br.odm[s][3 + a] = d[a];
    br.odm[s][6 + a] = m[a];
  }
  br.t_best[s] = t_cap;
  br.best[s] = 0;
  br.ex[s] = ex;
}

// Tile j of the packed list (total entries): thread (g, t)'s operands and
// its running (t, id) from each row's ray's running hit.
__device__ __forceinline__ void load_tile(Tile& tl, const BlockRays& br,
                                          const int* list, int total, int j,
                                          int g4, int t4) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = j * MXU_RAYS + g4 + 8 * q;
    const int s = row < total ? list[row] : -1;
    tl.slot[q] = s;
    const unsigned* f = br.feat[s < 0 ? 0 : s];
    const bool on = s >= 0;
    tl.a_det[q] = on ? f[t4] : 0u;
    tl.a_uv[q] = on ? f[4 + t4] : 0u;
    tl.a_uv[2 + q] = on ? f[8 + t4] : 0u;
    tl.m_det[q] = on ? f[12 + t4] : 0u;
    tl.m_uv[q] = on ? f[16 + t4] : 0u;
    tl.m_uv[2 + q] = on ? f[20 + t4] : 0u;
    const float cd = on ? br.start[s][0] : 0.f;
    const float cu = on ? br.start[s][1] : 0.f;
    tl.c_det[2 * q] = tl.c_det[2 * q + 1] = cd;
    tl.c_uv[2 * q] = tl.c_uv[2 * q + 1] = cu;
    tl.t[q] = on ? br.t_best[s] : BIG;
    tl.id[q] = NO_ID;
  }
}

// One 128-triangle row staged in S (triangle ids p0 + 0..127) for a tile:
// per 8 triangles the three products and their margins on the tensor
// cores, the filter on the thread's four pairs, the exact test on the pairs
// it passes (the ray's o, d, m from the block's tables).
template <bool EXCL>
__device__ __forceinline__ void sweep_row(const float* __restrict__ S, int p0,
                                          int g4, int t4, Tile& tl, bool half,
                                          const BlockRays& br, float t_min) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int n0 = 0; n0 < ROW; n0 += MXU_TILE) {
    __syncwarp();  // mma.sync.aligned: the lanes an exact test parted
    const float* col = S + n0 + g4;  // this thread's B column: triangle g
    const unsigned bd = tf32(col[(F_DET + t4) * SROW]);
    const unsigned bu0 = tf32(col[(F_U + t4) * SROW]);
    const unsigned bu1 = tf32(col[(F_U + 4 + t4) * SROW]);
    const unsigned bv0 = tf32(col[(F_V + t4) * SROW]);
    const unsigned bv1 = tf32(col[(F_V + 4 + t4) * SROW]);
    float D[4], U[4], V[4], ED[4], EU[4], EV[4], start[4];
    mma_k4(D, tl.a_det, bd, zero);
    mma_k4(ED, tl.m_det, bd & ~SIGN, tl.c_det);
    // The floor of u and v (2^-100 |D|) rides in the margins' start.
#pragma unroll
    for (int e = 0; e < 4; ++e)
      start[e] = __fmaf_rn(MXU_TAU, fabsf(D[e]), tl.c_uv[e]);
    mma_k8(U, tl.a_uv, bu0, bu1, zero);
    mma_k8(V, tl.a_uv, bv0, bv1, zero);
    mma_k8(EU, tl.m_uv, bu0 & ~SIGN, bu1 & ~SIGN, start);
    mma_k8(EV, tl.m_uv, bv0 & ~SIGN, bv1 & ~SIGN, start);
    // Rows g + 8 of a tile of at most 8 rays are empty: no filter there.
    unsigned maybe = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < 2 || !half)
        maybe |= static_cast<unsigned>(
                     maybe_hit(D[e], U[e], V[e], ED[e], EU[e], EV[e]))
                 << e;
    if (!maybe) continue;
    // Pair e: row g (e < 2) or g + 8, triangle n0 + 2t + (e & 1); per row
    // in ascending triangle order.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((maybe >> e) & 1u)) continue;
      const int q = e >> 1;
      const int s = tl.slot[q];
      const int c = n0 + 2 * t4 + (e & 1);
      float f[MT_FEATURES];
#pragma unroll
      for (int a = 0; a < MT_FEATURES; ++a) f[a] = S[a * SROW + c];
      float t_hit;
      const float* r = br.odm[s];
      bool ok = moller_trumbore_bilinear(r, r + 3, r + 6, f, t_min,
                                         tl.t[q], t_hit);
      if constexpr (EXCL) ok = ok && p0 + c != br.ex[s];
      if (ok) {
        tl.t[q] = t_hit;
        tl.id[q] = p0 + c;
      }
    }
  }
}

// A3m: block b takes rays [MXU_BLOCK_RAYS b, MXU_BLOCK_RAYS (b + 1)) (the
// header comment).
template <bool EXCL>
__global__ void __launch_bounds__(MXU_THREADS) mesh_search_mxu_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float* __restrict__ t_cap,
    const int* __restrict__ excl, const float* __restrict__ tris, int p_stride,
    const float* __restrict__ boxes, int k, int k_stride, int g, float t_min,
    int n, float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float stage[2][STAGE_FLOATS];
  __shared__ BlockRays br;
  __shared__ int list[MXU_THREADS];
  __shared__ int warp_cnt[MXU_WARPS];
  __shared__ unsigned warp_need[MXU_WARPS];
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int ray0 = blockIdx.x * MXU_BLOCK_RAYS;
  const size_t ps = static_cast<size_t>(p_stride);
  const size_t ks = static_cast<size_t>(k_stride);

  // Thread t gates slot t % MXU_BLOCK_RAYS, and sets its tables up.
  const int slot = threadIdx.x % MXU_BLOCK_RAYS;
  const int phase = threadIdx.x / MXU_BLOCK_RAYS;   // its clusters' parity
  const int gi = ray0 + slot;
  const bool g_live = gi < n && alive[gi];
  Ray rg = {};
  float d[3] = {0.f, 0.f, 0.f};
  if (g_live) rg = load_ray(gi, ox, oy, oz, dx, dy, dz, d);
  if (phase == 0)
    setup_ray(br, slot, g_live, rg.o, d, g_live ? t_cap[gi] : BIG,
              EXCL && g_live ? excl[gi] : -1);
  const bool any_live = __syncthreads_or(g_live);

  for (int base = 0; any_live && base < k; base += WARP) {
    // The clusters of these 32 that some ray of the block passes under its
    // cap now (which only shrinks; each is tested again at its turn).
    const float cap = gate_cap(br.t_best[slot]);
    unsigned mine = 0;
    for (int c = base + phase; c < min(base + WARP, k); c += GATE_PHASES)
      if (g_live && gate_box(boxes, ks, c, rg, t_min, cap))
        mine |= 1u << (c - base);
    mine = __reduce_or_sync(FULL, mine);
    if (lane == 0) warp_need[warp] = mine;
    __syncthreads();
    unsigned todo = 0;
#pragma unroll
    for (int w = 0; w < MXU_WARPS; ++w) todo |= warp_need[w];
    for (; todo; todo &= todo - 1) {
      const int c = base + __ffs(todo) - 1;
      // The rays that pass the gate at its turn, packed in slot order.
      const bool pass = phase == 0 && g_live &&
                        gate_box(boxes, ks, c, rg, t_min,
                                 gate_cap(br.t_best[slot]));
      const int total = qtrt_pack::block_pack<MXU_THREADS>(pass, slot, list,
                                                           warp_cnt);
      if (total == 0) continue;
      // Warp w takes rows 16 w.. of the list, if there are any.
      const bool busy = warp * MXU_RAYS < total;
      const bool half = warp * MXU_RAYS + 8 >= total;
      Tile tl;
      if (busy) load_tile(tl, br, list, total, warp, g4, t4);
      const int lo = c * g;
      const int rows = g / ROW;
      stage_row(stage[0], tris + lo, ps);
      cp_async_commit();
      for (int r = 0; r < rows; ++r) {
        if (r + 1 < rows) {
          stage_row(stage[(r + 1) & 1], tris + lo + (r + 1) * ROW, ps);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        if (busy)
          sweep_row<EXCL>(stage[r & 1], lo + r * ROW, g4, t4, tl, half, br,
                          t_min);
        __syncthreads();  // before the buffer is staged again
      }
      // The four threads of a row: the lexicographic minimum of their
      // (t, id), the ray's hit when it beats the ray's running one.
#pragma unroll
      for (int q = 0; busy && q < 2; ++q) {
        float t = tl.t[q];
        int id = tl.id[q];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float t2 = __shfl_xor_sync(FULL, t, off);
          const int id2 = __shfl_xor_sync(FULL, id, off);
          if (t2 < t || (t2 == t && id2 < id)) {
            t = t2;
            id = id2;
          }
        }
        const int s = tl.slot[q];
        if (t4 == 0 && s >= 0 && t < br.t_best[s]) {
          br.t_best[s] = t;
          br.best[s] = id;
        }
      }
      __syncthreads();  // the new hits, before the next gate reads them
    }
    __syncthreads();  // warp_need, before the next chunk writes it
  }
  if (phase != 0 || gi >= n) return;
  // A mesh hit counts only when some triangle beat the ray's cap.
  const bool won = g_live && br.t_best[slot] < t_cap[gi];
  t_out[gi] = won ? br.t_best[slot] : BIG;
  idx_out[gi] = won ? br.best[slot] : 0;
}

}  // namespace

// Kernel A4. Ray operands: [n] f32 components, [n] bool alive, [n] f32
// t_cap (BIG for no cap); boxes: [6, k_stride] f32; groups: [6, ng] f32,
// the union of the boxes of each run of GROUP_C consecutive clusters
// (mesh_common.cuh), ng = ceil(k / GROUP_C); out: [n] i32, the first passing
// cluster id or k (dead lanes: k); out2: null, or [n] i32 for the next
// passing id above it (k when none). Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int qtrt_mesh_first_cluster(const float* ox, const float* oy,
                                       const float* oz, const float* dx,
                                       const float* dy, const float* dz,
                                       const bool* alive, const float* t_cap,
                                       const float* boxes, int k,
                                       int k_stride, const float* groups,
                                       int ng, float t_min, int n, int* out,
                                       int* out2, void* stream) {
  if (n <= 0 || k <= 0 || k_stride < k ||
      ng != k / GROUP_C + (k % GROUP_C != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  const auto st = static_cast<cudaStream_t>(stream);
  if (out2 != nullptr) {
    first_cluster_kernel<true><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, groups, ng,
        t_min, n, out, out2);
  } else {
    first_cluster_kernel<false><<<grid, BLOCK, 0, st>>>(
        ox, oy, oz, dx, dy, dz, alive, t_cap, boxes, k, k_stride, groups, ng,
        t_min, n, out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel A3. Ray operands as for A4; excl: [n] i32 excluded BVH-order
// triangle id per lane (-1: none), or null for no exclude operand; tris:
// [9, p_stride] f32 triangle planes (mode VPU, ROWGATE) or [19, p_stride]
// f32 factor planes (MXU), with p_stride >= k * g; rows: [6, r_stride] f32
// row boxes with r_stride >= k * g / 128 (ROWGATE), else unread (null);
// boxes: [6, k_stride] f32; g: triangles per cluster, a multiple of 128;
// mode: 0 VPU, 1 ROWGATE, 2 MXU. t_out: [n] f32 (BIG where no triangle beat
// the cap, and on dead lanes); idx_out: [n] i32 (the winner's BVH-order
// id, else 0). Launches on `stream`; returns the cudaError_t of the launch
// (0 = success).
extern "C" int qtrt_mesh_search(const float* ox, const float* oy,
                                const float* oz, const float* dx,
                                const float* dy, const float* dz,
                                const bool* alive, const float* t_cap,
                                const int* excl, const float* tris,
                                int p_stride, const float* rows, int r_stride,
                                const float* boxes, int k, int k_stride,
                                int g, int mode, float t_min, int n,
                                float* t_out, int* idx_out, void* stream) {
  if (n <= 0 || k <= 0 || g <= 0 || k_stride < k ||
      static_cast<long long>(k) * g > p_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == ROWGATE &&
      (rows == nullptr || g % ROW != 0 ||
       static_cast<long long>(k) * (g / ROW) > r_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case VPU:
      launch_search<VPU>(st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris,
                         p_stride, nullptr, 0, boxes, k, k_stride, g, t_min,
                         n, t_out, idx_out);
      break;
    case ROWGATE:
      launch_search<ROWGATE>(st, ox, oy, oz, dx, dy, dz, alive, t_cap, excl,
                             tris, p_stride, rows, r_stride, boxes, k,
                             k_stride, g, t_min, n, t_out, idx_out);
      break;
    case MXU: {
      // Whole 128-triangle rows, staged by 16-byte copies.
      if (g % ROW != 0 || p_stride % 4 != 0 ||
          reinterpret_cast<unsigned long long>(tris) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const int grid = n / MXU_BLOCK_RAYS + (n % MXU_BLOCK_RAYS != 0);
      if (excl != nullptr)
        mesh_search_mxu_kernel<true><<<grid, MXU_THREADS, 0, st>>>(
            ox, oy, oz, dx, dy, dz, alive, t_cap, excl, tris, p_stride, boxes,
            k, k_stride, g, t_min, n, t_out, idx_out);
      else
        mesh_search_mxu_kernel<false><<<grid, MXU_THREADS, 0, st>>>(
            ox, oy, oz, dx, dy, dz, alive, t_cap, nullptr, tris, p_stride,
            boxes, k, k_stride, g, t_min, n, t_out, idx_out);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
