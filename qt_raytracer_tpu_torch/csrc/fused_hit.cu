// Fused closest-hit query for sphere scenes, for Hopper (sm_90a).
//
// Replaces qt_raytracer_tpu/kernels/fused_hit.py::_fused_kernel in full mode
// without an exclude operand (kernel A1 of ROADMAP Queue B). Per ray: sweep
// every sphere and keep the closest valid root (the lowest sphere id wins a
// tie), read the winner's 13 parameters, refine t with the stable root of
// the well-conditioned oc form, and emit the hit point, the front-face flag
// and the signed normal. The plain PyTorch version of the same function is
// fused_hit_plain in qt_raytracer_tpu_torch/kernels/fused_hit.py.
//
// What bounds it on the H100. The sweep costs about 25 FLOPs per ray-sphere
// pair, and one IEEE square root. At the main path's 414,720 rays x 512
// spheres that is about 5.3 GFLOP per launch, against about 100 B of ray I/O
// per ray (6 floats and a flag in, 19 words out: 41 MB per launch). That is
// some 130 FLOPs per byte, far above the card's balance point of about 20
// for FP32 outside the tensor cores, so the sweep's arithmetic is the bound,
// not memory. The candidates need a square root and a compare per pair, so
// no tensor-core form applies.
//
// What the design does about it. One thread per ray keeps the running
// minimum in registers: the [N,S] candidate matrix that the TPU kernel wrote
// to VMEM scratch never exists. Each block stages the sweep columns
// (cx, cy, cz, |c|^2 - r^2) in shared memory as float4, in tiles of TILE_S
// spheres so any S fits; all threads of a warp read the same sphere, a
// broadcast without bank conflicts. The winner's row of the [S,16] table is
// four 16-byte loads from a 32 KB table that stays in cache (the TPU's
// one-hot MXU extraction has no use here). Ray I/O is one coalesced word per
// thread per component. A block with no live ray skips the sweep. Beyond
// this, tiling and occupancy are untuned.
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

namespace {

constexpr float BIG = 3.0e38f;
constexpr int BLOCK = 256;   // rays per block, one per thread
constexpr int TILE_S = 256;  // spheres per shared-memory tile (4 KB)

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

__global__ void __launch_bounds__(BLOCK) fused_hit_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const bool* __restrict__ alive, const float4* __restrict__ spheres,
    const float4* __restrict__ params, int s, float t_min, int n,
    float* __restrict__ fout, int* __restrict__ iout) {
  __shared__ float4 tile[TILE_S];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n && alive[i];
  const bool block_live = __syncthreads_or(live);

  float o_x = 0.f, o_y = 0.f, o_z = 0.f, d_x = 0.f, d_y = 0.f, d_z = 1.f;
  if (live) {
    o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
    d_x = dx[i]; d_y = dy[i]; d_z = dz[i];
  }
  const float a = dot3(d_x, d_y, d_z, d_x, d_y, d_z);
  const float o_dot_d = dot3(o_x, o_y, o_z, d_x, d_y, d_z);
  const float o2 = dot3(o_x, o_y, o_z, o_x, o_y, o_z);
  const float inv_a = __fdiv_rn(1.f, a);

  // --- closest-hit sweep (expanded-form quadratic, as the TPU sweep) ---
  float t_best = BIG;
  int best = 0;
  if (block_live) {
    for (int base = 0; base < s; base += TILE_S) {
      const int m = min(TILE_S, s - base);
      __syncthreads();
      for (int k = threadIdx.x; k < m; k += BLOCK) tile[k] = spheres[base + k];
      __syncthreads();
      if (!live) continue;
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        const float4 c = tile[k];
        const float d_dot_c = dot3(c.x, c.y, c.z, d_x, d_y, d_z);
        const float o_dot_c = dot3(c.x, c.y, c.z, o_x, o_y, o_z);
        const float half_b = sub(o_dot_d, d_dot_c);
        const float cterm = add(sub(o2, mul(2.f, o_dot_c)), c.w);
        const float disc = sub(mul(half_b, half_b), mul(a, cterm));
        const float sq = __fsqrt_rn(fmaxf(disc, 0.f));
        const float near = mul(sub(-half_b, sq), inv_a);
        const float far = mul(add(-half_b, sq), inv_a);
        const bool near_ok = near >= t_min && near <= BIG;
        const bool far_ok = far >= t_min && far <= BIG;
        const float root = near_ok ? near : far;
        const float cand = (disc >= 0.f && (near_ok || far_ok)) ? root : BIG;
        if (cand < t_best) {
          t_best = cand;
          best = base + k;
        }
      }
    }
  }
  if (i >= n) return;

  float* f = fout + i;
  int* g = iout + i;
  const size_t row = static_cast<size_t>(n);
  if (!live) {
    const float fdef[N_FROWS] = {BIG, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f,
                                 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < N_FROWS; ++r) f[r * row] = fdef[r];
#pragma unroll
    for (int r = 0; r < N_IROWS; ++r) g[r * row] = 0;
    return;
  }
  const int idx = best;  // 0 on a miss: sphere 0's parameters, as in JAX

  // --- winner parameters: cx cy cz r | ax ay az fuzz | ior mat ex ey | ez ---
  const float4 p0 = params[4 * idx + 0];
  const float4 p1 = params[4 * idx + 1];
  const float4 p2 = params[4 * idx + 2];
  const float4 p3 = params[4 * idx + 3];
  const float cw_x = p0.x, cw_y = p0.y, cw_z = p0.z, r_w = p0.w;

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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// spheres: [s, 4] f32 rows (cx, cy, cz, |c|^2 - r^2 + BIG*inactive);
// params: [s, 16] f32 rows of packed_param_table; fout: [16, n] f32;
// iout: [3, n] i32. All pointers are device pointers, 16-byte aligned.
extern "C" int qtrt_fused_hit(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const bool* alive, const float* spheres,
                              const float* params, int s, float t_min, int n,
                              float* fout, int* iout, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  fused_hit_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, alive, reinterpret_cast<const float4*>(spheres),
      reinterpret_cast<const float4*>(params), s, t_min, n, fout, iout);
  return static_cast<int>(cudaGetLastError());
}
