// One bounce's shading in one kernel, for Hopper (sm_90a): shade_kernel.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA, which
// fuses it into a few loops; on the card the PyTorch route of
// qt_raytracer_tpu_torch/core/integrator_flat.py::_shade (nee_fn None)
// issues some 240 elementwise kernels a bounce, 31 of them the bounce's
// hash uniforms on [N, 8] int64 tensors, and the host's launch rate paces
// the frame. This kernel does the whole step per ray lane, in registers:
//   - the bounce's hash uniforms, the formula of sampling.stream_uniforms
//     (lowbias32(lowbias32(key + stream*GOLDEN + slot*WEYL2) + GOLDEN)
//     >> 8, times 2^-24) in uint32 arithmetic, whose wrap-around is the
//     masked int64 form's bit for bit; only the slots a lane uses (0-3,
//     7 under Russian roulette);
//   - _scatter_flat for the four materials (Lambertian with its degenerate
//     guard, metal with fuzz and the below-horizon absorb, dielectric with
//     Schlick, total internal reflection and om5's multiply chain, emissive);
//   - the sky and emission accumulation, `continues`, the throughput
//     update, Russian roulette when rr != 0, and the continuing ray.
// It writes the new ox..dz, tx..tz, rx..rz as a [12, n] f32 block and alive
// as [n] bool; prev_pdf, keys and pid are unchanged without NEE. The
// wrapper and the route rule are in kernels/fused_shade.py; the plain
// version is integrator_flat._shade_plain.
//
// Same bits as the PyTorch route on every lane, dead lanes included. Each
// PyTorch op is one kernel that rounds once, so here every add and multiply
// is rounded on its own (__fadd_rn and friends stop nvcc from contracting
// them into FMAs), in the PyTorch association order; divides and square
// roots are IEEE-rounded (no --use_fast_math), reciprocal(sqrt(x)) is two
// rounded operations, torch.pow(x, 1/3) is powf with the exponent rounded
// to float, torch.cos/sin are cosf/sinf. torch.clamp*, torch.maximum
// propagate NaN where fminf/fmaxf do not, so those are written out. A
// `where(c, x, 0.0)` that is added stays an add of 0.0 (-0 + 0 is +0), and
// every scalar constant is the float PyTorch rounds it to. A lane computes
// only what its outputs read: a dead lane adds 0.0 twice to its radiance and
// passes the rest through; a live miss adds the sky; only a live hit draws
// uniforms and scatters, in its own material's branch. The PyTorch route
// computes every branch on every lane and selects, which gives these bits.
//
// What bounds it on the H100: memory. A live lane reads 125 bytes (12 state
// floats, alive, its int64 key, 15 hit floats, mat and ff) and writes 49;
// at 414,720 lanes that is 72.2 MB, 21.5 us at 3.35 TB/s; a dead lane
// moves 98 bytes and a live miss 102. Its arithmetic, some 300
// single-rounded operations and three transcendentals a live hit, is a few
// microseconds of the FP32 rate. So the design is one thread a lane, 256
// threads a block, every field a coalesced load of its own [n] row (the
// rows A1 writes, or the world merge's tensors), and a dead lane reads
// neither its hit fields nor its key, 49 bytes instead of 125.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr float BIG = 3.0e38f;
constexpr unsigned GOLDEN = 0x9E3779B9u;
constexpr unsigned WEYL2 = 0x85EBCA77u;
// The Python constants of _scatter_flat, _sky and _shade as PyTorch
// takes them: the double, rounded to float.
constexpr float TWO_PI = static_cast<float>(6.283185307179586);
constexpr float THIRD = static_cast<float>(1.0 / 3.0);
constexpr float EPS_LEN2 = static_cast<float>(1.0e-20);
constexpr float EPS_DEGEN = static_cast<float>(1.0e-8);
constexpr float P_MIN = static_cast<float>(0.05);
constexpr float SKY_G = static_cast<float>(0.7);
constexpr float TWO_M24 = 5.9604644775390625e-08f;  // 2^-24
// scene.LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE.
constexpr int LAMBERTIAN = 0, METAL = 1, DIELECTRIC = 2, EMISSIVE = 3;

// Operand rows, in the order of kernels/fused_shade.py's STATE_FLOATS and
// HIT_FLOATS, then the four other operands; the wrapper passes one device
// pointer each, in this order.
enum In {
  S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_TX, S_TY, S_TZ, S_RX, S_RY, S_RZ,
  H_T, H_PX, H_PY, H_PZ, H_NX, H_NY, H_NZ, H_AX, H_AY, H_AZ, H_FUZZ, H_IOR,
  H_EX, H_EY, H_EZ, N_FLOATS
};
enum Other { P_ALIVE = N_FLOATS, P_KEYS, P_MAT, P_FF, N_PTRS };
struct Operands {
  const float* f[N_FLOATS];
  const bool* alive;
  const long long* keys;
  const int* mat;
  const int* ff;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// (ax*bx + ay*by) + az*bz, as the tensor ops round it.
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// torch.clamp_min / clamp_max / clamp with scalar bounds: NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
// torch.maximum: the first NaN operand wins.
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// vecmath.safe_sqrt: where(x > 0, sqrt(where(x > 0, x, 1)), 0).
__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.f ? __fsqrt_rn(x) : 0.f;
}

// The inv_len of integrator_flat._safe_rsqrt_len2: 1 / sqrt(|v|^2), two
// roundings, or 0 where |v|^2 <= 1e-20 (NaN included).
__device__ __forceinline__ float inv_len(float x, float y, float z) {
  const float n2 = dot3(x, y, z, x, y, z);
  return n2 > EPS_LEN2 ? __fdiv_rn(1.f, __fsqrt_rn(n2)) : 0.f;
}

// Wellons' lowbias32 (sampling._lowbias32) in uint32.
__device__ __forceinline__ unsigned lowbias32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Uniform `slot` of the stream whose offset is stream_word (stream id times
// GOLDEN, mod 2^32) for a hash state: sampling.stream_uniforms' value.
__device__ __forceinline__ float uniform(unsigned key, unsigned stream_word,
                                         unsigned slot) {
  const unsigned bits =
      lowbias32(lowbias32(key + (stream_word + slot * WEYL2)) + GOLDEN);
  return mul(__uint2float_rn(bits >> 8), TWO_M24);
}

__global__ void __launch_bounds__(BLOCK) shade_kernel(
    Operands a, unsigned stream_word, int rr, float emit_w, int n,
    float* __restrict__ out, bool* __restrict__ alive_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(n);
  const auto ld = [&](int k) { return __ldg(a.f[k] + i); };

  float o[3] = {ld(S_OX), ld(S_OY), ld(S_OZ)};
  float d[3] = {ld(S_DX), ld(S_DY), ld(S_DZ)};
  float tp[3] = {ld(S_TX), ld(S_TY), ld(S_TZ)};
  float r[3] = {ld(S_RX), ld(S_RY), ld(S_RZ)};
  bool cont = false;
  const bool alive = a.alive[i];
  const float t = alive ? ld(H_T) : BIG;

  if (!alive) {
    // Dead: both accumulations add 0.0.
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = add(add(r[k], 0.f), 0.f);
  } else if (!(t < BIG)) {
    // Live miss: the sky, then an emission term of 0.0.
    const float inv = inv_len(d[0], d[1], d[2]);
    const float s = mul(0.5f, add(mul(d[1], inv), 1.f));
    const float one_s = mul(sub(1.f, s), 1.f);
    const float sky[3] = {add(one_s, mul(s, 0.5f)), add(one_s, mul(s, SKY_G)),
                          add(one_s, mul(s, 1.f))};
#pragma unroll
    for (int k = 0; k < 3; ++k) r[k] = add(add(r[k], mul(tp[k], sky[k])), 0.f);
  } else {
    // Live hit: a sky term of 0.0, then the emission.
    const int mat = __ldg(a.mat + i);
    const bool emit = mat == EMISSIVE;
    const float e[3] = {emit ? ld(H_EX) : 0.f, emit ? ld(H_EY) : 0.f,
                        emit ? ld(H_EZ) : 0.f};
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r[k] = add(add(r[k], 0.f), mul(mul(tp[k], e[k]), emit_w));

    const float nrm[3] = {ld(H_NX), ld(H_NY), ld(H_NZ)};
    const float alb[3] = {ld(H_AX), ld(H_AY), ld(H_AZ)};
    const unsigned key = static_cast<unsigned>(__ldg(a.keys + i));
    float sd[3] = {0.f, 0.f, 0.f};   // scattered direction
    float at[3] = {alb[0], alb[1], alb[2]};   // attenuation
    bool ok = true;

    if (mat == LAMBERTIAN || mat == METAL) {
      // random_unit_vector(u0, u1), shared by both.
      const float zc = sub(1.f, mul(2.f, uniform(key, stream_word, 0)));
      const float rr_ = __fsqrt_rn(clamp_min(sub(1.f, mul(zc, zc)), EPS_LEN2));
      const float phi = mul(TWO_PI, uniform(key, stream_word, 1));
      const float ru[3] = {mul(rr_, cosf(phi)), mul(rr_, sinf(phi)), zc};
      if (mat == LAMBERTIAN) {
        float l[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) l[k] = add(nrm[k], ru[k]);
        const bool degen = dot3(l[0], l[1], l[2], l[0], l[1], l[2]) < EPS_DEGEN;
#pragma unroll
        for (int k = 0; k < 3; ++k) sd[k] = degen ? nrm[k] : l[k];
      } else {
        const float inv = inv_len(d[0], d[1], d[2]);
        const float u[3] = {mul(d[0], inv), mul(d[1], inv), mul(d[2], inv)};
        const float din = dot3(u[0], u[1], u[2], nrm[0], nrm[1], nrm[2]);
        const float cb = powf(uniform(key, stream_word, 2), THIRD);
        const float fuzz = ld(H_FUZZ);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float rf = sub(u[k], mul(mul(2.f, din), nrm[k]));
          sd[k] = add(rf, mul(fuzz, mul(ru[k], cb)));
        }
        ok = dot3(sd[0], sd[1], sd[2], nrm[0], nrm[1], nrm[2]) > 0.f;
      }
    } else if (emit) {
      ok = false;   // absorbed: the direction is never read
    } else {
      // Dielectric, and any other material id (_scatter_flat's last where).
      const float inv = inv_len(d[0], d[1], d[2]);
      const float u[3] = {mul(d[0], inv), mul(d[1], inv), mul(d[2], inv)};
      const float din = dot3(u[0], u[1], u[2], nrm[0], nrm[1], nrm[2]);
      const float ior = ld(H_IOR);
      const float ratio = __ldg(a.ff + i) > 0 ? __fdiv_rn(1.f, ior) : ior;
      const float cos_t = clamp_max(
          dot3(-u[0], -u[1], -u[2], nrm[0], nrm[1], nrm[2]), 1.f);
      const float sin_t = safe_sqrt(sub(1.f, mul(cos_t, cos_t)));
      const bool cannot = mul(ratio, sin_t) > 1.f;
      float r0 = __fdiv_rn(sub(1.f, ratio), add(1.f, ratio));
      r0 = mul(r0, r0);
      const float om = sub(1.f, cos_t);
      const float om2 = mul(om, om);
      const float om5 = mul(om, mul(om2, om2));
      const float refl = add(r0, mul(sub(1.f, r0), om5));
      const bool reflect =
          cannot || refl > uniform(key, stream_word, 3);
      float rp[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rp[k] = mul(ratio, add(u[k], mul(cos_t, nrm[k])));
      const float par = -safe_sqrt(fabsf(sub(1.f, dot3(rp[0], rp[1], rp[2],
                                                       rp[0], rp[1], rp[2]))));
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sd[k] = reflect ? sub(u[k], mul(mul(2.f, din), nrm[k]))
                        : add(rp[k], mul(par, nrm[k]));
      if (mat == DIELECTRIC) at[0] = at[1] = at[2] = 1.f;
    }

    cont = ok;
    if (cont) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tp[k] = mul(tp[k], at[k]);
    }
    if (rr != 0 && cont) {
      // Russian roulette: survivors are reweighted. torch.clamp passes a
      // NaN through.
      const float m = maximum(maximum(tp[0], tp[1]), tp[2]);
      const float pc = m != m ? m : fminf(fmaxf(m, P_MIN), 1.f);
      cont = uniform(key, stream_word, 7) < pc;
      if (cont) {
#pragma unroll
        for (int k = 0; k < 3; ++k) tp[k] = __fdiv_rn(tp[k], pc);
      }
    }
    if (cont) {
      o[0] = ld(H_PX);
      o[1] = ld(H_PY);
      o[2] = ld(H_PZ);
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = sd[k];
    }
  }

  float* f = out + i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[(0 + k) * row] = o[k];
    f[(3 + k) * row] = d[k];
    f[(6 + k) * row] = tp[k];
    f[(9 + k) * row] = r[k];
  }
  alive_out[i] = cont;
}

}  // namespace

// One bounce's shading (the header comment). ptrs: a host array of n_ptrs
// device pointers in the order of In and Other (27 [n] f32 rows, alive [n]
// bool, keys [n] int64 hash states, mat and ff [n] i32); stream_id: the
// bounce's RNG stream (STREAM_BOUNCE0 + depth); rr: nonzero for Russian
// roulette; emit_w: the emission weight; out: [12, n] f32 (ox..rz);
// alive_out: [n] bool. Returns the cudaError_t of the launch.
extern "C" int qtrt_fused_shade(const void* const* ptrs, int n_ptrs,
                                unsigned stream_id, int rr, float emit_w,
                                int n, float* out, bool* alive_out,
                                void* stream) {
  if (n <= 0 || n_ptrs != N_PTRS || ptrs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Operands a;
  for (int k = 0; k < N_FLOATS; ++k)
    a.f[k] = static_cast<const float*>(ptrs[k]);
  a.alive = static_cast<const bool*>(ptrs[P_ALIVE]);
  a.keys = static_cast<const long long*>(ptrs[P_KEYS]);
  a.mat = static_cast<const int*>(ptrs[P_MAT]);
  a.ff = static_cast<const int*>(ptrs[P_FF]);
  const int grid = n / BLOCK + (n % BLOCK != 0);
  shade_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      a, stream_id * GOLDEN, rr, emit_w, n, out, alive_out);
  return static_cast<int>(cudaGetLastError());
}
