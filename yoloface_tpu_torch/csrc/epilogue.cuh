// Requantization epilogues of the int8 net, in the three bit semantics.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::apply_requant_leaky (all
// its branches: fast-bits v2, exact, fast v1) and RequantSpec.
// apply_in_kernel, LeakySpec.apply / apply_exact_i32 (also standalone, for
// the fused stages), exact_add_rescale, apply_quantize_val and the
// LOGISTIC of activation_int32, plus the ADD and QUANTIZE of the arena
// emits (pallas_arena.py).  Plain versions: ops/int8_fast.py, ops/int8_fast2.py
// and the exact ops of ops/int8_ref.py (core/fixedpoint.py), bit for bit.
//
// What bounds these on the card: nothing of their own -- a few ALU ops per
// output element inside the stage kernel (the exact MBQM: one 64-bit
// multiply, two adds and two shifts; the stage kernels' exact
// instantiations, whole-frame and tiled, take mbqm32, its 32-bit halves,
// and read the exact fused leaky from a 256-entry table of leaky_exact:
// stage_ops.cuh).  What the
// design does about bits:
//  * fast: every product and sum is a separately rounded __fmul_rn /
//    __fadd_rn (and the library builds with -fmad=false), so no FMA
//    contraction changes a rounding; __float2int_rn rounds half to even
//    like torch.round and jnp.round;
//  * exact: gemmlowp's MultiplyByQuantizedMultiplier as one 64-bit product
//    of the magnitude, both roundings half away from zero on the magnitude
//    (the form of core/fixedpoint.mbqm_numpy).  The TPU needed 16-bit limbs
//    or f32-assisted forms for lack of int64; the card has it.  The planner
//    keeps x << left inside int32 (specs.check_exact_domain), so the
//    product stays below 2**62 and nothing overflows.
#pragma once

#include <cstdint>

namespace yf {

// round(x) + zp, clipped to int8.  |round(x)| is clamped to 256 first so
// the int conversion never overflows; the int8 clip saturates the same.
__device__ __forceinline__ int8_t round_zp_clip(float x, int zp) {
  float r = fminf(fmaxf(rintf(x), -256.0f), 256.0f);
  int v = __float2int_rn(r) + zp;
  return static_cast<int8_t>(min(max(v, -128), 127));
}

// Standalone conv requant: round(acc * scale[c]) + zp_out.
__device__ __forceinline__ int8_t requant_fast(int acc, float scale,
                                               int zp_out) {
  return round_zp_clip(__fmul_rn(static_cast<float>(acc), scale), zp_out);
}

// fast2: one rounding across conv requant and LeakyReLU.  The clamp of the
// unrounded t comes before the select on t >= 0.
__device__ __forceinline__ int8_t requant_leaky_v2(int acc, float scale,
                                                   int conv_zp, float s_id,
                                                   float s_al, int zp_out) {
  float t = __fmul_rn(static_cast<float>(acc), scale);
  t = fminf(fmaxf(t, static_cast<float>(-128 - conv_zp)),
            static_cast<float>(127 - conv_zp));
  float sel = t >= 0.0f ? s_id : s_al;
  return round_zp_clip(__fmul_rn(t, sel), zp_out);
}

// ADD: round(va * s1 + vb * s2) + zp_out, the two products rounded apart.
__device__ __forceinline__ int8_t add_fast(int va, int vb, float s1, float s2,
                                           int zp_out) {
  float v = __fadd_rn(__fmul_rn(static_cast<float>(va), s1),
                      __fmul_rn(static_cast<float>(vb), s2));
  return round_zp_clip(v, zp_out);
}

// QUANTIZE (int8 -> int8 requantize) on v = x - zp_in.
__device__ __forceinline__ int8_t quantize_fast(int v, float scale,
                                                int zp_out) {
  return round_zp_clip(__fmul_rn(static_cast<float>(v), scale), zp_out);
}

// fast (v1) LeakyReLU on v = x - zp_in: round(v * (v >= 0 ? s_id : s_al))
// + zp_out.
__device__ __forceinline__ int8_t leaky_v1(int v, float s_id, float s_al,
                                           int zp_out) {
  const float sel = v >= 0 ? s_id : s_al;
  return round_zp_clip(__fmul_rn(static_cast<float>(v), sel), zp_out);
}

// fast (v1) fused conv+leaky: the conv's rounding, then the leaky's.
__device__ __forceinline__ int8_t requant_leaky_v1(int acc, float scale,
                                                   int conv_zp, float s_id,
                                                   float s_al, int zp_out) {
  return leaky_v1(requant_fast(acc, scale, conv_zp) - conv_zp, s_id, s_al,
                  zp_out);
}

// LOGISTIC on v = x - zp_in: t = v * scale in float32, y = 1 / (1 +
// expf(-t)) with the correctly rounded expf and division (never __expf or
// __fdividef), then round(y * 256) - 128, clipped: the output's fixed 1/256
// scale and zero-point -128.
__device__ __forceinline__ int8_t logistic(int v, float scale) {
  const float t = __fmul_rn(static_cast<float>(v), scale);
  const float y = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-t)));
  return round_zp_clip(__fmul_rn(y, 256.0f), -128);
}

// gemmlowp MultiplyByQuantizedMultiplier: x * qm * 2**(shift - 31), SRDHM
// then RDivPOT, each rounding half away from zero, on |x|.
__device__ __forceinline__ int mbqm(int x, int qm, int shift) {
  const int left = shift > 0 ? shift : 0;
  const int right = shift > 0 ? 0 : -shift;
  const long long xs = static_cast<long long>(x) * (1LL << left);
  const bool neg = xs < 0;
  const long long p = (neg ? -xs : xs) * static_cast<long long>(qm);
  long long mag = (p + (1LL << 30) - (neg ? 1 : 0)) >> 31;
  mag = (mag + ((1LL << right) >> 1)) >> right;
  return static_cast<int>(neg ? -mag : mag);
}

// mbqm in 32-bit halves, for the planner's domain only: x << left fits
// int32 (specs.check_exact_domain), so |x << left| <= 2**31 is one
// unsigned word, and its product with qm < 2**31 is the two words
// (__umulhi, the low product).  The SRDHM's rounding add carries into the
// high word, its >> 31 is one funnel shift, and the RDivPOT of a value
// below 2**31 + 2**30 stays in 32 bits.  The bits of mbqm there
// (tests/test_torch_exact_epilogue.py holds a numpy mirror of these steps
// against core/fixedpoint.mbqm_numpy on every accumulator of the repo's
// graphs).
__device__ __forceinline__ int mbqm32(int x, int qm, int shift) {
  const int left = shift > 0 ? shift : 0;
  const int right = shift > 0 ? 0 : -shift;
  const int xs = static_cast<int>(static_cast<unsigned>(x) << left);
  const bool neg = xs < 0;
  const unsigned m = neg ? 0u - static_cast<unsigned>(xs)
                         : static_cast<unsigned>(xs);
  const unsigned q = static_cast<unsigned>(qm);
  const unsigned lo = m * q, hi = __umulhi(m, q);
  const unsigned lo2 = lo + ((1u << 30) - (neg ? 1u : 0u));
  const unsigned hi2 = hi + (lo2 < lo ? 1u : 0u);
  unsigned mag = __funnelshift_r(lo2, hi2, 31);      // (p + add) >> 31
  mag = (mag + ((1u << right) >> 1)) >> right;
  return neg ? -static_cast<int>(mag) : static_cast<int>(mag);
}

__device__ __forceinline__ int clip_i8(int v) { return min(max(v, -128), 127); }

// exact conv requant (and QUANTIZE on v = x - zp_in): clip(MBQM + zp_out)
__device__ __forceinline__ int8_t requant_exact(int x, int qm, int shift,
                                                int zp_out) {
  return static_cast<int8_t>(clip_i8(mbqm(x, qm, shift) + zp_out));
}

// exact LeakyReLU on v = x - zp_in: the identity (v >= 0) or alpha branch.
__device__ __forceinline__ int8_t leaky_exact(int v, int qm_id, int sh_id,
                                              int qm_al, int sh_al,
                                              int zp_out) {
  return v >= 0 ? requant_exact(v, qm_id, sh_id, zp_out)
                : requant_exact(v, qm_al, sh_al, zp_out);
}

// exact fused conv+leaky: the conv requant rounds and saturates, then the
// leaky requantizes v = r - conv_zp.
__device__ __forceinline__ int8_t requant_leaky_exact(int acc, int qm,
                                                      int shift, int conv_zp,
                                                      int qm_id, int sh_id,
                                                      int qm_al, int sh_al,
                                                      int zp_out) {
  const int v = clip_i8(mbqm(acc, qm, shift) + conv_zp) - conv_zp;
  return leaky_exact(v, qm_id, sh_id, qm_al, sh_al, zp_out);
}

// exact ADD on v = x - zp: both inputs rescaled to the shared
// 2**left_shift-amplified scale, summed, requantized.
__device__ __forceinline__ int8_t add_exact(int va, int vb, int lsh, int qm1,
                                            int sh1, int qm2, int sh2,
                                            int qmo, int sho, int zp_out) {
  const int sa = mbqm(va * (1 << lsh), qm1, sh1);
  const int sb = mbqm(vb * (1 << lsh), qm2, sh2);
  return requant_exact(sa + sb, qmo, sho, zp_out);
}

}  // namespace yf
