// Requantization epilogues of the int8 net: float32, round half to even.
//
// Replaces yoloface_tpu/kernels/pallas_int8.py::apply_requant_leaky (its
// fast-bits-v2 branch) and the fast requant of RequantSpec.apply_in_kernel,
// plus the fast ADD and QUANTIZE of the arena emits
// (pallas_arena.py).  Plain versions: ops/int8_fast.py and
// ops/int8_fast2.py, bit for bit.
//
// What bounds these on the card: nothing of their own -- a few ALU ops per
// output element inside the stage kernel.  What the design does about
// bits: every product and sum is a separately rounded __fmul_rn/__fadd_rn
// (and the library builds with -fmad=false), so no FMA contraction changes
// a rounding; __float2int_rn rounds half to even like torch.round and
// jnp.round.
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

}  // namespace yf
