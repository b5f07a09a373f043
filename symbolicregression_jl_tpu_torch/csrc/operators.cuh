// The device operator library shared by the port's CUDA kernels
// (postfix_eval.cu, postfix_grad.cu, instr_eval.cu): opcodes, the NaN-domain
// guards and forward functions of every operator in the registries of
// symbolicregression_jl_tpu_torch/ops/operators.py, and the closed-form
// derivatives of ops/operators.py UNARY_VJP / BINARY_VJP.
//
// The opcodes are ops/operators.py KERNEL_UNARY_IDS / KERNEL_BINARY_IDS:
// every unary id lies below OP_ADD, the first binary id, and every operator
// id at or above OP_COS. Built without --use_fast_math: the CUDA math
// library's functions stay within ulps of torch's on the card, which calls
// the same library.
//
// The dispatch functions take kAll: false compiles the common operators
// only (unary ids below OP_ASIN, binary ids below OP_MOD), true adds the
// fourteen others (OP_ASIN-OP_GAMMA, OP_MOD-OP_LOGICAL_AND), whose device
// functions are the largest (lgammaf, erfcf, atan2f, fmodf, ...). Each
// kernel is instantiated both ways and the wrapper launches the compact
// one when the batch's operators allow it: with all 44 in one switch, the
// scoring and loss-only kernels ran 11-13 % slower on the common
// operators (PERF.md). A code outside the compiled set gives NaN.
//
// Operators of the user's own (ops/operators.py register_unary /
// register_binary) and a loss callable come from a header that
// ops/user_ops.py generates from their traces (sr_user_ops.cuh, under
// build/, never in csrc/). A build with -DSR_USER_OPS and that header's
// directory on the include path names the registry's four dispatch
// functions registry_* (SR_REGISTRY) and defines apply_unary /
// apply_binary / unary_vjp / binary_vjp at the end of this file: their kAll
// instantiations run the user operators' codes (ids from 64 unary, 128
// binary), everything else goes to the registry's. In every other build the
// registry's functions carry those names themselves, so it is the code it
// was.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifdef SR_USER_OPS
#define SR_REGISTRY(name) registry_##name
#else
#define SR_REGISTRY(name) name
#endif

namespace srops {

enum : int {
  OP_PAD = 0, OP_CONST = 1, OP_VAR = 2,
  OP_COS = 10, OP_SIN, OP_TAN, OP_EXP, OP_LOG, OP_LOG2, OP_LOG10, OP_LOG1P,
  OP_SQRT, OP_ABS, OP_SQUARE, OP_CUBE, OP_NEG, OP_RELU, OP_SINH, OP_COSH,
  OP_TANH, OP_SIGMOID, OP_INV, OP_IDENTITY, OP_SIGN, OP_GAUSS,
  OP_ASIN, OP_ACOS, OP_ATAN, OP_ASINH, OP_ACOSH, OP_ATANH, OP_ERF, OP_ERFC,
  OP_GAMMA,
  OP_ADD = 50, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MAX, OP_MIN, OP_MOD,
  OP_ATAN2, OP_GREATER, OP_LOGICAL_OR, OP_LOGICAL_AND,
};

constexpr float kPi = 3.14159265358979323846f;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr float kInvLn10 = 0.4342944819032518f;
constexpr float kTwoOverSqrtPi = 1.1283791670955126f;

__device__ __forceinline__ float nanf_() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ bool pow_bad(float x, float y) {
  return (x < 0.f && y != rintf(y)) || (x == 0.f && y < 0.f);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? nanf_() : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? nanf_() : fminf(a, b);
}

// sign with NaN passed through and +-0 kept (jnp.sign)
__device__ __forceinline__ float sign_f(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : a);
}

// jnp.mod: the exact truncated remainder, moved by y where it is non-zero
// and its sign differs from y's
__device__ __forceinline__ bool mod_fix(float r, float y) {
  return ((r < 0.f) != (y < 0.f)) && r != 0.f;
}

__device__ __forceinline__ float mod_f(float x, float y) {
  const float r = fmodf(x, y);
  return mod_fix(r, y) ? r + y : r;
}

// gamma through exp(lgamma), the reflection for x <= 0; poles and
// non-finite values are NaN. pi * (1 / den) as the plain version's
// `math.pi / den` computes it.
__device__ __forceinline__ float gamma_f(float x) {
  const float pos = expf(lgammaf(x));
  const float neg = kPi * (1.f / (sinf(kPi * x) * expf(lgammaf(1.f - x))));
  const float out = x > 0.f ? pos : neg;
  const bool pole = x <= 0.f && x == rintf(x);
  return (pole || !isfinite(out)) ? nanf_() : out;
}

template <bool kAll>
__device__ __forceinline__ float SR_REGISTRY(apply_unary)(int code, float a) {
  switch (code) {
    case OP_COS: return cosf(a);
    case OP_SIN: return sinf(a);
    case OP_TAN: return tanf(a);
    case OP_EXP: return expf(a);
    case OP_LOG: return a > 0.f ? logf(a) : nanf_();
    case OP_LOG2: return a > 0.f ? log2f(a) : nanf_();
    case OP_LOG10: return a > 0.f ? log10f(a) : nanf_();
    case OP_LOG1P: return a > -1.f ? log1pf(a) : nanf_();
    case OP_SQRT: return a >= 0.f ? sqrtf(a) : nanf_();
    case OP_ABS: return fabsf(a);
    case OP_SQUARE: return a * a;
    case OP_CUBE: return a * a * a;
    case OP_NEG: return -a;
    case OP_RELU: return a != a ? a : fmaxf(a, 0.f);
    case OP_SINH: return sinhf(a);
    case OP_COSH: return coshf(a);
    case OP_TANH: return tanhf(a);
    case OP_SIGMOID: return 1.f / (1.f + expf(-a));
    case OP_INV: return 1.f / a;
    case OP_IDENTITY: return a;
    case OP_SIGN: return sign_f(a);
    case OP_GAUSS: return expf(-(a * a));
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_ASIN: return fabsf(a) <= 1.f ? asinf(a) : nanf_();
      case OP_ACOS: return fabsf(a) <= 1.f ? acosf(a) : nanf_();
      case OP_ATAN: return atanf(a);
      case OP_ASINH: return asinhf(a);
      case OP_ACOSH: return a >= 1.f ? acoshf(a) : nanf_();
      case OP_ATANH: return atanhf(mod_f(a + 1.f, 2.f) - 1.f);
      case OP_ERF: return erff(a);
      case OP_ERFC: return erfcf(a);
      case OP_GAMMA: return gamma_f(a);
      default: break;
    }
  }
  return nanf_();
}

template <bool kAll>
__device__ __forceinline__ float SR_REGISTRY(apply_binary)(int code, float b,
                                                           float a) {
  // b = left operand (second stack entry), a = right operand (top)
  switch (code) {
    case OP_ADD: return b + a;
    case OP_SUB: return b - a;
    case OP_MUL: return b * a;
    case OP_DIV: return b / a;
    case OP_POW: return pow_bad(b, a) ? nanf_() : powf(b, a);
    case OP_MAX: return nan_max(b, a);
    case OP_MIN: return nan_min(b, a);
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_MOD: return mod_f(b, a);
      case OP_ATAN2: return atan2f(b, a);
      case OP_GREATER: return b > a ? 1.f : 0.f;
      case OP_LOGICAL_OR: return (b > 0.f || a > 0.f) ? 1.f : 0.f;
      case OP_LOGICAL_AND: return (b > 0.f && a > 0.f) ? 1.f : 0.f;
      default: break;
    }
  }
  return nanf_();
}

// ---------------------------------------------------------------------------
// Derivatives: the lax JVP rules of the JAX registry functions, in the forms
// of ops/operators.py UNARY_VJP / BINARY_VJP (products where lax multiplies,
// so 0 * inf is NaN; selects where lax selects)
// ---------------------------------------------------------------------------

// The share of d max(x, y) / dx (or min): 1 where x alone is the result,
// 0.5 on a tie, 0 otherwise (NaN included).
__device__ __forceinline__ float balanced_eq(float x, float z, float y) {
  return x == z ? (y == z ? 0.5f : 1.f) : 0.f;
}

// digamma: the CUDA math library has none. Reflection for x < 0
// (psi(x) = psi(1 - x) - pi / tan(pi x)), the recurrence psi(x) =
// psi(x + 1) - 1 / x up to x >= 6, then the asymptotic series
// ln x - 1/(2x) - sum B_2k / (2k x^2k). In double, so that the cancellation
// near the root at 1.4616 costs no float32 digits. psi(0) = -inf, psi at a
// negative integer or -inf = NaN, psi(inf) = inf, as torch.digamma gives.
__device__ __forceinline__ float digamma_f(float xf) {
  if (xf != xf || xf == -INFINITY) return nanf_();
  if (xf == INFINITY) return INFINITY;
  if (xf == 0.f) return copysignf(INFINITY, -xf);
  double x = xf;
  double result = 0.0;
  if (x < 0.0) {
    if (x == floor(x)) return nanf_();
    const double pi = 3.14159265358979323846;
    double ip;
    const double r = modf(x, &ip);  // tan(pi r) is exact where tan(pi x) is not
    result = -pi / tan(pi * r);
    x = 1.0 - x;
  }
  while (x < 6.0) {
    result -= 1.0 / x;
    x += 1.0;
  }
  const double z = 1.0 / (x * x);
  const double series =
      z * (1.0 / 12 - z * (1.0 / 120 - z * (1.0 / 252 - z * (1.0 / 240 -
                                                              z * (1.0 / 132)))));
  return static_cast<float>(result + log(x) - 0.5 / x - series);
}

// gamma' as jax.vjp of gamma_op gives it: both branches of its `where`
// see their selected adjoint (0 for the other), and every local derivative
// multiplies it, so an infinite one in the unselected branch gives NaN.
__device__ __forceinline__ float gamma_vjp(float x, float v, float w) {
  const bool pole = x <= 0.f && x == rintf(x);
  const float g = (pole || !isfinite(v)) ? 0.f : w;
  const float g_pos = x > 0.f ? g : 0.f;
  const float g_neg = x > 0.f ? 0.f : g;
  const float ct_pos = (g_pos * expf(lgammaf(x))) * digamma_f(x);
  const float u = kPi * x;
  const float s = sinf(u);
  const float one_minus = 1.f - x;
  const float e = expf(lgammaf(one_minus));
  const float den = s * e;
  const float ct_den = (-g_neg * kPi) * (1.f / (den * den));
  const float ct_u = (ct_den * e) * cosf(u);
  const float ct_v = ((s * ct_den) * e) * digamma_f(one_minus);
  return (-ct_v + kPi * ct_u) + ct_pos;
}

// safe_asin (sgn 1) / safe_acos (sgn -1): the guard's select, the lax rule
// at the clipped operand, then jnp.clip's two tie-splitting steps
__device__ __forceinline__ float asin_vjp(float a, float w, float sgn) {
  const float m = nan_max(a, -1.f);
  const float c = nan_min(m, 1.f);
  const float r = rsqrtf(1.f - c * c);
  float g = (fabsf(a) <= 1.f ? w : 0.f) * (sgn * r);
  g = g * balanced_eq(m, c, 1.f);
  return g * balanced_eq(a, m, -1.f);
}

// dL/da of a unary slot: operand a, value v, adjoint w arriving at the slot.
template <bool kAll>
__device__ __forceinline__ float SR_REGISTRY(unary_vjp)(int code, float a,
                                                        float v, float w) {
  switch (code) {
    case OP_COS: return -(w * sinf(a));
    case OP_SIN: return w * cosf(a);
    case OP_TAN: return w * (1.f + v * v);
    case OP_EXP: return w * v;
    case OP_LOG: return a > 0.f ? w / a : 0.f;
    case OP_LOG2: return a > 0.f ? (w / kLn2) / a : 0.f;
    case OP_LOG10: return a > 0.f ? (w * kInvLn10) / a : 0.f;
    case OP_LOG1P: return a > -1.f ? w / (a + 1.f) : 0.f;
    case OP_SQRT: return a >= 0.f ? w * (0.5f / v) : 0.f;
    case OP_ABS: return a >= 0.f ? w : -w;
    case OP_SQUARE: return 2.f * (w * a);
    case OP_CUBE: return (a * a) * w + 2.f * ((w * a) * a);
    case OP_NEG: return -w;
    case OP_RELU: return w * balanced_eq(a, v, 0.f);
    case OP_SINH: return w * coshf(a);
    case OP_COSH: return w * sinhf(a);
    case OP_TANH: return (w + w * v) * (1.f - v);
    case OP_SIGMOID: return w * (v * (1.f - v));
    case OP_INV: return -w * (1.f / (a * a));
    case OP_IDENTITY: return w;
    case OP_SIGN: return 0.f;
    case OP_GAUSS: return -2.f * ((w * v) * a);
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_ASIN: return asin_vjp(a, w, 1.f);
      case OP_ACOS: return asin_vjp(a, w, -1.f);
      case OP_ATAN: return w / (1.f + a * a);
      case OP_ASINH: return w * rsqrtf(a * a + 1.f);
      case OP_ACOSH: {
        const bool ok = a >= 1.f;
        const float xs = ok ? a : 1.f;
        return ok ? (w * rsqrtf(xs * xs - 1.f)) : 0.f;
      }
      case OP_ATANH: {
        const float u = mod_f(a + 1.f, 2.f) - 1.f;
        return (1.f / (1.f + u)) * (w / (1.f - u));
      }
      case OP_ERF: return kTwoOverSqrtPi * (w * expf(-(a * a)));
      case OP_ERFC: return -kTwoOverSqrtPi * (w * expf(-(a * a)));
      case OP_GAMMA: return gamma_vjp(a, v, w);
      default: break;
    }
  }
  return nanf_();
}

// (dL/db, dL/da) of a binary slot: left b, right a, value v, adjoint w.
template <bool kAll>
__device__ __forceinline__ void SR_REGISTRY(binary_vjp)(int code, float b,
                                                        float a, float v,
                                                        float w, float* db,
                                                        float* da) {
  switch (code) {
    case OP_ADD: *db = w; *da = w; return;
    case OP_SUB: *db = w; *da = -w; return;
    case OP_MUL: *db = w * a; *da = b * w; return;
    case OP_DIV: *db = w / a; *da = (-w * b) * (1.f / (a * a)); return;
    case OP_POW:
      if (pow_bad(b, a)) {
        *db = 0.f;
        *da = 0.f;
      } else {
        *db = w * (a * powf(b, a - 1.f));
        *da = w * (logf(b == 0.f ? 1.f : b) * v);
      }
      return;
    case OP_MAX:
    case OP_MIN:
      *db = w * balanced_eq(b, v, a);
      *da = w * balanced_eq(a, v, b);
      return;
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_MOD: {
        const float q = b / a;
        *db = w;
        *da = (mod_fix(fmodf(b, a), a) ? w : 0.f) +
              (-w) * (sign_f(q) * floorf(fabsf(q)));
        return;
      }
      case OP_ATAN2: {
        const float r2 = b * b + a * a;
        *db = w * (a / r2);
        *da = w * (-b / r2);
        return;
      }
      case OP_GREATER:
      case OP_LOGICAL_OR:
      case OP_LOGICAL_AND: *db = 0.f; *da = 0.f; return;
      default: break;
    }
  }
  *db = nanf_();
  *da = nanf_();
}

}  // namespace srops

#ifdef SR_USER_OPS
// the user operators' forward and VJP device functions, written in terms of
// the registry_* functions above, the X-macros SR_UNARY_USER /
// SR_BINARY_USER of their opcodes and the SR_USER_*_CASES of the four
// dispatchers below; and, with SR_USER_LOSS 1, the loss callable's
// user_loss_elem / user_loss_seed (csrc/losses.cuh)
#include "sr_user_ops.cuh"

namespace srops {

template <bool kAll>
__device__ __forceinline__ float apply_unary(int code, float a) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_UNARY_CASES
      default: break;
    }
  }
  return registry_apply_unary<kAll>(code, a);
}

template <bool kAll>
__device__ __forceinline__ float apply_binary(int code, float b, float a) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_BINARY_CASES
      default: break;
    }
  }
  return registry_apply_binary<kAll>(code, b, a);
}

template <bool kAll>
__device__ __forceinline__ float unary_vjp(int code, float a, float v,
                                           float w) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_UNARY_VJP_CASES
      default: break;
    }
  }
  return registry_unary_vjp<kAll>(code, a, v, w);
}

template <bool kAll>
__device__ __forceinline__ void binary_vjp(int code, float b, float a, float v,
                                           float w, float* db, float* da) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_BINARY_VJP_CASES
      default: break;
    }
  }
  registry_binary_vjp<kAll>(code, b, a, v, w, db, da);
}

}  // namespace srops
#endif
