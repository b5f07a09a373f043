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
//
// Every function computes in the build's compute type SR_REAL (csrc/
// real.cuh): float, or double in the float64 build, where each one calls
// the double function of the CUDA math library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "real.cuh"

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

constexpr SR_REAL kPi = SR_LIT(3.14159265358979323846);
constexpr SR_REAL kLn2 = SR_LIT(0.69314718055994530942);
constexpr SR_REAL kInvLn10 = SR_LIT(0.4342944819032518);
constexpr SR_REAL kTwoOverSqrtPi = SR_LIT(1.1283791670955126);

#if SR_STORAGE == 3
__device__ __forceinline__ SR_REAL nanf_() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
#else
__device__ __forceinline__ SR_REAL nanf_() {
  return __int_as_float(0x7fc00000);
}
#endif

__device__ __forceinline__ bool pow_bad(SR_REAL x, SR_REAL y) {
  return (x < SR_LIT(0.) && y != SR_FN(rint)(y))
      || (x == SR_LIT(0.) && y < SR_LIT(0.));
}

__device__ __forceinline__ SR_REAL nan_max(SR_REAL a, SR_REAL b) {
  return (a != a || b != b) ? nanf_() : SR_FN(fmax)(a, b);
}

__device__ __forceinline__ SR_REAL nan_min(SR_REAL a, SR_REAL b) {
  return (a != a || b != b) ? nanf_() : SR_FN(fmin)(a, b);
}

// sign with NaN passed through and +-0 kept (jnp.sign)
__device__ __forceinline__ SR_REAL sign_f(SR_REAL a) {
  return a > SR_LIT(0.) ? SR_LIT(1.) : (a < SR_LIT(0.) ? -SR_LIT(1.) : a);
}

// jnp.mod: the exact truncated remainder, moved by y where it is non-zero
// and its sign differs from y's
__device__ __forceinline__ bool mod_fix(SR_REAL r, SR_REAL y) {
  return ((r < SR_LIT(0.)) != (y < SR_LIT(0.))) && r != SR_LIT(0.);
}

__device__ __forceinline__ SR_REAL mod_f(SR_REAL x, SR_REAL y) {
  const SR_REAL r = SR_FN(fmod)(x, y);
  return mod_fix(r, y) ? r + y : r;
}

// gamma through exp(lgamma), the reflection for x <= 0; poles and
// non-finite values are NaN. pi * (1 / den) as the plain version's
// `math.pi / den` computes it.
__device__ __forceinline__ SR_REAL gamma_f(SR_REAL x) {
  const SR_REAL pos = SR_FN(exp)(SR_FN(lgamma)(x));
  const SR_REAL neg =
      kPi * (SR_LIT(1.) / (SR_FN(sin)(kPi * x) *
                           SR_FN(exp)(SR_FN(lgamma)(SR_LIT(1.) - x))));
  const SR_REAL out = x > SR_LIT(0.) ? pos : neg;
  const bool pole = x <= SR_LIT(0.) && x == SR_FN(rint)(x);
  return (pole || !isfinite(out)) ? nanf_() : out;
}

template <bool kAll>
__device__ __forceinline__ SR_REAL SR_REGISTRY(apply_unary)(int code,
                                                            SR_REAL a) {
  switch (code) {
    case OP_COS: return SR_FN(cos)(a);
    case OP_SIN: return SR_FN(sin)(a);
    case OP_TAN: return SR_FN(tan)(a);
    case OP_EXP: return SR_FN(exp)(a);
    case OP_LOG: return a > SR_LIT(0.) ? SR_FN(log)(a) : nanf_();
    case OP_LOG2: return a > SR_LIT(0.) ? SR_FN(log2)(a) : nanf_();
    case OP_LOG10: return a > SR_LIT(0.) ? SR_FN(log10)(a) : nanf_();
    case OP_LOG1P: return a > -SR_LIT(1.) ? SR_FN(log1p)(a) : nanf_();
    case OP_SQRT: return a >= SR_LIT(0.) ? SR_FN(sqrt)(a) : nanf_();
    case OP_ABS: return SR_FN(fabs)(a);
    case OP_SQUARE: return a * a;
    case OP_CUBE: return a * a * a;
    case OP_NEG: return -a;
    case OP_RELU: return a != a ? a : SR_FN(fmax)(a, SR_LIT(0.));
    case OP_SINH: return SR_FN(sinh)(a);
    case OP_COSH: return SR_FN(cosh)(a);
    case OP_TANH: return SR_FN(tanh)(a);
    case OP_SIGMOID: return SR_LIT(1.) / (SR_LIT(1.) + SR_FN(exp)(-a));
    case OP_INV: return SR_LIT(1.) / a;
    case OP_IDENTITY: return a;
    case OP_SIGN: return sign_f(a);
    case OP_GAUSS: return SR_FN(exp)(-(a * a));
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_ASIN: return SR_FN(fabs)(a) <= SR_LIT(1.) ? SR_FN(asin)(a)
          : nanf_();
      case OP_ACOS: return SR_FN(fabs)(a) <= SR_LIT(1.) ? SR_FN(acos)(a)
          : nanf_();
      case OP_ATAN: return SR_FN(atan)(a);
      case OP_ASINH: return SR_FN(asinh)(a);
      case OP_ACOSH: return a >= SR_LIT(1.) ? SR_FN(acosh)(a) : nanf_();
      case OP_ATANH: return SR_FN(atanh)(mod_f(a + SR_LIT(1.),
                                               SR_LIT(2.)) - SR_LIT(1.));
      case OP_ERF: return SR_FN(erf)(a);
      case OP_ERFC: return SR_FN(erfc)(a);
      case OP_GAMMA: return gamma_f(a);
      default: break;
    }
  }
  return nanf_();
}

template <bool kAll>
__device__ __forceinline__ SR_REAL SR_REGISTRY(apply_binary)(int code,
                                                             SR_REAL b,
                                                             SR_REAL a) {
  // b = left operand (second stack entry), a = right operand (top)
  switch (code) {
    case OP_ADD: return b + a;
    case OP_SUB: return b - a;
    case OP_MUL: return b * a;
    case OP_DIV: return b / a;
    case OP_POW: return pow_bad(b, a) ? nanf_() : SR_FN(pow)(b, a);
    case OP_MAX: return nan_max(b, a);
    case OP_MIN: return nan_min(b, a);
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_MOD: return mod_f(b, a);
      case OP_ATAN2: return SR_FN(atan2)(b, a);
      case OP_GREATER: return b > a ? SR_LIT(1.) : SR_LIT(0.);
      case OP_LOGICAL_OR: return (b > SR_LIT(0.) || a > SR_LIT(0.))
          ? SR_LIT(1.) : SR_LIT(0.);
      case OP_LOGICAL_AND: return (b > SR_LIT(0.) && a > SR_LIT(0.))
          ? SR_LIT(1.) : SR_LIT(0.);
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
__device__ __forceinline__ SR_REAL balanced_eq(SR_REAL x, SR_REAL z,
                                               SR_REAL y) {
  return x == z ? (y == z ? SR_LIT(0.5) : SR_LIT(1.)) : SR_LIT(0.);
}

// digamma: the CUDA math library has none. Reflection for x < 0
// (psi(x) = psi(1 - x) - pi / tan(pi x)), the recurrence psi(x) =
// psi(x + 1) - 1 / x up to x >= 6, then the asymptotic series
// ln x - 1/(2x) - sum B_2k / (2k x^2k). In double, so that the cancellation
// near the root at 1.4616 costs no float32 digits; the float64 build runs
// the recurrence further and takes two more terms of the series. psi(0) =
// -inf, psi at a negative integer or -inf = NaN, psi(inf) = inf, as
// torch.digamma gives.
__device__ __forceinline__ SR_REAL digamma_f(SR_REAL xf) {
  if (xf != xf || xf == -INFINITY) return nanf_();
  if (xf == INFINITY) return INFINITY;
  if (xf == SR_LIT(0.)) return SR_FN(copysign)(INFINITY, -xf);
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
#if SR_STORAGE == 3
  // the float64 build: the recurrence up to x >= 10 and two more terms of
  // the series, whose first omitted term, B_16 / (16 x^16), is below 5e-17
  while (x < 10.0) {
    result -= 1.0 / x;
    x += 1.0;
  }
  const double z = 1.0 / (x * x);
  const double series =
      z * (1.0 / 12 -
           z * (1.0 / 120 -
                z * (1.0 / 252 -
                     z * (1.0 / 240 -
                          z * (1.0 / 132 -
                               z * (691.0 / 32760 - z * (1.0 / 12)))))));
#else
  while (x < 6.0) {
    result -= 1.0 / x;
    x += 1.0;
  }
  const double z = 1.0 / (x * x);
  const double series =
      z * (1.0 / 12 - z * (1.0 / 120 - z * (1.0 / 252 - z * (1.0 / 240 -
                                                              z * (1.0 / 132)))));
#endif
  return static_cast<SR_REAL>(result + log(x) - 0.5 / x - series);
}

// gamma' as jax.vjp of gamma_op gives it: both branches of its `where`
// see their selected adjoint (0 for the other), and every local derivative
// multiplies it, so an infinite one in the unselected branch gives NaN.
__device__ __forceinline__ SR_REAL gamma_vjp(SR_REAL x, SR_REAL v, SR_REAL w) {
  const bool pole = x <= SR_LIT(0.) && x == SR_FN(rint)(x);
  const SR_REAL g = (pole || !isfinite(v)) ? SR_LIT(0.) : w;
  const SR_REAL g_pos = x > SR_LIT(0.) ? g : SR_LIT(0.);
  const SR_REAL g_neg = x > SR_LIT(0.) ? SR_LIT(0.) : g;
  const SR_REAL ct_pos = (g_pos * SR_FN(exp)(SR_FN(lgamma)(x))) * digamma_f(x);
  const SR_REAL u = kPi * x;
  const SR_REAL s = SR_FN(sin)(u);
  const SR_REAL one_minus = SR_LIT(1.) - x;
  const SR_REAL e = SR_FN(exp)(SR_FN(lgamma)(one_minus));
  const SR_REAL den = s * e;
  const SR_REAL ct_den = (-g_neg * kPi) * (SR_LIT(1.) / (den * den));
  const SR_REAL ct_u = (ct_den * e) * SR_FN(cos)(u);
  const SR_REAL ct_v = ((s * ct_den) * e) * digamma_f(one_minus);
  return (-ct_v + kPi * ct_u) + ct_pos;
}

// safe_asin (sgn 1) / safe_acos (sgn -1): the guard's select, the lax rule
// at the clipped operand, then jnp.clip's two tie-splitting steps
__device__ __forceinline__ SR_REAL asin_vjp(SR_REAL a, SR_REAL w, SR_REAL sgn) {
  const SR_REAL m = nan_max(a, -SR_LIT(1.));
  const SR_REAL c = nan_min(m, SR_LIT(1.));
  const SR_REAL r = SR_FN(rsqrt)(SR_LIT(1.) - c * c);
  SR_REAL g = (SR_FN(fabs)(a) <= SR_LIT(1.) ? w : SR_LIT(0.)) * (sgn * r);
  g = g * balanced_eq(m, c, SR_LIT(1.));
  return g * balanced_eq(a, m, -SR_LIT(1.));
}

// dL/da of a unary slot: operand a, value v, adjoint w arriving at the slot.
template <bool kAll>
__device__ __forceinline__ SR_REAL SR_REGISTRY(unary_vjp)(int code, SR_REAL a,
                                                          SR_REAL v,
                                                          SR_REAL w) {
  switch (code) {
    case OP_COS: return -(w * SR_FN(sin)(a));
    case OP_SIN: return w * SR_FN(cos)(a);
    case OP_TAN: return w * (SR_LIT(1.) + v * v);
    case OP_EXP: return w * v;
    case OP_LOG: return a > SR_LIT(0.) ? w / a : SR_LIT(0.);
    case OP_LOG2: return a > SR_LIT(0.) ? (w / kLn2) / a : SR_LIT(0.);
    case OP_LOG10: return a > SR_LIT(0.) ? (w * kInvLn10) / a : SR_LIT(0.);
    case OP_LOG1P: return a > -SR_LIT(1.) ? w / (a + SR_LIT(1.)) : SR_LIT(0.);
    case OP_SQRT: return a >= SR_LIT(0.) ? w * (SR_LIT(0.5) / v) : SR_LIT(0.);
    case OP_ABS: return a >= SR_LIT(0.) ? w : -w;
    case OP_SQUARE: return SR_LIT(2.) * (w * a);
    case OP_CUBE: return (a * a) * w + SR_LIT(2.) * ((w * a) * a);
    case OP_NEG: return -w;
    case OP_RELU: return w * balanced_eq(a, v, SR_LIT(0.));
    case OP_SINH: return w * SR_FN(cosh)(a);
    case OP_COSH: return w * SR_FN(sinh)(a);
    case OP_TANH: return (w + w * v) * (SR_LIT(1.) - v);
    case OP_SIGMOID: return w * (v * (SR_LIT(1.) - v));
    case OP_INV: return -w * (SR_LIT(1.) / (a * a));
    case OP_IDENTITY: return w;
    case OP_SIGN: return SR_LIT(0.);
    case OP_GAUSS: return -SR_LIT(2.) * ((w * v) * a);
    default: break;
  }
  if constexpr (kAll) {
    switch (code) {
      case OP_ASIN: return asin_vjp(a, w, SR_LIT(1.));
      case OP_ACOS: return asin_vjp(a, w, -SR_LIT(1.));
      case OP_ATAN: return w / (SR_LIT(1.) + a * a);
      case OP_ASINH: return w * SR_FN(rsqrt)(a * a + SR_LIT(1.));
      case OP_ACOSH: {
        const bool ok = a >= SR_LIT(1.);
        const SR_REAL xs = ok ? a : SR_LIT(1.);
        return ok ? (w * SR_FN(rsqrt)(xs * xs - SR_LIT(1.))) : SR_LIT(0.);
      }
      case OP_ATANH: {
        const SR_REAL u = mod_f(a + SR_LIT(1.), SR_LIT(2.)) - SR_LIT(1.);
        return (SR_LIT(1.) / (SR_LIT(1.) + u)) * (w / (SR_LIT(1.) - u));
      }
      case OP_ERF: return kTwoOverSqrtPi * (w * SR_FN(exp)(-(a * a)));
      case OP_ERFC: return -kTwoOverSqrtPi * (w * SR_FN(exp)(-(a * a)));
      case OP_GAMMA: return gamma_vjp(a, v, w);
      default: break;
    }
  }
  return nanf_();
}

// (dL/db, dL/da) of a binary slot: left b, right a, value v, adjoint w.
template <bool kAll>
__device__ __forceinline__ void SR_REGISTRY(binary_vjp)(int code, SR_REAL b,
                                                        SR_REAL a, SR_REAL v,
                                                        SR_REAL w, SR_REAL* db,
                                                        SR_REAL* da) {
  switch (code) {
    case OP_ADD: *db = w; *da = w; return;
    case OP_SUB: *db = w; *da = -w; return;
    case OP_MUL: *db = w * a; *da = b * w; return;
    case OP_DIV: *db = w / a; *da = (-w * b) * (SR_LIT(1.) / (a * a)); return;
    case OP_POW:
      if (pow_bad(b, a)) {
        *db = SR_LIT(0.);
        *da = SR_LIT(0.);
      } else {
        *db = w * (a * SR_FN(pow)(b, a - SR_LIT(1.)));
        *da = w * (SR_FN(log)(b == SR_LIT(0.) ? SR_LIT(1.) : b) * v);
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
        const SR_REAL q = b / a;
        *db = w;
        *da = (mod_fix(SR_FN(fmod)(b, a), a) ? w : SR_LIT(0.)) +
              (-w) * (sign_f(q) * SR_FN(floor)(SR_FN(fabs)(q)));
        return;
      }
      case OP_ATAN2: {
        const SR_REAL r2 = b * b + a * a;
        *db = w * (a / r2);
        *da = w * (-b / r2);
        return;
      }
      case OP_GREATER:
      case OP_LOGICAL_OR:
      case OP_LOGICAL_AND: *db = SR_LIT(0.); *da = SR_LIT(0.); return;
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
__device__ __forceinline__ SR_REAL apply_unary(int code, SR_REAL a) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_UNARY_CASES
      default: break;
    }
  }
  return registry_apply_unary<kAll>(code, a);
}

template <bool kAll>
__device__ __forceinline__ SR_REAL apply_binary(int code, SR_REAL b,
                                                SR_REAL a) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_BINARY_CASES
      default: break;
    }
  }
  return registry_apply_binary<kAll>(code, b, a);
}

template <bool kAll>
__device__ __forceinline__ SR_REAL unary_vjp(int code, SR_REAL a, SR_REAL v,
                                           SR_REAL w) {
  if constexpr (kAll) {
    switch (code) {
      SR_USER_UNARY_VJP_CASES
      default: break;
    }
  }
  return registry_unary_vjp<kAll>(code, a, v, w);
}

template <bool kAll>
__device__ __forceinline__ void binary_vjp(int code, SR_REAL b, SR_REAL a,
                                           SR_REAL v, SR_REAL w, SR_REAL* db,
                                           SR_REAL* da) {
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
