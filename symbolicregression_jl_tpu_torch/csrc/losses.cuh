// The elementwise losses of the registry, on the card: loss_elem is the
// loss of one row's prediction, loss_seed its derivative with respect to
// the prediction (the root seed of the gradient kernel's adjoint sweep).
// They read the epilogues of the scoring kernel's fused mode
// (postfix_eval.cu) and of the constant-optimisation kernels
// (postfix_grad.cu), after the program's last slot: with_loss dispatches
// once on the warp-uniform loss id from the kernel's arguments, and the
// epilogue's loop over a lane's values runs elem<K> / seed<K>; the slot loop
// never reads the id.
//
// Counterpart of symbolicregression_jl_tpu_torch/ops/losses.py (LOSS_ELEM /
// LOSS_VJP), which is the JAX package's ops/losses.py with its seeds
// composed as jax.vjp composes them: the same operations in the same order,
// float32 constants computed on the host (Loss::c), abs' = (x >= 0 ? 1 :
// -1), a maximum's derivative 1 for the side it picked, 0.5 at a tie and 0
// otherwise, a where's untaken branch fed a zero cotangent (0 * inf is
// NaN there), pow' = p * x ** (p - 1). Every product, sum and difference is
// an explicit round-to-nearest intrinsic, so no multiply-add is contracted
// whatever the file's -fmad flag: a loss without exp, log, tanh, cos or pow
// gives the bits of the PyTorch version.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "real.cuh"

#ifdef SR_USER_OPS
// a build with the generated header: with SR_USER_LOSS 1 it carries the
// loss callable's user_loss_elem / user_loss_seed (ops/user_ops.py)
#include "operators.cuh"
#endif

namespace srloss {

// the loss ids of ops/losses.py
enum : int {
  kL2 = 0, kL1, kLp, kLogitDist, kHuber, kL1Eps, kL2Eps, kPeriodic, kQuantile,
  kZeroOne, kPerceptron, kL1Hinge, kL2Hinge, kSmoothedL1Hinge, kModifiedHuber,
  kL2Margin, kExp, kSigmoid, kDwdMargin, kLogitMargin, kLogCosh, kNumLosses
};

// The loss ids a launch takes: the registry's, and kUser, a traced loss
// callable, in a build whose generated header has one (only the kAnyLoss
// instantiations dispatch on the id, so only they carry it).
#if defined(SR_USER_OPS) && SR_USER_LOSS
#define SR_HAS_USER_LOSS 1
constexpr int kUser = kNumLosses;
#define SR_LOSS_KINDS (srloss::kNumLosses + 1)
#else
#define SR_LOSS_KINDS srloss::kNumLosses
#endif

// A loss: its id and up to three constants (ops/losses.py
// ElementwiseLoss.constants), float32, or float64 in the float64 build.
struct Loss {
  int kind;
  SR_REAL c0, c1, c2;
};

#if SR_STORAGE == 3
constexpr double kPi = 3.14159265358979323846;   // jnp.pi in float64
constexpr double kLn2 = 0.69314718055994530942;  // jnp.log(2.0) in float64
#else
constexpr SR_REAL kPi = SR_LIT(3.14159274101257324);   // jnp.pi in float32
// jnp.log(2.0) in float32
constexpr SR_REAL kLn2 = SR_LIT(0.693147182464599609);
#endif

__device__ __forceinline__ SR_REAL mul(SR_REAL a, SR_REAL b) {
  return SR_RN(mul)(a, b);
}
__device__ __forceinline__ SR_REAL add(SR_REAL a, SR_REAL b) {
  return SR_RN(add)(a, b);
}
__device__ __forceinline__ SR_REAL sub(SR_REAL a, SR_REAL b) {
  return SR_RN(sub)(a, b);
}
__device__ __forceinline__ SR_REAL div(SR_REAL a, SR_REAL b) {
  return SR_RN(div)(a, b);
}

// abs's derivative times g: g where x >= 0 (0 included), -g elsewhere (NaN
// included)
__device__ __forceinline__ SR_REAL abs_vjp(SR_REAL x, SR_REAL g) {
  return x >= SR_LIT(0.) ? g : -g;
}

// maximum(x, m) for a constant m, NaN kept (x < m ? m : x)
__device__ __forceinline__ SR_REAL max_c(SR_REAL x, SR_REAL m) {
  return x < m ? m : x;
}

// d maximum(x, other) / dx where the maximum was `ans`: 1 where it picked
// x, 0.5 at a tie, 0 elsewhere (NaN included)
__device__ __forceinline__ SR_REAL share(SR_REAL x, SR_REAL ans,
                                         SR_REAL other) {
  return div(x == ans ? SR_LIT(1.) : SR_LIT(0.),
             ans == other ? SR_LIT(2.) : SR_LIT(1.));
}

// x ** e, with the exponents 1 and 2 exact
__device__ __forceinline__ SR_REAL pow_c(SR_REAL x, SR_REAL e) {
  return e == SR_LIT(1.) ? x : (e == SR_LIT(2.) ? mul(x, x) : SR_FN(pow)(x, e));
}

__device__ __forceinline__ SR_REAL sigmoid(SR_REAL x) {
  return div(SR_LIT(1.), add(SR_LIT(1.), SR_FN(exp)(-x)));
}

__device__ __forceinline__ SR_REAL periodic_arg(const Loss& l, SR_REAL p,
                                                SR_REAL t) {
  return div(mul(mul(sub(p, t), SR_LIT(2.)), kPi), l.c0);
}

__device__ __forceinline__ SR_REAL loss_elem(const Loss& l, SR_REAL p,
                                             SR_REAL t) {
  switch (l.kind) {
    case kL1:
      return SR_FN(fabs)(sub(p, t));
    case kLp:
      return pow_c(SR_FN(fabs)(sub(p, t)), l.c0);
    case kLogitDist: {
      const SR_REAL d = sub(p, t);
      return -SR_FN(log)(mul(mul(SR_LIT(4.), sigmoid(d)), sigmoid(-d)));
    }
    case kHuber: {
      const SR_REAL d = SR_FN(fabs)(sub(p, t));
      return d <= l.c0 ? mul(mul(SR_LIT(0.5), d), d) : mul(l.c0, sub(d, l.c1));
    }
    case kL1Eps:
      return max_c(sub(SR_FN(fabs)(sub(p, t)), l.c0), SR_LIT(0.));
    case kL2Eps: {
      const SR_REAL e = max_c(sub(SR_FN(fabs)(sub(p, t)), l.c0), SR_LIT(0.));
      return mul(e, e);
    }
    case kPeriodic:
      return sub(SR_LIT(1.), SR_FN(cos)(periodic_arg(l, p, t)));
    case kQuantile: {
      const SR_REAL d = sub(t, p);
      return d >= SR_LIT(0.) ? mul(l.c0, d) : mul(l.c1, d);
    }
    case kZeroOne:
      return mul(t, p) >= SR_LIT(0.) ? SR_LIT(0.) : SR_LIT(1.);
    case kPerceptron:
      return max_c(mul(-t, p), SR_LIT(0.));
    case kL1Hinge:
      return max_c(sub(SR_LIT(1.), mul(t, p)), SR_LIT(0.));
    case kL2Hinge: {
      const SR_REAL h = max_c(sub(SR_LIT(1.), mul(t, p)), SR_LIT(0.));
      return mul(h, h);
    }
    case kSmoothedL1Hinge: {
      const SR_REAL a = mul(t, p);
      const SR_REAL h = max_c(sub(SR_LIT(1.), a), SR_LIT(0.));
      return a >= l.c0 ? mul(mul(l.c1, h), h) : sub(l.c2, a);
    }
    case kModifiedHuber: {
      const SR_REAL a = mul(t, p);
      const SR_REAL h = max_c(sub(SR_LIT(1.), a), SR_LIT(0.));
      return a >= -SR_LIT(1.) ? mul(h, h) : mul(-SR_LIT(4.), a);
    }
    case kL2Margin: {
      const SR_REAL d = sub(SR_LIT(1.), mul(t, p));
      return mul(d, d);
    }
    case kExp:
      return SR_FN(exp)(mul(-t, p));
    case kSigmoid:
      return sub(SR_LIT(1.), SR_FN(tanh)(mul(t, p)));
    case kDwdMargin: {
      const SR_REAL a = mul(t, p);
      return a <= l.c0 ? sub(SR_LIT(1.), a) : div(l.c1,
                                                  pow_c(max_c(a, l.c0), l.c2));
    }
    case kLogitMargin:
      return SR_FN(log1p)(SR_FN(exp)(mul(-t, p)));
    case kLogCosh: {
      const SR_REAL d = SR_FN(fabs)(sub(p, t));
      return sub(add(d, SR_FN(log1p)(SR_FN(exp)(mul(-SR_LIT(2.), d)))), kLn2);
    }
#ifdef SR_HAS_USER_LOSS
    case kUser:
      return srops::user_loss_elem(p, t);
#endif
    default: {  // kL2
      const SR_REAL d = sub(p, t);
      return mul(d, d);
    }
  }
}

__device__ __forceinline__ SR_REAL loss_seed(const Loss& l, SR_REAL p,
                                             SR_REAL t) {
  switch (l.kind) {
    case kL1:
      return abs_vjp(sub(p, t), SR_LIT(1.));
    case kLp: {
      const SR_REAL r = sub(p, t);
      return abs_vjp(r,
                     mul(l.c0, pow_c(SR_FN(fabs)(r), sub(l.c0, SR_LIT(1.)))));
    }
    case kLogitDist: {
      const SR_REAL d = sub(p, t);
      const SR_REAL s1 = sigmoid(d), s2 = sigmoid(-d);
      const SR_REAL four_s1 = mul(SR_LIT(4.), s1);
      const SR_REAL ct = div(-SR_LIT(1.), mul(four_s1, s2));
      const SR_REAL g1 = mul(mul(SR_LIT(4.), mul(ct, s2)),
                             mul(s1, sub(SR_LIT(1.), s1)));
      const SR_REAL g2 = mul(mul(four_s1, ct), mul(s2, sub(SR_LIT(1.), s2)));
      return sub(g1, g2);
    }
    case kHuber: {
      const SR_REAL r = sub(p, t);
      const SR_REAL d = SR_FN(fabs)(r);
      const SR_REAL cq = d <= l.c0 ? SR_LIT(1.) : SR_LIT(0.);
      return abs_vjp(r, add(mul(cq, d), mul(sub(SR_LIT(1.), cq), l.c0)));
    }
    case kL1Eps: {
      const SR_REAL r = sub(p, t);
      const SR_REAL a = sub(SR_FN(fabs)(r), l.c0);
      return abs_vjp(r, share(a, max_c(a, SR_LIT(0.)), SR_LIT(0.)));
    }
    case kL2Eps: {
      const SR_REAL r = sub(p, t);
      const SR_REAL a = sub(SR_FN(fabs)(r), l.c0);
      const SR_REAL e = max_c(a, SR_LIT(0.));
      return abs_vjp(r, mul(mul(SR_LIT(2.), e), share(a, e, SR_LIT(0.))));
    }
    case kPeriodic:
      return mul(mul(div(SR_FN(sin)(periodic_arg(l, p, t)), l.c0), kPi),
                 SR_LIT(2.));
    case kQuantile:
      return sub(t, p) >= SR_LIT(0.) ? -l.c0 : -l.c1;
    case kZeroOne:
      return SR_LIT(0.);
    case kPerceptron: {
      const SR_REAL a = mul(-t, p);
      return mul(-t, share(a, max_c(a, SR_LIT(0.)), SR_LIT(0.)));
    }
    case kL1Hinge: {
      const SR_REAL a = sub(SR_LIT(1.), mul(t, p));
      return mul(t, -share(a, max_c(a, SR_LIT(0.)), SR_LIT(0.)));
    }
    case kL2Hinge: {
      const SR_REAL a = sub(SR_LIT(1.), mul(t, p));
      const SR_REAL h = max_c(a, SR_LIT(0.));
      return mul(t, -mul(mul(SR_LIT(2.), h), share(a, h, SR_LIT(0.))));
    }
    case kSmoothedL1Hinge: {
      const SR_REAL a = mul(t, p);
      const SR_REAL b = sub(SR_LIT(1.), a);
      const SR_REAL h = max_c(b, SR_LIT(0.));
      const SR_REAL cq = a >= l.c0 ? SR_LIT(1.) : SR_LIT(0.);
      const SR_REAL q = mul(mul(l.c1, h), cq);
      return mul(t,
                 sub(-sub(SR_LIT(1.), cq),
                     mul(add(q, q), share(b, h, SR_LIT(0.)))));
    }
    case kModifiedHuber: {
      const SR_REAL a = mul(t, p);
      const SR_REAL b = sub(SR_LIT(1.), a);
      const SR_REAL h = max_c(b, SR_LIT(0.));
      const SR_REAL cq = a >= -SR_LIT(1.) ? SR_LIT(1.) : SR_LIT(0.);
      const SR_REAL q = mul(h, cq);
      return mul(t, sub(mul(-SR_LIT(4.), sub(SR_LIT(1.), cq)),
                        mul(add(q, q), share(b, h, SR_LIT(0.)))));
    }
    case kL2Margin:
      return mul(t, -mul(SR_LIT(2.), sub(SR_LIT(1.), mul(t, p))));
    case kExp:
      return mul(-t, SR_FN(exp)(mul(-t, p)));
    case kSigmoid: {
      const SR_REAL th = SR_FN(tanh)(mul(t, p));
      return mul(t, mul(sub(-SR_LIT(1.), th), sub(SR_LIT(1.), th)));
    }
    case kDwdMargin: {
      const SR_REAL a = mul(t, p);
      const SR_REAL m = max_c(a, l.c0);
      const SR_REAL P = pow_c(m, l.c2);
      const SR_REAL cl = a <= l.c0 ? SR_LIT(1.) : SR_LIT(0.);
      const SR_REAL P_bar = -mul(mul(sub(SR_LIT(1.), cl),
                                     div(SR_LIT(1.), mul(P, P))), l.c1);
      const SR_REAL m_bar = mul(P_bar,
                                mul(l.c2, pow_c(m, sub(l.c2, SR_LIT(1.)))));
      return mul(t, add(-cl, mul(m_bar, share(a, m, l.c0))));
    }
    case kLogitMargin: {
      const SR_REAL e = SR_FN(exp)(mul(-t, p));
      return mul(-t, mul(div(SR_LIT(1.), add(e, SR_LIT(1.))), e));
    }
    case kLogCosh: {
      const SR_REAL r = sub(p, t);
      const SR_REAL e = SR_FN(exp)(mul(-SR_LIT(2.), SR_FN(fabs)(r)));
      return abs_vjp(r,
                     add(SR_LIT(1.),
                         mul(-SR_LIT(2.),
                             mul(div(SR_LIT(1.), add(e, SR_LIT(1.))), e))));
    }
#ifdef SR_HAS_USER_LOSS
    case kUser:
      return srops::user_loss_seed(p, t);
#endif
    default:  // kL2
      return mul(SR_LIT(2.), sub(p, t));
  }
}

// A loss id as a type: with_loss's cases hand one to the epilogue, whose
// elem<K> / seed<K> then compile to that loss alone.
template <int K>
struct Kind {
  static constexpr int value = K;
};

template <int K>
__device__ __forceinline__ SR_REAL elem(const Loss& l, SR_REAL p, SR_REAL t) {
  return loss_elem(Loss{K, l.c0, l.c1, l.c2}, p, t);
}

template <int K>
__device__ __forceinline__ SR_REAL seed(const Loss& l, SR_REAL p, SR_REAL t) {
  return loss_seed(Loss{K, l.c0, l.c1, l.c2}, p, t);
}

// f(Kind<kind>{}): one dispatch on the (warp-uniform) loss id for a whole
// epilogue, whose loop over a lane's values then runs one loss's code (a
// switch per value made B4 under L1 79 % slower than under L2 on the H100,
// PERF.md).
template <class F>
__device__ __forceinline__ void with_loss(int kind, F&& f) {
  switch (kind) {
    case kL1: f(Kind<kL1>{}); break;
    case kLp: f(Kind<kLp>{}); break;
    case kLogitDist: f(Kind<kLogitDist>{}); break;
    case kHuber: f(Kind<kHuber>{}); break;
    case kL1Eps: f(Kind<kL1Eps>{}); break;
    case kL2Eps: f(Kind<kL2Eps>{}); break;
    case kPeriodic: f(Kind<kPeriodic>{}); break;
    case kQuantile: f(Kind<kQuantile>{}); break;
    case kZeroOne: f(Kind<kZeroOne>{}); break;
    case kPerceptron: f(Kind<kPerceptron>{}); break;
    case kL1Hinge: f(Kind<kL1Hinge>{}); break;
    case kL2Hinge: f(Kind<kL2Hinge>{}); break;
    case kSmoothedL1Hinge: f(Kind<kSmoothedL1Hinge>{}); break;
    case kModifiedHuber: f(Kind<kModifiedHuber>{}); break;
    case kL2Margin: f(Kind<kL2Margin>{}); break;
    case kExp: f(Kind<kExp>{}); break;
    case kSigmoid: f(Kind<kSigmoid>{}); break;
    case kDwdMargin: f(Kind<kDwdMargin>{}); break;
    case kLogitMargin: f(Kind<kLogitMargin>{}); break;
    case kLogCosh: f(Kind<kLogCosh>{}); break;
#ifdef SR_HAS_USER_LOSS
    case kUser: f(Kind<kUser>{}); break;
#endif
    default: f(Kind<kL2>{}); break;
  }
}

}  // namespace srloss
