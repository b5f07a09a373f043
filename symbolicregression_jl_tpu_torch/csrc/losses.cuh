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

// A loss: its id and up to three float32 constants (ops/losses.py
// ElementwiseLoss.constants).
struct Loss {
  int kind;
  float c0, c1, c2;
};

constexpr float kPi = 3.14159274101257324f;   // jnp.pi in float32
constexpr float kLn2 = 0.693147182464599609f;  // jnp.log(2.0) in float32

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// abs's derivative times g: g where x >= 0 (0 included), -g elsewhere (NaN
// included)
__device__ __forceinline__ float abs_vjp(float x, float g) {
  return x >= 0.f ? g : -g;
}

// maximum(x, m) for a constant m, NaN kept (x < m ? m : x)
__device__ __forceinline__ float max_c(float x, float m) {
  return x < m ? m : x;
}

// d maximum(x, other) / dx where the maximum was `ans`: 1 where it picked
// x, 0.5 at a tie, 0 elsewhere (NaN included)
__device__ __forceinline__ float share(float x, float ans, float other) {
  return div(x == ans ? 1.f : 0.f, ans == other ? 2.f : 1.f);
}

// x ** e, with the exponents 1 and 2 exact
__device__ __forceinline__ float pow_c(float x, float e) {
  return e == 1.f ? x : (e == 2.f ? mul(x, x) : powf(x, e));
}

__device__ __forceinline__ float sigmoid(float x) {
  return div(1.f, add(1.f, expf(-x)));
}

__device__ __forceinline__ float periodic_arg(const Loss& l, float p, float t) {
  return div(mul(mul(sub(p, t), 2.f), kPi), l.c0);
}

__device__ __forceinline__ float loss_elem(const Loss& l, float p, float t) {
  switch (l.kind) {
    case kL1:
      return fabsf(sub(p, t));
    case kLp:
      return pow_c(fabsf(sub(p, t)), l.c0);
    case kLogitDist: {
      const float d = sub(p, t);
      return -logf(mul(mul(4.f, sigmoid(d)), sigmoid(-d)));
    }
    case kHuber: {
      const float d = fabsf(sub(p, t));
      return d <= l.c0 ? mul(mul(0.5f, d), d) : mul(l.c0, sub(d, l.c1));
    }
    case kL1Eps:
      return max_c(sub(fabsf(sub(p, t)), l.c0), 0.f);
    case kL2Eps: {
      const float e = max_c(sub(fabsf(sub(p, t)), l.c0), 0.f);
      return mul(e, e);
    }
    case kPeriodic:
      return sub(1.f, cosf(periodic_arg(l, p, t)));
    case kQuantile: {
      const float d = sub(t, p);
      return d >= 0.f ? mul(l.c0, d) : mul(l.c1, d);
    }
    case kZeroOne:
      return mul(t, p) >= 0.f ? 0.f : 1.f;
    case kPerceptron:
      return max_c(mul(-t, p), 0.f);
    case kL1Hinge:
      return max_c(sub(1.f, mul(t, p)), 0.f);
    case kL2Hinge: {
      const float h = max_c(sub(1.f, mul(t, p)), 0.f);
      return mul(h, h);
    }
    case kSmoothedL1Hinge: {
      const float a = mul(t, p);
      const float h = max_c(sub(1.f, a), 0.f);
      return a >= l.c0 ? mul(mul(l.c1, h), h) : sub(l.c2, a);
    }
    case kModifiedHuber: {
      const float a = mul(t, p);
      const float h = max_c(sub(1.f, a), 0.f);
      return a >= -1.f ? mul(h, h) : mul(-4.f, a);
    }
    case kL2Margin: {
      const float d = sub(1.f, mul(t, p));
      return mul(d, d);
    }
    case kExp:
      return expf(mul(-t, p));
    case kSigmoid:
      return sub(1.f, tanhf(mul(t, p)));
    case kDwdMargin: {
      const float a = mul(t, p);
      return a <= l.c0 ? sub(1.f, a) : div(l.c1, pow_c(max_c(a, l.c0), l.c2));
    }
    case kLogitMargin:
      return log1pf(expf(mul(-t, p)));
    case kLogCosh: {
      const float d = fabsf(sub(p, t));
      return sub(add(d, log1pf(expf(mul(-2.f, d)))), kLn2);
    }
#ifdef SR_HAS_USER_LOSS
    case kUser:
      return srops::user_loss_elem(p, t);
#endif
    default: {  // kL2
      const float d = sub(p, t);
      return mul(d, d);
    }
  }
}

__device__ __forceinline__ float loss_seed(const Loss& l, float p, float t) {
  switch (l.kind) {
    case kL1:
      return abs_vjp(sub(p, t), 1.f);
    case kLp: {
      const float r = sub(p, t);
      return abs_vjp(r, mul(l.c0, pow_c(fabsf(r), sub(l.c0, 1.f))));
    }
    case kLogitDist: {
      const float d = sub(p, t);
      const float s1 = sigmoid(d), s2 = sigmoid(-d);
      const float four_s1 = mul(4.f, s1);
      const float ct = div(-1.f, mul(four_s1, s2));
      const float g1 = mul(mul(4.f, mul(ct, s2)), mul(s1, sub(1.f, s1)));
      const float g2 = mul(mul(four_s1, ct), mul(s2, sub(1.f, s2)));
      return sub(g1, g2);
    }
    case kHuber: {
      const float r = sub(p, t);
      const float d = fabsf(r);
      const float cq = d <= l.c0 ? 1.f : 0.f;
      return abs_vjp(r, add(mul(cq, d), mul(sub(1.f, cq), l.c0)));
    }
    case kL1Eps: {
      const float r = sub(p, t);
      const float a = sub(fabsf(r), l.c0);
      return abs_vjp(r, share(a, max_c(a, 0.f), 0.f));
    }
    case kL2Eps: {
      const float r = sub(p, t);
      const float a = sub(fabsf(r), l.c0);
      const float e = max_c(a, 0.f);
      return abs_vjp(r, mul(mul(2.f, e), share(a, e, 0.f)));
    }
    case kPeriodic:
      return mul(mul(div(sinf(periodic_arg(l, p, t)), l.c0), kPi), 2.f);
    case kQuantile:
      return sub(t, p) >= 0.f ? -l.c0 : -l.c1;
    case kZeroOne:
      return 0.f;
    case kPerceptron: {
      const float a = mul(-t, p);
      return mul(-t, share(a, max_c(a, 0.f), 0.f));
    }
    case kL1Hinge: {
      const float a = sub(1.f, mul(t, p));
      return mul(t, -share(a, max_c(a, 0.f), 0.f));
    }
    case kL2Hinge: {
      const float a = sub(1.f, mul(t, p));
      const float h = max_c(a, 0.f);
      return mul(t, -mul(mul(2.f, h), share(a, h, 0.f)));
    }
    case kSmoothedL1Hinge: {
      const float a = mul(t, p);
      const float b = sub(1.f, a);
      const float h = max_c(b, 0.f);
      const float cq = a >= l.c0 ? 1.f : 0.f;
      const float q = mul(mul(l.c1, h), cq);
      return mul(t, sub(-sub(1.f, cq), mul(add(q, q), share(b, h, 0.f))));
    }
    case kModifiedHuber: {
      const float a = mul(t, p);
      const float b = sub(1.f, a);
      const float h = max_c(b, 0.f);
      const float cq = a >= -1.f ? 1.f : 0.f;
      const float q = mul(h, cq);
      return mul(t, sub(mul(-4.f, sub(1.f, cq)),
                        mul(add(q, q), share(b, h, 0.f))));
    }
    case kL2Margin:
      return mul(t, -mul(2.f, sub(1.f, mul(t, p))));
    case kExp:
      return mul(-t, expf(mul(-t, p)));
    case kSigmoid: {
      const float th = tanhf(mul(t, p));
      return mul(t, mul(sub(-1.f, th), sub(1.f, th)));
    }
    case kDwdMargin: {
      const float a = mul(t, p);
      const float m = max_c(a, l.c0);
      const float P = pow_c(m, l.c2);
      const float cl = a <= l.c0 ? 1.f : 0.f;
      const float P_bar = -mul(mul(sub(1.f, cl), div(1.f, mul(P, P))), l.c1);
      const float m_bar = mul(P_bar, mul(l.c2, pow_c(m, sub(l.c2, 1.f))));
      return mul(t, add(-cl, mul(m_bar, share(a, m, l.c0))));
    }
    case kLogitMargin: {
      const float e = expf(mul(-t, p));
      return mul(-t, mul(div(1.f, add(e, 1.f)), e));
    }
    case kLogCosh: {
      const float r = sub(p, t);
      const float e = expf(mul(-2.f, fabsf(r)));
      return abs_vjp(r, add(1.f, mul(-2.f, mul(div(1.f, add(e, 1.f)), e))));
    }
#ifdef SR_HAS_USER_LOSS
    case kUser:
      return srops::user_loss_seed(p, t);
#endif
    default:  // kL2
      return mul(2.f, sub(p, t));
  }
}

// A loss id as a type: with_loss's cases hand one to the epilogue, whose
// elem<K> / seed<K> then compile to that loss alone.
template <int K>
struct Kind {
  static constexpr int value = K;
};

template <int K>
__device__ __forceinline__ float elem(const Loss& l, float p, float t) {
  return loss_elem(Loss{K, l.c0, l.c1, l.c2}, p, t);
}

template <int K>
__device__ __forceinline__ float seed(const Loss& l, float p, float t) {
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
