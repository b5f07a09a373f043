// Constant-optimisation kernel for Hopper (sm_90a): per instance, the
// weighted L2 loss of a postfix program and, in the gradient variant, its
// derivative with respect to every constant slot.
//
// Replaces the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_grad.py
// `_make_grad_kernel` / `make_loss_kernel`: with_grad=True (B3, through
// `eval_loss_grad_pallas`) and with_grad=False (B4, the line-search evaluator,
// through `eval_loss_pallas`). For instance i over X (nfeat, nrows) f32 with
// normalised row weights wn (w / sum w, or 1/nrows):
//   loss[i]    = sum_rows [wn != 0] wn * (root - y)^2          -> (N,) f32
//   grad[i, s] = d loss[i] / d cval[i, s] for CONST slots s, else 0
//                                                   (kWithGrad) -> (N, L) f32
//   bad[i]     = 1 when a value stored at a live slot is non-finite on any
//                row, zero-weight rows included                 -> (N,) i32
// The loss is returned without containment; the caller applies it with ok.
// Instance i runs the structure (opcodes, operand slots, length) of tree
// i / reps with its own constants cval[i]: the line search evaluates reps
// candidate constant vectors of one tree without repeating its tables.
//
// What bounds it on this card: neither HBM bytes nor f32 peak. Per (instance,
// row, slot) the forward sweep does a broadcast table read, operand reads and
// a write in shared memory, a switch and the operator; the adjoint sweep
// repeats that with the derivative. The bytes moved (X once per instance, the
// tables, one loss and L gradient words per instance) are tiny beside it, so
// the time is set by instructions and shared-memory traffic per slot.
//
// What the design does about it, from what B3 computes rather than from the
// TPU kernel's blocks (its instruction compression, packed word and tree
// interleave answer the TPU's scalar unit and are not carried over):
//  * One warp per instance, lanes stride the rows, so each slot's opcode is
//    uniform across the warp and the switches cost no divergence. Instances
//    are ordered by their tree's length (the wrapper's sort), so the warps of
//    a block finish together; results land at each instance's own index.
//  * The postfix operand schedule gives every slot its operand slots, and
//    the gradient is wanted per postfix slot, so the postfix program runs as
//    it is: forward values in shared memory [slot][thread]; then the seed
//    wn * 2 (root - y) at the root (0 on zero-weight rows, whose 0 * inf
//    local derivatives still reach the gradient as NaN, as jax.grad gives);
//    then the adjoint sweep in descending slot order. Every node has one
//    consumer, so an operator slot's adjoint is written once per row before
//    it is read; a unary slot pushes to its right operand only (its left
//    index names a real sibling slot, whose adjoint must not be
//    overwritten).
//  * A CONST slot's adjoint array entry is its lane's accumulator over rows.
//    At the end each CONST slot is reduced over the warp by a fixed
//    butterfly of shuffles, as is the loss: no atomics, the same bits on
//    every run.
//  * Shared memory is 5 L words of tables per warp plus L words per thread
//    of values and, with the gradient, L more of adjoints: 53 KB per
//    256-thread block at L = 24, 141 KB at L = 64. Above 48 KB it needs the
//    dynamic-size attribute; the launcher refuses more than the 227 KB a
//    block may use.
// The derivative of each operator is the lax JVP rule of the JAX registry
// function, in the forms of symbolicregression_jl_tpu_torch/ops/operators.py
// UNARY_VJP / BINARY_VJP. Built without --use_fast_math, like postfix_eval.cu,
// whose forward device functions this file repeats.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use
constexpr float kLn2 = 0.69314718055994530942f;
constexpr float kInvLn10 = 0.4342944819032518f;

// Kernel opcodes (ops/operators.py KERNEL_UNARY_IDS / KERNEL_BINARY_IDS).
enum : int {
  OP_PAD = 0, OP_CONST = 1, OP_VAR = 2,
  OP_COS = 10, OP_SIN, OP_TAN, OP_EXP, OP_LOG, OP_LOG2, OP_LOG10, OP_LOG1P,
  OP_SQRT, OP_ABS, OP_SQUARE, OP_CUBE, OP_NEG, OP_RELU, OP_SINH, OP_COSH,
  OP_TANH, OP_SIGMOID, OP_INV, OP_IDENTITY, OP_SIGN, OP_GAUSS,
  OP_ADD = 40, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MAX, OP_MIN,
};

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

__device__ __forceinline__ float apply_unary(int code, float a) {
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
    case OP_SIGN: return a > 0.f ? 1.f : (a < 0.f ? -1.f : a);
    case OP_GAUSS: return expf(-(a * a));
    default: return nanf_();
  }
}

__device__ __forceinline__ float apply_binary(int code, float b, float a) {
  // b = left operand (second stack entry), a = right operand (top)
  switch (code) {
    case OP_ADD: return b + a;
    case OP_SUB: return b - a;
    case OP_MUL: return b * a;
    case OP_DIV: return b / a;
    case OP_POW: return pow_bad(b, a) ? nanf_() : powf(b, a);
    case OP_MAX: return nan_max(b, a);
    case OP_MIN: return nan_min(b, a);
    default: return nanf_();
  }
}

// The share of d max(x, y) / dx (or min): 1 where x alone is the result,
// 0.5 on a tie, 0 otherwise (NaN included).
__device__ __forceinline__ float balanced_eq(float x, float z, float y) {
  return x == z ? (y == z ? 0.5f : 1.f) : 0.f;
}

// dL/da of a unary slot: operand a, value v, adjoint w arriving at the slot.
__device__ __forceinline__ float unary_vjp(int code, float a, float v,
                                           float w) {
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
    default: return nanf_();
  }
}

// (dL/db, dL/da) of a binary slot: left b, right a, value v, adjoint w.
__device__ __forceinline__ void binary_vjp(int code, float b, float a, float v,
                                           float w, float* db, float* da) {
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
    default: *db = nanf_(); *da = nanf_(); return;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <bool kWithGrad>
__global__ void __launch_bounds__(kThreads)
postfix_grad_kernel(const int* __restrict__ code, const int* __restrict__ feat,
                    const int* __restrict__ lidx, const int* __restrict__ ridx,
                    const long long* __restrict__ length,
                    const long long* __restrict__ order,
                    const float* __restrict__ cval,
                    const float* __restrict__ X, const float* __restrict__ y,
                    const float* __restrict__ wn, float* __restrict__ loss,
                    float* __restrict__ grad, int* __restrict__ bad,
                    int n_inst, int reps, int L, int nrows) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  int* s_code = smem + warp * 4 * L;
  int* s_feat = s_code + L;
  int* s_lidx = s_feat + L;
  int* s_ridx = s_lidx + L;
  float* s_cval = reinterpret_cast<float*>(smem + kWarpsPerBlock * 4 * L) +
                  warp * L;
  float* vals = reinterpret_cast<float*>(smem + kWarpsPerBlock * 5 * L);
  float* adj = vals + L * kThreads;  // only with kWithGrad

  const int g = blockIdx.x * kWarpsPerBlock + warp;
  if (g >= n_inst) return;  // whole warp leaves; the block never syncs
  const long long tree = order[g / reps];
  const long long inst = tree * reps + g % reps;
  const int n = static_cast<int>(length[tree]);
  for (int s = lane; s < n; s += 32) {
    const long long k = tree * L + s;
    s_code[s] = code[k];
    s_feat[s] = feat[k];
    s_lidx[s] = lidx[k];
    s_ridx[s] = ridx[k];
    s_cval[s] = cval[inst * L + s];
  }
  if (kWithGrad) {
    // CONST entries accumulate over rows; every other entry is written by
    // its consumer before it is read
    for (int s = 0; s < n; ++s) adj[s * kThreads + tid] = 0.f;
  }
  __syncwarp();

  float acc = 0.f;
  bool poisoned = false;
  for (int row = lane; row < nrows; row += 32) {
    for (int s = 0; s < n; ++s) {
      const int c = s_code[s];
      float v;
      if (c == OP_CONST) {
        v = s_cval[s];
      } else if (c <= OP_VAR) {  // VAR, and PAD which never poisons
        v = X[static_cast<long long>(s_feat[s]) * nrows + row];
      } else if (c < OP_ADD) {
        v = apply_unary(c, vals[s_ridx[s] * kThreads + tid]);
      } else {
        v = apply_binary(c, vals[s_lidx[s] * kThreads + tid],
                         vals[s_ridx[s] * kThreads + tid]);
      }
      vals[s * kThreads + tid] = v;
      poisoned |= (c != OP_PAD) && !isfinite(v);
    }
    if (n == 0) continue;
    const float d = vals[(n - 1) * kThreads + tid] - y[row];
    const float wr = wn[row];
    if (wr != 0.f) acc += (d * d) * wr;
    if (!kWithGrad) continue;

    const float seed = wr != 0.f ? (2.f * d) * wr : 0.f;
    float* root_adj = &adj[(n - 1) * kThreads + tid];
    *root_adj = s_code[n - 1] == OP_CONST ? *root_adj + seed : seed;
    for (int s = n - 1; s >= 0; --s) {
      const int c = s_code[s];
      if (c < OP_COS) continue;  // a leaf: CONST keeps its sum, VAR drops it
      const float w = adj[s * kThreads + tid];
      const float v = vals[s * kThreads + tid];
      const int ri = s_ridx[s];
      const float a = vals[ri * kThreads + tid];
      float da, db = 0.f;
      if (c < OP_ADD) {
        da = unary_vjp(c, a, v, w);
      } else {
        binary_vjp(c, vals[s_lidx[s] * kThreads + tid], a, v, w, &db, &da);
      }
      float* ra = &adj[ri * kThreads + tid];
      *ra = s_code[ri] == OP_CONST ? *ra + da : da;
      if (c >= OP_ADD) {
        const int li = s_lidx[s];
        float* la = &adj[li * kThreads + tid];
        *la = s_code[li] == OP_CONST ? *la + db : db;
      }
    }
  }

  const bool any_bad = __any_sync(0xffffffffu, poisoned);
  acc = warp_sum(acc);
  if (lane == 0) {
    loss[inst] = acc;
    bad[inst] = any_bad ? 1 : 0;
  }
  if (kWithGrad) {
    for (int s = 0; s < L; ++s) {
      float gs = 0.f;
      if (s < n && s_code[s] == OP_CONST) gs = warp_sum(adj[s * kThreads + tid]);
      if (lane == 0) grad[inst * L + s] = gs;
    }
  }
}

template <bool kWithGrad>
cudaError_t launch(const void* code, const void* feat, const void* lidx,
                   const void* ridx, const void* length, const void* order,
                   const void* cval, const void* X, const void* y,
                   const void* wn, void* loss, void* grad, void* bad,
                   int n_inst, int reps, int L, int nrows, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      postfix_grad_kernel<kWithGrad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_inst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  postfix_grad_kernel<kWithGrad><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(code), static_cast<const int*>(feat),
      static_cast<const int*>(lidx), static_cast<const int*>(ridx),
      static_cast<const long long*>(length),
      static_cast<const long long*>(order), static_cast<const float*>(cval),
      static_cast<const float*>(X), static_cast<const float*>(y),
      static_cast<const float*>(wn), static_cast<float*>(loss),
      static_cast<float*>(grad), static_cast<int*>(bad), n_inst, reps, L,
      nrows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for max_len L: tables, slot values and,
// with the gradient, adjoints.
int postfix_grad_smem_bytes(int L, int with_grad) {
  return (kWarpsPerBlock * 5 * L + (with_grad ? 2 : 1) * L * kThreads) * 4;
}

int postfix_grad_max_smem_bytes() { return kMaxSmemBytes; }

cudaError_t postfix_grad_launch(const void* code, const void* feat,
                                const void* lidx, const void* ridx,
                                const void* length, const void* order,
                                const void* cval, const void* X,
                                const void* y, const void* wn, void* loss,
                                void* grad, void* bad, int n_inst, int reps,
                                int L, int nrows, int with_grad,
                                void* stream) {
  if (n_inst <= 0) return cudaSuccess;
  const int smem = postfix_grad_smem_bytes(L, with_grad);
  if (smem > kMaxSmemBytes || reps <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_grad
             ? launch<true>(code, feat, lidx, ridx, length, order, cval, X, y,
                            wn, loss, grad, bad, n_inst, reps, L, nrows, smem,
                            s)
             : launch<false>(code, feat, lidx, ridx, length, order, cval, X,
                             y, wn, loss, grad, bad, n_inst, reps, L, nrows,
                             smem, s);
}

const char* postfix_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
