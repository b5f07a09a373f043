// Postfix-program scoring kernel for Hopper (sm_90a): value mode, fused-L2-loss
// mode and per-slot values.
//
// Replaces the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_eval.py
// `_make_kernel` / `_postfix_call` (through `eval_trees_pallas` and
// `eval_loss_trees_pallas`): for each of T postfix programs over X
// (nfeat, nrows) f32, run the program's slots up to its own length on every
// row; a non-finite value stored at a non-PAD slot poisons the tree.
//   mode 0 (value): out[t, row] = root value            -> (T, nrows) f32
//   mode 1 (fused): out[t] = sum_rows (root - y[row])^2  -> (T,) f32
//   mode 2 (slots): out[t, s] = value of slot s on the single row
//                   (nrows must be 1), 0 past the length -> (T, L) f32;
//                   constant folding reads every subtree's value from it
// In every mode bad[t] = 1 when the tree was poisoned.
//
// What bounds it on this card: neither HBM bytes nor f32 peak. Each
// (tree, row, slot) step is one table read from shared memory (broadcast),
// two operand reads and one write of the row's slot-value scratch in shared
// memory, a switch on the opcode, and the operator itself; the bytes moved
// (X once per tree, tables, one output) are tiny next to that. So the time
// is set by the instruction count per slot and the shared-memory traffic.
//
// What the design does about it:
//  * One warp takes one tree and its lanes stride the rows, so a slot's
//    opcode is uniform across the warp and the `switch` costs no
//    divergence (the TPU kernel's branchless all-operator mux and its
//    8-way tree interleave are not needed).
//  * The tree's tables are staged once into shared memory; the slot loop
//    stops at the tree's own length. The wrapper sorts trees by length so
//    the warps of a block finish together, and passes the permutation, so
//    results land at each tree's original index without a gather.
//  * Slot values live in shared memory laid out [slot][thread]: dynamic
//    operand indices never spill to local memory, and consecutive lanes
//    hit consecutive banks.
//  * The fused epilogue keeps the (T, nrows) matrix out of device memory:
//    each lane sums its rows in order, then a fixed butterfly of warp
//    shuffles reduces the lanes, so the result is the same on every run
//    (no atomics).
// Built without --use_fast_math: cos/exp/division stay within ulps of
// torch's, and every operator applies the NaN-domain guard of
// symbolicregression_jl_tpu_torch/ops/operators.py.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// Kernel opcodes: the wrapper maps each fused program code to one of these
// (ops/operators.py KERNEL_UNARY_IDS / KERNEL_BINARY_IDS).
enum : int {
  OP_PAD = 0, OP_CONST = 1, OP_VAR = 2,
  OP_COS = 10, OP_SIN, OP_TAN, OP_EXP, OP_LOG, OP_LOG2, OP_LOG10, OP_LOG1P,
  OP_SQRT, OP_ABS, OP_SQUARE, OP_CUBE, OP_NEG, OP_RELU, OP_SINH, OP_COSH,
  OP_TANH, OP_SIGMOID, OP_INV, OP_IDENTITY, OP_SIGN, OP_GAUSS,
  OP_ADD = 40, OP_SUB, OP_MUL, OP_DIV, OP_POW, OP_MAX, OP_MIN,
};

__device__ __forceinline__ float nanf_() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float safe_pow(float x, float y) {
  const bool bad = (x < 0.f && y != rintf(y)) || (x == 0.f && y < 0.f);
  return bad ? nanf_() : powf(x, y);
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
    case OP_POW: return safe_pow(b, a);
    case OP_MAX: return nan_max(b, a);
    case OP_MIN: return nan_min(b, a);
    default: return nanf_();
  }
}

__global__ void __launch_bounds__(kThreads)
postfix_kernel(const int* __restrict__ code, const int* __restrict__ feat,
               const int* __restrict__ lidx, const int* __restrict__ ridx,
               const float* __restrict__ cval,
               const long long* __restrict__ length,
               const long long* __restrict__ order,
               const float* __restrict__ X, const float* __restrict__ y,
               float* __restrict__ out, int* __restrict__ bad,
               int T, int L, int nrows, int mode) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* s_code = smem + warp * 4 * L;
  int* s_feat = s_code + L;
  int* s_lidx = s_feat + L;
  int* s_ridx = s_lidx + L;
  float* s_cval = reinterpret_cast<float*>(smem + kWarpsPerBlock * 4 * L) +
                  warp * L;
  float* vals = reinterpret_cast<float*>(smem + kWarpsPerBlock * 5 * L);

  const int g = blockIdx.x * kWarpsPerBlock + warp;
  if (g >= T) return;  // whole warp leaves; the block never syncs
  const long long t = order[g];
  const int n = static_cast<int>(length[t]);
  for (int s = lane; s < n; s += 32) {
    const long long k = t * L + s;
    s_code[s] = code[k];
    s_feat[s] = feat[k];
    s_lidx[s] = lidx[k];
    s_ridx[s] = ridx[k];
    s_cval[s] = cval[k];
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
        v = apply_unary(c, vals[s_ridx[s] * kThreads + threadIdx.x]);
      } else {
        v = apply_binary(c, vals[s_lidx[s] * kThreads + threadIdx.x],
                         vals[s_ridx[s] * kThreads + threadIdx.x]);
      }
      vals[s * kThreads + threadIdx.x] = v;
      poisoned |= (c != OP_PAD) && !isfinite(v);
    }
    const float root = n > 0 ? vals[(n - 1) * kThreads + threadIdx.x] : 0.f;
    if (mode == 0) {
      out[t * nrows + row] = root;
    } else if (mode == 1) {
      const float d = root - y[row];
      acc += d * d;
    }
  }
  if (mode == 2 && lane == 0) {
    for (int s = 0; s < L; ++s) {
      out[t * L + s] = s < n ? vals[s * kThreads + threadIdx.x] : 0.f;
    }
  }
  const bool any_bad = __any_sync(0xffffffffu, poisoned);
  if (mode == 1) {
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
  }
  if (lane == 0) {
    if (mode == 1) out[t] = acc;
    bad[t] = any_bad ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Shared memory the launch needs for max_len L (tables + slot scratch).
int postfix_eval_smem_bytes(int L) {
  return (kWarpsPerBlock * 5 * L + L * kThreads) * 4;
}

cudaError_t postfix_eval_launch(const void* code, const void* feat,
                                const void* lidx, const void* ridx,
                                const void* cval, const void* length,
                                const void* order, const void* X,
                                const void* y, void* out, void* bad, int T,
                                int L, int nrows, int mode, void* stream) {
  if (T <= 0) return cudaSuccess;
  const int smem = postfix_eval_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      postfix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  postfix_kernel<<<blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(code), static_cast<const int*>(feat),
      static_cast<const int*>(lidx), static_cast<const int*>(ridx),
      static_cast<const float*>(cval),
      static_cast<const long long*>(length),
      static_cast<const long long*>(order), static_cast<const float*>(X),
      static_cast<const float*>(y), static_cast<float*>(out),
      static_cast<int*>(bad), T, L, nrows, mode);
  return cudaGetLastError();
}

const char* postfix_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
