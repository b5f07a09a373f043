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
// The operators and their derivatives (the lax JVP rule of each JAX
// registry function, in the forms of symbolicregression_jl_tpu_torch/ops/
// operators.py UNARY_VJP / BINARY_VJP) are the shared library
// csrc/operators.cuh. Built without --use_fast_math, like postfix_eval.cu.

#include <cuda_runtime.h>

#include "operators.cuh"

namespace {

using namespace srops;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <bool kWithGrad, bool kAll>
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
        v = apply_unary<kAll>(c, vals[s_ridx[s] * kThreads + tid]);
      } else {
        v = apply_binary<kAll>(c, vals[s_lidx[s] * kThreads + tid],
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
        da = unary_vjp<kAll>(c, a, v, w);
      } else {
        binary_vjp<kAll>(c, vals[s_lidx[s] * kThreads + tid], a, v, w, &db,
                         &da);
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

template <bool kWithGrad, bool kAll>
cudaError_t launch(const void* code, const void* feat, const void* lidx,
                   const void* ridx, const void* length, const void* order,
                   const void* cval, const void* X, const void* y,
                   const void* wn, void* loss, void* grad, void* bad,
                   int n_inst, int reps, int L, int nrows, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      postfix_grad_kernel<kWithGrad, kAll>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_inst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  postfix_grad_kernel<kWithGrad, kAll><<<blocks, kThreads, smem, stream>>>(
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

// digamma_f elementwise: lets a test hold the hand-written digamma against
// torch.digamma on the card (no kernel of the search calls it)
__global__ void digamma_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = digamma_f(x[i]);
}

}  // namespace

extern "C" {

// Shared memory one block needs for max_len L: tables, slot values and,
// with the gradient, adjoints.
int postfix_grad_smem_bytes(int L, int with_grad) {
  return (kWarpsPerBlock * 5 * L + (with_grad ? 2 : 1) * L * kThreads) * 4;
}

int postfix_grad_max_smem_bytes() { return kMaxSmemBytes; }

// all_ops: the batch uses an operator outside the common set, so the
// instantiation with every operator runs (operators.cuh)
cudaError_t postfix_grad_launch(const void* code, const void* feat,
                                const void* lidx, const void* ridx,
                                const void* length, const void* order,
                                const void* cval, const void* X,
                                const void* y, const void* wn, void* loss,
                                void* grad, void* bad, int n_inst, int reps,
                                int L, int nrows, int with_grad, int all_ops,
                                void* stream) {
  if (n_inst <= 0) return cudaSuccess;
  const int smem = postfix_grad_smem_bytes(L, with_grad);
  if (smem > kMaxSmemBytes || reps <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run =
      with_grad ? (all_ops ? &launch<true, true> : &launch<true, false>)
                : (all_ops ? &launch<false, true> : &launch<false, false>);
  return run(code, feat, lidx, ridx, length, order, cval, X, y, wn, loss, grad,
             bad, n_inst, reps, L, nrows, smem, s);
}

cudaError_t postfix_grad_digamma(const void* x, void* out, int n,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  digamma_kernel<<<(n + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}

const char* postfix_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
