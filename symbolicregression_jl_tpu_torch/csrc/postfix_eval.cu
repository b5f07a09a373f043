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
// The operators (opcodes, NaN-domain guards, forward functions) are the
// shared library csrc/operators.cuh; built without --use_fast_math.

#include <cuda_runtime.h>

#include "operators.cuh"

namespace {

using namespace srops;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

template <bool kAll>
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
        v = apply_unary<kAll>(c, vals[s_ridx[s] * kThreads + threadIdx.x]);
      } else {
        v = apply_binary<kAll>(c, vals[s_lidx[s] * kThreads + threadIdx.x],
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

template <bool kAll>
cudaError_t launch(const void* code, const void* feat, const void* lidx,
                   const void* ridx, const void* cval, const void* length,
                   const void* order, const void* X, const void* y, void* out,
                   void* bad, int T, int L, int nrows, int mode, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      postfix_kernel<kAll>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T + kWarpsPerBlock - 1) / kWarpsPerBlock;
  postfix_kernel<kAll><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int*>(code), static_cast<const int*>(feat),
      static_cast<const int*>(lidx), static_cast<const int*>(ridx),
      static_cast<const float*>(cval),
      static_cast<const long long*>(length),
      static_cast<const long long*>(order), static_cast<const float*>(X),
      static_cast<const float*>(y), static_cast<float*>(out),
      static_cast<int*>(bad), T, L, nrows, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the launch needs for max_len L (tables + slot scratch).
int postfix_eval_smem_bytes(int L) {
  return (kWarpsPerBlock * 5 * L + L * kThreads) * 4;
}

// all_ops: the batch uses an operator outside the common set, so the
// instantiation with every operator runs (operators.cuh)
cudaError_t postfix_eval_launch(const void* code, const void* feat,
                                const void* lidx, const void* ridx,
                                const void* cval, const void* length,
                                const void* order, const void* X,
                                const void* y, void* out, void* bad, int T,
                                int L, int nrows, int mode, int all_ops,
                                void* stream) {
  if (T <= 0) return cudaSuccess;
  const int smem = postfix_eval_smem_bytes(L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = all_ops ? &launch<true> : &launch<false>;
  return run(code, feat, lidx, ridx, cval, length, order, X, y, out, bad, T, L,
             nrows, mode, smem, s);
}

const char* postfix_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
