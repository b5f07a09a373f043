// Constant-optimisation kernels for Hopper (sm_90a): per instance, the
// weighted L2 loss of a postfix program and, in the gradient kernel, its
// derivative with respect to every constant slot.
//
// Replace the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_grad.py
// `_make_grad_kernel` / `make_loss_kernel`: with_grad=True (B3, through
// `eval_loss_grad_pallas`: postfix_grad_kernel) and with_grad=False (B4, the
// line-search evaluator, through `eval_loss_pallas`: loss_kernel). For
// instance i over X (nfeat, nrows) f32 with normalised row weights wn
// (w / sum w, or 1/nrows):
//   loss[i]    = sum_rows [wn != 0] wn * (root - y)^2          -> (N,) f32
//   grad[i, s] = d loss[i] / d cval[i, s] for CONST slots s, else 0
//                                              (gradient kernel) -> (N, L) f32
//   bad[i]     = 1 when a value at a live slot is non-finite on any row,
//                zero-weight rows included                      -> (N,) i32
// The loss is returned without containment; the caller applies it with ok.
// Instance i runs the structure (opcodes, operands, length) of tree
// i / reps with its own constants cval[i]: the line search evaluates reps
// candidate constant vectors of one tree.
//
// What bounds them on this card: neither HBM bytes nor f32 peak. Per
// (instance, row, slot) the forward sweep reads an opcode, dispatches, reads
// operands and runs the operator; the adjoint sweep repeats that with the
// derivative. The bytes moved (X, the tables, one loss and L gradient words
// per instance) are tiny beside it, so the time is set by instructions and
// shared-memory traffic per slot.
//
// The gradient kernel, from what B3 computes rather than from the TPU
// kernel's blocks (its instruction compression, packed word and tree
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
//  * Shared memory is 5 L words of tables per warp plus 2 L words per thread
//    of values and adjoints: 53 KB per 256-thread block at L = 24. Above 48
//    KB it needs the dynamic-size attribute; the launcher refuses more than
//    the 227 KB a block may use.
// The loss-only kernel runs a tree's candidates together: the line search's
// 8 candidates share the tree and differ only in their constants, so each
// lane carries kCand candidates x kRows rows (4 x 2 by default, two warps
// per tree: measured against 8 x 1 and 4 x 1 in PERF.md) through the stack
// machine of csrc/postfix_program.cuh, derived in the prologue from the
// TreeBatch fields. The opcode read, the dispatch, the operand address and
// every X read are paid once for kCand candidates and every constant read
// once for kRows rows. Each candidate's loss is its lane's sum over rows
// in row order (the rows of a lane are lane, lane + 32, ...), then the
// gradient kernel's butterfly, and each row's term keeps its order of
// operations, so the loss is the bits of a one-warp-per-instance sum over
// the same rows. Trees run longest first.
// The operators and their derivatives (the lax JVP rule of each JAX
// registry function, in the forms of symbolicregression_jl_tpu_torch/ops/
// operators.py UNARY_VJP / BINARY_VJP) are the shared library
// csrc/operators.cuh. Built without --use_fast_math, like postfix_eval.cu.

#include <cuda_runtime.h>

#include "postfix_program.cuh"

namespace {

using namespace srops;
using srprog::OpMap;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

template <bool kAll>
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
  float* adj = vals + L * kThreads;

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
  // CONST entries accumulate over rows; every other entry is written by its
  // consumer before it is read
  for (int s = 0; s < n; ++s) adj[s * kThreads + tid] = 0.f;
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
  for (int s = 0; s < L; ++s) {
    float gs = 0.f;
    if (s < n && s_code[s] == OP_CONST) gs = warp_sum(adj[s * kThreads + tid]);
    if (lane == 0) grad[inst * L + s] = gs;
  }
}

// ---------------------------------------------------------------------------
// The loss-only kernel
// ---------------------------------------------------------------------------

constexpr int kLossMaxWarps = 8;

struct LossArgs {
  const long long* kind;
  const long long* op;
  const long long* feat;
  const long long* length;
  const long long* order;
  const float* cval;  // (T * reps, L)
  const float* X;
  const float* y;
  const float* wn;
  float* loss;
  int* bad;
  int T, reps, groups, L, nfeat, nrows, cap;
  OpMap map;
};

// One warp per (tree, group of kCand candidates); each lane carries kCand
// candidates x kRows rows (rows p * 32 kRows + j * 32 + lane of pass p).
template <bool kAll, int kCand, int kRows>
__global__ void __launch_bounds__(kLossMaxWarps * 32)
loss_kernel(const __grid_constant__ LossArgs a) {
  constexpr int kN = kCand * kRows;  // values per lane: [candidate][row]
  using St = srprog::Stack<kN>;
  extern __shared__ __align__(16) float loss_smem[];
  float* smem = loss_smem;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stack = smem + warp * a.cap * St::kEntry + lane * St::kLaneWidth;
  int* s_word = reinterpret_cast<int*>(smem + warps * a.cap * St::kEntry) +
                warp * (a.L + 1);
  float* s_cval = reinterpret_cast<float*>(
                      reinterpret_cast<int*>(smem + warps * a.cap * St::kEntry) +
                      warps * (a.L + 1)) +
                  warp * a.L * kCand;  // [slot][candidate]

  const int g = blockIdx.x * warps + warp;
  if (g >= a.T * a.groups) return;  // whole warp leaves; the block never syncs
  const long long tree = a.order[g / a.groups];
  const long long inst0 = tree * a.reps + (g % a.groups) * kCand;
  const long long len = a.length[tree];
  int n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
  const bool invalid =
      srprog::derive_program(a.kind, a.op, a.feat, tree * a.L, n, a.cap,
                             a.nfeat, a.map, s_word, lane) || n != len;
  for (int i = lane; i < n * kCand; i += 32) {
    const int s = i / kCand, c = i - s * kCand;
    s_cval[i] = a.cval[(inst0 + c) * a.L + s];
  }
  __syncwarp();
  if (invalid) n = 0;

  float acc[kCand] = {};
  float pz[kN] = {};
  const unsigned word_a = srprog::opaque(srprog::smem_u32(s_word));
  const unsigned stack_a = srprog::opaque(srprog::smem_u32(stack));
  const unsigned cval_a = srprog::opaque(srprog::smem_u32(s_cval));
  for (int base = 0; n > 0 && base < a.nrows; base += 32 * kRows) {
    float v[kN] = {};
    srprog::run_program<kAll, kN>(
        word_a, n, stack_a, v, pz,
        [&](int s, float (&x)[kN]) {
          float cv[kCand];
#pragma unroll
          for (int c = 0; c < kCand; ++c) {
            cv[c] = srprog::lds_f32(cval_a + 4u * (s * kCand + c));
          }
#pragma unroll
          for (int i = 0; i < kN; ++i) x[i] = cv[i / kRows];
        },
        [&](int f, float (&x)[kN]) {
          const float* xf = a.X + f * a.nrows;
          float xr[kRows];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            xr[j] = xf[min(base + j * 32 + lane, a.nrows - 1)];
          }
#pragma unroll
          for (int i = 0; i < kN; ++i) x[i] = xr[i % kRows];
        },
        [](int, const float (&)[kN]) {});
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int row = base + j * 32 + lane;
      if (row < a.nrows) {
        const float yr = a.y[row];
        const float wr = a.wn[row];
#pragma unroll
        for (int c = 0; c < kCand; ++c) {
          const float d = v[c * kRows + j] - yr;
          if (wr != 0.f) acc[c] += (d * d) * wr;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kCand; ++c) {
    bool nonfinite = false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      nonfinite |= pz[c * kRows + j] != pz[c * kRows + j];
    }
    const bool any_bad = __any_sync(0xffffffffu, nonfinite) || invalid;
    const float sum = warp_sum(acc[c]);
    if (lane == 0) {
      a.loss[inst0 + c] = sum;
      a.bad[inst0 + c] = any_bad ? 1 : 0;
    }
  }
}

// The two layouts: kCandidates candidates x kCandRows rows per lane (the
// line search), or one candidate x kSingleRows rows (any other reps).
constexpr int kCandidates = 4;
constexpr int kCandRows = 2;
constexpr int kSingleRows = 4;

int loss_values_per_lane(int cand) {
  return cand == 1 ? kSingleRows : kCandidates * kCandRows;
}

using LossFn = void (*)(LossArgs);

LossFn loss_kernel_for(bool all, int cand) {
  if (cand == 1) {
    return all ? &loss_kernel<true, 1, kSingleRows>
               : &loss_kernel<false, 1, kSingleRows>;
  }
  return all ? &loss_kernel<true, kCandidates, kCandRows>
             : &loss_kernel<false, kCandidates, kCandRows>;
}

int loss_smem_bytes(int warps, int L, int cand) {
  const int cap = (L + 1) / 2;
  return 4 * warps * (cap * 32 * loss_values_per_lane(cand) + L + 1 + L * cand);
}

template <bool kAll>
cudaError_t launch(const void* code, const void* feat, const void* lidx,
                   const void* ridx, const void* length, const void* order,
                   const void* cval, const void* X, const void* y,
                   const void* wn, void* loss, void* grad, void* bad,
                   int n_inst, int reps, int L, int nrows, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      postfix_grad_kernel<kAll>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n_inst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  postfix_grad_kernel<kAll><<<blocks, kThreads, smem, stream>>>(
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

// Shared memory one block of the gradient kernel needs for max_len L:
// tables, slot values and adjoints.
int postfix_grad_smem_bytes(int L) {
  return (kWarpsPerBlock * 5 * L + 2 * L * kThreads) * 4;
}

int postfix_grad_max_smem_bytes() { return kMaxSmemBytes; }

// The gradient kernel (B3): reps instances per tree, trees in the order
// `order`;
// all_ops: the batch uses an operator outside the common set, so the
// instantiation with every operator runs (operators.cuh)
cudaError_t postfix_grad_launch(const void* code, const void* feat,
                                const void* lidx, const void* ridx,
                                const void* length, const void* order,
                                const void* cval, const void* X,
                                const void* y, const void* wn, void* loss,
                                void* grad, void* bad, int n_inst, int reps,
                                int L, int nrows, int all_ops, void* stream) {
  if (n_inst <= 0) return cudaSuccess;
  const int smem = postfix_grad_smem_bytes(L);
  if (smem > kMaxSmemBytes || reps <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = all_ops ? &launch<true> : &launch<false>;
  return run(code, feat, lidx, ridx, length, order, cval, X, y, wn, loss, grad,
             bad, n_inst, reps, L, nrows, smem, s);
}

// Candidates per lane of the loss-only kernel's line-search layout.
int postfix_loss_candidates() { return kCandidates; }

// The launch layout of the loss-only kernel for reps candidates per tree,
// cand of them per lane (postfix_loss_candidates(), which must divide
// reps, or 1): plan[0] warps (candidate groups) per tree, [1] candidates
// per lane, [2] rows per lane, [3] warps per block, [4] resident blocks per
// SM, [5] shared memory per block in bytes, [6] blocks.
int postfix_loss_plan(int T, int reps, int cand, int L, int all_ops,
                      int* plan) {
  if (T < 0 || reps <= 0 || L <= 0 || L > 510 ||
      !(cand == 1 || (cand == kCandidates && reps % cand == 0))) {
    return cudaErrorInvalidValue;
  }
  int warps = kLossMaxWarps;
  while (warps > 1 && loss_smem_bytes(warps, L, cand) > kMaxSmemBytes) {
    warps >>= 1;
  }
  const int smem = loss_smem_bytes(warps, L, cand);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;
  const LossFn fn = loss_kernel_for(all_ops != 0, cand);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, warps * 32,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(T) * (reps / cand);
  const int p[7] = {reps / cand, cand, cand == 1 ? kSingleRows : kCandRows,
                    warps, occ, smem,
                    static_cast<int>((items + warps - 1) / warps)};
  for (int i = 0; i < 7; ++i) plan[i] = p[i];
  return cudaSuccess;
}

// The loss-only kernel (B4): reps candidate constant vectors (cval rows
// t * reps ...) per tree of the TreeBatch fields kind / op / feat / length,
// trees in the order `order`, cand per lane; opmap as postfix_eval_launch's;
// plan from postfix_loss_plan for the same arguments.
cudaError_t postfix_loss_launch(const void* kind, const void* op,
                                const void* feat, const void* length,
                                const void* order, const void* cval,
                                const void* X, const void* y, const void* wn,
                                void* loss, void* bad, const int* opmap,
                                int n_unary, int n_binary, int T, int reps,
                                int cand, int L, int nfeat, int nrows,
                                int all_ops, const int* plan, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (n_unary + n_binary > srprog::kMaxOps || plan[1] != cand ||
      plan[0] * cand != reps ||
      plan[5] != loss_smem_bytes(plan[3], L, cand) ||
      static_cast<long long>(plan[6]) * plan[3] <
          static_cast<long long>(T) * plan[0]) {
    return cudaErrorInvalidValue;
  }
  LossArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.length = static_cast<const long long*>(length);
  a.order = static_cast<const long long*>(order);
  a.cval = static_cast<const float*>(cval);
  a.X = static_cast<const float*>(X);
  a.y = static_cast<const float*>(y);
  a.wn = static_cast<const float*>(wn);
  a.loss = static_cast<float*>(loss);
  a.bad = static_cast<int*>(bad);
  a.T = T;
  a.reps = reps;
  a.groups = plan[0];
  a.L = L;
  a.nfeat = nfeat;
  a.nrows = nrows;
  a.cap = (L + 1) / 2;
  a.map = srprog::make_op_map(opmap, n_unary, n_binary);
  const LossFn fn = loss_kernel_for(all_ops != 0, plan[1]);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<plan[6], plan[3] * 32, plan[5], static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
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
