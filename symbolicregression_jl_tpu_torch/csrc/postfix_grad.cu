// Constant-optimisation kernels for Hopper (sm_90a): per instance, the
// weighted elementwise loss of a postfix program (any loss of the registry,
// csrc/losses.cuh) and, in the gradient kernel, its derivative with respect
// to every constant slot.
//
// Replace the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_grad.py
// `_make_grad_kernel` / `make_loss_kernel`: with_grad=True (B3, through
// `eval_loss_grad_pallas`: postfix_grad_kernel) and with_grad=False (B4, the
// line-search evaluator, through `eval_loss_pallas`: loss_kernel). For
// instance i over X (nfeat, nrows) f32 with normalised row weights wn
// (w / sum w, or 1/nrows):
//   loss[i]    = sum_rows [wn != 0] loss(root, y) * wn         -> (N,) f32
//   grad[i, s] = d loss[i] / d cval[i, s] for CONST slots s, else 0
//                                              (gradient kernel) -> (N, L) f32
//   bad[i]     = 1 when a value at a live slot is non-finite on any row,
//                zero-weight rows included                      -> (N,) i32
// The loss is returned without containment; the caller applies it with ok.
// Instance i runs the structure (opcodes, operands, length) of tree
// i / reps with its own constants cval[i]: the line search evaluates reps
// candidate constant vectors of one tree. A tree that is not a valid
// postfix program is not run: bad 1, loss and gradient 0.
//
// What bounds them on this card: neither HBM bytes nor f32 peak. Per
// (instance, row, slot) the forward sweep reads an opcode, dispatches, reads
// operands and runs the operator; the adjoint sweep repeats that with the
// derivative. The bytes moved (X, the tree fields, one loss and L gradient
// words per instance) are tiny beside it, so the time is set by
// instructions and shared-memory traffic per slot, and by how many rows a
// block's shared memory lets be in flight.
//
// Both kernels run the stack machine of csrc/postfix_program.cuh, derived
// in the prologue from the TreeBatch fields (no host tables): the top of
// the stack in registers, several values per lane, so one opcode read, one
// dispatch and one address serve them all. Trees run longest first (the
// wrapper's order), so the warps of a block finish together; results land
// at each instance's own index.
//
// The gradient kernel, from what B3 computes rather than from the TPU
// kernel's blocks (its instruction compression, packed word and tree
// interleave answer the TPU's scalar unit and are not carried over):
//  * One warp per instance; a lane carries kGradRows rows (pass p's rows
//    p * 64 + j * 32 + lane). The forward sweep stores every slot's
//    values, one vector store per slot, into [slot][lane] storage, and
//    reads a binary slot's left operand there, so it needs no stack; the
//    loss and its seed loss_seed(root, y) * wn follow (0 on zero-weight
//    rows, whose 0 * inf local derivatives still reach the gradient as
//    NaN, as jax.grad gives); then run_adjoint walks the slots in
//    descending order with the adjoint in registers: an operator slot's adjoint is written
//    once, by its one consumer, and a binary slot's left operand's adjoint
//    waits in the values of a slot that no later step reads. The prologue
//    writes each binary slot's left operand and each CONST slot's rank
//    into the words (derive_adjoint_words).
//  * A CONST slot's adjoint is its lane's accumulator over rows, in row
//    order; at the end each CONST slot is reduced over the warp by a fixed
//    butterfly of shuffles, as is the loss, and the gradient row goes out
//    as one coalesced store per 32 slots: no atomics, the same bits on
//    every run. Each row's adjoints take the same operations as in a
//    slot-indexed sweep, and the rows of a lane are summed in the same
//    order, so the bits are those of one row per lane.
//  * Shared memory per warp is L slots of kGradRows floats per lane,
//    (L + 1) / 2 CONST accumulators per lane (a valid program has at most
//    that many leaves), the words and the constants: the resident warps,
//    and so the rows in flight, bound the kernel. 2 rows per lane ran
//    faster than 4 (fewer warps) and 1 (less work per dispatch) (PERF.md),
//    and one warp fits up to max_len ~700 (165 KB at L = 504); the plan
//    takes the warps per block that keep the most warps resident. Above
//    that, the narrow route (kNarrow): one row per lane, the slot values
//    and accumulators in shared memory when one warp's fit, else in global
//    memory, one region per resident warp (srprog::narrow_plan), the warps
//    looping over the instances; the words and constants stay in shared
//    memory. The same row order, so the same bits.
// The loss-only kernel runs a tree's candidates together: the line search's
// 8 candidates share the tree and differ only in their constants, so each
// lane carries kCand candidates x kRows rows (4 x 2 by default, two warps
// per tree: measured against 8 x 1 and 4 x 1 in PERF.md). The opcode read,
// the dispatch, the operand address and every X read are paid once for
// kCand candidates and every constant read once for kRows rows. Each
// candidate's loss is its lane's sum over rows in row order (the rows of a
// lane are lane, lane + 32, ...), then the gradient kernel's butterfly,
// and each row's term keeps its order of operations, so the loss is the
// bits of the gradient kernel's loss for the same constants (BFGS compares
// the two).
// The loss: L2 runs its own instantiations, (d * d) * wn and (2 d) * wn
// inline; every other loss the kAnyLoss instantiations, whose epilogue
// switches on the loss id (a kernel argument, uniform over the warp) after
// the program's last slot: loss_elem(root, y) * wn and loss_seed(root, y) *
// wn (csrc/losses.cuh, the forms of ops/losses.py LOSS_ELEM / LOSS_VJP).
// Both kernels call the same function in the same order, so B3's loss is
// B4's in every bit for every loss.
// The bfloat16 and float16 builds (SR_STORAGE, csrc/postfix_program.cuh)
// are the card's route for the reference's constant optimisation at those
// precisions (`_bfgs_single` through jax.grad of the interpreter,
// constant_opt.py:83-140, which the fused kernels never run below
// float32): X, y and the constants in the storage type, the forward sweep
// rounding every slot's value to it as the scoring kernel does, so BFGS
// fits the values that scoring sees; the loss, its seed, the adjoint sweep
// and the row sums stay in float32, and B3's loss is still B4's in every
// bit. The float64 build (SR_STORAGE 3) runs all of it in double, with its
// slot values, accumulators and stacks 8 bytes per value (the layouts of
// grad_warp_floats, loss_smem_bytes and the narrow routes).
// The gradient kernel's cotangent-seeded mode (kCotangent, below) replaces
// the loss's seed by a seed per instance and row read from memory: the VJP
// of the value mode with respect to the constants, which a custom
// objective's gradient needs (ops/interpreter.py EvalTreeVJP).
// The operators and their derivatives (the lax JVP rule of each JAX
// registry function, in the forms of symbolicregression_jl_tpu_torch/ops/
// operators.py UNARY_VJP / BINARY_VJP) are the shared library
// csrc/operators.cuh. Built without --use_fast_math, like postfix_eval.cu.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "postfix_program.cuh"

namespace {

using namespace srops;
using srprog::OpMap;

constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ SR_REAL warp_sum(SR_REAL x) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------------
// The gradient kernel
// ---------------------------------------------------------------------------

constexpr int kGradMaxWarps = 8;
constexpr int kGradRows = 2;  // rows per lane

struct GradArgs {
  const long long* kind;
  const long long* op;
  const long long* feat;
  const long long* length;
  const long long* order;
  const srprog::Storage* cval;  // (T * reps, L)
  const srprog::Storage* X;
  const srprog::Storage* y;
  const SR_REAL* wn;
  SR_REAL* loss;
  SR_REAL* grad;
  int* bad;
  SR_REAL* scratch;  // the narrow route's slot values in global memory, or null
  const SR_REAL* cot;  // the cotangent mode's seeds (T * reps, nrows)
  // per_set: trees per dataset; X (T / per_set, nfeat, nrows), y and wn
  // (T / per_set, nrows), tree t reading set t / per_set
  int T, per_set, reps, L, nfeat, nrows, cap;
  OpMap map;
  srloss::Loss loss_fn;  // the kAnyLoss instantiations' loss
};

// The loss id of the cotangent-seeded mode (ops/kernel_grad.py
// COTANGENT_KIND), beside the registry's ids and kUser: the seed of row r
// of instance i is cot[i, r], read from memory, and its term cot[i, r] *
// root, so the gradient is the vector-Jacobian product sum_r cot[i, r] *
// d root[i, r] / d cval[i, :] of the value mode (B1), and the loss the sum
// of the terms. No weights. The VJP of eval_tree (ops/interpreter.py)
// under a custom objective.
constexpr int kCotangent = 32;

// Floats of shared memory per warp: slot values of rows floats per lane,
// the CONST accumulators [rank][lane], then the words (L + 1, two floats
// each) and the constants (L), rounded to 16 bytes.
#if SR_STORAGE == 3
// (The float64 build: doubles, a word one double, rounded to 16 bytes.)
__host__ __device__ constexpr long long grad_warp_floats(int L, int rows) {
  return static_cast<long long>(L) * 32 * rows + 32LL * ((L + 1) / 2) +
         ((2LL * L + 1 + 1) & ~1LL);
}
#else
__host__ __device__ constexpr long long grad_warp_floats(int L, int rows) {
  return static_cast<long long>(L) * 32 * rows + 32LL * ((L + 1) / 2) +
         ((3LL * L + 2 + 3) & ~3LL);
}
#endif

// The narrow route's parts per warp: the words and constants (shared
// memory) and the slot values and accumulators of one row per lane
// (shared or global memory), in bytes.
#if SR_STORAGE == 3
long long grad_narrow_fixed_bytes(int L) { return 8LL * (2LL * L + 1); }
long long grad_narrow_scratch_bytes(int L) {
  return 8LL * 32 * (L + (L + 1) / 2);
}
#else
long long grad_narrow_fixed_bytes(int L) { return 4LL * (3LL * L + 2); }
long long grad_narrow_scratch_bytes(int L) {
  return 4LL * 32 * (L + (L + 1) / 2);
}
#endif

// One warp per instance. kNarrow: the narrow route (kN is 1), the warps
// looping over the instances. kAnyLoss: a loss other than L2 (a.loss_fn).
// kCot: the cotangent-seeded mode (kCotangent).
template <bool kAll, int kN, bool kNarrow, bool kAnyLoss = false,
          bool kCot = false>
__global__ void __launch_bounds__(kGradMaxWarps * 32)
postfix_grad_kernel(const __grid_constant__ GradArgs a) {
  using St = srprog::Stack<kN, kNarrow>;
  using Addr = typename St::Addr;
  using M = typename St::M;
  constexpr unsigned kEntryBytes = St::kEntryBytes;
  extern __shared__ __align__(16) SR_REAL grad_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  SR_REAL* vals;
  int2* s_word;
  SR_REAL* s_cval;
  if constexpr (kNarrow) {
    s_word = reinterpret_cast<int2*>(grad_smem) + warp * (a.L + 1);
    SR_REAL* cvals = reinterpret_cast<SR_REAL*>(
        reinterpret_cast<int2*>(grad_smem) + warps * (a.L + 1));
    s_cval = cvals + warp * a.L;
    const long long per = 32LL * (a.L + a.cap);
    vals = a.scratch ? a.scratch + gw * per : cvals + warps * a.L + warp * per;
  } else {
    vals = grad_smem + warp * grad_warp_floats(a.L, kN);
    s_word = reinterpret_cast<int2*>(vals + a.L * St::kEntry + 32 * a.cap);
    s_cval = reinterpret_cast<SR_REAL*>(s_word + a.L + 1);
  }
  SR_REAL* cacc = vals + a.L * St::kEntry;
  const long long total = static_cast<long long>(a.T) * a.reps;
  const unsigned word_a = srprog::opaque(srprog::smem_u32(s_word));
  const unsigned cval_a = srprog::opaque(srprog::smem_u32(s_cval));
  Addr vals_a, cacc_a;
  if constexpr (kNarrow) {
    vals_a = srprog::gen_u64(vals + lane * St::kLaneWidth);
    cacc_a = srprog::gen_u64(cacc + lane);
  } else {
    vals_a = srprog::opaque(srprog::smem_u32(vals + lane * St::kLaneWidth));
    cacc_a = srprog::opaque(srprog::smem_u32(cacc + lane));
  }
  const auto instance = [&](long long g) {
    const long long tree = a.order[g / a.reps];
    const long long inst = tree * a.reps + g % a.reps;
    const long long set = tree / a.per_set;
    const srprog::Storage* X = a.X + set * a.nfeat * a.nrows;
    const srprog::Storage* y = a.y ? a.y + set * a.nrows : nullptr;
    const SR_REAL* wn = a.wn ? a.wn + set * a.nrows : nullptr;
    const long long len = a.length[tree];
    int n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
    // the first 32 constants load while the program is derived
    const SR_REAL c0 =
        lane < n ? srprog::to_f32(a.cval[inst * a.L + lane]) : SR_LIT(0.);
    const bool invalid =
        srprog::derive_program(a.kind, a.op, a.feat, tree * a.L, n, a.cap,
                               a.nfeat, a.map, s_word, lane) || n != len;
    if (lane < n) s_cval[lane] = c0;
    for (int s = lane + 32; s < n; s += 32) {
      s_cval[s] = srprog::to_f32(a.cval[inst * a.L + s]);
    }
    __syncwarp();
    if (invalid) {
      n = 0;
    } else {  // s_last in the accumulators' place, zeroed below
      srprog::derive_adjoint_words(s_word, n, reinterpret_cast<int*>(cacc),
                                   lane);
    }

    SR_REAL acc = SR_LIT(0.);
    SR_REAL pz[kN] = {};
    for (int k = 0; k < a.cap; ++k) M::st1(cacc_a + SR_WARP_RB * k, SR_LIT(0.));
    for (int base = 0; n > 0 && base < a.nrows; base += 32 * kN) {
      // this pass's rows, the last row repeated past the end; X has fewer
      // than 2^31 elements, so a VAR step's offsets are 32-bit
      unsigned xrow[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        xrow[j] = min(base + j * 32 + lane, a.nrows - 1);
      }
      SR_REAL v[kN] = {};
      srprog::run_program<kAll, kN, true, kNarrow>(
          word_a, n, vals_a, v, pz,
          [&](int s, SR_REAL (&x)[kN]) {
            const SR_REAL c = srprog::SR_LDS(cval_a + SR_RB * s);
#pragma unroll
            for (int i = 0; i < kN; ++i) x[i] = c;
          },
          [&](int f, SR_REAL (&x)[kN]) {
            const unsigned xf = static_cast<unsigned>(f) * a.nrows;
#pragma unroll
            for (int j = 0; j < kN; ++j) {
              x[j] = srprog::to_f32(X[xf + xrow[j]]);
            }
          },
          [&](int s, const SR_REAL (&x)[kN]) {
            St::store(vals_a + s * kEntryBytes, x);
          });
      SR_REAL w[kN];
      unsigned real = 0;  // the rows of this pass that exist
      if constexpr (kCot) {
        const SR_REAL* cot = a.cot + inst * a.nrows;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int row = base + j * 32 + lane;
          w[j] = SR_LIT(0.);
          if (row < a.nrows) {
            real |= 1u << j;
            w[j] = cot[row];
            acc += w[j] * v[j];
          }
        }
      } else if constexpr (kAnyLoss) {
        srloss::with_loss(a.loss_fn.kind, [&](auto k) {
          constexpr int K = decltype(k)::value;
#pragma unroll
          for (int j = 0; j < kN; ++j) {
            const int row = base + j * 32 + lane;
            w[j] = SR_LIT(0.);
            if (row < a.nrows) {
              real |= 1u << j;
              const SR_REAL wr = wn[row];
              if (wr != SR_LIT(0.)) {
                const SR_REAL yr = srprog::to_f32(y[row]);
                acc += srloss::elem<K>(a.loss_fn, v[j], yr) * wr;
                w[j] = srloss::seed<K>(a.loss_fn, v[j], yr) * wr;
              }
            }
          }
        });
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int row = base + j * 32 + lane;
          w[j] = SR_LIT(0.);
          if (row < a.nrows) {
            real |= 1u << j;
            const SR_REAL wr = wn[row];
            const SR_REAL d = v[j] - srprog::to_f32(y[row]);
            if (wr != SR_LIT(0.)) {
              acc += (d * d) * wr;
              w[j] = (SR_LIT(2.) * d) * wr;
            }
          }
        }
      }
      srprog::run_adjoint<kAll, kN, kNarrow>(
          word_a, n, vals_a, w, [&](int rank, const SR_REAL (&ws)[kN]) {
            const Addr c = cacc_a + SR_WARP_RB * rank;
            SR_REAL sum = M::ld1(c);
#pragma unroll
            for (int j = 0; j < kN; ++j) {
              if (real >> j & 1u) sum += ws[j];
            }
            M::st1(c, sum);
          });
    }

    bool nonfinite = false;
#pragma unroll
    for (int i = 0; i < kN; ++i) nonfinite |= pz[i] != pz[i];
    const bool any_bad = __any_sync(0xffffffffu, nonfinite) || invalid;
    acc = warp_sum(acc);
    if (lane == 0) {
      a.loss[inst] = acc;
      a.bad[inst] = any_bad ? 1 : 0;
    }
    // the butterfly leaves every lane the same bits; lane s % 32 keeps slot s's
    for (int s0 = 0; s0 < a.L; s0 += 32) {
      const int s = s0 + lane;
      const int2 word = s < n ? s_word[s] : make_int2(0, 0);
      unsigned consts = __ballot_sync(0xffffffffu,
                                      srprog::word_code(word) == OP_CONST);
      SR_REAL gs = SR_LIT(0.);
      while (consts) {
        const int b = __ffs(consts) - 1;
        consts &= consts - 1;
        const int rank = __shfl_sync(0xffffffffu, srprog::word_feat(word), b);
        const SR_REAL t = warp_sum(M::ld1(cacc_a + SR_WARP_RB * rank));
        if (lane == b) gs = t;
      }
      if (s < a.L) a.grad[inst * a.L + s] = gs;
    }
  };
  if constexpr (kNarrow) {
    for (long long g = gw; g < total;
         g += static_cast<long long>(gridDim.x) * warps) {
      __syncwarp();  // the last instance's words and accumulators are read
      instance(g);
    }
  } else if (gw < total) {  // else the whole warp leaves
    instance(gw);
  }
}

using GradFn = void (*)(GradArgs);

// loss_mode: 0 L2, 1 any other loss, 2 the cotangent-seeded mode.
GradFn grad_kernel_for(bool all, bool narrow, int loss_mode) {
#define SR_PICK(N, NARROW, ANY, COT)                                     \
  (all ? &postfix_grad_kernel<true, N, NARROW, ANY, COT>                 \
       : &postfix_grad_kernel<false, N, NARROW, ANY, COT>)
#define SR_PICK_LOSS(N, NARROW)                                          \
  (loss_mode == 2   ? SR_PICK(N, NARROW, false, true)                    \
   : loss_mode == 1 ? SR_PICK(N, NARROW, true, false)                    \
                    : SR_PICK(N, NARROW, false, false))
  return narrow ? SR_PICK_LOSS(1, true) : SR_PICK_LOSS(kGradRows, false);
#undef SR_PICK_LOSS
#undef SR_PICK
}

long long grad_smem_bytes(int warps, int L) {
  return static_cast<long long>(SR_RB) * warps * grad_warp_floats(L, kGradRows);
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
  const srprog::Storage* cval;  // (T * reps, L)
  const srprog::Storage* X;
  const srprog::Storage* y;
  const SR_REAL* wn;
  SR_REAL* loss;
  int* bad;
  SR_REAL* scratch;  // the narrow route's stacks in global memory, or null
  // per_set: trees per dataset, as GradArgs'
  int T, per_set, reps, groups, L, nfeat, nrows, cap;
  OpMap map;
  srloss::Loss loss_fn;  // the kAnyLoss instantiations' loss
};

// One warp per (tree, group of kCand candidates); each lane carries kCand
// candidates x kRows rows (rows p * 32 kRows + j * 32 + lane of pass p).
// kNarrow: the narrow route (one candidate x one row), the stack in
// a.scratch or after the words and constants, the warps looping.
// kAnyLoss: a loss other than L2 (a.loss_fn).
template <bool kAll, int kCand, int kRows, bool kNarrow = false,
          bool kAnyLoss = false>
__global__ void __launch_bounds__(kLossMaxWarps * 32)
loss_kernel(const __grid_constant__ LossArgs a) {
  constexpr int kN = kCand * kRows;  // values per lane: [candidate][row]
  using St = srprog::Stack<kN, kNarrow>;
  extern __shared__ __align__(16) SR_REAL loss_smem[];
  SR_REAL* smem = loss_smem;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  SR_REAL* stack;
  int2* s_word;
  SR_REAL* s_cval;
  if constexpr (kNarrow) {
    s_word = reinterpret_cast<int2*>(smem) + warp * (a.L + 1);
    SR_REAL* cvals = reinterpret_cast<SR_REAL*>(reinterpret_cast<int2*>(smem) +
                                                warps * (a.L + 1));
    s_cval = cvals + warp * a.L * kCand;
    const long long per = static_cast<long long>(a.cap) * St::kEntry;
    stack = (a.scratch ? a.scratch + gw * per
                       : cvals + warps * a.L * kCand + warp * per) +
            lane * St::kLaneWidth;
  } else {
    stack = smem + warp * a.cap * St::kEntry + lane * St::kLaneWidth;
    s_word = reinterpret_cast<int2*>(smem + warps * a.cap * St::kEntry) +
             warp * (a.L + 1);
    s_cval = reinterpret_cast<SR_REAL*>(
                 reinterpret_cast<int2*>(smem + warps * a.cap * St::kEntry) +
                 warps * (a.L + 1)) +
             warp * a.L * kCand;  // [slot][candidate]
  }
  const long long total = static_cast<long long>(a.T) * a.groups;
  const auto group = [&](long long g) {
    const long long tree = a.order[g / a.groups];
    const long long inst0 = tree * a.reps + (g % a.groups) * kCand;
    const long long set = tree / a.per_set;
    const srprog::Storage* X = a.X + set * a.nfeat * a.nrows;
    const srprog::Storage* y = a.y + set * a.nrows;
    const SR_REAL* wn = a.wn + set * a.nrows;
    const long long len = a.length[tree];
    int n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
    const bool invalid =
        srprog::derive_program(a.kind, a.op, a.feat, tree * a.L, n, a.cap,
                               a.nfeat, a.map, s_word, lane) || n != len;
    for (int i = lane; i < n * kCand; i += 32) {
      const int s = i / kCand, c = i - s * kCand;
      s_cval[i] = srprog::to_f32(a.cval[(inst0 + c) * a.L + s]);
    }
    __syncwarp();
    if (invalid) n = 0;

    SR_REAL acc[kCand] = {};
    SR_REAL pz[kN] = {};
    const unsigned word_a = srprog::opaque(srprog::smem_u32(s_word));
    typename St::Addr stack_a;
    if constexpr (kNarrow) {
      stack_a = srprog::gen_u64(stack);
    } else {
      stack_a = srprog::opaque(srprog::smem_u32(stack));
    }
    const unsigned cval_a = srprog::opaque(srprog::smem_u32(s_cval));
    for (int base = 0; n > 0 && base < a.nrows; base += 32 * kRows) {
      SR_REAL v[kN] = {};
      srprog::run_program<kAll, kN, false, kNarrow>(
          word_a, n, stack_a, v, pz,
          [&](int s, SR_REAL (&x)[kN]) {
            SR_REAL cv[kCand];
#pragma unroll
            for (int c = 0; c < kCand; ++c) {
              cv[c] = srprog::SR_LDS(cval_a + SR_RB * (s * kCand + c));
            }
#pragma unroll
            for (int i = 0; i < kN; ++i) x[i] = cv[i / kRows];
          },
          [&](int f, SR_REAL (&x)[kN]) {
            const srprog::Storage* xf = X + f * a.nrows;
            SR_REAL xr[kRows];
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              xr[j] = srprog::to_f32(xf[min(base + j * 32 + lane, a.nrows - 1)]);
            }
#pragma unroll
            for (int i = 0; i < kN; ++i) x[i] = xr[i % kRows];
          },
          [](int, const SR_REAL (&)[kN]) {});
      if constexpr (kAnyLoss) {
        srloss::with_loss(a.loss_fn.kind, [&](auto k) {
          constexpr int K = decltype(k)::value;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int row = base + j * 32 + lane;
            if (row < a.nrows) {
              const SR_REAL yr = srprog::to_f32(y[row]);
              const SR_REAL wr = wn[row];
#pragma unroll
              for (int c = 0; c < kCand; ++c) {
                const SR_REAL p = v[c * kRows + j];
                if (wr != SR_LIT(0.)) acc[c] += srloss::elem<K>(a.loss_fn, p,
                                                                yr) * wr;
              }
            }
          }
        });
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int row = base + j * 32 + lane;
          if (row < a.nrows) {
            const SR_REAL yr = srprog::to_f32(y[row]);
            const SR_REAL wr = wn[row];
#pragma unroll
            for (int c = 0; c < kCand; ++c) {
              const SR_REAL d = v[c * kRows + j] - yr;
              if (wr != SR_LIT(0.)) acc[c] += (d * d) * wr;
            }
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
      const SR_REAL sum = warp_sum(acc[c]);
      if (lane == 0) {
        a.loss[inst0 + c] = sum;
        a.bad[inst0 + c] = any_bad ? 1 : 0;
      }
    }
  };
  if constexpr (kNarrow) {
    for (long long g = gw; g < total;
         g += static_cast<long long>(gridDim.x) * warps) {
      __syncwarp();  // the last tree's words are read
      group(g);
    }
  } else if (gw < total) {  // else the whole warp leaves; the block never syncs
    group(gw);
  }
}

// The two layouts: kCandidates candidates x kCandRows rows per lane (the
// line search), or one candidate x kSingleRows rows (any other reps); and
// the narrow route (one x one).
constexpr int kCandidates = 4;
constexpr int kCandRows = 2;
constexpr int kSingleRows = 4;

int loss_values_per_lane(int cand) {
  return cand == 1 ? kSingleRows : kCandidates * kCandRows;
}

using LossFn = void (*)(LossArgs);

LossFn loss_kernel_for(bool all, int cand, bool narrow, bool any_loss) {
#define SR_PICK(C, R, NARROW)                                            \
  (any_loss ? (all ? &loss_kernel<true, C, R, NARROW, true>              \
                   : &loss_kernel<false, C, R, NARROW, true>)            \
            : (all ? &loss_kernel<true, C, R, NARROW, false>             \
                   : &loss_kernel<false, C, R, NARROW, false>))
  if (narrow) return SR_PICK(1, 1, true);
  if (cand == 1) return SR_PICK(1, kSingleRows, false);
  return SR_PICK(kCandidates, kCandRows, false);
#undef SR_PICK
}

long long loss_smem_bytes(int warps, int L, int cand) {
  const long long cap = (L + 1) / 2;
#if SR_STORAGE == 3
  return 8LL * warps * (cap * 32 * loss_values_per_lane(cand) + 1LL * (L + 1) +
                       1LL * L * cand);
#else
  return 4LL * warps *
         (cap * 32 * loss_values_per_lane(cand) + 2LL * (L + 1) + 1LL * L * cand);
#endif
}

// The loss-only kernel's narrow stack per warp: one value per lane.
long long loss_narrow_stack_bytes(int L) {
  return static_cast<long long>(SR_RB) * 32 * ((L + 1) / 2);
}

// digamma_f elementwise: lets a test hold the hand-written digamma against
// torch.digamma on the card (no kernel of the search calls it)
__global__ void digamma_kernel(const SR_REAL* __restrict__ x,
                               SR_REAL* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = digamma_f(x[i]);
}

}  // namespace

extern "C" {

// The build's storage type (SR_STORAGE: 0 float, 1 bfloat16, 2 float16,
// 3 double), the type of X, y and cval.
int postfix_grad_storage() { return SR_STORAGE; }

// The launch layout of the gradient kernel for T trees x reps instances:
// plan[0] rows per lane, [1] warps per block, [2] resident blocks per SM,
// [3] shared memory per block in bytes, [4] blocks, [5] 1 for the narrow
// route, [6] bytes of global memory for its slot values (0 when they are in
// shared memory). The warps per block are those that keep the most warps
// resident; the narrow route where one warp of kGradRows rows per lane does
// not fit. any_loss: the instantiation for a loss other than L2 (1) or the
// cotangent-seeded mode (2).
int postfix_grad_plan(int T, int reps, int L, int all_ops, int any_loss,
                      long long* plan) {
  if (T < 0 || reps <= 0 || L <= 0 || L >= (1 << 24) || any_loss < 0 ||
      any_loss > 2) {
    return cudaErrorInvalidValue;
  }
  if (grad_smem_bytes(1, L) > kMaxSmemBytes) {
    srprog::NarrowPlan np;
    const cudaError_t err = srprog::narrow_plan(
        grad_kernel_for(all_ops != 0, true, any_loss),
        static_cast<long long>(T) * reps,
        grad_narrow_fixed_bytes(L), grad_narrow_scratch_bytes(L),
        kGradMaxWarps, kMaxSmemBytes, &np);
    if (err != cudaSuccess) return err;
    const long long p[7] = {1, np.warps, np.blocks_per_sm, np.smem, np.blocks,
                            1, np.scratch_bytes};
    for (int i = 0; i < 7; ++i) plan[i] = p[i];
    return cudaSuccess;
  }
  const GradFn fn = grad_kernel_for(all_ops != 0, false, any_loss);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  int best_warps = 0, best_occ = 0;
  for (int warps = kGradMaxWarps; warps >= 1; warps >>= 1) {
    const long long smem = grad_smem_bytes(warps, L);
    if (smem > kMaxSmemBytes) continue;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, fn, warps * 32, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (occ * warps > best_occ * best_warps) {
      best_warps = warps;
      best_occ = occ;
    }
  }
  if (best_warps == 0) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(T) * reps;
  const long long p[7] = {kGradRows, best_warps, best_occ,
                          grad_smem_bytes(best_warps, L),
                          (items + best_warps - 1) / best_warps, 0, 0};
  for (int i = 0; i < 7; ++i) plan[i] = p[i];
  return cudaSuccess;
}

// The gradient kernel (B3): reps instances per tree (cval rows t * reps
// ...) of the TreeBatch fields kind / op / feat / length, trees in the
// order `order`; opmap as postfix_eval_launch's; plan from postfix_grad_plan
// for the same arguments, and for the narrow route with its slot values in
// global memory, `scratch` of plan[6] bytes. all_ops: the batch uses an
// operator outside the common set, so the instantiation with every operator
// runs (operators.cuh). loss_kind, c0-c2: the loss (csrc/losses.cuh; ops/
// losses.py ElementwiseLoss.kind / constants); the plan's any_loss is
// loss_kind != L2, 2 for kCotangent, whose y is the seeds (T * reps, nrows)
// of the compute type and wn is not read. X, y and cval are of the build's
// storage type
// (postfix_grad_storage); wn, loss and grad are float. per_set: trees per
// dataset, X being (T / per_set, nfeat, nrows) and y and wn (T / per_set,
// nrows) (per_set = T: one X); the cotangent seeds stay per instance.
cudaError_t postfix_grad_launch(const void* kind, const void* op,
                                const void* feat, const void* length,
                                const void* order, const void* cval,
                                const void* X, const void* y, const void* wn,
                                void* loss, void* grad, void* bad,
                                void* scratch, const int* opmap, int n_unary,
                                int n_binary, int T, int per_set, int reps,
                                int L,
                                int nfeat, int nrows, int all_ops,
                                int loss_kind, SR_REAL c0, SR_REAL c1,
                                SR_REAL c2, const long long* plan,
                                void* stream) {
  if (T <= 0) return cudaSuccess;
  const bool narrow = plan[5] != 0;
  const long long smem =
      narrow ? plan[1] * (grad_narrow_fixed_bytes(L) +
                          (plan[6] ? 0 : grad_narrow_scratch_bytes(L)))
             : grad_smem_bytes(static_cast<int>(plan[1]), L);
  if (n_unary + n_binary > srprog::kMaxOps || reps <= 0 || L <= 0 ||
      per_set < 1 || T % per_set != 0 || loss_kind < 0 ||
      (loss_kind >= SR_LOSS_KINDS && loss_kind != kCotangent) ||
      L >= (1 << 24) || plan[0] != (narrow ? 1 : kGradRows) ||
      plan[1] < 1 || plan[1] > kGradMaxWarps || plan[3] != smem ||
      plan[3] > kMaxSmemBytes || (plan[6] != 0) != (scratch != nullptr) ||
      plan[4] < 1 ||
      (!plan[6] && plan[4] * plan[1] < static_cast<long long>(T) * reps)) {
    return cudaErrorInvalidValue;
  }
  GradArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.length = static_cast<const long long*>(length);
  a.order = static_cast<const long long*>(order);
  a.cval = static_cast<const srprog::Storage*>(cval);
  a.X = static_cast<const srprog::Storage*>(X);
  a.y = static_cast<const srprog::Storage*>(y);
  a.wn = static_cast<const SR_REAL*>(wn);
  a.loss = static_cast<SR_REAL*>(loss);
  a.grad = static_cast<SR_REAL*>(grad);
  a.bad = static_cast<int*>(bad);
  a.scratch = static_cast<SR_REAL*>(scratch);
  a.T = T;
  a.per_set = per_set;
  a.reps = reps;
  a.L = L;
  a.nfeat = nfeat;
  a.nrows = nrows;
  a.cap = (L + 1) / 2;
  a.map = srprog::make_op_map(opmap, n_unary, n_binary);
  a.loss_fn = srloss::Loss{loss_kind, c0, c1, c2};
  const bool cotangent = loss_kind == kCotangent;
  a.cot = cotangent ? static_cast<const SR_REAL*>(y) : nullptr;
  if (cotangent) a.y = nullptr;
  const GradFn fn = grad_kernel_for(
      all_ops != 0, narrow, cotangent ? 2 : (loss_kind != srloss::kL2 ? 1 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<static_cast<unsigned>(plan[4]), static_cast<unsigned>(plan[1]) * 32,
       static_cast<size_t>(plan[3]), static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Candidates per lane of the loss-only kernel's line-search layout.
int postfix_loss_candidates() { return kCandidates; }

// The launch layout of the loss-only kernel for reps candidates per tree,
// cand of them per lane (postfix_loss_candidates(), which must divide
// reps, or 1; 1 where one warp's stack would not fit): plan[0] warps
// (candidate groups) per tree, [1] candidates
// per lane, [2] rows per lane, [3] warps per block, [4] resident blocks per
// SM, [5] shared memory per block in bytes, [6] blocks, [7] 1 for the
// narrow route (one candidate x one row, where one candidate x kSingleRows
// does not fit either), [8] bytes of global memory for its stacks (0 when
// they are in shared memory). any_loss: the instantiation for a loss other
// than L2.
int postfix_loss_plan(int T, int reps, int cand, int L, int all_ops,
                      int any_loss, long long* plan) {
  if (T < 0 || reps <= 0 || L <= 0 || L >= (1 << 24) ||
      !(cand == 1 || (cand == kCandidates && reps % cand == 0))) {
    return cudaErrorInvalidValue;
  }
  // the line-search layout's stack holds kCandidates x kCandRows values
  // per lane: above max_len ~440 one warp's does not fit, one candidate
  // per lane does (the same sums in the same order)
  if (loss_smem_bytes(1, L, cand) > kMaxSmemBytes) cand = 1;
  if (loss_smem_bytes(1, L, 1) > kMaxSmemBytes) {
    srprog::NarrowPlan np;
    const cudaError_t err = srprog::narrow_plan(
        loss_kernel_for(all_ops != 0, 1, true, any_loss != 0),
        static_cast<long long>(T) * reps,
        grad_narrow_fixed_bytes(L), loss_narrow_stack_bytes(L), kLossMaxWarps,
        kMaxSmemBytes, &np);
    if (err != cudaSuccess) return err;
    const long long p[9] = {reps, 1, 1, np.warps, np.blocks_per_sm, np.smem,
                            np.blocks, 1, np.scratch_bytes};
    for (int i = 0; i < 9; ++i) plan[i] = p[i];
    return cudaSuccess;
  }
  int warps = kLossMaxWarps;
  while (warps > 1 && loss_smem_bytes(warps, L, cand) > kMaxSmemBytes) {
    warps >>= 1;
  }
  const int smem = static_cast<int>(loss_smem_bytes(warps, L, cand));
  const LossFn fn = loss_kernel_for(all_ops != 0, cand, false, any_loss != 0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, warps * 32,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(T) * (reps / cand);
  const long long p[9] = {reps / cand, cand,
                          cand == 1 ? kSingleRows : kCandRows, warps, occ,
                          smem, (items + warps - 1) / warps, 0, 0};
  for (int i = 0; i < 9; ++i) plan[i] = p[i];
  return cudaSuccess;
}

// The loss-only kernel (B4): reps candidate constant vectors (cval rows
// t * reps ...) per tree of the TreeBatch fields kind / op / feat / length,
// trees in the order `order`, cand per lane; opmap as postfix_eval_launch's;
// plan from postfix_loss_plan for the same arguments, and for the narrow
// route with its stacks in global memory, `scratch` of plan[8] bytes;
// loss_kind, c0-c2 and per_set as postfix_grad_launch's.
cudaError_t postfix_loss_launch(const void* kind, const void* op,
                                const void* feat, const void* length,
                                const void* order, const void* cval,
                                const void* X, const void* y, const void* wn,
                                void* loss, void* bad, void* scratch,
                                const int* opmap, int n_unary, int n_binary,
                                int T, int per_set, int reps, int cand, int L,
                                int nfeat,
                                int nrows, int all_ops, int loss_kind,
                                SR_REAL c0, SR_REAL c1, SR_REAL c2,
                                const long long* plan, void* stream) {
  if (T <= 0) return cudaSuccess;
  const bool narrow = plan[7] != 0;
  const long long smem =
      narrow ? plan[3] * (grad_narrow_fixed_bytes(L) +
                          (plan[8] ? 0 : loss_narrow_stack_bytes(L)))
             : loss_smem_bytes(static_cast<int>(plan[3]), L, cand);
  if (n_unary + n_binary > srprog::kMaxOps || plan[1] != cand ||
      per_set < 1 || T % per_set != 0 ||
      loss_kind < 0 || loss_kind >= SR_LOSS_KINDS ||
      plan[0] * cand != reps || L <= 0 || L >= (1 << 24) || plan[3] < 1 ||
      plan[3] > kLossMaxWarps || plan[5] != smem || smem > kMaxSmemBytes ||
      (narrow && cand != 1) || (plan[8] != 0) != (scratch != nullptr) ||
      plan[6] < 1 ||
      (!plan[8] && plan[6] * plan[3] < static_cast<long long>(T) * plan[0])) {
    return cudaErrorInvalidValue;
  }
  LossArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.length = static_cast<const long long*>(length);
  a.order = static_cast<const long long*>(order);
  a.cval = static_cast<const srprog::Storage*>(cval);
  a.X = static_cast<const srprog::Storage*>(X);
  a.y = static_cast<const srprog::Storage*>(y);
  a.wn = static_cast<const SR_REAL*>(wn);
  a.loss = static_cast<SR_REAL*>(loss);
  a.bad = static_cast<int*>(bad);
  a.scratch = static_cast<SR_REAL*>(scratch);
  a.T = T;
  a.per_set = per_set;
  a.reps = reps;
  a.groups = static_cast<int>(plan[0]);
  a.L = L;
  a.nfeat = nfeat;
  a.nrows = nrows;
  a.cap = (L + 1) / 2;
  a.map = srprog::make_op_map(opmap, n_unary, n_binary);
  a.loss_fn = srloss::Loss{loss_kind, c0, c1, c2};
  const LossFn fn =
      loss_kernel_for(all_ops != 0, cand, narrow, loss_kind != srloss::kL2);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<static_cast<unsigned>(plan[6]), static_cast<unsigned>(plan[3]) * 32,
       static_cast<size_t>(plan[5]), static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

cudaError_t postfix_grad_digamma(const void* x, void* out, int n,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  digamma_kernel<<<(n + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const SR_REAL*>(x), static_cast<SR_REAL*>(out), n);
  return cudaGetLastError();
}

const char* postfix_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
