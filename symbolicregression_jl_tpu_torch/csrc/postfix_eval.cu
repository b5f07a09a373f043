// Postfix-program scoring kernel for Hopper (sm_90a): value mode and
// fused-loss mode; and the constant-fold kernel (below).
//
// Replaces the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_eval.py
// `_make_kernel` / `_postfix_call` (through `eval_trees_pallas` and
// `eval_loss_trees_pallas`): for each of T postfix programs over X
// (nfeat, nrows) f32, run the program's slots up to its own length on every
// row; a non-finite value at a slot that is not PAD poisons the tree.
//   mode 0 (value): out[t, row] = root value            -> (T, nrows) f32
//   mode 1 (fused): out[t] = sum_rows loss(root, y[row])  -> (T,) f32, for
//                   any elementwise loss of the registry (csrc/losses.cuh)
// Several datasets of one shape in one launch (tenant-batched serving, per-
// island minibatches): X (S, nfeat, nrows) and y (S, nrows), the trees
// set-major, tree t reading set t / per_set; S = 1 (per_set = T) is the
// single-dataset call. Each set's trees get the layout (row ranges, rows
// per lane) that a launch on that set alone gets, so a tree sums its rows
// in the same order whatever S is.
// In both modes bad[t] = 1 when the tree was poisoned. The trees are the
// TreeBatch fields as they are (kind, op, feat int64; cval f32; length
// int64); a tree that is not a valid postfix program counts as poisoned.
// The bfloat16 and float16 builds (SR_STORAGE, csrc/postfix_program.cuh)
// are the kernel's compute_dtype="bfloat16" variant (`_make_kernel` with
// cdt bf16, pallas_eval.py:497-500 and :578-582), float16 the same rule
// for the reference's jnp interpreter at float16: X, cval and the value
// output in the storage type, each slot's value computed in f32
// and rounded to the storage type where it is produced, poison judged on
// the rounded value. They carry mode 0 only (the reference fuses
// the loss at float32 alone, fitness.py:331-335). X is staged in shared
// memory as float (converted on the way in, so a 2-byte X of any row
// count needs no alignment rule), and the outputs take half the bytes.
// The float64 build (SR_STORAGE 3) computes and stores in double (the
// reference runs float64 on its jnp interpreter, which no Pallas kernel
// replaces): mode 0, every value, stack entry and staged X 8 bytes,
// so each layout holds half the values per byte (postfix_eval_smem_bytes).
//
// What bounds it on this card: neither HBM bytes nor f32 peak but the
// instructions issued per (tree, row, slot) step: the opcode read, the
// dispatch, operand reads and writes, the finiteness test and X indexing
// (about 60 per row-step with one row per lane and every slot's value in
// shared memory, PERF.md), and at the cycle's 5,376 trees, filling the
// card: one warp per tree is a single partial wave.
//
// What this design does about it:
//  * The program is the stack machine of csrc/postfix_program.cuh, derived
//    in the prologue from the TreeBatch fields (no host tables): the top of
//    the stack stays in registers, each lane carries kRows rows through a
//    slot, so one opcode read, one dispatch and one address serve kRows
//    rows, and kRows operator evaluations are independent work.
//  * Work item = (tree, row range). The wrapper's plan splits each tree's
//    rows into `items` ranges so that a batch gives several waves of
//    blocks, and orders trees longest first, so the tail is short
//    trees. A block's warps take consecutive trees over one row range, and
//    the block stages that range of X in shared memory once with cp.async;
//    every VAR step reads it there with 32-bit offsets (X too large for
//    shared memory is read from global memory instead). With several
//    sets, the order is longest first within each set and each set's
//    trees fill whole blocks (its last block's surplus warps idle), so a
//    block never holds trees of two sets and stages one set's X.
//  * The fused loss: each lane sums its rows in order, a fixed butterfly of
//    shuffles sums the lanes, and with several ranges a second pass adds
//    each tree's partial sums in range order, so the loss is the same bits
//    on every run (no atomics). Poison flags combine the same way. L2 has
//    its own instantiation, (root - y)^2 inline as before; every other
//    loss runs the kAnyLoss instantiation, whose epilogue switches on the
//    loss id (a kernel argument, uniform over the warp) after the
//    program's last slot, so the slot loop is the same code. Its rows
//    are summed in the same order, so ops/kernel_eval.py
//    eval_loss_trees_program_plain gives its bits.
//  * Long programs: a stack of (L + 1) / 2 entries of kRows values per lane
//    leaves no room for a warp above max_len ~900. There the plan takes the
//    narrow route, postfix_narrow_kernel: one row per lane, one range per
//    tree, X read from global memory, and the stack in shared memory when
//    one warp's fits, else in global memory, one region per resident warp
//    (srprog::narrow_plan), the warps looping over the trees.
// The operators are the shared library csrc/operators.cuh; built without
// --use_fast_math.

#include <cuda_runtime.h>

#include "losses.cuh"
#include "postfix_program.cuh"

namespace {

using namespace srprog;

constexpr int kRows = 4;  // rows per lane per pass
constexpr int kMaxWarps = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use

struct EvalArgs {
  const long long* kind;
  const long long* op;
  const long long* feat;
  const Storage* cval;
  const long long* length;
  const long long* order;
  const Storage* X;
  const SR_REAL* y;   // the fused mode's (float build only)
  Storage* out;
  int* bad;
  // (T, items) partial losses; the fused mode's out when items == 1
  SR_REAL* part;
  int* part_bad;  // (T, items) partial poison flags; bad when items == 1
  SR_REAL* scratch;  // the narrow route's stacks in global memory, or null
  // per_set: trees per dataset (T for one X); set_groups: blocks of warps
  // per set and row range, ceil(per_set / warps)
  int T, L, nfeat, nrows, items, range, cap, per_set, set_groups;
  OpMap map;
  srloss::Loss loss_fn;  // the fused mode's loss (the kAnyLoss instantiations)
};

template <int kMode, bool kAll, bool kStaged, bool kAnyLoss = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
postfix_kernel(const __grid_constant__ EvalArgs a) {
  constexpr int kR = kRows;
  extern __shared__ __align__(16) SR_REAL smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x % a.items;  // row range
  const int row0 = r * a.range;
  const int rows = min(a.range, a.nrows - row0);
  // this block's dataset and its trees' places in the set's order
  const int gb = blockIdx.x / a.items;
  const int set = gb / a.set_groups;
  const int g = (gb - set * a.set_groups) * warps + warp;
  const long long set_base = static_cast<long long>(set) * a.per_set;
  const Storage* X = a.X + static_cast<long long>(set) * a.nfeat * a.nrows;
  const SR_REAL* y = kMode == 1 ? a.y + static_cast<long long>(set) * a.nrows
                                : nullptr;
  SR_REAL* stack = smem + warp * a.cap * Stack<kR>::kEntry +
                 lane * Stack<kR>::kLaneWidth;
  SR_REAL* xs = smem + warps * a.cap * Stack<kR>::kEntry;
  int2* words = reinterpret_cast<int2*>(xs + (kStaged ? a.nfeat * a.range : 0));
  int2* s_word = words + warp * (a.L + 1);
  SR_REAL* s_cval = reinterpret_cast<SR_REAL*>(words + warps * (a.L + 1)) +
                  warp * a.L;

  if constexpr (kStaged) {
    // X[:, row0 : row0 + range]; rows past the end repeat the last row, so
    // a lane's surplus rows compute copies of a real row
    for (int i = threadIdx.x; i < a.nfeat * a.range; i += blockDim.x) {
      const int f = i / a.range;
      const int row = min(row0 + i - f * a.range, a.nrows - 1);
      stage_x(xs + i, X + f * a.nrows + row);
    }
  }
  const bool active = g < a.per_set;
  long long t = 0;
  int n = 0;
  bool invalid = false;
  if (active) {
    t = a.order[set_base + g];
    const long long len = a.length[t];
    n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
    // the first 32 constants load while the program is derived
    const SR_REAL c0 = lane < n ? to_f32(a.cval[t * a.L + lane]) : SR_LIT(0.);
    invalid = derive_program(a.kind, a.op, a.feat, t * a.L, n, a.cap, a.nfeat,
                             a.map, s_word, lane) || n != len;
    if (lane < n) s_cval[lane] = c0;
    for (int s = lane + 32; s < n; s += 32) {
      s_cval[s] = to_f32(a.cval[t * a.L + s]);
    }
  }
  if constexpr (kStaged) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the block's only barrier
  }
  if (!active) return;
  __syncwarp();
  if (invalid) n = 0;

  SR_REAL acc = SR_LIT(0.);
  SR_REAL pz[kR] = {};
  const unsigned word_a = opaque(smem_u32(s_word));
  const unsigned stack_a = opaque(smem_u32(stack));
  const unsigned cval_a = opaque(smem_u32(s_cval));
  const unsigned x_lane = opaque(smem_u32(xs + lane * kR));
  const unsigned range_b = opaque(SR_RB * a.range);
  for (int base = 0; base < rows; base += (32 * kR)) {
    const int lr = base + lane * kR;  // local row of this lane's first row
    const unsigned x_a = x_lane + SR_RB * base;
    SR_REAL v[kR] = {};
    run_program<kAll, kR>(
        word_a, n, stack_a, v, pz,
        [&](int s, SR_REAL (&x)[kR]) {
          const SR_REAL c = SR_LDS(cval_a + SR_RB * s);
#pragma unroll
          for (int i = 0; i < kR; ++i) x[i] = c;
        },
        [&](int f, SR_REAL (&x)[kR]) {
          if constexpr (kStaged) {
            Stack<kR>::load(x_a + f * range_b, x);
          } else {
            const Storage* xf = X + f * a.nrows;
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              x[i] = to_f32(xf[min(row0 + lr + i, a.nrows - 1)]);
            }
          }
        },
        [](int, const SR_REAL (&)[kR]) {});
    if constexpr (kMode == 0) {
      // aligned: every row of the pass is real
      store_rows<kR>(a.out + t * a.nrows + row0 + lr, v,
                     a.nrows % kR == 0 && row0 + lr < a.nrows,
                     a.nrows - (row0 + lr));
    } else if constexpr (kMode == 1 && kAnyLoss) {
      srloss::with_loss(a.loss_fn.kind, [&](auto k) {
        constexpr int K = decltype(k)::value;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const int row = row0 + lr + i;
          if (row < a.nrows) acc += srloss::elem<K>(a.loss_fn, v[i], y[row]);
        }
      });
    } else if constexpr (kMode == 1) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = row0 + lr + i;
        if (row < a.nrows) {
          const SR_REAL d = v[i] - y[row];
          acc += d * d;
        }
      }
    }
  }
  bool nonfinite = false;
#pragma unroll
  for (int i = 0; i < kR; ++i) nonfinite |= pz[i] != pz[i];
  const bool any_bad = __any_sync(0xffffffffu, nonfinite) || invalid;
  if constexpr (kMode == 1) {
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
  }
  if (lane == 0) {
    const long long p = t * a.items + r;
    if constexpr (kMode == 1) a.part[p] = acc;
    a.part_bad[p] = any_bad ? 1 : 0;
  }
}

// The narrow route (long programs): one row per lane, each tree's rows in
// one range, X from global memory; the stack at a.scratch (one region of
// (L + 1) / 2 entries per resident warp) or, with a.scratch null, in shared
// memory after the words and constants. The warps loop over the trees.
template <int kMode, bool kAll, bool kAnyLoss = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
postfix_narrow_kernel(const __grid_constant__ EvalArgs a) {
  using St = Stack<1, true>;
  extern __shared__ __align__(16) SR_REAL smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int2* s_word = reinterpret_cast<int2*>(smem) + warp * (a.L + 1);
  SR_REAL* s_cval = reinterpret_cast<SR_REAL*>(reinterpret_cast<int2*>(smem) +
                                                warps * (a.L + 1));
  SR_REAL* stacks = s_cval + warps * a.L;
  s_cval += warp * a.L;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  SR_REAL* stack = a.scratch ? a.scratch + gw * a.cap * St::kEntry
                           : stacks + warp * a.cap * St::kEntry;
  const unsigned word_a = opaque(smem_u32(s_word));
  const unsigned cval_a = opaque(smem_u32(s_cval));
  const unsigned long long stack_a = gen_u64(stack + lane);
  for (long long g = gw; g < a.T; g += static_cast<long long>(gridDim.x) * warps) {
    const long long t = a.order[g];
    const long long set = t / a.per_set;
    const Storage* X = a.X + set * a.nfeat * a.nrows;
    const SR_REAL* y = kMode == 1 ? a.y + set * a.nrows : nullptr;
    const long long len = a.length[t];
    int n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
    __syncwarp();  // the last tree's words are read
    const SR_REAL c0 = lane < n ? to_f32(a.cval[t * a.L + lane]) : SR_LIT(0.);
    const bool invalid = derive_program(a.kind, a.op, a.feat, t * a.L, n,
                                        a.cap, a.nfeat, a.map, s_word, lane) ||
                         n != len;
    if (lane < n) s_cval[lane] = c0;
    for (int s = lane + 32; s < n; s += 32) {
      s_cval[s] = to_f32(a.cval[t * a.L + s]);
    }
    __syncwarp();
    if (invalid) n = 0;
    SR_REAL acc = SR_LIT(0.);
    SR_REAL pz[1] = {};
    for (int base = 0; base < a.nrows; base += 32) {
      const int row = base + lane;
      const unsigned xr = min(row, a.nrows - 1);
      SR_REAL v[1] = {};
      run_program<kAll, 1, false, true>(
          word_a, n, stack_a, v, pz,
          [&](int s, SR_REAL (&x)[1]) { x[0] = SR_LDS(cval_a + SR_RB * s); },
          [&](int f, SR_REAL (&x)[1]) {
            x[0] = to_f32(X[static_cast<unsigned>(f) * a.nrows + xr]);
          },
          [](int, const SR_REAL (&)[1]) {});
      if constexpr (kMode == 0) {
        if (row < a.nrows) a.out[t * a.nrows + row] = from_f32(v[0]);
      } else if constexpr (kMode == 1 && kAnyLoss) {
        if (row < a.nrows) {
          srloss::with_loss(a.loss_fn.kind, [&](auto k) {
            constexpr int K = decltype(k)::value;
            acc += srloss::elem<K>(a.loss_fn, v[0], y[row]);
          });
        }
      } else if constexpr (kMode == 1) {
        if (row < a.nrows) {
          const SR_REAL d = v[0] - y[row];
          acc += d * d;
        }
      }
    }
    const bool any_bad = __any_sync(0xffffffffu, pz[0] != pz[0]) || invalid;
    if constexpr (kMode == 1) {
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
    }
    if (lane == 0) {
      if constexpr (kMode == 1) a.part[t] = acc;
      a.bad[t] = any_bad ? 1 : 0;
    }
  }
}

// Each tree's partial sums and flags, in range order.
__global__ void combine_kernel(const SR_REAL* __restrict__ part,
                               const int* __restrict__ part_bad,
                               SR_REAL* __restrict__ out, int* __restrict__ bad,
                               int T, int items, int mode) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  SR_REAL sum = SR_LIT(0.);
  int b = 0;
  for (int r = 0; r < items; ++r) {
    if (mode == 1) sum += part[static_cast<long long>(t) * items + r];
    b |= part_bad[static_cast<long long>(t) * items + r];
  }
  if (mode == 1) out[t] = sum;
  bad[t] = b;
}

using KernelFn = void (*)(EvalArgs);

// any_loss: the fused mode under a loss other than L2. The 2-byte builds
// have no fused mode: null.
KernelFn narrow_kernel_for(int mode, bool all, bool any_loss) {
  if (mode == 0) {
    return all ? &postfix_narrow_kernel<0, true> : &postfix_narrow_kernel<0, false>;
  }
#if SR_STORAGE == 0
  if (mode == 1 && any_loss) {
    return all ? &postfix_narrow_kernel<1, true, true>
               : &postfix_narrow_kernel<1, false, true>;
  }
  if (mode == 1) {
    return all ? &postfix_narrow_kernel<1, true> : &postfix_narrow_kernel<1, false>;
  }
#endif
  return nullptr;
}

// Shared memory per warp of the narrow route: the words and constants,
// and the stack ((L + 1) / 2 entries of one float per lane).
#if SR_STORAGE == 3
// (the float64 build: 8 bytes per value and per word)
long long narrow_fixed_bytes(int L) { return 8LL * (2LL * L + 1); }
long long narrow_stack_bytes(int L) { return 8LL * 32 * ((L + 1) / 2); }
#else
long long narrow_fixed_bytes(int L) { return 4LL * (3LL * L + 2); }
long long narrow_stack_bytes(int L) { return 4LL * 32 * ((L + 1) / 2); }
#endif

KernelFn kernel_for(int mode, bool all, bool staged, bool any_loss) {
#define SR_PICK(M, ANY)                                                      \
  (all ? (staged ? &postfix_kernel<M, true, true, ANY>                       \
                 : &postfix_kernel<M, true, false, ANY>)                     \
       : (staged ? &postfix_kernel<M, false, true, ANY>                      \
                 : &postfix_kernel<M, false, false, ANY>))
  if (mode == 0) return SR_PICK(0, false);
#if SR_STORAGE == 0
  if (mode == 1) return any_loss ? SR_PICK(1, true) : SR_PICK(1, false);
#endif
#undef SR_PICK
  return nullptr;
}

// ---------------------------------------------------------------------------
// The constant-fold kernel
// ---------------------------------------------------------------------------
//
// Replaces the reference's constant fold, symbolicregression_jl_tpu/models/
// mutate_device.py `_const_fold_scan` (:469, a lax.scan over the slots,
// vmapped over trees) with `simplify_tree` (:530-582): for a flat (T, L)
// batch of TreeBatch fields, fold every maximal constant subtree into one
// CONST leaf (op 0, feat 0, the subtree's value) and compact the survivors
// in postfix order, PAD after the new length; changed[t] = new length <
// length, and an unchanged tree is written back as it was, every slot of it.
// A node is constant when it is a leaf other than VAR (CONST, or PAD inside
// the length, which reads 0) whose value is finite, or an operator whose
// children are all constant and whose value is finite. Its value comes from
// the operator bodies of csrc/operators.cuh (and the generated user header),
// rounded to the storage type where it is produced, as the scoring kernel's
// stack machine computes it. A program that is not a valid postfix program
// (derive_program's rules, features unchecked: the fold reads none) is left
// as it is. The same kernel gives the slot-values output of
// ops/kernel_eval.py eval_slot_values (kSlots): every slot's value on the one
// row of X (nfeat, 1), 0 past the length, bad[t] = 1 when a slot that is not
// PAD is not finite or the program is invalid (then every value is 0).
//
// What bounds it on this card: bytes, the fields read once and written once
// (24 B of int64 kind / op / feat and the constant per slot each way); the
// work per slot is a few instructions and at most one operator.
//
// What this design does about it:
//  * One thread per tree walks its slots once, in order. Each stack entry's
//    subtree has already been written to the tree's output: a constant one
//    as one CONST slot, so a node whose children are all constant finds them
//    in the last `arity` output slots and replaces them by itself, and a
//    child is a fold root exactly when its parent does not take it in. No
//    parent array, no (L, L) mask and no second sweep: the output map (a
//    source slot, or kFold with the value) doubles as the value stack, and
//    it is written in place over the slots already read.
//  * A block takes kFoldTrees consecutive trees (one warp walks them): their
//    fields are one contiguous span of memory, staged through an arena
//    [slot][tree] (row stride kFoldTrees + 1, so a warp's 32 consecutive
//    elements and a walk step's 32 trees each fall in 32 banks) with
//    coalesced loads, and written back from it with coalesced stores, by
//    all kFoldThreads threads: a thread issues its loads one loop step at
//    a time, so the block's threads are what keeps loads in flight (one
//    warp a block was slower at 5,376 and 64,000 trees, PERF.md).
//  * The arena is in shared memory while it fits in a block (max_len up to
//    879 at 4-byte values, 586 at float64); above that each block's arena
//    lies in global memory (kGlobal), the blocks looping over the tiles.
//  * No sort, no warp-cooperative prologue, no launch plan beyond the grid.
constexpr int kFoldTrees = 32;              // trees per block (one warp)
constexpr int kFoldThreads = 256;           // threads per block
constexpr int kFoldLd = kFoldTrees + 1;     // the arena's row stride
constexpr int kFold = -1;                   // output map: a folded constant
constexpr int kBadCode = 0xff;              // staged code of an invalid slot

struct FoldArgs {
  const long long* kind;
  const long long* op;
  const long long* feat;
  const Storage* cval;
  const long long* length;
  const Storage* X;  // kSlots: (nfeat, 1)
  long long* kind_o;
  long long* op_o;
  long long* feat_o;
  Storage* cval_o;
  long long* length_o;
  unsigned char* changed;
  Storage* vals;  // kSlots: (T, L)
  int* bad;       // kSlots: (T,)
  unsigned char* scratch;  // kGlobal: one arena per block
  long long arena_bytes;
  int T, L, nfeat;
  OpMap map;
};

// Bytes of one slot row of the arena: kFoldLd values and kFoldLd ints.
constexpr int fold_slot_bytes() {
  return kFoldLd * static_cast<int>(sizeof(SR_REAL) + sizeof(int));
}

// The value of operator slot c (a dense code) on the left operand l (binary
// only) and the right operand or only child r; NaN for a code outside the
// instantiation, as in run_program.
template <bool kAll>
__device__ __forceinline__ SR_REAL fold_apply(int c, SR_REAL l, SR_REAL r) {
#define SR_UNARY_FOLD(OPC) \
  case dense_code(OPC):    \
    return apply_unary<kAll>(OPC, r);
#define SR_BINARY_FOLD(OPC) \
  case dense_code(OPC):     \
    return apply_binary<kAll>(OPC, l, r);
  switch (c) {
    SR_UNARY_COMMON(SR_UNARY_FOLD)
    SR_BINARY_COMMON(SR_BINARY_FOLD)
    default:
      break;
  }
  if constexpr (kAll) {
    switch (c) {
      SR_UNARY_OTHER(SR_UNARY_FOLD)
      SR_BINARY_OTHER(SR_BINARY_FOLD)
      default:
        break;
    }
  }
#undef SR_UNARY_FOLD
#undef SR_BINARY_FOLD
  return nanf_();
}

template <bool kSlots, bool kAll, bool kGlobal>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const __grid_constant__ FoldArgs a) {
  extern __shared__ __align__(16) unsigned char fold_smem[];
  __shared__ int s_len[kFoldTrees];  // length, or -1 outside 0..L
  __shared__ int s_new[kFoldTrees];  // new length, or -1: written as it was
  const int L = a.L;
  const int cap = (L + 1) / 2;
  const int r = threadIdx.x;
  unsigned char* arena =
      kGlobal ? a.scratch + blockIdx.x * a.arena_bytes : fold_smem;
  SR_REAL* V = reinterpret_cast<SR_REAL*>(arena);
  int* A = reinterpret_cast<int*>(arena + sizeof(SR_REAL) *
                                              static_cast<long long>(L) * kFoldLd);
  constexpr int kFirstBinary = dense_code(OP_ADD);
  const int n_binary = a.map.n_ops - a.map.n_unary;
  const int tiles = (a.T + kFoldTrees - 1) / kFoldTrees;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long t0 = static_cast<long long>(tile) * kFoldTrees;
    const int nt = static_cast<int>(min(static_cast<long long>(kFoldTrees),
                                        a.T - t0));
    const long long base = t0 * L;  // the tile's first element
    if (r < kFoldTrees) {
      int n = -1;
      if (r < nt) {
        const long long len = a.length[t0 + r];
        n = len < 0 || len > L ? -1 : static_cast<int>(len);
      }
      s_len[r] = n;
    }
    __syncthreads();
    // stage the live slots: code (dense opcode, or kBadCode) and leaf value
    for (int e = r; e < nt * L; e += kFoldThreads) {
      const int q = e / L;
      const int s = e - q * L;
      if (s >= s_len[q]) continue;
      const long long g = base + e;
      // independent loads, so their latencies overlap
      const long long k = a.kind[g];
      const long long o = a.op[g];
      const Storage c = a.cval[g];
      const long long f = kSlots ? a.feat[g] : 0;
      int code = kBadCode;
      SR_REAL v = SR_LIT(0.);
      if (k == KIND_CONST) {
        code = OP_CONST;
        v = to_f32(c);
      } else if (k == KIND_VAR || k == KIND_PAD) {
        code = static_cast<int>(k);
        if constexpr (kSlots) {
          if (f < 0 || f >= a.nfeat) {
            code = kBadCode;
          } else {
            v = to_f32(a.X[f]);
          }
        }
      } else if (k == KIND_UNA) {
        if (o >= 0 && o < a.map.n_unary) code = a.map.code[o];
      } else if (k == KIND_BIN) {
        if (o >= 0 && o < n_binary) code = a.map.code[a.map.n_unary + o];
      }
      A[s * kFoldLd + q] = code;
      V[s * kFoldLd + q] = v;
    }
    __syncthreads();
    // the walk: one thread per tree, the block's first warp; the output
    // map's last slot (the top of the stack) also in registers
    int m = -1;
    if (r < nt) {
      const long long t = t0 + r;
      int n = s_len[r];
      bool invalid = n < 0;
      if (invalid) n = 0;
      int depth = 0, out = 0;
      int top_a = 0;
      SR_REAL top_v = SR_LIT(0.);
      bool nonfinite = false;
      int* a_r = A + r;
      SR_REAL* v_r = V + r;
      for (int s = 0; s < n; ++s) {
        const int c = a_r[s * kFoldLd];
        SR_REAL x = SR_LIT(0.);
        if (c == kBadCode) {
          invalid = true;
          break;
        }
        if (c <= OP_VAR) {  // a leaf
          if (depth >= cap) {
            invalid = true;
            break;
          }
          ++depth;
          x = v_r[s * kFoldLd];
          top_a = kSlots || (c != OP_VAR && isfinite(x)) ? kFold : s;
          top_v = x;
          a_r[out * kFoldLd] = top_a;
          v_r[out * kFoldLd] = x;
          ++out;
        } else {
          const bool bin = c >= kFirstBinary;
          if (depth < (bin ? 2 : 1)) {
            invalid = true;
            break;
          }
          if (bin) --depth;
          // the children are constant: each is one output slot, the last
          bool folds = kSlots || (top_a == kFold &&
                                  (!bin || a_r[(out - 2) * kFoldLd] == kFold));
          if (folds) {
            x = round_s(fold_apply<kAll>(
                c, bin ? v_r[(out - 2) * kFoldLd] : SR_LIT(0.), top_v));
            folds = kSlots || isfinite(x);
          }
          if (folds) {
            if (bin) --out;
            top_a = kFold;
            top_v = x;
            a_r[(out - 1) * kFoldLd] = kFold;
            v_r[(out - 1) * kFoldLd] = x;
          } else {
            top_a = s;
            a_r[out * kFoldLd] = s;
            ++out;
          }
        }
        if constexpr (kSlots) {
          a.vals[t * L + s] = from_f32(x);
          nonfinite |= c != OP_PAD && !isfinite(x);
        }
      }
      invalid |= n > 0 && depth != 1;
      if constexpr (kSlots) {
        for (int s = invalid ? 0 : n; s < L; ++s) {
          a.vals[t * L + s] = from_f32(SR_LIT(0.));
        }
        a.bad[t] = invalid || nonfinite ? 1 : 0;
      } else {
        m = !invalid && out < n ? out : -1;
        a.length_o[t] = m < 0 ? a.length[t] : m;
        a.changed[t] = m >= 0 ? 1 : 0;
      }
    }
    if constexpr (!kSlots) {
      if (r < kFoldTrees) s_new[r] = m;
      __syncthreads();
      // write back: the kept slots from the output map, PAD after the new
      // length, an unchanged tree as it was
      for (int e = r; e < nt * L; e += kFoldThreads) {
        const int q = e / L;
        const int j = e - q * L;
        const int mq = s_new[q];
        const long long g = base + e;
        long long src = -1;
        long long k = KIND_PAD, o = 0, f = 0;
        Storage c = from_f32(SR_LIT(0.));
        if (mq < 0) {
          src = g;
        } else if (j < mq) {
          const int w = A[j * kFoldLd + q];
          if (w == kFold) {
            k = KIND_CONST;
            c = from_f32(V[j * kFoldLd + q]);
          } else {
            src = base + static_cast<long long>(q) * L + w;
          }
        }
        if (src >= 0) {
          k = a.kind[src];
          o = a.op[src];
          f = a.feat[src];
          c = a.cval[src];
        }
        a.kind_o[g] = k;
        a.op_o[g] = o;
        a.feat_o[g] = f;
        a.cval_o[g] = c;
      }
    }
    __syncthreads();  // the arena and s_len are read before the next tile
  }
}

using FoldFn = void (*)(FoldArgs);

FoldFn fold_kernel_for(bool slots, bool all, bool global) {
#define SR_FOLD_PICK(S)                                                      \
  (all ? (global ? &fold_kernel<S, true, true> : &fold_kernel<S, true, false>) \
       : (global ? &fold_kernel<S, false, true> : &fold_kernel<S, false, false>))
  return slots ? SR_FOLD_PICK(true) : SR_FOLD_PICK(false);
#undef SR_FOLD_PICK
}

}  // namespace

extern "C" {

// The build's storage type (SR_STORAGE: 0 float, 1 bfloat16, 2 float16,
// 3 double), the type of X, cval and the value output.
int postfix_eval_storage() { return SR_STORAGE; }

// The kernel's fixed layout: cfg[0] rows per lane per pass, [1] most warps
// per block, [2] most shared memory per block in bytes.
void postfix_eval_config(int* cfg) {
  cfg[0] = kRows;
  cfg[1] = kMaxWarps;
  cfg[2] = kMaxSmemBytes;
}

// Shared memory of one block: per warp, the stack ((L + 1) / 2 entries of
// 32 x kRows floats), the program words (L + 1, 8 bytes each) and
// constants (L); with X staged, X's rows of the work item (nfeat x range
// floats).
int postfix_eval_smem_bytes(int warps, int L, int nfeat, int range,
                            int staged) {
  const int entry = 32 * kRows;
#if SR_STORAGE == 3
  // the float64 build: values and words of 8 bytes
  const long long b =
      8LL * warps * ((L + 1) / 2 * static_cast<long long>(entry) + 2LL * L + 1) +
      (staged ? 8LL * nfeat * range : 0);
#else
  const long long b = 4LL * warps * ((L + 1) / 2 * static_cast<long long>(entry) +
                                     3LL * L + 2) +
                      (staged ? 4LL * nfeat * range : 0);
#endif
  return b > kMaxSmemBytes ? kMaxSmemBytes + 1 : static_cast<int>(b);
}

// Resident blocks per SM of the instantiation for (mode, all_ops, staged,
// any_loss) at warps x 32 threads and smem bytes, or -1 on an error.
int postfix_eval_occupancy(int mode, int all_ops, int staged, int any_loss,
                           int warps, int smem) {
  const KernelFn fn =
      kernel_for(mode, all_ops != 0, staged != 0, mode == 1 && any_loss != 0);
  if (fn == nullptr) return -1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemBytes) != cudaSuccess) {
    return -1;
  }
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, warps * 32,
                                                    smem) != cudaSuccess) {
    return -1;
  }
  return occ;
}

// The narrow route's layout for T trees (srprog::narrow_plan): plan[0]
// warps per block, [1] resident blocks per SM, [2] shared memory per block
// in bytes, [3] blocks, [4] 1 when the stacks are in shared memory, [5]
// bytes of global memory for the stacks (0 in shared memory).
int postfix_eval_narrow_plan(int T, int L, int mode, int all_ops,
                             int any_loss, long long* plan) {
  if (T < 0 || L <= 0 || L >= (1 << 24) || mode < 0 || mode > 1) {
    return cudaErrorInvalidValue;
  }
  const KernelFn fn =
      narrow_kernel_for(mode, all_ops != 0, mode == 1 && any_loss != 0);
  if (fn == nullptr) return cudaErrorInvalidValue;
  NarrowPlan np;
  const cudaError_t err =
      narrow_plan(fn, T, narrow_fixed_bytes(L), narrow_stack_bytes(L),
                  kMaxWarps, kMaxSmemBytes, &np);
  if (err != cudaSuccess) return err;
  const long long p[6] = {np.warps, np.blocks_per_sm, np.smem, np.blocks,
                          np.in_shared, np.scratch_bytes};
  for (int i = 0; i < 6; ++i) plan[i] = p[i];
  return cudaSuccess;
}

// X, cval and out are of the build's storage type (postfix_eval_storage;
// the 2-byte and float64 builds take mode 0 only); y, part and the fused
// mode's out are float.
// opmap: the kernel operator id of each unary, then each binary operator
// (host memory, n_unary + n_binary entries); all_ops: the batch uses an
// operator outside the common set, so the instantiation with every
// operator runs (operators.cuh). The layout (items row ranges of `range`
// rows per tree, X staged or not, warps per block, smem bytes, blocks) is
// the wrapper's plan (ops/kernel_eval.py eval_plan). part / part_bad:
// (T, items) scratch, or out / bad when items is 1. narrow: the narrow
// route (postfix_eval_narrow_plan's layout; items 1, X not staged), its
// stacks in `scratch` (global memory of the plan's size) or, when scratch
// is null, in shared memory. loss_kind, c0-c2: the fused mode's loss
// (csrc/losses.cuh; ops/losses.py ElementwiseLoss.kind / constants); L2
// runs its own instantiation. per_set: trees per dataset, X being
// (T / per_set, nfeat, nrows) and y (T / per_set, nrows), the trees set-
// major and `order` longest first within each set (per_set = T: one X);
// blocks is then T / per_set x ceil(per_set / warps) x items.
cudaError_t postfix_eval_launch(const void* kind, const void* op,
                                const void* feat, const void* cval,
                                const void* length, const void* order,
                                const void* X, const void* y, void* out,
                                void* bad, void* part, void* part_bad,
                                void* scratch, const int* opmap, int n_unary,
                                int n_binary, int T, int per_set, int L,
                                int nfeat, int nrows, int mode, int all_ops,
                                int items,
                                int range, int staged, int warps, int smem,
                                int blocks, int narrow, int loss_kind,
                                SR_REAL c0, SR_REAL c1, SR_REAL c2,
                                void* stream) {
  if (T <= 0) return cudaSuccess;
  if (per_set < 1 || T % per_set != 0) return cudaErrorInvalidValue;
  const int set_groups = warps < 1 ? 0 : (per_set + warps - 1) / warps;
  if (n_unary + n_binary > kMaxOps || mode < 0 || mode > 1 || items < 1 ||
      loss_kind < 0 || loss_kind >= SR_LOSS_KINDS ||
      range < 1 || warps < 1 || warps > kMaxWarps || L <= 0 ||
      L >= (1 << 24) || smem > kMaxSmemBytes || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  if (narrow ? (items != 1 || staged ||
                smem != warps * (narrow_fixed_bytes(L) +
                                 (scratch ? 0 : narrow_stack_bytes(L))) ||
                static_cast<long long>(blocks) * warps <
                    (scratch ? 1 : T))
             : (smem != postfix_eval_smem_bytes(warps, L, nfeat, range,
                                                staged) ||
                static_cast<long long>(blocks) !=
                    static_cast<long long>(T / per_set) * set_groups * items)) {
    return cudaErrorInvalidValue;
  }
  EvalArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.cval = static_cast<const Storage*>(cval);
  a.length = static_cast<const long long*>(length);
  a.order = static_cast<const long long*>(order);
  a.X = static_cast<const Storage*>(X);
  a.y = static_cast<const SR_REAL*>(y);
  a.out = static_cast<Storage*>(out);
  a.bad = static_cast<int*>(bad);
  a.part = static_cast<SR_REAL*>(part);
  a.part_bad = static_cast<int*>(part_bad);
  a.scratch = static_cast<SR_REAL*>(scratch);
  a.T = T;
  a.L = L;
  a.nfeat = nfeat;
  a.nrows = nrows;
  a.items = items;
  a.range = range;
  a.cap = (L + 1) / 2;
  a.per_set = per_set;
  a.set_groups = set_groups;
  a.map = make_op_map(opmap, n_unary, n_binary);
  a.loss_fn = srloss::Loss{loss_kind, c0, c1, c2};
  const bool any_loss = mode == 1 && loss_kind != srloss::kL2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KernelFn fn = narrow ? narrow_kernel_for(mode, all_ops != 0, any_loss)
                            : kernel_for(mode, all_ops != 0, staged != 0,
                                         any_loss);
  if (fn == nullptr) return cudaErrorInvalidValue;  // no fused mode here
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<blocks, warps * 32, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || items == 1) return err;
  combine_kernel<<<(T + 255) / 256, 256, 0, s>>>(
      a.part, a.part_bad, static_cast<SR_REAL*>(out), a.bad, T, items, mode);
  return cudaGetLastError();
}

// The constant-fold kernel's layout: cfg[0] trees per block, [1] bytes of
// one slot row of a block's arena (max_len rows; in global memory each
// block's arena starts at a multiple of 16 bytes), [2] the most dynamic
// shared memory a block may use.
void postfix_fold_config(int* cfg) {
  cfg[0] = kFoldTrees;
  cfg[1] = fold_slot_bytes();
  cfg[2] = kMaxSmemBytes - 2 * kFoldTrees * static_cast<int>(sizeof(int));
}

// The constant fold (kind_o non-null: kind_o, op_o, feat_o, cval_o,
// length_o and changed written; X, vals and bad null) or the slot-values
// output (vals non-null: vals (T, L) and bad (T,) written from X (nfeat,
// 1); the fold outputs null) of T trees of max_len L (the TreeBatch fields
// as they are: int64 kind, op, feat, length, cval of the storage type).
// The arenas are in shared memory (smem = L x postfix_fold_config's slot
// bytes, blocks = one per kFoldTrees trees, scratch null) or, when scratch
// is given, in global memory, one per block (smem 0, any blocks).
cudaError_t postfix_fold_launch(const void* kind, const void* op,
                                const void* feat, const void* cval,
                                const void* length, const void* X,
                                void* kind_o, void* op_o, void* feat_o,
                                void* cval_o, void* length_o, void* changed,
                                void* vals, void* bad, void* scratch,
                                const int* opmap, int n_unary, int n_binary,
                                int T, int L, int nfeat, int all_ops,
                                int blocks, int smem, void* stream) {
  if (T <= 0) return cudaSuccess;
  const bool slots = vals != nullptr;
  const long long arena = static_cast<long long>(L) * fold_slot_bytes();
  const int tiles = (T + kFoldTrees - 1) / kFoldTrees;
  if (n_unary + n_binary > kMaxOps || L <= 0 || L >= (1 << 24) ||
      blocks < 1 || (slots ? (bad == nullptr || X == nullptr || nfeat < 1 ||
                              kind_o != nullptr)
                           : (kind_o == nullptr || op_o == nullptr ||
                              feat_o == nullptr || cval_o == nullptr ||
                              length_o == nullptr || changed == nullptr)) ||
      (scratch ? (smem != 0 || blocks > tiles)
               : (smem != arena || blocks != tiles ||
                  arena > kMaxSmemBytes - 2 * kFoldTrees *
                                              static_cast<long long>(sizeof(int))))) {
    return cudaErrorInvalidValue;
  }
  FoldArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.cval = static_cast<const Storage*>(cval);
  a.length = static_cast<const long long*>(length);
  a.X = static_cast<const Storage*>(X);
  a.kind_o = static_cast<long long*>(kind_o);
  a.op_o = static_cast<long long*>(op_o);
  a.feat_o = static_cast<long long*>(feat_o);
  a.cval_o = static_cast<Storage*>(cval_o);
  a.length_o = static_cast<long long*>(length_o);
  a.changed = static_cast<unsigned char*>(changed);
  a.vals = static_cast<Storage*>(vals);
  a.bad = static_cast<int*>(bad);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.arena_bytes = (arena + 15) / 16 * 16;
  a.T = T;
  a.L = L;
  a.nfeat = nfeat;
  a.map = make_op_map(opmap, n_unary, n_binary);
  const FoldFn fn = fold_kernel_for(slots, all_ops != 0, scratch != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  fn<<<blocks, kFoldThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* postfix_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
