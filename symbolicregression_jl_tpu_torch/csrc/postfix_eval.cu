// Postfix-program scoring kernel for Hopper (sm_90a): value mode, fused-loss
// mode and per-slot values.
//
// Replaces the Pallas TPU kernel symbolicregression_jl_tpu/ops/pallas_eval.py
// `_make_kernel` / `_postfix_call` (through `eval_trees_pallas` and
// `eval_loss_trees_pallas`): for each of T postfix programs over X
// (nfeat, nrows) f32, run the program's slots up to its own length on every
// row; a non-finite value at a slot that is not PAD poisons the tree.
//   mode 0 (value): out[t, row] = root value            -> (T, nrows) f32
//   mode 1 (fused): out[t] = sum_rows loss(root, y[row])  -> (T,) f32, for
//                   any elementwise loss of the registry (csrc/losses.cuh)
//   mode 2 (slots): out[t, s] = value of slot s on the single row
//                   (nrows must be 1), 0 past the length -> (T, L) f32;
//                   constant folding reads every subtree's value from it
// In every mode bad[t] = 1 when the tree was poisoned. The trees are the
// TreeBatch fields as they are (kind, op, feat int64; cval f32; length
// int64); a tree that is not a valid postfix program counts as poisoned.
// The bfloat16 and float16 builds (SR_STORAGE, csrc/postfix_program.cuh)
// are the kernel's compute_dtype="bfloat16" variant (`_make_kernel` with
// cdt bf16, pallas_eval.py:497-500 and :578-582), float16 the same rule
// for the reference's jnp interpreter at float16: X, cval and the value
// and slot outputs in the storage type, each slot's value computed in f32
// and rounded to the storage type where it is produced, poison judged on
// the rounded value. They carry modes 0 and 2 only (the reference fuses
// the loss at float32 alone, fitness.py:331-335). X is staged in shared
// memory as float (converted on the way in, so a 2-byte X of any row
// count needs no alignment rule), and the outputs take half the bytes.
// The float64 build (SR_STORAGE 3) computes and stores in double (the
// reference runs float64 on its jnp interpreter, which no Pallas kernel
// replaces): modes 0 and 2, every value, stack entry and staged X 8 bytes,
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
//    shared memory is read from global memory instead).
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
  int T, L, nfeat, nrows, items, range, cap;
  OpMap map;
  srloss::Loss loss_fn;  // the fused mode's loss (the kAnyLoss instantiations)
};

template <int kMode, bool kAll, bool kStaged, bool kAnyLoss = false>
__global__ void __launch_bounds__(kMaxWarps * 32)
postfix_kernel(const __grid_constant__ EvalArgs a) {
  // the slot-values mode has one row: one row per lane keeps its stack small
  constexpr int kR = kMode == 2 ? 1 : kRows;
  extern __shared__ __align__(16) SR_REAL smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x % a.items;  // row range
  const int row0 = r * a.range;
  const int rows = min(a.range, a.nrows - row0);
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
      stage_x(xs + i, a.X + f * a.nrows + row);
    }
  }
  const int g = (blockIdx.x / a.items) * warps + warp;
  const bool active = g < a.T;
  long long t = 0;
  int n = 0;
  bool invalid = false;
  if (active) {
    t = a.order[g];
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
  Storage* slots = kMode == 2 ? a.out + t * a.L : nullptr;
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
            const Storage* xf = a.X + f * a.nrows;
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              x[i] = to_f32(xf[min(row0 + lr + i, a.nrows - 1)]);
            }
          }
        },
        [&](int s, const SR_REAL (&x)[kR]) {
          if constexpr (kMode == 2) {
            if (lane == 0) slots[s] = from_f32(x[0]);
          }
        });
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
          if (row < a.nrows) acc += srloss::elem<K>(a.loss_fn, v[i], a.y[row]);
        }
      });
    } else if constexpr (kMode == 1) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int row = row0 + lr + i;
        if (row < a.nrows) {
          const SR_REAL d = v[i] - a.y[row];
          acc += d * d;
        }
      }
    }
  }
  if constexpr (kMode == 2) {
    for (int s = n + lane; s < a.L; s += 32) slots[s] = from_f32(SR_LIT(0.));
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
    if constexpr (kMode == 2) {
      a.bad[t] = any_bad ? 1 : 0;
    } else {
      a.part_bad[p] = any_bad ? 1 : 0;
    }
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
    Storage* slots = kMode == 2 ? a.out + t * a.L : nullptr;
    for (int base = 0; base < a.nrows; base += 32) {
      const int row = base + lane;
      const unsigned xr = min(row, a.nrows - 1);
      SR_REAL v[1] = {};
      run_program<kAll, 1, false, true>(
          word_a, n, stack_a, v, pz,
          [&](int s, SR_REAL (&x)[1]) { x[0] = SR_LDS(cval_a + SR_RB * s); },
          [&](int f, SR_REAL (&x)[1]) {
            x[0] = to_f32(a.X[static_cast<unsigned>(f) * a.nrows + xr]);
          },
          [&](int s, const SR_REAL (&x)[1]) {
            if constexpr (kMode == 2) {
              if (lane == 0) slots[s] = from_f32(x[0]);
            }
          });
      if constexpr (kMode == 0) {
        if (row < a.nrows) a.out[t * a.nrows + row] = from_f32(v[0]);
      } else if constexpr (kMode == 1 && kAnyLoss) {
        if (row < a.nrows) {
          srloss::with_loss(a.loss_fn.kind, [&](auto k) {
            constexpr int K = decltype(k)::value;
            acc += srloss::elem<K>(a.loss_fn, v[0], a.y[row]);
          });
        }
      } else if constexpr (kMode == 1) {
        if (row < a.nrows) {
          const SR_REAL d = v[0] - a.y[row];
          acc += d * d;
        }
      }
    }
    if constexpr (kMode == 2) {
      for (int s = n + lane; s < a.L; s += 32) slots[s] = from_f32(SR_LIT(0.));
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
#else
  if (mode == 1) return nullptr;
#endif
  return all ? &postfix_narrow_kernel<2, true> : &postfix_narrow_kernel<2, false>;
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
#else
  if (mode == 1) return nullptr;
#endif
#undef SR_PICK
  return all ? &postfix_kernel<2, true, false> : &postfix_kernel<2, false, false>;
}

}  // namespace

extern "C" {

// The build's storage type (SR_STORAGE: 0 float, 1 bfloat16, 2 float16,
// 3 double), the type of X, cval and the value and slot outputs.
int postfix_eval_storage() { return SR_STORAGE; }

// The kernel's fixed layout: cfg[0] rows per lane per pass (1 in the
// slot-values mode), [1] most warps per block, [2] most shared memory per
// block in bytes.
void postfix_eval_config(int* cfg) {
  cfg[0] = kRows;
  cfg[1] = kMaxWarps;
  cfg[2] = kMaxSmemBytes;
}

// Shared memory of one block: per warp, the stack ((L + 1) / 2 entries of
// 32 x kRows floats, 32 in the slot-values mode), the program words (L + 1,
// 8 bytes each) and constants (L); with X staged, X's rows of the work item
// (nfeat x range floats).
int postfix_eval_smem_bytes(int warps, int L, int nfeat, int range,
                            int staged, int mode) {
  const int entry = 32 * (mode == 2 ? 1 : kRows);
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
  if (T < 0 || L <= 0 || L >= (1 << 24) || mode < 0 || mode > 2) {
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
// the 2-byte builds take modes 0 and 2 only); y, part and the fused
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
// runs its own instantiation.
cudaError_t postfix_eval_launch(const void* kind, const void* op,
                                const void* feat, const void* cval,
                                const void* length, const void* order,
                                const void* X, const void* y, void* out,
                                void* bad, void* part, void* part_bad,
                                void* scratch, const int* opmap, int n_unary,
                                int n_binary, int T, int L, int nfeat,
                                int nrows, int mode, int all_ops, int items,
                                int range, int staged, int warps, int smem,
                                int blocks, int narrow, int loss_kind,
                                SR_REAL c0, SR_REAL c1, SR_REAL c2,
                                void* stream) {
  if (T <= 0) return cudaSuccess;
  if (n_unary + n_binary > kMaxOps || mode < 0 || mode > 2 || items < 1 ||
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
             : (smem != postfix_eval_smem_bytes(warps, L, nfeat, range, staged,
                                                mode) ||
                blocks != (T + warps - 1) / warps * items)) {
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
  if (err != cudaSuccess || items == 1 || mode == 2) return err;
  combine_kernel<<<(T + 255) / 256, 256, 0, s>>>(
      a.part, a.part_bad, static_cast<SR_REAL*>(out), a.bad, T, items, mode);
  return cudaGetLastError();
}

const char* postfix_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
