// Instruction-program scoring kernels for Hopper (sm_90a), value mode.
//
// Replace the Pallas TPU kernels of symbolicregression_jl_tpu/ops/
// pallas_eval.py `_make_instr_kernel` through `_eval_instr`:
//   B5 (program="instr", kPacked false): each step's operands described by
//       source (a previous result, a feature column of X, or a constant) and
//       index, each fetched through a select on its source;
//   B6 (program="instr_packed", kPacked true): one packed word per step
//       (opcode | lconst | rconst | lidx | ridx, the layout of
//       ops/kernel_instr.py pack_instr_tables) and its two constants, over a
//       unified operand space: features at [0, nfeat), results at nfeat + k,
//       so an operand is one load from a computed address (or a constant).
// For each of T trees (the TreeBatch fields kind / op / feat / cval / length
// as they are) over X (nfeat, nrows) f32, run the tree's instruction program
// (one step per operator node; a bare leaf is one identity step) on every
// row:
//   out[t, row] = the last step's value (0 for an empty or invalid tree)
//                                                           -> (T, nrows) f32
//   bad[t] = 1 when a step's value or operand was non-finite on a row, or
//            the tree is not a valid postfix program          -> (T,) i32
// Each step applies the device function of csrc/operators.cuh that the
// postfix kernel (postfix_eval.cu) applies at the same node, to the same
// operand values, and this file is built with the same flags: the values are
// bit-equal to the postfix kernel's value mode. A step's poison check on its
// operands covers the leaves, which the postfix kernel checks as slots.
//
// What bounds it on this card: the output. At 5,376 trees x 2,048 rows the
// (T, nrows) matrix is 44 MB, 13 us at 3.35 TB/s; the operator nodes are 10x
// fewer operations than that at 67 TFLOP/s. The design's work is to keep the
// per-step instructions (opcode read, dispatch, operand address and fetch)
// from setting the time instead:
//  * The program is derived in the prologue, per warp, from the TreeBatch
//    fields (no host tables, no host wait): derive_program's words give each
//    slot its stack entry, derive_adjoint_words each binary slot's left
//    operand (the slot the stack entry holds), and a ballot scan over the
//    operator slots each one's instruction number (derive_instructions).
//    The right operand is always the previous slot: a leaf, or the previous
//    instruction's result, which B5 keeps in registers. An invalid program
//    is reported poisoned without running.
//  * Each lane carries kR rows through a step, so one record read, one
//    dispatch and one operand address serve kR rows, and the kR operator
//    evaluations are independent work.
//  * Work items = (tree, row range), trees longest first, as the postfix
//    kernel's (ops/kernel_eval.py eval_plan): 5,376 trees fill 132 SMs. B5
//    stages each block's range of X in shared memory with cp.async; B6 loads
//    each lane's rows of every feature into the front of its operand space.
//  * Results live in shared memory ([entry][lane][kR]). B6 keeps every
//    result at nfeat + k of its operand space. B5 keeps a result where the
//    stack machine would: at the stack depth after its slot, the entry a
//    later binary step's left operand names (its own stack entry), so it
//    needs (L + 1) / 2 + 1 entries, not L, and twice the warps fit. Where
//    one warp's do not fit (long programs), the narrow route: one row per
//    lane, one range per tree, results in shared memory or in global memory
//    (one region per resident warp, srprog::narrow_plan), the warps looping
//    over the trees.
// The bfloat16 and float16 builds (SR_STORAGE, csrc/postfix_program.cuh)
// are `_make_instr_kernel`'s compute_dtype="bfloat16" variant
// (pallas_eval.py:778-788), float16 the same rule: X, the constants and
// the output in the storage type, each step's value computed in f32 and
// rounded to the storage type (poison on the rounded value), the operand
// finiteness test kept; they give B1's bits at the same storage type. The
// float64 build (SR_STORAGE 3) computes and stores in double; B6's records
// there carry its constants' slots instead of their bits, read from the
// constants as B5 reads them.
// Built without --use_fast_math and, unlike the constant-optimisation
// kernels, without -fmad=false: the flags of postfix_eval.cu, whose bits
// these values must be.

#include <cuda_runtime.h>

#include "postfix_program.cuh"

namespace {

using namespace srprog;

constexpr int kRows = 4;  // rows per lane per pass (the wide routes)
constexpr int kMaxWarps = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use
// operand sources (ops/kernel_instr.py SRC_*), in bits 30-31 of a
// descriptor; its index in bits 0-29
constexpr int SRC_RES = 0, SRC_VAR = 1, SRC_CONST = 2;
constexpr int kIdxMask = (1 << 30) - 1;

struct InstrArgs {
  const long long* kind;
  const long long* op;
  const long long* feat;
  const Storage* cval;
  const long long* length;
  const long long* order;
  const Storage* X;
  Storage* out;
  int* bad;
  int* part_bad;   // (T, items) poison flags; bad itself when items == 1
  SR_REAL* scratch;  // the narrow route's results in global memory, or null
  int T, L, nfeat, nrows, items, range, cap;
  OpMap map;
};

__device__ __forceinline__ int desc_src(int d) {
  return static_cast<unsigned>(d) >> 30;
}
__device__ __forceinline__ int desc_idx(int d) { return d & kIdxMask; }
__device__ __forceinline__ int make_desc(int src, int idx) {
  return (src << 30) | idx;
}

// A step's record (16 bytes). B5: x = opcode | rsrc << 8 | lsrc << 10 |
// the entry its result goes to << 12, y = ridx, z = lidx (a RES operand's
// instruction, a VAR's feature, a CONST's postfix slot), w = the entry a
// RES left operand is read from. B6: x = the packed word, y / z = the bits
// of the left / right constant (in the float64 build their postfix slots:
// B6 reads its constants from the slots' constants as B5 does).
template <bool kPacked>
__device__ __forceinline__ int4 make_record(int code, int r, int l,
                                            const SR_REAL* cv, int nfeat, int L,
                                            int store, int left_entry) {
  if constexpr (kPacked) {
    const auto unify = [&](int d) {
      return desc_src(d) == SRC_RES ? nfeat + desc_idx(d)
             : desc_src(d) == SRC_VAR ? desc_idx(d) : 0;
    };
#if SR_STORAGE == 3
    const auto slot = [&](int d) {
      return desc_src(d) == SRC_CONST && desc_idx(d) < L ? desc_idx(d) : 0;
    };
    (void)cv;
#else
    const auto constant = [&](int d) {
      return desc_src(d) == SRC_CONST && desc_idx(d) < L ? cv[desc_idx(d)]
                                                         : SR_LIT(0.);
    };
#endif
    const int word = code | (desc_src(l) == SRC_CONST) << 8 |
                     (desc_src(r) == SRC_CONST) << 9 | unify(l) << 10 |
                     unify(r) << 21;
#if SR_STORAGE == 3
    return make_int4(word, slot(l), slot(r), 0);
#else
    return make_int4(word, __float_as_int(constant(l)),
                     __float_as_int(constant(r)), 0);
#endif
  } else {
    return make_int4(code | desc_src(r) << 8 | desc_src(l) << 10 | store << 12,
                     desc_idx(r), desc_idx(l), left_entry);
  }
}

// The instruction program of a valid postfix program of n slots, from its
// words (derive_program, then derive_adjoint_words: a binary slot's left
// operand in the feature field) into rec[0, n_instr); returns n_instr on
// every lane. s_desc (n ints) takes what each slot pushes: an operator
// slot's result (RES, its instruction number), a VAR's feature, a CONST's
// (or PAD's) slot; cv holds each slot's constant (0 but at CONST slots).
// Instruction k is the k-th operator slot s: its right operand is slot
// s - 1, its left (binary) the slot in the word; a unary step's left is the
// constant 0 at index L, and a program of one leaf is one identity step on
// it, as instruction_schedule has them.
template <bool kPacked>
__device__ __forceinline__ int derive_instructions(const int2* s_word, int n,
                                                   int* s_desc,
                                                   const SR_REAL* cv,
                                                   int4* rec, int L, int nfeat,
                                                   int lane) {
  const unsigned below = (1u << lane) - 1u;
  const int dummy = make_desc(SRC_CONST, L);
  int ops = 0;
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    const bool live = s < n;
    const int2 w = live ? s_word[s] : make_int2(0, 0);
    const int code = word_code(w);
    const bool is_op = live && code > OP_VAR;
    const unsigned ops_here = __ballot_sync(0xffffffffu, is_op);
    const int pos = ops + __popc(ops_here & below);
    if (live) {
      s_desc[s] = is_op ? make_desc(SRC_RES, pos)
                  : code == OP_VAR ? make_desc(SRC_VAR, word_feat(w))
                                   : make_desc(SRC_CONST, s);
    }
    __syncwarp();
    if (is_op) {
      // a binary slot's word names its left operand's stack entry; its
      // result lands there too, a unary slot's one entry higher
      const bool bin = code >= dense_code(OP_ADD);
      const int l = bin ? s_desc[word_feat(w)] : dummy;
      rec[pos] = make_record<kPacked>(code, s_desc[s - 1], l, cv, nfeat, L,
                                      word_entry(w) + (bin ? 0 : 1),
                                      word_entry(w));
    }
    ops += __popc(ops_here);
    __syncwarp();
  }
  if (n > 0 && ops == 0) {  // a bare leaf
    if (lane == 0) {
      rec[0] = make_record<kPacked>(dense_code(OP_IDENTITY), s_desc[0], dummy,
                                    cv, nfeat, L, 0, 0);
    }
    ops = 1;
  }
  __syncwarp();
  return ops;
}

__device__ __forceinline__ int4 lds_record(unsigned a) {
  int4 r;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(a));
  return r;
}

// One instruction's operator on kN values per lane: v = op(b, a), or op(a)
// for a unary code (the dense numbering of postfix_program.cuh).
template <bool kAll, int kN>
__device__ __forceinline__ void apply_step(int code, const SR_REAL (&a)[kN],
                                           const SR_REAL (&b)[kN],
                                           SR_REAL (&v)[kN]) {
#define SR_UNARY_CASE(OPC)                                                   \
  case dense_code(OPC):                                                      \
    _Pragma("unroll") for (int i = 0; i < kN; ++i) v[i] =                    \
        apply_unary<kAll>(OPC, a[i]);                                        \
    break;
#define SR_BINARY_CASE(OPC)                                                  \
  case dense_code(OPC):                                                      \
    _Pragma("unroll") for (int i = 0; i < kN; ++i) v[i] =                    \
        apply_binary<kAll>(OPC, b[i], a[i]);                                 \
    break;
  switch (code) {
    SR_UNARY_COMMON(SR_UNARY_CASE)
    SR_BINARY_COMMON(SR_BINARY_CASE)
    default:
      if constexpr (kAll) {
        switch (code) {
          SR_UNARY_OTHER(SR_UNARY_CASE)
          SR_BINARY_OTHER(SR_BINARY_CASE)
          default:
#pragma unroll
            for (int i = 0; i < kN; ++i) v[i] = nanf_();
            break;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kN; ++i) v[i] = nanf_();
      }
      break;
  }
#undef SR_UNARY_CASE
#undef SR_BINARY_CASE
}

// Runs the ni steps of the records at rec_a on kN values per lane; r holds
// the last step's values on return. B5: res is this lane's part of result
// entry 0; var(f, x) gives feature f's values, a constant is cval_a's float
// at its slot. B6: res is this lane's part of the operand space's entry 0,
// whose entries [0, nfeat) hold the features. The next record loads while
// a step runs.
#if SR_STORAGE == 3
#define B6_CONST(field) SR_LDS(cval_a + SR_RB * (field))
#else
#define B6_CONST(field) __int_as_float(field)
#endif
template <bool kPacked, bool kAll, int kN, bool kGeneric, class Var>
__device__ __forceinline__ void run_instr(unsigned rec_a, int ni,
                                          unsigned cval_a,
                                          typename Stack<kN, kGeneric>::Addr res,
                                          int nfeat, SR_REAL (&r)[kN],
                                          SR_REAL (&pz)[kN], Var var) {
  using St = Stack<kN, kGeneric>;
  using Addr = typename St::Addr;
  constexpr unsigned kEntryBytes = St::kEntryBytes;
  const Addr out0 = kPacked ? res + static_cast<Addr>(nfeat) * kEntryBytes : res;
  int4 next = ni > 0 ? lds_record(rec_a) : make_int4(0, 0, 0, 0);
  for (int k = 0; k < ni; ++k) {
    const int4 q = next;
    if (k + 1 < ni) next = lds_record(rec_a + 16u * (k + 1));
    const int code = q.x & 0xff;
    const bool binary = code >= dense_code(OP_ADD);
    SR_REAL a[kN], b[kN], v[kN];
    if constexpr (kPacked) {
      if ((q.x >> 9) & 1) {
#pragma unroll
        for (int i = 0; i < kN; ++i) a[i] = B6_CONST(q.z);
      } else {
        St::load(res + static_cast<Addr>((q.x >> 21) & 0x7ff) * kEntryBytes, a);
      }
      poison(a, pz);
      if (binary) {
        if ((q.x >> 8) & 1) {
#pragma unroll
          for (int i = 0; i < kN; ++i) b[i] = B6_CONST(q.y);
        } else {
          St::load(res + static_cast<Addr>((q.x >> 10) & 0x7ff) * kEntryBytes,
                   b);
        }
        poison(b, pz);
      }
    } else {
      const auto leaf = [&](int src, int idx, SR_REAL (&x)[kN]) {
        if (src == SRC_VAR) {
          var(idx, x);
        } else {
          const SR_REAL c = SR_LDS(cval_a + SR_RB * idx);
#pragma unroll
          for (int i = 0; i < kN; ++i) x[i] = c;
        }
        poison(x, pz);
      };
      const int rs = (q.x >> 8) & 3, ls = (q.x >> 10) & 3;
      if (rs == SRC_RES) {  // the previous step's result
#pragma unroll
        for (int i = 0; i < kN; ++i) a[i] = r[i];
      } else {
        leaf(rs, q.y, a);
      }
      if (binary) {
        if (ls == SRC_RES) {
          St::load(res + static_cast<Addr>(q.w) * kEntryBytes, b);
        } else {
          leaf(ls, q.z, b);
        }
      }
    }
    apply_step<kAll, kN>(code, a, b, v);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = round_s(v[i]);
    poison(v, pz);
    const unsigned at = kPacked ? k : static_cast<unsigned>(q.x) >> 12;
    St::store(out0 + static_cast<Addr>(at) * kEntryBytes, v);
#pragma unroll
    for (int i = 0; i < kN; ++i) r[i] = v[i];
  }
}

// Result (operand space) entries per warp: B5 one per stack entry, B6 one
// per step and feature.
__host__ __device__ constexpr long long space_entries(bool packed, int L,
                                                      int nfeat) {
  return packed ? static_cast<long long>(L) + nfeat : (L + 1) / 2 + 1;
}

// Floats per warp of the records and (B5) the constants, the constants
// rounded to an even count so what follows stays 8-byte aligned; in the
// float64 build doubles, a record two, and B6 keeps the constants too.
#if SR_STORAGE == 3
__host__ __device__ constexpr long long fixed_floats(bool, int L) {
  return 2LL * L + (L + 1) / 2 * 2LL;
}
#else
__host__ __device__ constexpr long long fixed_floats(bool packed, int L) {
  return 4LL * L + (packed ? 0 : (L + 1) / 2 * 2LL);
}
#endif

// The prologue of one tree: its program derived into s_rec (and, B5, its
// constants into s_cval), the derivation's words and descriptors in the
// warp's results region `tmp` (which the steps overwrite later). Returns
// the number of steps, 0 for an empty or invalid tree; *invalid says which.
template <bool kPacked>
__device__ __forceinline__ int prologue(const InstrArgs& a, long long t,
                                        SR_REAL* tmp, int4* s_rec,
                                        SR_REAL* s_cval, int lane,
                                        bool* invalid) {
  const long long len = a.length[t];
  int n = len < 0 || len > a.L ? 0 : static_cast<int>(len);
  int2* s_word = reinterpret_cast<int2*>(tmp);
  int* s_last = reinterpret_cast<int*>(s_word + a.L + 1);
  int* s_desc = s_last + a.cap;
#if SR_STORAGE == 3
  SR_REAL* cv = s_cval;
  (void)s_desc;
#else
  SR_REAL* cv = kPacked ? reinterpret_cast<SR_REAL*>(s_desc + a.L) : s_cval;
#endif
  // the first 32 constants load while the program is derived
  const SR_REAL c0 = lane < n ? to_f32(a.cval[t * a.L + lane]) : SR_LIT(0.);
  *invalid = derive_program(a.kind, a.op, a.feat, t * a.L, n, a.cap, a.nfeat,
                            a.map, s_word, lane) ||
             n != len;
  __syncwarp();
  if (*invalid) n = 0;
  for (int s = lane; s < n; s += 32) {
    const SR_REAL c = s < 32 ? c0 : to_f32(a.cval[t * a.L + s]);
    cv[s] = word_code(s_word[s]) == OP_CONST ? c : SR_LIT(0.);  // PAD gives 0
  }
  if (n > 0) derive_adjoint_words(s_word, n, s_last, lane);
  return derive_instructions<kPacked>(s_word, n, s_desc, cv, s_rec, a.L,
                                      a.nfeat, lane);
}

// The wide routes: kRows rows per lane, work items (tree, row range) as the
// postfix kernel's, results in shared memory; B5 with X staged or not.
template <bool kPacked, bool kAll, bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32)
instr_kernel(const __grid_constant__ InstrArgs a) {
  constexpr int kR = kRows;
  using St = Stack<kR>;
  extern __shared__ __align__(16) SR_REAL smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x % a.items;  // row range
  const int row0 = r * a.range;
  const int rows = min(a.range, a.nrows - row0);
  const long long space = space_entries(kPacked, a.L, a.nfeat) * St::kEntry;
  SR_REAL* xs = smem;
  SR_REAL* results = xs + (kStaged ? a.nfeat * a.range : 0);
  SR_REAL* mine = results + warp * space;
  int4* recs = reinterpret_cast<int4*>(results + warps * space);
  int4* s_rec = recs + warp * a.L;
  SR_REAL* s_cval = reinterpret_cast<SR_REAL*>(recs + warps * a.L) +
                  warp * ((a.L + 1) / 2 * 2);  // B5's constants

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
  int ni = 0;
  bool invalid = false;
  if (active) {
    t = a.order[g];
    ni = prologue<kPacked>(a, t, mine, s_rec, s_cval, lane, &invalid);
  }
  if constexpr (kStaged) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();  // the block's only barrier
  }
  if (!active) return;

  SR_REAL pz[kR] = {};
  const unsigned rec_a = opaque(smem_u32(s_rec));
  const unsigned cval_a = opaque(smem_u32(s_cval));
  const unsigned res_a = opaque(smem_u32(mine + lane * kR));
  const unsigned x_lane = opaque(smem_u32(xs + lane * kR));
  const unsigned range_b = opaque(SR_RB * a.range);
  for (int base = 0; base < rows; base += 32 * kR) {
    const int lr = base + lane * kR;  // local row of this lane's first row
    SR_REAL v[kR] = {};
    if constexpr (kPacked) {
      // this lane's rows of every feature, in front of the results
      for (int f = 0; f < a.nfeat; ++f) {
        SR_REAL x[kR];
        const Storage* xf = a.X + f * a.nrows;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          x[i] = to_f32(xf[min(row0 + lr + i, a.nrows - 1)]);
        }
        St::store(res_a + f * St::kEntryBytes, x);
      }
    }
    run_instr<kPacked, kAll, kR, false>(
        rec_a, ni, cval_a, res_a, a.nfeat, v, pz, [&](int f, SR_REAL (&x)[kR]) {
          if constexpr (kStaged) {
            St::load(x_lane + SR_RB * base + f * range_b, x);
          } else {
            const Storage* xf = a.X + f * a.nrows;
#pragma unroll
            for (int i = 0; i < kR; ++i) {
              x[i] = to_f32(xf[min(row0 + lr + i, a.nrows - 1)]);
            }
          }
        });
    // aligned: every row of the pass is real
    store_rows<kR>(a.out + t * a.nrows + row0 + lr, v,
                   a.nrows % kR == 0 && row0 + lr < a.nrows,
                   a.nrows - (row0 + lr));
  }
  bool nonfinite = false;
#pragma unroll
  for (int i = 0; i < kR; ++i) nonfinite |= pz[i] != pz[i];
  const bool any_bad = __any_sync(0xffffffffu, nonfinite) || invalid;
  if (lane == 0) a.part_bad[t * a.items + r] = any_bad ? 1 : 0;
}

// The narrow route (long programs): one row per lane, one range per tree,
// X from global memory; the results at a.scratch (one region per resident
// warp) or, with a.scratch null, in shared memory after the records and
// constants. The warps loop over the trees.
template <bool kPacked, bool kAll>
__global__ void __launch_bounds__(kMaxWarps * 32)
instr_narrow_kernel(const __grid_constant__ InstrArgs a) {
  using St = Stack<1, true>;
  extern __shared__ __align__(16) SR_REAL smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * warps + warp;
  const long long space = space_entries(kPacked, a.L, a.nfeat) * St::kEntry;
  int4* s_rec = reinterpret_cast<int4*>(smem) + warp * a.L;
  SR_REAL* s_cval = reinterpret_cast<SR_REAL*>(reinterpret_cast<int4*>(smem) +
                                           warps * a.L);
#if SR_STORAGE == 3
  SR_REAL* results = s_cval + warps * ((a.L + 1) / 2 * 2LL);
#else
  SR_REAL* results = s_cval + (kPacked ? 0 : warps * ((a.L + 1) / 2 * 2LL));
#endif
  s_cval += warp * ((a.L + 1) / 2 * 2);
  SR_REAL* mine = a.scratch ? a.scratch + gw * space : results + warp * space;
  const unsigned rec_a = opaque(smem_u32(s_rec));
  const unsigned cval_a = opaque(smem_u32(s_cval));
  const unsigned long long res_a = gen_u64(mine + lane);
  for (long long g = gw; g < a.T; g += static_cast<long long>(gridDim.x) * warps) {
    __syncwarp();  // the last tree's records and results are read
    const long long t = a.order[g];
    bool invalid;
    const int ni = prologue<kPacked>(a, t, mine, s_rec, s_cval, lane, &invalid);
    SR_REAL pz[1] = {};
    for (int base = 0; base < a.nrows; base += 32) {
      const int row = base + lane;
      const unsigned xr = min(row, a.nrows - 1);
      SR_REAL v[1] = {};
      if constexpr (kPacked) {
        for (int f = 0; f < a.nfeat; ++f) {
          const SR_REAL x[1] = {
              to_f32(a.X[static_cast<unsigned>(f) * a.nrows + xr])};
          St::store(res_a + static_cast<unsigned long long>(f) * St::kEntryBytes,
                    x);
        }
      }
      run_instr<kPacked, kAll, 1, true>(
          rec_a, ni, cval_a, res_a, a.nfeat, v, pz, [&](int f,
                                                        SR_REAL (&x)[1]) {
            x[0] = to_f32(a.X[static_cast<unsigned>(f) * a.nrows + xr]);
          });
      if (row < a.nrows) a.out[t * a.nrows + row] = from_f32(v[0]);
    }
    const bool any_bad = __any_sync(0xffffffffu, pz[0] != pz[0]) || invalid;
    if (lane == 0) a.bad[t] = any_bad ? 1 : 0;
  }
}

// Each tree's poison flags over its row ranges.
__global__ void combine_bad_kernel(const int* __restrict__ part_bad,
                                   int* __restrict__ bad, int T, int items) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int b = 0;
  for (int r = 0; r < items; ++r) {
    b |= part_bad[static_cast<long long>(t) * items + r];
  }
  bad[t] = b;
}

using KernelFn = void (*)(InstrArgs);

KernelFn kernel_for(bool packed, bool all, bool staged, bool narrow) {
  if (narrow) {
    return packed ? (all ? &instr_narrow_kernel<true, true>
                         : &instr_narrow_kernel<true, false>)
                  : (all ? &instr_narrow_kernel<false, true>
                         : &instr_narrow_kernel<false, false>);
  }
  if (packed) {  // B6 never stages X
    return all ? &instr_kernel<true, true, false> : &instr_kernel<true, false, false>;
  }
  return all ? (staged ? &instr_kernel<false, true, true>
                       : &instr_kernel<false, true, false>)
             : (staged ? &instr_kernel<false, false, true>
                       : &instr_kernel<false, false, false>);
}

// The wide routes' shared memory per block: per warp the results (kRows
// floats per lane per entry), the records and (B5) the constants; with X
// staged (B5), X's rows of the work item.
long long wide_smem_bytes(bool packed, int warps, int L, int nfeat, int range,
                          bool staged) {
#if SR_STORAGE == 3
  return 8LL * warps *
             (space_entries(packed, L, nfeat) * 32 * kRows +
              fixed_floats(packed, L)) +
         (staged && !packed ? 8LL * nfeat * range : 0);
}

long long narrow_fixed_bytes(bool packed, int L) {
  return 8LL * fixed_floats(packed, L);
}
long long narrow_space_bytes(bool packed, int L, int nfeat) {
  return 8LL * 32 * space_entries(packed, L, nfeat);
}
#else
  return 4LL * warps *
             (space_entries(packed, L, nfeat) * 32 * kRows +
              fixed_floats(packed, L)) +
         (staged && !packed ? 4LL * nfeat * range : 0);
}

long long narrow_fixed_bytes(bool packed, int L) {
  return 4LL * fixed_floats(packed, L);
}
long long narrow_space_bytes(bool packed, int L, int nfeat) {
  return 4LL * 32 * space_entries(packed, L, nfeat);
}
#endif

}  // namespace

extern "C" {

// The build's storage type (SR_STORAGE: 0 float, 1 bfloat16, 2 float16,
// 3 double), the type of X, cval and out.
int instr_eval_storage() { return SR_STORAGE; }

// The wide routes' fixed layout: cfg[0] rows per lane per pass, [1] most
// warps per block, [2] most shared memory per block in bytes.
void instr_eval_config(int* cfg) {
  cfg[0] = kRows;
  cfg[1] = kMaxWarps;
  cfg[2] = kMaxSmemBytes;
}

// Shared memory of one block of the wide route (more than kMaxSmemBytes is
// reported as kMaxSmemBytes + 1).
int instr_eval_smem_bytes(int packed, int warps, int L, int nfeat, int range,
                          int staged) {
  const long long b =
      wide_smem_bytes(packed != 0, warps, L, nfeat, range, staged != 0);
  return b > kMaxSmemBytes ? kMaxSmemBytes + 1 : static_cast<int>(b);
}

// Resident blocks per SM of the wide instantiation at warps x 32 threads and
// smem bytes, or -1 on an error.
int instr_eval_occupancy(int packed, int all_ops, int staged, int warps,
                         int smem) {
  const KernelFn fn = kernel_for(packed != 0, all_ops != 0, staged != 0, false);
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

// The narrow route's layout (srprog::narrow_plan), as
// postfix_eval_narrow_plan's.
int instr_eval_narrow_plan(int T, int L, int nfeat, int packed, int all_ops,
                           long long* plan) {
  if (T < 0 || L <= 0 || L >= (1 << 20)) return cudaErrorInvalidValue;
  NarrowPlan np;
  const cudaError_t err = narrow_plan(
      kernel_for(packed != 0, all_ops != 0, false, true), T,
      narrow_fixed_bytes(packed != 0, L), narrow_space_bytes(packed != 0, L, nfeat),
      kMaxWarps, kMaxSmemBytes, &np);
  if (err != cudaSuccess) return err;
  const long long p[6] = {np.warps, np.blocks_per_sm, np.smem, np.blocks,
                          np.in_shared, np.scratch_bytes};
  for (int i = 0; i < 6; ++i) plan[i] = p[i];
  return cudaSuccess;
}

// B5 (packed 0) or B6 (packed 1) over the TreeBatch fields kind / op / feat
// (int64 (T, L)), cval ((T, L), like X and out of the build's storage
// type, instr_eval_storage) and length (int64 (T,)), trees in the
// order `order`; opmap as postfix_eval_launch's; all_ops: the batch uses an
// operator outside the common set, so the instantiation with every operator
// runs (operators.cuh). The layout is the wrapper's plan
// (ops/kernel_instr.py launch_plan): the wide route with `items` row ranges
// of `range` rows per tree (part_bad (T, items), or bad when items is 1),
// X staged or not, or the narrow route (items 1, its results in `scratch`
// of the plan's size or, when scratch is null, in shared memory). B6 takes
// nfeat + L + 4 <= 2048 (its 11-bit operand indices), B5 L < 2^20 (its
// records' 20-bit entry field).
cudaError_t instr_eval_launch(const void* kind, const void* op,
                              const void* feat, const void* cval,
                              const void* length, const void* order,
                              const void* X, void* out, void* bad,
                              void* part_bad, void* scratch, const int* opmap,
                              int n_unary, int n_binary, int T, int L,
                              int nfeat, int nrows, int packed, int all_ops,
                              int items, int range, int staged, int warps,
                              int smem, int blocks, int narrow, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (n_unary + n_binary > kMaxOps || items < 1 || range < 1 || warps < 1 ||
      warps > kMaxWarps || L <= 0 || L >= (1 << 20) || smem > kMaxSmemBytes ||
      blocks < 1 || (packed && nfeat + L + 4 > 2048)) {
    return cudaErrorInvalidValue;
  }
  if (narrow ? (items != 1 || staged ||
                smem != warps * (narrow_fixed_bytes(packed != 0, L) +
                                 (scratch ? 0 : narrow_space_bytes(packed != 0, L,
                                                                   nfeat))) ||
                static_cast<long long>(blocks) * warps < (scratch ? 1 : T))
             : ((packed && staged) ||
                smem != wide_smem_bytes(packed != 0, warps, L, nfeat, range,
                                        staged != 0) ||
                blocks != (T + warps - 1) / warps * items)) {
    return cudaErrorInvalidValue;
  }
  InstrArgs a;
  a.kind = static_cast<const long long*>(kind);
  a.op = static_cast<const long long*>(op);
  a.feat = static_cast<const long long*>(feat);
  a.cval = static_cast<const Storage*>(cval);
  a.length = static_cast<const long long*>(length);
  a.order = static_cast<const long long*>(order);
  a.X = static_cast<const Storage*>(X);
  a.out = static_cast<Storage*>(out);
  a.bad = static_cast<int*>(bad);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KernelFn fn =
      kernel_for(packed != 0, all_ops != 0, staged != 0, narrow != 0);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  fn<<<blocks, warps * 32, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || narrow || items == 1) return err;
  combine_bad_kernel<<<(T + 255) / 256, 256, 0, s>>>(a.part_bad, a.bad, T,
                                                     items);
  return cudaGetLastError();
}

const char* instr_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
