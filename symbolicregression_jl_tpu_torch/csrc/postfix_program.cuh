// The postfix program as a stack machine, shared by the scoring kernel
// (postfix_eval.cu) and the constant-optimisation kernels (postfix_grad.cu).
//
// derive_program turns one tree of the TreeBatch fields (kind, op, feat:
// int64 (T, L)) into one 64-bit word per slot in shared memory, in the
// kernel's prologue: the warp's lanes take one slot each and a shuffle scan
// of the arity deltas gives every slot's stack depth, so the host prepares
// no table. run_program then executes the words over kN values per lane
// (rows, or the line search's candidates, or both):
//  * the top of the stack lives in registers (the operand schedule's right
//    operand is always the previous slot), so a unary slot reads nothing
//    and a binary slot reads only its left operand from shared memory;
//  * a leaf pushes the old top to the entry at its depth, a binary slot
//    pops the entry just below the top: a valid program of L slots needs
//    (L + 1) / 2 entries (entry 0 takes the first leaf's push of nothing);
//  * one opcode read, one dispatch and one address serve all kN values,
//    and the kN operator evaluations are independent work;
//  * one switch over every opcode (leaves, unary, binary; numbered densely
//    by dense_code); each case runs its operator from csrc/operators.cuh
//    with a constant opcode, so the operator library's own switch folds
//    away.
// A non-finite value at a slot that is not PAD poisons the row: each value
// is folded into an accumulator as fma(v, 0, acc), which turns NaN for the
// first infinity or NaN and stays so.
// run_adjoint walks the same words backwards for the gradient kernel, the
// adjoint in registers as the top of the stack was.
//
// The storage type (SR_STORAGE, one per build: 0 float, 1 bfloat16, 2
// float16; the -D flag of ops/kernel_eval.py compile_library) is the type
// of X, y, the constants and the value outputs in device memory: a
// search's working dtype (Options.precision). Every operator runs in
// float32, and its result is rounded to the storage type where it is
// produced (round_s: round to nearest even, then back to float), so a
// value consumed straight from a register is already rounded; the
// poison test then sees the rounded value (f32 -> bf16 overflows near
// f32max, f32 -> f16 above 65,504). Leaves read values that the storage
// type holds exactly. What the kernels keep in shared or global scratch
// (stacks, slot values, results) stays float: it holds values of the
// storage type. In the float build Storage is float and round_s is the
// identity, so that build is the code it was. SR_STORAGE 3 is the float64
// build: storage and compute type (SR_REAL, csrc/real.cuh) are double,
// round_s is the identity, and every value in scratch is a double, so each
// launch layout counts 8 bytes per value (the *_bytes functions of the
// three sources, which the wrappers' plans read).

#pragma once

#include <cuda_runtime.h>

#ifndef SR_STORAGE
#define SR_STORAGE 0
#endif
#if SR_STORAGE == 1
#include <cuda_bf16.h>
#elif SR_STORAGE == 2
#include <cuda_fp16.h>
#elif SR_STORAGE != 0 && SR_STORAGE != 3
#error "SR_STORAGE must be 0 (float), 1 (bfloat16), 2 (float16) or 3 (double)"
#endif

#include "operators.cuh"

namespace srprog {

using namespace srops;

#if SR_STORAGE == 1
using Storage = __nv_bfloat16;
__device__ __forceinline__ SR_REAL to_f32(Storage x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ Storage from_f32(SR_REAL x) {
  return __float2bfloat16_rn(x);
}
#elif SR_STORAGE == 2
using Storage = __half;
__device__ __forceinline__ SR_REAL to_f32(Storage x) { return __half2float(x); }
__device__ __forceinline__ Storage from_f32(SR_REAL x) {
  return __float2half_rn(x);
}
#else
using Storage = SR_REAL;
__device__ __forceinline__ SR_REAL to_f32(Storage x) { return x; }
__device__ __forceinline__ Storage from_f32(SR_REAL x) { return x; }
#endif
#if SR_STORAGE == 3
constexpr bool kFloatStorage = true;  // storage is the compute type
#else
constexpr bool kFloatStorage = SR_STORAGE == 0;
#endif

// A value produced in float32, as the storage type holds it.
__device__ __forceinline__ SR_REAL round_s(SR_REAL x) {
  if constexpr (kFloatStorage) {
    return x;
  } else {
    return to_f32(from_f32(x));
  }
}

__device__ __forceinline__ void cp_async4(SR_REAL* dst, const SR_REAL* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

#if SR_STORAGE == 3
__device__ __forceinline__ void cp_async8(SR_REAL* dst, const SR_REAL* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
#endif

// One element of X into a block's staged float copy of X: cp.async in the
// float build (an 8-byte one in the float64 build), a load and a
// conversion in the 2-byte builds (so a 2-byte X of any row count needs no
// alignment rule).
__device__ __forceinline__ void stage_x(SR_REAL* dst, const Storage* src) {
#if SR_STORAGE == 0
  cp_async4(dst, src);
#elif SR_STORAGE == 3
  cp_async8(dst, src);
#else
  *dst = to_f32(*src);
#endif
}

// Writes kN values of one lane's consecutive rows at o (value outputs).
// With `aligned` every row is real and o is 4-element aligned: the float
// build writes one float4, the float64 build two double2, the 2-byte
// builds one 8-byte word per 4 rows.
template <int kN>
__device__ __forceinline__ void store_rows(Storage* o, const SR_REAL (&v)[kN],
                                           bool aligned, int real) {
#if SR_STORAGE == 3
  if constexpr (kN == 4) {
    if (aligned) {
      reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
      reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
      return;
    }
  }
#else
  if constexpr (kN == 4 && kFloatStorage) {
    if (aligned) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  } else if constexpr (kN == 4) {
    if (aligned) {
      alignas(8) Storage s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = from_f32(v[i]);
      *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(s);
      return;
    }
  }
#endif
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i < real) o[i] = from_f32(v[i]);
  }
}

// the TreeBatch node kinds (models/trees.py)
enum : int { KIND_PAD = 0, KIND_CONST = 1, KIND_VAR = 2, KIND_UNA = 3,
             KIND_BIN = 4 };

constexpr int kMaxOps = 64;

// The dense opcode (dense_code of the kernel operator id) of each unary,
// then each binary operator of the set.
struct OpMap {
  unsigned char code[kMaxOps];
  int n_unary;
  int n_ops;
};

// The words number the opcodes densely (leaves 0-2, unary 3-33, binary
// 34-45), so the slot loop's switch is over one dense range of cases; with
// the opcodes' own numbers (leaves, 10-40, 50-61) the compiler built a
// tree of compares and the kernels ran 2-8 % slower (PERF.md).
#ifndef SR_USER_OPS
__host__ __device__ constexpr int dense_code(int c) {
  return c < OP_COS ? c : (c < OP_ADD ? c - (OP_COS - 3)
                                      : c - (OP_ADD - (OP_GAMMA - OP_COS + 4)));
}
#else
// With user operators: leaves 0-2, registry unary 3-33, user unary 34 ..
// 33 + U, registry binary from 34 + U, user binary after them, so the unary
// and the binary codes each stay one range, the binary ones above the unary
// ones (ops/kernel_eval.py dense_code)
__host__ __device__ constexpr int dense_code(int c) {
  return c < OP_COS   ? c
         : c < OP_ADD ? c - (OP_COS - 3)
         : c < kUserUnaryBase
             ? c - OP_ADD + (OP_GAMMA - OP_COS + 4) + SR_USER_NUNARY
         : c < kUserBinaryBase
             ? c - kUserUnaryBase + (OP_GAMMA - OP_COS + 4)
             : c - kUserBinaryBase + (OP_GAMMA - OP_COS + 4) + SR_USER_NUNARY +
                   (OP_LOGICAL_AND - OP_ADD + 1);
}
#endif

// The launchers' OpMap from the operator ids of the set (host memory).
inline OpMap make_op_map(const int* ids, int n_unary, int n_binary) {
  OpMap m;
  for (int i = 0; i < kMaxOps; ++i) {
    m.code[i] = i < n_unary + n_binary
                    ? static_cast<unsigned char>(dense_code(ids[i]))
                    : 0xff;
  }
  m.n_unary = n_unary;
  m.n_ops = n_unary + n_binary;
  return m;
}

// A slot's word: x = dense opcode | stack entry << 8, y = feature (the
// gradient kernel's words put a binary slot's left operand or a CONST
// slot's rank there). A 24-bit entry and a 32-bit feature field: every
// max_len below 2^25 and every feature count fit (the launchers take
// max_len below 2^24).
__device__ __forceinline__ int word_code(int2 w) { return w.x & 0xff; }
__device__ __forceinline__ int word_entry(int2 w) {
  return static_cast<unsigned>(w.x) >> 8;
}
__device__ __forceinline__ int word_feat(int2 w) { return w.y; }

// Shared memory through 32-bit shared-window addresses: a kernel computes
// each base address once and hides how (opaque), so the compiler keeps it
// in a register: with plain pointers it recomputes them from the thread
// index and the CTA's shared window in every slot step, about 30 of a
// step's ~60 instructions in the SASS (PERF.md). The accesses are volatile
// asm, which the compiler keeps in program order; the stack's stores and
// later loads of the same entry rely on that.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned opaque(unsigned x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ int2 lds_word(unsigned a) {
  int2 w;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];" : "=r"(w.x), "=r"(w.y)
               : "r"(a));
  return w;
}
#if SR_STORAGE == 3
__device__ __forceinline__ double lds_f64(unsigned a) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];" : "=d"(v) : "r"(a));
  return v;
}
// one compute-type value from shared memory, a value's bytes, and the
// bytes of one value per lane of a warp
#define SR_LDS lds_f64
#define SR_RB 8u
#define SR_WARP_RB 256u
#else
__device__ __forceinline__ SR_REAL lds_f32(unsigned a) {
  SR_REAL v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}
#define SR_LDS lds_f32
#define SR_RB 4u
#define SR_WARP_RB 128u
#endif

// Writes the words of the program of n slots at kind/op/feat + base into
// s_word[0, n) and 0 into s_word[n] (the slot loop reads one word ahead).
// Returns, on every lane, whether the program is not a valid postfix
// program of the operator set within cap stack entries and nfeat features;
// such a program is not run and counts as poisoned.
__device__ __forceinline__ bool derive_program(
    const long long* __restrict__ kind, const long long* __restrict__ op,
    const long long* __restrict__ feat, long long base, int n, int cap,
    int nfeat, const OpMap& map, int2* s_word, int lane) {
  bool invalid = false;
  int depth = 0;  // stack depth before the chunk
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    const bool live = s < n;
    // the three loads are independent, so their latencies overlap
    const long long kl = live ? kind[base + s] : KIND_PAD;
    const long long o = live ? op[base + s] : 0;
    const long long fl = live ? feat[base + s] : 0;
    const int k = kl < KIND_PAD || kl > KIND_BIN ? -1 : static_cast<int>(kl);
    const int delta = !live ? 0 : (k == KIND_BIN ? -1 : (k == KIND_UNA ? 0 : 1));
    int incl = delta;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const int before = depth + incl - delta;
    depth += __shfl_sync(0xffffffffu, incl, 31);
    if (live) {
      int code = k, entry = 0, f = 0;
      if (k == KIND_UNA || k == KIND_BIN) {
        const int lo = k == KIND_UNA ? 0 : map.n_unary;
        const int hi = k == KIND_UNA ? map.n_unary : map.n_ops;
        const bool known_op = o >= 0 && o < hi - lo;
        code = known_op ? map.code[lo + o] : 0xff;
        entry = before - 1;  // a binary slot's left operand
        invalid |= !known_op || before < (k == KIND_UNA ? 1 : 2);
      } else {
        f = k == KIND_CONST ? 0 : static_cast<int>(fl);
        entry = before;  // where the leaf pushes the old top
        invalid |= k < 0 || before >= cap ||
                   (k != KIND_CONST && (fl < 0 || fl >= nfeat));
      }
      s_word[s] = make_int2(code | (entry << 8), f);
    }
  }
  if (lane == 0) s_word[n] = make_int2(0, 0);
  invalid |= n > 0 && depth != 1;
  return __any_sync(0xffffffffu, invalid);
}

// What the gradient kernel's sweeps need beside the words of a valid
// program of n slots (derive_program), written into the feature field,
// which both kinds leave 0:
//  * a binary slot's left operand, whose values the sweeps read from the
//    slot values (the forward sweep never names it: it is the old top that
//    the last leaf before the binary slot at the same stack entry pushed
//    there, so the slot just before that leaf);
//  * a CONST slot's rank among the CONST slots, the index of its
//    accumulator.
// The warp takes 32 slots at a time: __match_any_sync groups the lanes by
// entry, and s_last (one int per stack entry) carries each entry's last
// push into the next 32 slots.
__device__ __forceinline__ void derive_adjoint_words(int2* s_word, int n,
                                                     int* s_last, int lane) {
  int consts_before = 0;
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    const int2 w = s < n ? s_word[s] : make_int2(0, 0);
    const int code = word_code(w);
    const bool leaf = s < n && code <= OP_VAR;
    const bool bin = s < n && code >= dense_code(OP_ADD);
    const bool cst = s < n && code == OP_CONST;
    const int e = word_entry(w);
    const unsigned below = (1u << lane) - 1u;
    // lanes that are neither leaf nor binary each take a key of their own
    const unsigned same =
        __match_any_sync(0xffffffffu, leaf || bin ? e : -1 - lane);
    const unsigned leaves = __ballot_sync(0xffffffffu, leaf) & same;
    const unsigned consts = __ballot_sync(0xffffffffu, cst);
    // the leaf at bit b of `pushed` is slot s0 + b; its old top, s0 + b - 1
    const unsigned pushed = leaves & below;
    const int left =
        !bin ? 0 : (pushed ? s0 + 30 - __clz(pushed) : s_last[e]);
    __syncwarp();
    if (leaf && ((leaves >> lane) >> 1) == 0) s_last[e] = s - 1;
    if (bin) s_word[s].y = left;
    const int rank = consts_before + __popc(consts & below);
    if (cst) s_word[s].y = rank;
    consts_before += __popc(consts);
    __syncwarp();
  }
}

// Loads and stores of 1, 2 or 4 floats (1 or 2 doubles in the float64
// build) through a shared-window address (Mem<false>: 32-bit,
// ld/st.shared) or a generic address (Mem<true>: 64-bit, ld/st; a stack or
// slot values in global memory, or in shared memory reached generically).
// Volatile, so they stay in program order.
template <bool kGeneric>
struct Mem;

#if SR_STORAGE == 3
#define SR_MEM(GENERIC, ADDR, SPACE, C)                                      \
  template <>                                                                \
  struct Mem<GENERIC> {                                                      \
    using Addr = ADDR;                                                       \
    __device__ __forceinline__ static double ld1(Addr a) {                   \
      double v;                                                              \
      asm volatile("ld" SPACE ".f64 %0, [%1];" : "=d"(v) : C(a));            \
      return v;                                                              \
    }                                                                        \
    __device__ __forceinline__ static void st1(Addr a, double v) {           \
      asm volatile("st" SPACE ".f64 [%0], %1;" ::C(a), "d"(v));              \
    }                                                                        \
    __device__ __forceinline__ static void ld2(Addr a, double* v) {          \
      asm volatile("ld" SPACE ".v2.f64 {%0, %1}, [%2];"                      \
                   : "=d"(v[0]), "=d"(v[1]) : C(a));                         \
    }                                                                        \
    __device__ __forceinline__ static void st2(Addr a, const double* v) {    \
      asm volatile("st" SPACE ".v2.f64 [%0], {%1, %2};" ::C(a), "d"(v[0]),   \
                   "d"(v[1]));                                               \
    }                                                                        \
  };
#else

#define SR_MEM(GENERIC, ADDR, SPACE, C)                                      \
  template <>                                                                \
  struct Mem<GENERIC> {                                                      \
    using Addr = ADDR;                                                       \
    __device__ __forceinline__ static SR_REAL ld1(Addr a) {                    \
      SR_REAL v;                                                               \
      asm volatile("ld" SPACE ".f32 %0, [%1];" : "=f"(v) : C(a));            \
      return v;                                                              \
    }                                                                        \
    __device__ __forceinline__ static void st1(Addr a, SR_REAL v) {            \
      asm volatile("st" SPACE ".f32 [%0], %1;" ::C(a), "f"(v));              \
    }                                                                        \
    __device__ __forceinline__ static void ld2(Addr a, SR_REAL* v) {           \
      asm volatile("ld" SPACE ".v2.f32 {%0, %1}, [%2];"                      \
                   : "=f"(v[0]), "=f"(v[1]) : C(a));                         \
    }                                                                        \
    __device__ __forceinline__ static void st2(Addr a, const SR_REAL* v) {     \
      asm volatile("st" SPACE ".v2.f32 [%0], {%1, %2};" ::C(a), "f"(v[0]),   \
                   "f"(v[1]));                                               \
    }                                                                        \
    __device__ __forceinline__ static void ld4(Addr a, SR_REAL* v) {           \
      asm volatile("ld" SPACE ".v4.f32 {%0, %1, %2, %3}, [%4];"              \
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])          \
                   : C(a));                                                  \
    }                                                                        \
    __device__ __forceinline__ static void st4(Addr a, const SR_REAL* v) {     \
      asm volatile("st" SPACE ".v4.f32 [%0], {%1, %2, %3, %4};" ::C(a),      \
                   "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]));              \
    }                                                                        \
  };
#endif
SR_MEM(false, unsigned, ".shared", "r")
SR_MEM(true, unsigned long long, "", "l")
#undef SR_MEM

// The generic address of p.
__device__ __forceinline__ unsigned long long gen_u64(const void* p) {
  return reinterpret_cast<unsigned long long>(p);
}

// A stack entry holds kN floats per lane: [32 lanes][kN] for kN <= 4, and
// [kN / 4 planes][32 lanes][4] above, so every access is one conflict-free
// 8- or 16-byte access per lane (per plane). kGeneric: the entries are
// reached by generic addresses (the kernels' routes whose stack or slot
// values live in global memory). In the float64 build an entry is [32
// lanes][kN] doubles for every kN, a lane's values one or kN / 2 16-byte
// accesses, so a lane's values are consecutive as in a staged X.
#if SR_STORAGE == 3
template <int kN, bool kGeneric = false>
struct Stack {
  static_assert(kN == 1 || kN % 2 == 0, "one value or pairs per lane");
  using M = Mem<kGeneric>;
  using Addr = typename M::Addr;
  static constexpr int kLaneWidth = kN;
  static constexpr int kEntry = 32 * kN;  // doubles per entry
  static constexpr unsigned kEntryBytes = 8u * kEntry;

  __device__ __forceinline__ static void store(Addr e, const double (&v)[kN]) {
    if constexpr (kN == 1) {
      M::st1(e, v[0]);
    } else {
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) M::st2(e + j * 16, v + 2 * j);
    }
  }

  __device__ __forceinline__ static void load(Addr e, double (&v)[kN]) {
    if constexpr (kN == 1) {
      v[0] = M::ld1(e);
    } else {
#pragma unroll
      for (int j = 0; j < kN / 2; ++j) M::ld2(e + j * 16, v + 2 * j);
    }
  }
};
#else
template <int kN, bool kGeneric = false>
struct Stack {
  using M = Mem<kGeneric>;
  using Addr = typename M::Addr;
  static constexpr int kLaneWidth = kN < 4 ? kN : 4;
  static constexpr int kEntry = 32 * kN;  // floats per entry
  static constexpr unsigned kEntryBytes = 4u * kEntry;

  __device__ __forceinline__ static void store(Addr e, const SR_REAL (&v)[kN]) {
    if constexpr (kN == 1) {
      M::st1(e, v[0]);
    } else if constexpr (kN == 2) {
      M::st2(e, v);
    } else {
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) M::st4(e + j * 512, v + 4 * j);
    }
  }

  __device__ __forceinline__ static void load(Addr e, SR_REAL (&v)[kN]) {
    if constexpr (kN == 1) {
      v[0] = M::ld1(e);
    } else if constexpr (kN == 2) {
      M::ld2(e, v);
    } else {
#pragma unroll
      for (int j = 0; j < kN / 4; ++j) M::ld4(e + j * 512, v + 4 * j);
    }
  }
};
#endif

template <int kN>
__device__ __forceinline__ void poison(const SR_REAL (&v)[kN],
                                       SR_REAL (&pz)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) pz[i] = SR_FMA_RN(v[i], SR_LIT(0.), pz[i]);
}

// The operators of the compact instantiation, then the others (with the
// user operators of a -DSR_USER_OPS build, which only the full
// instantiation runs).
#ifdef SR_USER_OPS
#define SR_UNARY_USER_LIST(X) SR_UNARY_USER(X)
#define SR_BINARY_USER_LIST(X) SR_BINARY_USER(X)
#else
#define SR_UNARY_USER_LIST(X)
#define SR_BINARY_USER_LIST(X)
#endif
#define SR_UNARY_COMMON(X)                                                   \
  X(OP_COS) X(OP_SIN) X(OP_TAN) X(OP_EXP) X(OP_LOG) X(OP_LOG2) X(OP_LOG10)   \
  X(OP_LOG1P) X(OP_SQRT) X(OP_ABS) X(OP_SQUARE) X(OP_CUBE) X(OP_NEG)         \
  X(OP_RELU) X(OP_SINH) X(OP_COSH) X(OP_TANH) X(OP_SIGMOID) X(OP_INV)        \
  X(OP_IDENTITY) X(OP_SIGN) X(OP_GAUSS)
#define SR_UNARY_OTHER(X)                                                    \
  X(OP_ASIN) X(OP_ACOS) X(OP_ATAN) X(OP_ASINH) X(OP_ACOSH) X(OP_ATANH)       \
  X(OP_ERF) X(OP_ERFC) X(OP_GAMMA) SR_UNARY_USER_LIST(X)
#define SR_BINARY_COMMON(X)                                                  \
  X(OP_ADD) X(OP_SUB) X(OP_MUL) X(OP_DIV) X(OP_POW) X(OP_MAX) X(OP_MIN)
#define SR_BINARY_OTHER(X)                                                   \
  X(OP_MOD) X(OP_ATAN2) X(OP_GREATER) X(OP_LOGICAL_OR) X(OP_LOGICAL_AND)     \
  SR_BINARY_USER_LIST(X)

// Runs slots [0, n) of the program in s_word on kN values per lane. v holds
// the top of the stack: on return, the root. stack points at this lane's
// part of entry 0. const_leaf(s, v) and var_leaf(feature, v) give a leaf's
// values; on_step(s, v) sees every slot's values. kFromSlots (the gradient
// kernel, whose on_step stores every slot's values at stack + slot, and
// whose words name each binary slot's left operand, derive_adjoint_words):
// a binary slot reads its left operand there, and a leaf pushes nothing.
template <bool kAll, int kN, bool kFromSlots = false, bool kGeneric = false,
          class ConstLeaf, class VarLeaf, class OnStep>
__device__ __forceinline__ void run_program(
    unsigned s_word, int n, typename Stack<kN, kGeneric>::Addr stack,
    SR_REAL (&v)[kN], SR_REAL (&pz)[kN], ConstLeaf const_leaf, VarLeaf var_leaf,
    OnStep on_step) {
  using St = Stack<kN, kGeneric>;
  using Addr = typename St::Addr;
  int2 w = lds_word(s_word);
  for (int s = 0; s < n; ++s) {
    const int2 next = lds_word(s_word + 8 * (s + 1));
    const Addr e = stack + static_cast<Addr>(kFromSlots ? word_feat(w)
                                                        : word_entry(w)) *
                               St::kEntryBytes;
    SR_REAL l[kN];
#define SR_UNARY_CASE(OPC)                                                   \
  case dense_code(OPC):                                                      \
    _Pragma("unroll") for (int i = 0; i < kN; ++i) v[i] =                    \
        round_s(apply_unary<kAll>(OPC, v[i]));                               \
    poison(v, pz);                                                           \
    break;
#define SR_BINARY_CASE(OPC)                                                  \
  case dense_code(OPC):                                                      \
    St::load(e, l);                                                          \
    _Pragma("unroll") for (int i = 0; i < kN; ++i) v[i] =                    \
        round_s(apply_binary<kAll>(OPC, l[i], v[i]));                        \
    poison(v, pz);                                                           \
    break;
    switch (word_code(w)) {
      case OP_PAD:  // reads its feature like VAR and never poisons
        if constexpr (!kFromSlots) St::store(e, v);
        var_leaf(word_feat(w), v);
        break;
      case OP_CONST:
        if constexpr (!kFromSlots) St::store(e, v);
        const_leaf(s, v);
        poison(v, pz);
        break;
      case OP_VAR:
        if constexpr (!kFromSlots) St::store(e, v);
        var_leaf(word_feat(w), v);
        poison(v, pz);
        break;
      SR_UNARY_COMMON(SR_UNARY_CASE)
      SR_BINARY_COMMON(SR_BINARY_CASE)
      default:
        if constexpr (kAll) {
          switch (word_code(w)) {
            SR_UNARY_OTHER(SR_UNARY_CASE)
            SR_BINARY_OTHER(SR_BINARY_CASE)
            default:
#pragma unroll
              for (int i = 0; i < kN; ++i) v[i] = nanf_();
              poison(v, pz);
              break;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kN; ++i) v[i] = nanf_();
          poison(v, pz);
        }
        break;
    }
#undef SR_UNARY_CASE
#undef SR_BINARY_CASE
    on_step(s, v);
    w = next;
  }
}

// The adjoint sweep of the program in s_word (derive_adjoint_words) over kN
// values per lane, slots n - 1 down to 0. vals points at this lane's part
// of slot 0's values (one Stack entry per slot, as the forward sweep's
// on_step stored them); w holds the root's adjoint. Reverse postfix order
// visits a slot, then its right operand's subtree, then its left's, so:
//  * an operator slot's adjoint arrives in w from its one consumer, and
//    its right operand is the slot just below, whose adjoint it leaves in
//    w;
//  * a binary slot's left operand's adjoint waits until the right subtree
//    is done, when the leaf that pushed that operand in the forward sweep
//    (the right subtree's first slot, at the binary slot's stack entry e)
//    takes it back into w. It waits in the values of slot n - e: a slot at
//    or above the binary slot, whose values no later step reads (the
//    stack holds e + 1 entries there and must reduce to one, so at least
//    e - 1 binary slots follow), and a different slot for every waiting
//    adjoint;
//  * a leaf ends its path: const_leaf(rank, w) takes a CONST slot's
//    adjoint, a VAR's is dropped.
// The operand values are loaded a step ahead: slot s - 1's values are the
// right operand at slot s and the own values at slot s - 1. Slot 0, a leaf,
// is the last step, out of the loop: nothing waits for it.
template <bool kAll, int kN, bool kGeneric = false, class ConstLeaf>
__device__ __forceinline__ void run_adjoint(
    unsigned s_word, int n, typename Stack<kN, kGeneric>::Addr vals,
    SR_REAL (&w)[kN], ConstLeaf const_leaf) {
  using St = Stack<kN, kGeneric>;
  using Addr = typename St::Addr;
  constexpr unsigned kEntryBytes = St::kEntryBytes;
  SR_REAL v[kN];
  St::load(vals + static_cast<Addr>(n - 1) * kEntryBytes, v);
  int2 word = lds_word(s_word + 8 * (n - 1));
  for (int s = n - 1; s > 0; --s) {
    const int2 next = lds_word(s_word + 8 * (s - 1));
    SR_REAL a[kN];
    St::load(vals + static_cast<Addr>(s - 1) * kEntryBytes, a);
    // where the adjoint of the operand at the word's stack entry waits
    const Addr e =
        vals + static_cast<Addr>(n - word_entry(word)) * kEntryBytes;
#define SR_UNARY_ADJ(OPC)                                                    \
  case dense_code(OPC):                                                      \
    _Pragma("unroll") for (int i = 0; i < kN; ++i) w[i] =                    \
        unary_vjp<kAll>(OPC, a[i], v[i], w[i]);                              \
    break;
#define SR_BINARY_ADJ(OPC)                                                   \
  case dense_code(OPC): {                                                    \
    SR_REAL l[kN], dl[kN];                                                     \
    St::load(vals + static_cast<Addr>(word_feat(word)) * kEntryBytes, l);  \
    _Pragma("unroll") for (int i = 0; i < kN; ++i)                           \
        binary_vjp<kAll>(OPC, l[i], a[i], v[i], w[i], &dl[i], &w[i]);       \
    St::store(e, dl);                                                        \
    break;                                                                   \
  }
    switch (word_code(word)) {
      case OP_PAD:
      case OP_VAR:  // the left sibling's adjoint, which its consumer stored
        St::load(e, w);
        break;
      case OP_CONST:
        const_leaf(word_feat(word), w);
        St::load(e, w);
        break;
      SR_UNARY_COMMON(SR_UNARY_ADJ)
      SR_BINARY_COMMON(SR_BINARY_ADJ)
      default:
        if constexpr (kAll) {
          switch (word_code(word)) {
            SR_UNARY_OTHER(SR_UNARY_ADJ)
            SR_BINARY_OTHER(SR_BINARY_ADJ)
            default:
#pragma unroll
              for (int i = 0; i < kN; ++i) w[i] = nanf_();
              break;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kN; ++i) w[i] = nanf_();
        }
        break;
    }
#undef SR_UNARY_ADJ
#undef SR_BINARY_ADJ
#pragma unroll
    for (int i = 0; i < kN; ++i) v[i] = a[i];
    word = next;
  }
  // slot 0 of a valid program is its first leaf, whose path ends there
  if (word_code(word) == OP_CONST) const_leaf(word_feat(word), w);
}

// The launch layout of a kernel's narrow route: one value per lane, so the
// least shared memory per warp. Each warp's fixed part (its words and
// constants, fixed_bytes) stays in shared memory; its stack or slot values
// (scratch_bytes) too when one warp's both fit in a block's max_smem, else
// they go to global memory, one region per resident warp: the warps loop
// over the work, and the grid holds at most the warps whose scratch fits in
// kScratchBudget bytes (the L2 cache), but at least one warp per SM.
constexpr long long kScratchBudget = 32ll << 20;

struct NarrowPlan {
  long long warps, blocks_per_sm, smem, blocks, in_shared, scratch_bytes;
};

template <class Fn>
inline cudaError_t narrow_plan(Fn fn, long long work, long long fixed_bytes,
                               long long scratch_bytes, int max_warps,
                               long long max_smem, NarrowPlan* out) {
  const bool in_shared = fixed_bytes + scratch_bytes <= max_smem;
  const long long per_warp = fixed_bytes + (in_shared ? scratch_bytes : 0);
  if (per_warp > max_smem) return cudaErrorInvalidValue;
  int warps = max_warps;
  while (warps > 1 && per_warp * warps > max_smem) warps >>= 1;
  const int smem = static_cast<int>(per_warp * warps);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(max_smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, warps * 32, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  long long blocks = (work + warps - 1) / warps;
  if (!in_shared) {
    long long most = kScratchBudget / scratch_bytes;
    if (most < sms) most = sms;
    const long long resident = static_cast<long long>(occ) * warps * sms;
    if (most > resident) most = resident;
    const long long cap = (most + warps - 1) / warps;
    if (blocks > cap) blocks = cap;
  }
  *out = NarrowPlan{warps, occ, smem, blocks, in_shared ? 1 : 0,
                    in_shared ? 0 : blocks * warps * scratch_bytes};
  return cudaSuccess;
}

}  // namespace srprog
