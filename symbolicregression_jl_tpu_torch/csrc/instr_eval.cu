// Instruction-program scoring kernels for Hopper (sm_90a), value mode.
//
// Replace the Pallas TPU kernels of symbolicregression_jl_tpu/ops/
// pallas_eval.py `_make_instr_kernel` through `_eval_instr`:
//   instr_kernel<false>  (B5, program="instr"): seven per-step tables
//       (opcode; left source, index, constant; right source, index,
//       constant), each operand fetched by its source: a previous result, a
//       feature column of X, or the constant;
//   instr_kernel<true>   (B6, program="instr_packed"): one packed word per
//       step (opcode | lconst | rconst | lidx | ridx) plus the two constants,
//       over a unified operand space: features at [0, nfeat), results at
//       nfeat + k.
// For each of T operator-only programs (ops/kernel_instr.py
// instruction_schedule; trees sorted by instruction count) over X (nfeat,
// nrows) f32, run the program's n_instr steps on every row:
//   out[perm[g], row] = the last step's value (0 for an empty tree)
//                                                           -> (T, nrows) f32
//   bad[perm[g]] = 1 when a step's value or either operand was non-finite
//                                                           -> (T,) i32
// Each step applies the device function of csrc/operators.cuh that the
// postfix kernel (postfix_eval.cu) applies at the same node, to the same
// operand values, and both are built with the same flags: the values are
// bit-equal to the postfix kernel's value mode. A step's poison check on
// its operands covers the leaves, which the postfix kernel checks as slots.
//
// Layout (the postfix kernel's): one warp per tree, lanes stride the rows,
// so a step's opcode is uniform across the warp and the `switch` costs no
// divergence; the tree's tables are staged once in shared memory and the
// step loop runs to the tree's own n_instr; step results live in shared
// memory [step][thread] (B6: [nfeat + step][thread], the features of the
// lane's row loaded in front of them for each row). B5 reads a feature
// operand from X in global memory (consecutive lanes, consecutive rows).
// The TPU kernels' tree interleave, slot unroll and branchless candidate
// mux answer the TPU's scalar unit and are not carried over.
//
// Shared memory per warp: the staged tables (7 or 3 words per step) and 32
// lanes of scratch. The launcher takes as many warps per block, up to 8, as
// fit in the 227 KB a block may use, and refuses a layout that fits none.

#include <cuda_runtime.h>

#include "operators.cuh"

namespace {

using namespace srops;

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the most a block may use
constexpr int SRC_RES = 0, SRC_VAR = 1;  // else SRC_CONST

template <bool kPacked>
__host__ __device__ constexpr int tables_per_step() { return kPacked ? 3 : 7; }

template <bool kPacked>
int smem_bytes_per_warp(int L, int nfeat) {
  const int scratch = kPacked ? nfeat + L : L;
  return (tables_per_step<kPacked>() * L + 32 * scratch) * 4;
}

template <bool kPacked, bool kAll>
__global__ void instr_kernel(const int* __restrict__ code,
                             const int* __restrict__ lsrc,
                             const int* __restrict__ lidx,
                             const float* __restrict__ lcval,
                             const int* __restrict__ rsrc,
                             const int* __restrict__ ridx,
                             const float* __restrict__ rcval,
                             const int* __restrict__ n_instr,
                             const long long* __restrict__ perm,
                             const float* __restrict__ X,
                             float* __restrict__ out, int* __restrict__ bad,
                             int T, int L, int nfeat, int nrows) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tid = threadIdx.x;
  constexpr int kTables = tables_per_step<kPacked>();
  int* s_tab = smem + warp * kTables * L;
  int* s_code = s_tab;  // B6: the packed word
  float* s_lcval = reinterpret_cast<float*>(s_tab + L);
  float* s_rcval = reinterpret_cast<float*>(s_tab + 2 * L);
  int* s_lsrc = s_tab + 3 * L;  // B5 only: the four operand tables
  int* s_lidx = s_tab + 4 * L;
  int* s_rsrc = s_tab + 5 * L;
  int* s_ridx = s_tab + 6 * L;
  float* scratch = reinterpret_cast<float*>(smem + warps * kTables * L);
  const int base = kPacked ? nfeat : 0;  // scratch row of step 0's result

  const int g = blockIdx.x * warps + warp;
  if (g >= T) return;  // whole warp leaves; the block never syncs
  const long long t = perm[g];
  const int n = n_instr[g];
  for (int k = lane; k < n; k += 32) {
    const long long i = static_cast<long long>(g) * L + k;
    s_code[k] = code[i];
    s_lcval[k] = lcval[i];
    s_rcval[k] = rcval[i];
    if (!kPacked) {
      s_lsrc[k] = lsrc[i];
      s_lidx[k] = lidx[i];
      s_rsrc[k] = rsrc[i];
      s_ridx[k] = ridx[i];
    }
  }
  __syncwarp();

  bool poisoned = false;
  for (int row = lane; row < nrows; row += 32) {
    if (kPacked) {
      for (int f = 0; f < nfeat; ++f) {
        scratch[f * nthreads + tid] = X[static_cast<long long>(f) * nrows + row];
      }
    }
    for (int k = 0; k < n; ++k) {
      int c;
      float a, b;
      if (kPacked) {
        const int w = s_code[k];
        c = w & 0xFF;
        a = ((w >> 9) & 1) ? s_rcval[k]
                           : scratch[((w >> 21) & 0x7FF) * nthreads + tid];
        b = ((w >> 8) & 1) ? s_lcval[k]
                           : scratch[((w >> 10) & 0x7FF) * nthreads + tid];
      } else {
        c = s_code[k];
        const int rs = s_rsrc[k], ls = s_lsrc[k];
        a = rs == SRC_RES ? scratch[s_ridx[k] * nthreads + tid]
            : rs == SRC_VAR
                ? X[static_cast<long long>(s_ridx[k]) * nrows + row]
                : s_rcval[k];
        b = ls == SRC_RES ? scratch[s_lidx[k] * nthreads + tid]
            : ls == SRC_VAR
                ? X[static_cast<long long>(s_lidx[k]) * nrows + row]
                : s_lcval[k];
      }
      const float v =
          c >= OP_ADD ? apply_binary<kAll>(c, b, a) : apply_unary<kAll>(c, a);
      scratch[(base + k) * nthreads + tid] = v;
      poisoned |= !(isfinite(v) && isfinite(a) && isfinite(b));
    }
    out[t * nrows + row] = n > 0 ? scratch[(base + n - 1) * nthreads + tid] : 0.f;
  }
  const bool any_bad = __any_sync(0xffffffffu, poisoned);
  if (lane == 0) bad[t] = any_bad ? 1 : 0;
}

template <bool kPacked>
int warps_per_block(int L, int nfeat) {
  const int w = kMaxSmemBytes / smem_bytes_per_warp<kPacked>(L, nfeat);
  return w < kMaxWarpsPerBlock ? w : kMaxWarpsPerBlock;
}

template <bool kPacked, bool kAll>
cudaError_t launch(const void* code, const void* lsrc, const void* lidx,
                   const void* lcval, const void* rsrc, const void* ridx,
                   const void* rcval, const void* n_instr, const void* perm,
                   const void* X, void* out, void* bad, int T, int L,
                   int nfeat, int nrows, cudaStream_t stream) {
  const int warps = warps_per_block<kPacked>(L, nfeat);
  if (warps < 1) return cudaErrorInvalidValue;
  const int smem = warps * smem_bytes_per_warp<kPacked>(L, nfeat);
  cudaError_t err = cudaFuncSetAttribute(
      instr_kernel<kPacked, kAll>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int blocks = (T + warps - 1) / warps;
  instr_kernel<kPacked, kAll><<<blocks, warps * 32, smem, stream>>>(
      static_cast<const int*>(code), static_cast<const int*>(lsrc),
      static_cast<const int*>(lidx), static_cast<const float*>(lcval),
      static_cast<const int*>(rsrc), static_cast<const int*>(ridx),
      static_cast<const float*>(rcval), static_cast<const int*>(n_instr),
      static_cast<const long long*>(perm), static_cast<const float*>(X),
      static_cast<float*>(out), static_cast<int*>(bad), T, L, nfeat, nrows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Warps per block the launch takes for this layout (0: it does not fit).
int instr_eval_warps_per_block(int L, int nfeat, int packed) {
  return packed ? warps_per_block<true>(L, nfeat)
                : warps_per_block<false>(L, nfeat);
}

// all_ops: the batch uses an operator outside the common set, so the
// instantiation with every operator runs (operators.cuh)
cudaError_t instr_eval_launch(const void* code, const void* lsrc,
                              const void* lidx, const void* lcval,
                              const void* rsrc, const void* ridx,
                              const void* rcval, const void* n_instr,
                              const void* perm, const void* X, void* out,
                              void* bad, int T, int L, int nfeat, int nrows,
                              int packed, int all_ops, void* stream) {
  if (T <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run =
      packed ? (all_ops ? &launch<true, true> : &launch<true, false>)
             : (all_ops ? &launch<false, true> : &launch<false, false>);
  return run(code, lsrc, lidx, lcval, rsrc, ridx, rcval, n_instr, perm, X, out,
             bad, T, L, nfeat, nrows, s);
}

const char* instr_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
