// The JAX package's random stream on the card: threefry2x32 (20 rounds) in
// JAX's partitionable mode, one thread per (key, counter) pair, with the
// epilogue of each jax.random call the port makes.
//
// It replaces no Pallas kernel: it is the counterpart of XLA's
// threefry2x32 lowering, which the JAX package's every split and draw
// runs (symbolicregression_jl_tpu/models/mutate_device.py, evolve.py,
// population.py, fitness.py, constant_opt.py, parallel/migration.py).
// One launch serves one reference call, batched over every key it is
// given (every island, tournament, member and retry).
//
// Modes (the plain versions are in utils/rng.py):
//   0 split    out (nkeys, per_key, 2) int64: threefry2x32(key, (hi, lo))
//              of the counter offset + c (offset = data is fold_in)
//   1 bits     out (nkeys, per_key) int64: bits1 ^ bits2 cut to 8/16/32
//              bits, or bits1 << 32 | bits2 for 64
//   2 uniform  out of the dtype: mantissa bits under 1.0's exponent,
//              minus 1, fma(f, span, lo) rounded once, max(lo, .)
//   3 normal   sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))
//   4 gumbel   -log(-log(uniform(tiny, 1)))
//   5 randint  the reference's two 32-bit draws from split(key), reduced
//              modulo the span with its 2^32 multiplier; maxval from the
//              device when a pointer is given
//
// The float math is XLA's CPU op sequence, op for op (its LLVM IR and the
// multiply-adds its code generator contracts into FMA), written with
// explicit round-to-nearest intrinsics; the build passes -fmad=false so
// nothing else is contracted. float64 log is the one exception: the
// reference's is the C library's, the card's is CUDA's, which can differ
// in the last bit (utils/rng.py says where that shows).
//
// Bound: integer operations. A pair is ~140 32-bit integer operations
// (20 rounds of add / rotate / xor, 5 key injections), plus the epilogue;
// it reads its key once (16 bytes) and writes 2-16 bytes. At the main
// path's sizes (<= 10^6 pairs a launch) a per-call launch is
// latency-bound: the cycle draws through plan_kernel below instead, one
// launch per call site's draw plan, which walks the call site's split path
// per thread and makes every draw of it (a float32 and a float64
// instantiation, so the float32 path carries no float64 erf_inv).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#define SR_INF __int_as_float(0x7F800000)
#define SR_INF_D __longlong_as_double(0x7FF0000000000000LL)

namespace {

enum Mode { kSplit = 0, kBits = 1, kUniform = 2, kNormal = 3, kGumbel = 4,
            kRandint = 5 };
enum Dtype { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };
// a plan's kinds of draw (utils/rng.py DRAW_KINDS)
enum DrawKind { kDrawBits = 0, kDrawUniform = 1, kDrawNormal = 2,
                kDrawGumbel = 3, kDrawRandint = 4 };
constexpr int kAllDtypes = 7;  // float_epilogue's mask of every dtype

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// ---- XLA's CPU float32 log / log1p / erf_inv ------------------------------

__device__ __forceinline__ float xla_log_f32(float x) {
  const float p0 = 0x1.204376p-4f, p1 = -0x1.d7a37p-4f, p2 = 0x1.de4a34p-4f,
              p3 = -0x1.fcba9ep-4f, p4 = 0x1.23d37ep-3f, p5 = -0x1.555cap-3f,
              p6 = 0x1.999d58p-3f, p7 = -0x1.fffff8p-3f, p8 = 0x1.555554p-2f;
  const float q1 = -0x1.bd0106p-13f, q2 = 0x1.63p-1f;
  float xc = x <= 0x1p-126f ? 0x1p-126f : x;
  int bits = __float_as_int(xc);
  float e = __fadd_rn((float)((bits >> 23) - 127), 1.0f);
  float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);
  bool small = m < 0x1.6a09e6p-1f;
  float xm = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float z = __fmul_rn(xm, xm);
  float x3 = __fmul_rn(z, xm);
  float y = __fmaf_rn(xm, __fmaf_rn(xm, p0, p1), p2);
  float y1 = __fmaf_rn(xm, __fmaf_rn(xm, p3, p4), p5);
  float y2 = __fmaf_rn(xm, __fmaf_rn(xm, p6, p7), p8);
  y = __fmaf_rn(x3, __fmaf_rn(x3, y, y1), y2);
  y = __fmaf_rn(x3, y, __fmul_rn(e, q1));
  float r = __fadd_rn(__fmaf_rn(-z, 0.5f, xm), y);
  r = __fmaf_rn(e, q2, r);
  if (isnan(x) || x < 0.0f) return __int_as_float(0x7FC00000);
  if (x == 0.0f) return -SR_INF;
  if (isinf(x)) return SR_INF;
  return r;
}

__device__ __forceinline__ float xla_log1p_f32(float a) {
  const float den_c[6] = {0x1.e2035ap+3f, 0x1.4c30b6p+6f, 0x1.bb865ap+7f,
                          0x1.351946p+8f, 0x1.b0db14p+7f, 0x1.e0f304p+5f};
  const float num_c[7] = {0x1.7bc096p-15f, 0x1.fe818ap-2f, 0x1.a509f4p+2f,
                          0x1.de9738p+4f, 0x1.e798ecp+5f, 0x1.c8e75ap+5f,
                          0x1.40a202p+4f};
  if (!(fabsf(a) < 0x1.a8279ap-2f)) return xla_log_f32(__fadd_rn(a, 1.0f));
  float a2 = __fmul_rn(a, a);
  float zero = __fmul_rn(a, 0.0f);
  float den = __fadd_rn(zero, 1.0f);
#pragma unroll
  for (int i = 0; i < 6; ++i) den = __fmaf_rn(a, den, den_c[i]);
  float num = __fadd_rn(zero, num_c[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) num = __fmaf_rn(a, num, num_c[i]);
  float t = __fmul_rn(__fmul_rn(a, a2), __fdiv_rn(num, den));
  return __fadd_rn(a, __fmaf_rn(-a2, 0.5f, t));
}

__device__ __forceinline__ float xla_erfinv_f32(float x) {
  const float lt5[9] = {0x1.e2cb1p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a81p-10f,
                        -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  float lw = xla_log1p_f32(__fmul_rn(x, -x));  // -w
  bool lt = lw > -5.0f;
  float w = lt ? __fsub_rn(-2.5f, lw) : __fadd_rn(__fsqrt_rn(-lw), -3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(w, p, lt ? lt5[i] : ge5[i]);
  if (fabsf(x) == 1.0f) p = SR_INF;
  return __fmul_rn(x, p);
}

// ---- float64: XLA's log1p / erf_inv around CUDA's log ----------------------

__device__ __forceinline__ double xla_log1p_f64(double a) {
  const double den_c[6] = {
      __longlong_as_double(0x402E20359E903E37LL),
      __longlong_as_double(0x4054C30B52213498LL),
      __longlong_as_double(0x406BB86590FCFB56LL),
      __longlong_as_double(0x407351945DC908A5LL),
      __longlong_as_double(0x406B0DB13E48E066LL),
      __longlong_as_double(0x404E0F304466448ELL)};
  const double num_c[7] = {
      __longlong_as_double(0x3F07BC0962B395CALL),
      __longlong_as_double(0x3FDFE818A0FE1A83LL),
      __longlong_as_double(0x401A509F46F4FA53LL),
      __longlong_as_double(0x403DE9738B8CB9C9LL),
      __longlong_as_double(0x404E798EB86C3351LL),
      __longlong_as_double(0x404C8E7597479A10LL),
      __longlong_as_double(0x40340A202D99830ALL)};
  if (!(fabs(a) < __longlong_as_double(0x3FDA827999FCEF32LL)))
    return log(__dadd_rn(a, 1.0));
  double a2 = __dmul_rn(a, a);
  double zero = __dmul_rn(a, 0.0);
  double den = __dadd_rn(zero, 1.0);
  for (int i = 0; i < 6; ++i) den = __fma_rn(a, den, den_c[i]);
  double num = __dadd_rn(zero, num_c[0]);
  for (int i = 1; i < 7; ++i) num = __fma_rn(a, num, num_c[i]);
  double t = __dmul_rn(__dmul_rn(a, a2), __ddiv_rn(num, den));
  return __dadd_rn(a, __fma_rn(-a2, 0.5, t));
}

__constant__ unsigned long long kErfinvF64[23][3] = {
    {0xBBB135D2E746E627ULL, 0x3E23040F87DBD932ULL, 0xBDBDCEC3A7785389ULL},
    {0xBC08DDF93324D327ULL, 0x3E785CBE52878635ULL, 0xBDF18FEEC0E38727ULL},
    {0x3C37B83EEF0B7C9FULL, 0xBE92777453DD3955ULL, 0x3E19E6BF2DDA45E3ULL},
    {0x3C69BA72CD589B91ULL, 0x3E5395ABCD554C6CULL, 0xBE30468FB24E2F5FULL},
    {0xBCA33689090A6B96ULL, 0x3EB936388A3790ADULL, 0x3E405AC6A8FBA182ULL},
    {0x3C782E11898132E0ULL, 0xBED0D5DB812B5083ULL, 0xBE50102E495FB9C0ULL},
    {0x3CFDE4ACFD9E26BAULL, 0x3EC8860CD5D652F6ULL, 0x3E5F4C20E1334AF8ULL},
    {0xBD26D33EED66C487ULL, 0x3EEA29A0CACDFB23ULL, 0xBE722D220FDF9C3EULL},
    {0xBD36F2167040D8E2ULL, 0xBF08CEF1F80281F2ULL, 0x3E8EBC8BB824CB54ULL},
    {0x3D872A22C2D77E20ULL, 0x3F11E684D0B9188AULL, 0xBEB0A8D40EA372CCULL},
    {0xBDAC8859C4E5C0AFULL, 0x3EF932CD54C8A222ULL, 0x3ED2FBD29D093D2BULL},
    {0xBDCDC583D118A561ULL, 0xBF37448A89EF8AA3ULL, 0xBEF4A3497E1E0FACULL},
    {0x3E120F47CCF46B3CULL, 0x3F4F3CC55AD40C25ULL, 0x3F13EBF4EB00938FULL},
    {0xBE31A9E38DC84D60ULL, 0xBF5BA924132F38B1ULL, 0xBF2C2F36A8FC5D53ULL},
    {0xBE5F36CD6D3D46A9ULL, 0x3F6468EECA533CF8ULL, 0xBF222EA5DF04047CULL},
    {0x3E9C6B4F5D03B787ULL, 0xBF6EBADABB891BBDULL, 0x3FF02A30D1FBA0DCULL},
    {0xBEB6E8A5434AE8A2ULL, 0x3F75FFCFE5B76AFCULL, 0x4013664DDD1AD7FBULL},
    {0xBEED1D1F7B8736F6ULL, 0x3FF0158A6D641D39ULL, 0},
    {0x3F2879C2A212F024ULL, 0x4008ABCC380D5A48ULL, 0},
    {0xBF4845769484FCA8ULL, 0, 0},
    {0xBF78B6C33114F909ULL, 0, 0},
    {0x3FCEBD80D9B13E28ULL, 0, 0},
    {0x3FFA755E7C99AE86ULL, 0, 0}};

__device__ __forceinline__ double xla_erfinv_f64(double x) {
  double lw = xla_log1p_f64(__dmul_rn(x, -x));  // -w
  bool lt6 = lw > -6.25, lt16 = lw > -16.0;
  double w = lt6 ? __dsub_rn(-3.125, lw)
                 : __dsub_rn(__dsqrt_rn(-lw), lt16 ? 3.25 : 5.0);
  int col = lt6 ? 0 : (lt16 ? 1 : 2);
  double p = __longlong_as_double((long long)kErfinvF64[0][col]);
  for (int i = 1; i < 17; ++i)
    p = __fma_rn(w, p, __longlong_as_double((long long)kErfinvF64[i][col]));
  if (lt16)
    for (int i = 17; i < 19; ++i)
      p = __fma_rn(w, p, __longlong_as_double((long long)kErfinvF64[i][col]));
  if (lt6)
    for (int i = 19; i < 23; ++i)
      p = __fma_rn(w, p, __longlong_as_double((long long)kErfinvF64[i][0]));
  if (fabs(x) == 1.0) p = SR_INF_D;
  return __dmul_rn(x, p);
}

// ---- the unit interval of each dtype ---------------------------------------

// float32 in [0, 1) from 32 bits; float32 minus 1 of the 2-byte types'
// mantissa bits (bfloat16 takes 8 bits, float16 16)
__device__ __forceinline__ float unit_f32(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}
__device__ __forceinline__ float unit_bf16(uint32_t bits) {
  unsigned short h = (unsigned short)(((bits & 0xFFu) >> 1) | 0x3F80u);
  return __fsub_rn(__bfloat162float(__ushort_as_bfloat16(h)), 1.0f);
}
__device__ __forceinline__ float unit_f16(uint32_t bits) {
  unsigned short h = (unsigned short)(((bits & 0xFFFFu) >> 6) | 0x3C00u);
  return __fsub_rn(__half2float(__ushort_as_half(h)), 1.0f);
}
__device__ __forceinline__ double unit_f64(uint32_t b1, uint32_t b2) {
  unsigned long long bits = ((unsigned long long)b1 << 32) | b2;
  return __dsub_rn(
      __longlong_as_double((long long)((bits >> 12) | 0x3FF0000000000000ULL)),
      1.0);
}

__device__ __forceinline__ unsigned short to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned short to_f16_bits(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_f16(float v) {
  return __half2float(__float2half_rn(v));
}

// the float epilogue of element ``idx`` of a uniform, normal or gumbel draw
// from its two hash words, the one copy of it both kernels run: kMask
// enables the float64 (1), bfloat16 (2) and float16 (4) paths beside
// float32's. The 2-byte types compute in float32, rounded to the type
// where the reference's code rounds.
template <int kMask, typename Index>
__device__ __forceinline__ void float_epilogue(int kind, int dtype,
                                               uint32_t x1, uint32_t x2,
                                               double lo_d, double span_d,
                                               void* out, Index idx) {
  const uint32_t bits = x1 ^ x2;
  if ((kMask & 1) && dtype == kF64) {
    double u = fmax(lo_d, __fma_rn(unit_f64(x1, x2), span_d, lo_d));
    double v = u;
    if (kind == kDrawNormal)
      v = __dmul_rn(__longlong_as_double(0x3FF6A09E667F3BCDLL),
                    xla_erfinv_f64(u));
    else if (kind == kDrawGumbel)
      v = -log(-log(u));
    ((double*)out)[idx] = v;
    return;
  }
  const float lo = (float)lo_d, span = (float)span_d;
  if (((kMask & 6) == 0) || dtype == kF32) {
    float u = fmaxf(lo, __fmaf_rn(unit_f32(bits), span, lo));
    float v = u;
    if (kind == kDrawNormal)
      v = __fmul_rn(0x1.6a09e6p+0f, xla_erfinv_f32(u));
    else if (kind == kDrawGumbel)
      v = -xla_log_f32(-xla_log_f32(u));
    ((float*)out)[idx] = v;
    return;
  }
  const bool bf = (kMask & 2) && dtype == kBF16;
  float f = bf ? unit_bf16(bits) : unit_f16(bits);
  float u;
  if (kind == kDrawGumbel && !bf) {
    u = fmaxf(lo, f);  // XLA folds float16's (f * span + tiny) to f
  } else {
    float r = __fmaf_rn(f, span, lo);
    u = fmaxf(lo, bf ? round_bf16(r) : round_f16(r));
  }
  float v = u;
  if (kind == kDrawNormal) {
    float e = xla_erfinv_f32(u);
    e = bf ? round_bf16(e) : round_f16(e);
    const float s2 = bf ? round_bf16(1.41421356237309515f)
                        : round_f16(1.41421356237309515f);
    v = __fmul_rn(s2, e);
  } else if (kind == kDrawGumbel) {
    float l1 = -xla_log_f32(u);
    l1 = bf ? round_bf16(l1) : round_f16(l1);
    v = -xla_log_f32(l1);
  }
  ((unsigned short*)out)[idx] = bf ? to_bf16_bits(v) : to_f16_bits(v);
}

struct Args {
  const long long* keys;
  long long nkeys, key_stride, per_key, offset;
  int mode, dtype, width;
  double lo, span;       // uniform's bounds, already in the dtype
  long long imin, imax;  // randint
  const long long* imax_ptr;
  void* out;
};

__global__ void threefry_kernel(Args a) {
  const long long total = a.nkeys * a.per_key;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / a.per_key;
    const unsigned long long c =
        (unsigned long long)(t - b * a.per_key) + (unsigned long long)a.offset;
    const long long* kp = a.keys + b * a.key_stride;
    uint32_t k1 = (uint32_t)kp[0], k2 = (uint32_t)kp[1];
    if (a.mode == kRandint) {
      uint32_t h1 = 0, h2 = 0, l1 = 0, l2 = 1;
      threefry2x32(k1, k2, h1, h2);  // split(key)[0]
      threefry2x32(k1, k2, l1, l2);  // split(key)[1]
      uint32_t x1 = (uint32_t)(c >> 32), x2 = (uint32_t)c;
      uint32_t y1 = x1, y2 = x2;
      threefry2x32(h1, h2, x1, x2);
      threefry2x32(l1, l2, y1, y2);
      uint32_t hi_bits = x1 ^ x2, lo_bits = y1 ^ y2;
      long long maxv = a.imax_ptr ? *a.imax_ptr : a.imax;
      maxv = maxv > 2147483647LL ? 2147483647LL
                                 : (maxv < -2147483648LL ? -2147483648LL : maxv);
      uint32_t span = maxv <= a.imin ? 1u : (uint32_t)(maxv - a.imin);
      uint32_t mult = 65536u % span;
      mult = (mult * mult) % span;
      uint32_t off = (hi_bits % span) * mult + lo_bits % span;
      ((long long*)a.out)[t] = a.imin + (long long)(off % span);
      continue;
    }
    uint32_t x1 = (uint32_t)(c >> 32), x2 = (uint32_t)c;
    threefry2x32(k1, k2, x1, x2);
    if (a.mode == kSplit) {
      ((long long*)a.out)[2 * t] = x1;
      ((long long*)a.out)[2 * t + 1] = x2;
      continue;
    }
    if (a.mode == kBits) {
      long long v;
      if (a.width == 64)
        v = (long long)(((unsigned long long)x1 << 32) | x2);
      else
        v = (long long)((x1 ^ x2) &
                        (a.width == 32 ? 0xFFFFFFFFu
                                       : ((1u << a.width) - 1u)));
      ((long long*)a.out)[t] = v;
      continue;
    }
    float_epilogue<kAllDtypes>(a.mode - kUniform + kDrawUniform, a.dtype, x1,
                               x2, a.lo, a.span, a.out, t);
  }
}

// ---- draw plans: every split and draw of one call site in one launch ------
//
// The host (utils/rng.py DrawPlan) compiles a call site's static split path
// into a table of ops, 18 int32 words each, the same for every thread:
//   node  [0, allow, dst slot, src slot, counter, fan axis]
//         key[dst] = threefry2x32(key[src], (0, counter)), or with a fan axis
//         the thread's index on that axis as the counter (slot -1 = root)
//   draw  [1, allow, kind, src slot, n, element axis, buffer, column, level,
//          width or dtype, bound index, lo (2 words), span (2 words), imin,
//          imax]
//         the n elements of the draw from key[src]; with an element axis a
//         the thread takes elements i_a, i_a + F_a, ...; else all of them
//   keep  [2, allow, -, src slot, 2, 0, buffer, column, level]
// An op runs in a thread when the thread's nonzero fan-out indices all lie
// on the op's allowed axes (bit a for axis a), so a draw of level l is made
// once per (root, i_1..i_l) and a node only where something below needs it.
// Element c of a draw at level l lands at
//   out[buffer] + ((root * F_1 + i_1) ... * F_l + i_l) * sp[buffer]
//              + (column + c) * sc[buffer],
// a buffer row-major (sc = 1) or column-major (sp = 1) so that a warp's
// stores are adjacent.
// Threads are (root, i_1, ..., i_m), the last axis fastest. Keys live in
// shared memory by slot (the host sizes it to the slots the table uses; in
// local memory a full card's threads overflowed L1), the thread's indices
// in registers; 32-bit indices throughout (the host refuses plans of 2^31
// threads or elements). The plan's draws are float32 or float64 (the
// search draws in no other dtype; the host refuses a 2-byte draw on the
// card), so there are two instantiations, and the float32 one carries no
// float64 erf_inv.

constexpr int kOpWords = 18;
constexpr int kMaxSlots = 24;  // 24 x 2 words x 256 threads: 48 KB
constexpr int kMaxAxes = 3;
constexpr int kMaxBuffers = 16;
constexpr int kMaxBounds = 4;

struct PlanArgs {
  const long long* roots;
  int root_stride, naxes, nops;
  int axes[kMaxAxes];
  const int* ops;
  void* out[kMaxBuffers];
  int sp[kMaxBuffers], sc[kMaxBuffers];  // strides of a prefix, a column
  const long long* bound[kMaxBounds];
};

// one of four per-thread values by a run-time index, kept in registers
__device__ __forceinline__ int pick4(int i, int v0, int v1, int v2, int v3) {
  return i == 0 ? v0 : (i == 1 ? v1 : (i == 2 ? v2 : v3));
}

template <int kMask>
__global__ void __launch_bounds__(256) plan_kernel(PlanArgs a, int nthreads) {
  // the key slots: [slot][word][thread of the block] in shared memory, so
  // a warp's reads and writes of a slot are conflict-free and the slots
  // of every resident thread stay on the SM
  extern __shared__ uint32_t slots[];
  uint32_t* const s1 = slots + threadIdx.x;
  uint32_t* const s2 = slots + 256 + threadIdx.x;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nthreads) return;
  // (root, i_1..i_m) of the thread, the prefix index of each level and the
  // axes on which its index is nonzero
  int i1 = 0, i2 = 0, i3 = 0, rem = t;
  for (int l = a.naxes; l >= 1; --l) {
    const int f = a.axes[l - 1];
    const int q = rem / f;
    const int i = rem - q * f;
    i1 = l == 1 ? i : i1;
    i2 = l == 2 ? i : i2;
    i3 = l == 3 ? i : i3;
    rem = q;
  }
  const int p0 = rem;
  const int p1 = a.naxes >= 1 ? p0 * a.axes[0] + i1 : p0;
  const int p2 = a.naxes >= 2 ? p1 * a.axes[1] + i2 : p1;
  const int p3 = a.naxes >= 3 ? p2 * a.axes[2] + i3 : p2;
  const int nz = (i1 ? 2 : 0) | (i2 ? 4 : 0) | (i3 ? 8 : 0);
  const long long* kp = a.roots + (long long)rem * a.root_stride;
  const uint32_t r1 = (uint32_t)kp[0], r2 = (uint32_t)kp[1];
  for (int o = 0; o < a.nops; ++o) {
    const int* w = a.ops + o * kOpWords;
    if (nz & ~__ldg(w + 1)) continue;
    const int type = __ldg(w), src = __ldg(w + 3);
    const uint32_t k1 = src < 0 ? r1 : s1[src * 512];
    const uint32_t k2 = src < 0 ? r2 : s2[src * 512];
    if (type == 0) {
      const int axis = __ldg(w + 5);
      uint32_t x1 = 0, x2 = axis ? (uint32_t)pick4(axis, 0, i1, i2, i3)
                                 : (uint32_t)__ldg(w + 4);
      threefry2x32(k1, k2, x1, x2);
      const int dst = __ldg(w + 2);
      s1[dst * 512] = x1;
      s2[dst * 512] = x2;
      continue;
    }
    const int b = __ldg(w + 6), level = __ldg(w + 8);
    const unsigned sc = (unsigned)a.sc[b];
    const unsigned base =
        (unsigned)pick4(level, p0, p1, p2, p3) * (unsigned)a.sp[b] +
        (unsigned)__ldg(w + 7) * sc;
    if (type == 2) {
      ((long long*)a.out[b])[base] = k1;
      ((long long*)a.out[b])[base + sc] = k2;
      continue;
    }
    const int kind = __ldg(w + 2), n = __ldg(w + 4), eaxis = __ldg(w + 5);
    const int c0 = pick4(eaxis, 0, i1, i2, i3);
    const int step = eaxis ? a.axes[eaxis - 1] : 1;
    if (kind == 4) {  // randint: split(key) once, two 32-bit draws a value
      uint32_t h1 = 0, h2 = 0, l1 = 0, l2 = 1;
      threefry2x32(k1, k2, h1, h2);
      threefry2x32(k1, k2, l1, l2);
      const int bi = __ldg(w + 10), imin = __ldg(w + 15);
      long long maxv = bi >= 0 ? *a.bound[bi] : (long long)__ldg(w + 16);
      maxv = maxv > 2147483647LL ? 2147483647LL
                                 : (maxv < -2147483648LL ? -2147483648LL : maxv);
      const uint32_t span = maxv <= imin ? 1u : (uint32_t)(maxv - imin);
      uint32_t mult = 65536u % span;
      mult = (mult * mult) % span;
      for (int c = c0; c < n; c += step) {
        uint32_t x1 = 0, x2 = (uint32_t)c, y1 = 0, y2 = (uint32_t)c;
        threefry2x32(h1, h2, x1, x2);
        threefry2x32(l1, l2, y1, y2);
        const uint32_t off = ((x1 ^ x2) % span) * mult + (y1 ^ y2) % span;
        ((long long*)a.out[b])[base + c * sc] = imin + (long long)(off % span);
      }
      continue;
    }
    if (kind == 0) {  // bits
      const int width = __ldg(w + 9);
      for (int c = c0; c < n; c += step) {
        uint32_t x1 = 0, x2 = (uint32_t)c;
        threefry2x32(k1, k2, x1, x2);
        long long v;
        if (width == 64)
          v = (long long)(((unsigned long long)x1 << 32) | x2);
        else
          v = (long long)((x1 ^ x2) &
                          (width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u)));
        ((long long*)a.out[b])[base + c * sc] = v;
      }
      continue;
    }
    const int dtype = __ldg(w + 9);
    const double lo = __hiloint2double(__ldg(w + 12), __ldg(w + 11));
    const double span = __hiloint2double(__ldg(w + 14), __ldg(w + 13));
    for (int c = c0; c < n; c += step) {
      uint32_t x1 = 0, x2 = (uint32_t)c;
      threefry2x32(k1, k2, x1, x2);
      float_epilogue<kMask>(kind, dtype, x1, x2, lo, span, a.out[b],
                            base + c * sc);
    }
  }
}

int grid_for(long long total) {
  long long g = (total + 255) / 256;
  const long long cap = 132LL * 32;
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" {

int threefry_launch(const long long* keys, long long nkeys,
                    long long key_stride, long long per_key,
                    long long offset, int mode, int dtype, int width,
                    double lo, double span, long long imin, long long imax,
                    const long long* imax_ptr, void* out, void* stream) {
  const long long total = nkeys * per_key;
  if (total <= 0) return 0;
  Args a{keys, nkeys, key_stride, per_key, offset, mode, dtype, width,
         lo,   span,  imin,       imax,    imax_ptr, out};
  threefry_kernel<<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// a draw plan's launch: ``axes`` (naxes sizes), ``outs`` / ``strides``
// (nbuf buffers and, for each, the strides in elements of a prefix and of
// a column), ``bounds`` (nbound device scalars) are host arrays read here;
// ``ops`` is the op table of nops ops on the card; ``mask`` picks the
// instantiation: 1 where the plan draws in float64, else 0
int threefry_plan_launch(const long long* roots, int nroots, int root_stride,
                         int naxes, const int* axes, const int* ops, int nops,
                         int nslots, int nbuf, void* const* outs,
                         const int* strides, int nbound,
                         const long long* const* bounds, int mask,
                         void* stream) {
  if (naxes > kMaxAxes || nbuf > kMaxBuffers || nbound > kMaxBounds ||
      nops < 0 || nslots < 0 || nslots > kMaxSlots || mask < 0 || mask > 1)
    return (int)cudaErrorInvalidValue;
  PlanArgs a{};
  a.roots = roots;
  a.root_stride = root_stride;
  a.naxes = naxes;
  a.nops = nops;
  a.ops = ops;
  long long total = nroots;
  for (int i = 0; i < naxes; ++i) {
    a.axes[i] = axes[i];
    total *= axes[i];
  }
  if (total <= 0) return 0;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nbuf; ++i) {
    a.out[i] = outs[i];
    a.sp[i] = strides[2 * i];
    a.sc[i] = strides[2 * i + 1];
  }
  for (int i = 0; i < nbound; ++i) a.bound[i] = bounds[i];
  const int nt = (int)total;
  const int grid = (nt + 255) / 256;
  const size_t smem = (size_t)nslots * 2 * 256 * sizeof(uint32_t);
  cudaStream_t s = (cudaStream_t)stream;
  if (mask)
    plan_kernel<1><<<grid, 256, smem, s>>>(a, nt);
  else
    plan_kernel<0><<<grid, 256, smem, s>>>(a, nt);
  return (int)cudaGetLastError();
}

const char* threefry_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
