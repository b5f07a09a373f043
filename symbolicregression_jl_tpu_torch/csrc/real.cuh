// The compute type of a build of the port's kernels, and the spelling of
// its math: every operator, loss and sweep computes in SR_REAL, float in
// the float32, bfloat16 and float16 builds (SR_STORAGE 0, 1, 2) and double
// in the float64 build (SR_STORAGE 3: storage double and compute double).
// The macros expand to the float tokens the kernels were written in
// (SR_FN(exp) -> expf, SR_LIT(1.) -> 1.f, SR_RN(mul) -> __fmul_rn), so
// the float builds preprocess to the same tokens as before the compute
// type existed; in the double build they name the double functions,
// literals and round-to-nearest intrinsics.

#pragma once

#ifndef SR_STORAGE
#define SR_STORAGE 0
#endif

#if SR_STORAGE == 3
#define SR_REAL double
#define SR_FN(name) name
#define SR_LIT(x) x
#define SR_RN(op) __d##op##_rn
#define SR_FMA_RN __fma_rn
#else
#define SR_REAL float
#define SR_FN(name) name##f
#define SR_LIT(x) x##f
#define SR_RN(op) __f##op##_rn
#define SR_FMA_RN __fmaf_rn
#endif
