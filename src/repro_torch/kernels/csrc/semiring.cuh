// Semiring functors shared by the SpMV kernels of repro_torch.
//
// Each kernel that serves graph analytics is a template over one of these
// (⊕, ⊗) pairs; `SEMIRING_DISPATCH` turns the runtime code of
// `repro_torch.graph.semiring.Semiring.code` into the instantiation.
// Products and sums are rounded one at a time (__fmul_rn / __fadd_rn), so
// the compiler never contracts them into an FMA: a kernel rounds exactly
// where its plain PyTorch version rounds.
#pragma once

#include <math.h>

#include "common.cuh"

struct PlusTimes {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

struct MinPlus {
  static __device__ __forceinline__ float identity() { return INFINITY; }
  static __device__ __forceinline__ float add(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fadd_rn(a, b); }
};

// or_and over {0, 1} indicators: AND is *, OR is max.
struct OrAnd {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

// max_times is a semiring over nonnegative values only (identity 0).
struct MaxTimes {
  static __device__ __forceinline__ float identity() { return 0.0f; }
  static __device__ __forceinline__ float add(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
};

// Codes match Semiring.code on the Python side.
#define SEMIRING_DISPATCH(code, SR, ...)          \
  switch (code) {                                 \
    case 0: { using SR = PlusTimes; __VA_ARGS__; break; } \
    case 1: { using SR = MinPlus; __VA_ARGS__; break; }   \
    case 2: { using SR = OrAnd; __VA_ARGS__; break; }     \
    case 3: { using SR = MaxTimes; __VA_ARGS__; break; }  \
    default: return (int)cudaErrorInvalidValue;   \
  }
