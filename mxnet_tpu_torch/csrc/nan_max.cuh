// A max that keeps NaN, for the softmax kernels' running and cross-lane
// maxima.
//
// fmaxf (PTX max.f32) returns the other operand when one is NaN, so a row
// whose scores hold a NaN would take a finite max and, with a NaN sum,
// leave the kernels' `l > 0` epilogue writing zeros.  The reference's
// kernels reduce with jnp.max, and the plain versions with torch.amax,
// both of which return NaN; max.NaN.f32 (sm_80 and later, one
// instruction) does the same.  For operands that are not NaN it equals
// fmaxf, except perhaps for the sign of a zero, which no caller can see:
// the max is only ever subtracted from a score or added to a log.
#pragma once

__device__ __forceinline__ float fmax_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
