// Min, max and sign with PyTorch's NaN semantics, shared by every kernel of
// csrc/.  fmax/fmin return the other operand when one is NaN; torch.maximum,
// torch.minimum, torch.amax/amin, torch.clamp and torch.sign (and their jnp
// counterparts in the JAX package) return NaN.  A kernel that dropped the NaN
// would floor or skip a bad cell and carry on with finite values where its
// plain version reports the failure, so every comparison and reduction here
// propagates it.  On finite operands the result is the same value fmax/fmin
// give.
#pragma once

#include <cuda_runtime.h>

namespace ath {

template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T tsign(T c) {
  return (c != c) ? c : T((c > T(0)) - (c < T(0)));
}

}  // namespace ath
