// The float32 entry points of the folded convolutions' backward
// (conv_bwd.cuh). Kernel size and stride are template parameters: only the
// pairs the foldable nets run are built.

#include "conv_bwd.cuh"

// dx from dy and the weights (one launch).
extern "C" int pg_conv_dgrad_f32(const PgConv* args, void* stream) {
  const PgConv& a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(a) || a.cin % 4 != 0 || (a.chunk != 12 && a.chunk != 16) || a.m % a.chunk != 0 ||
      a.rows < 1 || a.cols < 1 || a.rows * a.cols > 8 * a.long_threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int k = a.ksize, st = a.stride;
  if (k == 5 && st == 2) {
    return static_cast<int>(a.chunk == 12 ? dgrad<5, 2, 12>(a, s) : dgrad<5, 2, 16>(a, s));
  }
  if (a.chunk == 16 && k == 3 && st == 1) return static_cast<int>(dgrad<3, 1, 16>(a, s));
  if (a.chunk == 16 && k == 3 && st == 2) return static_cast<int>(dgrad<3, 2, 16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dW and db from x and dy (two launches: the partitions' partial products,
// then their sum in order).
extern "C" int pg_conv_wgrad_f32(const PgConv* args, void* stream) {
  const PgConv& a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const int k = a.ksize, st = a.stride;
  if (a.cin % 4 == 0) {
    if (k == 5 && st == 2) return static_cast<int>(wgrad<5, 2, 4>(a, s));
    if (k == 3 && st == 1) return static_cast<int>(wgrad<3, 1, 4>(a, s));
    if (k == 3 && st == 2) return static_cast<int>(wgrad<3, 2, 4>(a, s));
  } else {
    if (k == 5 && st == 2) return static_cast<int>(wgrad<5, 2, 1>(a, s));
    if (k == 8 && st == 4) return static_cast<int>(wgrad<8, 4, 1>(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
