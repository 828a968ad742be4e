// The float32 entry points of the fused batch norm + ReLU (bn_relu.cuh).

#include "bn_relu.cuh"

// y, the statistics and the running statistics of x (two launches).
extern "C" int pg_bn_relu_forward_f32(const PgBn* args, void* stream) {
  return dispatch<float, false>(args, stream);
}

// dx, dscale and dbias from g, x and the forward's statistics (two launches).
extern "C" int pg_bn_relu_backward_f32(const PgBn* args, void* stream) {
  return dispatch<float, true>(args, stream);
}
