// The bfloat16 entry points of the fused batch norm + ReLU (bn_relu.cuh).

#include "bn_relu.cuh"

// y, the statistics and the running statistics of x (two launches).
extern "C" int pg_bn_relu_forward_bf16(const PgBn* args, void* stream) {
  return dispatch<bf16_bits, false>(args, stream);
}

// dx, dscale and dbias from g, x and the forward's statistics (two launches).
extern "C" int pg_bn_relu_backward_bf16(const PgBn* args, void* stream) {
  return dispatch<bf16_bits, true>(args, stream);
}
