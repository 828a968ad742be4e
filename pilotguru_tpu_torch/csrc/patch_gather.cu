// Per-keypoint square patch gather from an edge-padded image.
//
// Replaces the TPU kernel pilotguru_tpu/vo/patch_pallas.py::
// gather_patches_pallas (body _patch_kernel). Same contract as the plain
// PyTorch version pilotguru_tpu_torch/vo/patch_kernel.py::
// gather_patches_plain (and pilotguru_tpu/vo/features.py::extract_patches):
//   s = 2 * radius + 1, (ys, xs) = yx[k] clamped to [0, h-1] x [0, w-1]
//   (the start clamping of dynamic_slice on the padded image), and
//   out[k, i, j] = img[clamp(ys + i - radius, 0, h-1),
//                      clamp(xs + j - radius, 0, w-1)].
//
// What bounds it on the card: pure data movement, s*s*4 bytes written per
// keypoint (about 6 KB at radius 19) and as much read, mostly from L2 since
// neighbouring keypoints' windows overlap. The design: one block per
// keypoint; a warp walks a patch row, so reads of the image row and writes
// of the output row are each one coalesced run of s floats. The index
// clamping replaces the edge-padded copy of the image that the reference
// materialises, so nothing but the output is written.

#include <cuda_runtime.h>

namespace {

__global__ void gather_patches_kernel(const float* __restrict__ img,
                                      const int* __restrict__ yx,
                                      float* __restrict__ out,
                                      int h, int w, int radius) {
  const int k = blockIdx.x;
  const int s = 2 * radius + 1;
  const int ys = min(max(yx[2 * k], 0), h - 1) - radius;
  const int xs = min(max(yx[2 * k + 1], 0), w - 1) - radius;
  float* dst = out + (size_t)k * s * s;
  for (int i = threadIdx.y; i < s; i += blockDim.y) {
    const float* src = img + (size_t)min(max(ys + i, 0), h - 1) * w;
    for (int j = threadIdx.x; j < s; j += blockDim.x) {
      dst[i * s + j] = src[min(max(xs + j, 0), w - 1)];
    }
  }
}

}  // namespace

// img: [h, w] float32; yx: [k, 2] int32 (row, col); out: [k, s, s] float32;
// all contiguous on the device of `stream`. k >= 1. Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int pg_gather_patches(const void* img, const void* yx, void* out,
                                 int h, int w, int k, int radius, void* stream) {
  const dim3 block(32, 8);
  gather_patches_kernel<<<k, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(yx),
      static_cast<float*>(out), h, w, radius);
  return static_cast<int>(cudaGetLastError());
}
