// Fused Gaussian blur + per-keypoint patch gather: one BLURRED square patch
// per keypoint, without building the blurred image.
//
// Replaces the TPU kernel pilotguru_tpu/vo/patch_pallas.py::
// gather_blurred_patches_pallas (body _blur_patch_kernel). Same contract as
// the plain PyTorch version pilotguru_tpu_torch/vo/patch_kernel.py::
// gather_blurred_patches_plain. With s = 2 * radius + 1, n = 2 * br + 1 taps
// and (ys, xs) = yx[k] clamped into the image:
//   P(p, q)     = image[refl(clamp(p - radius, 0, h + 2 br - 1) - br),
//                       refl(clamp(q - radius, 0, w + 2 br - 1) - br)],
//                 the edge padding (by radius) of the reflect padding (by
//                 br, numpy's "reflect": the edge is not repeated);
//   vert(i, c)  = sum_u taps[u] * P(ys + i + u, xs + c),  c in [0, s + 2 br);
//   out[k,i,j]  = sum_v taps[v] * vert(i, j + v).
// Vertical pass first; each sum runs sequentially in tap order, multiply then
// add, with __fmul_rn / __fadd_rn so nvcc cannot contract them into FMAs:
// the kernel and the plain version agree bit for bit. Within br + radius of
// the border this differs from blur-then-gather by construction (the blur
// sees the edge-padded raw image), as the Pallas kernel does.
//
// What bounds it on the card: bytes. Per keypoint it reads a (s + 2 br)^2
// raw window (12.1 KB at radius 19, br 8), mostly from L2 since neighbouring
// windows overlap, and writes s * s floats (5.9 KB); the 17-tap passes cost
// about 125 kFLOP per keypoint, under a microsecond of the card's FP32 rate
// for a whole level. The design: one block per keypoint; the raw window and
// the vertical pass live in shared memory (20.7 KB), so only the window is
// read and only the patch is written. The index mapping replaces the padded
// image copy that the reference materialises.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 64;

__device__ __forceinline__ int padded_index(int p, int radius, int br, int n) {
  // Edge padding by `radius`, then numpy reflect padding by `br` (br < n).
  int q = min(max(p - radius, 0), n + 2 * br - 1) - br;
  if (q < 0) q = -q;
  if (q > n - 1) q = 2 * (n - 1) - q;
  return q;
}

__global__ void blur_patch_gather_kernel(const float* __restrict__ img,
                                         const int* __restrict__ yx,
                                         const float* __restrict__ taps,
                                         float* __restrict__ out,
                                         int h, int w, int radius, int br) {
  extern __shared__ float smem[];
  __shared__ float s_taps[kMaxTaps];
  const int k = blockIdx.x;
  const int s = 2 * radius + 1;
  const int ntaps = 2 * br + 1;
  const int win = s + 2 * br;
  float* s_win = smem;               // [win][win] raw window
  float* s_vert = smem + win * win;  // [s][win] vertical pass
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int ys = min(max(yx[2 * k], 0), h - 1);
  const int xs = min(max(yx[2 * k + 1], 0), w - 1);

  for (int i = tid; i < ntaps; i += nthreads) s_taps[i] = taps[i];
  for (int i = tid; i < win * win; i += nthreads) {
    const int a = i / win;
    const int b = i - a * win;
    const int gy = padded_index(ys + a, radius, br, h);
    const int gx = padded_index(xs + b, radius, br, w);
    s_win[i] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  for (int i = tid; i < s * win; i += nthreads) {
    const int r = i / win;
    const int c = i - r * win;
    float acc = __fmul_rn(s_taps[0], s_win[r * win + c]);
    for (int u = 1; u < ntaps; ++u) {
      acc = __fadd_rn(acc, __fmul_rn(s_taps[u], s_win[(r + u) * win + c]));
    }
    s_vert[i] = acc;
  }
  __syncthreads();

  float* dst = out + (size_t)k * s * s;
  for (int i = tid; i < s * s; i += nthreads) {
    const int r = i / s;
    const int c = i - r * s;
    const float* row = s_vert + r * win + c;
    float acc = __fmul_rn(s_taps[0], row[0]);
    for (int v = 1; v < ntaps; ++v) acc = __fadd_rn(acc, __fmul_rn(s_taps[v], row[v]));
    dst[i] = acc;
  }
}

}  // namespace

// img: [h, w] float32; yx: [k, 2] int32 (row, col); taps: [2 br + 1] float32;
// out: [k, s, s] float32 with s = 2 radius + 1; all contiguous on the device
// of `stream`. k >= 1, 2 br + 1 <= 64, br < min(h, w), and the window and the
// vertical pass fit in 48 KB of shared memory. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int pg_blur_patch_gather(const void* img, const void* yx,
                                    const void* taps, void* out, int h, int w,
                                    int k, int radius, int br, void* stream) {
  const int s = 2 * radius + 1;
  const int win = s + 2 * br;
  const size_t smem = sizeof(float) * (size_t)(win * win + s * win);
  blur_patch_gather_kernel<<<k, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(yx),
      static_cast<const float*>(taps), static_cast<float*>(out), h, w, radius, br);
  return static_cast<int>(cudaGetLastError());
}
