// FAST-9/16 corner response + 3x3 non-max suppression for one image.
//
// Replaces the TPU kernel pilotguru_tpu/vo/fast_pallas.py::fast_nms_pallas
// (body _fast_nms_kernel). Same contract as the plain PyTorch version
// pilotguru_tpu_torch/vo/fast_kernel.py::fast_nms_plain:
//   raw = FAST-9/16 SAD-over-threshold response where the 16-pixel circle
//         holds a run of >= 9 brighter or >= 9 darker pixels, with the
//         3-pixel image border zeroed;
//   nms = raw where raw >= max(3x3 neighbourhood of raw), else 0 (ties keep
//         the pixel).
//
// What bounds it on the card: memory. Per pixel it reads 4 bytes and writes
// 8; the 16 taps and the 3x3 window come out of shared memory. The design:
// one block per 32x32 output tile loads the tile plus a 4-pixel halo (3 for
// the circle, 1 for the NMS window) into shared memory once, with edge
// clamping on load; it computes the response for the tile plus a 1-pixel
// ring (so the NMS needs no second pass through device memory), zeroes the
// image border, and takes the 3x3 maximum from shared memory.
//
// The 16 taps are accumulated sequentially in FAST_CIRCLE order, as the
// Pallas body does and as fast_nms_plain does, so the kernel and the plain
// version agree bit for bit and the NMS support cannot flip on a near-tie.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 4;
constexpr int kIn = kTile + 2 * kHalo;  // 40: shared image tile side
constexpr int kScore = kTile + 2;       // 34: response tile side (1-px ring)

// FAST_CIRCLE of pilotguru_tpu/vo/features.py: (row, col) offsets, from 12
// o'clock clockwise. Bit t of a mask word is tap t.
__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ unsigned rot16(unsigned x, int k) {
  return ((x >> k) | (x << (16 - k))) & 0xFFFFu;
}

// >= 9 contiguous set bits on the 16-cycle: R_2k = R_k & rot(R_k, k).
__device__ __forceinline__ bool has_arc(unsigned p) {
  unsigned r2 = p & rot16(p, 1);
  unsigned r4 = r2 & rot16(r2, 2);
  unsigned r8 = r4 & rot16(r4, 4);
  return (r8 & rot16(p, 8)) != 0u;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ raw,
                                float* __restrict__ nms,
                                int h, int w, float thr) {
  __shared__ float s_img[kIn][kIn];
  __shared__ float s_score[kScore][kScore];

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int y0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  // Shared row r <-> global row y0 - kHalo + r (clamped into the image).
  for (int i = tid; i < kIn * kIn; i += nthreads) {
    const int r = i / kIn;
    const int c = i - r * kIn;
    const int gy = min(max(y0 - kHalo + r, 0), h - 1);
    const int gx = min(max(x0 - kHalo + c, 0), w - 1);
    s_img[r][c] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  // Response row r <-> global row y0 - 1 + r; its centre sits at shared
  // row r + 3. Pixels outside the 3-pixel border (and outside the image)
  // score 0: the border is zeroed before the NMS, exactly like the
  // reference, and scores are >= 0, so a 0 ring equals a -inf ring.
  for (int i = tid; i < kScore * kScore; i += nthreads) {
    const int r = i / kScore;
    const int c = i - r * kScore;
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    float z = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const float center = s_img[r + 3][c + 3];
      unsigned bright = 0u, dark = 0u;
      float bsum = 0.0f, dsum = 0.0f;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const float d = s_img[r + 3 + kCircleDy[t]][c + 3 + kCircleDx[t]] - center;
        if (d > thr) {
          bright |= 1u << t;
          bsum = __fadd_rn(bsum, __fsub_rn(d, thr));
        }
        if (d < -thr) {
          dark |= 1u << t;
          dsum = __fadd_rn(dsum, __fsub_rn(-d, thr));
        }
      }
      if (has_arc(bright) || has_arc(dark)) z = fmaxf(bsum, dsum);
    }
    s_score[r][c] = z;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nthreads) {
    const int r = i / kTile;
    const int c = i - r * kTile;
    const int gy = y0 + r;
    const int gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const float mid = s_score[r + 1][c + 1];
    float nbr = mid;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) nbr = fmaxf(nbr, s_score[r + dy][c + dx]);
    }
    const size_t o = (size_t)gy * w + gx;
    raw[o] = mid;
    nms[o] = mid >= nbr ? mid : 0.0f;
  }
}

}  // namespace

// img, raw, nms: [h, w] float32, contiguous, on the device of `stream`.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int pg_fast_nms(const void* img, void* raw, void* nms, int h, int w,
                           float threshold, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<float*>(raw),
      static_cast<float*>(nms), h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
