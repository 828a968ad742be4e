// Fused Gaussian blur + per-keypoint patch gather: one BLURRED square patch
// per keypoint, without building the blurred image; for one image or for
// every level of an image pyramid in one launch.
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
// The one shape the extractor uses is compiled in: radius 19, br 8 (17 taps,
// a 55x55 raw window, a 39x39 patch). Any other shape is refused by the
// wrapper.
//
// What bounds it on an H100: float32 instruction issue and, before this
// design, shared-memory reads. A keypoint moves 18 KB at most (12.1 KB of
// raw window, mostly from L2 since neighbouring windows overlap, and 5.9 KB
// of patch) but costs 62,322 multiplies and 58,656 adds, which may not fuse:
// at half the card's float32 peak that is 1.6 us for 434 keypoints, level
// with the bytes (1.6 us), and 7.2 us for a frame's 2000. Measured (80GB
// HBM3, 700 W; chip_smoke.py): 6.5 us and 20.5 us, where the kernel that
// read tap and pixel from shared memory for every multiply-add took 16.2 us
// for 434. At 434 keypoints the card holds every block at once (3.3 to an
// SM) and the time is one block's chain of load, two passes and store.
// Tensor cores are out: the two passes as banded matrix products would round
// the pixels to TF32 (or split them and change the order of the sums), and
// the extractor's parity rests on equal bits: the NMS, orientation-bin and
// BRIEF comparisons downstream flip on the last one. What the design does:
//   * Register sliding windows. In the vertical pass a thread owns one column
//     of the window and a run of kRunV output rows: it reads its kRunV + 16
//     inputs from shared memory once and keeps them in registers, so a
//     multiply-add costs about 0.1 shared reads instead of 2. The horizontal
//     pass does the same along rows of the vertical result. Every output's
//     sum is still taken in tap order.
//   * Everything is a compile-time constant: the loops are unrolled, the taps
//     come with the launch parameters (constant-bank operands of the
//     multiplies) and no run-time division remains.
//   * The window's row stride is odd (55), so column walks and row walks of
//     32 lanes do not conflict in shared memory; the patch goes through
//     shared memory once more so that its global writes are coalesced.
//   * One launch covers all levels: a table of levels comes by value and a
//     block finds its level from its keypoint index.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 19;
constexpr int kBlur = 8;
constexpr int kSize = 2 * kRadius + 1;   // 39: patch side
constexpr int kTaps = 2 * kBlur + 1;     // 17
constexpr int kWin = kSize + 2 * kBlur;  // 55: raw window side
constexpr int kRunV = 20;  // output rows per thread, vertical pass
constexpr int kRunH = 13;  // output columns per thread, horizontal pass
constexpr int kThreads = 128;
constexpr int kRunsV = (kSize + kRunV - 1) / kRunV;
constexpr int kRunsH = (kSize + kRunH - 1) / kRunH;
constexpr int kMaxLevels = 8;

static_assert(kRunV <= kSize && kRunH <= kSize, "a run is at most one patch side");
static_assert(kSize * kSize <= kWin * kWin, "the patch reuses the window's cells");

// The levels of one launch. Level l owns keypoints first_keypoint[l] ..
// first_keypoint[l + 1] - 1; unused entries have first_keypoint = INT_MAX.
struct BlurLevels {
  const float* img[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int first_keypoint[kMaxLevels];
  float taps[kTaps];
};

__device__ __forceinline__ int padded_index(int p, int n) {
  // Edge padding by kRadius, then numpy reflect padding by kBlur (kBlur < n).
  int q = min(max(p - kRadius, 0), n + 2 * kBlur - 1) - kBlur;
  if (q < 0) q = -q;
  if (q > n - 1) q = 2 * (n - 1) - q;
  return q;
}

// kRun consecutive outputs of a 17-tap blur along a line of shared memory
// with element stride `stride`: out[i] = sum_u taps[u] * in[(i + u) * stride],
// each sum in tap order, multiply then add.
template <int kRun>
__device__ __forceinline__ void blur_run(const float* __restrict__ in, int stride,
                                         const BlurLevels& levels, float (&out)[kRun]) {
  float v[kRun + kTaps - 1];
#pragma unroll
  for (int j = 0; j < kRun + kTaps - 1; ++j) v[j] = in[j * stride];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    float acc = __fmul_rn(levels.taps[0], v[i]);
#pragma unroll
    for (int u = 1; u < kTaps; ++u) {
      acc = __fadd_rn(acc, __fmul_rn(levels.taps[u], v[i + u]));
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
blur_patch_gather_kernel(const __grid_constant__ BlurLevels levels, const int* __restrict__ yx,
                         float* __restrict__ out) {
  __shared__ float s_win[kWin * kWin];    // raw window, then the patch
  __shared__ float s_vert[kSize * kWin];  // vertical pass
  const int k = blockIdx.x;
  const int tid = threadIdx.x;

  // This block's level: the last one whose first keypoint is not past it.
  // The table is indexed with constants only, so it stays in the parameter
  // bank.
  const float* __restrict__ img = levels.img[0];
  int h = levels.h[0], w = levels.w[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (k >= levels.first_keypoint[l]) {
      img = levels.img[l];
      h = levels.h[l];
      w = levels.w[l];
    }
  }
  const int ys = min(max(yx[2 * k], 0), h - 1);
  const int xs = min(max(yx[2 * k + 1], 0), w - 1);

  // Raw window: lane = column (64 lanes to a row group, 55 in use), so a
  // row's reads are neighbours in the image.
  // A window whose rows all lie inside the image (most do) walks them by
  // pointer; one that crosses the top or bottom border maps each row.
  {
    const int b = tid & 63;
    if (b < kWin) {
      const int gx = padded_index(xs + b, w);
      const int a0 = tid >> 6;
      if (ys >= kRadius + kBlur && ys < h - kRadius - kBlur) {
        const float* src = img + (size_t)(ys - kRadius - kBlur + a0) * w + gx;
#pragma unroll
        for (int a = a0; a < kWin; a += kThreads / 64) {
          s_win[a * kWin + b] = *src;
          src += (size_t)(kThreads / 64) * w;
        }
      } else {
#pragma unroll
        for (int a = a0; a < kWin; a += kThreads / 64) {
          const int gy = padded_index(ys + a, h);
          s_win[a * kWin + b] = img[(size_t)gy * w + gx];
        }
      }
    }
  }
  __syncthreads();

  // Vertical pass: thread = (run of rows, column). The last run is moved up
  // to end at the last row; the rows it shares with the run before get the
  // same values twice.
  if (tid < kRunsV * kWin) {
    const int run = tid / kWin;
    const int c = tid - run * kWin;
    const int r0 = min(run * kRunV, kSize - kRunV);
    float acc[kRunV];
    blur_run<kRunV>(&s_win[r0 * kWin + c], kWin, levels, acc);
#pragma unroll
    for (int i = 0; i < kRunV; ++i) s_vert[(r0 + i) * kWin + c] = acc[i];
  }
  __syncthreads();

  // Horizontal pass: thread = (run of columns, row); the patch goes to the
  // window's cells, which are free now.
  if (tid < kRunsH * kSize) {
    const int run = tid / kSize;
    const int r = tid - run * kSize;
    const int c0 = min(run * kRunH, kSize - kRunH);
    float acc[kRunH];
    blur_run<kRunH>(&s_vert[r * kWin + c0], 1, levels, acc);
#pragma unroll
    for (int i = 0; i < kRunH; ++i) s_win[r * kSize + c0 + i] = acc[i];
  }
  __syncthreads();

  float* dst = out + (size_t)k * (kSize * kSize);
  for (int i = tid; i < kSize * kSize; i += kThreads) dst[i] = s_win[i];
}

static_assert(kRunsV * kWin <= kThreads && kRunsH * kSize <= kThreads,
              "one thread per (run, line) in each pass");

}  // namespace

// The host's view of BlurLevels for pg_blur_patch_gather_levels: `count`
// levels, each img a [h, w] float32 contiguous array with
// min(h, w) > 8, holding num_keypoints[l] >= 0 keypoints, level after level,
// in yx.
struct PgBlurLevels {
  const void* img[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num_keypoints[kMaxLevels];
  int count;
};

// yx: [K, 2] int32 (row, col) with K the sum of num_keypoints >= 1; taps:
// 17 floats on the HOST; out: [K, 39, 39] float32; images, yx and out
// contiguous on the device of `stream`. radius and br must be 19 and 8, the
// shape compiled in. One launch; does not synchronise; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a bad table or shape).
extern "C" int pg_blur_patch_gather_levels(const PgBlurLevels* levels, const void* yx,
                                           const float* taps, void* out, int radius,
                                           int br, void* stream) {
  if (levels->count < 1 || levels->count > kMaxLevels || radius != kRadius ||
      br != kBlur) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlurLevels table;
  int total = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int src = l < levels->count ? l : 0;
    table.img[l] = static_cast<const float*>(levels->img[src]);
    table.h[l] = levels->h[src];
    table.w[l] = levels->w[src];
    if (l < levels->count) {
      table.first_keypoint[l] = total;
      total += levels->num_keypoints[l];
    } else {
      table.first_keypoint[l] = 0x7FFFFFFF;
    }
  }
  if (total < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int u = 0; u < kTaps; ++u) table.taps[u] = taps[u];
  blur_patch_gather_kernel<<<total, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int*>(yx), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
