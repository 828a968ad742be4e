// Per-keypoint square patch gather from an edge-clamped image, for one image
// or for every level of an image pyramid in one launch.
//
// Replaces the TPU kernel pilotguru_tpu/vo/patch_pallas.py::
// gather_patches_pallas (body _patch_kernel). Same contract as the plain
// PyTorch version pilotguru_tpu_torch/vo/patch_kernel.py::
// gather_patches_plain (and pilotguru_tpu/vo/features.py::extract_patches):
//   s = 2 * radius + 1, (ys, xs) = yx[k] clamped to [0, h-1] x [0, w-1]
//   (the start clamping of dynamic_slice on the padded image; negative
//   starts clamp to 0), and
//   out[k, i, j] = img[clamp(ys + i - radius, 0, h-1),
//                      clamp(xs + j - radius, 0, w-1)].
// The index clamping replaces the edge-padded copy of the image that the
// reference materialises, so nothing but the output is written. The one
// shape the extractor uses is compiled in (radius 19: 39x39 patches); the
// wrapper refuses any other.
//
// What bounds it on an H100: bytes. It does no arithmetic; a frame's 2000
// keypoints write 12.2 MB of patches and read the distinct pixels their
// windows cover (most of each level, from L2 right after the blur wrote
// it), about 6 us at 3.35 TB/s. Measured (H100 80GB HBM3, 700 W; 4
// keypoints and 512 threads a block): 7.3 us for
// 2288 keypoints over 8 levels in one launch (a frame's 2000 plus border
// and corner keypoints) and 2.9 us for 434 on one level (bound 1.3 us),
// where a build with 256 threads and without the loads takes 1.9 us. The
// first design (one block of 32x8 threads per keypoint, a warp per patch
// row, 4-byte stores, the second pass over a row with 7 of 32 lanes busy,
// a launch per level) reached 35% of its bound. This one:
//   * Several keypoints a block (kKeypoints). The block writes
//     their patches as one flat run of floats: every lane of every warp
//     stores to consecutive addresses, whatever the row boundaries. 1521
//     floats a patch is odd, but 4 patches are 6084 bytes, a multiple of
//     16, so with a multiple of 4 keypoints a block every block's run
//     starts 16-byte aligned: the body is 16-byte stores; a scalar head and
//     tail take what an unaligned start or a last block of fewer keypoints
//     leaves.
//   * A thread fills 4 consecutive outputs: it locates the first (keypoint,
//     row, column) once with constant divisions and steps the column, row
//     and keypoint by increments; the 4 loads are independent and go through
//     the read-only path (__ldg).
//   * A block reads its keypoints' window origins and level once, into
//     shared memory, before any store.
//   * One launch covers all levels: a table of levels comes by value
//     (__grid_constant__) with each level's image and keypoint array, so
//     the per-level keypoint sets need no concatenation; a keypoint finds
//     its level by an unrolled chain of compares on constant indices (no
//     local-memory copy of the table).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 19;
constexpr int kSize = 2 * kRadius + 1;  // 39: patch side
constexpr int kPatch = kSize * kSize;   // 1521 floats a patch
constexpr int kKeypoints = 4;  // keypoints per block
constexpr int kThreads = 512;
constexpr int kMaxLevels = 8;

static_assert(kKeypoints <= kThreads, "one thread reads each keypoint of a block");

// The levels of one launch. Level l owns keypoints first_keypoint[l] ..
// first_keypoint[l + 1] - 1, whose (row, col) pairs are yx[l][0 ..];
// unused entries have first_keypoint = INT_MAX.
struct PatchLevels {
  const float* img[kMaxLevels];
  const int* yx[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int first_keypoint[kMaxLevels];
};

// One keypoint's window: its level's image, the window's top-left corner
// (may lie outside the image) and the level's size.
struct Window {
  const float* img;
  int y0, x0, h, w;
};

__device__ __forceinline__ float fetch(const Window& win, int i, int j) {
  const int row = min(max(win.y0 + i, 0), win.h - 1);
  const int col = min(max(win.x0 + j, 0), win.w - 1);
  return __ldg(win.img + (size_t)row * win.w + col);
}

__global__ void __launch_bounds__(kThreads)
gather_patches_kernel(const __grid_constant__ PatchLevels levels, float* __restrict__ out,
                      int total) {
  __shared__ Window s_win[kKeypoints];
  const int k0 = blockIdx.x * kKeypoints;
  const int nk = min(kKeypoints, total - k0);
  const int tid = threadIdx.x;

  if (tid < nk) {
    const int k = k0 + tid;
    // This keypoint's level: the last one whose first keypoint is not past
    // it. The table is indexed with constants only.
    const float* img = levels.img[0];
    const int* yx = levels.yx[0];
    int h = levels.h[0], w = levels.w[0], first = 0;
#pragma unroll
    for (int l = 1; l < kMaxLevels; ++l) {
      if (k >= levels.first_keypoint[l]) {
        img = levels.img[l];
        yx = levels.yx[l];
        h = levels.h[l];
        w = levels.w[l];
        first = levels.first_keypoint[l];
      }
    }
    const int local = k - first;
    Window win;
    win.img = img;
    win.y0 = min(max(__ldg(yx + 2 * local), 0), h - 1) - kRadius;
    win.x0 = min(max(__ldg(yx + 2 * local + 1), 0), w - 1) - kRadius;
    win.h = h;
    win.w = w;
    s_win[tid] = win;
  }
  __syncthreads();

  float* dst = out + (size_t)k0 * kPatch;
  const int n = nk * kPatch;
  // Floats before the first 16-byte boundary (0 when the output is aligned,
  // as the wrapper's allocations are).
  const int head = min(n, (int)(((16u - (reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u) >> 2));
  const int nvec = (n - head) >> 2;

  if (tid < head) {
    const int kp = tid / kPatch, rem = tid - kp * kPatch;
    dst[tid] = fetch(s_win[kp], rem / kSize, rem % kSize);
  }
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  for (int v = tid; v < nvec; v += kThreads) {
    const int e = head + 4 * v;
    int kp = e / kPatch;
    const int rem = e - kp * kPatch;
    int i = rem / kSize;
    int j = rem - i * kSize;
    Window win = s_win[kp];
    float q[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q[c] = fetch(win, i, j);
      if (c < 3 && ++j == kSize) {
        j = 0;
        if (++i == kSize) {
          i = 0;
          win = s_win[++kp];
        }
      }
    }
    dst4[v] = make_float4(q[0], q[1], q[2], q[3]);
  }
  const int e = head + 4 * nvec + tid;
  if (e < n) {
    const int kp = e / kPatch, rem = e - kp * kPatch;
    dst[e] = fetch(s_win[kp], rem / kSize, rem % kSize);
  }
}

}  // namespace

// The host's view of PatchLevels for pg_gather_patches_levels: `count`
// levels, each img a [h, w] float32 contiguous array with h, w >= 1 and yx
// its [num_keypoints, 2] int32 (row, col) contiguous array (num_keypoints
// >= 0; yx may be null where it is 0).
struct PgPatchLevels {
  const void* img[kMaxLevels];
  const void* yx[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num_keypoints[kMaxLevels];
  int count;
};

// out: [K, 39, 39] float32 with K the sum of num_keypoints >= 1, contiguous
// on the device of `stream`, as are the images and keypoint arrays. radius
// must be 19, the shape compiled in. One launch; does not synchronise;
// returns cudaGetLastError() (or cudaErrorInvalidValue for a bad table or
// shape).
extern "C" int pg_gather_patches_levels(const PgPatchLevels* levels, void* out, int radius,
                                        void* stream) {
  if (levels->count < 1 || levels->count > kMaxLevels || radius != kRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PatchLevels table;
  int total = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int src = l < levels->count ? l : 0;
    table.img[l] = static_cast<const float*>(levels->img[src]);
    table.yx[l] = static_cast<const int*>(levels->yx[src]);
    table.h[l] = levels->h[src];
    table.w[l] = levels->w[src];
    if (l < levels->count) {
      if (levels->h[l] < 1 || levels->w[l] < 1 || levels->num_keypoints[l] < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      table.first_keypoint[l] = total;
      total += levels->num_keypoints[l];
    } else {
      table.first_keypoint[l] = 0x7FFFFFFF;
    }
  }
  if (total < 1 || (reinterpret_cast<uintptr_t>(out) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (total + kKeypoints - 1) / kKeypoints;
  gather_patches_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}
