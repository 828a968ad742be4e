// FAST-9/16 corner response + 3x3 non-max suppression, for one image or for
// every level of an image pyramid in one launch.
//
// Replaces the TPU kernel pilotguru_tpu/vo/fast_pallas.py::fast_nms_pallas
// (body _fast_nms_kernel). Same contract as the plain PyTorch version
// pilotguru_tpu_torch/vo/fast_kernel.py::fast_nms_plain, per image:
//   raw = FAST-9/16 SAD-over-threshold response where the 16-pixel circle
//         holds a run of >= 9 brighter or >= 9 darker pixels, with the
//         3-pixel image border zeroed;
//   nms = raw where raw >= max(3x3 neighbourhood of raw), else 0 (ties keep
//         the pixel).
//
// What bounds it on an H100 (80GB HBM3, 700 W; probe builds): a fixed
// chain and instruction issue, not bytes. A pixel moves 12 bytes, for which
// the card's memory rate allows 3.3 us at 720x1280 (a plain copy of those
// bytes on the same grid takes 3.3 us, an empty kernel 1.4 us). Loading the
// tiles, the NMS and the stores alone take 5.5 us; building the masks adds
// 3.2 us, which is the rate at which the SM can issue their five
// instructions a tap; the arc tests, the list of corners and their
// responses add 2.5 us on a video frame and 4.2 us on noise (where a third
// of the pixels are corners). A pyramid level below 500 pixels a side
// cannot fill the card: one block's chain of load, sync, mark, sync,
// respond, sync, NMS takes 4 to 5 us however empty the card is. What the
// design does about it:
//   * One launch covers all levels: a table of levels comes by value and
//     the grid is flat over all levels' 32x32 tiles, so the small levels
//     share the card with the large one instead of running one after
//     another.
//   * The tap offsets are compile-time constants: each tap is one
//     shared-memory read at an immediate offset.
//   * Masks first, sums only for corners. Phase one builds each pixel's
//     two 16-bit masks (which taps differ from the centre by more than the
//     threshold, and which are darker), five instructions a tap in all (a
//     sign bit is funnel-shifted into each mask), and lists the pixels
//     whose mask holds a 9-arc (a few percent of a video frame) in shared
//     memory. Phase two takes the response sums of the listed corners only,
//     one thread per corner, so no warp runs the sums for 32 pixels because
//     one of them is a corner. A pixel without an arc scores 0 in the plain
//     version too.
//   * No division and no clamping in the loops: 2-D thread indices walk the
//     tile; out-of-image cells load 0 (a pixel that scores lies at least 3
//     inside the image, so its taps never read them).
// One block per 32x32 output tile loads the tile plus a 4-pixel halo (3 for
// the circle, 1 for the NMS window) into shared memory, computes the
// response for the tile plus a 1-pixel ring, and takes the 3x3 maximum from
// shared memory (each row's 3-wide maximum once for the three rows it
// serves), so the image is read once and each output written once.
// Tried and dropped, with times, in PERF.md: 512 threads a block, the sums
// in the marking pass, an arc test of the union mask first.
//
// The response sums accumulate sequentially in FAST_CIRCLE order with
// __fadd_rn / __fsub_rn, as the Pallas body does and as fast_nms_plain does,
// so the kernel and the plain version agree bit for bit and the NMS support
// cannot flip on a near-tie.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 4;
constexpr int kIn = kTile + 2 * kHalo;  // 40: shared image tile side
constexpr int kScore = kTile + 2;       // 34: response tile side (1-px ring)
constexpr int kRows = 8;  // the block is 32 x kRows threads (>= 5)
static_assert(kRows >= 5 && kTile % kRows == 0, "32 x kRows threads tile the 32 rows");
constexpr int kMaxLevels = 8;

// FAST_CIRCLE of pilotguru_tpu/vo/features.py: (row, col) offsets, from 12
// o'clock clockwise.
__device__ constexpr int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                          3, 3, 2, 1, 0, -1, -2, -3};
__device__ constexpr int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                          0, -1, -2, -3, -3, -3, -2, -1};

// The levels of one launch. Level l owns tiles first_tile[l] ..
// first_tile[l + 1] - 1 of the flat grid, tiles_x[l] to a row; unused
// entries have first_tile = INT_MAX.
struct FastLevels {
  const float* img[kMaxLevels];
  float* raw[kMaxLevels];
  float* nms[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int first_tile[kMaxLevels];
  int tiles_x[kMaxLevels];
};

// >= 9 contiguous set bits on the 16-cycle of the low 16 bits of m. With the
// cycle written twice (32 bits), bit i of the result says that bits i .. i+8
// are set; any rotation or reflection of the cycle gives the same answer.
__device__ __forceinline__ bool has_arc(unsigned m) {
  const unsigned p = m | (m << 16);
  unsigned r = p & (p >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= p >> 8;
  return (r & 0xFFFFu) != 0u;
}

// Tap T's difference d and two sign bits: |d| > thr <=> thr - |d| < 0 (a
// float difference that is not 0 never rounds to 0), and d's own sign says
// whether the tap is the darker or the brighter one. Each mask shifts left
// by one and takes a sign bit, so tap T ends at bit 15 - T: `over` holds the
// taps that differ from the centre by more than thr, `neg` the taps below it.
template <int T>
__device__ __forceinline__ void tap(const float* __restrict__ c, float center,
                                    float thr, unsigned& over, unsigned& neg) {
  const float d = __fsub_rn(c[kCircleDy[T] * kIn + kCircleDx[T]], center);
  over = __funnelshift_l(__float_as_uint(__fsub_rn(thr, fabsf(d))), over, 1);
  neg = __funnelshift_l(__float_as_uint(d), neg, 1);
}

// Tap T's share of the two response sums, branch-free: a tap that is not
// over the threshold adds +0, which leaves the sum's bits as they are.
template <int T>
__device__ __forceinline__ void add_tap(const float* __restrict__ c, float center,
                                        float thr, float& bsum, float& dsum) {
  const float d = __fsub_rn(c[kCircleDy[T] * kIn + kCircleDx[T]], center);
  bsum = __fadd_rn(bsum, fmaxf(__fsub_rn(d, thr), 0.0f));
  dsum = __fadd_rn(dsum, fmaxf(__fsub_rn(-d, thr), 0.0f));
}

// Whether the pixel whose shared-memory cell is c has a 9-arc of brighter or
// of darker taps.
__device__ __forceinline__ bool fast_is_corner(const float* __restrict__ c, float thr) {
  const float center = c[0];
  unsigned over = 0u, neg = 0u;
  // The four compass taps (0, 4, 8, 12) before the other twelve. Any 9-arc
  // holds at least two of them, so a pixel with fewer than two brighter and
  // fewer than two darker compass taps scores 0. A warp skips the twelve
  // only where all its 32 pixels fail the test: on a video frame that saves
  // a tenth of the time, on noise it costs a twentieth.
  tap<0>(c, center, thr, over, neg);
  tap<4>(c, center, thr, over, neg);
  tap<8>(c, center, thr, over, neg);
  tap<12>(c, center, thr, over, neg);
  if (__popc(over & ~neg) < 2 && __popc(over & neg) < 2) return false;
  over = neg = 0u;
  tap<0>(c, center, thr, over, neg);
  tap<1>(c, center, thr, over, neg);
  tap<2>(c, center, thr, over, neg);
  tap<3>(c, center, thr, over, neg);
  tap<4>(c, center, thr, over, neg);
  tap<5>(c, center, thr, over, neg);
  tap<6>(c, center, thr, over, neg);
  tap<7>(c, center, thr, over, neg);
  tap<8>(c, center, thr, over, neg);
  tap<9>(c, center, thr, over, neg);
  tap<10>(c, center, thr, over, neg);
  tap<11>(c, center, thr, over, neg);
  tap<12>(c, center, thr, over, neg);
  tap<13>(c, center, thr, over, neg);
  tap<14>(c, center, thr, over, neg);
  tap<15>(c, center, thr, over, neg);
  return has_arc(over & ~neg) || has_arc(over & neg);
}

// Response of a corner: the larger of the two sums over the threshold, each
// taken in tap order.
__device__ __forceinline__ float fast_response(const float* __restrict__ c, float thr) {
  const float center = c[0];
  float bsum = 0.0f, dsum = 0.0f;
  add_tap<0>(c, center, thr, bsum, dsum);
  add_tap<1>(c, center, thr, bsum, dsum);
  add_tap<2>(c, center, thr, bsum, dsum);
  add_tap<3>(c, center, thr, bsum, dsum);
  add_tap<4>(c, center, thr, bsum, dsum);
  add_tap<5>(c, center, thr, bsum, dsum);
  add_tap<6>(c, center, thr, bsum, dsum);
  add_tap<7>(c, center, thr, bsum, dsum);
  add_tap<8>(c, center, thr, bsum, dsum);
  add_tap<9>(c, center, thr, bsum, dsum);
  add_tap<10>(c, center, thr, bsum, dsum);
  add_tap<11>(c, center, thr, bsum, dsum);
  add_tap<12>(c, center, thr, bsum, dsum);
  add_tap<13>(c, center, thr, bsum, dsum);
  add_tap<14>(c, center, thr, bsum, dsum);
  add_tap<15>(c, center, thr, bsum, dsum);
  return fmaxf(bsum, dsum);
}

// Phase one for response cell (r, c): score 0, and a corner joins the list.
__device__ __forceinline__ void mark_cell(const float* s_img, float* s_score,
                                          unsigned short* s_corners, int* s_count,
                                          int r, int c, bool scores, float thr) {
  s_score[r * kScore + c] = 0.0f;
  if (scores && fast_is_corner(&s_img[(r + 3) * kIn + c + 3], thr)) {
    s_corners[atomicAdd(s_count, 1)] = static_cast<unsigned short>((r << 8) | c);
  }
}

__global__ void __launch_bounds__(kTile * kRows)
fast_nms_kernel(const __grid_constant__ FastLevels levels, float thr) {
  __shared__ float s_img[kIn * kIn];
  __shared__ float s_score[kScore * kScore];
  __shared__ unsigned short s_corners[kScore * kScore];
  __shared__ int s_count;

  // This block's level: the last one whose first tile is not past it. The
  // table is indexed with constants only, so it stays in the parameter bank.
  const int tile = blockIdx.x;
  const float* __restrict__ img = levels.img[0];
  float* __restrict__ raw = levels.raw[0];
  float* __restrict__ nms = levels.nms[0];
  int h = levels.h[0], w = levels.w[0];
  int first = 0, tiles_x = levels.tiles_x[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (tile >= levels.first_tile[l]) {
      img = levels.img[l];
      raw = levels.raw[l];
      nms = levels.nms[l];
      h = levels.h[l];
      w = levels.w[l];
      first = levels.first_tile[l];
      tiles_x = levels.tiles_x[l];
    }
  }
  const int by = (tile - first) / tiles_x;
  const int bx = (tile - first) - by * tiles_x;
  const int y0 = by * kTile;
  const int x0 = bx * kTile;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  if (tid == 0) s_count = 0;

  // Shared cell (r, c) <-> pixel (y0 - kHalo + r, x0 - kHalo + c); cells
  // outside the image hold 0. Columns 0 .. 31 by (ty, tx); the 8 columns
  // 32 .. 39 of the 40 rows by the flat thread index.
#pragma unroll
  for (int r = ty; r < kIn; r += kRows) {
    const int gy = y0 - kHalo + r;
    const int gx = x0 - kHalo + tx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_img[r * kIn + tx] = in ? img[(size_t)gy * w + gx] : 0.0f;
  }
#pragma unroll
  for (int i = tid; i < kIn * (kIn - kTile); i += kTile * kRows) {
    const int r = i >> 3;
    const int c = kTile + (i & 7);
    const int gy = y0 - kHalo + r;
    const int gx = x0 - kHalo + c;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_img[r * kIn + c] = in ? img[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  // Response cell (r, c) <-> pixel (y0 - 1 + r, x0 - 1 + c), at shared cell
  // (r + 3, c + 3). Pixels within 3 of the border (and outside the image)
  // score 0: the border is zeroed before the NMS, exactly like the
  // reference, and scores are >= 0, so a 0 ring equals a -inf ring.
  // Phase one marks the corners: columns 0 .. 31 by (ty, tx); columns 32
  // and 33 of the 34 rows by threads 64 .. 131 (with 8 rows of threads,
  // warps that have no row 32 or 33).
#pragma unroll
  for (int r = ty; r < kScore; r += kRows) {
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + tx;
    mark_cell(s_img, s_score, s_corners, &s_count, r, tx,
              gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3, thr);
  }
  if (tid >= 64 && tid < 64 + 2 * kScore) {
    const int r = (tid - 64) >> 1;
    const int c = kTile + ((tid - 64) & 1);
    const int gy = y0 - 1 + r;
    const int gx = x0 - 1 + c;
    mark_cell(s_img, s_score, s_corners, &s_count, r, c,
              gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3, thr);
  }
  __syncthreads();

  // Phase two: one thread per listed corner takes its response, so the
  // lanes of a warp all work (in phase one a warp would run the sums for
  // all 32 pixels wherever one of them is a corner).
  const int corners = s_count;
  for (int i = tid; i < corners; i += kTile * kRows) {
    const int r = s_corners[i] >> 8;
    const int c = s_corners[i] & 0xFF;
    s_score[r * kScore + c] = fast_response(&s_img[(r + 3) * kIn + c + 3], thr);
  }
  __syncthreads();

  // NMS: a thread takes kTile / kRows rows of one column, so each row's
  // 3-wide maximum is taken once and shared by the three rows it serves.
  const int gx = x0 + tx;
  if (gx >= w) return;
  constexpr int kRun = kTile / kRows;
  const int r0 = ty * kRun;
  float across[kRun + 2];
#pragma unroll
  for (int j = 0; j < kRun + 2; ++j) {
    const float* s = &s_score[(r0 + j) * kScore + tx];
    across[j] = fmaxf(fmaxf(s[0], s[1]), s[2]);
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int gy = y0 + r0 + i;
    if (gy >= h) break;
    const float mid = s_score[(r0 + i + 1) * kScore + tx + 1];
    const float nbr = fmaxf(fmaxf(across[i], across[i + 1]), across[i + 2]);
    const size_t o = (size_t)gy * w + gx;
    raw[o] = mid;
    nms[o] = mid >= nbr ? mid : 0.0f;
  }
}

}  // namespace

// The host's view of FastLevels for pg_fast_nms_levels: `count` levels, each
// img / raw / nms a [h, w] float32 contiguous array on the device of
// `stream`.
struct PgFastLevels {
  const void* img[kMaxLevels];
  void* raw[kMaxLevels];
  void* nms[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int count;
};

// One launch over every level of `levels` (1 <= count <= 8). Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue for a bad table).
extern "C" int pg_fast_nms_levels(const PgFastLevels* levels, float threshold,
                                  void* stream) {
  if (levels->count < 1 || levels->count > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FastLevels table;
  int tiles = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int src = l < levels->count ? l : 0;
    table.img[l] = static_cast<const float*>(levels->img[src]);
    table.raw[l] = static_cast<float*>(levels->raw[src]);
    table.nms[l] = static_cast<float*>(levels->nms[src]);
    table.h[l] = levels->h[src];
    table.w[l] = levels->w[src];
    table.tiles_x[l] = (table.w[l] + kTile - 1) / kTile;
    if (l < levels->count) {
      table.first_tile[l] = tiles;
      tiles += table.tiles_x[l] * ((table.h[l] + kTile - 1) / kTile);
    } else {
      table.first_tile[l] = 0x7FFFFFFF;
    }
  }
  fast_nms_kernel<<<tiles, dim3(kTile, kRows), 0, static_cast<cudaStream_t>(stream)>>>(
      table, threshold);
  return static_cast<int>(cudaGetLastError());
}
