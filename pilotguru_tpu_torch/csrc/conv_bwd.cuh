// The backward of the folded convolutions (pilotguru_tpu_torch/ml/folded.py)
// in full float32: dgrad (the input's gradient) and wgrad (the weights' and
// the bias's), written straight into the layouts the training path holds.
// conv_bwd_f32.cu builds it into a library of its own.
//
// Replaces no TPU kernel: the JAX package leaves the convolutions' gradients
// to XLA. Added because cuDNN's deterministic float32 backward ran at about
// 13% of the card's FP32 peak and took half or more of the folded train
// step. The forward stays cuDNN's. Same contract as the plain PyTorch version
// pilotguru_tpu_torch/ml/conv_kernel.py::conv_dgrad_plain /
// conv_wgrad_plain. A VALID convolution of stride S and a K x K kernel, G
// groups, each reading ``cin`` input channels (its slice of x; all of x
// where the input is shared, G = 1) and writing ``m`` output channels:
//   dx[b, iy, ix, g*cin + ci] = sum over taps (ky, kx) with iy = S*oy + ky,
//     ix = S*ox + kx, and over co < m, of dy[b, oy, ox, g*m + co] *
//     w[g, ky, kx, co, ci];
//   dW[g, ky, kx, ci, co] = sum over the pixels (b, oy, ox) of
//     dy[b, oy, ox, g*m + co] * x[b, S*oy + ky, S*ox + kx, g*cin + ci];
//   db[g, co] = sum over the pixels of dy[b, oy, ox, g*m + co];
// where the input is shared, output channel co of the one group is channel
// co % cout of net co / cout in dW and db.
//
// What bounds it on an H100: float32 FMAs. TF32 is off, so the tensor cores
// cannot serve these products; each kernel is a register-tiled implicit
// GEMM on the FP32 pipes. A thread holds 8 x 4 outer products, fed from
// shared memory that cp.async fills ahead (wgrad two steps, dgrad one;
// 2 or 3 blocks an SM and 4 stages measured no faster). Activations and
// gradients are channels-last ([B, H, W, C]); where the channels of a group
// are a multiple of 4, every load is a 16-byte vector.
//
// dgrad (per group: M = input pixels, N = cin, K = m x taps): the stride is
// split into its S x S phases. The input pixels (iy, ix) of one phase
// (iy % S, ix % S) see a fixed subset of the taps, and pixel (S*jy + py,
// S*jx + px) reads dy at (jy - ty, jx - tx) for tap (py + S*ty, px + S*tx),
// so no multiply is spent on a zero and every dx element is written once. A
// block takes a rectangle of ``rows`` x ``cols`` pixels of a phase's grid
// and ``tile`` input channels; a step loads ``CH`` output channels of the
// window of dy the rectangle reads, once for all the phase's taps (a 5x5/2
// conv's dy is read about 1.4 times, not 25), and adds every tap's products.
//
// wgrad (per group: M = m, N = K*K*cin + 1, K = B x Hout x Wout pixels): the
// last column of im2col(x) is 1, so the bias's gradient comes out of the
// same product. The pixels are split into ``splits`` partitions, sized from
// the shape alone (one wave of blocks); a thread sums each segment
// of 128 pixels in one FMA chain and adds the segments in order, which keeps
// the rounding of a partition's tens of thousands of terms near that of a
// few hundred (the biases before batch norm have gradients of rounding
// noise about 0). Each block writes its partial product to scratch, and a
// second pass adds the partitions in order and writes dW in the stacked
// HWIO layout [nets, K, K, cin, cout] and db [nets, cout].
//
// No float atomics: each sum runs in an order that depends on the shape
// alone, so two calls on the same inputs give the same bits.

#pragma once

#include <cuda_runtime.h>

// PgConv of the ctypes binding: one call's tensors and sizes.
struct PgConv {
  const float* x;      // [B, hin, win, groups * cin]
  const float* dy;     // [B, hout, wout, groups * m]
  const float* w;      // dgrad: [groups, K, K, m, cin]
  float* dx;           // dgrad: as x
  float* partial;      // wgrad: [splits, groups, K*K*cin + 1, m]
  float* dw;           // wgrad: [nets, K, K, cin, cout]
  float* db;           // wgrad: [nets, cout]
  int batch, hin, win, hout, wout;
  int ksize, stride;
  int groups, cin, m;  // a group's input and output channels
  int cout;            // a net's output channels: m, or m / nets where the input is shared
  int tile;            // channels a block covers (dgrad: of cin; wgrad: of m), a multiple of 4
  int long_threads;    // threads along the long side, each 8 values of it
  int splits;          // wgrad: partitions of the pixels
  int chunk;           // dgrad: output channels a step (12 or 16, dividing m)
  int rows, cols;      // dgrad: the rectangle of a phase's pixel grid a block takes
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStages = 3;   // wgrad: shared-memory buffers in flight (dgrad: 2)
constexpr int kPixels = 16;  // wgrad: pixels a step
constexpr int kSegment = 8;  // wgrad: steps a thread sums before adding them to its total
constexpr int kRowPad = 20;  // dgrad: floats a pixel of the dy window takes (conflict-free reads)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies V floats (V = 4: 16 bytes, L1 kept; V = 1: 4 bytes) from global to
// shared memory, or writes zeros where ``ok`` is false.
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const unsigned d = smem_addr(dst);
  const int bytes = ok ? 4 * V : 0;
  if constexpr (V == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes));
  }
}

// As copy_async<4>, bypassing L1 (data read once).
__device__ __forceinline__ void copy_async_once(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N groups of this thread's copies are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- dgrad

// Grid: (rectangles of rows x cols pixels of the largest phase's grid, for
// each image; channel tiles of cin; groups * S * S). Block: tile / 4 x
// long_threads threads, a thread holding 8 pixels of the rectangle (pixel
// t_p + i * long_threads, row-major) by 4 input channels. A step takes CH
// output channels: the window of dy that the rectangle's pixels read over
// all the phase's taps, and those taps' weights; the rectangle's pixels
// then add every tap's products from shared memory.
template <int K, int S, int CH>
__global__ void __launch_bounds__(kMaxThreads) conv_dgrad_kernel(const __grid_constant__ PgConv a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVectors = CH / 4;       // 16-byte vectors of a window pixel's step
  constexpr int kTaps = (K + S - 1) / S;  // taps along an axis, at most
  const int ts = a.tile / 4;
  const int tl = a.long_threads;
  const int threads = ts * tl;
  const int tid = threadIdx.x;
  const int phase = blockIdx.z % (S * S);
  const int g = blockIdx.z / (S * S);
  const int py = phase / S, px = phase % S;
  const int hq = (a.hin - py + S - 1) / S, wq = (a.win - px + S - 1) / S;
  const int taps_y = (K - py + S - 1) / S, taps_x = (K - px + S - 1) / S;
  // This block's rectangle: image b, phase-grid rows jy0.. and columns jx0..
  const int across = (((a.win + S - 1) / S) + a.cols - 1) / a.cols;
  const int down = (((a.hin + S - 1) / S) + a.rows - 1) / a.rows;
  const int b = blockIdx.x / (across * down);
  const int jy0 = (blockIdx.x / across) % down * a.rows, jx0 = blockIdx.x % across * a.cols;
  if (jy0 >= hq || jx0 >= wq) return;
  const int c0 = blockIdx.y * a.tile;
  // The dy window: rows jy0 - taps_y + 1 .. jy0 + rows - 1, and so on.
  const int wh = a.rows + taps_y - 1, ww = a.cols + taps_x - 1;
  const int window = (a.rows + kTaps - 1) * (a.cols + kTaps - 1);  // the largest phase's
  const int oy0 = jy0 - taps_y + 1, ox0 = jx0 - taps_x + 1;
  const int cy = a.groups * a.m;
  const int steps = a.m / CH;

  float* dys = smem;                                  // [2][window][kRowPad]
  float* ws = dys + 2 * window * kRowPad;             // [2][kTaps^2][CH][tile]
  const int w_stage = kTaps * kTaps * CH * a.tile;

  auto load = [&](int step, int buf) {
    float* dst = dys + buf * window * kRowPad;
    const float* src = a.dy + ((long long)b * a.hout * a.wout) * cy + g * a.m + step * CH;
    for (int id = tid; id < wh * ww * kVectors; id += threads) {
      const int wp = id / kVectors, v = id % kVectors;
      const int oy = oy0 + wp / ww, ox = ox0 + wp % ww;
      const bool ok = oy >= 0 && oy < a.hout && ox >= 0 && ox < a.wout;
      copy_async<4>(dst + wp * kRowPad + 4 * v,
                    ok ? src + ((long long)oy * a.wout + ox) * cy + 4 * v : a.dy, ok);
    }
    float* wdst = ws + buf * w_stage;
    for (int id = tid; id < taps_y * taps_x * CH * ts; id += threads) {
      const int c = id % ts, r = id / ts;  // r: tap * CH + output channel
      const int tap = r / CH, co = r % CH;
      const int ky = py + S * (tap / taps_x), kx = px + S * (tap % taps_x);
      const bool ok = c0 + 4 * c < a.cin;
      const float* wsrc = a.w + ((((long long)g * K + ky) * K + kx) * a.m + step * CH + co) *
                                    a.cin + c0 + 4 * c;
      copy_async<4>(wdst + r * a.tile + 4 * c, ok ? wsrc : a.w, ok);
    }
  };

  // This thread's pixels: their window offset at tap (0, 0); a pixel past
  // the rectangle reads pixel 0's and is not stored.
  const int t_c = tid % ts, t_p = tid / ts;
  int at[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = t_p + i * tl;
    const int r = p < a.rows * a.cols ? p / a.cols : 0, c = p < a.rows * a.cols ? p % a.cols : 0;
    at[i] = ((r + taps_y - 1) * ww + c + taps_x - 1) * kRowPad;
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load(0, 0);
  commit_copies();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1, (step + 1) % 2);
    commit_copies();
    wait_copies<1>();  // this step's buffer has landed
    __syncthreads();
    const float* d = dys + (step % 2) * window * kRowPad;
    const float* wv = ws + (step % 2) * w_stage + 4 * t_c;
    for (int ty = 0; ty < taps_y; ++ty) {
      for (int tx = 0; tx < taps_x; ++tx) {
        const float* dt = d - (ty * ww + tx) * kRowPad;
        const float* wt = wv + (ty * taps_x + tx) * CH * a.tile;
#pragma unroll
        for (int k4 = 0; k4 < kVectors; ++k4) {
          float4 w4[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w4[u] = *reinterpret_cast<const float4*>(wt + (4 * k4 + u) * a.tile);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 dv = *reinterpret_cast<const float4*>(dt + at[i] + 4 * k4);
            const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][0] = fmaf(dd[u], w4[u].x, acc[i][0]);
              acc[i][1] = fmaf(dd[u], w4[u].y, acc[i][1]);
              acc[i][2] = fmaf(dd[u], w4[u].z, acc[i][2]);
              acc[i][3] = fmaf(dd[u], w4[u].w, acc[i][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled next step
  }

  const int ci = c0 + 4 * t_c;
  if (ci >= a.cin) return;
  const int cx = a.groups * a.cin;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = t_p + i * tl;
    if (p >= a.rows * a.cols) break;
    const int jy = jy0 + p / a.cols, jx = jx0 + p % a.cols;
    if (jy >= hq || jx >= wq) continue;
    const long long at_dx = (((long long)b * a.hin + py + S * jy) * a.win + px + S * jx) * cx +
                            g * a.cin + ci;
    *reinterpret_cast<float4*>(a.dx + at_dx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ----------------------------------------------------------------- wgrad

// Grid: (column tiles of K*K*cin + 1, channel tiles of m, groups * splits).
// Block: tile / 4 x long_threads threads. V: floats a load of x (4, or 1
// where cin is not a multiple of 4).
template <int K, int S, int V>
__global__ void __launch_bounds__(kMaxThreads) conv_wgrad_kernel(const __grid_constant__ PgConv a) {
  extern __shared__ __align__(16) float smem[];
  const int ts = a.tile / 4;
  const int tl = a.long_threads;
  const int threads = ts * tl;
  const int span = 8 * tl;  // columns a block
  const int tid = threadIdx.x;
  const int taps_cols = K * K * a.cin;
  const int cols = taps_cols + 1;
  const int n0 = blockIdx.x * span;
  const int m0 = blockIdx.y * a.tile;
  const int g = blockIdx.z % a.groups;
  const int split = blockIdx.z / a.groups;
  const int cx = a.groups * a.cin, cy = a.groups * a.m;
  const int total = a.batch * a.hout * a.wout;
  const int per = ((total + a.splits - 1) / a.splits + kPixels - 1) / kPixels * kPixels;
  const int k_begin = split * per;
  const int k_end = min(total, k_begin + per);
  const int steps = k_end > k_begin ? (k_end - k_begin + kPixels - 1) / kPixels : 0;

  float* dys = smem;                                 // [kStages][kPixels][tile]
  float* xs = dys + kStages * kPixels * a.tile;      // [kStages][kPixels][span]
  long long* rows = reinterpret_cast<long long*>(xs + kStages * kPixels * span);  // [2][kPixels]

  // The x offset of step ``step``'s pixels' windows (-1 past the partition),
  // into ring slot step & 1.
  auto fill_rows = [&](int step) {
    if (tid < kPixels) {
      const int p = k_begin + step * kPixels + tid;
      long long off = -1;
      if (p < k_end) {
        const int ox = p % a.wout, t = p / a.wout;
        const int oy = t % a.hout, b = t / a.hout;
        off = (((long long)b * a.hin + S * oy) * a.win + S * ox) * cx + g * a.cin;
      }
      rows[(step & 1) * kPixels + tid] = off;
    }
  };

  // dy's loads: thread (row a_r, vector a_c), rows a_r, a_r + tl.
  const int a_c = tid % ts, a_r = tid / ts;
  const bool a_ok = m0 + 4 * a_c < a.m;
  const float* dy_col = a.dy + g * a.m + m0 + 4 * a_c;
  // x's loads: thread (row b_r, column vector b_c) of span / V a row.
  const int b_vectors = span / V;
  const int b_c = tid % b_vectors, b_r = tid / b_vectors;
  const int b_rows = threads / b_vectors;  // rows a pass
  const int col = n0 + b_c * V;
  int col_off = 0;
  if (col < taps_cols) {
    const int tap = col / a.cin, ci = col - tap * a.cin;
    col_off = ((tap / K) * a.win + tap % K) * cx + ci;
  }

  auto load = [&](int step, int buf) {
    float* ad = dys + buf * kPixels * a.tile + 4 * a_c;
    for (int r = a_r; r < kPixels; r += tl) {
      const int p = k_begin + step * kPixels + r;
      const bool ok = a_ok && p < k_end;
      copy_async_once(ad + r * a.tile, ok ? dy_col + (long long)p * cy : a.dy, ok);
    }
    if (b_r >= b_rows) return;
    const long long* row = rows + (step & 1) * kPixels;
    float* bd = xs + buf * kPixels * span + b_c * V;
    for (int r = b_r; r < kPixels; r += b_rows) {
      const long long off = row[r];
      float* dst = bd + r * span;
      if (col < taps_cols) {
        copy_async<V>(dst, off >= 0 ? a.x + off + col_off : a.x, off >= 0);
      } else {
        // The bias's column of ones, then zeros past the last column.
        dst[0] = col == taps_cols && off >= 0 ? 1.0f : 0.0f;
#pragma unroll
        for (int v = 1; v < V; ++v) dst[v] = 0.0f;
      }
    }
  };

  const int t_m = tid % ts, t_n = tid / ts;
  // acc sums a segment of kSegment steps; sum adds the segments in order.
  float acc[8][4], sum[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = sum[i][j] = 0.0f;

  fill_rows(0);
  __syncthreads();
  if (steps > 0) load(0, 0);
  commit_copies();
  fill_rows(1);
  __syncthreads();
  if (steps > 1) load(1, 1);
  commit_copies();
  fill_rows(2);
  for (int step = 0; step < steps; ++step) {
    wait_copies<kStages - 2>();  // the oldest step has landed
    __syncthreads();
    if (step + 2 < steps) load(step + 2, (step + 2) % kStages);
    commit_copies();
    fill_rows(step + 3);
    const int buf = step % kStages;
    const float* av = dys + buf * kPixels * a.tile + 4 * t_m;
    const float* bv = xs + buf * kPixels * span + 8 * t_n;
#pragma unroll
    for (int kk = 0; kk < kPixels; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(av + kk * a.tile);
      const float4 b0 = *reinterpret_cast<const float4*>(bv + kk * span);
      const float4 b1 = *reinterpret_cast<const float4*>(bv + kk * span + 4);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(bb[i], a4.x, acc[i][0]);
        acc[i][1] = fmaf(bb[i], a4.y, acc[i][1]);
        acc[i][2] = fmaf(bb[i], a4.z, acc[i][2]);
        acc[i][3] = fmaf(bb[i], a4.w, acc[i][3]);
      }
    }
    if ((step + 1) % kSegment == 0 || step + 1 == steps) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sum[i][j] += acc[i][j];
          acc[i][j] = 0.0f;
        }
    }
  }

  const int mm = m0 + 4 * t_m;
  if (mm >= a.m) return;
  float* out = a.partial + ((long long)split * a.groups + g) * cols * a.m + mm;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + 8 * t_n + i;
    if (n >= cols) break;
    *reinterpret_cast<float4*>(out + (long long)n * a.m) =
        make_float4(sum[i][0], sum[i][1], sum[i][2], sum[i][3]);
  }
}

// The partitions' partial products added in order, into dW and db.
__global__ void __launch_bounds__(kMaxThreads) conv_wgrad_reduce_kernel(
    const __grid_constant__ PgConv a) {
  const int taps_cols = a.ksize * a.ksize * a.cin;
  const long long size = (long long)a.groups * (taps_cols + 1) * a.m;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float sum = 0.0f;
  for (int s = 0; s < a.splits; ++s) sum += __ldcs(a.partial + s * size + i);
  const int mm = static_cast<int>(i % a.m);
  const long long t = i / a.m;
  const int n = static_cast<int>(t % (taps_cols + 1));
  const int g = static_cast<int>(t / (taps_cols + 1));
  const int net = g * (a.m / a.cout) + mm / a.cout, co = mm % a.cout;
  if (n < taps_cols) {
    a.dw[((long long)net * taps_cols + n) * a.cout + co] = sum;
  } else {
    a.db[net * a.cout + co] = sum;
  }
}

// --------------------------------------------------------------- launches

template <int K, int S, int CH>
size_t dgrad_smem(const PgConv& a) {
  constexpr int kTaps = (K + S - 1) / S;
  const int window = (a.rows + kTaps - 1) * (a.cols + kTaps - 1);
  return sizeof(float) * 2 * (window * kRowPad + kTaps * kTaps * CH * a.tile);
}

inline size_t wgrad_smem(const PgConv& a) {
  const int span = 8 * a.long_threads;
  return sizeof(float) * kStages * kPixels * (a.tile + span) + 2 * sizeof(long long) * kPixels;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const PgConv& a,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K, int S, int CH>
cudaError_t dgrad(const PgConv& a, cudaStream_t stream) {
  const int down = ((a.hin + S - 1) / S + a.rows - 1) / a.rows;  // phase (0, 0), the largest
  const int across = ((a.win + S - 1) / S + a.cols - 1) / a.cols;
  const dim3 grid(static_cast<unsigned>((long long)a.batch * down * across),
                  (a.cin + a.tile - 1) / a.tile, a.groups * S * S);
  return launch(conv_dgrad_kernel<K, S, CH>, grid, a.tile / 4 * a.long_threads,
                dgrad_smem<K, S, CH>(a), a, stream);
}

template <int K, int S, int V>
cudaError_t wgrad(const PgConv& a, cudaStream_t stream) {
  const int span = 8 * a.long_threads;
  const int cols = K * K * a.cin + 1;
  // Every thread's loads of x sit in one column vector.
  if (span / V > a.tile / 4 * a.long_threads || a.cin % V != 0 || a.splits < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((cols + span - 1) / span, (a.m + a.tile - 1) / a.tile, a.groups * a.splits);
  cudaError_t err = launch(conv_wgrad_kernel<K, S, V>, grid, a.tile / 4 * a.long_threads,
                           wgrad_smem(a), a, stream);
  if (err != cudaSuccess) return err;
  const long long size = (long long)a.groups * cols * a.m;
  conv_wgrad_reduce_kernel<<<static_cast<unsigned>((size + kMaxThreads - 1) / kMaxThreads),
                             kMaxThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The sizes every launch relies on.
inline bool valid(const PgConv& a) {
  return a.batch > 0 && a.hout > 0 && a.wout > 0 && a.hin >= (a.hout - 1) * a.stride + a.ksize &&
         a.win >= (a.wout - 1) * a.stride + a.ksize && a.groups > 0 && a.cin > 0 && a.m > 0 &&
         a.m % 4 == 0 && a.cout > 0 && a.m % a.cout == 0 && a.tile > 0 && a.tile % 4 == 0 &&
         a.tile <= 64 && a.long_threads > 0 && a.tile / 4 * a.long_threads <= kMaxThreads;
}

}  // namespace
