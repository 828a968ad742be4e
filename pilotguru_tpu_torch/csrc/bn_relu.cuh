// Batch norm in train mode fused with the ReLU after it, forward and
// backward, for the folded PilotNet (pilotguru_tpu_torch/ml/folded.py).
// bn_relu_f32.cu and bn_relu_bf16.cu each build this code for one dtype,
// into a library of its own, so a float32 run compiles only its kernels.
//
// Replaces no TPU kernel: the JAX package writes this expression in jnp and
// XLA fuses it. Written op by op in PyTorch it broadcast [C] statistics over
// the activation in 8 passes forward and 14 backward (about 47 reads or
// writes of it), a third of the folded train step on an H100. Same contract
// as the plain PyTorch version pilotguru_tpu_torch/ml/bn_relu_kernel.py::
// bn_relu_train_plain / bn_relu_backward_plain, per channel c over the n
// rows:
//   mean = sum(x) / n, var = sum(x^2) / n - mean^2 (sums in float64),
//   keep = var >= 0, var clamped at 0, both rounded to float32;
//   rstd = 1 / sqrt(var + eps);
//   xhat = (x - mean) * rstd, z = xhat * scale + bias (float32, each
//   operation rounded as PyTorch's separate ops round: no contraction);
//   y = relu(z rounded to x's dtype);
//   running mean and var: momentum * old + (1 - momentum) * new.
// Backward, from the upstream gradient g (x's dtype):
//   g' = 0 where y <= 0, else g (PyTorch's threshold_backward),
//   dbias = sum(g'), dscale = sum(g' * xhat) (float64 sums),
//   dx = rstd * scale * ((g' - dbias / n) - xhat * dscale / n),
//   where the variance term is 0 for channels whose raw variance was below
//   0 (the gradient of the clamp).
// xhat and y are recomputed from x in the backward; nothing but x and the
// [C] statistics is kept between the passes.
//
// Layout: a [n, C] row-major array, which is what a [B, C] activation and a
// channels-last [B, C, H, W] one (n = B * H * W) hold. A thread owns V
// consecutive channels (V = 4 where C allows: 16-byte float32 or 8-byte
// bfloat16 loads) and walks rows; a block's threads cover a tile of at most
// 64 such vectors over as many rows as fit in 256 threads, so each row's
// tile is one contiguous run and a thread keeps its channels' constants in
// registers. The wrapper picks V, the tiles and the partitions of the rows
// from the shape alone.
//
// What bounds it on an H100: bytes. Forward reads x twice and writes y;
// backward reads g and x twice and writes dx: 8 passes over an activation
// against about 47 op by op. Each pass is a kernel: the statistics must be
// complete before the apply pass starts, forward and backward.
//
// No float atomics: each block of a statistics pass writes its float64
// partial sums to scratch. Integer tickets find, for each channel tile, the
// last block of each group of partitions to finish, which adds the group's
// partials, and then the last group, which adds the groups' sums: every
// sum in a fixed order, about sqrt(partitions) terms a level, so no single
// block reads all the partials. The mapping depends on the shape alone, so
// a call repeats to the bit.

#pragma once

#include <cuda_runtime.h>

// PgBn of the ctypes binding: one call's tensors and sizes.
struct PgBn {
  const void* x;         // [n, C], float32 or bfloat16 (the library's)
  const void* g;         // backward: the upstream gradient, as x
  void* out;             // forward: y; backward: dx; as x
  const float* scale;    // [C]
  const float* bias;     // [C]
  const float* mean_ra;  // [C], forward only
  const float* var_ra;   // [C], forward only
  float* stats;          // [5, C]: mean, rstd, keep, new running mean and var
  float* grads;          // [4, C]: dscale, dbias, dbias / n, dscale / n or 0
  double* partial;       // [parts, C, 2], [groups, C, 2], then the int tickets
  long long rows;        // n
  int channels;          // C
  int vec;               // V: 4 or 1, dividing C
  int tiles;             // channel tiles, each at most 64 vectors
  int parts;             // partitions of the rows in the statistics pass
  int groups;            // groups of partitions in the reduction of their sums
  float eps;
  float momentum;
  float one_minus_momentum;  // rounded from the double 1 - momentum, as PyTorch's scalar
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 64;       // vectors a tile
constexpr int kApplyBlocks = 2048;  // about two waves of 8 blocks on 132 SMs

typedef unsigned short bf16_bits;  // a bfloat16's bits

__device__ __forceinline__ float bf16_to_float(unsigned bits) {
  return __uint_as_float((bits & 0xFFFFu) << 16);
}

// Round to nearest even, as PyTorch's BFloat16 conversion.
__device__ __forceinline__ unsigned float_to_bf16(float f) {
  if (f != f) return 0x7FC0u;
  const unsigned u = __float_as_uint(f);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

// V consecutive elements of a row, to float and back.
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(const bf16_bits* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_to_float(q.x), v[1] = bf16_to_float(q.x >> 16);
    v[2] = bf16_to_float(q.y), v[3] = bf16_to_float(q.y >> 16);
  } else {
    v[0] = bf16_to_float(__ldg(p));
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16_bits* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(float_to_bf16(v[0]) | (float_to_bf16(v[1]) << 16),
                   float_to_bf16(v[2]) | (float_to_bf16(v[3]) << 16));
  } else {
    *p = static_cast<bf16_bits>(float_to_bf16(v[0]));
  }
}

// A value rounded to T's precision.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2) {
    return bf16_to_float(float_to_bf16(v));
  } else {
    return v;
  }
}

// This thread's place: its lane in the tile's width (in vectors), its first
// channel, its first row within a step of rows_per_step rows, and whether
// it holds channels at all.
struct Place {
  int lane, width, c0, row_off, rows_per_step;
  bool active;
};

template <int V>
__device__ __forceinline__ Place place(const PgBn& a) {
  const int vectors = a.channels / V;
  Place p;
  p.width = (vectors + a.tiles - 1) / a.tiles;
  p.lane = threadIdx.x % p.width;
  p.row_off = threadIdx.x / p.width;
  p.rows_per_step = kThreads / p.width;
  const int vec = blockIdx.x * p.width + p.lane;
  p.c0 = vec * V;
  p.active = p.row_off < p.rows_per_step && vec < vectors;
  return p;
}

// One channel's constants.
struct Channel {
  float mean, rstd, scale, bias;
};

__device__ __forceinline__ Channel channel(const PgBn& a, int c) {
  return {a.stats[c], a.stats[a.channels + c], a.scale[c], a.bias[c]};
}

__device__ __forceinline__ float xhat(float x, const Channel& ch) {
  return __fmul_rn(__fsub_rn(x, ch.mean), ch.rstd);
}

// The activation before the ReLU, rounded to T.
template <typename T>
__device__ __forceinline__ float pre_relu(float xh, const Channel& ch) {
  return round_to<T>(__fadd_rn(__fmul_rn(xh, ch.scale), ch.bias));
}

// Rows [r0, r1) of partition ``part`` of ``parts``.
__device__ __forceinline__ void row_range(const PgBn& a, int part, int parts, long long& r0,
                                          long long& r1) {
  const long long per = (a.rows + parts - 1) / parts;
  r0 = part * per;
  r1 = r0 + per < a.rows ? r0 + per : a.rows;
}

// Sums of src's pairs over items [i0, i1) (src is [items, C, 2]) for each
// channel in [c_begin, c_end), each in a fixed order: where the channels
// are fewer than 256, K = 256 / channels threads share a channel, thread k
// adding items i0 + k, i0 + k + K, ..., and the K sums are added in order
// of k. ``out(c, sum0, sum1)`` takes channel c's. ``s``: 2 * kThreads
// doubles of shared memory.
template <typename F>
__device__ __forceinline__ void sum_items(const double* src, int i0, int i1, int c_begin,
                                          int c_end, int C, double* s, F&& out) {
  const int count = c_end - c_begin;
  const int K = count < kThreads ? kThreads / count : 1;
  const int per_round = kThreads / K;  // channels a round
  const int lane = threadIdx.x % per_round;
  const int k = threadIdx.x / per_round;
  for (int c0 = c_begin; c0 < c_end; c0 += per_round) {
    const int c = c0 + lane;
    double t0 = 0.0, t1 = 0.0;
    if (c < c_end && k < K) {
#pragma unroll 4
      for (int i = i0 + k; i < i1; i += K) {
        const double2 v =
            __ldcg(reinterpret_cast<const double2*>(src + 2 * ((long long)i * C + c)));
        t0 += v.x;
        t1 += v.y;
      }
    }
    __syncthreads();
    s[threadIdx.x] = t0;
    s[kThreads + threadIdx.x] = t1;
    __syncthreads();
    if (c < c_end && k == 0) {
      double sum0 = 0.0, sum1 = 0.0;
      for (int j = 0; j < K; ++j) {
        sum0 += s[j * per_round + lane];
        sum1 += s[kThreads + j * per_round + lane];
      }
      out(c, sum0, sum1);
    }
  }
}

// What a statistics pass makes of channel c's two sums.
__device__ __forceinline__ void finish_forward(const PgBn& a, int c, double sum, double sum_sq) {
  const int C = a.channels;
  const double n = static_cast<double>(a.rows);
  const double mean = sum / n;
  // Separate roundings, as the plain version's float64 ops round.
  const double var = __dadd_rn(sum_sq / n, -__dmul_rn(mean, mean));
  const float meanf = static_cast<float>(mean);
  const float varf = static_cast<float>(var > 0.0 ? var : 0.0);
  a.stats[c] = meanf;
  a.stats[C + c] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(varf, a.eps)));
  a.stats[2 * C + c] = var >= 0.0 ? 1.0f : 0.0f;
  a.stats[3 * C + c] = __fadd_rn(__fmul_rn(a.momentum, a.mean_ra[c]),
                                 __fmul_rn(a.one_minus_momentum, meanf));
  a.stats[4 * C + c] = __fadd_rn(__fmul_rn(a.momentum, a.var_ra[c]),
                                 __fmul_rn(a.one_minus_momentum, varf));
}

__device__ __forceinline__ void finish_backward(const PgBn& a, int c, double sg, double sgx) {
  const int C = a.channels;
  const double n = static_cast<double>(a.rows);
  a.grads[c] = static_cast<float>(sgx);
  a.grads[C + c] = static_cast<float>(sg);
  a.grads[2 * C + c] = static_cast<float>(sg / n);
  a.grads[3 * C + c] = a.stats[2 * C + c] != 0.0f ? static_cast<float>(sgx / n) : 0.0f;
}

// True in every thread of the block that is the last of ``expected`` to
// take a ticket from ``ticket``, after each has made its writes visible.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int expected, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(ticket, 1) == expected - 1;
  __syncthreads();
  const bool last = *s_last;
  if (last) __threadfence();
  return last;
}

// Statistics pass. Forward: sum(x) and sum(x^2); backward: sum(g') and
// sum(g' * xhat). Each block writes its two partials per channel; the last
// blocks to finish reduce them, in two levels.
template <typename T, int V, bool kBackward>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const __grid_constant__ PgBn a) {
  __shared__ double s_sum[2][V][kThreads];
  __shared__ bool s_last;
  const Place p = place<V>(a);
  const int C = a.channels;
  double s0[V], s1[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s0[v] = s1[v] = 0.0;
  if (p.active) {
    const T* __restrict__ x = static_cast<const T*>(a.x) + p.c0;
    long long r0, r1;
    row_range(a, blockIdx.y, a.parts, r0, r1);
    if constexpr (kBackward) {
      const T* __restrict__ g = static_cast<const T*>(a.g) + p.c0;
      Channel ch[V];
#pragma unroll
      for (int v = 0; v < V; ++v) ch[v] = channel(a, p.c0 + v);
#pragma unroll 2
      for (long long r = r0 + p.row_off; r < r1; r += p.rows_per_step) {
        float xv[V], gv[V];
        load<V>(x + r * C, xv);
        load<V>(g + r * C, gv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = xhat(xv[v], ch[v]);
          const double gp = pre_relu<T>(xh, ch[v]) <= 0.0f ? 0.0 : static_cast<double>(gv[v]);
          s0[v] += gp;
          s1[v] += gp * static_cast<double>(xh);
        }
      }
    } else {
#pragma unroll 4
      for (long long r = r0 + p.row_off; r < r1; r += p.rows_per_step) {
        float xv[V];
        load<V>(x + r * C, xv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const double d = static_cast<double>(xv[v]);
          s0[v] += d;
          s1[v] += d * d;
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s_sum[0][v][threadIdx.x] = s0[v];
    s_sum[1][v][threadIdx.x] = s1[v];
  }
  __syncthreads();
  // The first row of each lane adds its lane's rows in order.
  if (p.active && p.row_off == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      double t0 = 0.0, t1 = 0.0;
      for (int k = 0; k < p.rows_per_step; ++k) {
        t0 += s_sum[0][v][k * p.width + p.lane];
        t1 += s_sum[1][v][k * p.width + p.lane];
      }
      const long long at = 2 * ((long long)blockIdx.y * C + p.c0 + v);
      a.partial[at] = t0;
      a.partial[at + 1] = t1;
    }
  }
  // Two levels, per channel tile: the last block of each group of
  // partitions to finish adds the group's partials; the last group of the
  // tile to finish adds the groups' sums and finishes the tile's channels.
  const int per_group = (a.parts + a.groups - 1) / a.groups;
  const int used_groups = (a.parts + per_group - 1) / per_group;
  const int q = blockIdx.y / per_group;
  const int q0 = q * per_group;
  const int q1 = q0 + per_group < a.parts ? q0 + per_group : a.parts;
  const int tile_channels = p.width * V;
  const int c_begin = blockIdx.x * tile_channels;
  const int c_end = c_begin + tile_channels < C ? c_begin + tile_channels : C;
  double* group_sums = a.partial + 2 * (long long)a.parts * C;
  int* tickets = reinterpret_cast<int*>(group_sums + 2 * (long long)a.groups * C);
  double* s = &s_sum[0][0][0];
  if (!last_to_arrive(tickets + blockIdx.x * a.groups + q, q1 - q0, &s_last)) return;
  sum_items(a.partial, q0, q1, c_begin, c_end, C, s, [&](int c, double t0, double t1) {
    group_sums[2 * ((long long)q * C + c)] = t0;
    group_sums[2 * ((long long)q * C + c) + 1] = t1;
  });
  if (!last_to_arrive(tickets + a.tiles * a.groups + blockIdx.x, used_groups, &s_last)) return;
  sum_items(group_sums, 0, used_groups, c_begin, c_end, C, s, [&](int c, double t0, double t1) {
    if constexpr (kBackward) {
      finish_backward(a, c, t0, t1);
    } else {
      finish_forward(a, c, t0, t1);
    }
  });
}

// Apply pass. Forward: y = relu(z); backward: dx from g, x and the sums.
template <typename T, int V, bool kBackward>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(const __grid_constant__ PgBn a,
                                                            int parts) {
  const Place p = place<V>(a);
  if (!p.active) return;
  const int C = a.channels;
  const T* __restrict__ x = static_cast<const T*>(a.x) + p.c0;
  T* __restrict__ out = static_cast<T*>(a.out) + p.c0;
  Channel ch[V];
#pragma unroll
  for (int v = 0; v < V; ++v) ch[v] = channel(a, p.c0 + v);
  long long r0, r1;
  row_range(a, blockIdx.y, parts, r0, r1);
  if constexpr (kBackward) {
    const T* __restrict__ g = static_cast<const T*>(a.g) + p.c0;
    float mean_g[V], mean_gx[V], gain[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      mean_g[v] = a.grads[2 * C + p.c0 + v];
      mean_gx[v] = a.grads[3 * C + p.c0 + v];
      gain[v] = __fmul_rn(ch[v].rstd, ch[v].scale);
    }
#pragma unroll 2
    for (long long r = r0 + p.row_off; r < r1; r += p.rows_per_step) {
      float xv[V], gv[V], dx[V];
      load<V>(x + r * C, xv);
      load<V>(g + r * C, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = xhat(xv[v], ch[v]);
        const float gp = pre_relu<T>(xh, ch[v]) <= 0.0f ? 0.0f : gv[v];
        dx[v] = __fmul_rn(gain[v], __fsub_rn(__fsub_rn(gp, mean_g[v]),
                                             __fmul_rn(xh, mean_gx[v])));
      }
      store<V>(out + r * C, dx);
    }
  } else {
#pragma unroll 4
    for (long long r = r0 + p.row_off; r < r1; r += p.rows_per_step) {
      float xv[V];
      load<V>(x + r * C, xv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float z = pre_relu<T>(xhat(xv[v], ch[v]), ch[v]);
        xv[v] = z < 0.0f ? 0.0f : z;
      }
      store<V>(out + r * C, xv);
    }
  }
}

template <typename T, int V, bool kBackward>
cudaError_t launch(const PgBn& a, cudaStream_t stream) {
  const int width = (a.channels / V + a.tiles - 1) / a.tiles;
  const long long rows_per_step = kThreads / width;
  // About two waves of blocks, each thread applying at least 4 rows.
  long long parts = (kApplyBlocks + a.tiles - 1) / a.tiles;
  const long long most = a.rows / (4 * rows_per_step);
  parts = parts < most ? parts : most;
  parts = parts < 1 ? 1 : parts;
  cudaError_t err = cudaMemsetAsync(a.partial + 2 * (long long)(a.parts + a.groups) * a.channels,
                                    0, sizeof(int) * a.tiles * (a.groups + 1), stream);
  if (err != cudaSuccess) return err;
  bn_stats_kernel<T, V, kBackward><<<dim3(a.tiles, a.parts), kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_apply_kernel<T, V, kBackward>
      <<<dim3(a.tiles, static_cast<unsigned>(parts)), kThreads, 0, stream>>>(
          a, static_cast<int>(parts));
  return cudaGetLastError();
}

// One entry point's launches, after the arguments are checked.
template <typename T, bool kBackward>
int dispatch(const PgBn* a, void* stream) {
  const int vec = a->vec;
  if (a->channels < 1 || a->rows < 1 || (vec != 1 && vec != 4) || a->channels % vec != 0 ||
      a->tiles < 1 || a->tiles > a->channels / vec ||
      (a->channels / vec + a->tiles - 1) / a->tiles > kMaxWidth || a->parts < 1 ||
      a->parts > 65535 || a->groups < 1 || a->groups > a->parts) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec == 4 ? launch<T, 4, kBackward>(*a, s)
                                   : launch<T, 1, kBackward>(*a, s));
}

}  // namespace
