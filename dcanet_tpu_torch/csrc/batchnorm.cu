// Train-mode BatchNorm for Hopper (sm_90a): the batch statistics, the
// normalisation and the backward of a channels-first tensor (N, C, S), with
// S = D*H*W (BatchNorm3d) or H*W (BatchNorm2d).
//
//   mean[c] = sum_{n,s} x[n, c, s] / (N*S),  var[c] = sum (x - mean)^2 / (N*S)
//   y = (x - mean) * rsqrt(var + eps) * gamma + beta
//   running_mean += momentum * (mean - running_mean), running_var likewise
//   with var: flax's train mode, the BIASED variance in both places (not
//   updated under nn/layers.py::frozen_bn_statistics).
// Backward, with xhat = (x - mean) * invstd and n = N*S:
//   dbeta = sum dy,  dgamma = sum dy * xhat,
//   dx = (dy - dbeta / n - xhat * dgamma / n) * gamma * invstd.
// x, y, dy, dx are f32 or bf16; the statistics, gamma, beta, the running
// buffers and every sum are f32.
//
// Replaces no Pallas kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it into its neighbours on the TPU. The port ran PyTorch's own
// kernels, whose channels-first path launches one block per channel, so a
// BatchNorm of 32 or 64 channels ran 32-64 blocks on the card's 132 SMs,
// each walking its channel's 4.7 M elements (the kitti preset's step at
// batch 12), and it took a second statistics pass over an f32 copy of x for
// the running statistics.
//
// Bound: memory traffic. The least a bf16 forward moves is 6 bytes an
// element (read x for the statistics; read x, write y) and a backward 10
// (read x and dy for the sums; read x and dy, write dx): 16 B an element,
// 2.4 GB or 0.72 ms at 3.35 TB/s for one call of the kitti step's largest
// BatchNorm (12, 32, 48, 64, 128); f32 doubles it. The arithmetic, a few
// operations an element, is far below the card's rate.
//
// Design: every kernel runs a grid of (splits, C) blocks, and block (k, c)
// walks split k of channel c: the elements e in [lo_k, hi_k) of the channel
// in the order e = n*S + s, the even share of N*S rounded down to a whole
// vector (split_start). `splits` (bn_splits) is chosen so that C * splits
// fills the card with kBlocksPerSm blocks on each SM at once, whatever C,
// which is the split grid's answer to the bound: every SM streams, where the
// one-block-per-channel grid left three quarters of them idle. A row (n, c)
// is S contiguous elements; each part of a row that a split covers is read
// as 16-byte vectors where they are aligned (the element offset a multiple
// of V = 16 / sizeof(T)), with a scalar head and tail where S*sizeof(T) % 16
// != 0 leaves the rows unaligned. Neighbouring threads read neighbouring
// vectors, kUnroll of them in flight per thread.
//   1. bn_stats_kernel: each thread keeps f32 (count, mean, M2) and merges
//      each vector's own (V, mean, M2) into them by Chan's rule (each head
//      or tail element as a run of one); the block merges its threads' by
//      warp shuffles and shared memory, and writes one partial per block.
//   2. bn_normalize_kernel: each block merges its channel's `splits`
//      partials (one warp, in a fixed order, so every block of a channel
//      finds the same mean and invstd), then writes y = (x - mean) * scale
//      + beta over its split. Block 0 of each channel also stores mean and
//      invstd for the backward and updates the running statistics in place:
//      the finalize step needs no launch of its own.
//   3. bn_backward_reduce_kernel: the same grid over x and dy; per-thread f32
//      sums of dy and dy * (x - mean), summed by the block into one partial.
//   4. bn_backward_kernel: each block sums its channel's partials, then
//      writes dx = k*(dy - dbeta/n) + p*(x - mean) over its split, x-hat
//      recomputed from x, mean and invstd (the saved tensors are x and two
//      f32 vectors of C, as PyTorch's); with one value per channel both
//      differences are 0 exactly, and so is dx. Block 0 of each channel
//      writes dgamma and dbeta.
// Two launches a forward, two a backward; nothing is allocated here (the
// caller passes the partials' buffer, bn_splits sizes it); every launch is on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Launch shape of every kernel: kThreads threads a block; a channel split in
// so many blocks that C * splits blocks fill kBlocksPerSm blocks on each SM,
// but none with fewer than kMinSplit elements (bn_splits); kUnroll 16-byte
// loads in flight per thread.
// tests/test_torch_batchnorm.py reads these lines to emulate the kernels' index map.
struct BnShape {
  static constexpr int kThreads = 256, kBlocksPerSm = 4, kUnroll = 4, kMinSplit = 8192;
};

constexpr int kWarps = BnShape::kThreads / 32;

__host__ __device__ constexpr long long lmin(long long a, long long b) { return a < b ? a : b; }
__host__ __device__ constexpr long long lmax(long long a, long long b) { return a > b ? a : b; }

// Blocks per channel: as many as fill kBlocksPerSm blocks on every SM over
// the C channels (at least one), and no more than leave each block
// kMinSplit elements.
int bn_splits(int C, long long NS, int sms) {
  const long long fill = lmax(1, (long long)sms * BnShape::kBlocksPerSm / C);
  const long long most = lmax(1, (NS + BnShape::kMinSplit - 1) / BnShape::kMinSplit);
  return (int)lmin(fill, most);
}

// The elements move as raw bits: 16-byte vectors of V elements, unpacked to
// f32 and packed back with round-to-nearest-even.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kV = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float load1(const float* p) { return *p; }
  static __device__ __forceinline__ void store1(float* p, float v) { *p = v; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kV = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack2(float a, float b) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return (unsigned)__bfloat16_as_ushort(p.x) | ((unsigned)__bfloat16_as_ushort(p.y) << 16);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float((unsigned)__bfloat16_as_ushort(*p) << 16);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// First element (in the channel's order e = n*S + s) of split k of
// `splits`: the even share of NS, rounded down to a whole vector; the last
// split ends at NS.
__device__ __forceinline__ long long split_start(long long NS, int k, int splits, int V) {
  return k >= splits ? NS : NS * k / splits / V * V;
}

// seg(off, head, nvec, tail) for each row (n, c) that the elements [lo, hi)
// of channel c touch, in order of n: off is the tensor offset of the part's
// first element; `head` scalars from there, then `nvec` aligned vectors of V
// elements, then `tail` scalars.
template <int V, typename F>
__device__ __forceinline__ void for_each_segment(int c, int C, long long S, long long lo, long long hi, F&& seg) {
  for (long long n = lo / S; n * S < hi; ++n) {
    const long long a = lmax(lo - n * S, 0), b = lmin(hi - n * S, S);
    const long long off = (n * C + c) * S + a;
    const int head = (int)lmin((V - off % V) % V, b - a);
    const long long nvec = (b - a - head) / V;
    const int tail = (int)(b - a - head - nvec * V);
    seg(off, head, nvec, tail);
  }
}

// Count, mean and sum of squared deviations of a run of values, merged by
// Chan's rule.
struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float d = b.mean - a.mean, r = b.n / n;
  return {n, fmaf(d, r, a.mean), a.m2 + b.m2 + d * d * a.n * r};
}

template <int V>
__device__ __forceinline__ Moments run_moments(const float (&f)[V]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) s += f[k];
  const float mean = s * (1.f / V);
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = f[k] - mean;
    m2 = fmaf(d, d, m2);
  }
  return {(float)V, mean, m2};
}

__device__ __forceinline__ Moments shfl_down(const Moments& m, int o) {
  return {__shfl_down_sync(0xffffffffu, m.n, o), __shfl_down_sync(0xffffffffu, m.mean, o),
          __shfl_down_sync(0xffffffffu, m.m2, o)};
}

// Lane 0 ends with the merge of the warp's 32: lane i takes lane i + o's at
// o = 16, 8, 4, 2, 1.
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = merge(m, shfl_down(m, o));
  return m;
}

// Thread 0 ends with the merge of the block's threads: each warp's, then
// warp 0 merges the warps' in the same tree.
__device__ __forceinline__ Moments block_merge(Moments m) {
  __shared__ Moments part[kWarps];
  m = warp_merge(m);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? part[lane] : Moments{0.f, 0.f, 0.f};
    m = warp_merge(m);
  }
  return m;
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
  }
  return v;
}

__device__ __forceinline__ float2 block_sum(float2 v) {
  __shared__ float2 part[kWarps];
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < kWarps ? part[lane] : make_float2(0.f, 0.f));
  return v;
}

// The kUnroll vectors j0 + i*kThreads (i < kUnroll) of a part that exist.
template <typename T>
__device__ __forceinline__ void load_vectors(const T* p, long long j0, long long nvec, uint4 (&u)[BnShape::kUnroll]) {
  const uint4* pv = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < BnShape::kUnroll; ++i) {
    const long long j = j0 + (long long)i * BnShape::kThreads;
    u[i] = j < nvec ? pv[j] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Pass 1: one (count, mean, M2) partial per block, at partials[(c * splits
// + k) * 3].
template <typename T>
__global__ void __launch_bounds__(BnShape::kThreads, BnShape::kBlocksPerSm)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials, int C, long long S, long long NS) {
  constexpr int V = Vec<T>::kV, U = BnShape::kUnroll, TH = BnShape::kThreads;
  const int k = blockIdx.x, c = blockIdx.y, splits = gridDim.x, t = threadIdx.x;
  const long long lo = split_start(NS, k, splits, V), hi = split_start(NS, k + 1, splits, V);
  Moments m{0.f, 0.f, 0.f};
  for_each_segment<V>(c, C, S, lo, hi, [&](long long off, int head, long long nvec, int tail) {
    const T* p = x + off;
    if (t < head) m = merge(m, Moments{1.f, Vec<T>::load1(p + t), 0.f});
    const T* body = p + head;
    for (long long j0 = t; j0 < nvec; j0 += (long long)U * TH) {
      uint4 u[U];
      load_vectors(body, j0, nvec, u);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (j0 + (long long)i * TH < nvec) {
          float f[V];
          Vec<T>::unpack(u[i], f);
          m = merge(m, run_moments<V>(f));
        }
      }
    }
    if (t < tail) m = merge(m, Moments{1.f, Vec<T>::load1(body + nvec * V + t), 0.f});
  });
  m = block_merge(m);
  if (t == 0) {
    float* o = partials + ((long long)c * splits + k) * 3;
    o[0] = m.n;
    o[1] = m.mean;
    o[2] = m.m2;
  }
}

// Pass 2: the channel's statistics from its partials, then y over the split.
template <typename T>
__global__ void __launch_bounds__(BnShape::kThreads, BnShape::kBlocksPerSm)
    bn_normalize_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ partials,
                        const float* __restrict__ weight, const float* __restrict__ bias, float* running_mean,
                        float* running_var, float* __restrict__ save_mean, float* __restrict__ save_invstd, int C,
                        long long S, long long NS, float eps, float momentum, int update) {
  constexpr int V = Vec<T>::kV, U = BnShape::kUnroll, TH = BnShape::kThreads;
  const int k = blockIdx.x, c = blockIdx.y, splits = gridDim.x, t = threadIdx.x;
  __shared__ float coef[3];
  if (t < 32) {
    Moments m{0.f, 0.f, 0.f};
    for (int j = t; j < splits; j += 32) {
      const float* p = partials + ((long long)c * splits + j) * 3;
      m = merge(m, Moments{p[0], p[1], p[2]});
    }
    m = warp_merge(m);
    if (t == 0) {
      const float var = m.m2 / m.n;
      const float invstd = rsqrtf(var + eps);
      coef[0] = m.mean;
      coef[1] = invstd * weight[c];
      coef[2] = bias[c];
      if (k == 0) {
        save_mean[c] = m.mean;
        save_invstd[c] = invstd;
        if (update) {
          running_mean[c] += momentum * (m.mean - running_mean[c]);
          running_var[c] += momentum * (var - running_var[c]);
        }
      }
    }
  }
  __syncthreads();
  const float mean = coef[0], scale = coef[1], shift = coef[2];
  const long long lo = split_start(NS, k, splits, V), hi = split_start(NS, k + 1, splits, V);
  for_each_segment<V>(c, C, S, lo, hi, [&](long long off, int head, long long nvec, int tail) {
    if (t < head) Vec<T>::store1(y + off + t, fmaf(Vec<T>::load1(x + off + t) - mean, scale, shift));
    const long long b = off + head;
    uint4* out = reinterpret_cast<uint4*>(y + b);
    for (long long j0 = t; j0 < nvec; j0 += (long long)U * TH) {
      uint4 u[U];
      load_vectors(x + b, j0, nvec, u);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const long long j = j0 + (long long)i * TH;
        if (j < nvec) {
          float f[V];
          Vec<T>::unpack(u[i], f);
#pragma unroll
          for (int q = 0; q < V; ++q) f[q] = fmaf(f[q] - mean, scale, shift);
          out[j] = Vec<T>::pack(f);
        }
      }
    }
    const long long e = b + nvec * V;
    if (t < tail) Vec<T>::store1(y + e + t, fmaf(Vec<T>::load1(x + e + t) - mean, scale, shift));
  });
}

// Backward pass 1: per block the sums of dy and dy * (x - mean) over its
// split, at partials[(c * splits + k) * 2].
template <typename T>
__global__ void __launch_bounds__(BnShape::kThreads, BnShape::kBlocksPerSm)
    bn_backward_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ save_mean,
                              float* __restrict__ partials, int C, long long S, long long NS) {
  constexpr int V = Vec<T>::kV, U = BnShape::kUnroll, TH = BnShape::kThreads;
  const int k = blockIdx.x, c = blockIdx.y, splits = gridDim.x, t = threadIdx.x;
  const float mean = save_mean[c];
  float2 s = make_float2(0.f, 0.f);
  const long long lo = split_start(NS, k, splits, V), hi = split_start(NS, k + 1, splits, V);
  for_each_segment<V>(c, C, S, lo, hi, [&](long long off, int head, long long nvec, int tail) {
    if (t < head) {
      const float g = Vec<T>::load1(dy + off + t);
      s.x += g;
      s.y = fmaf(g, Vec<T>::load1(x + off + t) - mean, s.y);
    }
    const long long b = off + head;
    for (long long j0 = t; j0 < nvec; j0 += (long long)U * TH) {
      uint4 ug[U], ux[U];
      load_vectors(dy + b, j0, nvec, ug);
      load_vectors(x + b, j0, nvec, ux);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        if (j0 + (long long)i * TH < nvec) {
          float g[V], f[V];
          Vec<T>::unpack(ug[i], g);
          Vec<T>::unpack(ux[i], f);
#pragma unroll
          for (int q = 0; q < V; ++q) {
            s.x += g[q];
            s.y = fmaf(g[q], f[q] - mean, s.y);
          }
        }
      }
    }
    const long long e = b + nvec * V;
    if (t < tail) {
      const float g = Vec<T>::load1(dy + e + t);
      s.x += g;
      s.y = fmaf(g, Vec<T>::load1(x + e + t) - mean, s.y);
    }
  });
  s = block_sum(s);
  if (t == 0) {
    float* o = partials + ((long long)c * splits + k) * 2;
    o[0] = s.x;
    o[1] = s.y;
  }
}

// Backward pass 2: the channel's sums from its partials, then dx over the
// split; block 0 of the channel writes dgamma and dbeta.
template <typename T>
__global__ void __launch_bounds__(BnShape::kThreads, BnShape::kBlocksPerSm)
    bn_backward_kernel(const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
                       const float* __restrict__ partials, T* __restrict__ dx, float* __restrict__ dweight,
                       float* __restrict__ dbias, int C, long long S, long long NS) {
  constexpr int V = Vec<T>::kV, U = BnShape::kUnroll, TH = BnShape::kThreads;
  const int k = blockIdx.x, c = blockIdx.y, splits = gridDim.x, t = threadIdx.x;
  __shared__ float coef[3];
  if (t < 32) {
    float2 s = make_float2(0.f, 0.f);
    for (int j = t; j < splits; j += 32) {
      const float* p = partials + ((long long)c * splits + j) * 2;
      s.x += p[0];
      s.y += p[1];
    }
    s = warp_sum(s);
    if (t == 0) {
      const float invstd = save_invstd[c], inv_n = 1.f / (float)NS;
      const float dgamma = s.y * invstd;
      const float kk = weight[c] * invstd;
      coef[0] = kk;                                // of dy - dbeta/n
      coef[1] = -kk * invstd * dgamma * inv_n;     // of x - mean
      coef[2] = s.x * inv_n;                       // dbeta/n, the mean of dy
      if (k == 0) {
        dweight[c] = dgamma;
        dbias[c] = s.x;
      }
    }
  }
  __syncthreads();
  const float kk = coef[0], p = coef[1], mdy = coef[2], mean = save_mean[c];
  const long long lo = split_start(NS, k, splits, V), hi = split_start(NS, k + 1, splits, V);
  for_each_segment<V>(c, C, S, lo, hi, [&](long long off, int head, long long nvec, int tail) {
    if (t < head)
      Vec<T>::store1(dx + off + t,
                     fmaf(kk, Vec<T>::load1(dy + off + t) - mdy, p * (Vec<T>::load1(x + off + t) - mean)));
    const long long b = off + head;
    uint4* out = reinterpret_cast<uint4*>(dx + b);
    for (long long j0 = t; j0 < nvec; j0 += (long long)U * TH) {
      uint4 ug[U], ux[U];
      load_vectors(dy + b, j0, nvec, ug);
      load_vectors(x + b, j0, nvec, ux);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const long long j = j0 + (long long)i * TH;
        if (j < nvec) {
          float g[V], f[V];
          Vec<T>::unpack(ug[i], g);
          Vec<T>::unpack(ux[i], f);
#pragma unroll
          for (int r = 0; r < V; ++r) f[r] = fmaf(kk, g[r] - mdy, p * (f[r] - mean));
          out[j] = Vec<T>::pack(f);
        }
      }
    }
    const long long e = b + nvec * V;
    if (t < tail)
      Vec<T>::store1(dx + e + t, fmaf(kk, Vec<T>::load1(dy + e + t) - mdy, p * (Vec<T>::load1(x + e + t) - mean)));
  });
}

bool aligned16(const void* p) { return (size_t)p % 16 == 0; }

cudaError_t check_shape(int N, int C, long long S, int splits) {
  if (N <= 0 || C <= 0 || S <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (C > 65535 || splits > 0x7fffffff / C) return cudaErrorInvalidValue;  // gridDim.y, the partials' index
  return cudaSuccess;
}

template <typename T>
int forward(const void* x, void* y, const void* weight, const void* bias, void* running_mean, void* running_var,
            void* save_mean, void* save_invstd, void* partials, int N, int C, long long S, int splits, float eps,
            float momentum, int update, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check_shape(N, C, S, splits);
  if (err != cudaSuccess) return (int)err;
  if (!aligned16(x) || !aligned16(y)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(splits, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NS = (long long)N * S;
  bn_stats_kernel<T><<<grid, BnShape::kThreads, 0, s>>>(static_cast<const T*>(x), static_cast<float*>(partials), C,
                                                          S, NS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_normalize_kernel<T><<<grid, BnShape::kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(partials),
      static_cast<const float*>(weight), static_cast<const float*>(bias), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<float*>(save_mean), static_cast<float*>(save_invstd), C, S, NS,
      eps, momentum, update);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const void* dy, const void* x, const void* weight, const void* save_mean, const void* save_invstd,
             void* dx, void* dweight, void* dbias, void* partials, int N, int C, long long S, int splits, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = check_shape(N, C, S, splits);
  if (err != cudaSuccess) return (int)err;
  if (!aligned16(dy) || !aligned16(x) || !aligned16(dx)) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(splits, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NS = (long long)N * S;
  bn_backward_reduce_kernel<T><<<grid, BnShape::kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(save_mean),
      static_cast<float*>(partials), C, S, NS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_backward_kernel<T><<<grid, BnShape::kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const float*>(weight),
      static_cast<const float*>(save_mean), static_cast<const float*>(save_invstd),
      static_cast<const float*>(partials), static_cast<T*>(dx), static_cast<float*>(dweight),
      static_cast<float*>(dbias), C, S, NS);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers and the stream are passed as
// void*; a launch returns the cudaError_t of its launches (0 = success). x,
// y, dy and dx are contiguous (N, C, S) on 16-byte boundaries; weight, bias,
// the running buffers, save_mean, save_invstd, dweight and dbias hold C
// floats; the partials C * splits * 3 floats in a forward, C * splits * 2 in
// a backward.

// Blocks per channel for C channels of N*S elements on the device (-1 for a
// shape the kernels do not take).
extern "C" int batchnorm_splits(int C, long long NS, int device) {
  int sms = 0;
  if (C <= 0 || NS <= 0 || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  return bn_splits(C, NS, sms);
}

// y, save_mean, save_invstd; the running buffers updated unless update == 0.
extern "C" int batchnorm_forward_f32(const void* x, void* y, const void* weight, const void* bias,
                                     void* running_mean, void* running_var, void* save_mean, void* save_invstd,
                                     void* partials, int N, int C, long long S, int splits, float eps,
                                     float momentum, int update, int device, void* stream) {
  return forward<float>(x, y, weight, bias, running_mean, running_var, save_mean, save_invstd, partials, N, C, S,
                        splits, eps, momentum, update, device, stream);
}

extern "C" int batchnorm_forward_bf16(const void* x, void* y, const void* weight, const void* bias,
                                      void* running_mean, void* running_var, void* save_mean, void* save_invstd,
                                      void* partials, int N, int C, long long S, int splits, float eps,
                                      float momentum, int update, int device, void* stream) {
  return forward<__nv_bfloat16>(x, y, weight, bias, running_mean, running_var, save_mean, save_invstd, partials, N,
                                C, S, splits, eps, momentum, update, device, stream);
}

// dx, dweight, dbias from dy and the forward's x, weight, save_mean and
// save_invstd.
extern "C" int batchnorm_backward_f32(const void* dy, const void* x, const void* weight, const void* save_mean,
                                      const void* save_invstd, void* dx, void* dweight, void* dbias, void* partials,
                                      int N, int C, long long S, int splits, int device, void* stream) {
  return backward<float>(dy, x, weight, save_mean, save_invstd, dx, dweight, dbias, partials, N, C, S, splits, device,
                         stream);
}

extern "C" int batchnorm_backward_bf16(const void* dy, const void* x, const void* weight, const void* save_mean,
                                       const void* save_invstd, void* dx, void* dweight, void* dbias, void* partials,
                                       int N, int C, long long S, int splits, int device, void* stream) {
  return backward<__nv_bfloat16>(dy, x, weight, save_mean, save_invstd, dx, dweight, dbias, partials, N, C, S, splits,
                                 device, stream);
}
