// Group-wise correlation cost volume for Hopper (sm_90a).
//
//   out[b, g, d, h, w] = mean_{c in group g} L[b, c, h, w] * R[b, c, h, w - d]
//   out[b, g, d, h, w] = 0 for w < d (the occluded left margin; every plane
//   with d >= W is all zeros).
//
// Layouts: L, R are NCHW (B, C, H, W), as the port's 2D convs emit them; the
// volume is written straight into NCDHW (B, G, D, H, W), the layout F.conv3d
// consumes. f32 or bf16 in, f32 accumulation, the input type out.
//
// Replaces dcanet_tpu/kernels/gwc.py::_gwc_kernel (the Pallas TPU kernel,
// launched by _gwc_forward). The TPU kernel's (B, H, D/8) grid and its
// block-diagonal (C, G) matmul are a TPU layout choice and are not carried
// over.
//
// Bound: memory traffic. At the main path's shape (B=1, C=320, H=96, W=312,
// G=40, D=48) in f32 the kernel must read 2*96*312*320*4 B = 76.7 MB and write
// 40*48*96*312*4 B = 230 MB, ~307 MB in all: ~92 us at 3.35 TB/s. In bf16 the
// traffic halves (~46 us). The arithmetic, 2*C*D*H*W = 0.92 GFLOP, is far
// below the card's float32 rate.
//
// Design: the work items are (b, g, h, W-tile of kTW output columns), tile
// fastest; as many blocks as the card holds at once each walk their items.
// For an item the block stages the group's CPG rows of L[w0, w0 + kTW) and of
// R[w0 - DC, w0 + kTW) in shared memory (DC = kSlices * kND disparities per
// pass; zeros outside [0, W)), with asynchronous 16-byte copies (cp.async)
// where the rows are aligned (W % kV == 0) and scalar loads otherwise; the
// next item's copies are in flight while this one is computed (two
// buffers, where they fit in 48 KB). Thread (cg, s) owns the kV columns
// w0 + cg*kV + [0, kV) and the kND disparities dc + s*kND + [0, kND). For
// each channel c (in order) it reads its kV left values and one strip of
// kND + kV right values R[w - d] that covers all its (d, w) pairs, in shared
// loads of up to 16 bytes, and does kND * kV FMAs: the right window slides
// one column per d inside the strip, in registers. Sums run in f32 over
// c = 0..CPG-1, are divided by CPG and rounded once. For each d the thread
// writes its kV outputs with one vector store (16 bytes for f32 and bf16),
// the w < d zeros masked into it; neighbouring threads write neighbouring
// columns. A D larger than DC takes further passes over the same item, each
// staging its own window of R. Ragged W (W % kV != 0) or unaligned pointers
// take scalar loads and stores in the same kernel.
//
// Backward (gwc_volume_backward_*), given the volume's grad Gv (B, G, D, H, W)
// and cpg = C/G, g = c / cpg:
//   dL[b, c, h, w]  = (1/cpg) sum_{d <= w}       Gv[b, g, d, h, w]      R[b, c, h, w - d]
//   dR[b, c, h, w'] = (1/cpg) sum_{d: w'+d < W}  Gv[b, g, d, h, w' + d] L[b, c, h, w' + d]
// It replaces the JAX package's backward of the same kernel (gwc.py::_bwd,
// XLA linear transposes). One thread per (b, g, h, w) writes dL and dR for
// the group's cpg channels, so each Gv element is read twice per group and
// not once per channel; no atomics. Reads of Gv, L, R and the writes coalesce
// along w. Sums in f32, rounded once to the input type.
// Bound: memory traffic. At the SceneFlow train shape (B=1, C=320, H=64,
// W=128, G=40, D=48) in f32 it must read Gv (62.9 MB) and L, R (21.0 MB) and
// write dL, dR (21.0 MB): ~105 MB, ~31 us at 3.35 TB/s; ~0.4 GFLOP of
// products. bf16 halves the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <numeric>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kThreads = 256;  // the backward kernel's block

// Tile of the forward kernel per element type: kTW output columns per block,
// kV columns per thread (one store of kV elements per d), kND disparities per
// thread, kSlices threads along d; (kTW / kV) * kSlices threads per block.
// tests/test_torch_gwc.py reads these lines to emulate the kernel's index map.
template <typename T>
struct FwdTile;
template <>
struct FwdTile<float> {
  static constexpr int kTW = 128, kV = 4, kND = 12, kSlices = 4;
};
template <>
struct FwdTile<__nv_bfloat16> {
  static constexpr int kTW = 128, kV = 8, kND = 8, kSlices = 6;
};

// The forward kernel moves elements as raw bits and converts by hand.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using bits = unsigned int;
  static __device__ __forceinline__ float to_f32(bits v) { return __uint_as_float(v); }
  template <int N>
  static __device__ __forceinline__ void round(const float (&x)[N], bits (&o)[N]) {
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = __float_as_uint(x[k]);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float to_f32(bits v) { return __uint_as_float((unsigned int)v << 16); }
  // round to nearest even, two values per instruction (cvt.rn.bf16x2.f32)
  template <int N>
  static __device__ __forceinline__ void round(const float (&x)[N], bits (&o)[N]) {
#pragma unroll
    for (int k = 0; k + 1 < N; k += 2) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(x[k], x[k + 1]);
      o[k] = __bfloat16_as_ushort(p.x);
      o[k + 1] = __bfloat16_as_ushort(p.y);
    }
    if (N % 2) o[N - 1] = __bfloat16_as_ushort(__float2bfloat16(x[N - 1]));
  }
};

template <int BYTES>
struct VecOf;
template <>
struct VecOf<4> { using type = unsigned int; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<16> { using type = uint4; };

__host__ __device__ constexpr int cgcd(int a, int b) { return b ? cgcd(b, a % b) : a; }

// N consecutive elements at src, which is aligned to U elements, in loads of
// U elements each.
template <typename S, int N, int U>
__device__ __forceinline__ void load_run(const S* src, S (&dst)[N]) {
  static_assert(N % U == 0, "a run is a whole number of loads");
  using V = typename VecOf<U * sizeof(S)>::type;
#pragma unroll
  for (int i = 0; i < N / U; ++i) {
    union { V v; S e[U]; } u;
    u.v = reinterpret_cast<const V*>(src)[i];
#pragma unroll
    for (int k = 0; k < U; ++k) dst[i * U + k] = u.e[k];
  }
}

// Asynchronous copy of BYTES (4, 8 or 16) from global src to shared dst;
// zeros in place of the source when `valid` is false (src-size 0: nothing
// is read). Completes at cp_async_wait_group, in the group of the next
// cp_async_commit.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned int sdst = (unsigned int)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(sdst), "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [col, col + N) of a global row into shared dst, zero outside
// [0, W). With `vec` (W % N == 0, col % N == 0, the row aligned to N
// elements) the N columns lie wholly inside or outside and move as one
// asynchronous copy; otherwise as scalar loads.
template <typename S, int N>
__device__ __forceinline__ void stage_run(const S* __restrict__ row, int col, int W, bool vec, S* dst) {
  if (vec) {
    const bool inside = col >= 0 && col < W;
    cp_async<N * sizeof(S)>(dst, row + (inside ? col : 0), inside);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) dst[k] = (col + k >= 0 && col + k < W) ? row[col + k] : S(0);
  }
}

// N elements to global dst, aligned to N elements, in one store.
template <typename S, int N>
__device__ __forceinline__ void store_run(S* dst, const S (&src)[N]) {
  using V = typename VecOf<N * sizeof(S)>::type;
  union { V v; S e[N]; } u;
#pragma unroll
  for (int k = 0; k < N; ++k) u.e[k] = src[k];
  *reinterpret_cast<V*>(dst) = u.v;
}

template <typename T>
struct FwdShape {
  using F = FwdTile<T>;
  static constexpr int kCols = F::kTW / F::kV;            // column groups per block
  static constexpr int kThreads = kCols * F::kSlices;
  static constexpr int kPass = F::kSlices * F::kND;       // disparities per pass
  static constexpr int kRW = F::kTW + kPass;              // staged right columns
  static constexpr int kMinBlocks = 512 / kThreads > 0 ? 512 / kThreads : 1;
};

template <typename T, int CPG>
__global__ void __launch_bounds__(FwdShape<T>::kThreads, FwdShape<T>::kMinBlocks)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
                  int G, int H, int W, int D, int tiles, int items, bool vec) {
  using E = Elem<T>;
  using S = typename E::bits;
  using F = FwdTile<T>;
  using Sh = FwdShape<T>;
  constexpr int TW = F::kTW, V = F::kV, ND = F::kND, NCG = Sh::kCols;
  constexpr int DC = Sh::kPass, RW = Sh::kRW;
  constexpr int U = cgcd(cgcd(V, ND), 16 / (int)sizeof(S));  // elements per shared load of the strip
  // two buffers (the next item staged while this one is computed) where
  // they fit in the 48 KB of static shared memory
  constexpr int NBUF = 2 * CPG * (TW + RW) * (int)sizeof(S) <= 48 * 1024 ? 2 : 1;
  static_assert(TW % V == 0 && DC % V == 0, "the tile and the pass are whole column groups");
  static_assert(V * sizeof(S) <= 16, "one store of at most 16 bytes per thread and d");
  __shared__ __align__(16) S ls[NBUF][CPG][TW];
  __shared__ __align__(16) S rs[NBUF][CPG][RW];

  const int t = threadIdx.x;
  const int cg = t % NCG, s = t / NCG;
  const long long plane = (long long)H * W;

  // work item -> (b, g, h, tile), tile fastest: the first column, the rows
  // of channel g*CPG at (b, h, 0) in L and R, and out[b, g, 0, h, 0]
  struct Item {
    int w0;
    const S* l;
    const S* r;
    S* o;
  };
  auto decode = [&](int item) {
    const int tile = item % tiles;
    item /= tiles;
    const int h = item % H;
    item /= H;
    const long long bg = item;  // b * G + g
    const long long fbase = bg * CPG * plane + (long long)h * W;
    return Item{tile * TW, reinterpret_cast<const S*>(left) + fbase, reinterpret_cast<const S*>(right) + fbase,
                 reinterpret_cast<S*>(out) + bg * D * plane + (long long)h * W};
  };
  // R[w0 - dc - DC, w0 + TW) of the item's rows into rs[buf], and for the
  // first pass L[w0, w0 + TW) into ls[buf]; one commit group
  auto stage = [&](const Item& it, int buf, int dc) {
    if (dc == 0) {
      for (int i = t; i < CPG * NCG; i += Sh::kThreads) {
        const int c = i / NCG, j = (i % NCG) * V;
        stage_run<S, V>(it.l + c * plane, it.w0 + j, W, vec, &ls[buf][c][j]);
      }
    }
    const int a = it.w0 - dc - DC;  // column of rs[buf][.][0]
    for (int i = t; i < CPG * (RW / V); i += Sh::kThreads) {
      const int c = i / (RW / V), j = (i % (RW / V)) * V;
      stage_run<S, V>(it.r + c * plane, a + j, W, vec, &rs[buf][c][j]);
    }
    cp_async_commit();
  };

  int item = blockIdx.x;
  if (item >= items) return;
  stage(decode(item), 0, 0);
  for (int n = 0; item < items; ++n, item += gridDim.x) {
    const int buf = NBUF == 2 ? n & 1 : 0;
    const int next = item + gridDim.x;
    if (NBUF == 2 && next < items) {
      stage(decode(next), buf ^ 1, 0);
      cp_async_wait_group<1>();  // this item's group has landed, the next one's may be in flight
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const Item it = decode(item);
    const int wv = it.w0 + cg * V;  // this thread's first column
    for (int dc = 0; dc < D; dc += DC) {
      if (dc) {  // a further pass over d: this item's own window of R
        __syncthreads();
        stage(it, buf, dc);
        cp_async_wait_group<0>();
        __syncthreads();
      }
      const int d0 = dc + s * ND;
      if (wv >= W || d0 >= D) continue;

      // out(d0 + k, wv + v) needs R[wv + v - d0 - k] = rs[buf][c][j0 + v - k + ND]
      const int j0 = cg * V + DC - (s + 1) * ND;
      float acc[ND][V];
#pragma unroll
      for (int k = 0; k < ND; ++k)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < CPG; ++c) {
        S lb[V], rb[ND + V];
        load_run<S, V, V>(&ls[buf][c][cg * V], lb);
        load_run<S, ND + V, U>(&rs[buf][c][j0], rb);
        float l[V], r[ND + V];
#pragma unroll
        for (int v = 0; v < V; ++v) l[v] = E::to_f32(lb[v]);
#pragma unroll
        for (int k = 1; k < ND + V; ++k) r[k] = E::to_f32(rb[k]);
#pragma unroll
        for (int k = 0; k < ND; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k][v] = fmaf(l[v], r[v - k + ND], acc[k][v]);
      }
#pragma unroll
      for (int k = 0; k < ND; ++k) {
        const int d = d0 + k;
        if (d >= D) break;
        float x[V];
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = wv + v >= d ? acc[k][v] / (float)CPG : 0.0f;
        S o[V];
        E::round(x, o);
        S* dst = it.o + d * plane + wv;
        if (vec) {
          store_run<S, V>(dst, o);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (wv + v < W) dst[v] = o[v];
        }
      }
    }
    __syncthreads();  // rs[buf], ls[buf] are read: free to refill
    if (NBUF == 1 && next < items) stage(decode(next), 0, 0);
  }
}

template <typename T, int CPG>
__global__ void __launch_bounds__(kThreads)
gwc_volume_backward_kernel(const T* __restrict__ grad, const T* __restrict__ left,
                           const T* __restrict__ right, T* __restrict__ dleft,
                           T* __restrict__ dright, int B, int G, int H, int W, int D) {
  const long long n = (long long)B * G * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int w = (int)(idx % W);
  long long t = idx / W;
  const int h = (int)(t % H);
  t /= H;
  const int g = (int)(t % G);
  const int b = (int)(t / G);

  const long long plane = (long long)H * W;
  const long long C = (long long)G * CPG;
  const long long fbase = ((long long)b * C + (long long)g * CPG) * plane + (long long)h * W;
  // Gv[b, g, 0, h, 0]
  const T* gv = grad + ((long long)b * G + g) * D * plane + (long long)h * W;

  float dl[CPG], dr[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) dl[c] = dr[c] = 0.0f;

  // dL: the volume entries at this pixel, against R shifted left by d
  const int dl_end = min(D - 1, w);
  for (int d = 0; d <= dl_end; ++d) {
    const float gd = to_f32(gv[d * plane + w]);
#pragma unroll
    for (int c = 0; c < CPG; ++c) dl[c] += gd * to_f32(right[fbase + c * plane + w - d]);
  }
  // dR: the volume entries at w + d, against L at w + d
  const int dr_end = min(D - 1, W - 1 - w);
  for (int d = 0; d <= dr_end; ++d) {
    const float gd = to_f32(gv[d * plane + w + d]);
#pragma unroll
    for (int c = 0; c < CPG; ++c) dr[c] += gd * to_f32(left[fbase + c * plane + w + d]);
  }
  const float inv = 1.0f / (float)CPG;
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    dleft[fbase + c * plane + w] = from_f32<T>(dl[c] * inv);
    dright[fbase + c * plane + w] = from_f32<T>(dr[c] * inv);
  }
}

template <typename T>
int launch_backward(const void* grad, const void* left, const void* right, void* dleft,
                    void* dright, int B, int C, int H, int W, int G, int D, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || C % G != 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * G * H * W;
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* gv = static_cast<const T*>(grad);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* dl = static_cast<T*>(dleft);
  T* dr = static_cast<T*>(dright);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kThreads);
#define GWC_BWD(CPG)                                                                     \
  gwc_volume_backward_kernel<T, CPG><<<grid, block, 0, s>>>(gv, l, r, dl, dr, B, G, H, W, D); \
  break;
  switch (C / G) {
    case 1: GWC_BWD(1)
    case 2: GWC_BWD(2)
    case 4: GWC_BWD(4)
    case 8: GWC_BWD(8)
    case 16: GWC_BWD(16)
    case 32: GWC_BWD(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GWC_BWD
  return (int)cudaGetLastError();
}

// Blocks for `items` work items on a card that holds `resident` blocks at
// once: at most both, and prime to `tiles`, so that each block's items
// (a stride of the grid apart) take every tile of a row in turn and a
// ragged last tile does not leave the same blocks with less work each time.
long long grid_size(long long items, long long tiles, long long resident) {
  long long n = std::min(items, resident);
  while (n > 1 && std::gcd(n, tiles) != 1) --n;
  return n;
}

template <typename T>
int launch(const void* left, const void* right, void* out, int B, int C, int H, int W,
           int G, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * G * H * W == 0 || D == 0) return 0;
  constexpr int TW = FwdTile<T>::kTW;
  constexpr unsigned kAlign = FwdTile<T>::kV * sizeof(T);
  const long long tiles = (W + TW - 1) / TW;
  const long long items = (long long)B * G * H * tiles;
  if (items > 0x3fffffffLL) return (int)cudaErrorInvalidValue;  // item + gridDim.x stays an int
  const bool vec = W % FwdTile<T>::kV == 0 && (size_t)left % kAlign == 0 &&
                   (size_t)right % kAlign == 0 && (size_t)out % kAlign == 0;
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as are resident at once, each walking its items
#define GWC_FWD(CPG)                                                                              \
  {                                                                                               \
    int per_sm = 0;                                                                               \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gwc_volume_kernel<T, CPG>,       \
                                                        FwdShape<T>::kThreads, 0);                \
    if (err != cudaSuccess) return (int)err;                                                      \
    const long long blocks = grid_size(items, tiles, (long long)sms * std::max(per_sm, 1));     \
    gwc_volume_kernel<T, CPG><<<(unsigned)blocks, FwdShape<T>::kThreads, 0, s>>>(                 \
        l, r, o, G, H, W, D, (int)tiles, (int)items, vec);                                        \
  }                                                                                               \
  break;
  switch (C / G) {
    case 1: GWC_FWD(1)
    case 2: GWC_FWD(2)
    case 4: GWC_FWD(4)
    case 8: GWC_FWD(8)
    case 16: GWC_FWD(16)
    case 32: GWC_FWD(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GWC_FWD
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers and the stream are passed as
// void*; the return value is the cudaError_t of the launch (0 = success).
extern "C" int gwc_volume_f32(const void* left, const void* right, void* out, int B, int C,
                              int H, int W, int G, int D, int device, void* stream) {
  return launch<float>(left, right, out, B, C, H, W, G, D, device, stream);
}

extern "C" int gwc_volume_bf16(const void* left, const void* right, void* out, int B, int C,
                               int H, int W, int G, int D, int device, void* stream) {
  return launch<__nv_bfloat16>(left, right, out, B, C, H, W, G, D, device, stream);
}

extern "C" int gwc_volume_backward_f32(const void* grad, const void* left, const void* right,
                                       void* dleft, void* dright, int B, int C, int H, int W,
                                       int G, int D, int device, void* stream) {
  return launch_backward<float>(grad, left, right, dleft, dright, B, C, H, W, G, D, device,
                                stream);
}

extern "C" int gwc_volume_backward_bf16(const void* grad, const void* left, const void* right,
                                        void* dleft, void* dright, int B, int C, int H, int W,
                                        int G, int D, int device, void* stream) {
  return launch_backward<__nv_bfloat16>(grad, left, right, dleft, dright, B, C, H, W, G, D,
                                        device, stream);
}
