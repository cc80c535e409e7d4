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
// Design, simple first: one thread per (b, g, h, w). The thread keeps its
// pixel's C/G left channels in registers and walks d, reading R[b, c, h, w-d]
// and writing out[b, g, d, h, w]. Neighbouring threads take neighbouring w, so
// both the reads of R and the writes of the volume coalesce. Each right row is
// re-read D times, from L2; staging a W-tile of both rows in shared memory is
// later work.
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

constexpr int kThreads = 256;

template <typename T, int CPG>
__global__ void __launch_bounds__(kThreads)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right,
                  T* __restrict__ out, int B, int G, int H, int W, int D) {
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
  // offset of channel g*CPG at (b, h, column 0)
  const long long fbase = ((long long)b * C + (long long)g * CPG) * plane + (long long)h * W;

  float l[CPG];
#pragma unroll
  for (int c = 0; c < CPG; ++c) l[c] = to_f32(left[fbase + c * plane + w]);

  T* o = out + ((long long)b * G + g) * D * plane + (long long)h * W + w;
  const T* r = right + fbase + w;
  const T zero = from_f32<T>(0.0f);
  for (int d = 0; d < D; ++d) {
    if (d <= w) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < CPG; ++c) acc += l[c] * to_f32(r[c * plane - d]);
      o[d * plane] = from_f32<T>(acc / (float)CPG);
    } else {
      o[d * plane] = zero;
    }
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

template <typename T>
int launch(const void* left, const void* right, void* out, int B, int C, int H, int W,
           int G, int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || C % G != 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * G * H * W;
  if (n == 0 || D == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)blocks), block(kThreads);
  switch (C / G) {
    case 1: gwc_volume_kernel<T, 1><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    case 2: gwc_volume_kernel<T, 2><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    case 4: gwc_volume_kernel<T, 4><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    case 8: gwc_volume_kernel<T, 8><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    case 16: gwc_volume_kernel<T, 16><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    case 32: gwc_volume_kernel<T, 32><<<grid, block, 0, s>>>(l, r, o, B, G, H, W, D); break;
    default: return (int)cudaErrorInvalidValue;
  }
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
