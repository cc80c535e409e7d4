// Direct 3x3x3 stride-1 pad-1 3D convolution for Hopper (sm_90a), with a
// per-output-channel scale and bias and an optional ReLU in the epilogue.
//
//   out[b, o, d, h, w] = act(scale[o] * sum_{c, kd, kh, kw}
//                            x[b, c, d+kd-1, h+kh-1, w+kw-1] * wt[c, kd, kh, kw, o]
//                            + bias[o])
//
// with zeros outside the volume. Layouts: x and out NCDHW (B, C, D, H, W); the
// weight is taken as (C, 3, 3, 3, Co), which the wrapper makes from torch's
// (Co, C, 3, 3, 3) once per call. f32 or bf16 in, f32 accumulation, the input
// type out; scale and bias are f32 and may be null (1 and 0).
//
// Replaces dcanet_tpu/kernels/conv3d.py::_kernel (the Pallas TPU kernel,
// launched by conv3d_pallas; conv3d_fast reuses it for dgrad). The TPU
// kernel's kw-folded N=(kw, Co) matmul and its row-tile copies are layout
// choices for the TPU's matrix unit and are not carried over.
//
// Bound: operations. At (B, C, D, H, W) = (1, 32, 48, 96, 312), 32 -> 32, the
// conv is 2*27*32*32*1.44M = 79.5 GFLOP: 1.19 ms at the 67 TFLOP/s of f32
// outside the tensor cores; ~0.08 ms in bf16 on the tensor cores (989 TFLOP/s
// dense), where the bytes (~184 MB, ~0.055 ms) come close. 64 -> 32 doubles
// the operations.
//
// Design, simple first, on the FMA units (no tensor cores yet: wgmma and TMA
// are later work). A block of 256 threads computes an 8 x 32 (h, w) tile of
// one (b, d) plane for 32 output channels. For each chunk of 4 input
// channels it stages the three input planes' (8+2) x (32+2) halo tiles and
// the chunk's 27 x 32 weights in shared memory, in f32. A thread owns one row
// of the tile, four columns 8 apart and 8 output channels: 32 sums in
// registers, 96 FMAs per 12 input and 6 16-byte weight loads from shared
// memory. The input rows sit 40 floats apart, so a warp's 4 rows x 8 columns
// fall in 32 different banks; the weight loads are broadcasts.

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
constexpr int TH = 8;          // output rows per block
constexpr int TW = 32;         // output columns per block
constexpr int CO_T = 32;       // output channels per block
constexpr int CI_T = 4;        // input channels staged at a time
constexpr int ROWS = TH + 2;   // staged rows (halo 1)
constexpr int COLS = TW + 2;   // staged columns (halo 1)
constexpr int PITCH = 40;      // shared-memory row pitch, in floats

template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
conv3d_kernel(const T* __restrict__ x, const T* __restrict__ wt,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ out, int C, int D, int H, int W, int Co, int tiles_w) {
  __shared__ float s_in[CI_T][3][ROWS][PITCH];
  __shared__ __align__(16) float s_w[CI_T][27][CO_T];

  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int d = blockIdx.y % D;
  const int b = blockIdx.y / D;
  const int co0 = blockIdx.z * CO_T;
  const int tid = threadIdx.x;
  const int co_grp = tid >> 6;  // 8 output channels: co0 + 8*co_grp + j
  const int ty = (tid & 63) >> 3;
  const int tx = tid & 7;       // columns tx + 8p, p = 0..3

  const long long plane = (long long)H * W;
  const long long vol = (long long)D * plane;
  const T* xb = x + (long long)b * C * vol;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;

  for (int ci0 = 0; ci0 < C; ci0 += CI_T) {
    for (int i = tid; i < CI_T * 3 * ROWS * COLS; i += kThreads) {
      const int col = i % COLS;
      int r = i / COLS;
      const int row = r % ROWS;
      r /= ROWS;
      const int kd = r % 3;
      const int ci = r / 3;
      const int gc = ci0 + ci, gd = d + kd - 1, gh = h0 + row - 1, gw = w0 + col - 1;
      float v = 0.0f;
      if (gc < C && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
        v = to_f32(xb[gc * vol + gd * plane + (long long)gh * W + gw]);
      s_in[ci][kd][row][col] = v;
    }
    for (int i = tid; i < CI_T * 27 * CO_T; i += kThreads) {
      const int co = i % CO_T;
      const int r = i / CO_T;
      const int tap = r % 27;
      const int ci = r / 27;
      const int gc = ci0 + ci, gco = co0 + co;
      s_w[ci][tap][co] =
          (gc < C && gco < Co) ? to_f32(wt[((long long)gc * 27 + tap) * Co + gco]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const float* row = &s_in[ci][kd][ty + kh][tx];
          float v[4][3];
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) v[p][kw] = row[8 * p + kw];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float4* wp =
                reinterpret_cast<const float4*>(&s_w[ci][(kd * 3 + kh) * 3 + kw][co_grp * 8]);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[p][j] = fmaf(v[p][kw], wv[j], acc[p][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int h = h0 + ty;
  if (h >= H) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + co_grp * 8 + j;
    if (co >= Co) break;
    const float s = scale ? scale[co] : 1.0f;
    const float t = bias ? bias[co] : 0.0f;
    T* o = out + (((long long)b * Co + co) * D + d) * plane + (long long)h * W;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int wc = w0 + tx + 8 * p;
      if (wc < W) {
        float y = fmaf(acc[p][j], s, t);
        if (RELU) y = fmaxf(y, 0.0f);
        o[wc] = from_f32<T>(y);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* scale, const void* bias, void* out,
           int B, int C, int D, int H, int W, int Co, int relu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 || Co <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const long long bd = (long long)B * D, co_blocks = (Co + CO_T - 1) / CO_T;
  if (tiles_w * tiles_h > 0x7fffffffLL || bd > 65535 || co_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles_w * tiles_h), (unsigned)bd, (unsigned)co_blocks);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(wt);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  T* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu)
    conv3d_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, wp, sp, bp, op, C, D, H, W, Co, (int)tiles_w);
  else
    conv3d_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, wp, sp, bp, op, C, D, H, W, Co, (int)tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. Pointers and the stream are passed as void*
// (scale and bias may be null); the return value is the cudaError_t of the
// launch (0 = success).
extern "C" int conv3d_f32(const void* x, const void* wt, const void* scale, const void* bias,
                          void* out, int B, int C, int D, int H, int W, int Co, int relu,
                          int device, void* stream) {
  return launch<float>(x, wt, scale, bias, out, B, C, D, H, W, Co, relu, device, stream);
}

extern "C" int conv3d_bf16(const void* x, const void* wt, const void* scale, const void* bias,
                           void* out, int B, int C, int D, int H, int W, int Co, int relu,
                           int device, void* stream) {
  return launch<__nv_bfloat16>(x, wt, scale, bias, out, B, C, D, H, W, Co, relu, device, stream);
}
