// Direct 3x3x3 stride-1 pad-1 3D convolution for Hopper (sm_90a), with a
// per-output-channel scale and bias and an optional ReLU in the epilogue.
//
//   out[b, o, d, h, w] = act(scale[o] * sum_{c, kd, kh, kw}
//                            x[b, c, d+kd-1, h+kh-1, w+kw-1] * wt[c, kd, kh, kw, o]
//                            + bias[o])
//
// with zeros outside the volume. Layouts: x and out NCDHW (B, C, D, H, W).
// f32 or bf16 in, f32 accumulation, the input type out; scale and bias are
// f32 and may be null (1 and 0). The wrapper packs the weight once per call
// from torch's (Co, C, 3, 3, 3), zero-padded: for f32 the TF32 halves
// (Co/32, 3, C/8, 2 [hi, lo], 9, 32, 8) of `pack_weight_tf32x3`, for bf16
// (Co/32, 3, C/16, 9, 32, 16) of `pack_weight_bf16` (kernels/conv3d.py).
//
// Replaces dcanet_tpu/kernels/conv3d.py::_kernel (the Pallas TPU kernel,
// launched by conv3d_pallas; conv3d_fast reuses it for dgrad). The TPU
// kernel's kw-folded N=(kw, Co) matmul and its row-tile copies are layout
// choices for the TPU's matrix unit and are not carried over. Both kernels
// here are implicit GEMMs on the tensor cores with warp-level mma.sync.
//
// Bound: operations. At (B, C, D, H, W) = (1, 32, 48, 96, 312), 32 -> 32, the
// conv is 2*27*32*32*1.44M = 79.5 GFLOP. 64 -> 32 doubles the operations.
//  - f32 on the FMA units (67 TFLOP/s): 1.19 / 2.37 ms. cuDNN's f32 conv
//    (TF32 off) took 2.71 ms, 44 % of that bound, and this file's earlier
//    FMA kernel 3.01 ms, 39 % (H100 SXM, PERF.md). Even a very good FMA
//    kernel stays near 2 ms.
//  - f32 as 3xTF32 on the tensor cores (495 TFLOP/s dense TF32, three
//    passes): 3 * 79.5 GFLOP / 495 TFLOP/s = 0.482 / 0.964 ms. The bytes
//    (368 MB at 32 -> 32, 0.110 ms at 3.35 TB/s) are not the limit.
//  - bf16 on the tensor cores (989 TFLOP/s dense): ~0.08 ms, where the bytes
//    (~184 MB, ~0.055 ms) come close.
//
// f32, on the tensor cores in split precision ("3xTF32", CUTLASS's
// OpMultiplyAddFastF32). One TF32 pass keeps 10 mantissa bits: at K = 27*C
// its error against the plain f32 conv is ~30x the f32 tolerance of
// 1e-5 * max(1, max|ref|) (cuDNN with TF32 on, on the H100, and a plain
// emulation in tests/test_torch_conv3d.py). Each operand is split as
// a = hi + lo, both parts TF32, and a*b is taken as hi*hi + hi*lo + lo*hi,
// three mma.sync m16n8k8 TF32 per tile, accumulated in f32; the dropped
// lo*lo and the cut of lo are ~2^-20 of |a*b| or less, below f32's own
// summation error. On the H100 the kernel's max |err| against the plain
// version is 1.4e-5 / 2.5e-5 at 32 -> 32 / 64 -> 32 (tolerance 1.7e-4 /
// 3.1e-4), below the FMA kernel it replaced (2.6e-5 / 5.3e-5).
// The skeleton is the bf16 kernel's below, at half the MMA depth:
//  - A block computes an 8 x 32 (h, w) tile of one (b, d) plane (M) for 32
//    output channels (N; grid z tiles Co, so dgrad's Co = 64 takes two
//    blocks). K is the 27 taps x C in steps of one kd plane and 8 channels,
//    the K of m16n8k8: 3 * ceil(C/8) steps, each 9 (kh, kw) taps. Each of
//    the 8 warps owns one row of 32 pixels x 32 channels: 2 x 4 accumulator
//    tiles, 24 MMAs per tap from 2 A and 4 B (hi, lo) ldmatrix.x4 loads.
//  - ldmatrix.x4.b16 gives lane t the 32-bit word at row t/4, word t%4 of
//    each of its four 8 x 16-byte matrices. With A stored [pixel][8 f32
//    channels] and the matrices at pixels 0-7 / 8-15 x channels 0-3 / 4-7,
//    that is the m16n8k8 TF32 A fragment: a0 (g, t4), a1 (g+8, t4), a2 (g,
//    t4+4), a3 (g+8, t4+4), g = lane/4, t4 = lane%4. B stored [co][8 c]
//    gives b0 (k = t4, n = g) and b1 (k = t4+4, n = g) the same way.
//  - Channel-last staging at a pitch of 12 floats (48 bytes, as the bf16
//    kernel's 24 elements): a kw shift is one pixel row and each ldmatrix
//    phase covers the 32 banks once. The input goes to shared memory by
//    4-byte cp.async with zero fill (the transpose is in the addresses), so
//    no registers hold the next step's input.
//  - The weights' TF32 halves are made on the host; a step's hi and lo
//    slices (2 x 9 x 32 x 8 floats) are contiguous and go to shared memory
//    by 16-byte cp.async; the host rounds both to nearest (cvt.rna's
//    rule). The input is split in registers after ldmatrix, by truncation
//    (split_tf32): staging both halves would take ~121 KB a block and leave
//    1 block per SM, which the bf16 kernel's tile sweep measured 1.5x
//    slower.
//  - The tensor cores truncate, not round, when they add a product into
//    the accumulator. A sum carried through every MMA of the conv (3 * 27 *
//    C/8 of them) drifts by up to an ulp per MMA: 4.5e-4 at 64 -> 32 on the
//    H100, 1.5x the f32 tolerance. So each step's 27 MMAs per tile go to a
//    partial sum that starts at zero, added to the running sum by a
//    round-to-nearest FADD after the step.
//  - Two stages as in the bf16 kernel; 2 x (10*34*12 + 2*9*32*12) floats =
//    87,936 bytes of shared memory, 2 blocks per SM.
//  - Epilogue: scale, bias and ReLU in f32 on the accumulators, staged in
//    shared memory as [co][h][w] (co pitch 260 floats, so the 4 channels a
//    warp writes at once fall in different banks), then written NCDHW with
//    16-byte stores along w where W % 4 == 0, masked at the ragged H, W and
//    Co edges.
//
// bf16, on the tensor cores: an implicit GEMM with warp-level mma.sync
// m16n8k16 (bf16 in, f32 accumulate; HMMA in SASS). M is the output pixels
// of an 8 x 32 (h, w) tile of one (b, d) plane, N the block's 32 output
// channels (grid z tiles Co, so dgrad's Co = 64 takes two blocks), K the 27
// taps x C in steps of 16 channels. A step is one kd plane and one 16-channel
// chunk: 3 * ceil(C/16) steps, each 9 (kh, kw) taps of K = 16. Each of the 8
// warps owns one row of 32 pixels x 32 channels: 2 x 4 accumulator tiles, 8
// MMAs per tap from 2 A and 2 B ldmatrix.x4 loads. The tile was chosen on
// the card among 13 shapes (dcanet_tpu_torch/tune_conv3d.py): 8 x 32 stages
// 1.33 halo pixels per output pixel (4 x 64: 1.55, 0.45 vs 0.51 ms) and fits
// 122 registers without spills, 2 blocks per SM.
//  - Channel-last in shared memory. A kw shift moves the A tile by one pixel;
//    in NCDHW that is 2 bytes, below ldmatrix's 16-byte row alignment. The
//    step's (8+2) x (32+2) halo tile is staged as [row][col][c] with the 16
//    channels of a pixel contiguous, so a shift is one whole pixel row of the
//    A matrix. The pixel pitch is 24 elements (48 bytes): each ldmatrix phase
//    reads 8 rows 12 words apart, which cover all 32 banks once. (WMMA's
//    load_matrix_sync would need 32-byte fragment pointers, a pitch of 16 or
//    32 elements, and two-way bank conflicts; ldmatrix needs 16 bytes.)
//  - The transpose happens in the staging loop: a thread loads 8 channels of
//    one halo pixel (each load coalesced along w across the warp), packs them
//    and stores 16 bytes channel-last; no NDHWC copy of x is made. Channels
//    >= C and points outside the volume are stored as zeros.
//  - Weights: the step's 9 x 32 x 16 slice is contiguous in the packed
//    layout and goes to shared memory with 16-byte cp.async, rows of 16
//    channels at the same 24-element pitch.
//  - Overlap: two stages. While the warps run step s's MMAs, the next step's
//    input sits in registers (loaded before, stored after the MMAs) and its
//    weights are in flight by cp.async. One barrier per step.
//  - Shared memory: 2 stages x (10*34*24 + 9*32*24) bf16 = 60,288 bytes for
//    any C (dynamic, above the 48 KB static limit): the registers, not the
//    shared memory, hold the SM to 2 blocks.
//  - Epilogue: scale, bias and ReLU in f32 on the accumulators, one rounding
//    to bf16, staged in shared memory as [co][h][w] (co pitch 264 elements,
//    so the 4 channels a warp writes at once fall in different banks), then
//    written NCDHW with 16-byte stores along w where W % 8 == 0, masked at
//    the ragged H, W and Co edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// PTX helpers of both kernels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// 4 bytes, of which the first n (0 or 4) are read and the rest zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 implicit GEMM on the tensor cores

namespace tf32x3 {

constexpr int kThreads = 256;     // 8 warps
constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int MT = 2;             // 16-pixel M tiles per warp, side by side in one row
constexpr int CO_T = 32;          // output channels per block: 4 N tiles of 8
constexpr int CK = 8;             // input channels per step: the MMA's K
constexpr int ROWS = TH + 2;      // staged rows (halo 1)
constexpr int COLS = TW + 2;      // staged columns (halo 1)
constexpr int PITCH = 12;         // floats per staged pixel / weight row (48 bytes)
constexpr int WARPS_PER_ROW = TW / (16 * MT);
constexpr int IN_ELEMS = ROWS * COLS * PITCH;
constexpr int W_ELEMS = 2 * 9 * CO_T * PITCH;    // the hi and the lo weights
constexpr int STAGE = IN_ELEMS + W_ELEMS;        // one step's tiles, in floats
constexpr int IN_STEP = ROWS * COLS * CK;        // one step's input values
constexpr int W_STEP = 2 * 9 * CO_T * CK;        // one step's packed weights, in floats
constexpr int W_PIECES = W_STEP / 4;             // ... in 16-byte pieces
constexpr int OUT_PITCH = TH * TW + 4;           // epilogue: floats per output channel
constexpr int SMEM_BYTES = 4 * (2 * STAGE > CO_T * OUT_PITCH ? 2 * STAGE : CO_T * OUT_PITCH);
static_assert(WARPS_PER_ROW * TH * 32 == kThreads, "one warp per 16*MT columns of a row");
static_assert((PITCH * 4) % 16 == 0 && (IN_ELEMS * 4) % 16 == 0 && (STAGE * 4) % 16 == 0,
              "ldmatrix and cp.async need 16-byte aligned rows");
static_assert(OUT_PITCH % 16 == 4, "epilogue: a warp's 4 channels x 8 pixels in 32 banks");

// D = A * B + D in TF32; A 16x8 row-major (pixels x channels), B 8x8 "col"
// (stored as 8 output channels x 8 channels), D 16x8 f32.
__device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a = hi + lo: hi is a's top 19 bits (TF32 by truncation), lo = a - hi is
// exact in f32, and the MMA reads lo's top 19 bits, which loses less than
// 2^-20 of |a|. Rounding both with cvt.rna.tf32.f32, as the host rounds the
// weights, took 10-14 % longer on the H100 at the same accuracy inside the
// f32 tolerance (tune_conv3d.py, variant th8_tw32_split_rna).
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& hi, uint32_t& lo) {
  hi = a & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(a) - __uint_as_float(hi));
}

struct Geometry {
  const float* xb;  // x at batch b
  long long plane, vol;
  int C, D, H, W, d, h0, w0, n_cc;
};

// Step s's input halo tile into a stage, channel-last ([row][col][c]), by
// 4-byte cp.async, zero-filled outside the volume and for channels >= C. A
// warp's 32 copies are 8 neighbouring pixels x 4 channels: 8 consecutive
// floats of each of 4 channel planes, and 32 different banks.
__device__ __forceinline__ void stage_input(uint32_t s_in, const Geometry& g, int s, int tid) {
  const int c0 = (s % g.n_cc) * CK;
  const int gd = g.d + s / g.n_cc - 1;
  const bool d_ok = gd >= 0 && gd < g.D;
  for (int e = tid; e < IN_STEP; e += kThreads) {
    const int c4 = e & 3, pix = (e >> 2) % (ROWS * COLS), cg = (e >> 2) / (ROWS * COLS);
    const int gh = g.h0 + pix / COLS - 1, gw = g.w0 + pix % COLS - 1, c = c0 + cg * 4 + c4;
    const bool ok = d_ok && c < g.C && gh >= 0 && gh < g.H && gw >= 0 && gw < g.W;
    const float* src = ok ? g.xb + c * g.vol + gd * g.plane + (long long)gh * g.W + gw : g.xb;
    cp_async4(s_in + (pix * PITCH + cg * 4 + c4) * 4, src, ok ? 4u : 0u);
  }
}

// Step s's packed weights ([hi, lo][tap][co][8 c], contiguous) into a stage,
// rows of 8 channels at the pixel pitch.
__device__ __forceinline__ void load_weights(uint32_t s_w, const float* w_step, int tid) {
  for (int q = tid; q < W_PIECES; q += kThreads) {
    const int half = q % (CK / 4), row = q / (CK / 4);  // row = (part * 9 + tap) * CO_T + co
    cp_async16(s_w + (row * PITCH + half * 4) * 4, w_step + q * 4);
  }
}

template <bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ out, int C, int D, int H, int W, int Co, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WARPS_PER_ROW;                  // the warp's tile row
  const int wc = (warp % WARPS_PER_ROW) * 16 * MT;      // ... and first column
  Geometry g;
  g.h0 = (blockIdx.x / tiles_w) * TH;
  g.w0 = (blockIdx.x % tiles_w) * TW;
  g.d = blockIdx.y % D;
  const int b = blockIdx.y / D;
  const int co0 = blockIdx.z * CO_T;
  g.C = C, g.D = D, g.H = H, g.W = W;
  g.plane = (long long)H * W;
  g.vol = (long long)D * g.plane;
  g.xb = x + (long long)b * C * g.vol;
  g.n_cc = (C + CK - 1) / CK;
  const int steps = 3 * g.n_cc;
  const float* w_tile = wp + (long long)blockIdx.z * steps * W_STEP;

  // ldmatrix row addresses, in bytes: A rows are pixels (lanes 0-15 at
  // channels 0-3, lanes 16-31 at 4-7); B rows are output channels (matrices:
  // co 0-7 at c 0-3 and 4-7, then co 8-15 at c 0-3 and 4-7).
  const uint32_t a_lane = ((lane & 15) * PITCH + (lane >> 4) * 4) * 4;
  const uint32_t b_lane = (((lane & 7) + ((lane >> 4) << 3)) * PITCH + ((lane >> 3) & 1) * 4) * 4;

  // acc sums the steps; part sums one step's 27 MMAs per tile. The tensor
  // cores truncate when they add into the accumulator, so a sum carried
  // through all 3 * 27 * C/8 MMAs drifts by up to an ulp of it per MMA
  // (4.5e-4 at C = 64, above the f32 tolerance, on the H100); a step's
  // partial sum is small, and adding it to acc rounds to nearest.
  float acc[MT][4][4], part[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

  stage_input(smem_addr(smem), g, 0, tid);
  load_weights(smem_addr(smem + IN_ELEMS), w_tile, tid);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage buf is complete; every warp is done with stage buf ^ 1
    if (s + 1 < steps) {
      stage_input(smem_addr(smem + (buf ^ 1) * STAGE), g, s + 1, tid);
      load_weights(smem_addr(smem + (buf ^ 1) * STAGE + IN_ELEMS), w_tile + (long long)(s + 1) * W_STEP,
                   tid);
      cp_async_commit();
    }
    const uint32_t s_in = smem_addr(smem + buf * STAGE);
    const uint32_t s_w = s_in + IN_ELEMS * 4;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][n][j] = 0.0f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
        uint32_t a_hi[MT][4], a_lo[MT][4], bq[2][2][4];  // bq[hi / lo][co 0-15 / 16-31]
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldmatrix_x4(s_in + ((wr + kh) * COLS + wc + 16 * m + kw) * PITCH * 4 + a_lane, a);
#pragma unroll
          for (int r = 0; r < 4; ++r) split_tf32(a[r], a_hi[m][r], a_lo[m][r]);
        }
#pragma unroll
        for (int part = 0; part < 2; ++part)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldmatrix_x4(s_w + ((part * 9 + tap) * CO_T + 16 * p) * PITCH * 4 + b_lane, bq[part][p]);
        // The small products first. Each pass's 2 x 4 MMAs go to different
        // accumulators, so they do not wait on one another.
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_1688(part[m][n], a_lo[m], bq[0][n >> 1][(n & 1) * 2], bq[0][n >> 1][(n & 1) * 2 + 1]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_1688(part[m][n], a_hi[m], bq[1][n >> 1][(n & 1) * 2], bq[1][n >> 1][(n & 1) * 2 + 1]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_1688(part[m][n], a_hi[m], bq[0][n >> 1][(n & 1) * 2], bq[0][n >> 1][(n & 1) * 2 + 1]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] += part[m][n][j];
  }
  __syncthreads();  // the stages are free: reuse them for the output tile

  // Accumulator layout of m16n8: c0, c1 at pixel lane/4, channels 2*(lane%4)
  // and +1; c2, c3 at pixel lane/4 + 8.
  const int gp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = 8 * n + 2 * t4 + j, gco = co0 + co;
      const float sc = (scale && gco < Co) ? scale[gco] : 1.0f;
      const float bi = (bias && gco < Co) ? bias[gco] : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float y = fmaf(acc[m][n][2 * hf + j], sc, bi);
          if (RELU) y = fmaxf(y, 0.0f);
          smem[co * OUT_PITCH + wr * TW + wc + 16 * m + gp + 8 * hf] = y;
        }
      }
    }
  }
  __syncthreads();

  const bool vec = (W % 4) == 0;
  for (int i = tid; i < CO_T * TH * (TW / 4); i += kThreads) {
    const int v = i % (TW / 4), row = (i / (TW / 4)) % TH, co = i / (TW / 4 * TH);
    const int gco = co0 + co, h = g.h0 + row, w = g.w0 + 4 * v;
    if (gco >= Co || h >= H || w >= W) continue;
    const float* src = smem + co * OUT_PITCH + row * TW + 4 * v;
    float* dst = out + (((long long)b * Co + gco) * D + g.d) * g.plane + (long long)h * W + w;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int j = 0; j < 4 && w + j < W; ++j) dst[j] = src[j];
    }
  }
}

}  // namespace tf32x3

// ---------------------------------------------------------------------------
// bf16: implicit GEMM on the tensor cores

namespace tc {

constexpr int kThreads = 256;     // 8 warps
constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int MT = 2;             // 16-pixel M tiles per warp, side by side in one row
constexpr int CO_T = 32;          // output channels per block: 4 N tiles of 8
constexpr int CK = 16;            // input channels per step: the MMA's K
constexpr int ROWS = TH + 2;      // staged rows (halo 1)
constexpr int COLS = TW + 2;      // staged columns (halo 1)
constexpr int PITCH = 24;         // bf16 elements per staged pixel / weight row
constexpr int WARPS_PER_ROW = TW / (16 * MT);
constexpr int IN_ELEMS = ROWS * COLS * PITCH;
constexpr int W_ELEMS = 9 * CO_T * PITCH;
constexpr int STAGE = IN_ELEMS + W_ELEMS;        // one step's tiles, in bf16 elements
constexpr int TASKS = ROWS * COLS * (CK / 8);    // 8 channels of one halo pixel each
constexpr int NT = (TASKS + kThreads - 1) / kThreads;
constexpr int W_STEP = 9 * CO_T * CK;            // one step's packed weights, in elements
constexpr int W_PIECES = W_STEP / 8;             // ... in 16-byte pieces
constexpr int OUT_PITCH = TH * TW + 8;           // epilogue: elements per output channel
constexpr int SMEM_BYTES = 2 * (2 * STAGE > CO_T * OUT_PITCH ? 2 * STAGE : CO_T * OUT_PITCH);
static_assert(WARPS_PER_ROW * TH * 32 == kThreads, "one warp per 16*MT columns of a row");
static_assert((PITCH * 2) % 16 == 0 && (IN_ELEMS * 2) % 16 == 0 && (STAGE * 2) % 16 == 0,
              "ldmatrix and cp.async need 16-byte aligned rows");

// D = A * B + D; A 16x16 row-major (pixels x channels), B 16x8 "col" (stored
// as 8 output channels x 16 channels), D 16x8 f32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Geometry {
  const unsigned short* xb;  // x at batch b, as raw bf16 bits
  long long plane, vol;
  int C, D, H, W, d, h0, w0, n_cc;
};

// Step s's input halo tile, 8 channels of one pixel per task, into registers
// as packed bf16 pairs (zeros outside the volume and for channels >= C).
__device__ __forceinline__ void load_input(uint4 (&v)[NT], const Geometry& g, int s, int tid) {
  const int c0 = (s % g.n_cc) * CK;
  const int gd = g.d + s / g.n_cc - 1;
  const bool d_ok = gd >= 0 && gd < g.D;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int i = tid + k * kThreads;
    const int col = i % COLS, row = (i / COLS) % ROWS, cg = i / (COLS * ROWS);
    const int gh = g.h0 + row - 1, gw = g.w0 + col - 1;
    uint32_t p[4] = {0u, 0u, 0u, 0u};
    if (i < TASKS && d_ok && gh >= 0 && gh < g.H && gw >= 0 && gw < g.W) {
      const int c = c0 + cg * 8;
      const unsigned short* src = g.xb + gd * g.plane + (long long)gh * g.W + gw;
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const uint32_t lo = c + j < g.C ? src[(c + j) * g.vol] : 0u;
        const uint32_t hi = c + j + 1 < g.C ? src[(c + j + 1) * g.vol] : 0u;
        p[j / 2] = lo | (hi << 16);
      }
    }
    v[k] = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// The registers of load_input into a stage, channel-last: [row][col][c].
__device__ __forceinline__ void store_input(__nv_bfloat16* s_in, const uint4 (&v)[NT], int tid) {
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int i = tid + k * kThreads;
    if (i < TASKS) {
      const int col = i % COLS, row = (i / COLS) % ROWS, cg = i / (COLS * ROWS);
      *reinterpret_cast<uint4*>(s_in + (row * COLS + col) * PITCH + cg * 8) = v[k];
    }
  }
}

// Step s's packed weights ([tap][co][16 c], contiguous) into a stage, rows
// of 16 channels at the pixel pitch.
__device__ __forceinline__ void load_weights(uint32_t s_w, const __nv_bfloat16* w_step, int tid) {
  for (int q = tid; q < W_PIECES; q += kThreads) {
    const int half = q % (CK / 8), row = q / (CK / 8);  // row = tap * CO_T + co
    cp_async16(s_w + (row * PITCH + half * 8) * 2, w_step + q * 8);
  }
}

template <bool RELU>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int C, int D, int H, int W, int Co,
                   int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WARPS_PER_ROW;                  // the warp's tile row
  const int wc = (warp % WARPS_PER_ROW) * 16 * MT;      // ... and first column
  Geometry g;
  g.h0 = (blockIdx.x / tiles_w) * TH;
  g.w0 = (blockIdx.x % tiles_w) * TW;
  g.d = blockIdx.y % D;
  const int b = blockIdx.y / D;
  const int co0 = blockIdx.z * CO_T;
  g.C = C, g.D = D, g.H = H, g.W = W;
  g.plane = (long long)H * W;
  g.vol = (long long)D * g.plane;
  g.xb = reinterpret_cast<const unsigned short*>(x) + (long long)b * C * g.vol;
  g.n_cc = (C + CK - 1) / CK;
  const int steps = 3 * g.n_cc;
  const __nv_bfloat16* w_tile = wp + (long long)blockIdx.z * steps * W_STEP;

  // ldmatrix row addresses: A rows are pixels (lanes 0-15 at channels 0-7,
  // lanes 16-31 at 8-15); B rows are output channels (matrices: co 0-7 at
  // c 0-7 and 8-15, then co 8-15 at c 0-7 and 8-15).
  const uint32_t a_lane = ((lane & 15) * PITCH + (lane >> 4) * 8) * 2;
  const uint32_t b_lane = (((lane & 7) + ((lane >> 4) << 3)) * PITCH + ((lane >> 3) & 1) * 8) * 2;

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

  uint4 pre[NT];
  load_input(pre, g, 0, tid);
  load_weights(smem_addr(smem + IN_ELEMS), w_tile, tid);
  cp_async_commit();
  store_input(smem, pre, tid);

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // stage buf is complete; every warp is done with stage buf ^ 1
    const bool next = s + 1 < steps;
    if (next) {
      load_input(pre, g, s + 1, tid);
      load_weights(smem_addr(smem + (buf ^ 1) * STAGE + IN_ELEMS), w_tile + (long long)(s + 1) * W_STEP,
                   tid);
      cp_async_commit();
    }
    const uint32_t s_in = smem_addr(smem + buf * STAGE);
    const uint32_t s_w = s_in + IN_ELEMS * 2;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        uint32_t a[MT][4], bq[2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(s_in + ((wr + kh) * COLS + wc + 16 * m + kw) * PITCH * 2 + a_lane, a[m]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4(s_w + ((kh * 3 + kw) * CO_T + 16 * p) * PITCH * 2 + b_lane, bq[p]);
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_16816(acc[m][n], a[m], bq[n >> 1][(n & 1) * 2], bq[n >> 1][(n & 1) * 2 + 1]);
      }
    }
    if (next) store_input(smem + (buf ^ 1) * STAGE, pre, tid);
  }
  __syncthreads();  // the stages are free: reuse them for the output tile

  // Accumulator layout of m16n8: c0, c1 at pixel lane/4, channels 2*(lane%4)
  // and +1; c2, c3 at pixel lane/4 + 8.
  const int gp = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int co = 8 * n + 2 * t4 + j, gco = co0 + co;
      const float sc = (scale && gco < Co) ? scale[gco] : 1.0f;
      const float bi = (bias && gco < Co) ? bias[gco] : 0.0f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float y = fmaf(acc[m][n][2 * hf + j], sc, bi);
          if (RELU) y = fmaxf(y, 0.0f);
          smem[co * OUT_PITCH + wr * TW + wc + 16 * m + gp + 8 * hf] = __float2bfloat16(y);
        }
      }
    }
  }
  __syncthreads();

  const bool vec = (W % 8) == 0;
  for (int i = tid; i < CO_T * TH * (TW / 8); i += kThreads) {
    const int v = i % (TW / 8), row = (i / (TW / 8)) % TH, co = i / (TW / 8 * TH);
    const int gco = co0 + co, h = g.h0 + row, w = g.w0 + 8 * v;
    if (gco >= Co || h >= H || w >= W) continue;
    const __nv_bfloat16* src = smem + co * OUT_PITCH + row * TW + 8 * v;
    __nv_bfloat16* dst = out + (((long long)b * Co + gco) * D + g.d) * g.plane + (long long)h * W + w;
    if (vec && w + 8 <= W) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && w + j < W; ++j) dst[j] = src[j];
    }
  }
}

}  // namespace tc

// Grid over (h, w) tiles, B*D planes and output-channel tiles; false for
// sizes that are empty or that the grid cannot hold.
bool grid_for(int B, int C, int D, int H, int W, int Co, int th, int tw, int co_t, dim3& grid,
              int& tiles_w) {
  if (B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 || Co <= 0) return false;
  const long long tw_n = (W + tw - 1) / tw, th_n = (H + th - 1) / th;
  const long long bd = (long long)B * D, co_blocks = (Co + co_t - 1) / co_t;
  if (tw_n * th_n > 0x7fffffffLL || bd > 65535 || co_blocks > 65535) return false;
  grid = dim3((unsigned)(tw_n * th_n), (unsigned)bd, (unsigned)co_blocks);
  tiles_w = (int)tw_n;
  return true;
}

}  // namespace

// Plain C interface for ctypes. Pointers and the stream are passed as void*
// (scale and bias may be null); the return value is the cudaError_t of the
// launch (0 = success). wt: the packed weight of
// kernels/conv3d.py::pack_weight_tf32x3.
extern "C" int conv3d_f32(const void* x, const void* wt, const void* scale, const void* bias,
                          void* out, int B, int C, int D, int H, int W, int Co, int relu,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  int tiles_w;
  if (!grid_for(B, C, D, H, W, Co, tf32x3::TH, tf32x3::TW, tf32x3::CO_T, grid, tiles_w))
    return (int)cudaErrorInvalidValue;
  auto kernel = relu ? tf32x3::conv3d_tf32x3_kernel<true> : tf32x3::conv3d_tf32x3_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf32x3::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, tf32x3::kThreads, tf32x3::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(out), C, D, H, W, Co, tiles_w);
  return (int)cudaGetLastError();
}

// wt: the packed weight of kernels/conv3d.py::pack_weight_bf16.
extern "C" int conv3d_bf16(const void* x, const void* wt, const void* scale, const void* bias,
                           void* out, int B, int C, int D, int H, int W, int Co, int relu,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  int tiles_w;
  if (!grid_for(B, C, D, H, W, Co, tc::TH, tc::TW, tc::CO_T, grid, tiles_w))
    return (int)cudaErrorInvalidValue;
  auto kernel = relu ? tc::conv3d_bf16_kernel<true> : tc::conv3d_bf16_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, tc::kThreads, tc::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), C, D, H, W, Co, tiles_w);
  return (int)cudaGetLastError();
}
