// Group-wise correlation cost volume for Hopper (sm_90a).
//
//   out[b, g, d, h, w] = mean_{c in group g} L[b, c, h, w] * R[b, c, h, w - d]
//   out[b, g, d, h, w] = 0 for w < d (the occluded left margin; every plane
//   with d >= W is all zeros).
//
// A launch writes the planes d in [d_lo, d_lo + D) of that volume: plane k
// of its output holds disparity d_lo + k (d_lo = 0 and D = maxdisp for the
// whole volume). A rank of the disparity-sharded eval builds only its own
// planes this way. The kernel's passes start at d_lo rounded down to a
// multiple of kV, so that the staged windows of R stay aligned for the
// 16-byte copies; the up to kV - 1 planes below d_lo are computed and not
// stored. That arithmetic costs the bf16 kernel about 18 % (chip_smoke.py
// phase 2 on an H100), so launches from d_lo = 0, the whole volume's
// among them, take an instantiation without it (kRange = false).
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
// The occluded entries (w < d) of Gv reach neither. It replaces the JAX
// package's backward of the same kernel (gwc.py::_bwd, XLA linear
// transposes).
// Bound: memory traffic. At the SceneFlow train shape (B=1, C=320, H=64,
// W=128, G=40, D=48) in f32 it must read the entries w >= d of Gv (51.4 MB
// of its 62.9 MB) and L, R (21.0 MB) and write dL, dR (21.0 MB): ~93 MB,
// ~28 us at 3.35 TB/s; ~0.4 GFLOP of products. bf16 halves the bytes.
// Design: the work items are (b, g, h, W-tile of TW columns; TW = kTW, or
// kTW / 2 where that leaves fewer columns idle), as in the forward, walked
// by as many blocks as are resident. A pass stages, by cp.async 16-byte
// copies with zero fill outside [0, W) (scalar loads for ragged rows), up
// to kPass rows of Gv (rows dc + [0, rows)) over w0 + [0, TW + dc + rows),
// the group's rows of R over w0 - dc - rows + [0, TW + rows) and of L over
// w0 + dc + [0, TW + rows) into dynamic shared memory (above 48 KB, opted
// in at launch); the next pass's copies are in flight while this one is
// computed (two buffers).
// Every element of Gv, L and R is then read from device memory about once
// per item. Half the threads make dL, half dR; thread (e, s, q) of a half
// owns the kV columns w0 + q*kV + [0, kV) and the kCh channels s*kCh +
// [0, kCh), keeps its sums in registers across passes, and takes every
// kSplit-th step of kND disparities from e on; at the item's end the kSplit
// threads of a set add their sums through shared memory. A step loads the
// kND x kV values of Gv its columns need once for all its channels (dL:
// Gv[d, w]; dR: the diagonal Gv[d, w + d], from one or two aligned 16-byte
// loads per d, the offset known at compile time), then per channel one
// strip of kND + kV values (dL: R[w - d]; dR: L[w + d]) from which each d
// takes its window in registers. Sums in f32, divided by cpg and rounded
// once; one 16-byte store per channel, neighbouring threads on neighbouring
// columns. The occluded Gv[d, w < d] are zeros in shared memory for dL:
// whole vectors by the copies' zero fill, the one vector per row that
// straddles d by hand. Staged rows span TW + halo columns (halo = D rounded
// up to kND, at most kHalo); a pass whose rows end beyond the halo (D >
// kHalo) stages twice, Gv from w0 for dL and from w0 + dc for dR.
//
// Plane range (gwc_volume_backward_* with d_lo > 0): Gv holds the planes
// d_lo <= d < d_lo + D of the volume, plane k disparity d_lo + k (a rank of
// the disparity-sharded train step holds only its own), and dL, dR are
// that range's part of the sums above. The passes start at dbase = d_lo
// rounded down to kND, so that every window of R, L and Gv starts on a
// whole 16-byte vector as in the whole volume; the up to kND - 1 rows below
// d_lo are staged as zeros, and the windows and the occlusion test take the
// absolute disparity dbase + d. Gv's window for dR then no longer starts at
// w0, so above dbase = 0 no pass serves dL and dR from one staging (every
// pass stages twice). Launches from d_lo = 0, the whole volume's among
// them, take an instantiation without that arithmetic (kRange = false).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <numeric>

namespace {

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

// Tile of the backward kernel per element type: kTW columns per work item
// (or kTW / 2 where that leaves fewer columns idle: bwd_tile_width), kV
// columns per thread (one store of kV elements per channel), kND
// disparities per step of a thread's loop, at most kCH channels per thread,
// kSplit threads sharing the steps of one set of sums (1 where the block
// would pass 512 threads: bwd_split), at most kPass
// disparities per pass (one staging), staged rows of at most kTW + kHalo
// columns.
// tests/test_torch_gwc.py reads these lines to emulate the kernel's index map.
template <typename T>
struct BwdTile;
template <>
struct BwdTile<float> {
  static constexpr int kTW = 128, kV = 4, kND = 8, kCH = 4, kSplit = 2, kPass = 48, kHalo = 64;
};
template <>
struct BwdTile<__nv_bfloat16> {
  static constexpr int kTW = 64, kV = 8, kND = 8, kCH = 4, kSplit = 2, kPass = 64, kHalo = 64;
};

// The kernels move elements as raw bits and convert by hand.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using bits = unsigned int;
  static __device__ __forceinline__ float to_f32(bits v) { return __uint_as_float(v); }
  // element i of a run held as 32-bit words (i known at compile time)
  template <int NW>
  static __device__ __forceinline__ float at(const unsigned (&w)[NW], int i) { return __uint_as_float(w[i]); }
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
  template <int NW>
  static __device__ __forceinline__ float at(const unsigned (&w)[NW], int i) {
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
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

// NW 32-bit words of shared memory at p (16-byte aligned) in 16-byte loads,
// all of them: the compiler does not narrow them to the words the caller
// uses, which at a 16-byte stride between lanes would cost as many bank
// cycles as whole vectors and more instructions.
template <int NW>
__device__ __forceinline__ void lds_words(const void* p, unsigned (&w)[NW]) {
  static_assert(NW % 4 == 0, "whole 16-byte vectors");
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
#pragma unroll
  for (int i = 0; i < NW / 4; ++i)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[4 * i]), "=r"(w[4 * i + 1]), "=r"(w[4 * i + 2]), "=r"(w[4 * i + 3])
                 : "r"(a + 16 * i));
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

template <typename T, int CPG, bool kRange>
__global__ void __launch_bounds__(FwdShape<T>::kThreads, FwdShape<T>::kMinBlocks)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
                  int G, int H, int W, int D, int d_lo, int tiles, int items, bool vec) {
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
  // the passes cover the disparities dbase + [0, DT): the D output planes
  // from d_lo = dbase + off on, dbase aligned to V; without kRange (d_lo =
  // 0) the same code as a kernel with no range
  const int off = kRange ? d_lo % V : 0, dbase = kRange ? d_lo - off : 0, DT = D + off;

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
  // R[w0 - dbase - dc - DC, w0 - dbase - dc + TW) of the item's rows into
  // rs[buf], and for the first pass L[w0, w0 + TW) into ls[buf]; one commit
  // group
  auto stage = [&](const Item& it, int buf, int dc) {
    if (dc == 0) {
      for (int i = t; i < CPG * NCG; i += Sh::kThreads) {
        const int c = i / NCG, j = (i % NCG) * V;
        stage_run<S, V>(it.l + c * plane, it.w0 + j, W, vec, &ls[buf][c][j]);
      }
    }
    const int a = it.w0 - dbase - dc - DC;  // column of rs[buf][.][0], a multiple of V
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
    for (int dc = 0; dc < DT; dc += DC) {
      if (dc) {  // a further pass over d: this item's own window of R
        __syncthreads();
        stage(it, buf, dc);
        cp_async_wait_group<0>();
        __syncthreads();
      }
      const int d0 = dc + s * ND;
      if (wv >= W || d0 >= DT) continue;

      // disparity dbase + d0 + k (output plane d0 + k - off) at column wv + v
      // needs R[wv + v - dbase - d0 - k] = rs[buf][c][j0 + v - k + ND]
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
        if (d >= DT) break;
        if (kRange && d < off) continue;  // below d_lo: not this launch's plane
        float x[V];
#pragma unroll
        for (int v = 0; v < V; ++v) x[v] = wv + v >= dbase + d ? acc[k][v] / (float)CPG : 0.0f;
        S o[V];
        E::round(x, o);
        S* dst = it.o + (d - off) * plane + wv;
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

// Threads sharing one set of backward sums: kSplit, or 1 where kSplit would
// take the block past 512 threads (and so below 128 registers per thread).
template <typename T>
__host__ __device__ constexpr int bwd_split(int cpg, int tw) {
  using F = BwdTile<T>;
  const int sums = tw / F::kV * (cpg / (cpg < F::kCH ? cpg : F::kCH));
  return 2 * sums * F::kSplit <= 512 ? F::kSplit : 1;
}

template <typename T, int CPG, int TW>
struct BwdShape {
  using F = BwdTile<T>;
  static constexpr int kCols = TW / F::kV;                 // column groups per item
  static constexpr int kCh = CPG < F::kCH ? CPG : F::kCH;  // channels per thread
  static constexpr int kSums = kCols * (CPG / kCh);        // sets of sums per role (dL, dR)
  static constexpr int kSplit = bwd_split<T>(CPG, TW);     // threads per set of sums
  static constexpr int kRole = kSums * kSplit;             // threads making dL, and as many dR
  static constexpr int kThreads = 2 * kRole;
  static_assert(kThreads <= 512, "at most 512 threads per block");
};

// Columns per work item of the backward on rows of W: kTW, or kTW / 2 where
// its tiles leave fewer columns idle (a row of 176 is 3 items of 64, not 2
// of 128).
template <typename T>
int bwd_tile_width(int W) {
  constexpr int tw = BwdTile<T>::kTW, half = tw / 2;
  return (W + half - 1) / half * half < (W + tw - 1) / tw * tw ? half : tw;
}

// The backward's passes over d for a given D and tile width TW. Staged rows
// span TW + halo columns (halo: D rounded up to kND, at most kHalo); pass p
// stages rows dc + [0, rows) of Gv, dc = p * pass. The first `joint` passes
// (dc + rows <= halo) serve dL and dR from one staging (Gv's window from
// w0); a later pass stages twice: Gv from w0 for dL, from w0 + dc for dR.
template <typename T>
struct BwdPlan {
  int halo, pass, pitch, passes, joint;
  // D: the rows the passes cover; dbase: the disparity of the first (a
  // plane range's; above 0 no pass is joint, as dR's window of Gv then
  // starts at w0 + dbase + dc)
  __host__ __device__ BwdPlan(int D, int TW, int dbase = 0) {
    using F = BwdTile<T>;
    const int d = (D + F::kND - 1) / F::kND * F::kND;
    halo = d < F::kHalo ? d : F::kHalo;
    pass = F::kPass < halo ? F::kPass : halo;
    pitch = TW + halo;
    passes = (D + pass - 1) / pass;
    const int full = halo / pass;  // passes wholly inside the window
    joint = passes < full ? passes : full;
    if (passes > full && full * pass + rows(D, full * pass) <= halo) ++joint;
    if (dbase) joint = 0;
  }
  // rows of Gv a pass at dc stages: up to D rounded up to kND
  __host__ __device__ int rows(int D, int dc) const {
    const int r = (D - dc + BwdTile<T>::kND - 1) / BwdTile<T>::kND * BwdTile<T>::kND;
    return r < pass ? r : pass;
  }
  __host__ __device__ int phases() const { return joint + 2 * (passes - joint); }
};

// Dynamic shared memory of the backward kernel: two buffers, each with
// `pass` rows of Gv and the group's rows of L and R, `pitch` elements each;
// then the f32 partial sums of all but the first of each set's kSplit
// threads. D: the rows the passes cover (a plane range's D + d_lo % kND).
template <typename T>
long long bwd_smem_bytes(int cpg, int D, int TW) {
  const BwdPlan<T> plan(D, TW);
  return 2 * (plan.pass + 2LL * cpg) * plan.pitch * (long long)sizeof(T) +
         (bwd_split<T>(cpg, TW) - 1) * 2LL * cpg * TW * (long long)sizeof(float);
}

// Rows the backward's passes cover for D planes from d_lo: D, and for a
// range from d_lo > 0 the d_lo % kND zero rows below it.
template <typename T>
int bwd_rows(int D, int d_lo) {
  return D + (d_lo ? d_lo % BwdTile<T>::kND : 0);
}

template <typename T, int CPG, int TW, bool kRange>
__global__ void __launch_bounds__(BwdShape<T, CPG, TW>::kThreads)
gwc_volume_backward_kernel(const T* __restrict__ grad, const T* __restrict__ left,
                           const T* __restrict__ right, T* __restrict__ dleft,
                           T* __restrict__ dright, int H, int W, int D, int d_lo, int tiles,
                           int items, bool vec) {
  using E = Elem<T>;
  using S = typename E::bits;
  using F = BwdTile<T>;
  using Sh = BwdShape<T, CPG, TW>;
  constexpr int V = F::kV, ND = F::kND, CH = Sh::kCh, NCG = Sh::kCols;
  constexpr int NT = Sh::kThreads, SPLIT = Sh::kSplit;
  static_assert(TW % V == 0 && ND % V == 0 && F::kPass % ND == 0 && F::kHalo % ND == 0,
                "columns, steps and passes are whole vectors");
  static_assert(V * sizeof(S) == 16, "a thread's kV columns are one 16-byte vector");
  constexpr int VW = 4, SW = (ND + V) * (int)sizeof(S) / 4;  // words of a vector, of a strip
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* const smem = reinterpret_cast<S*>(smem_raw);

  // the passes cover the rows dbase + [0, DT), absolute disparities: Gv's
  // planes from d_lo = dbase + off on, dbase aligned to kND, the rows below
  // zeros; without kRange (d_lo = 0) the same code as a kernel with no range
  const int off = kRange ? d_lo % ND : 0, dbase = kRange ? d_lo - off : 0, DT = D + off;
  const BwdPlan<T> plan(DT, TW, dbase);
  const int P = plan.pitch, phases = plan.phases();
  const int buf_elems = (plan.pass + 2 * CPG) * P;
  // partial sums of threads e > 0: [dL, dR][e - 1][channel][column]
  float* const part = reinterpret_cast<float*>(smem + 2 * buf_elems);
  // thread t: role (dL, dR), e (which of the kSplit threads sharing the
  // steps over d: steps e, e + kSplit, ...), channels c0 + [0, kCh), columns
  // q*kV + [0, kV); the role is warp-uniform where kRole is a multiple of 32
  const int t = threadIdx.x;
  const bool is_dr = t >= Sh::kRole;
  const int tr = is_dr ? t - Sh::kRole : t;
  const int e = tr / Sh::kSums, q = tr % NCG, c0 = tr % Sh::kSums / NCG * CH;
  const long long plane = (long long)H * W;

  // work item -> (b, g, h, tile), tile fastest: the first column, Gv[b, g,
  // 0, h, 0], and the rows of channel g*CPG at (b, h, 0) of L, R, dL, dR
  struct Item {
    int w0;
    const S* g;
    const S* l;
    const S* r;
    S* dl;
    S* dr;
  };
  auto decode = [&](int item) {
    const int tile = item % tiles;
    item /= tiles;
    const int h = item % H;
    item /= H;
    const long long bg = item;  // b * G + g
    const long long fbase = bg * CPG * plane + (long long)h * W;
    return Item{tile * TW,
                reinterpret_cast<const S*>(grad) + bg * D * plane + (long long)h * W,
                reinterpret_cast<const S*>(left) + fbase,
                reinterpret_cast<const S*>(right) + fbase,
                reinterpret_cast<S*>(dleft) + fbase,
                reinterpret_cast<S*>(dright) + fbase};
  };
  // An item's phases: pass p < joint for dL and dR; then each later pass
  // once for dL and once for dR. a: Gv's window starts at w0 + a (for dR
  // alone at the pass's first disparity, dbase + dc).
  struct Phase {
    int dc, rows, a;
    bool dl, dr;
  };
  auto phase_of = [&](int ph) {
    Phase x;
    if (ph < plan.joint) {
      x.dc = ph * plan.pass;
      x.dl = x.dr = true;
    } else {
      const int k = ph - plan.joint;
      x.dc = (plan.joint + k / 2) * plan.pass;
      x.dl = k % 2 == 0;
      x.dr = !x.dl;
    }
    x.rows = plan.rows(DT, x.dc);
    x.a = x.dl ? 0 : dbase + x.dc;
    return x;
  };
  // f(row, column) for the vectors of a rows x vecs region, the block's
  // threads in turn; the indices advance without a division
  auto for_each_vector = [&](int rows, int vecs, auto&& f) {
    int row = t / vecs, j = t % vecs;
    const int drow = NT / vecs, dj = NT % vecs;
    while (row < rows) {
      f(row, j * V);
      row += drow;
      j += dj;
      if (j >= vecs) {
        j -= vecs;
        ++row;
      }
    }
  };
  // A phase's windows into buffer buf, one commit group, with dca = dbase +
  // dc the disparity of its first row: Gv rows dc + [0, rows) over w0 + a +
  // [0, TW), or + [0, TW + dca - a + rows) where dR reads them; for dL
  // R[w0 - dca - rows + [0, TW + rows)), for dR L[w0 + dca + [0, TW +
  // rows)). Zeros outside [0, W), in place of the rows outside Gv's planes,
  // and for dL in place of the vectors of Gv that lie wholly left of their
  // row's disparity (occluded).
  auto stage = [&](const Item& it, const Phase& x, int buf) {
    S* gs = smem + buf * buf_elems;
    S* ls = gs + plan.pass * P;
    S* rs = ls + CPG * P;
    const int ga = it.w0 + x.a, dca = dbase + x.dc;
    for_each_vector(x.rows, (x.dr ? TW + dca - x.a + x.rows : TW) / V, [&](int row, int j) {
      const int d = x.dc + row;
      const bool live = (!kRange || d >= off) && d < DT && !(x.dl && ga + j + V <= dbase + d);
      stage_run<S, V>(it.g + (live ? d - off : 0) * plane, ga + j, live ? W : 0, vec, gs + row * P + j);
    });
    for_each_vector(CPG, (TW + x.rows) / V, [&](int c, int j) {
      if (x.dl) stage_run<S, V>(it.r + c * plane, it.w0 - dca - x.rows + j, W, vec, rs + c * P + j);
      if (x.dr) stage_run<S, V>(it.l + c * plane, it.w0 + dca + j, W, vec, ls + c * P + j);
    });
    cp_async_commit();
  };

  float acc[CH][V];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.0f;

  int item = blockIdx.x, phase = 0;
  if (item >= items) return;
  Item it = decode(item);
  stage(it, phase_of(0), 0);
  for (int n = 0;; ++n) {
    const int buf = n & 1;
    int next = item, next_phase = phase + 1;
    if (next_phase == phases) {
      next += gridDim.x;
      next_phase = 0;
    }
    Item next_it = it;
    if (next < items) {
      if (next != item) next_it = decode(next);
      stage(next_it, phase_of(next_phase), buf ^ 1);
      cp_async_wait_group<1>();  // this phase's group has landed, the next one's may be in flight
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const Phase x = phase_of(phase);
    const int w = it.w0 + q * V;  // this thread's first column
    S* const gs = smem + buf * buf_elems;
    if (x.dl && it.w0 < dbase + x.dc + x.rows - 1) {
      // the occluded Gv[d, u < d] never reach dL (dR reads only u >= d):
      // staging put zeros in place of whole vectors of them, here the rest
      for (int row = t; row < x.rows; row += NT) {
        const int occluded = dbase + x.dc + row - it.w0;  // columns [0, occluded) of the row
        if (occluded > 0 && occluded < TW)
          for (int u = occluded - occluded % V; u < occluded; ++u) gs[row * P + u] = S(0);
      }
      __syncthreads();
    }
    if (w < W && !is_dr && x.dl) {
      // dL(c, w + v) += Gv[d0 + k, w + v] R[c, w + v - dbase - d0 - k]; the
      // strip r[i] = R[c, w - dbase - d0 - kND + i] from rs[c][q*kV + rows -
      // (j + 1)*kND]
      const S* rs = gs + (plan.pass + CPG) * P;
      for (int j = e; j * ND < x.rows; j += SPLIT) {
        const int d0 = x.dc + j * ND;
        if (d0 >= DT || dbase + d0 >= w + V) break;  // later d lie past D or right of every column (w < d)
        unsigned gw[ND][VW], rw[CH][SW];  // every load of the step first, then the products
#pragma unroll
        for (int k = 0; k < ND; ++k) lds_words(gs + (j * ND + k) * P + q * V, gw[k]);
#pragma unroll
        for (int c = 0; c < CH; ++c) lds_words(rs + (c0 + c) * P + q * V + x.rows - (j + 1) * ND, rw[c]);
        float g[ND][V];
#pragma unroll
        for (int k = 0; k < ND; ++k)
#pragma unroll
          for (int v = 0; v < V; ++v) g[k][v] = E::at(gw[k], v);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float r[ND + V];
#pragma unroll
          for (int i = 1; i < ND + V; ++i) r[i] = E::at(rw[c], i);
#pragma unroll
          for (int k = 0; k < ND; ++k)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[c][v] = fmaf(g[k][v], r[v - k + ND], acc[c][v]);
        }
      }
    }
    if (w < W && is_dr && x.dr) {
      // dR(c, w + v) += Gv[d0 + k, w + v + e0 + k] L[c, w + v + e0 + k], e0 =
      // dbase + d0: row j*kND + k of Gv at column q*kV + e0 - a + k + v, and
      // the strip l[i] = L[c, w + e0 + i] from ls[c][q*kV + j*kND]
      const S* ls = gs + plan.pass * P;
      for (int j = e; j * ND < x.rows; j += SPLIT) {
        const int d0 = x.dc + j * ND;
        if (d0 >= DT || w + dbase + d0 >= W) break;  // later d lie past D or read only zeros past W
        unsigned lw[CH][SW];
#pragma unroll
        for (int c = 0; c < CH; ++c) lds_words(ls + (c0 + c) * P + q * V + j * ND, lw[c]);
        float g[ND][V];
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          const int o = k % V;  // known at compile time once unrolled
          const S* row = gs + (j * ND + k) * P + q * V + dbase + d0 - x.a + (k - o);
          if (o == 0) {
            unsigned y[VW];
            lds_words(row, y);
#pragma unroll
            for (int v = 0; v < V; ++v) g[k][v] = E::at(y, v);
          } else {
            unsigned y[2 * VW];
            lds_words(row, y);
#pragma unroll
            for (int v = 0; v < V; ++v) g[k][v] = E::at(y, o + v);
          }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float l[ND + V - 1];
#pragma unroll
          for (int i = 0; i < ND + V - 1; ++i) l[i] = E::at(lw[c], i);
#pragma unroll
          for (int k = 0; k < ND; ++k)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[c][v] = fmaf(g[k][v], l[k + v], acc[c][v]);
        }
      }
    }
    if (phase == phases - 1) {  // the item's last phase: its sums are complete
      if constexpr (SPLIT > 1) {  // thread e = 0 of each set adds the others' partial sums
        float* pp = part + (is_dr * (SPLIT - 1) * CPG + c0) * TW + q * V;
        if (e > 0) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int v = 0; v < V; ++v) pp[((e - 1) * CPG + c) * TW + v] = acc[c][v];
        }
        __syncthreads();
        if (e == 0) {
#pragma unroll
          for (int f = 1; f < SPLIT; ++f)
#pragma unroll
            for (int c = 0; c < CH; ++c)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[c][v] += pp[((f - 1) * CPG + c) * TW + v];
        }
      }
      if (e == 0 && w < W) {
        S* out = is_dr ? it.dr : it.dl;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float y[V];
#pragma unroll
          for (int v = 0; v < V; ++v) y[v] = acc[c][v] / (float)CPG;
          S o[V];
          E::round(y, o);
          S* dst = out + (c0 + c) * plane + w;
          if (vec) {
            store_run<S, V>(dst, o);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (w + v < W) dst[v] = o[v];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[c][v] = 0.0f;
    }
    __syncthreads();  // this buffer is read: free to refill
    if (next >= items) break;
    item = next;
    phase = next_phase;
    it = next_it;
  }
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
           int G, int D, int d_lo, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || C % G != 0 || d_lo < 0) return (int)cudaErrorInvalidValue;
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
    auto kernel = d_lo ? gwc_volume_kernel<T, CPG, true> : gwc_volume_kernel<T, CPG, false>;      \
    int per_sm = 0;                                                                               \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FwdShape<T>::kThreads, 0); \
    if (err != cudaSuccess) return (int)err;                                                      \
    const long long blocks = grid_size(items, tiles, (long long)sms * std::max(per_sm, 1));     \
    kernel<<<(unsigned)blocks, FwdShape<T>::kThreads, 0, s>>>(l, r, o, G, H, W, D, d_lo, (int)tiles, \
                                                             (int)items, vec);                    \
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

// One launch of the backward kernel at tile width TW: as many blocks as are
// resident at once, each walking its items; above 48 KB of shared memory
// only once the kernel is opted in (each launch, for what it asks; costs no
// measurable time).
template <typename T, int CPG, int TW>
cudaError_t launch_backward_tw(const T* gv, const T* l, const T* r, T* dl, T* dr, int B, int G, int H,
                               int W, int D, int d_lo, int sms, bool vec, cudaStream_t s) {
  auto kernel = d_lo ? gwc_volume_backward_kernel<T, CPG, TW, true> : gwc_volume_backward_kernel<T, CPG, TW, false>;
  constexpr int threads = BwdShape<T, CPG, TW>::kThreads;
  const long long tiles = (W + TW - 1) / TW;
  const long long items = (long long)B * G * H * tiles;
  if (items > 0x3fffffffLL) return cudaErrorInvalidValue;  // item + gridDim.x stays an int
  const int smem = (int)bwd_smem_bytes<T>(CPG, bwd_rows<T>(D, d_lo), TW);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = grid_size(items, tiles, (long long)sms * std::max(per_sm, 1));
  kernel<<<(unsigned)blocks, threads, smem, s>>>(gv, l, r, dl, dr, H, W, D, d_lo, (int)tiles, (int)items, vec);
  return cudaGetLastError();
}

template <typename T>
int launch_backward(const void* grad, const void* left, const void* right, void* dleft,
                    void* dright, int B, int C, int H, int W, int G, int D, int d_lo, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || C % G != 0 || D <= 0 || d_lo < 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * G * H * W == 0) return 0;
  constexpr int TW = BwdTile<T>::kTW;
  constexpr unsigned kAlign = BwdTile<T>::kV * sizeof(T);
  const bool vec = W % BwdTile<T>::kV == 0 && (size_t)grad % kAlign == 0 && (size_t)left % kAlign == 0 &&
                   (size_t)right % kAlign == 0 && (size_t)dleft % kAlign == 0 && (size_t)dright % kAlign == 0;
  const T* gv = static_cast<const T*>(grad);
  const T* l = static_cast<const T*>(left);
  const T* r = static_cast<const T*>(right);
  T* dl = static_cast<T*>(dleft);
  T* dr = static_cast<T*>(dright);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = bwd_tile_width<T>(W) < TW;
  int sms = 0, optin = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if (bwd_smem_bytes<T>(C / G, bwd_rows<T>(D, d_lo), bwd_tile_width<T>(W)) > optin)
    return (int)cudaErrorInvalidConfiguration;
#define GWC_BWD(CPG)                                                                                    \
  err = narrow ? launch_backward_tw<T, CPG, TW / 2>(gv, l, r, dl, dr, B, G, H, W, D, d_lo, sms, vec, s) \
               : launch_backward_tw<T, CPG, TW>(gv, l, r, dl, dr, B, G, H, W, D, d_lo, sms, vec, s);    \
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
  return (int)err;
}

}  // namespace

// Plain C interface for ctypes. Pointers and the stream are passed as
// void*; the return value is the cudaError_t of the launch (0 = success).
// The forward writes the D planes d_lo, ..., d_lo + D - 1 of the volume;
// the backward takes their grad and makes their part of dL and dR.
extern "C" int gwc_volume_f32(const void* left, const void* right, void* out, int B, int C,
                              int H, int W, int G, int D, int d_lo, int device, void* stream) {
  return launch<float>(left, right, out, B, C, H, W, G, D, d_lo, device, stream);
}

extern "C" int gwc_volume_bf16(const void* left, const void* right, void* out, int B, int C,
                               int H, int W, int G, int D, int d_lo, int device, void* stream) {
  return launch<__nv_bfloat16>(left, right, out, B, C, H, W, G, D, d_lo, device, stream);
}

extern "C" int gwc_volume_backward_f32(const void* grad, const void* left, const void* right,
                                       void* dleft, void* dright, int B, int C, int H, int W,
                                       int G, int D, int d_lo, int device, void* stream) {
  return launch_backward<float>(grad, left, right, dleft, dright, B, C, H, W, G, D, d_lo, device,
                                stream);
}

// Bytes of dynamic shared memory a backward launch asks for per block (the
// card allows cudaDevAttrMaxSharedMemoryPerBlockOptin); -1 for a shape the
// kernels do not take. A launch that would ask for more fails with
// cudaErrorInvalidConfiguration.
extern "C" long long gwc_volume_backward_smem_bytes(int C, int W, int G, int D, int d_lo, int elem_bytes) {
  if (G <= 0 || C % G != 0 || D <= 0 || W <= 0 || d_lo < 0) return -1;
  if (elem_bytes == 4) return bwd_smem_bytes<float>(C / G, bwd_rows<float>(D, d_lo), bwd_tile_width<float>(W));
  if (elem_bytes == 2)
    return bwd_smem_bytes<__nv_bfloat16>(C / G, bwd_rows<__nv_bfloat16>(D, d_lo),
                                         bwd_tile_width<__nv_bfloat16>(W));
  return -1;
}

extern "C" int gwc_volume_backward_bf16(const void* grad, const void* left, const void* right,
                                        void* dleft, void* dright, int B, int C, int H, int W,
                                        int G, int D, int d_lo, int device, void* stream) {
  return launch_backward<__nv_bfloat16>(grad, left, right, dleft, dright, B, C, H, W, G, D,
                                        d_lo, device, stream);
}
