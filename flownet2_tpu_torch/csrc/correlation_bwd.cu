// K5, K6 and K7 backward: the correlation cost volume's gradient, float32
// or bfloat16.
//
// Replaces flownet2_tpu/ops/correlation_pallas.py: _bwd_f1_kernel and
// _bwd_f1_kernel_wide (K5, d_f1) and _bwd_f2_kernel and _bwd_f2_kernel_wide
// (K6, d_f2), reached through _correlation_pallas_bwd_impl from
// correlation_pallas_bwd (entry points correlation_bwd_f1 and
// correlation_bwd_f2) and, with slab=True, from correlation_pallas_bwd_rows
// (K7, entry points correlation_bwd_f1_rows and correlation_bwd_f2_rows).
// Each kernel has no width limit, so one covers the narrow and the wide
// case.  With r = maxd / s2, D = 2r + 1, d = (tj+r)*D + (ti+r) and
// out-of-range terms zero:
//
//   K5: d_f1[b,c,y,x]   = (1/C) sum_{tj,ti} g[b,d,y,x] * f2[b,c,y+tj*s2,x+ti*s2]
//   K6: d_f2[b,c,y2,x2] = (1/C) sum_{tj,ti} g[b,d,y2-tj*s2,x2-ti*s2]
//                                          * f1[b,c,y2-tj*s2,x2-ti*s2]
//
// g is (B, D*D, H, W); f1, f2, d_f1, d_f2 are (B, C, H, W).  K=1, stride1=1,
// pad=maxd, as for K1 (correlation_fwd.cu).
//
// The row-slab forms (K7) serve a height-split cost volume: g and f1 hold
// one band of Hloc rows, and the second operand is the band's halo slab of
// Hloc + 2*maxd rows (correlation_fwd.cu), whose gradient comes back in slab
// coordinates:
//
//   d_f1[b,c,y,x]     = (1/C) sum_{tj,ti} g[b,d,y,x]
//                                        * slab[b,c,y+maxd+tj*s2,x+ti*s2]
//   d_slab[b,c,ys,x2] = (1/C) sum_{tj,ti} g[b,d,ys-maxd-tj*s2,x2-ti*s2]
//                                        * f1[b,c,ys-maxd-tj*s2,x2-ti*s2]
//
// with source rows outside [0, Hloc) and columns outside [0, W) contributing
// zero, so the top and bottom maxd slab rows get terms from only some tj.
// Each kernel body reads or writes the second operand with a row count H2
// and a row shift: K5 and K6 are (H2 = H, shift = 0), K7 is
// (H2 = Hloc + 2*maxd, shift = maxd), two instantiations of one template, so
// that K5 and K6 keep the code they had with both values folded in (as
// run-time arguments they cost 3-4% of their time on the H100).  The d_f2
// grid covers H2 rows.  The sums run in the same order either way.
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 256, H 48,
// W 56, maxd 20, s2 2 -> 441 channels): each kernel does 4.855 GFLOP of
// f32 multiply-adds against ~82 MB moved (g, one feature map in, one out),
// so the FMA rate (~67 TFLOP/s, ~72.5 us) bounds it, not the memory
// (~24.5 us).  The TPU kernels fed bf16 operands to the matrix unit; here
// operands and sums stay f32.
//
// Design: both kernels are gathers: every output element is summed by one
// thread in a fixed order, so there are no atomics and the result does not
// depend on the run (a scatter of d_f2 with atomicAdd would).  Each output
// sums the row shifts in ascending order (a row shift whose second-operand
// row lies outside the map skipped), then is divided by C: in the FMA bodies
// one fmaf chain with the column shifts in ascending order inside each row
// shift, in the tensor-core body one mma per k-step in ascending order.  A
// body sums the same way in either form, so a band's rows carry the bits of
// the whole-map call.
//
// In float32, K5 and K6 (and their K7 forms) each have two bodies, chosen
// by configuration in launch_f1() and launch_f2():
//
// * correlation_bwd_f1_tile_kernel and correlation_bwd_f2_tile_kernel, for
//   maxd 20, s2 2 (FlowNetC's, D = 21), the ones the models run.  See the
//   notes above them.
// * correlation_bwd_f1_kernel and correlation_bwd_f2_kernel, for every
//   other (maxd, s2): a block owns one output row, 64 output columns and 32
//   channels, and loops over the D row shifts staging the cotangent
//   channels of that shift and the one feature row it needs (64 + 2*maxd
//   columns, 32 channels) in shared memory; thread (tx, grp) owns output
//   column tx and the channels grp, grp+4, ..., grp+28, kept in registers
//   across all shifts.  Per column shift a thread reads one cotangent value
//   and reuses it for its 8 channels: about one 4-byte shared-memory load
//   per FMA, which held K6 at 5.2% of the bound of its in-map FMAs (0.888
//   ms at the shape above on an NVIDIA H100 80GB HBM3, 700 W).  Outputs are
//   written as coalesced rows.  A row shift that falls wholly outside the
//   image is skipped (the whole block agrees, so the barriers stay
//   uniform).
//
// bfloat16 g, f1 and f2 (entry points correlation_bwd_f1_bf16 and
// correlation_bwd_f2_bf16, the bf16 model's K5 and K6, and their K7 forms
// correlation_bwd_f1_rows_bf16 and correlation_bwd_f2_rows_bf16): float32
// sums of the bf16 products, divided by C and rounded once to bfloat16.  The
// TPU kernels feed bf16 operands to the matrix unit, sum in f32 and return
// f32 (correlation_pallas.py:541-602), which the JAX package casts to f1's
// dtype (ops/correlation.py:296): the same value, rounded once.  At 2 bytes
// a value FlowNet2's training shape moves ~41 MB a kernel, 0.0122 ms at
// 3.35 TB/s, and its multiply-adds take ~0.005 ms at the bf16 tensor-core
// rate: the bytes bound it.  Two bodies serve each, chosen by configuration
// in launch_f1_bf16() and launch_f2_bf16():
//
// * correlation_bwd_f1_mma_kernel and correlation_bwd_f2_mma_kernel
//   (namespace band), d_f1 and d_f2 (and K7's d_f1 and d_slab) at maxd 20,
//   s2 2: the TPU kernels' band products on the tensor cores.  See the
//   notes above them.
// * the general bodies, for every other (maxd, s2): the operands are upcast
//   exactly as they are staged into the float shared tiles and each output
//   is the float fmaf chain of the float body in its order.  The tiled f32
//   bodies do not serve bf16: their 16-byte cp.async staging copies f32
//   rows as they lie and cannot upcast.

#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The register-tiled d_f1 body for maxd 20, s2 2 (K5 and K7 d_f1).
//
// A thread owns 16 neighbouring pixels x .. x+15 of one output row and 4
// channels: 64 sums in registers, kept across all 21 x 21 shifts.  At one
// row shift, the cotangent of (pixel, column shift) does not depend on the
// channel, and pixel k at column shift t reads f2 at span column
// x - 20 + k + 2t: from one column shift to the next a pixel group's f2
// window moves by 2 columns.  So per column shift a thread reads 16
// cotangent words (four 16-byte loads, shared by its 4 channels) and, per
// channel, the 2 new words of its window (one 16-byte load every other
// shift), for 64 FMAs: 96 bytes of shared memory per 64 FMAs, where the
// general body reads 4 bytes per FMA.  The 21 column shifts are unrolled,
// so the window is registers.
//
// Rows lie in shared memory as they lie in device memory (one 104-column
// span of f2 per channel, a row of the 64-column tile per cotangent
// channel), staged by 16-byte cp.async where W % 4 == 0 and the tensors are
// 16-byte aligned (kVec), else 4 bytes a copy.  f2 columns outside the map
// are written as zeros, and add exact zeros to the sums as in the general
// body; cotangent columns outside the map are not staged, since they feed
// only pixels outside it, which are not stored.
// A warp is one output row: lanes are 4 pixel groups x 8 channel groups,
// thread cg owning channels cg, cg+8, cg+16, cg+24 of the block's 32.  A
// quarter warp is 2 pixel groups (16 words apart) x 4 channel groups, and
// the channel rows lie 108 words apart (12 banks), so its 16-byte f2 loads
// cover the 32 banks once; its cotangent loads read 2 addresses.
//
// A block is (batch, 64-column tile, 32 channels, kRows output rows of one
// parity).  Output row ybase + 2r at row shift tj reads f2 row
// ybase + 2(tj + r) - 20 (+ 20 in the slab form): the rows of consecutive
// shifts are shared, so the block keeps a ring of kRows + 1 staged f2 rows
// and stages one new row and the kRows x 21 cotangent rows per row shift,
// while the previous shift is summed (two stages, one barrier a shift).  A
// warp whose f2 row lies outside the map skips that shift, as the general
// body does, and its rows are not staged.  Barriers stay uniform.
//
// Eight rows a block take 210 KB of shared memory, one block of 256 threads
// an SM, and stage (20 + 8) / 8 = 3.5 f2 rows per output row; four rows (two
// blocks an SM) stage 6.  On an NVIDIA H100 80GB HBM3 at 700 W, K5 at
// (8, 256, 48, 56) read 0.186 ms with 8 rows, 0.197-0.201 with 4, 0.201 with
// 64 channels a block (16 channel groups over two warps a row), 0.23-0.30
// with 2 rows or 8 pixels x 8 channels a thread; with 4 rows its sums alone
// took 0.153 ms and its staging alone 0.089.  The general body reads 0.661
// at that shape: this body is 3.6x faster, at 39% of the FMA bound.
// ---------------------------------------------------------------------------

namespace tiled {

constexpr int kMaxd = 20;                  // the tiled body's configuration
constexpr int kS2 = 2;
constexpr int kD = 2 * (kMaxd / kS2) + 1;  // 21
constexpr int kTileW = 64;                 // output columns per block
constexpr int kPix = 16;                   // pixels per thread
constexpr int kQ = 4;                      // channels per thread
constexpr int kCg = 8;                     // channel groups (a warp's lanes)
constexpr int kChunk = kQ * kCg;           // channels per block: 32
constexpr int kRows = 8;                   // output rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kSpan = kTileW + 2 * kMaxd;  // f2 columns a tile reads: 104
constexpr int kStride = 108;               // floats between channel rows
constexpr int kWin = kPix + kS2 * (kD - 1);   // f2 words a thread reads: 56
constexpr int kRing = kRows + 1;           // staged f2 rows
constexpr int kRowFloats = kChunk * kStride;
constexpr int kGFloats = kRows * kD * kTileW;   // one shift's cotangent
constexpr size_t kSmem = sizeof(float) * (kRing * kRowFloats + 2 * kGFloats);
static_assert(kSmem > 48 * 1024 && kSmem <= 227 * 1024,
              "above the default limit, within an SM's 227 KB");
static_assert(kTileW == 4 * kPix && kCg * 4 == 32, "a warp is one row");
static_assert(kStride >= kSpan && kStride % 4 == 0 && kStride % 32 == 12,
              "16-byte rows whose quarter-warp loads miss no bank");
static_assert(kWin % 4 == 0 && kPix % 4 == 0 && kMaxd % 4 == 0,
              "16-byte loads");

// One row shift of a thread's sums: cotangent rows at ``gp`` (column shift
// t at gp + t*kTileW), f2 spans of its channels at ``fp`` (channel j at
// fp + j*kCg*kStride), both at the thread's first pixel.
__device__ __forceinline__ void shift_sums(float (&acc)[kQ][kPix],
                                           const float* gp, const float* fp) {
  float w[kQ][kWin];
#pragma unroll
  for (int t = 0; t < kD; ++t) {
    // the window's 16-byte pieces that column shift t is the first to read
#pragma unroll
    for (int i = 0; i < kWin / 4; ++i) {
      const int last = kS2 * t + kPix - 1;
      if (4 * i <= last && (t == 0 || 4 * i > last - kS2)) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(fp + j * kCg * kStride + 4 * i);
          w[j][4 * i] = v.x;
          w[j][4 * i + 1] = v.y;
          w[j][4 * i + 2] = v.z;
          w[j][4 * i + 3] = v.w;
        }
      }
    }
    float gv[kPix];
#pragma unroll
    for (int i = 0; i < kPix / 4; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(gp + t * kTileW + 4 * i);
      gv[4 * i] = v.x;
      gv[4 * i + 1] = v.y;
      gv[4 * i + 2] = v.z;
      gv[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        acc[j][k] = fmaf(gv[k], w[j][kS2 * t + k], acc[j][k]);
    }
  }
}

template <bool kSlab, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
correlation_bwd_f1_tile_kernel(const float* __restrict__ g,
                               const float* __restrict__ f2,
                               float* __restrict__ d_f1, int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                        // [kRing][kChunk][kStride]
  float* gs = smem + kRing * kRowFloats;   // [2][kRows][kD][kTileW]
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of f2
  const int shift = kSlab ? kMaxd : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 5;                           // output row (warp)
  const int q = (lane & 1) | ((lane >> 2) & 2);     // pixel group
  const int cg = ((lane >> 1) & 3) | ((lane >> 2) & 4);   // channel group
  const int tiles = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunk;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int y = ybase + 2 * r;
  const bool owns = y < H;
  // staged f2 row rho is row row0 + 2*rho of f2; warp r at row shift n
  // reads rho = n + r
  const int row0 = ybase + shift - kMaxd;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  const float* f2b = f2 + (static_cast<int64_t>(b) * C + c0) * plane2;
  const float* gb = g + static_cast<int64_t>(b) * kD * kD * plane;

  // Staging, kPiece floats a copy.  f2: thread tid copies channel
  // tid / kPerCh of the chunk, the pieces tid % kPerCh, + kPerCh, ... of its
  // span.  The cotangent: thread tid copies one piece of a row of the tile
  // (kReps of them where the rows hold more pieces than the block has
  // threads) for the column shifts s_ti, s_ti + kTiStep, ...  The addresses
  // are worked out once; a row shift adds one offset.
  constexpr int kPiece = kVec ? 4 : 1;
  constexpr int kSpanPieces = kSpan / kPiece;
  constexpr int kTilePieces = kTileW / kPiece;
  constexpr int kPerCh = kThreads / kChunk;
  constexpr int kRowCol = kRows * kTilePieces;   // one column shift's pieces
  constexpr int kTiStep = kThreads >= kRowCol ? kThreads / kRowCol : 1;
  constexpr int kReps = kThreads >= kRowCol ? 1 : kRowCol / kThreads;
  static_assert(kThreads % kChunk == 0 &&
                (kThreads % kRowCol == 0 || kRowCol % kThreads == 0),
                "every thread copies the same number of pieces");
  const int sc = tid / kPerCh;
  const bool sc_ok = c0 + sc < C;
  const float* f2_src = f2b + sc * plane2 + (x0 - kMaxd);
  float* f2_dst = fs + sc * kStride;
  const int s_ti = kThreads >= kRowCol ? tid / kRowCol : 0;
  auto stage_f2 = [&](int rho) {
    const int row = row0 + 2 * rho;
    if (row < 0 || row >= H2) return;      // no warp reads it
    float* dst = f2_dst + (rho % kRing) * kRowFloats;
    const float* src = f2_src + static_cast<int64_t>(row) * W;
#pragma unroll
    for (int k = 0; k < (kSpanPieces + kPerCh - 1) / kPerCh; ++k) {
      const int col = (tid % kPerCh + k * kPerCh) * kPiece;   // span column
      if (col >= kSpan) break;
      const int x = x0 - kMaxd + col;
      const bool ok = sc_ok && x >= 0 && x < W;
      cp_async<4 * kPiece>(dst + col, ok ? src + col : f2, ok);
    }
  };
  auto stage_g = [&](int n) {
    float* dst0 = gs + (n & 1) * kGFloats;
#pragma unroll
    for (int m = 0; m < kReps; ++m) {
      const int rc = tid % kRowCol + m * kThreads;
      const int rr = rc / kTilePieces;
      const int col = rc % kTilePieces * kPiece;
      const int yy = ybase + 2 * rr;
      const int y2 = row0 + 2 * (n + rr);
      // not staged: a row whose warp skips this shift, and columns outside
      // the map (they feed only pixels outside it, which are not stored)
      if (yy >= H || y2 < 0 || y2 >= H2 || x0 + col >= W) continue;
      float* dst = dst0 + (rr * kD + s_ti) * kTileW + col;
      const float* src = gb + static_cast<int64_t>(n * kD + s_ti) * plane +
                         static_cast<int64_t>(yy) * W + x0 + col;
#pragma unroll
      for (int k = 0; k < (kD + kTiStep - 1) / kTiStep; ++k) {
        if (s_ti + k * kTiStep >= kD) break;
        cp_async<4 * kPiece>(dst + k * kTiStep * kTileW,
                             src + k * kTiStep * plane, true);
      }
    }
  };

  float acc[kQ][kPix];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[j][k] = 0.f;
  }

  for (int rho = 0; rho < kRows; ++rho) stage_f2(rho);
  stage_g(0);
  cp_async_commit();
  const float* g_at = gs + r * kD * kTileW + kPix * q;
  const float* f_at = fs + cg * kStride + kPix * q;
  for (int n = 0; n < kD; ++n) {
    cp_async_wait<0>();
    __syncthreads();     // shift n has landed; shift n - 1 is summed
    if (n + 1 < kD) {
      stage_f2(n + kRows);
      stage_g(n + 1);
    }
    cp_async_commit();
    const int y2 = row0 + 2 * (n + r);
    if (owns && y2 >= 0 && y2 < H2)
      shift_sums(acc, g_at + (n & 1) * kGFloats,
                 f_at + (n + r) % kRing * kRowFloats);
  }

  if (owns) {
    const float cf = static_cast<float>(C);
    const int x = x0 + kPix * q;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int c = c0 + cg + j * kCg;
      if (c >= C) continue;
      float* o = d_f1 + (static_cast<int64_t>(b) * C + c) * plane +
                 static_cast<int64_t>(y) * W + x;
      if (kVec) {
#pragma unroll
        for (int k = 0; k < kPix; k += 4) {
          if (x + k < W)
            *reinterpret_cast<float4*>(o + k) =
                make_float4(acc[j][k] / cf, acc[j][k + 1] / cf,
                            acc[j][k + 2] / cf, acc[j][k + 3] / cf);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (x + k < W) o[k] = acc[j][k] / cf;
        }
      }
    }
  }
}

template <bool kSlab, bool kVec>
int launch_as(const float* g, const float* f2, float* d_f1, int B, int C,
              int H, int W, cudaStream_t stream) {
  // the attribute belongs to the current device, so it is set on every
  // launch (one host call) rather than once per process
  const int err = static_cast<int>(cudaFuncSetAttribute(
      correlation_bwd_f1_tile_kernel<kSlab, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem)));
  if (err) return err;
  // row blocks with a first row inside the map: two (one per parity) for
  // every 2*kRows rows
  const int rest = H % (2 * kRows);
  const int ny = H / (2 * kRows) * 2 + (rest < 2 ? rest : 2);
  const dim3 grid((W + kTileW - 1) / kTileW * ((C + kChunk - 1) / kChunk), ny,
                  B);
  correlation_bwd_f1_tile_kernel<kSlab, kVec>
      <<<grid, kThreads, kSmem, stream>>>(g, f2, d_f1, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSlab>
int launch(const float* g, const float* f2, float* d_f1, int B, int C, int H,
           int W, cudaStream_t stream) {
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(g) |
                    reinterpret_cast<uintptr_t>(f2) |
                    reinterpret_cast<uintptr_t>(d_f1)) % 16 == 0;
  return vec ? launch_as<kSlab, true>(g, f2, d_f1, B, C, H, W, stream)
             : launch_as<kSlab, false>(g, f2, d_f1, B, C, H, W, stream);
}

// ---------------------------------------------------------------------------
// The register-tiled d_f2 body for maxd 20, s2 2 (K6 and K7 d_slab): the
// d_f1 body above, mirrored.
//
// Output pixel x2 at column shift ti reads the cotangent and f1 at source
// column x2 + 20 - 2ti, so pixel k of a thread's 16 reads f1 at span column
// xq - 20 + k + 40 - 2ti: the f1 window is the d_f1 body's, sliding left by
// 2 columns a shift where f2's slides right (a new 16-byte piece every other
// shift, the 21 shifts unrolled).  The cotangent is read at the source
// column too, not at the output pixel: the block's 64 pixels read columns
// x0 + 20 - 2ti .. + 63 of plane (tj, ti), 16-byte aligned only for even
// ti.  So each cotangent row is staged from the aligned column at or below
// that one, 68 columns, and a thread reads its 16 words at word offset 0
// (even ti, four 16-byte loads) or 2 (odd ti, five 16-byte loads of which
// it uses 16).  Cotangent columns outside the map feed pixels inside it
// (multiplied by f1's zero padding), so they are staged as zeros, as f1's
// are: the sums then add 0 * 0, as the general body does.
//
// Output row y2 at row shift tj reads source row y2 + 20 - 2tj (y2 - 2tj
// in the slab form, where y2 runs over the Hloc + 40 slab rows): warp r of
// a block reads staged f1 row rho = r + 20 - tj, so the ring of kRows + 1
// rows is filled in descending row order while each output's chain still
// runs tj ascending.  A warp whose source row lies outside [0, H) skips that
// shift; rows and cotangent rows no warp reads are not staged; barriers
// stay uniform.  The grid covers the output's rows (H2), by parity.
//
// Shared memory: 9 f1 rows (124.4 KB) and two stages of 8 x 21 cotangent
// rows of 68 columns (91.4 KB), 215.8 KB, one block of 256 threads an SM;
// 196-207 registers, no spills.  On an NVIDIA H100 80GB HBM3 at 700 W, K6
// at (8, 256, 48, 56) reads 0.238 ms (the general body 0.888: 3.7x, at 19%
// of the bound of its in-map FMAs) and K7 d_slab at one band of two, g
// (8, 441, 24, 56), 0.217 ms (0.602); its sums alone take 0.157 ms and its
// staging alone 0.132.  Staging the cotangent rows 64 columns wide by 8-byte
// cp.async read 0.293 / 0.275 ms; 4 rows a block (two blocks an SM) 0.241 /
// 0.206.
// ---------------------------------------------------------------------------

constexpr int kGStride = kTileW + 4;   // cotangent columns staged per row
constexpr int kGFloatsF2 = kRows * kD * kGStride;
constexpr size_t kSmemF2 =
    sizeof(float) * (kRing * kRowFloats + 2 * kGFloatsF2);
static_assert(kSmemF2 > 48 * 1024 && kSmemF2 <= 227 * 1024,
              "above the default limit, within an SM's 227 KB");
static_assert(kGStride % 4 == 0 && kMaxd % 4 == 0 && kS2 == 2,
              "16-byte cotangent rows at word offset 0 or 2");

// One row shift of a thread's d_f2 sums: cotangent rows at ``gp`` (column
// shift t at gp + t*kGStride, the thread's words from offset 2 for odd t),
// f1 spans of its channels at ``fp`` (channel j at fp + j*kCg*kStride),
// both at the thread's first pixel.
__device__ __forceinline__ void shift_sums_f2(float (&acc)[kQ][kPix],
                                              const float* gp,
                                              const float* fp) {
  float w[kQ][kWin];
#pragma unroll
  for (int t = 0; t < kD; ++t) {
    const int first = kS2 * (kD - 1 - t);   // pixel k reads word first + k
    // the window's 16-byte pieces that column shift t is the first to read
#pragma unroll
    for (int i = 0; i < kWin / 4; ++i) {
      if (4 * i + 3 >= first && (t == 0 || 4 * i + 3 < first + kS2)) {
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(fp + j * kCg * kStride + 4 * i);
          w[j][4 * i] = v.x;
          w[j][4 * i + 1] = v.y;
          w[j][4 * i + 2] = v.z;
          w[j][4 * i + 3] = v.w;
        }
      }
    }
    constexpr int kLead = 2;                // odd t's word offset
    float u[kPix + 4];
    const float* gt = gp + t * kGStride;
#pragma unroll
    for (int i = 0; i < kPix / 4 + 1; ++i) {
      if (i == kPix / 4 && t % 2 == 0) break;
      const float4 v = *reinterpret_cast<const float4*>(gt + 4 * i);
      u[4 * i] = v.x;
      u[4 * i + 1] = v.y;
      u[4 * i + 2] = v.z;
      u[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        acc[j][k] = fmaf(u[(t % 2 ? kLead : 0) + k], w[j][first + k],
                         acc[j][k]);
    }
  }
}

template <bool kSlab, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
correlation_bwd_f2_tile_kernel(const float* __restrict__ g,
                               const float* __restrict__ f1,
                               float* __restrict__ d_f2, int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                        // [kRing][kChunk][kStride]
  float* gs = smem + kRing * kRowFloats;   // [2][kRows][kD][kGStride]
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of d_f2

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = tid >> 5;                           // output row (warp)
  const int q = (lane & 1) | ((lane >> 2) & 2);     // pixel group
  const int cg = ((lane >> 1) & 3) | ((lane >> 2) & 4);   // channel group
  const int tiles = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunk;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int y2 = ybase + 2 * r;
  const bool owns = y2 < H2;
  // staged f1 row rho is row row0 + 2*rho of f1; warp r at row shift n
  // reads rho = r + kD - 1 - n
  const int row0 = ybase - (kSlab ? 2 * kMaxd : kMaxd);

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  const float* f1b = f1 + (static_cast<int64_t>(b) * C + c0) * plane;
  const float* gb = g + static_cast<int64_t>(b) * kD * kD * plane;

  // Staging, kPiece floats a copy, as in the d_f1 body.  f1: thread tid
  // copies channel tid / kPerCh of the chunk, the pieces tid % kPerCh,
  // + kPerCh, ... of its span.  The cotangent: thread tid copies one piece
  // of the first 64 columns of a row (kReps of them where the rows hold more
  // pieces than the block has threads) for the column shifts s_ti,
  // s_ti + kTiStep, ...; the last 4 columns of every row are shared out
  // over the threads apart.  Column shift ti's row starts at column
  // x0 + lead(ti), lead(ti) = 20 - 2ti rounded down to a multiple of 4.
  constexpr int kPiece = kVec ? 4 : 1;
  constexpr int kSpanPieces = kSpan / kPiece;
  constexpr int kTilePieces = kTileW / kPiece;
  constexpr int kTailPieces = (kGStride - kTileW) / kPiece;
  constexpr int kPerCh = kThreads / kChunk;
  constexpr int kRowCol = kRows * kTilePieces;   // one column shift's pieces
  constexpr int kTiStep = kThreads >= kRowCol ? kThreads / kRowCol : 1;
  constexpr int kReps = kThreads >= kRowCol ? 1 : kRowCol / kThreads;
  constexpr int kTails = kRows * kD * kTailPieces;
  static_assert(kThreads % kChunk == 0 &&
                (kThreads % kRowCol == 0 || kRowCol % kThreads == 0),
                "every thread copies the same number of pieces");
  const int sc = tid / kPerCh;
  const bool sc_ok = c0 + sc < C;
  const float* f1_src = f1b + sc * plane + (x0 - kMaxd);
  float* f1_dst = fs + sc * kStride;
  const int s_ti = kThreads >= kRowCol ? tid / kRowCol : 0;
  auto lead = [](int ti) { return kMaxd - 4 * ((ti + 1) >> 1); };
  auto stage_f1 = [&](int rho) {
    const int row = row0 + 2 * rho;
    if (row < 0 || row >= H) return;       // no warp reads it
    float* dst = f1_dst + (rho % kRing) * kRowFloats;
    const float* src = f1_src + static_cast<int64_t>(row) * W;
#pragma unroll
    for (int k = 0; k < (kSpanPieces + kPerCh - 1) / kPerCh; ++k) {
      const int col = (tid % kPerCh + k * kPerCh) * kPiece;   // span column
      if (col >= kSpan) break;
      const int x = x0 - kMaxd + col;
      const bool ok = sc_ok && x >= 0 && x < W;
      cp_async<4 * kPiece>(dst + col, ok ? src + col : f1, ok);
    }
  };
  // one piece: cotangent row (rr, ti) of row shift n, staged column col
  auto stage_g_piece = [&](float* dst0, int n, int rr, int ti, int col) {
    const int y = row0 + 2 * (rr + kD - 1 - n);   // source row
    // not staged: a row whose warp skips this shift
    if (ybase + 2 * rr >= H2 || y < 0 || y >= H) return;
    const int x = x0 + lead(ti) + col;
    const bool ok = x >= 0 && x < W;   // else zeros: they meet f1's padding
    cp_async<4 * kPiece>(
        dst0 + (rr * kD + ti) * kGStride + col,
        ok ? gb + static_cast<int64_t>(n * kD + ti) * plane +
                 static_cast<int64_t>(y) * W + x
           : g,
        ok);
  };
  auto stage_g = [&](int n) {
    float* dst0 = gs + (n & 1) * kGFloatsF2;
#pragma unroll
    for (int m = 0; m < kReps; ++m) {
      const int rc = tid % kRowCol + m * kThreads;
      const int rr = rc / kTilePieces;
      const int col = rc % kTilePieces * kPiece;
#pragma unroll
      for (int k = 0; k < (kD + kTiStep - 1) / kTiStep; ++k) {
        if (s_ti + k * kTiStep >= kD) break;
        stage_g_piece(dst0, n, rr, s_ti + k * kTiStep, col);
      }
    }
#pragma unroll
    for (int e0 = 0; e0 < kTails; e0 += kThreads) {
      const int e = e0 + tid;
      if (e >= kTails) break;
      stage_g_piece(dst0, n, e / (kD * kTailPieces), e / kTailPieces % kD,
                    kTileW + e % kTailPieces * kPiece);
    }
  };

  float acc[kQ][kPix];
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) acc[j][k] = 0.f;
  }

  for (int rho = kD - 1; rho < kD - 1 + kRows; ++rho) stage_f1(rho);
  stage_g(0);
  cp_async_commit();
  const float* g_at = gs + r * kD * kGStride + kPix * q;
  const float* f_at = fs + cg * kStride + kPix * q;
  for (int n = 0; n < kD; ++n) {
    cp_async_wait<0>();
    __syncthreads();     // shift n has landed; shift n - 1 is summed
    if (n + 1 < kD) {
      stage_f1(kD - 2 - n);
      stage_g(n + 1);
    }
    cp_async_commit();
    const int rho = r + kD - 1 - n;
    const int y = row0 + 2 * rho;
    if (owns && y >= 0 && y < H)
      shift_sums_f2(acc, g_at + (n & 1) * kGFloatsF2,
                    f_at + rho % kRing * kRowFloats);
  }

  if (owns) {
    const float cf = static_cast<float>(C);
    const int x = x0 + kPix * q;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int c = c0 + cg + j * kCg;
      if (c >= C) continue;
      float* o = d_f2 + (static_cast<int64_t>(b) * C + c) * plane2 +
                 static_cast<int64_t>(y2) * W + x;
      if (kVec) {
#pragma unroll
        for (int k = 0; k < kPix; k += 4) {
          if (x + k < W)
            *reinterpret_cast<float4*>(o + k) =
                make_float4(acc[j][k] / cf, acc[j][k + 1] / cf,
                            acc[j][k + 2] / cf, acc[j][k + 3] / cf);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (x + k < W) o[k] = acc[j][k] / cf;
        }
      }
    }
  }
}

template <bool kSlab, bool kVec>
int launch_f2_as(const float* g, const float* f1, float* d_f2, int B, int C,
                 int H, int W, cudaStream_t stream) {
  const int err = static_cast<int>(cudaFuncSetAttribute(
      correlation_bwd_f2_tile_kernel<kSlab, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemF2)));
  if (err) return err;
  // row blocks with a first row inside the output: two (one per parity) for
  // every 2*kRows of its H2 rows
  const int H2 = kSlab ? H + 2 * kMaxd : H;
  const int rest = H2 % (2 * kRows);
  const int ny = H2 / (2 * kRows) * 2 + (rest < 2 ? rest : 2);
  const dim3 grid((W + kTileW - 1) / kTileW * ((C + kChunk - 1) / kChunk), ny,
                  B);
  correlation_bwd_f2_tile_kernel<kSlab, kVec>
      <<<grid, kThreads, kSmemF2, stream>>>(g, f1, d_f2, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSlab>
int launch_f2(const float* g, const float* f1, float* d_f2, int B, int C,
              int H, int W, cudaStream_t stream) {
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(g) |
                    reinterpret_cast<uintptr_t>(f1) |
                    reinterpret_cast<uintptr_t>(d_f2)) % 16 == 0;
  return vec ? launch_f2_as<kSlab, true>(g, f1, d_f2, B, C, H, W, stream)
             : launch_f2_as<kSlab, false>(g, f1, d_f2, B, C, H, W, stream);
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// The tensor-core d_f2 body for bfloat16 g and f1 at maxd 20, s2 2 (K6 bf16
// and K7 bf16 d_slab): the TPU kernel's band product on mma.sync.
//
// Replaces _bwd_f2_kernel (correlation_pallas.py:478, launched at :578; wide
// form :225, :365), which builds, per output row and row shift, the band
// matrix B_t[x, x2] of the bf16 cotangent and multiplies it with the bf16
// f1 row on the matrix unit, summing in f32.  At the training shape, g
// (8, 441, 48, 56) and f1, d_f2 (8, 256, 48, 56) in bf16 move ~41 MB,
// 0.0122 ms at 3.35 TB/s; the 4.855 GFLOP of in-map multiply-adds take
// ~0.005 ms at the bf16 tensor-core rate: the bytes bound it.
//
// For 16 output columns x2 = x0 + m of one output row at row shift tj,
// with source row y, the window of 64 source columns [x0 - 24, x0 + 40)
// holds every term:
//
//   d_f2[c][x2] += sum_k Band[k][m] * f1[c][y][x0 - 24 + k],
//   Band[k][m] = g[tj*21 + ti][y][x0 - 24 + k] at k = m + 44 - 2 ti
//
// and zero elsewhere, 21 nonzeros in each column of 64.  That is an
// m16n8k16 product with the channels as M (f1 as A, channel rows as they
// lie: ldmatrix without .trans), the output columns as N (the band as B)
// and the window's columns as K, four k-steps of 16: 3x the band's
// multiply-adds on the tensor cores, bf16 operands as they lie, f32
// accumulators.  The window starts 24 columns left of the tile, not 20,
// so that every 8-column piece is 16-byte aligned (as in correlation_fwd.cu).
// The channels are M, not the columns, so that a lane's accumulators hold
// neighbouring output columns of one channel: the epilogue stores bf16
// pairs straight from registers, x fastest, with no tile in shared memory
// and no barrier; and one band fragment serves the block's 64 channels.
//
// The band is built in registers: of the two values of a B register (rows
// k, k + 1 of column m) only the one whose k has m's parity can be nonzero,
// so a lane loads the 4-byte pair that holds it from the staged cotangent
// rows and masks the other half off (and the whole register where its ti
// lies outside [0, 21)).  The pair's plane is ti0 + 4 (j - 2s - b) for
// n-tile j, k-step s and register b, and its staged column does not
// depend on j, s or b beyond the output column (planes 4 apart are staged
// from columns 8 apart), so every register is one load at a fixed offset
// from the lane's base and one AND with one of 9 masks worked out once.
// Writing the 21 diagonals into a zeroed band tile and reading it with
// ldmatrix would cost a store per value and a barrier per shift.
//
// A block is (batch, 64-column tile, 64 channels, kRows = 4 output rows of
// one parity); warp (row, half) owns 32 columns of one row for all 64
// channels, 64 accumulators a thread, and walks its window's 5 k-steps
// (k-steps wholly outside the map and n-tiles wholly past it are skipped,
// in both forms alike).  Output row y2 at shift tj reads source row
// y2 + 20 - 2 tj (y2 - 2 tj in the slab form), so the block keeps a ring of
// kRows + 1 staged f1 rows, filled in descending row order while the shifts
// run tj ascending, as the f32 tiled body does: each f1 row is staged
// (20 + 4) / 4 = 6 times, not 21.  Each shift stages one new f1 row (64
// channel rows of 112 columns) and the 4 x 21 cotangent rows of 72
// columns, from the 8-aligned column at or below the first one a plane
// needs, into the other of two stages while the current shift is summed.
// Rows lie in shared memory as in device memory, copied by 16-byte
// cp.async where W % 8 == 0 and the tensors are 16-byte aligned, else 4
// bytes (even W) or 2; a thread owns one staging slot of each kind whose
// addresses are worked out once.  Columns outside [0, W) and channels past
// C are staged as zeros; a row no warp reads is not staged.  Pitches of 240
// and 160 bytes put ldmatrix's rows and the band loads on distinct banks.
// 102.7 KB of shared memory, two blocks of 256 threads an SM.
//
// Every output sums its shifts in ascending order, each over the same
// k-steps and fragment positions in the whole-map and the slab form (both
// tile the columns and the channels from 0), so a band's d_slab rows carry
// the bits of the whole-map call.  The products of bf16 values are exact in
// f32; the order of the sums and the tensor cores' adds differ from the
// general body's fmaf chain, which puts ~2 values in 10^4 one ulp apart.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, the parent's general
// body in the same call): 0.0775 ms for K6 at (8, 256, 48, 56) against
// 0.8639 (11.1x), 0.0589 for K7 d_slab at one band of two, g (8, 441, 24,
// 56) against its (8, 256, 64, 56) slab, against 0.6026; 16% and 15% of the
// bytes' bound (0.0122, 0.0089 ms).  123 and 127 registers and no spills
// for the 16-byte forms (8-52 bytes spilled by the 4- and 2-byte forms).
// Tried and dropped, in one call: 32 channels a block, 0.0804 / 0.0712 ms
// at three blocks an SM and 0.0846 / 0.0704 at two, and 2 rows a block
// (128 threads, three blocks an SM), 0.0733 / 0.0614, against 0.0781 /
// 0.0592 for this shape.
// ---------------------------------------------------------------------------

namespace band {

constexpr int kMaxd = 20;                  // the body's configuration
constexpr int kS2 = 2;
constexpr int kD = 2 * (kMaxd / kS2) + 1;  // 21
constexpr int kTileW = 64;                 // output columns a block
constexpr int kRows = 4;                   // output rows (one parity) a block
constexpr int kChunk = 64;                 // channels a block
constexpr int kHalves = kTileW / 32;       // 32-column halves, a warp each
constexpr int kThreads = 32 * kRows * kHalves;   // 256: warp = (row, half)
constexpr int kMTiles = kChunk / 16;       // 16-channel m-tiles a warp
constexpr int kNTiles = 4;                 // 8-column n-tiles a warp
constexpr int kKSteps = 5;                 // 16-column k-steps a warp
constexpr int kMinBlocks = 2;              // resident blocks asked for
constexpr int kLead = 24;                  // window start, left of the tile
constexpr int kSpan = kTileW + 2 * kLead;  // f1 columns staged: 112
constexpr int kF1Pitch = kSpan + 8;        // bf16 a staged f1 channel row
constexpr int kGCols = 72;                 // cotangent columns staged a plane
constexpr int kGPitch = kGCols + 8;        // bf16 a staged cotangent row
constexpr int kRing = kRows + 1;           // staged f1 rows
constexpr int kF1Elems = kChunk * kF1Pitch;     // one staged f1 row
constexpr int kGElems = kRows * kD * kGPitch;   // one shift's cotangent rows
constexpr int kGBase = kRing * kF1Elems;        // the cotangent stages
// The band loads of a lane run over planes ti0 - 28 .. ti0 + 4 with
// ti0 in [19, 25]; those outside [0, 21) are masked to zero, but read: the
// last stage's last row reaches 9 rows past the end.
constexpr int kGPad = 9 * kGPitch;
constexpr size_t kSmem =
    sizeof(__nv_bfloat16) * (kGBase + 2 * kGElems + kGPad);
// Staging slots: a thread copies one 8-column piece of the cotangent rows
// of one output row for 3 consecutive planes, and one 8-column piece of
// kF1CPer consecutive f1 channel rows.
constexpr int kGPlanes = 3;
constexpr int kGSlots = kRows * (kD / kGPlanes) * (kGCols / 8);   // 252
constexpr int kF1CPer = kChunk / 16;
constexpr int kF1Slots = (kChunk / kF1CPer) * (kSpan / 8);       // 224
constexpr int kBandOff = (kLead + kMaxd) / kS2;   // 22
static_assert(kD % kGPlanes == 0 && kGSlots <= kThreads &&
              kF1Slots <= kThreads, "one slot of each kind a thread");
static_assert(kSmem <= 113 * 1024, "two blocks an SM");
static_assert((kF1Pitch * 2) % 16 == 0 && (kF1Pitch / 2) % 32 == 28 &&
              kLead % 8 == 0 && kGCols % 8 == 0,
              "16-byte ldmatrix rows on distinct banks");

// The first column, relative to the tile's, of the staged row of plane ti:
// the 8-aligned column at or below x2 + maxd - 2 ti for x2 = 0 (floor, for
// negative values too).  Planes 4 apart start 8 columns apart.
__device__ __forceinline__ int g_lead(int ti) {
  return (kMaxd - kS2 * ti) & ~7;
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies the 8 values at src[off .. off + 8), global columns x .. x + 7,
// into dst, kPiece a copy; a copy whose columns lie outside [0, W), or all
// of them where ``ok`` is false, writes zeros.
template <int kPiece>
__device__ __forceinline__ void copy8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int64_t off,
                                      int x, int W, bool ok) {
#pragma unroll
  for (int e = 0; e < 8; e += kPiece) {
    const bool in = ok && x + e >= 0 && x + e < W;
    stage_piece<kPiece>(dst + e, in ? src + off + e : src, in);
  }
}

// Whether k-step s of a warp's window meets n-tile j of its 32 columns:
// n-tile j reads window columns 8j + 4 .. 8j + 51.
__host__ __device__ constexpr bool meets(int j, int s) {
  return s >= j / 2 && s <= j / 2 + 3;
}

template <bool kSlab, int kPiece>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
correlation_bwd_f2_mma_kernel(const __nv_bfloat16* __restrict__ g,
                              const __nv_bfloat16* __restrict__ f1,
                              __nv_bfloat16* __restrict__ d_f2, int C, int H,
                              int W) {
  extern __shared__ __align__(16) __nv_bfloat16 smem16[];
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of d_f2
  const int shift = kSlab ? kMaxd : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int half = (tid >> 5) % kHalves;     // 32-column half of the warp
  const int r = (tid >> 5) / kHalves;        // output row of the warp
  const int tiles = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunk;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int y2 = ybase + 2 * r;
  const bool owns = y2 < H2;
  // output row y2 at row shift n reads source row y2 - shift + maxd - 2n;
  // staged f1 row rho is row row0 + 2 rho, so warp r reads
  // rho = r + kD - 1 - n
  const int row0 = ybase - shift - kMaxd;

  const int64_t plane = static_cast<int64_t>(H) * W;

  // Staging slots, their addresses worked out once.  The cotangent: slot
  // u < kGSlots copies piece gp of the rows of planes gti .. gti + 2 of
  // output row gr, from global column x0 + g_lead(ti) + 8 gp.
  const bool g_slot = tid < kGSlots;
  const int gp = tid % (kGCols / 8);
  const int gti = tid / (kGCols / 8) % (kD / kGPlanes) * kGPlanes;
  const int gr = tid / (kGCols / 8) / (kD / kGPlanes);
  const bool g_live = g_slot && ybase + 2 * gr < H2;
  const int gy0 = ybase + 2 * gr - shift + kMaxd;   // its source row, n = 0
  const int gx = x0 + 8 * gp;
  const int g_dst = (gr * kD + gti) * kGPitch + 8 * gp;
  const int64_t g_base = static_cast<int64_t>(b) * kD * kD * plane + gx;
  // f1: slot u < kF1Slots copies piece fp of channels fc .. fc + kF1CPer - 1
  // of the chunk, from global column x0 - kLead + 8 fp.
  const bool f_slot = tid < kF1Slots;
  const int fp = tid % (kSpan / 8);
  const int fc = tid / (kSpan / 8) * kF1CPer;
  const int fx = x0 - kLead + 8 * fp;
  const int f_left = C - c0 - fc;            // channels of the slot in C
  const int f_dst = fc * kF1Pitch + 8 * fp;
  const int64_t f_base = (static_cast<int64_t>(b) * C + c0 + fc) * plane + fx;

  auto stage_g = [&](int n) {
    const int y = gy0 - 2 * n;
    if (!g_live || y < 0 || y >= H) return;   // no warp reads it
    __nv_bfloat16* dst = smem16 + kGBase + (n & 1) * kGElems + g_dst;
    const int64_t off =
        g_base + (static_cast<int64_t>(n * kD + gti) * H + y) * W;
#pragma unroll
    for (int t = 0; t < kGPlanes; ++t) {
      const int lead = g_lead(gti + t);
      copy8<kPiece>(dst + t * kGPitch, g, off + t * plane + lead, gx + lead,
                    W, true);
    }
  };
  auto stage_f1 = [&](int rho) {
    const int row = row0 + 2 * rho;
    if (!f_slot || row < 0 || row >= H) return;   // no warp reads it
    __nv_bfloat16* dst = smem16 + rho % kRing * kF1Elems + f_dst;
    const int64_t off = f_base + static_cast<int64_t>(row) * W;
#pragma unroll
    for (int c = 0; c < kF1CPer; ++c)
      copy8<kPiece>(dst + c * kF1Pitch, f1, off + c * plane, fx, W,
                    c < f_left);
  };

  // The lane's fragments.  B, the band: lane (gq, qq) holds column
  // n = 8j + gq of n-tile j and rows k = 16s + 8b + 2qq + {0, 1} of
  // k-step s in register b.  Band[k][n] is g of plane
  // ti = (n + kLead + maxd - k) / 2 at window column k where that is an
  // integer in [0, kD), else zero: one of the two values of a register can
  // be nonzero, the one whose k has n's parity, and it is read as the
  // 4-byte pair that holds it, the other half masked off.  The plane is
  // ti0 + 4 (j - 2s - b), and its staged row's column, k - kLead -
  // g_lead(ti), does not depend on j, s or b beyond n: each register is one
  // load at a fixed offset from the lane's base.
  const int gq = lane >> 2;
  const int qq = lane & 3;
  const uint32_t keep = (gq & 1) ? 0xffff0000u : 0x0000ffffu;
  const int ti0 = kBandOff - qq + (gq >> 1);
  uint32_t mk[9];                  // keep, or 0 where ti0 + 4m is no plane
#pragma unroll
  for (int m = -7; m <= 1; ++m)
    mk[m + 7] = static_cast<unsigned>(ti0 + 4 * m) < kD ? keep : 0u;
  const int band_lane =
      r * kD * kGPitch + ti0 * kGPitch + 2 * qq - kLead - g_lead(ti0) +
      32 * half;
  // A, f1: matrices (channels 0-7, 8-15) x (columns 0-7, 8-15) of a
  // 16 x 16 tile in the fragment's order, channel rows as they lie.
  const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kF1Pitch +
                     ((lane >> 4) & 1) * 8 + 32 * half;
  // k-steps whose window columns all lie outside the map and n-tiles
  // whose columns all lie past it add nothing and are skipped; both forms
  // skip the same ones
  unsigned ksteps = 0, ntiles = 0;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int xs = x0 - kLead + 16 * (2 * half + s);
    if (xs + 16 > 0 && xs < W) ksteps |= 1u << s;
  }
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    if (x0 + 32 * half + 8 * j < W) ntiles |= 1u << j;

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int rho = kD - 1; rho < kD - 1 + kRows; ++rho) stage_f1(rho);
  stage_g(0);
  cp_async_commit();
  for (int n = 0; n < kD; ++n) {
    cp_async_wait<0>();
    __syncthreads();     // shift n has landed; shift n - 1 is summed
    if (n + 1 < kD) {
      stage_f1(kD - 2 - n);
      stage_g(n + 1);
    }
    cp_async_commit();
    const int y = y2 - shift + kMaxd - 2 * n;   // the warp's source row
    if (!owns || y < 0 || y >= H) continue;
    const __nv_bfloat16* bp =
        smem16 + kGBase + (n & 1) * kGElems + band_lane;
    const __nv_bfloat16* ap =
        smem16 + (r + kD - 1 - n) % kRing * kF1Elems + a_lane;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      if (!(ksteps >> s & 1)) continue;
      uint32_t bq[kNTiles][2];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        if (!meets(j, s)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bq[j][h] = lds32(bp + j * (4 * kGPitch + 8) - s * 8 * kGPitch -
                           h * 4 * kGPitch) &
                     mk[j - 2 * s - h + 7];
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, ap + mt * 16 * kF1Pitch + 16 * s);
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          if (meets(j, s) && (ntiles >> j & 1))
            mma_bf16(acc[mt][j], a, bq[j][0], bq[j][1]);
      }
    }
  }

  // Divide by C, round once and store, x fastest: accumulator element e of
  // (m-tile mt, n-tile j) is channel 16 mt + gq (+ 8 for e >= 2) and column
  // 8j + 2qq + e % 2 of the warp's 32, so a lane holds neighbouring pairs.
  if (!owns) return;
  const float cf = static_cast<float>(C);
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * mt + gq + 8 * h;
      if (c >= C) continue;
      __nv_bfloat16* o = d_f2 + (static_cast<int64_t>(b) * C + c) * plane2 +
                         static_cast<int64_t>(y2) * W;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int x = x0 + 32 * half + 8 * j + 2 * qq;
        const float lo = acc[mt][j][2 * h] / cf;
        const float hi = acc[mt][j][2 * h + 1] / cf;
        if constexpr (kPiece > 1) {   // W even: the pair is 4-byte aligned
          if (x < W) *reinterpret_cast<uint32_t*>(o + x) = bf16_pair(lo, hi);
        } else {
          if (x < W) fnet_store(o + x, lo);
          if (x + 1 < W) fnet_store(o + x + 1, hi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core d_f1 body for bfloat16 g and f2 at maxd 20, s2 2 (K5 bf16
// and K7 bf16 d_f1): the d_f2 body above, mirrored.
//
// Replaces _bwd_f1_kernel (correlation_pallas.py:449, launched at :557; wide
// form :201, :340), which builds, per output row and row shift, the band
// matrix G_t[x, v] = g[y, x, t*D + (v - x)/s2] of the bf16 cotangent and
// multiplies it with the bf16 f2 row on the matrix unit, summing in f32.
// At the training shape, g (8, 441, 48, 56) and f2, d_f1 (8, 256, 48, 56)
// in bf16 move ~41 MB, 0.0122 ms at 3.35 TB/s; the 4.855 GFLOP of in-map
// multiply-adds take ~0.005 ms at the bf16 tensor-core rate: the bytes bound
// it.
//
// For 16 output columns x = x0 + m of one output row y at row shift tj,
// with f2 row y2 = y + shift + 2 (tj - 10), the window of 64 f2 columns
// [x0 - 24, x0 + 40) holds every term:
//
//   d_f1[c][x] += sum_k f2[c][y2][x0 - 24 + k] * Band[k][m],
//   Band[k][m] = g[tj*21 + ti][y][x0 + m] at k = m + 4 + 2 ti
//
// and zero elsewhere.  The roles are the d_f2 body's: the channels are M (f2
// as A, channel rows as they lie: ldmatrix without .trans), the output
// columns N (the band as B, built in registers), the window's columns K;
// n-tile j of a warp's 32 columns reads window columns 8j + 4 .. 8j + 51,
// so ``meets`` and the skipped k-steps and n-tiles are the d_f2 body's.
// What differs is where the band is read: at the output column, not the
// source column.  So each plane's staged cotangent row is the tile's own 64
// columns, with no per-plane lead, and in register h of n-tile j at k-step
// s, lane (gq, qq) holds Band[k][n] for k = 16s + 8h + 2qq + {0, 1},
// n = 8j + gq, of which only the half gq & 1 can be nonzero, of plane
// ti = ti0 + 4 (2s + h - j), ti0 = qq - (gq >> 1) - 2: the half gq & 1 of
// the 4-byte pair at column 32 half + 8j + 2 (gq >> 1) of that plane's row.
// Every register is one load at a fixed offset from the lane's base and one
// AND with one of 9 masks (2s + h - j runs over [-1, 7] where ``meets``
// holds); the planes read run from ti0 - 4 to ti0 + 28, so the loads reach
// 9 rows before the first stage (the f2 ring there) and 9 rows past the
// last (kF1GPad), masked to zero.  A cotangent pitch of 72 bf16 puts the 16
// words of every band load on 16 banks; 64 would put them on 4.
//
// A block is (batch, 64-column tile, 64 channels, kRows = 4 output rows of
// one parity); warp (row, half) owns 32 columns of one row for all 64
// channels.  Output row y at shift tj reads f2 row y + shift - 20 + 2 tj:
// the block keeps a ring of kRows + 1 staged f2 rows filled in ascending
// row order, warp r reading ring row r + n at shift n, and while shift n is
// summed stages row n + kRows into the slot that shift n - 1 freed (the
// f32 tiled body's ring): each f2 row is staged (20 + 4) / 4 = 6 times, not
// 21.  The f2 rows are staged as the d_f2 body stages f1 (112 columns,
// pitch 120, 4 channels a slot); each shift's 4 x 21 cotangent rows of 64
// columns go into the other of two stages, a slot copying one 8-column
// piece of 3 planes of one row (224 slots).  A row no warp reads is not
// staged; columns outside [0, W) and channels past C are staged as zeros.
// 99.9 KB of shared memory, two blocks of 256 threads an SM.
//
// Every output sums its shifts in ascending order, each over the same
// k-steps and fragment positions in the whole-map and the slab form (both
// tile the columns and the channels from 0).  Where the whole map skips a
// shift whose f2 row lies outside the map, the slab form reads a zero halo
// row of the slab: its mma products are zeros, which leave the sums as they
// are.  So every band's d_f1 rows carry the bits of the whole-map call.
// The products of bf16 values are exact in f32; the order of the sums and
// the tensor cores' adds differ from the general body's fmaf chain, which
// puts ~2 values in 10^4 one ulp apart.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, the parent's general
// body in the same call): 0.0809 and 0.0804 ms for K5 at (8, 256, 48, 56)
// against 0.6503 and 0.6570 (8.1x; the f32 tiled body 0.186), 0.0464 and
// 0.0463 for K7 d_f1 at one band of two, g (8, 441, 24, 56) against its
// (8, 256, 64, 56) slab, against 0.4644 and 0.4631 (10.0x); 15% and 19% of
// the bytes' bound (0.0122, 0.0089 ms).  ptxas: 115 registers and no spill
// in the 16-byte forms, 128 registers in the 4- and 2-byte forms (4 bytes
// spilled by the whole-map 2-byte form).
// ---------------------------------------------------------------------------

constexpr int kF1GCols = kTileW;           // cotangent columns staged a plane
constexpr int kF1GPitch = kF1GCols + 8;    // bf16 a staged cotangent row
constexpr int kF1GElems = kRows * kD * kF1GPitch;   // one shift's rows
constexpr int kF1GPad = 9 * kF1GPitch;     // read past the last stage
constexpr size_t kSmemF1 =
    sizeof(__nv_bfloat16) * (kGBase + 2 * kF1GElems + kF1GPad);
constexpr int kF1GSlots = kRows * (kD / kGPlanes) * (kF1GCols / 8);   // 224
constexpr int kF1BandOff = (kLead - kMaxd) / kS2;   // 2
static_assert(kF1GSlots <= kThreads && kSmemF1 <= 113 * 1024,
              "one slot a thread, two blocks an SM");
static_assert(kGBase >= 9 * kF1GPitch, "the ring lies below the first stage");
static_assert((kF1GPitch * 2) % 16 == 0 && (kF1GPitch / 2) % 32 == 4,
              "16-byte rows; band loads on distinct banks");

template <bool kSlab, int kPiece>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
correlation_bwd_f1_mma_kernel(const __nv_bfloat16* __restrict__ g,
                              const __nv_bfloat16* __restrict__ f2,
                              __nv_bfloat16* __restrict__ d_f1, int C, int H,
                              int W) {
  extern __shared__ __align__(16) __nv_bfloat16 smem16[];
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of f2
  const int shift = kSlab ? kMaxd : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int half = (tid >> 5) % kHalves;     // 32-column half of the warp
  const int r = (tid >> 5) / kHalves;        // output row of the warp
  const int tiles = (W + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunk;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int y = ybase + 2 * r;
  const bool owns = y < H;
  // output row y at row shift n reads f2 row y + shift - maxd + 2n; staged
  // f2 row rho is row row0 + 2 rho, so warp r reads rho = r + n
  const int row0 = ybase + shift - kMaxd;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;

  // Staging slots, their addresses worked out once.  The cotangent: slot
  // u < kF1GSlots copies piece gp of the rows of planes gti .. gti + 2 of
  // output row gr, from global column x0 + 8 gp.
  const bool g_slot = tid < kF1GSlots;
  const int gp = tid % (kF1GCols / 8);
  const int gti = tid / (kF1GCols / 8) % (kD / kGPlanes) * kGPlanes;
  const int gr = tid / (kF1GCols / 8) / (kD / kGPlanes);
  const int gy = ybase + 2 * gr;                  // its row
  const bool g_live = g_slot && gy < H;
  const int gy2 = gy + shift - kMaxd;             // its warp's f2 row, n = 0
  const int gx = x0 + 8 * gp;
  const int g_dst = (gr * kD + gti) * kF1GPitch + 8 * gp;
  const int64_t g_base = (static_cast<int64_t>(b) * kD * kD + gti) * plane +
                         static_cast<int64_t>(gy) * W + gx;
  // f2: slot u < kF1Slots copies piece fp of channels fc .. fc + kF1CPer - 1
  // of the chunk, from global column x0 - kLead + 8 fp.
  const bool f_slot = tid < kF1Slots;
  const int fp = tid % (kSpan / 8);
  const int fc = tid / (kSpan / 8) * kF1CPer;
  const int fx = x0 - kLead + 8 * fp;
  const int f_left = C - c0 - fc;            // channels of the slot in C
  const int f_dst = fc * kF1Pitch + 8 * fp;
  const int64_t f_base =
      (static_cast<int64_t>(b) * C + c0 + fc) * plane2 + fx;

  auto stage_g = [&](int n) {
    const int y2 = gy2 + 2 * n;
    if (!g_live || y2 < 0 || y2 >= H2) return;   // no warp reads it
    __nv_bfloat16* dst = smem16 + kGBase + (n & 1) * kF1GElems + g_dst;
    const int64_t off = g_base + static_cast<int64_t>(n * kD) * plane;
#pragma unroll
    for (int t = 0; t < kGPlanes; ++t)
      copy8<kPiece>(dst + t * kF1GPitch, g, off + t * plane, gx, W, true);
  };
  auto stage_f2 = [&](int rho) {
    const int row = row0 + 2 * rho;
    if (!f_slot || row < 0 || row >= H2) return;   // no warp reads it
    __nv_bfloat16* dst = smem16 + rho % kRing * kF1Elems + f_dst;
    const int64_t off = f_base + static_cast<int64_t>(row) * W;
#pragma unroll
    for (int c = 0; c < kF1CPer; ++c)
      copy8<kPiece>(dst + c * kF1Pitch, f2, off + c * plane2, fx, W,
                    c < f_left);
  };

  // The lane's fragments.  B, the band: register h of n-tile j at k-step s
  // is the pair at bp + j (8 - 4 pitch) + s 8 pitch + h 4 pitch (plane
  // ti0 + 4 (2s + h - j), column 32 half + 8j + 2 (gq >> 1)), masked to the
  // half gq & 1 where that plane lies in [0, kD).  A, f2: as in the d_f2
  // body.
  const int gq = lane >> 2;
  const int qq = lane & 3;
  const uint32_t keep = (gq & 1) ? 0xffff0000u : 0x0000ffffu;
  const int ti0 = qq - (gq >> 1) - kF1BandOff;
  uint32_t mk[9];                  // keep, or 0 where ti0 + 4m is no plane
#pragma unroll
  for (int m = -1; m <= 7; ++m)
    mk[m + 1] = static_cast<unsigned>(ti0 + 4 * m) < kD ? keep : 0u;
  const int band_lane = (r * kD + ti0) * kF1GPitch + 2 * (gq >> 1) +
                        32 * half;
  const int a_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * kF1Pitch +
                     ((lane >> 4) & 1) * 8 + 32 * half;
  // k-steps whose window columns all lie outside the map and n-tiles
  // whose columns all lie past it add nothing and are skipped; both forms
  // skip the same ones
  unsigned ksteps = 0, ntiles = 0;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    const int xs = x0 - kLead + 16 * (2 * half + s);
    if (xs + 16 > 0 && xs < W) ksteps |= 1u << s;
  }
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    if (x0 + 32 * half + 8 * j < W) ntiles |= 1u << j;

  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int rho = 0; rho < kRows; ++rho) stage_f2(rho);
  stage_g(0);
  cp_async_commit();
  for (int n = 0; n < kD; ++n) {
    cp_async_wait<0>();
    __syncthreads();     // shift n has landed; shift n - 1 is summed
    if (n + 1 < kD) {
      stage_f2(n + kRows);
      stage_g(n + 1);
    }
    cp_async_commit();
    const int y2 = y + shift - kMaxd + 2 * n;   // the warp's f2 row
    if (!owns || y2 < 0 || y2 >= H2) continue;
    const __nv_bfloat16* bp =
        smem16 + kGBase + (n & 1) * kF1GElems + band_lane;
    const __nv_bfloat16* ap = smem16 + (r + n) % kRing * kF1Elems + a_lane;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      if (!(ksteps >> s & 1)) continue;
      uint32_t bq[kNTiles][2];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        if (!meets(j, s)) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bq[j][h] = lds32(bp + j * (8 - 4 * kF1GPitch) +
                           s * 8 * kF1GPitch + h * 4 * kF1GPitch) &
                     mk[2 * s + h - j + 1];
      }
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t a[4];
        ldsm_x4(a, ap + mt * 16 * kF1Pitch + 16 * s);
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
          if (meets(j, s) && (ntiles >> j & 1))
            mma_bf16(acc[mt][j], a, bq[j][0], bq[j][1]);
      }
    }
  }

  // Divide by C, round once and store, x fastest, as the d_f2 body does.
  if (!owns) return;
  const float cf = static_cast<float>(C);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 16 * mt + gq + 8 * h;
      if (c >= C) continue;
      __nv_bfloat16* o = d_f1 + (static_cast<int64_t>(b) * C + c) * plane +
                         static_cast<int64_t>(y) * W;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const int x = x0 + 32 * half + 8 * j + 2 * qq;
        const float lo = acc[mt][j][2 * h] / cf;
        const float hi = acc[mt][j][2 * h + 1] / cf;
        if constexpr (kPiece > 1) {   // W even: the pair is 4-byte aligned
          if (x < W) *reinterpret_cast<uint32_t*>(o + x) = bf16_pair(lo, hi);
        } else {
          if (x < W) fnet_store(o + x, lo);
          if (x + 1 < W) fnet_store(o + x + 1, hi);
        }
      }
    }
  }
}

// Either body: kF1 picks the d_f1 body, whose grid covers the H output
// rows, or the d_f2 body, whose grid covers the H2 rows of d_f2.
template <bool kF1, bool kSlab, int kPiece>
int launch_as(const __nv_bfloat16* g, const __nv_bfloat16* src,
              __nv_bfloat16* out, int B, int C, int H, int W,
              cudaStream_t stream) {
  const auto kernel = kF1 ? correlation_bwd_f1_mma_kernel<kSlab, kPiece>
                          : correlation_bwd_f2_mma_kernel<kSlab, kPiece>;
  const size_t smem = kF1 ? kSmemF1 : kSmem;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (err) return err;
  // row blocks with a first row inside the output: two (one per parity) for
  // every 2*kRows of its rows
  const int rows = kF1 || !kSlab ? H : H + 2 * kMaxd;
  const int rest = rows % (2 * kRows);
  const int ny = rows / (2 * kRows) * 2 + (rest < 2 ? rest : 2);
  const dim3 grid((W + kTileW - 1) / kTileW * ((C + kChunk - 1) / kChunk), ny,
                  B);
  kernel<<<grid, kThreads, smem, stream>>>(g, src, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The copy width, chosen at launch as in correlation_fwd.cu: 16 bytes where
// W % 8 == 0 and every tensor is 16-byte aligned, 4 where W is even and
// they are 4-byte aligned, else 2.
template <bool kF1, bool kSlab>
int launch(const __nv_bfloat16* g, const __nv_bfloat16* src,
           __nv_bfloat16* out, int B, int C, int H, int W,
           cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(out);
  if (W % 8 == 0 && addr % 16 == 0)
    return launch_as<kF1, kSlab, 8>(g, src, out, B, C, H, W, stream);
  if (W % 2 == 0 && addr % 4 == 0)
    return launch_as<kF1, kSlab, 2>(g, src, out, B, C, H, W, stream);
  return launch_as<kF1, kSlab, 1>(g, src, out, B, C, H, W, stream);
}

}  // namespace band

// ---------------------------------------------------------------------------
// The general bodies: d_f1 for every other (maxd, s2), and d_f2.
// ---------------------------------------------------------------------------

constexpr int kTileW = 64;                   // output columns per block
constexpr int kGroups = 4;                   // thread groups over channels
constexpr int kThreads = kTileW * kGroups;   // 256
constexpr int kChunkC = 32;                  // channels per block
constexpr int kPerThread = kChunkC / kGroups;

// K5: d_f1.  Block (tile * chunks, y, b).  For row shift tj the f2 row (of
// H2) is y + shift + (tj - r)*s2; column shift ti reads f2 at span offset
// tx + ti*s2 + (maxd - r*s2), the span starting at column x0 - maxd.
// T is the element type of g, f2 and d_f1: bfloat16 operands are upcast
// exactly while they are staged, the sums are the float ones, and d_f1 is
// rounded once (fnet_load, fnet_store in common.cuh).
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f1_kernel(const T* __restrict__ g, const T* __restrict__ f2,
                          T* __restrict__ d_f1, int C, int H, int W, int maxd,
                          int s2, int D, int tiles) {
  extern __shared__ float smem[];
  const int H2 = kSlab ? H + 2 * maxd : H;   // rows of f2
  const int shift = kSlab ? maxd : 0;
  const int span = kTileW + 2 * maxd;
  float* gs = smem;                        // [D][kTileW]
  float* f2s = smem + D * kTileW;          // [kChunkC][span]

  const int r = (D - 1) / 2;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunkC;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTileW;
  const int grp = threadIdx.x / kTileW;
  const int nc = min(kChunkC, C - c0);
  const int lead = maxd - r * s2;
  const int xs = x0 - maxd;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  const T* g_row = g + static_cast<int64_t>(b) * D * D * plane +
                   static_cast<int64_t>(y) * W;
  const T* f2_b = f2 + (static_cast<int64_t>(b) * C + c0) * plane2;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y2 = y + shift + (tj - r) * s2;
    if (y2 < 0 || y2 >= H2) continue;
    for (int i = threadIdx.x; i < D * kTileW; i += kThreads) {
      const int ti = i / kTileW;
      const int col = x0 + i % kTileW;
      gs[i] = col < W ? fnet_load(g_row +
                                  static_cast<int64_t>(tj * D + ti) * plane +
                                  col)
                      : 0.f;
    }
    const T* f2_row = f2_b + static_cast<int64_t>(y2) * W;
    for (int i = threadIdx.x; i < kChunkC * span; i += kThreads) {
      const int c = i / span;
      const int col = xs + i % span;
      f2s[i] = (c < nc && col >= 0 && col < W)
                   ? fnet_load(f2_row + static_cast<int64_t>(c) * plane2 +
                               col)
                   : 0.f;
    }
    __syncthreads();
    for (int ti = 0; ti < D; ++ti) {
      const float gv = gs[ti * kTileW + tx];
      const float* f2c = f2s + grp * span + tx + lead + ti * s2;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        acc[k] = fmaf(gv, f2c[k * kGroups * span], acc[k]);
      }
    }
    __syncthreads();
  }

  const int x = x0 + tx;
  if (x < W) {
    T* out = d_f1 + (static_cast<int64_t>(b) * C + c0) * plane +
             static_cast<int64_t>(y) * W + x;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = grp + k * kGroups;
      if (c < nc) fnet_store(out + c * plane, acc[k] / static_cast<float>(C));
    }
  }
}

// K6: d_f2.  Block (tile * chunks, y2, b) with y2 over the H2 output rows.
// For row shift tj the source row (of H) is y = y2 - shift - (tj - r)*s2;
// column shift ti reads g and f1 at source column
// x2 - (ti - r)*s2, at span offset tx + (maxd + r*s2) - ti*s2, the span
// starting at column x0 - maxd.  T as in K5's general body.
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f2_kernel(const T* __restrict__ g, const T* __restrict__ f1,
                          T* __restrict__ d_f2, int C, int H, int W, int maxd,
                          int s2, int D, int tiles) {
  extern __shared__ float smem[];
  const int H2 = kSlab ? H + 2 * maxd : H;   // rows of d_f2
  const int shift = kSlab ? maxd : 0;
  const int span = kTileW + 2 * maxd;
  float* gs = smem;                        // [D][span]
  float* f1s = smem + D * span;            // [kChunkC][span]

  const int r = (D - 1) / 2;
  const int x0 = (blockIdx.x % tiles) * kTileW;
  const int c0 = (blockIdx.x / tiles) * kChunkC;
  const int y2 = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTileW;
  const int grp = threadIdx.x / kTileW;
  const int nc = min(kChunkC, C - c0);
  const int back = maxd + r * s2;
  const int xs = x0 - maxd;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* g_b = g + static_cast<int64_t>(b) * D * D * plane;
  const T* f1_b = f1 + (static_cast<int64_t>(b) * C + c0) * plane;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y = y2 - shift - (tj - r) * s2;
    if (y < 0 || y >= H) continue;
    const T* g_row = g_b + static_cast<int64_t>(tj * D) * plane +
                     static_cast<int64_t>(y) * W;
    for (int i = threadIdx.x; i < D * span; i += kThreads) {
      const int ti = i / span;
      const int col = xs + i % span;
      gs[i] = (col >= 0 && col < W)
                  ? fnet_load(g_row + static_cast<int64_t>(ti) * plane + col)
                  : 0.f;
    }
    const T* f1_row = f1_b + static_cast<int64_t>(y) * W;
    for (int i = threadIdx.x; i < kChunkC * span; i += kThreads) {
      const int c = i / span;
      const int col = xs + i % span;
      f1s[i] = (c < nc && col >= 0 && col < W)
                   ? fnet_load(f1_row + static_cast<int64_t>(c) * plane + col)
                   : 0.f;
    }
    __syncthreads();
    for (int ti = 0; ti < D; ++ti) {
      const int at = tx + back - ti * s2;
      const float gv = gs[ti * span + at];
      const float* f1c = f1s + grp * span + at;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        acc[k] = fmaf(gv, f1c[k * kGroups * span], acc[k]);
      }
    }
    __syncthreads();
  }

  const int x2 = x0 + tx;
  if (x2 < W) {
    const int64_t plane2 = static_cast<int64_t>(H2) * W;
    T* out = d_f2 + (static_cast<int64_t>(b) * C + c0) * plane2 +
             static_cast<int64_t>(y2) * W + x2;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = grp + k * kGroups;
      if (c < nc)
        fnet_store(out + c * plane2, acc[k] / static_cast<float>(C));
    }
  }
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, T*, int, int, int, int, int,
                           int, int);

// ``rows`` is the output's row count: H for d_f1, H2 for d_f2.
template <typename T>
int launch(BwdKernel<T> kernel, size_t smem, const T* g, const T* src, T* out,
           int B, int C, int H, int W, int rows, int maxd, int s2, int device,
           void* stream) {
  int err = fnet_set_device(device);
  if (err) return err;
  const int D = 2 * (maxd / s2) + 1;
  const int tiles = (W + kTileW - 1) / kTileW;
  const int chunks = (C + kChunkC - 1) / kChunkC;
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const dim3 grid(tiles * chunks, rows, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, src, out, C, H, W, maxd, s2, D, tiles);
  return static_cast<int>(cudaGetLastError());
}

size_t smem_f1(int maxd, int s2) {
  const int D = 2 * (maxd / s2) + 1;
  return sizeof(float) * (D * kTileW + kChunkC * (kTileW + 2 * maxd));
}

size_t smem_f2(int maxd, int s2) {
  const int D = 2 * (maxd / s2) + 1;
  return sizeof(float) * (D + kChunkC) * (kTileW + 2 * maxd);
}

// d_f1: the tiled body where the configuration is the one it is written
// for, the general body for any other; both are kernels.
template <bool kSlab>
int launch_f1(const float* g, const float* f2, float* d_f1, int B, int C,
              int H, int W, int maxd, int s2, int device, void* stream) {
  if (maxd == tiled::kMaxd && s2 == tiled::kS2) {
    const int err = fnet_set_device(device);
    if (err) return err;
    return tiled::launch<kSlab>(g, f2, d_f1, B, C, H, W,
                                static_cast<cudaStream_t>(stream));
  }
  return launch<float>(correlation_bwd_f1_kernel<float, kSlab>,
                       smem_f1(maxd, s2), g, f2, d_f1, B, C, H, W, H, maxd,
                       s2, device, stream);
}

// d_f2 (and d_slab, whose H2 = H + 2*maxd rows the grid covers): likewise.
template <bool kSlab>
int launch_f2(const float* g, const float* f1, float* d_f2, int B, int C,
              int H, int W, int maxd, int s2, int device, void* stream) {
  if (maxd == tiled::kMaxd && s2 == tiled::kS2) {
    const int err = fnet_set_device(device);
    if (err) return err;
    return tiled::launch_f2<kSlab>(g, f1, d_f2, B, C, H, W,
                                   static_cast<cudaStream_t>(stream));
  }
  return launch<float>(correlation_bwd_f2_kernel<float, kSlab>,
                       smem_f2(maxd, s2), g, f1, d_f2, B, C, H, W,
                       kSlab ? H + 2 * maxd : H, maxd, s2, device, stream);
}

// The bf16 d_f1 (and K7's d_f1): the tensor-core body for maxd 20, s2 2,
// the general body on the upcast operands for any other (maxd, s2).
template <bool kSlab>
int launch_f1_bf16(const __nv_bfloat16* g, const __nv_bfloat16* f2,
                   __nv_bfloat16* d_f1, int B, int C, int H, int W, int maxd,
                   int s2, int device, void* stream) {
  if (maxd == band::kMaxd && s2 == band::kS2) {
    const int err = fnet_set_device(device);
    if (err) return err;
    return band::launch<true, kSlab>(g, f2, d_f1, B, C, H, W,
                                     static_cast<cudaStream_t>(stream));
  }
  return launch<__nv_bfloat16>(
      correlation_bwd_f1_kernel<__nv_bfloat16, kSlab>, smem_f1(maxd, s2), g,
      f2, d_f1, B, C, H, W, H, maxd, s2, device, stream);
}

// The bf16 d_f2 (and d_slab): the tensor-core body for maxd 20, s2 2, the
// general body on the upcast operands for any other (maxd, s2).
template <bool kSlab>
int launch_f2_bf16(const __nv_bfloat16* g, const __nv_bfloat16* f1,
                   __nv_bfloat16* d_f2, int B, int C, int H, int W, int maxd,
                   int s2, int device, void* stream) {
  if (maxd == band::kMaxd && s2 == band::kS2) {
    const int err = fnet_set_device(device);
    if (err) return err;
    return band::launch<false, kSlab>(g, f1, d_f2, B, C, H, W,
                                      static_cast<cudaStream_t>(stream));
  }
  return launch<__nv_bfloat16>(
      correlation_bwd_f2_kernel<__nv_bfloat16, kSlab>, smem_f2(maxd, s2), g,
      f1, d_f2, B, C, H, W, kSlab ? H + 2 * maxd : H, maxd, s2, device,
      stream);
}

}  // namespace

// K5.  g: (B, D*D, H, W); f2, d_f1: (B, C, H, W); all float32 and
// contiguous, with D = 2*(maxd/s2) + 1.
extern "C" int correlation_bwd_f1(const float* g, const float* f2, float* d_f1,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  return launch_f1<false>(g, f2, d_f1, B, C, H, W, maxd, s2, device, stream);
}

// K6.  g: (B, D*D, H, W); f1, d_f2: (B, C, H, W); all float32 and contiguous.
extern "C" int correlation_bwd_f2(const float* g, const float* f1, float* d_f2,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  return launch_f2<false>(g, f1, d_f2, B, C, H, W, maxd, s2, device, stream);
}

// K5 for bfloat16 g and f2: float32 sums of the bf16 products, divided by
// C and rounded once, so d_f1 is (B, C, H, W) bfloat16.  The tensor-core
// body at maxd 20, s2 2, the general body for any other (maxd, s2).
extern "C" int correlation_bwd_f1_bf16(const __nv_bfloat16* g,
                                       const __nv_bfloat16* f2,
                                       __nv_bfloat16* d_f1, int B, int C,
                                       int H, int W, int maxd, int s2,
                                       int device, void* stream) {
  return launch_f1_bf16<false>(g, f2, d_f1, B, C, H, W, maxd, s2, device,
                               stream);
}

// K6 for bfloat16 g and f1: float32 sums of the bf16 products, divided by
// C and rounded once, so d_f2 is (B, C, H, W) bfloat16.  The tensor-core
// body at maxd 20, s2 2, the general body for any other (maxd, s2).
extern "C" int correlation_bwd_f2_bf16(const __nv_bfloat16* g,
                                       const __nv_bfloat16* f1,
                                       __nv_bfloat16* d_f2, int B, int C,
                                       int H, int W, int maxd, int s2,
                                       int device, void* stream) {
  return launch_f2_bf16<false>(g, f1, d_f2, B, C, H, W, maxd, s2, device,
                               stream);
}

// K7 backward, d_f1.  g: (B, D*D, Hloc, W); slab: (B, C, Hloc + 2*maxd, W);
// d_f1: (B, C, Hloc, W); all float32 and contiguous.
extern "C" int correlation_bwd_f1_rows(const float* g, const float* slab,
                                       float* d_f1, int B, int C, int Hloc,
                                       int W, int maxd, int s2, int device,
                                       void* stream) {
  return launch_f1<true>(g, slab, d_f1, B, C, Hloc, W, maxd, s2, device,
                        stream);
}

// K7 backward, d_slab.  g: (B, D*D, Hloc, W); f1: (B, C, Hloc, W); d_slab:
// (B, C, Hloc + 2*maxd, W), in slab coordinates; all float32 and contiguous.
extern "C" int correlation_bwd_f2_rows(const float* g, const float* f1,
                                       float* d_slab, int B, int C, int Hloc,
                                       int W, int maxd, int s2, int device,
                                       void* stream) {
  return launch_f2<true>(g, f1, d_slab, B, C, Hloc, W, maxd, s2, device,
                         stream);
}

// K7 backward for bfloat16 g, f1 and slab, any (maxd, s2), on the bodies
// of the whole-map bf16 entry points, chosen the same way (the TPU kernels'
// bf16 form, correlation_pallas.py:528, :553-554).  d_f1: (B, C, Hloc, W)
// bfloat16.
extern "C" int correlation_bwd_f1_rows_bf16(const __nv_bfloat16* g,
                                            const __nv_bfloat16* slab,
                                            __nv_bfloat16* d_f1, int B, int C,
                                            int Hloc, int W, int maxd, int s2,
                                            int device, void* stream) {
  return launch_f1_bf16<true>(g, slab, d_f1, B, C, Hloc, W, maxd, s2, device,
                              stream);
}

// d_slab: (B, C, Hloc + 2*maxd, W) bfloat16, in slab coordinates; the grid
// covers all Hloc + 2*maxd rows of it, as launch_f2<true> does.
extern "C" int correlation_bwd_f2_rows_bf16(const __nv_bfloat16* g,
                                            const __nv_bfloat16* f1,
                                            __nv_bfloat16* d_slab, int B,
                                            int C, int Hloc, int W, int maxd,
                                            int s2, int device,
                                            void* stream) {
  return launch_f2_bf16<true>(g, f1, d_slab, B, C, Hloc, W, maxd, s2, device,
                              stream);
}
