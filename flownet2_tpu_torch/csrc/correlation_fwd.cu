// K1 and K7 forward: correlation cost volume, forward, float32 or bfloat16.
//
// Replaces flownet2_tpu/ops/correlation_pallas.py: _kernel (narrow case,
// W + 2*maxd <= 128) and _kernel_wide (64-column chunks), reached from
// correlation_pallas (K1, entry point correlation_fwd) and, with slab=True,
// from correlation_pallas_rows (K7, entry point correlation_fwd_rows).  The
// kernels here have no width limit and cover all four.
//
//   out[b, (tj+r)*D + (ti+r), y, x] =
//       (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y + tj*s2, x + ti*s2]
//
// with r = maxd / s2, D = 2r + 1, tj, ti in [-r, r], and f2 read as zero
// outside the image (the op's zero padding by maxd).  NCHW in, (B, D*D, H, W)
// out.  This is the K=1, stride1=1, pad=maxd case, the only one any model
// uses; the wrapper rejects the others.
//
// The row-slab form (K7) serves a height-split cost volume: f1 holds one
// band of Hloc rows and the second operand is that band's halo slab, rows
// [off - maxd, off + Hloc + maxd) of the zero-padded f2, Hloc + 2*maxd rows:
//
//   out[b, d, y, x] = (1/C) * sum_c f1[b, c, y, x]
//                               * slab[b, c, y + maxd + tj*s2, x + ti*s2]
//
// The slab is not padded in H again; columns outside [0, W) read zero.  The
// kernel bodies read the second operand with a row count H2 and a row shift:
// K1 is (H2 = H, shift = 0), K7 is (H2 = Hloc + 2*maxd, shift = maxd).  The
// two are instantiations of one template with both values folded in.  Each
// body sums every output in one order that does not depend on the form, and
// divides by C last, so a band's rows carry the bits of the whole-map call.
//
// float32 operands: the sums are float32 on the FMA pipes, one fmaf chain
// over the channels in ascending order in either float body.  The port's
// float32 configuration is the parity one: a single TF32 product would break
// its 1e-5 tolerance and a 3xTF32 split costs as many operations as the FMAs.
//
// bfloat16 f1 and f2 (entry point correlation_fwd_bf16, the bf16 model's K1,
// and correlation_fwd_rows_bf16, its K7): float32 sums of the bf16 products,
// divided by C and rounded once to bfloat16 (the TPU kernel feeds bf16 to its
// matrix unit, accumulates in f32 and returns (out / C) in f1's dtype,
// correlation_pallas.py:83-99, :643-664).  At maxd 20, s2 2 they run the
// tensor-core body below, the TPU design on Hopper's tensor cores; for any
// other (maxd, s2) the general body, which upcasts while it stages and sums
// in fmaf chains.  At FlowNetC's shape a bf16 call moves ~47 MB, ~0.014 ms
// at 3.35 TB/s, and its 3.6 GFLOP of in-map multiply-adds (those whose f2
// row and column lie in the map) ~0.004 ms at the bf16 tensor-core rate:
// the bytes bound it.
//
// Bound on an H100 SXM at FlowNetC's shape (B 8, C 256, H 48, W 64,
// maxd 20, s2 2 -> 441 channels): 5.55 GFLOP of f32 multiply-adds against
// ~94 MB moved, so the FMA rate (~67 TFLOP/s, ~83 us) bounds it, not the
// memory (~28 us).
//
// Three bodies, chosen by configuration and dtype in launch() and
// launch_bf16():
//
// * correlation_fwd_tile_kernel, float32 at maxd 20, s2 2 (FlowNetC's,
//   D = 21), the one the float models run.  See the note above it.
// * correlation_fwd_mma_kernel, bfloat16 at maxd 20, s2 2.  See the note
//   above it.
// * correlation_fwd_general_kernel, for every other (maxd, s2): a block per
//   (batch, output row, row shift, 64-column tile) that stages the f1 row and
//   the one f2 row it needs 32 channels at a time; thread (tx, g) owns output
//   column tx and the column shifts g, g+4, ...
//
// The general body served FlowNetC's configuration too at first, at 1.11 ms,
// 7.5% of the FMA bound (NVIDIA H100 80GB HBM3, 700 W).  Four things held it
// there, and the tiled body answers each:
//
// 1. One 4-byte shared-memory load per FMA: an SM starts one 32-lane load a
//    clock and four 32-lane FMAs.  -> A register tile of 8 pixels x 11 column
//    shifts per thread: 88 FMAs for nine 16-byte loads.
// 2. A third of the FMA slots masked (32 slots for 21 shifts).  -> 22 slots
//    for 21 shifts.
// 3. Synchronous staging with a division and a modulo per element, no load
//    in flight while the FMAs ran.  -> cp.async, 16 bytes a copy, into a
//    two-stage ring; a thread works out its pieces' addresses once per chunk
//    of 8 channels.
// 4. The f1 row staged again for each of the 21 row shifts, ~1.1 GB from L2
//    to shared memory per launch.  -> A block takes 7 row shifts of 2 output
//    rows: 2 f1 rows and 8 f2 rows serve 14 (row, shift) pairs, ~0.3 GB.
//
// The tiled body reaches 0.253 ms at FlowNetC's shape, 33% of the bound, and
// 0.214 ms for one band of two (K7, (8, 256, 24, 64)) against 0.769; 128
// registers, no spills, 2 blocks of 224 threads an SM; bit for bit the
// general body's output (NVIDIA H100 80GB HBM3, 700 W).  What holds it now,
// from throwaway builds with one part left out: the sums alone
// take 0.180 ms, and what bounds them is shared-memory bandwidth (nine
// 16-byte loads are 36 of an SM's 128-byte cycles per warp and channel
// against 22 cycles to start its FMAs) together with the tail of a grid of
// 576 blocks on 264 resident ones; staging adds 0.02 ms and the store of the
// cost volume 0.045 ms, since an SM's two blocks reach their epilogues
// together.  A first form with the rows split by column parity in shared
// memory (4 pixels of one parity x 21 shifts, seven loads per 84 FMAs) summed
// faster (0.131 ms) but staged 4 bytes a copy, which cost as much again
// (0.32 ms in all); a 168-sum tile at 237 registers did no better
// (0.245-0.258 ms).

#include <cstdint>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// The register-tiled body for maxd 20, s2 2.
//
// A thread owns 8 neighbouring pixels x .. x+7 of one output row at one row
// shift, and 11 of the 21 column shifts: 88 sums in registers.  Per channel
// it needs its 8 f1 values and the 28 f2 values at columns
// x - 20 + 20*h + j, j = 0..27 (h = 0 for the column shifts 0..10, h = 1 for
// 10..20); value j feeds pixel k at local shift t where j = k + 2t.  That is
// 88 FMAs for 36 shared-memory words, nine 16-byte loads.  Both halves run
// the same code on a base that differs by 20 columns; column shift 10 is
// summed by both and stored by the first.
//
// Rows lie in shared memory as they lie in device memory, so staging moves
// 16 bytes at a time.  The 8 threads of a quarter warp are 4 neighbouring
// pixel groups times the 2 halves: their 16-byte loads start 8 words apart
// and the halves 20 words apart, which covers the 32 banks once.
//
// A block is one (batch, 64-column tile, kRows output rows of one parity,
// kShifts row shifts): kShifts * kRows thread tiles of 16 threads.  Output
// row y at row shift tj reads the f2 row y + 2*(tj - 10), so rows y, y+2, ..
// at consecutive shifts share f2 rows: the block stages kShifts + kRows - 1
// f2 rows and kRows f1 rows per channel, once for all its thread tiles.
//
// Staging is asynchronous: cp.async into a ring of kStages buffers of
// kChunkC channels, one barrier per chunk, so the next chunk loads while
// this one is summed.  Where W is a multiple of 4 and the tensors are
// 16-byte aligned (kVec) a copy moves 16 bytes, which then lie wholly inside
// or outside [0, W); otherwise 4.  Columns outside the map are written as
// zeros.  A thread tile whose f2 row lies outside the map skips the sums and
// writes zeros; its row is not staged.  Barriers stay uniform over the block.
// ---------------------------------------------------------------------------

constexpr int kMaxd = 20;                   // the tiled body's configuration
constexpr int kS2 = 2;
constexpr int kRad = kMaxd / kS2;           // 10
constexpr int kD = 2 * kRad + 1;            // 21
constexpr int kTileW = 64;                  // output columns per block
constexpr int kPix = 8;                     // pixels per thread
constexpr int kT = kRad + 1;                // column shifts per thread: 11
constexpr int kWords = kPix + 2 * (kT - 1); // f2 words per thread: 28
constexpr int kSpan = kTileW + 2 * kMaxd;   // f2 columns one tile reads: 104
constexpr int kTileThreads = kTileW / kPix * 2;   // 16 a thread tile
constexpr int kShifts = 7;                  // row shifts per block
constexpr int kRows = 2;                    // output rows (one parity) a block
constexpr int kChunkC = 8;                  // channels per stage
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;               // resident blocks asked for
constexpr int kThreads = kTileThreads * kShifts * kRows;
constexpr int kGroups = (kD + kShifts - 1) / kShifts;   // shift groups
constexpr int kF2Rows = kShifts + kRows - 1;            // f2 rows staged
constexpr int kF1Ch = kRows * kTileW;       // floats per staged channel, f1
constexpr int kChFloats = kF1Ch + kF2Rows * kSpan;   // f1 rows, then f2 rows
constexpr int kStageFloats = kChunkC * kChFloats;
static_assert(kStages >= 2, "the ring needs two stages");
static_assert(kWords % 4 == 0 && kPix % 4 == 0 && kMaxd % 4 == 0 &&
              kSpan % 4 == 0, "16-byte loads");

// One channel of a thread's sums: its 8 f1 values at ``a_ptr`` and its 28 f2
// values at ``w_ptr`` (16-byte aligned shared memory), 88 FMAs.
__device__ __forceinline__ void tile_sums(float (&acc)[kPix][kT],
                                          const float* a_ptr,
                                          const float* w_ptr) {
  float a[kPix];
  float w[kWords];
#pragma unroll
  for (int i = 0; i < kPix / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(a_ptr + 4 * i);
    a[4 * i] = v.x;
    a[4 * i + 1] = v.y;
    a[4 * i + 2] = v.z;
    a[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < kWords / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(w_ptr + 4 * i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
#pragma unroll
    for (int t = 0; t < kT; ++t)
      acc[k][t] = fmaf(a[k], w[k + 2 * t], acc[k][t]);
  }
}

template <bool kSlab, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
correlation_fwd_tile_kernel(const float* __restrict__ f1,
                            const float* __restrict__ f2,
                            float* __restrict__ out, int C, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of the second operand
  const int shift = kSlab ? kMaxd : 0;

  const int tid = threadIdx.x;
  const int q = (tid & 3) + ((tid >> 1) & 4);   // which 8 pixels of the tile
  const int h = (tid >> 2) & 1;          // which half of the column shifts
  const int u = tid / kTileThreads;      // thread tile
  const int s = u % kShifts;             // row shift within the group
  const int yy = u / kShifts;            // output row within the block
  const int tj0 = (blockIdx.x % kGroups) * kShifts;
  const int x0 = (blockIdx.x / kGroups) * kTileW;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int tj = tj0 + s;
  const int y = ybase + 2 * yy;
  // staged f2 row rho is row row0 + 2*rho of the second operand; thread
  // tile (s, yy) reads rho = s + yy
  const int row0 = ybase + shift + (tj0 - kRad) * kS2;
  const int y2 = row0 + 2 * (s + yy);
  const bool owns = tj < kD && y < H;
  const bool active = owns && y2 >= 0 && y2 < H2;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  const float* f1b = f1 + static_cast<int64_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<int64_t>(b) * C * plane2;

  float acc[kPix][kT];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[k][t] = 0.f;
  }

  if (__syncthreads_or(active)) {
    // One channel's stage is kRows f1 rows of kTileW floats, then kF2Rows f2
    // rows of kSpan floats.  It is copied in pieces of kPiece floats; a
    // thread takes the pieces tid, tid + kThreads, ... of the channel layout
    // and copies each for every channel of the chunk.
    constexpr int kPiece = kVec ? 4 : 1;
    constexpr int kF1Pieces = kF1Ch / kPiece;
    constexpr int kRowPieces = kSpan / kPiece;
    constexpr int kPieces = kChFloats / kPiece;
    auto stage = [&](int n) {
      const int c0 = n * kChunkC;
      const int nc = min(kChunkC, C - c0);
      float* buf = smem + (n % kStages) * kStageFloats;
      for (int p = tid; p < kPieces; p += kThreads) {
        const float* src;
        int64_t stride;
        bool ok;
        if (p < kF1Pieces) {
          const int ry = p / (kTileW / kPiece);
          const int col = x0 + (p % (kTileW / kPiece)) * kPiece;
          const int row = ybase + 2 * ry;
          if (row >= H) continue;               // no tile owns it
          ok = col < W;
          src = f1b + c0 * plane + static_cast<int64_t>(row) * W + col;
          stride = plane;
        } else {
          const int rho = (p - kF1Pieces) / kRowPieces;
          const int col = x0 - kMaxd + ((p - kF1Pieces) % kRowPieces) * kPiece;
          const int row = row0 + 2 * rho;
          if (row < 0 || row >= H2) continue;   // no active tile reads it
          ok = col >= 0 && col < W;
          src = f2b + c0 * plane2 + static_cast<int64_t>(row) * W + col;
          stride = plane2;
        }
        if (!ok) {
          src = f1;
          stride = 0;
        }
        float* dst = buf + p * kPiece;
#pragma unroll
        for (int c = 0; c < kChunkC; ++c) {
          if (c < nc) cp_async<4 * kPiece>(dst + c * kChFloats, src, ok);
          src += stride;
        }
      }
      cp_async_commit();
    };

    const float* a_base = smem + yy * kTileW + kPix * q;
    const float* w_base =
        smem + kF1Ch + (s + yy) * kSpan + kPix * q + kMaxd * h;
    const int nchunks = (C + kChunkC - 1) / kChunkC;
    for (int n = 0; n < kStages - 1; ++n) {
      if (n < nchunks) stage(n); else cp_async_commit();
    }
    for (int n = 0; n < nchunks; ++n) {
      cp_async_wait<kStages - 2>();
      __syncthreads();     // chunk n has landed; chunk n - 1 is summed
      if (n + kStages - 1 < nchunks) stage(n + kStages - 1);
      else cp_async_commit();
      if (active) {
        const int nc = min(kChunkC, C - n * kChunkC);
        const float* a_ptr = a_base + (n % kStages) * kStageFloats;
        const float* w_ptr = w_base + (n % kStages) * kStageFloats;
        if (nc == kChunkC) {
#pragma unroll
          for (int c = 0; c < kChunkC; ++c)
            tile_sums(acc, a_ptr + c * kChFloats, w_ptr + c * kChFloats);
        } else {
          for (int c = 0; c < nc; ++c)
            tile_sums(acc, a_ptr + c * kChFloats, w_ptr + c * kChFloats);
        }
      }
    }
  }

  if (owns) {
    const float cf = static_cast<float>(C);
    const int x = x0 + kPix * q;
    const int64_t d0 = static_cast<int64_t>(b) * kD * kD + tj * kD + kRad * h;
    float* o = out + d0 * plane + static_cast<int64_t>(y) * W + x;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (t == 0 && h == 1) continue;   // column shift 10 is the first half's
      if (kVec) {
#pragma unroll
        for (int k = 0; k < kPix; k += 4) {
          if (x + k < W)
            *reinterpret_cast<float4*>(o + t * plane + k) =
                make_float4(acc[k][t] / cf, acc[k + 1][t] / cf,
                            acc[k + 2][t] / cf, acc[k + 3][t] / cf);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (x + k < W) o[t * plane + k] = acc[k][t] / cf;
        }
      }
    }
  }
}

template <bool kSlab, bool kVec>
int launch_tile_as(const float* f1, const float* f2, float* out, int B, int C,
                   int H, int W, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * kStages * kStageFloats;
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        correlation_fwd_tile_kernel<kSlab, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
  }
  // row blocks with a first row inside the map: two (one per parity) for
  // every 2*kRows rows
  const int rest = H % (2 * kRows);
  const int ny = H / (2 * kRows) * 2 + (rest < 2 ? rest : 2);
  const dim3 grid((W + kTileW - 1) / kTileW * kGroups, ny, B);
  correlation_fwd_tile_kernel<kSlab, kVec><<<grid, kThreads, smem, stream>>>(
      f1, f2, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSlab>
int launch_tile(const float* f1, const float* f2, float* out, int B, int C,
                int H, int W, cudaStream_t stream) {
  const bool vec = W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(f1) |
                    reinterpret_cast<uintptr_t>(f2) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_tile_as<kSlab, true>(f1, f2, out, B, C, H, W, stream)
             : launch_tile_as<kSlab, false>(f1, f2, out, B, C, H, W, stream);
}

// ---------------------------------------------------------------------------
// The tensor-core body for bfloat16 f1 and f2 at maxd 20, s2 2: the TPU
// kernel's band product on mma.sync.
//
// For 16 output pixels x0 .. x0+15 of one row at one row shift, the product
// A (16 px x 16 ch) . B (16 ch x 64 cols) over the f2 columns
// [x0 - 24, x0 + 40), chunk by chunk of 16 channels, holds every sum the
// band needs: pixel r at column shift ti is the product's element
// (r, r + 2*ti + 4).  That is eight m16n8k16 products (bf16 operands as
// they lie, f32 accumulators) for 16 x 21 wanted sums, 3x the band's
// multiply-adds, on units ~15x the FMA pipes' rate.  The window starts 24
// columns left of the tile, not 20, so that every 8-column piece of it is
// 16-byte aligned for ldmatrix and cp.async.
//
// A block is one (batch, 64-column tile, kMmaRows output rows of one
// parity, kMmaShifts row shifts), as in the tiled float body: output row y
// at shift tj reads the f2 row y + 2*(tj - 10), so the block stages
// kMmaShifts + kMmaRows - 1 f2 rows and kMmaRows f1 rows per channel for its
// kMmaRows * kMmaShifts (row, shift) pairs.  Warp (q, yy) owns the 16-pixel
// tile q of output row yy at the block's kMmaShifts shifts: per k-step it
// loads its A fragment once and a B fragment per shift, and holds 3 x 8
// accumulator tiles (96 registers).  Two blocks of 256 threads share an SM,
// so that one block's epilogue runs beside the other's products.
//
// Rows lie in shared memory as [row][channel][column] with the column
// fastest, as in device memory, so staging copies bytes as they lie
// (16-byte cp.async where W % 8 == 0 and the tensors are 16-byte aligned,
// else 4-byte cp.async for an even W, else a 2-byte load and store) into a
// ring of kMmaStages chunks of kMmaChunkC channels; ldmatrix.trans turns the
// channel-major rows into the fragments.  Row pitches of 144 and 240 bytes
// put the eight rows of each 8x8 ldmatrix on distinct banks.  A thread owns
// fixed (row, column piece) slots of a stage and a group of its channels,
// and works out their addresses once, so that a copy costs a pointer step:
// decoding each piece's address for each chunk costs the warps more
// instruction slots than their products, and the copies' bytes do not bound
// the staging.  Columns outside [0, W) and channels past C are
// staged as zeros; a pair whose f2 row lies outside the map computes nothing
// and writes zeros.
//
// Every output's sum runs over the same chunks, k-steps and fragment
// position in the whole-map and the slab form (both tile the columns from
// 0 and the channels from 0), so a band's rows carry the bits of the
// whole-map call.  The epilogue writes the band's float sums to a tile in
// shared memory, then divides by C, rounds once to bf16 and stores with x
// fastest, 16 bytes a thread.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (kernel_ab.py, the parent's general
// body in the same call): 0.1049 ms for K1 at (8, 256, 48, 64) against
// 1.1329, 0.0660 for K7 at one band of two against 0.7667; 128 registers
// and 60 bytes spilled (chip_smoke.py phase 1's ptxas lines).  That is 13%
// and 15% of the bytes' bound (0.0140, 0.0101 ms).
// The tensor cores do 3x the band's products at mma.sync's rate, which is
// below wgmma's; staging and the epilogue, which one block's warps run in
// turn with the products, take the rest.  One value in ~10^4 differs by
// one ulp from the general body's fmaf chain (the order of the sums).
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 2;            // output rows (one parity) a block
constexpr int kMmaShifts = 3;          // row shifts a block and a warp
constexpr int kMmaQ = kTileW / 16;     // 16-pixel tiles across a block: 4
constexpr int kMmaThreads = 32 * kMmaQ * kMmaRows;   // 256
constexpr int kMmaGroups = kD / kMmaShifts;          // 7
constexpr int kMmaPairs = kMmaRows * kMmaShifts;     // 6
constexpr int kMmaF2Rows = kMmaShifts + kMmaRows - 1;   // 4
constexpr int kMmaLead = 24;           // f2 window start, left of the tile
constexpr int kMmaSpan = kTileW + 2 * kMmaLead;      // f2 columns staged: 112
constexpr int kMmaKSteps = 2;          // k-steps of 16 channels a stage
constexpr int kMmaChunkC = 16 * kMmaKSteps;   // channels a stage
constexpr int kMmaStages = 2;
constexpr int kMmaMinBlocks = 2;       // resident blocks asked for
constexpr int kF1Pitch = kTileW + 8;   // bf16 a staged f1 channel row: 72
constexpr int kF2Pitch = kMmaSpan + 8; // and f2: 120
constexpr int kMmaF1Elems = kMmaRows * kMmaChunkC * kF1Pitch;
constexpr int kMmaStageElems =
    kMmaF1Elems + kMmaF2Rows * kMmaChunkC * kF2Pitch;
constexpr int kBandPitch = kTileW + 8; // floats a row of the band tile
static_assert(kD % kMmaShifts == 0, "whole shift groups");
static_assert(2 * kMmaPairs * kD * kBandPitch <= kMmaStages * kMmaStageElems,
              "the band tile reuses the ring");
static_assert((kF1Pitch * 2) % 16 == 0 && (kF2Pitch * 2) % 16 == 0 &&
              kMmaLead % 8 == 0, "16-byte ldmatrix rows");

template <bool kSlab, int kPiece>
__global__ void __launch_bounds__(kMmaThreads, kMmaMinBlocks)
correlation_fwd_mma_kernel(const __nv_bfloat16* __restrict__ f1,
                           const __nv_bfloat16* __restrict__ f2,
                           __nv_bfloat16* __restrict__ out, int C, int H,
                           int W) {
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  const int H2 = kSlab ? H + 2 * kMaxd : H;   // rows of the second operand
  const int shift = kSlab ? kMaxd : 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = (tid >> 5) % kMmaQ;      // 16-pixel tile of the warp
  const int yy = (tid >> 5) / kMmaQ;     // output row of the warp
  const int tj0 = (blockIdx.x % kMmaGroups) * kMmaShifts;
  const int x0 = (blockIdx.x / kMmaGroups) * kTileW;
  // blocks alternate row parity: rows ybase, ybase + 2, ...
  const int ybase = (blockIdx.y >> 1) * (2 * kMmaRows) + (blockIdx.y & 1);
  const int b = blockIdx.z;
  const int y = ybase + 2 * yy;
  // staged f2 row rho is row row0 + 2*rho of the second operand; the pair
  // (yy, s) reads rho = yy + s
  const int row0 = ybase + shift + (tj0 - kRad) * kS2;
  const bool live = y < H && x0 + 16 * q < W;
  bool active[kMmaShifts];
  bool any = false;
#pragma unroll
  for (int s = 0; s < kMmaShifts; ++s) {
    const int y2 = row0 + 2 * (yy + s);
    active[s] = live && y2 >= 0 && y2 < H2;
    any = any || active[s];
  }

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  const __nv_bfloat16* f1b = f1 + static_cast<int64_t>(b) * C * plane;
  const __nv_bfloat16* f2b = f2 + static_cast<int64_t>(b) * C * plane2;

  float acc[kMmaShifts][8][4];
#pragma unroll
  for (int s = 0; s < kMmaShifts; ++s)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][t][e] = 0.f;

  if (__syncthreads_or(any)) {
    // A stage is kMmaRows f1 rows of kMmaChunkC channel rows of kTileW
    // columns, then kMmaF2Rows f2 rows of kMmaChunkC channel rows of
    // kMmaSpan columns, copied in pieces of kPiece values.  A thread owns
    // kPasses (row, column piece) slots of that layout and kCPer channels of
    // each chunk; it works out a slot's addresses once, so that a copy costs
    // a pointer step.
    constexpr int kF1Slots = kMmaRows * (kTileW / kPiece);
    constexpr int kSlots = kF1Slots + kMmaF2Rows * (kMmaSpan / kPiece);
    constexpr int kCGroups = kPiece == 8 ? kMmaThreads / 128 : 1;
    constexpr int kCPer = kMmaChunkC / kCGroups;
    constexpr int kSlotThreads = kMmaThreads / kCGroups;
    constexpr int kPasses = (kSlots + kSlotThreads - 1) / kSlotThreads;
    const int cg = tid / kSlotThreads;
    const __nv_bfloat16* src[kPasses];
    int64_t stride[kPasses];      // 0 where the piece lies outside [0, W)
    int dst[kPasses], pitch[kPasses];
    bool used[kPasses], inside[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int u = tid % kSlotThreads + k * kSlotThreads;
      src[k] = f1;
      stride[k] = 0;
      dst[k] = pitch[k] = 0;
      used[k] = inside[k] = false;
      if (u < kF1Slots) {
        const int ry = u / (kTileW / kPiece);
        const int col = (u % (kTileW / kPiece)) * kPiece;
        const int row = ybase + 2 * ry;
        used[k] = row < H;                   // no pair owns a row past it
        inside[k] = x0 + col < W;
        pitch[k] = kF1Pitch;
        dst[k] = (ry * kMmaChunkC + cg * kCPer) * kF1Pitch + col;
        if (used[k] && inside[k]) {
          stride[k] = plane;
          src[k] = f1b + cg * kCPer * plane + static_cast<int64_t>(row) * W +
                   x0 + col;
        }
      } else if (u < kSlots) {
        const int i = u - kF1Slots;
        const int rho = i / (kMmaSpan / kPiece);
        const int col = (i % (kMmaSpan / kPiece)) * kPiece;
        const int row = row0 + 2 * rho;
        const int gcol = x0 - kMmaLead + col;
        used[k] = row >= 0 && row < H2;      // no active pair reads others
        inside[k] = gcol >= 0 && gcol < W;
        pitch[k] = kF2Pitch;
        dst[k] =
            kMmaF1Elems + (rho * kMmaChunkC + cg * kCPer) * kF2Pitch + col;
        if (used[k] && inside[k]) {
          stride[k] = plane2;
          src[k] = f2b + cg * kCPer * plane2 + static_cast<int64_t>(row) * W +
                   gcol;
        }
      }
    }
    // stage(n) runs for n = 0, 1, 2, ... in turn, so each slot's source
    // steps one chunk a call
    auto stage = [&](int n) {
      const int left = C - n * kMmaChunkC - cg * kCPer;   // channels left
      __nv_bfloat16* buf = ring + (n % kMmaStages) * kMmaStageElems;
#pragma unroll
      for (int k = 0; k < kPasses; ++k) {
        if (!used[k]) continue;
        const __nv_bfloat16* from = src[k];
        __nv_bfloat16* to = buf + dst[k];
#pragma unroll
        for (int c = 0; c < kCPer; ++c) {
          stage_piece<kPiece>(to, from, inside[k] && c < left);
          from += stride[k];
          to += pitch[k];
        }
        src[k] += kMmaChunkC * stride[k];
      }
      cp_async_commit();
    };

    // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8.  A's
    // four matrices are (pixels 0-7, 8-15) x (channels 0-7, 8-15) in the
    // fragment's order; B's are (channels 0-7, 8-15) x (n-tiles t, t+1).
    const int a_off = (yy * kMmaChunkC + (lane & 7) + ((lane >> 4) & 1) * 8) *
                          kF1Pitch + 16 * q + ((lane >> 3) & 1) * 8;
    const int b_off = kMmaF1Elems +
                      (yy * kMmaChunkC + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          kF2Pitch + 16 * q + ((lane >> 4) & 1) * 8;
    const int nchunks = (C + kMmaChunkC - 1) / kMmaChunkC;
    for (int n = 0; n < kMmaStages - 1; ++n) {
      if (n < nchunks) stage(n); else cp_async_commit();
    }
    for (int n = 0; n < nchunks; ++n) {
      cp_async_wait<kMmaStages - 2>();
      __syncthreads();     // chunk n has landed; chunk n - 1 is summed
      if (n + kMmaStages - 1 < nchunks) stage(n + kMmaStages - 1);
      else cp_async_commit();
      if (any) {
        const __nv_bfloat16* buf = ring + (n % kMmaStages) * kMmaStageElems;
#pragma unroll
        for (int k = 0; k < kMmaKSteps; ++k) {
          uint32_t a[4];
          ldsm_x4_trans(a, buf + a_off + 16 * k * kF1Pitch);
#pragma unroll
          for (int s = 0; s < kMmaShifts; ++s) {
            if (!active[s]) continue;
            const __nv_bfloat16* b_ptr =
                buf + b_off + (s * kMmaChunkC + 16 * k) * kF2Pitch;
#pragma unroll
            for (int t = 0; t < 8; t += 2) {
              uint32_t bb[4];
              ldsm_x4_trans(bb, b_ptr + 8 * t);
              mma_bf16(acc[s][t], a, bb[0], bb[1]);
              mma_bf16(acc[s][t + 1], a, bb[2], bb[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
  __syncthreads();         // the ring is free: it holds the band tile now

  // The band tile: [pair][ti][x], the float sums.  Accumulator element e of
  // n-tile t is pixel r = lane/4 (+8 for e >= 2) at window column
  // j = 8t + 2*(lane%4) + e%2, which is column shift ti = (j - r - 4) / 2.
  // A row pitch of 72 words puts the 16 sums a warp writes at once on
  // distinct banks.
  float* band = reinterpret_cast<float*>(ring);
  if (live) {
#pragma unroll
    for (int s = 0; s < kMmaShifts; ++s) {
      float* bp = band + (yy * kMmaShifts + s) * kD * kBandPitch + 16 * q;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (lane >> 2) + (e >> 1) * 8;
          const int d = 8 * t + 2 * (lane & 3) + (e & 1) - r - 4;
          if (d >= 0 && d <= 2 * (kD - 1) && (d & 1) == 0)
            bp[(d >> 1) * kBandPitch + r] = acc[s][t][e];
        }
      }
    }
  }
  __syncthreads();

  // Divide by C, round once and store, x fastest: 8 values a thread where
  // W % 8 == 0.
  const float cf = static_cast<float>(C);
  constexpr int kOut = kPiece == 8 ? 8 : 1;
  constexpr int kRowPieces = kTileW / kOut;
  for (int p = tid; p < kMmaPairs * kD * kRowPieces; p += kMmaThreads) {
    const int pair = p / (kD * kRowPieces);
    const int ti = (p / kRowPieces) % kD;
    const int x = x0 + (p % kRowPieces) * kOut;
    const int oy = ybase + 2 * (pair / kMmaShifts);
    const int tj = tj0 + pair % kMmaShifts;
    if (oy >= H || x >= W) continue;
    const float* src = band + (pair * kD + ti) * kBandPitch + x - x0;
    __nv_bfloat16* dst =
        out + (static_cast<int64_t>(b) * kD * kD + tj * kD + ti) * plane +
        static_cast<int64_t>(oy) * W + x;
    if constexpr (kOut == 8) {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          bf16_pair(lo.x / cf, lo.y / cf), bf16_pair(lo.z / cf, lo.w / cf),
          bf16_pair(hi.x / cf, hi.y / cf), bf16_pair(hi.z / cf, hi.w / cf));
    } else {
      fnet_store(dst, *src / cf);
    }
  }
}

template <bool kSlab, int kPiece>
int launch_mma_as(const __nv_bfloat16* f1, const __nv_bfloat16* f2,
                  __nv_bfloat16* out, int B, int C, int H, int W,
                  cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * kMmaStages * kMmaStageElems;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      correlation_fwd_mma_kernel<kSlab, kPiece>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err) return err;
  // row blocks with a first row inside the map: two (one per parity) for
  // every 2*kMmaRows rows
  const int rest = H % (2 * kMmaRows);
  const int ny = H / (2 * kMmaRows) * 2 + (rest < 2 ? rest : 2);
  const dim3 grid((W + kTileW - 1) / kTileW * kMmaGroups, ny, B);
  correlation_fwd_mma_kernel<kSlab, kPiece>
      <<<grid, kMmaThreads, smem, stream>>>(f1, f2, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The copy width, chosen at launch: 16 bytes where W % 8 == 0 and every
// tensor is 16-byte aligned, 4 where W is even and they are 4-byte aligned,
// else 2.
template <bool kSlab>
int launch_mma(const __nv_bfloat16* f1, const __nv_bfloat16* f2,
               __nv_bfloat16* out, int B, int C, int H, int W,
               cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(f1) |
                         reinterpret_cast<uintptr_t>(f2) |
                         reinterpret_cast<uintptr_t>(out);
  if (W % 8 == 0 && addr % 16 == 0)
    return launch_mma_as<kSlab, 8>(f1, f2, out, B, C, H, W, stream);
  if (W % 2 == 0 && addr % 4 == 0)
    return launch_mma_as<kSlab, 2>(f1, f2, out, B, C, H, W, stream);
  return launch_mma_as<kSlab, 1>(f1, f2, out, B, C, H, W, stream);
}

// ---------------------------------------------------------------------------
// The general body, for every other (maxd, s2).
// ---------------------------------------------------------------------------

constexpr int kGenGroups = 4;                  // thread groups over col shifts
constexpr int kGenThreads = kTileW * kGenGroups;   // 256
constexpr int kGenShifts = 8;                  // sums per thread and pass
constexpr int kGenChunkC = 32;                 // channels staged per step

// T is the operands' and the output's element type: bfloat16 operands are
// upcast exactly while they are staged, the sums are the float ones, and
// the output is rounded once (fnet_load, fnet_store in common.cuh).
template <typename T, bool kSlab>
__global__ void __launch_bounds__(kGenThreads)
correlation_fwd_general_kernel(const T* __restrict__ f1,
                               const T* __restrict__ f2,
                               T* __restrict__ out, int C, int H, int W,
                               int maxd, int s2, int D) {
  extern __shared__ float smem[];
  const int H2 = kSlab ? H + 2 * maxd : H;   // rows of the second operand
  const int shift = kSlab ? maxd : 0;
  const int span = kTileW + 2 * maxd;   // f2 columns one tile reads
  float* f1s = smem;                       // [kGenChunkC][kTileW]
  float* f2s = smem + kGenChunkC * kTileW; // [kGenChunkC][span]

  const int r = (D - 1) / 2;
  const int tj = blockIdx.x % D;        // row shift, as an index in [0, D)
  const int x0 = (blockIdx.x / D) * kTileW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int y2 = y + shift + (tj - r) * s2;   // row of the second operand
  const int tx = threadIdx.x % kTileW;
  const int g = threadIdx.x / kTileW;
  const int x = x0 + tx;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t plane2 = static_cast<int64_t>(H2) * W;
  T* out_row = out + static_cast<int64_t>(b) * D * D * plane +
                   static_cast<int64_t>(tj) * D * plane +
                   static_cast<int64_t>(y) * W;

  if (y2 < 0 || y2 >= H2) {
    if (x < W) {
      for (int ti = g; ti < D; ti += kGenGroups)
        fnet_store(out_row + ti * plane + x, 0.f);
    }
    return;
  }

  const T* f1_row = f1 + static_cast<int64_t>(b) * C * plane +
                    static_cast<int64_t>(y) * W;
  const T* f2_row = f2 + static_cast<int64_t>(b) * C * plane2 +
                    static_cast<int64_t>(y2) * W;
  const int xs = x0 - maxd;            // first f2 column of the span
  // f2 column of (x, ti) is x + (ti - r)*s2, at span offset
  // tx + ti*s2 + (maxd - r*s2).
  const int lead = maxd - r * s2;

  for (int ti0 = 0; ti0 < D; ti0 += kGenGroups * kGenShifts) {
    float acc[kGenShifts];
#pragma unroll
    for (int k = 0; k < kGenShifts; ++k) acc[k] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kGenChunkC) {
      const int nc = min(kGenChunkC, C - c0);
      for (int i = threadIdx.x; i < kGenChunkC * kTileW; i += kGenThreads) {
        const int c = i / kTileW;
        const int col = x0 + i % kTileW;
        f1s[i] = (c < nc && col < W)
                     ? fnet_load(f1_row + static_cast<int64_t>(c0 + c) * plane
                                 + col)
                     : 0.f;
      }
      for (int i = threadIdx.x; i < kGenChunkC * span; i += kGenThreads) {
        const int c = i / span;
        const int col = xs + i % span;
        f2s[i] = (c < nc && col >= 0 && col < W)
                     ? fnet_load(f2_row + static_cast<int64_t>(c0 + c) * plane2
                                 + col)
                     : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float a = f1s[c * kTileW + tx];
        const float* f2c = f2s + c * span + tx + lead;
#pragma unroll
        for (int k = 0; k < kGenShifts; ++k) {
          const int ti = ti0 + g + k * kGenGroups;
          if (ti < D) acc[k] = fmaf(a, f2c[ti * s2], acc[k]);
        }
      }
      __syncthreads();
    }

    if (x < W) {
#pragma unroll
      for (int k = 0; k < kGenShifts; ++k) {
        const int ti = ti0 + g + k * kGenGroups;
        if (ti < D)
          fnet_store(out_row + ti * plane + x, acc[k] / static_cast<float>(C));
      }
    }
  }
}

template <typename T, bool kSlab>
int launch_general(const T* f1, const T* f2, T* out, int B, int C, int H,
                   int W, int maxd, int s2, cudaStream_t stream) {
  const int D = 2 * (maxd / s2) + 1;
  const int tiles = (W + kTileW - 1) / kTileW;
  const size_t smem = sizeof(float) * kGenChunkC * (2 * kTileW + 2 * maxd);
  if (smem > 48 * 1024) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        correlation_fwd_general_kernel<T, kSlab>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const dim3 grid(tiles * D, H, B);
  correlation_fwd_general_kernel<T, kSlab>
      <<<grid, kGenThreads, smem, stream>>>(f1, f2, out, C, H, W, maxd, s2, D);
  return static_cast<int>(cudaGetLastError());
}

// The tiled body where the configuration is the one it is written for, the
// general body for any other: a choice by configuration, both are kernels.
template <bool kSlab>
int launch(const float* f1, const float* f2, float* out, int B, int C, int H,
           int W, int maxd, int s2, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maxd == kMaxd && s2 == kS2)
    return launch_tile<kSlab>(f1, f2, out, B, C, H, W, st);
  return launch_general<float, kSlab>(f1, f2, out, B, C, H, W, maxd, s2, st);
}

// The bf16 forms: the tensor-core body for maxd 20, s2 2, the general body
// for any other configuration.
template <bool kSlab>
int launch_bf16(const __nv_bfloat16* f1, const __nv_bfloat16* f2,
                __nv_bfloat16* out, int B, int C, int H, int W, int maxd,
                int s2, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (maxd == kMaxd && s2 == kS2)
    return launch_mma<kSlab>(f1, f2, out, B, C, H, W, st);
  return launch_general<__nv_bfloat16, kSlab>(f1, f2, out, B, C, H, W, maxd,
                                              s2, st);
}

}  // namespace

// K1.  f1, f2: (B, C, H, W) float32, contiguous; out: (B, D*D, H, W) float32
// with D = 2*(maxd/s2) + 1.
extern "C" int correlation_fwd(const float* f1, const float* f2, float* out,
                               int B, int C, int H, int W, int maxd, int s2,
                               int device, void* stream) {
  return launch<false>(f1, f2, out, B, C, H, W, maxd, s2, device, stream);
}

// K1 for bfloat16 f1 and f2: float32 sums of the bf16 products, divided by
// C and rounded once, so out is (B, D*D, H, W) bfloat16.  The tensor-core
// body at maxd 20, s2 2, the general body for any other (maxd, s2).  The
// TPU kernel's bf16 form (correlation_pallas.py :70 accepts bf16 and :664
// returns (out / C) in f1's dtype).
extern "C" int correlation_fwd_bf16(const __nv_bfloat16* f1,
                                    const __nv_bfloat16* f2,
                                    __nv_bfloat16* out, int B, int C, int H,
                                    int W, int maxd, int s2, int device,
                                    void* stream) {
  return launch_bf16<false>(f1, f2, out, B, C, H, W, maxd, s2, device,
                            stream);
}

// K7 forward.  f1: (B, C, Hloc, W); slab: (B, C, Hloc + 2*maxd, W); out:
// (B, D*D, Hloc, W); all float32 and contiguous.
extern "C" int correlation_fwd_rows(const float* f1, const float* slab,
                                    float* out, int B, int C, int Hloc, int W,
                                    int maxd, int s2, int device,
                                    void* stream) {
  return launch<true>(f1, slab, out, B, C, Hloc, W, maxd, s2, device,
                      stream);
}

// K7 forward for bfloat16 f1 and slab, as correlation_fwd_bf16 (the same
// bodies, chosen the same way): out (B, D*D, Hloc, W) bfloat16.  The TPU
// kernel's bf16 form of the row-slab path (correlation_pallas.py:615, :664).
extern "C" int correlation_fwd_rows_bf16(const __nv_bfloat16* f1,
                                         const __nv_bfloat16* slab,
                                         __nv_bfloat16* out, int B, int C,
                                         int Hloc, int W, int maxd, int s2,
                                         int device, void* stream) {
  return launch_bf16<true>(f1, slab, out, B, C, Hloc, W, maxd, s2, device,
                           stream);
}
