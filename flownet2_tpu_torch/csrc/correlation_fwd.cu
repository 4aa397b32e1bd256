// K1: correlation cost volume, forward, float32.
//
// Replaces flownet2_tpu/ops/correlation_pallas.py: _kernel (narrow case,
// W + 2*maxd <= 128) and _kernel_wide (64-column chunks), both reached from
// correlation_pallas.  One kernel with no width limit covers both.
//
//   out[b, (tj+r)*D + (ti+r), y, x] =
//       (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y + tj*s2, x + ti*s2]
//
// with r = maxd / s2, D = 2r + 1, tj, ti in [-r, r], and f2 read as zero
// outside the image (the op's zero padding by maxd).  NCHW in, (B, D*D, H, W)
// out.  This is the K=1, stride1=1, pad=maxd case, the only one any model
// uses; the wrapper rejects the others.
//
// Bound on an H100 SXM at FlowNetC's shape (B 8, C 256, H 48, W 64,
// maxd 20, s2 2 -> 441 channels): 5.55 GFLOP of f32 multiply-adds against
// ~94 MB moved, so the FMA rate (~67 TFLOP/s, ~83 us) bounds it, not the
// memory (~28 us).  The TPU kernel fed bf16 operands to the matrix unit;
// here operands and sums stay f32 (a tensor-core variant is later work).
//
// Design: a block per (batch, output row, row shift tj, 64-column tile).
// It stages the f1 row and the one f2 row it needs, 32 channels at a time,
// in shared memory (64 + 64 + 2*maxd columns), so each input value is read
// from device memory once per row shift and then reused from shared memory
// by every column shift.  Thread (tx, g) owns output column tx and the
// column shifts g, g+4, g+8, ..., kept in registers across all channels.
// A warp reads 32 consecutive shared-memory words per step, so there are no
// bank conflicts; outputs are written as coalesced rows.  A row shift that
// falls wholly in the padding writes zeros and skips the sums.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileW = 64;                  // output columns per block
constexpr int kGroups = 4;                  // thread groups over column shifts
constexpr int kThreads = kTileW * kGroups;  // 256
constexpr int kShiftsPerThread = 8;         // accumulators per thread and pass
constexpr int kChunkC = 32;                 // channels staged per step

__global__ void __launch_bounds__(kThreads)
correlation_fwd_kernel(const float* __restrict__ f1,
                       const float* __restrict__ f2,
                       float* __restrict__ out, int C, int H, int W, int maxd,
                       int s2, int D) {
  extern __shared__ float smem[];
  const int span = kTileW + 2 * maxd;   // f2 columns one tile reads
  float* f1s = smem;                    // [kChunkC][kTileW]
  float* f2s = smem + kChunkC * kTileW; // [kChunkC][span]

  const int r = (D - 1) / 2;
  const int tj = blockIdx.x % D;        // row shift, as an index in [0, D)
  const int x0 = (blockIdx.x / D) * kTileW;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int y2 = y + (tj - r) * s2;
  const int tx = threadIdx.x % kTileW;
  const int g = threadIdx.x / kTileW;
  const int x = x0 + tx;

  const int64_t plane = static_cast<int64_t>(H) * W;
  float* out_row = out + static_cast<int64_t>(b) * D * D * plane +
                   static_cast<int64_t>(tj) * D * plane +
                   static_cast<int64_t>(y) * W;

  if (y2 < 0 || y2 >= H) {
    if (x < W) {
      for (int ti = g; ti < D; ti += kGroups) out_row[ti * plane + x] = 0.f;
    }
    return;
  }

  const float* f1_row = f1 + static_cast<int64_t>(b) * C * plane +
                        static_cast<int64_t>(y) * W;
  const float* f2_row = f2 + static_cast<int64_t>(b) * C * plane +
                        static_cast<int64_t>(y2) * W;
  const int xs = x0 - maxd;            // first f2 column of the span
  // f2 column of (x, ti) is x + (ti - r)*s2, at span offset
  // tx + ti*s2 + (maxd - r*s2).
  const int lead = maxd - r * s2;

  for (int ti0 = 0; ti0 < D; ti0 += kGroups * kShiftsPerThread) {
    float acc[kShiftsPerThread];
#pragma unroll
    for (int k = 0; k < kShiftsPerThread; ++k) acc[k] = 0.f;

    for (int c0 = 0; c0 < C; c0 += kChunkC) {
      const int nc = min(kChunkC, C - c0);
      for (int i = threadIdx.x; i < kChunkC * kTileW; i += kThreads) {
        const int c = i / kTileW;
        const int col = x0 + i % kTileW;
        f1s[i] = (c < nc && col < W)
                     ? f1_row[static_cast<int64_t>(c0 + c) * plane + col]
                     : 0.f;
      }
      for (int i = threadIdx.x; i < kChunkC * span; i += kThreads) {
        const int c = i / span;
        const int col = xs + i % span;
        f2s[i] = (c < nc && col >= 0 && col < W)
                     ? f2_row[static_cast<int64_t>(c0 + c) * plane + col]
                     : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < nc; ++c) {
        const float a = f1s[c * kTileW + tx];
        const float* f2c = f2s + c * span + tx + lead;
#pragma unroll
        for (int k = 0; k < kShiftsPerThread; ++k) {
          const int ti = ti0 + g + k * kGroups;
          if (ti < D) acc[k] = fmaf(a, f2c[ti * s2], acc[k]);
        }
      }
      __syncthreads();
    }

    if (x < W) {
#pragma unroll
      for (int k = 0; k < kShiftsPerThread; ++k) {
        const int ti = ti0 + g + k * kGroups;
        if (ti < D) out_row[ti * plane + x] = acc[k] / static_cast<float>(C);
      }
    }
  }
}

}  // namespace

// f1, f2: (B, C, H, W) float32, contiguous; out: (B, D*D, H, W) float32
// with D = 2*(maxd/s2) + 1.
extern "C" int correlation_fwd(const float* f1, const float* f2, float* out,
                               int B, int C, int H, int W, int maxd, int s2,
                               int device, void* stream) {
  int err = fnet_set_device(device);
  if (err) return err;
  const int D = 2 * (maxd / s2) + 1;
  const int tiles = (W + kTileW - 1) / kTileW;
  const size_t smem = sizeof(float) * kChunkC * (2 * kTileW + 2 * maxd);
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        correlation_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
  }
  const dim3 grid(tiles * D, H, B);
  correlation_fwd_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      f1, f2, out, C, H, W, maxd, s2, D);
  return static_cast<int>(cudaGetLastError());
}
