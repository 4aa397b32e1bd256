// K5 and K6: the correlation cost volume's gradient, float32.
//
// Replaces flownet2_tpu/ops/correlation_pallas.py: _bwd_f1_kernel and
// _bwd_f1_kernel_wide (K5, d_f1) and _bwd_f2_kernel and _bwd_f2_kernel_wide
// (K6, d_f2), reached from correlation_pallas_bwd through
// _correlation_pallas_bwd_impl.  Each kernel has no width limit, so one
// covers the narrow and the wide case.  With r = maxd / s2, D = 2r + 1,
// d = (tj+r)*D + (ti+r) and out-of-range terms zero:
//
//   K5: d_f1[b,c,y,x]   = (1/C) sum_{tj,ti} g[b,d,y,x] * f2[b,c,y+tj*s2,x+ti*s2]
//   K6: d_f2[b,c,y2,x2] = (1/C) sum_{tj,ti} g[b,d,y2-tj*s2,x2-ti*s2]
//                                          * f1[b,c,y2-tj*s2,x2-ti*s2]
//
// g is (B, D*D, H, W); f1, f2, d_f1, d_f2 are (B, C, H, W).  K=1, stride1=1,
// pad=maxd, as for K1 (correlation_fwd.cu).
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 256, H 48,
// W 56, maxd 20, s2 2 -> 441 channels): each kernel does 4.855 GFLOP of
// f32 multiply-adds against ~82 MB moved (g, one feature map in, one out),
// so the FMA rate (~67 TFLOP/s, ~72.5 us) bounds it, not the memory
// (~24.5 us).  The TPU kernels fed bf16 operands to the matrix unit; here
// operands and sums stay f32.
//
// Design: both kernels are gathers.  A block owns one output row, 64
// output columns and 32 channels, and loops over the D row shifts; every
// output element is summed by one thread in a fixed order, so there are no
// atomics and the result does not depend on the run (a scatter of d_f2
// with atomicAdd would).  For each row shift the block stages in shared
// memory the D cotangent channels of that shift and the one feature row it
// needs (64 + 2*maxd columns, 32 channels); thread (tx, grp) owns output
// column tx and the channels grp, grp+4, ..., grp+28, kept in registers
// across all shifts.  Per column shift a thread reads one cotangent value
// and reuses it for its 8 channels.  A warp reads 32 consecutive
// shared-memory words per step (no bank conflicts), and outputs are written
// as coalesced rows.  A row shift that falls wholly outside the image is
// skipped (the whole block agrees, so the barriers stay uniform).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTileW = 64;                   // output columns per block
constexpr int kGroups = 4;                   // thread groups over channels
constexpr int kThreads = kTileW * kGroups;   // 256
constexpr int kChunkC = 32;                  // channels per block
constexpr int kPerThread = kChunkC / kGroups;

// K5: d_f1.  Block (tile * chunks, y, b).  For row shift tj the f2 row is
// y + (tj - r)*s2; column shift ti reads f2 at span offset tx + ti*s2 +
// (maxd - r*s2), the span starting at column x0 - maxd.
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f1_kernel(const float* __restrict__ g,
                          const float* __restrict__ f2,
                          float* __restrict__ d_f1, int C, int H, int W,
                          int maxd, int s2, int D, int tiles) {
  extern __shared__ float smem[];
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
  const float* g_row = g + static_cast<int64_t>(b) * D * D * plane +
                       static_cast<int64_t>(y) * W;
  const float* f2_b = f2 + (static_cast<int64_t>(b) * C + c0) * plane;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y2 = y + (tj - r) * s2;
    if (y2 < 0 || y2 >= H) continue;
    for (int i = threadIdx.x; i < D * kTileW; i += kThreads) {
      const int ti = i / kTileW;
      const int col = x0 + i % kTileW;
      gs[i] = col < W ? g_row[static_cast<int64_t>(tj * D + ti) * plane + col]
                      : 0.f;
    }
    const float* f2_row = f2_b + static_cast<int64_t>(y2) * W;
    for (int i = threadIdx.x; i < kChunkC * span; i += kThreads) {
      const int c = i / span;
      const int col = xs + i % span;
      f2s[i] = (c < nc && col >= 0 && col < W)
                   ? f2_row[static_cast<int64_t>(c) * plane + col]
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
    float* out = d_f1 + (static_cast<int64_t>(b) * C + c0) * plane +
                 static_cast<int64_t>(y) * W + x;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = grp + k * kGroups;
      if (c < nc) out[c * plane] = acc[k] / static_cast<float>(C);
    }
  }
}

// K6: d_f2.  Block (tile * chunks, y2, b).  For row shift tj the source row
// is y = y2 - (tj - r)*s2; column shift ti reads g and f1 at source column
// x2 - (ti - r)*s2, at span offset tx + (maxd + r*s2) - ti*s2, the span
// starting at column x0 - maxd.
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f2_kernel(const float* __restrict__ g,
                          const float* __restrict__ f1,
                          float* __restrict__ d_f2, int C, int H, int W,
                          int maxd, int s2, int D, int tiles) {
  extern __shared__ float smem[];
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
  const float* g_b = g + static_cast<int64_t>(b) * D * D * plane;
  const float* f1_b = f1 + (static_cast<int64_t>(b) * C + c0) * plane;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y = y2 - (tj - r) * s2;
    if (y < 0 || y >= H) continue;
    const float* g_row = g_b + static_cast<int64_t>(tj * D) * plane +
                         static_cast<int64_t>(y) * W;
    for (int i = threadIdx.x; i < D * span; i += kThreads) {
      const int ti = i / span;
      const int col = xs + i % span;
      gs[i] = (col >= 0 && col < W)
                  ? g_row[static_cast<int64_t>(ti) * plane + col]
                  : 0.f;
    }
    const float* f1_row = f1_b + static_cast<int64_t>(y) * W;
    for (int i = threadIdx.x; i < kChunkC * span; i += kThreads) {
      const int c = i / span;
      const int col = xs + i % span;
      f1s[i] = (c < nc && col >= 0 && col < W)
                   ? f1_row[static_cast<int64_t>(c) * plane + col]
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
    float* out = d_f2 + (static_cast<int64_t>(b) * C + c0) * plane +
                 static_cast<int64_t>(y2) * W + x2;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = grp + k * kGroups;
      if (c < nc) out[c * plane] = acc[k] / static_cast<float>(C);
    }
  }
}

using BwdKernel = void (*)(const float*, const float*, float*, int, int, int,
                           int, int, int, int);

int launch(BwdKernel kernel, size_t smem, const float* g, const float* src,
           float* out, int B, int C, int H, int W, int maxd, int s2,
           int device, void* stream) {
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
  const dim3 grid(tiles * chunks, H, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, src, out, C, H, W, maxd, s2, D, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (B, D*D, H, W); f2, d_f1: (B, C, H, W); all float32 and contiguous,
// with D = 2*(maxd/s2) + 1.
extern "C" int correlation_bwd_f1(const float* g, const float* f2, float* d_f1,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  const int D = 2 * (maxd / s2) + 1;
  const size_t smem = sizeof(float) * (D * kTileW + kChunkC * (kTileW + 2 * maxd));
  return launch(correlation_bwd_f1_kernel, smem, g, f2, d_f1, B, C, H, W, maxd,
                s2, device, stream);
}

// g: (B, D*D, H, W); f1, d_f2: (B, C, H, W); all float32 and contiguous.
extern "C" int correlation_bwd_f2(const float* g, const float* f1, float* d_f2,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  const int D = 2 * (maxd / s2) + 1;
  const size_t smem = sizeof(float) * (D + kChunkC) * (kTileW + 2 * maxd);
  return launch(correlation_bwd_f2_kernel, smem, g, f1, d_f2, B, C, H, W, maxd,
                s2, device, stream);
}
