// K5, K6 and K7 backward: the correlation cost volume's gradient, float32.
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

// K5: d_f1.  Block (tile * chunks, y, b).  For row shift tj the f2 row (of
// H2) is y + shift + (tj - r)*s2; column shift ti reads f2 at span offset
// tx + ti*s2 + (maxd - r*s2), the span starting at column x0 - maxd.
template <bool kSlab>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f1_kernel(const float* __restrict__ g,
                          const float* __restrict__ f2,
                          float* __restrict__ d_f1, int C, int H, int W,
                          int maxd, int s2, int D, int tiles) {
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
  const float* g_row = g + static_cast<int64_t>(b) * D * D * plane +
                       static_cast<int64_t>(y) * W;
  const float* f2_b = f2 + (static_cast<int64_t>(b) * C + c0) * plane2;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y2 = y + shift + (tj - r) * s2;
    if (y2 < 0 || y2 >= H2) continue;
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
                   ? f2_row[static_cast<int64_t>(c) * plane2 + col]
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

// K6: d_f2.  Block (tile * chunks, y2, b) with y2 over the H2 output rows.
// For row shift tj the source row (of H) is y = y2 - shift - (tj - r)*s2;
// column shift ti reads g and f1 at source column
// x2 - (ti - r)*s2, at span offset tx + (maxd + r*s2) - ti*s2, the span
// starting at column x0 - maxd.
template <bool kSlab>
__global__ void __launch_bounds__(kThreads)
correlation_bwd_f2_kernel(const float* __restrict__ g,
                          const float* __restrict__ f1,
                          float* __restrict__ d_f2, int C, int H, int W,
                          int maxd, int s2, int D, int tiles) {
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
  const float* g_b = g + static_cast<int64_t>(b) * D * D * plane;
  const float* f1_b = f1 + (static_cast<int64_t>(b) * C + c0) * plane;

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int tj = 0; tj < D; ++tj) {
    const int y = y2 - shift - (tj - r) * s2;
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
    const int64_t plane2 = static_cast<int64_t>(H2) * W;
    float* out = d_f2 + (static_cast<int64_t>(b) * C + c0) * plane2 +
                 static_cast<int64_t>(y2) * W + x2;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = grp + k * kGroups;
      if (c < nc) out[c * plane2] = acc[k] / static_cast<float>(C);
    }
  }
}

using BwdKernel = void (*)(const float*, const float*, float*, int, int, int,
                           int, int, int, int);

// ``rows`` is the output's row count: H for d_f1, H2 for d_f2.
int launch(BwdKernel kernel, size_t smem, const float* g, const float* src,
           float* out, int B, int C, int H, int W, int rows, int maxd, int s2,
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

}  // namespace

// K5.  g: (B, D*D, H, W); f2, d_f1: (B, C, H, W); all float32 and
// contiguous, with D = 2*(maxd/s2) + 1.
extern "C" int correlation_bwd_f1(const float* g, const float* f2, float* d_f1,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  return launch(correlation_bwd_f1_kernel<false>, smem_f1(maxd, s2), g, f2,
                d_f1, B, C, H, W, H, maxd, s2, device, stream);
}

// K6.  g: (B, D*D, H, W); f1, d_f2: (B, C, H, W); all float32 and contiguous.
extern "C" int correlation_bwd_f2(const float* g, const float* f1, float* d_f2,
                                  int B, int C, int H, int W, int maxd, int s2,
                                  int device, void* stream) {
  return launch(correlation_bwd_f2_kernel<false>, smem_f2(maxd, s2), g, f1,
                d_f2, B, C, H, W, H, maxd, s2, device, stream);
}

// K7 backward, d_f1.  g: (B, D*D, Hloc, W); slab: (B, C, Hloc + 2*maxd, W);
// d_f1: (B, C, Hloc, W); all float32 and contiguous.
extern "C" int correlation_bwd_f1_rows(const float* g, const float* slab,
                                       float* d_f1, int B, int C, int Hloc,
                                       int W, int maxd, int s2, int device,
                                       void* stream) {
  return launch(correlation_bwd_f1_kernel<true>, smem_f1(maxd, s2), g, slab,
                d_f1, B, C, Hloc, W, Hloc, maxd, s2, device, stream);
}

// K7 backward, d_slab.  g: (B, D*D, Hloc, W); f1: (B, C, Hloc, W); d_slab:
// (B, C, Hloc + 2*maxd, W), in slab coordinates; all float32 and contiguous.
extern "C" int correlation_bwd_f2_rows(const float* g, const float* f1,
                                       float* d_slab, int B, int C, int Hloc,
                                       int W, int maxd, int s2, int device,
                                       void* stream) {
  return launch(correlation_bwd_f2_kernel<true>, smem_f2(maxd, s2), g, f1,
                d_slab, B, C, Hloc, W, Hloc + 2 * maxd, maxd, s2, device,
                stream);
}
