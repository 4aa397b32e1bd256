// The correlation at the configurations no model uses: the cost volume and
// both gradients, float32, bfloat16 or half, at any (pad, kernel_size,
// max_displacement, stride1, stride2).
//
// Counterpart of flownet2_tpu/ops/correlation.py: the shifts form
// (_correlation_shifts, :60-117), which the JAX package runs for every
// configuration outside kernel_size 1, stride1 1, pad == max_displacement
// (its Pallas kernels' supported() refuses them, correlation_pallas.py:
// 64-69, so a TPU runs them through XLA), and jax.vjp of that form (the
// general branch of _corr_bwd, :253-260).  With
//
//   k_rad = (K - 1) / 2,  b_rad = k_rad + maxd,  r = maxd / s2,  D = 2r + 1
//   out_h = ceil((H + 2 pad - 2 b_rad) / s1), likewise out_w
//   nelems = K * K * C
//
//   out[b, (tj+r)*D + (ti+r), y, x] = 1/nelems * sum_{j,i} sum_c
//       f1[b, c, Y + j,         X + i]
//     * f2[b, c, Y + tj*s2 + j, X + ti*s2 + i]
//   with Y = y*s1 + b_rad - pad, X = x*s1 + b_rad - pad
//
// over the taps j, i in [-k_rad, k_rad] and the shifts tj, ti in [-r, r],
// both maps read as zero outside [0, H) x [0, W): the op's zero padding by
// pad is a bounds test here, not a padded copy.  The tap window is centred
// in bounds at y*s1 + b_rad, as the JAX package centres it (the reference
// kernel centres at y*s1 + maxd and reads out of bounds for K > 1).  An even
// K keeps the JAX package's taps and divisor: 2 k_rad + 1 taps a side, and
// nelems still K*K*C.  NCHW in, (B, D*D, out_h, out_w) out.
//
// The gradients are gathers: each input element sums, in one fixed order,
// every (tj, ti, j, i) whose output reads it, so two calls give the same
// bits (no atomics).  For d_f1 at (p, q) the output of tap (j, i) is
//
//   oy = (p + pad - b_rad - j) / s1,  ox = (q + pad - b_rad - i) / s1
//
// where the division is exact, oy in [0, out_h) and ox in [0, out_w), and
// it multiplies f2[p + tj*s2, q + ti*s2]; for d_f2 at (p, q) the same with
// p - tj*s2 and q - ti*s2 in place of p and q, multiplying f1 there.  The
// other operand's value depends on (tj, ti) alone: a thread loads it once
// for its channels and adds the products of the taps in order, the order
// in which the plain version correlation_cfg_bwd_plain accumulates them.
//
// Element types: loads go through fnet_load (bfloat16 and half upcast
// exactly), the sums are float32, and fnet_store rounds once (the plain
// versions in ops/correlation.py widen and round once likewise).
//
// Two bodies, each one template on the element type:
// * correlation_cfg_fwd_kernel: a block per (batch, output row, row shift,
//   32 output columns); for each tap row it stages the f1 and f2 rows the
//   tile reads, up to 32 channels at a time, as float in shared memory;
//   thread (tx, g) owns output column tx and the column shifts g, g + 8,
//   ...  A tap row whose f1 or f2 row lies outside the map adds nothing and
//   is skipped.
// * correlation_cfg_bwd_kernel<T, kF2>: a thread per input pixel and 16
//   channels; each (tj, ti) reads the 16 channels of the other operand
//   once into registers and the cotangent once at each tap whose output
//   exists.
//
// No speed work: these bodies serve configurations no model runs.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kFwdCols = 32;                          // output columns a block
constexpr int kFwdGroups = 8;                         // groups over col shifts
constexpr int kFwdThreads = kFwdCols * kFwdGroups;    // 256
constexpr int kFwdShifts = 8;                         // sums a thread and pass
constexpr int kFwdChunkC = 32;                        // channels staged, most
constexpr int kBwdThreads = 128;                      // input pixels a block
constexpr int kBwdChans = 16;                         // channels a thread

// The configuration and the sizes derived from it.
struct CorrCfg {
  int C, H, W, pad, maxd, s1, s2;
  int k_rad, taps, b_rad, r, D, out_h, out_w;
  float nelems;
};

inline int out_extent(int n, int pad, int b_rad, int s1) {
  const int span = n + 2 * pad - 2 * b_rad;
  return span > 0 ? (span + s1 - 1) / s1 : 0;
}

inline CorrCfg make_cfg(int C, int H, int W, int pad, int K, int maxd, int s1,
                        int s2) {
  CorrCfg p;
  p.C = C;
  p.H = H;
  p.W = W;
  p.pad = pad;
  p.maxd = maxd;
  p.s1 = s1;
  p.s2 = s2;
  p.k_rad = (K - 1) / 2;
  p.taps = 2 * p.k_rad + 1;
  p.b_rad = p.k_rad + maxd;
  p.r = maxd / s2;
  p.D = 2 * p.r + 1;
  p.out_h = out_extent(H, pad, p.b_rad, s1);
  p.out_w = out_extent(W, pad, p.b_rad, s1);
  p.nelems = static_cast<float>(K * K * C);
  return p;
}

// Whether the configuration is one the JAX package accepts: K, s1 and s2
// at least 1, pad and maxd not negative (the wrapper raises before).
inline bool valid_cfg(int K, int pad, int maxd, int s1, int s2) {
  return K >= 1 && s1 >= 1 && s2 >= 1 && pad >= 0 && maxd >= 0;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
correlation_cfg_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           T* __restrict__ out, CorrCfg p, int chunk,
                           int span1, int span2) {
  // float staging for every element type: an extern array of T would clash
  // between the bfloat16 and half instantiations
  extern __shared__ float smem[];
  float* f1s = smem;                  // [chunk][span1]
  float* f2s = smem + chunk * span1;  // [chunk][span2]

  const int tjx = blockIdx.x % p.D;   // row shift, as an index in [0, D)
  const int x0 = (blockIdx.x / p.D) * kFwdCols;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kFwdCols;
  const int g = threadIdx.x / kFwdCols;
  const int x = x0 + tx;
  const int tj = tjx - p.r;
  // the f1 column of the tile's first output column at tap -k_rad, and the
  // f2 column of that at shift -r: staged column 0 of each row
  const int col1 = x0 * p.s1 + p.b_rad - p.k_rad - p.pad;
  const int col2 = col1 - p.r * p.s2;

  const int64_t plane = static_cast<int64_t>(p.H) * p.W;
  const int64_t oplane = static_cast<int64_t>(p.out_h) * p.out_w;
  const T* f1_b = f1 + static_cast<int64_t>(b) * p.C * plane;
  const T* f2_b = f2 + static_cast<int64_t>(b) * p.C * plane;
  T* out_row = out + (static_cast<int64_t>(b) * p.D + tjx) * p.D * oplane +
               static_cast<int64_t>(y) * p.out_w;

  for (int ti0 = 0; ti0 < p.D; ti0 += kFwdGroups * kFwdShifts) {
    float acc[kFwdShifts];
#pragma unroll
    for (int k = 0; k < kFwdShifts; ++k) acc[k] = 0.f;

    for (int j = -p.k_rad; j <= p.k_rad; ++j) {
      const int r1 = y * p.s1 + p.b_rad + j - p.pad;
      const int r2 = r1 + tj * p.s2;
      // the same for the whole block: a row outside the map adds nothing
      if (r1 < 0 || r1 >= p.H || r2 < 0 || r2 >= p.H) continue;
      const T* f1_row = f1_b + static_cast<int64_t>(r1) * p.W;
      const T* f2_row = f2_b + static_cast<int64_t>(r2) * p.W;
      for (int c0 = 0; c0 < p.C; c0 += chunk) {
        const int nc = min(chunk, p.C - c0);
        for (int i = threadIdx.x; i < nc * span1; i += kFwdThreads) {
          const int c = i / span1;
          const int col = col1 + i % span1;
          f1s[i] = (col >= 0 && col < p.W)
                       ? fnet_load(f1_row + (c0 + c) * plane + col)
                       : 0.f;
        }
        for (int i = threadIdx.x; i < nc * span2; i += kFwdThreads) {
          const int c = i / span2;
          const int col = col2 + i % span2;
          f2s[i] = (col >= 0 && col < p.W)
                       ? fnet_load(f2_row + (c0 + c) * plane + col)
                       : 0.f;
        }
        __syncthreads();
        for (int c = 0; c < nc; ++c) {
          const float* a_row = f1s + c * span1 + tx * p.s1;
          const float* b_row = f2s + c * span2 + tx * p.s1;
          for (int i = 0; i < p.taps; ++i) {
            const float a = a_row[i];
#pragma unroll
            for (int k = 0; k < kFwdShifts; ++k) {
              const int tix = ti0 + g + k * kFwdGroups;
              if (tix < p.D) acc[k] = fmaf(a, b_row[i + tix * p.s2], acc[k]);
            }
          }
        }
        __syncthreads();
      }
    }

    if (x < p.out_w) {
#pragma unroll
      for (int k = 0; k < kFwdShifts; ++k) {
        const int tix = ti0 + g + k * kFwdGroups;
        if (tix < p.D)
          fnet_store(out_row + tix * oplane + x, acc[k] / p.nelems);
      }
    }
  }
}

// d_f1 (kF2 false: src is f2) or d_f2 (kF2 true: src is f1) for the
// cotangent g (B, D*D, out_h, out_w); grad and src are (B, C, H, W).
template <typename T, bool kF2>
__global__ void __launch_bounds__(kBwdThreads)
correlation_cfg_bwd_kernel(const T* __restrict__ g, const T* __restrict__ src,
                           T* __restrict__ grad, CorrCfg p) {
  const int64_t plane = static_cast<int64_t>(p.H) * p.W;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kBwdThreads +
                      threadIdx.x;
  if (pix >= plane) return;
  const int py = static_cast<int>(pix / p.W);
  const int px = static_cast<int>(pix % p.W);
  const int c0 = blockIdx.y * kBwdChans;
  const int nc = min(kBwdChans, p.C - c0);
  const int b = blockIdx.z;
  const int64_t oplane = static_cast<int64_t>(p.out_h) * p.out_w;
  const T* g_b = g + static_cast<int64_t>(b) * p.D * p.D * oplane;
  const T* src_b = src + (static_cast<int64_t>(b) * p.C + c0) * plane;

  float acc[kBwdChans];
#pragma unroll
  for (int k = 0; k < kBwdChans; ++k) acc[k] = 0.f;

  for (int tjx = 0; tjx < p.D; ++tjx) {
    const int dy = (tjx - p.r) * p.s2;
    // the other operand's row, and the row that the output's taps read
    const int sy = kF2 ? py - dy : py + dy;
    const int ry = kF2 ? py - dy : py;
    if (sy < 0 || sy >= p.H) continue;
    for (int tix = 0; tix < p.D; ++tix) {
      const int dx = (tix - p.r) * p.s2;
      const int sx = kF2 ? px - dx : px + dx;
      const int rx = kF2 ? px - dx : px;
      if (sx < 0 || sx >= p.W) continue;
      const T* g_d = g_b + (static_cast<int64_t>(tjx) * p.D + tix) * oplane;
      const T* s_px = src_b + static_cast<int64_t>(sy) * p.W + sx;
      float sv[kBwdChans];
#pragma unroll
      for (int k = 0; k < kBwdChans; ++k)
        sv[k] = k < nc ? fnet_load(s_px + k * plane) : 0.f;
      for (int j = -p.k_rad; j <= p.k_rad; ++j) {
        const int ty = ry + p.pad - p.b_rad - j;
        if (ty < 0 || ty % p.s1) continue;
        const int oy = ty / p.s1;
        if (oy >= p.out_h) continue;
        for (int i = -p.k_rad; i <= p.k_rad; ++i) {
          const int tx = rx + p.pad - p.b_rad - i;
          if (tx < 0 || tx % p.s1) continue;
          const int ox = tx / p.s1;
          if (ox >= p.out_w) continue;
          const float gv =
              fnet_load(g_d + static_cast<int64_t>(oy) * p.out_w + ox);
#pragma unroll
          for (int k = 0; k < kBwdChans; ++k) acc[k] = fmaf(gv, sv[k], acc[k]);
        }
      }
    }
  }
  T* grad_px = grad + (static_cast<int64_t>(b) * p.C + c0) * plane + pix;
#pragma unroll
  for (int k = 0; k < kBwdChans; ++k)
    if (k < nc) fnet_store(grad_px + k * plane, acc[k] / p.nelems);
}

template <typename T>
int launch_fwd(const T* f1, const T* f2, T* out, int B, int C, int H, int W,
               int pad, int K, int maxd, int s1, int s2, int device,
               void* stream) {
  if (!valid_cfg(K, pad, maxd, s1, s2))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = fnet_set_device(device);
  if (err) return err;
  const CorrCfg p = make_cfg(C, H, W, pad, K, maxd, s1, s2);
  if (B <= 0 || p.out_h <= 0 || p.out_w <= 0) return 0;  // nothing to write
  const int span1 = (kFwdCols - 1) * s1 + p.taps;
  const int span2 = span1 + 2 * p.r * s2;
  int optin = 0;
  err = static_cast<int>(cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  if (err) return err;
  const int per_channel = static_cast<int>(sizeof(float)) * (span1 + span2);
  const int chunk =
      std::min(kFwdChunkC, std::min(std::max(C, 1), optin / per_channel));
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = chunk * per_channel;
  if (smem > 48 * 1024) {
    err = static_cast<int>(cudaFuncSetAttribute(
        correlation_cfg_fwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (err) return err;
  }
  const int tiles = (p.out_w + kFwdCols - 1) / kFwdCols;
  const dim3 grid(tiles * p.D, p.out_h, B);
  correlation_cfg_fwd_kernel<T>
      <<<grid, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          f1, f2, out, p, chunk, span1, span2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kF2>
int launch_bwd(const T* g, const T* src, T* grad, int B, int C, int H, int W,
               int pad, int K, int maxd, int s1, int s2, int device,
               void* stream) {
  if (!valid_cfg(K, pad, maxd, s1, s2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = fnet_set_device(device);
  if (err) return err;
  const CorrCfg p = make_cfg(C, H, W, pad, K, maxd, s1, s2);
  const int64_t plane = static_cast<int64_t>(H) * W;
  if (B <= 0 || C <= 0 || plane <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((plane + kBwdThreads - 1) /
                                        kBwdThreads),
                  (C + kBwdChans - 1) / kBwdChans, B);
  correlation_cfg_bwd_kernel<T, kF2>
      <<<grid, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(g, src,
                                                                    grad, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The cost volume.  f1, f2: (B, C, H, W), contiguous; out: (B, D*D, out_h,
// out_w), all float32.  An empty output launches nothing.
extern "C" int correlation_cfg_fwd(const float* f1, const float* f2,
                                   float* out, int B, int C, int H, int W,
                                   int pad, int K, int maxd, int s1, int s2,
                                   int device, void* stream) {
  return launch_fwd<float>(f1, f2, out, B, C, H, W, pad, K, maxd, s1, s2,
                           device, stream);
}

// The same for bfloat16 f1 and f2 and a bfloat16 out: float32 sums of the
// upcast products, divided by nelems and rounded once.
extern "C" int correlation_cfg_fwd_bf16(const __nv_bfloat16* f1,
                                        const __nv_bfloat16* f2,
                                        __nv_bfloat16* out, int B, int C,
                                        int H, int W, int pad, int K, int maxd,
                                        int s1, int s2, int device,
                                        void* stream) {
  return launch_fwd<__nv_bfloat16>(f1, f2, out, B, C, H, W, pad, K, maxd, s1,
                                   s2, device, stream);
}

// The same for half f1, f2 and out.
extern "C" int correlation_cfg_fwd_fp16(const __half* f1, const __half* f2,
                                        __half* out, int B, int C, int H,
                                        int W, int pad, int K, int maxd,
                                        int s1, int s2, int device,
                                        void* stream) {
  return launch_fwd<__half>(f1, f2, out, B, C, H, W, pad, K, maxd, s1, s2,
                            device, stream);
}

// d_f1 for the cotangent g (B, D*D, out_h, out_w): reads f2 (B, C, H, W),
// writes d_f1 (B, C, H, W), every element; float32.
extern "C" int correlation_cfg_bwd_f1(const float* g, const float* f2,
                                      float* d_f1, int B, int C, int H, int W,
                                      int pad, int K, int maxd, int s1, int s2,
                                      int device, void* stream) {
  return launch_bwd<float, false>(g, f2, d_f1, B, C, H, W, pad, K, maxd, s1,
                                  s2, device, stream);
}

extern "C" int correlation_cfg_bwd_f1_bf16(const __nv_bfloat16* g,
                                           const __nv_bfloat16* f2,
                                           __nv_bfloat16* d_f1, int B, int C,
                                           int H, int W, int pad, int K,
                                           int maxd, int s1, int s2,
                                           int device, void* stream) {
  return launch_bwd<__nv_bfloat16, false>(g, f2, d_f1, B, C, H, W, pad, K,
                                          maxd, s1, s2, device, stream);
}

extern "C" int correlation_cfg_bwd_f1_fp16(const __half* g, const __half* f2,
                                           __half* d_f1, int B, int C, int H,
                                           int W, int pad, int K, int maxd,
                                           int s1, int s2, int device,
                                           void* stream) {
  return launch_bwd<__half, false>(g, f2, d_f1, B, C, H, W, pad, K, maxd, s1,
                                   s2, device, stream);
}

// d_f2 for the cotangent g: reads f1, writes d_f2, every element; float32.
extern "C" int correlation_cfg_bwd_f2(const float* g, const float* f1,
                                      float* d_f2, int B, int C, int H, int W,
                                      int pad, int K, int maxd, int s1, int s2,
                                      int device, void* stream) {
  return launch_bwd<float, true>(g, f1, d_f2, B, C, H, W, pad, K, maxd, s1,
                                 s2, device, stream);
}

extern "C" int correlation_cfg_bwd_f2_bf16(const __nv_bfloat16* g,
                                           const __nv_bfloat16* f1,
                                           __nv_bfloat16* d_f2, int B, int C,
                                           int H, int W, int pad, int K,
                                           int maxd, int s1, int s2,
                                           int device, void* stream) {
  return launch_bwd<__nv_bfloat16, true>(g, f1, d_f2, B, C, H, W, pad, K,
                                         maxd, s1, s2, device, stream);
}

extern "C" int correlation_cfg_bwd_f2_fp16(const __half* g, const __half* f1,
                                           __half* d_f2, int B, int C, int H,
                                           int W, int pad, int K, int maxd,
                                           int s1, int s2, int device,
                                           void* stream) {
  return launch_bwd<__half, true>(g, f1, d_f2, B, C, H, W, pad, K, maxd, s1,
                                  s2, device, stream);
}
