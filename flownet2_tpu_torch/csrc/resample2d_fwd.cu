// K2: bilinear flow warp, forward, float32, for F flows over one image.
//
// Replaces flownet2_tpu/ops/resample2d_pallas.py: _fwd_kernel, reached from
// resample2d_bilinear_pallas (one flow) and resample2d_bilinear_pallas_multi
// (F flows over one image).  One launch covers all F flows.
//
//   xf = x + flow[b, f, 0, y, x],  yf = y + flow[b, f, 1, y, x]
//   x0 = floor(xf), a = xf - x0 (likewise y0, b)
//   out[b, f, c, y, x] = (1-a)(1-b) img[yT, xL] + a(1-b) img[yT, xR]
//                      + (1-a) b   img[yB, xL] + a b    img[yB, xR]
//
// with the corner indices x0, x0+1, y0, y0+1 clamped to the image and the
// weights not renormalised at the border (ops/resample2d.py in the JAX
// package).  Image (B, C, H, W), flows (B, F, 2, H, W), out (B, F, C, H, W).
//
// Bound on an H100 SXM at FlowNet2's shape (B 8, C 3, 384x512): the warp
// does ~10 flops per output value, so memory bounds it: ~50 MB moved for one
// flow (~15 us at 3.35 TB/s), ~82 MB for two (~24 us).
//
// Design: one thread per output pixel computes the coordinates, weights and
// the four clamped corner offsets once and loops over the channels.  Flow
// reads and output writes are coalesced; the corner reads are gathers that
// are nearly coalesced for smooth flow, and the image (19 MB at this shape)
// stays in the 50 MB L2 for both flows of a launch.  The TPU kernel's
// x-shifted planes and _fold_lr exist for lane-local gathers on that chip
// and are not carried over.  floorf (not an int cast, which truncates
// toward zero) gives the right corner for negative coordinates.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample2d_fwd_kernel(const float* __restrict__ img,
                      const float* __restrict__ flows,
                      float* __restrict__ out, int F, int C, int H, int W) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>(p / W);

  const float* flow = flows + static_cast<int64_t>(bf) * 2 * plane;
  const float xf = static_cast<float>(x) + flow[p];
  const float yf = static_cast<float>(y) + flow[plane + p];
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  const float a = xf - x0;
  const float bw = yf - y0;
  // Clamp in float first so a huge flow cannot overflow the int conversion;
  // the index clamps below give the same corners either way.
  const int xi = static_cast<int>(fminf(fmaxf(x0, -1.f), static_cast<float>(W)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, -1.f), static_cast<float>(H)));
  const int xL = min(max(xi, 0), W - 1);
  const int xR = min(max(xi + 1, 0), W - 1);
  const int yT = min(max(yi, 0), H - 1);
  const int yB = min(max(yi + 1, 0), H - 1);
  const int64_t iTL = static_cast<int64_t>(yT) * W + xL;
  const int64_t iTR = static_cast<int64_t>(yT) * W + xR;
  const int64_t iBL = static_cast<int64_t>(yB) * W + xL;
  const int64_t iBR = static_cast<int64_t>(yB) * W + xR;
  const float wTL = (1.f - a) * (1.f - bw);
  const float wTR = a * (1.f - bw);
  const float wBL = (1.f - a) * bw;
  const float wBR = a * bw;

  const float* src = img + static_cast<int64_t>(b) * C * plane;
  float* dst = out + static_cast<int64_t>(bf) * C * plane + p;
  for (int c = 0; c < C; ++c) {
    const float* s = src + c * plane;
    dst[c * plane] = wTL * s[iTL] + wTR * s[iTR] + wBL * s[iBL] + wBR * s[iBR];
  }
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, H, W); out: (B, F, C, H, W); all
// float32 and contiguous.
extern "C" int resample2d_fwd(const float* img, const float* flows, float* out,
                              int B, int F, int C, int H, int W, int device,
                              void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_fwd_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      img, flows, out, F, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
