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
// weights not renormalised at the border (fnet_bilinear in common.cuh).
// Image (B, C, H, W), flows (B, F, 2, Ho, W), out (B, F, C, Ho, W).  The flow
// may cover only the image rows [off, off + Ho) (the local-rows form of the
// TPU kernels, resample2d_pallas.py:374-380, which a height-split warp
// runs per row band); Ho = H, off = 0 is the whole image.
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
// and are not carried over.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
resample2d_fwd_kernel(const float* __restrict__ img,
                      const float* __restrict__ flows,
                      float* __restrict__ out, int F, int C, int H, int W,
                      int ho_arg, int off_arg) {
  // whole image: Ho = H and off = 0 folded in, the code the kernel had
  // before it took local rows
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // flow and output
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= oplane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;

  const FnetBilinear s =
      fnet_bilinear(flows + static_cast<int64_t>(bf) * 2 * oplane, p, H, W, Ho,
                    off);
  const float wTL = (1.f - s.a) * (1.f - s.b);
  const float wTR = s.a * (1.f - s.b);
  const float wBL = (1.f - s.a) * s.b;
  const float wBR = s.a * s.b;

  const float* src = img + static_cast<int64_t>(b) * C * plane;
  float* dst = out + static_cast<int64_t>(bf) * C * oplane + p;
  for (int c = 0; c < C; ++c) {
    const float* i = src + c * plane;
    dst[c * oplane] = wTL * i[s.tl] + wTR * i[s.tr] + wBL * i[s.bl] +
                     wBR * i[s.br];
  }
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, Ho, W); out: (B, F, C, Ho, W); all
// float32 and contiguous; output row r is image row r + off.
extern "C" int resample2d_fwd(const float* img, const float* flows, float* out,
                              int B, int F, int C, int H, int W, int Ho,
                              int off, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t oplane = static_cast<int64_t>(Ho) * W;
  const dim3 grid(static_cast<unsigned>((oplane + kThreads - 1) / kThreads),
                  B * F);
  // a whole-image call keeps the kernel with Ho = H and off = 0 folded in
  if (Ho == H && off == 0) {
    resample2d_fwd_kernel<false>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            img, flows, out, F, C, H, W, Ho, off);
  } else {
    resample2d_fwd_kernel<true>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            img, flows, out, F, C, H, W, Ho, off);
  }
  return static_cast<int>(cudaGetLastError());
}
