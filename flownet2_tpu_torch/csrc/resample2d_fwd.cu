// K2: bilinear flow warp, forward, float32 or bfloat16, for F flows over one
// image.
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
// bfloat16 (entry point resample2d_fwd_bf16): the TPU kernel's bf16 form
// (bf16 planes, pair-packed by _planes_pair_packed_bf16,
// resample2d_pallas.py:359-372, chosen at :385-387).  Its values, not its
// (L, R) lane packing: the flow is upcast to float for the coordinates, the
// four corners are upcast after the gather, the weights and the lerp are
// float, and the output is rounded once to bfloat16 (:239-259, :411).  At 2
// bytes a value the one-flow warp moves ~25 MB, the two-flow ~41 MB.
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

// T: the image's and the output's element type; TF: the flows'.  The
// corners are upcast to float after the gather, the weights and the lerp are
// float, and the output is rounded once at the store (fnet_load, fnet_store).
template <typename T, typename TF, bool kRows>
__global__ void __launch_bounds__(kThreads)
resample2d_fwd_kernel(const T* __restrict__ img, const TF* __restrict__ flows,
                      T* __restrict__ out, int F, int C, int H, int W,
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

  const T* src = img + static_cast<int64_t>(b) * C * plane;
  T* dst = out + static_cast<int64_t>(bf) * C * oplane + p;
  for (int c = 0; c < C; ++c) {
    const T* i = src + c * plane;
    fnet_store(dst + c * oplane,
               wTL * fnet_load(i + s.tl) + wTR * fnet_load(i + s.tr) +
                   wBL * fnet_load(i + s.bl) + wBR * fnet_load(i + s.br));
  }
}

template <typename T, typename TF, bool kRows>
int launch(const T* img, const TF* flows, T* out, int B, int F, int C, int H,
           int W, int Ho, int off, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t oplane = static_cast<int64_t>(Ho) * W;
  const dim3 grid(static_cast<unsigned>((oplane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_fwd_kernel<T, TF, kRows>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          img, flows, out, F, C, H, W, Ho, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, Ho, W); out: (B, F, C, Ho, W); all
// float32 and contiguous; output row r is image row r + off.
extern "C" int resample2d_fwd(const float* img, const float* flows, float* out,
                              int B, int F, int C, int H, int W, int Ho,
                              int off, int device, void* stream) {
  // a whole-image call keeps the kernel with Ho = H and off = 0 folded in
  if (Ho == H && off == 0)
    return launch<float, float, false>(img, flows, out, B, F, C, H, W, Ho,
                                       off, device, stream);
  return launch<float, float, true>(img, flows, out, B, F, C, H, W, Ho, off,
                                    device, stream);
}

// The same for a bfloat16 image, bfloat16 flows and a bfloat16 output: the
// float warp of the upcast image by the upcast flows, rounded once, over the
// whole image or its rows [off, off + Ho).  The offset joins the integer row
// before the upcast flow is added (fnet_bilinear), so a band's rows are the
// whole-image call's bits; the TPU band warp's _shift_dy, which adds it to
// the bf16 flow, would round it to whole rows at an offset of 128 or more.
extern "C" int resample2d_fwd_bf16(const __nv_bfloat16* img,
                                   const __nv_bfloat16* flows,
                                   __nv_bfloat16* out, int B, int F, int C,
                                   int H, int W, int Ho, int off, int device,
                                   void* stream) {
  if (Ho == H && off == 0)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        img, flows, out, B, F, C, H, W, Ho, off, device, stream);
  return launch<__nv_bfloat16, __nv_bfloat16, true>(
      img, flows, out, B, F, C, H, W, Ho, off, device, stream);
}
