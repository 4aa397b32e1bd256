// K3: bilinear flow warp, forward, with the flow tangents, float32 or
// bfloat16, for F flows over one image.
//
// Replaces flownet2_tpu/ops/resample2d_pallas.py: _fwd_tangents_kernel,
// reached from resample2d_bilinear_tangents_pallas,
// resample2d_bilinear_tangents_cm (one flow) and
// resample2d_bilinear_tangents_cm_multi (F flows).  One launch covers all F
// flows.  With K2's sample point (fnet_bilinear in common.cuh) and corner
// values iTL, iTR, iBL, iBR of channel c:
//
//   out[b,f,c,y,x] = (1-a)(1-b) iTL + a(1-b) iTR + (1-a) b iBL + a b iBR
//   d1[b,f,c,y,x]  = d out / d dx = (1-b)(iTR - iTL) + b(iBR - iBL)
//   d2[b,f,c,y,x]  = d out / d dy = (1-a)(iBL - iTL) + a(iBR - iTR)
//
// so the training backward is the elementwise d_flow = (sum_c g*d1,
// sum_c g*d2).  Image (B, C, H, W), flows (B, F, 2, Ho, W); out, d1, d2
// (B, F, C, Ho, W).  As in K2 the flow may cover only the image rows
// [off, off + Ho) (the local-rows form, resample2d_pallas.py:424-430).
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 3, 384x448):
// ~20 flops per output value, so memory bounds it: image, flow and three
// outputs are 77.1 MB for one flow (~23.0 us at 3.35 TB/s), 137.6 MB for
// two (~41.1 us).
//
// bfloat16 (entry point resample2d_tangents_bf16): the TPU kernel's bf16
// form (bf16 planes, resample2d_pallas.py:431-433): the flow is upcast for
// the coordinates, the corners are upcast after the gather, the weights,
// the lerp and the tangents are float; out is rounded once to bfloat16, and
// d1 and d2 stay float32, as the TPU kernel returns them (:458-463), so the
// backward's sum of g*d1 loses nothing to them.  One flow moves ~55 MB.
// Local rows as in float32.
//
// Design: K2's, with two more outputs.  One thread per output pixel and
// flow computes the corners once and loops over the channels, writing out,
// d1 and d2 as coalesced rows; the corner reads are gathers from an image
// that stays in L2 for all flows of a launch.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// T: the element type of the image, the flows and out; d1 and d2 are
// float.  The corners are upcast after the gather (fnet_load) and out is
// rounded once at the store (fnet_store).
template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads)
resample2d_tangents_kernel(const T* __restrict__ img,
                           const T* __restrict__ flows, T* __restrict__ out,
                           float* __restrict__ d1, float* __restrict__ d2,
                           int F, int C, int H, int W, int ho_arg,
                           int off_arg) {
  // whole image: Ho = H and off = 0 folded in, the code the kernel had
  // before it took local rows
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // flow and outputs
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= oplane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;

  const FnetBilinear s =
      fnet_bilinear<T>(flows + static_cast<int64_t>(bf) * 2 * oplane, p, H, W,
                       Ho, off);
  const float wTL = (1.f - s.a) * (1.f - s.b);
  const float wTR = s.a * (1.f - s.b);
  const float wBL = (1.f - s.a) * s.b;
  const float wBR = s.a * s.b;

  const T* src = img + static_cast<int64_t>(b) * C * plane;
  const int64_t at = static_cast<int64_t>(bf) * C * oplane + p;
  for (int c = 0; c < C; ++c) {
    const T* i = src + c * plane;
    const float tl = fnet_load(i + s.tl), tr = fnet_load(i + s.tr);
    const float bl = fnet_load(i + s.bl), br = fnet_load(i + s.br);
    const int64_t o = at + c * oplane;
    fnet_store(out + o, wTL * tl + wTR * tr + wBL * bl + wBR * br);
    d1[o] = (1.f - s.b) * (tr - tl) + s.b * (br - bl);
    d2[o] = (1.f - s.a) * (bl - tl) + s.a * (br - tr);
  }
}

template <typename T, bool kRows>
int launch(const T* img, const T* flows, T* out, float* d1, float* d2, int B,
           int F, int C, int H, int W, int Ho, int off, int device,
           void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t oplane = static_cast<int64_t>(Ho) * W;
  const dim3 grid(static_cast<unsigned>((oplane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_tangents_kernel<T, kRows>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          img, flows, out, d1, d2, F, C, H, W, Ho, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, Ho, W); out, d1, d2: (B, F, C, Ho, W);
// all float32 and contiguous; output row r is image row r + off.
extern "C" int resample2d_tangents(const float* img, const float* flows,
                                   float* out, float* d1, float* d2, int B,
                                   int F, int C, int H, int W, int Ho, int off,
                                   int device, void* stream) {
  // a whole-image call keeps the kernel with Ho = H and off = 0 folded in
  if (Ho == H && off == 0)
    return launch<float, false>(img, flows, out, d1, d2, B, F, C, H, W, Ho,
                                off, device, stream);
  return launch<float, true>(img, flows, out, d1, d2, B, F, C, H, W, Ho, off,
                             device, stream);
}

// The same for a bfloat16 image and flows: out (B, F, C, Ho, W) bfloat16,
// rounded once; d1, d2 float32; whole image or local rows, as
// resample2d_fwd_bf16.
extern "C" int resample2d_tangents_bf16(const __nv_bfloat16* img,
                                        const __nv_bfloat16* flows,
                                        __nv_bfloat16* out, float* d1,
                                        float* d2, int B, int F, int C, int H,
                                        int W, int Ho, int off, int device,
                                        void* stream) {
  if (Ho == H && off == 0)
    return launch<__nv_bfloat16, false>(img, flows, out, d1, d2, B, F, C, H,
                                        W, Ho, off, device, stream);
  return launch<__nv_bfloat16, true>(img, flows, out, d1, d2, B, F, C, H, W,
                                     Ho, off, device, stream);
}
