// K3: bilinear flow warp, forward, with the flow tangents, float32, for F
// flows over one image.
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
// sum_c g*d2).  Image (B, C, H, W), flows (B, F, 2, H, W); out, d1, d2
// (B, F, C, H, W).
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 3, 384x448):
// ~20 flops per output value, so memory bounds it: image, flow and three
// outputs are 77.1 MB for one flow (~23.0 us at 3.35 TB/s), 137.6 MB for
// two (~41.1 us).
//
// Design: K2's, with two more outputs.  One thread per output pixel and
// flow computes the corners once and loops over the channels, writing out,
// d1 and d2 as coalesced rows; the corner reads are gathers from an image
// that stays in L2 for all flows of a launch.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample2d_tangents_kernel(const float* __restrict__ img,
                           const float* __restrict__ flows,
                           float* __restrict__ out, float* __restrict__ d1,
                           float* __restrict__ d2, int F, int C, int H,
                           int W) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;

  const FnetBilinear s =
      fnet_bilinear(flows + static_cast<int64_t>(bf) * 2 * plane, p, H, W);
  const float wTL = (1.f - s.a) * (1.f - s.b);
  const float wTR = s.a * (1.f - s.b);
  const float wBL = (1.f - s.a) * s.b;
  const float wBR = s.a * s.b;

  const float* src = img + static_cast<int64_t>(b) * C * plane;
  const int64_t at = static_cast<int64_t>(bf) * C * plane + p;
  for (int c = 0; c < C; ++c) {
    const float* i = src + c * plane;
    const float tl = i[s.tl], tr = i[s.tr], bl = i[s.bl], br = i[s.br];
    const int64_t o = at + c * plane;
    out[o] = wTL * tl + wTR * tr + wBL * bl + wBR * br;
    d1[o] = (1.f - s.b) * (tr - tl) + s.b * (br - bl);
    d2[o] = (1.f - s.a) * (bl - tl) + s.a * (br - tr);
  }
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, H, W); out, d1, d2: (B, F, C, H, W);
// all float32 and contiguous.
extern "C" int resample2d_tangents(const float* img, const float* flows,
                                   float* out, float* d1, float* d2, int B,
                                   int F, int C, int H, int W, int device,
                                   void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_tangents_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      img, flows, out, d1, d2, F, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
