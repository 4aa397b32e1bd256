// K4: the bilinear flow warp's flow gradient, float32, for F flows over
// one image.
//
// Replaces flownet2_tpu/ops/resample2d_pallas.py: _grad_flow_kernel,
// reached from resample2d_grad_flow_pallas in the backward of the generic
// warp (ops/resample2d.py _resample2d_bwd).  It recomputes the sample point
// (fnet_bilinear in common.cuh), as the reference CUDA backward does, and
// with the corner values iTL, iTR, iBL, iBR of channel c forms
//
//   d_flow[b,f,0,y,x] = sum_c g[b,f,c,y,x] ((1-b)(iTR - iTL) + b(iBR - iBL))
//   d_flow[b,f,1,y,x] = sum_c g[b,f,c,y,x] ((1-a)(iBL - iTL) + a(iBR - iTR))
//
// g (B, F, C, H, W), image (B, C, H, W), flows and d_flow (B, F, 2, H, W).
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 3, 384x448,
// one flow): ~25 flops per pixel and channel, so memory bounds it: g,
// image, flow and d_flow are 55.0 MB (~16.4 us at 3.35 TB/s).
//
// Design: one thread per output pixel and flow computes the corners once
// and sums over the channels in registers, so the reduction needs no
// shared memory and no atomics; g reads and d_flow writes are coalesced,
// the corner reads are gathers as in K2.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample2d_grad_flow_kernel(const float* __restrict__ g,
                            const float* __restrict__ img,
                            const float* __restrict__ flows,
                            float* __restrict__ d_flows, int F, int C, int H,
                            int W) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;

  const FnetBilinear s =
      fnet_bilinear(flows + static_cast<int64_t>(bf) * 2 * plane, p, H, W);
  const float* src = img + static_cast<int64_t>(b) * C * plane;
  const float* gp = g + static_cast<int64_t>(bf) * C * plane + p;
  float ddx = 0.f, ddy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* i = src + c * plane;
    const float tl = i[s.tl], tr = i[s.tr], bl = i[s.bl], br = i[s.br];
    const float gv = gp[c * plane];
    ddx += gv * ((1.f - s.b) * (tr - tl) + s.b * (br - bl));
    ddy += gv * ((1.f - s.a) * (bl - tl) + s.a * (br - tr));
  }
  float* d = d_flows + static_cast<int64_t>(bf) * 2 * plane + p;
  d[0] = ddx;
  d[plane] = ddy;
}

}  // namespace

// g: (B, F, C, H, W); img: (B, C, H, W); flows, d_flows: (B, F, 2, H, W);
// all float32 and contiguous.
extern "C" int resample2d_grad_flow(const float* g, const float* img,
                                    const float* flows, float* d_flows, int B,
                                    int F, int C, int H, int W, int device,
                                    void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_grad_flow_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      g, img, flows, d_flows, F, C, H, W);
  return static_cast<int>(cudaGetLastError());
}
