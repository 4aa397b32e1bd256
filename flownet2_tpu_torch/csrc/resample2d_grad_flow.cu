// K4: the bilinear flow warp's flow gradient, float32 or bfloat16, for F
// flows over one image.
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
// g (B, F, C, Ho, W), image (B, C, H, W), flows and d_flow (B, F, 2, Ho, W).
// As in K2 the flow may cover only the image rows [off, off + Ho) (the
// local-rows form, resample2d_pallas.py:533-540).
//
// Bound on an H100 SXM at FlowNet2's training shape (B 8, C 3, 384x448,
// one flow): ~25 flops per pixel and channel, so memory bounds it: g,
// image, flow and d_flow are 55.0 MB (~16.4 us at 3.35 TB/s).
//
// bfloat16 (entry point resample2d_grad_flow_bf16): the TPU kernel's bf16
// form (bf16 planes, resample2d_pallas.py:541-543): the flow is upcast for
// the coordinates, the cotangent and the corners are upcast (:324), the
// sums are float, and d_flow, which the TPU kernel returns in f32 and the
// JAX package casts to the flow's dtype (ops/resample2d.py:308-309), is
// rounded once to bfloat16.  At 2 bytes a value it moves ~27.5 MB for one
// flow.  Local rows as in float32.
//
// Design: one thread per output pixel and flow computes the corners once
// and sums over the channels in registers, so the reduction needs no
// shared memory and no atomics; g reads and d_flow writes are coalesced,
// the corner reads are gathers as in K2.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// T: the element type of g, the image, the flows and d_flow.  The values
// are upcast to float as they are read (fnet_load), the sums are float, and
// d_flow is rounded once at the store (fnet_store).
template <typename T, bool kRows>
__global__ void __launch_bounds__(kThreads)
resample2d_grad_flow_kernel(const T* __restrict__ g, const T* __restrict__ img,
                            const T* __restrict__ flows,
                            T* __restrict__ d_flows, int F, int C, int H,
                            int W, int ho_arg, int off_arg) {
  // whole image: Ho = H and off = 0 folded in, the code the kernel had
  // before it took local rows
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // g, flow and d_flow
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= oplane) return;
  const int bf = blockIdx.y;  // b * F + f
  const int b = bf / F;

  const FnetBilinear s =
      fnet_bilinear<T>(flows + static_cast<int64_t>(bf) * 2 * oplane, p, H, W,
                       Ho, off);
  const T* src = img + static_cast<int64_t>(b) * C * plane;
  const T* gp = g + static_cast<int64_t>(bf) * C * oplane + p;
  float ddx = 0.f, ddy = 0.f;
  for (int c = 0; c < C; ++c) {
    const T* i = src + c * plane;
    const float tl = fnet_load(i + s.tl), tr = fnet_load(i + s.tr);
    const float bl = fnet_load(i + s.bl), br = fnet_load(i + s.br);
    const float gv = fnet_load(gp + c * oplane);
    ddx += gv * ((1.f - s.b) * (tr - tl) + s.b * (br - bl));
    ddy += gv * ((1.f - s.a) * (bl - tl) + s.a * (br - tr));
  }
  T* d = d_flows + static_cast<int64_t>(bf) * 2 * oplane + p;
  fnet_store(d, ddx);
  fnet_store(d + oplane, ddy);
}

template <typename T, bool kRows>
int launch(const T* g, const T* img, const T* flows, T* d_flows, int B, int F,
           int C, int H, int W, int Ho, int off, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  const int64_t oplane = static_cast<int64_t>(Ho) * W;
  const dim3 grid(static_cast<unsigned>((oplane + kThreads - 1) / kThreads),
                  B * F);
  resample2d_grad_flow_kernel<T, kRows>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          g, img, flows, d_flows, F, C, H, W, Ho, off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (B, F, C, Ho, W); img: (B, C, H, W); flows, d_flows: (B, F, 2, Ho, W);
// all float32 and contiguous; output row r is image row r + off.
extern "C" int resample2d_grad_flow(const float* g, const float* img,
                                    const float* flows, float* d_flows, int B,
                                    int F, int C, int H, int W, int Ho,
                                    int off, int device, void* stream) {
  // a whole-image call keeps the kernel with Ho = H and off = 0 folded in
  if (Ho == H && off == 0)
    return launch<float, false>(g, img, flows, d_flows, B, F, C, H, W, Ho,
                                off, device, stream);
  return launch<float, true>(g, img, flows, d_flows, B, F, C, H, W, Ho, off,
                             device, stream);
}

// The same for a bfloat16 cotangent, image and flows, with a bfloat16
// d_flow: the float sums of the upcast values, rounded once; whole image or
// local rows, as resample2d_fwd_bf16.
extern "C" int resample2d_grad_flow_bf16(const __nv_bfloat16* g,
                                         const __nv_bfloat16* img,
                                         const __nv_bfloat16* flows,
                                         __nv_bfloat16* d_flows, int B, int F,
                                         int C, int H, int W, int Ho, int off,
                                         int device, void* stream) {
  if (Ho == H && off == 0)
    return launch<__nv_bfloat16, false>(g, img, flows, d_flows, B, F, C, H, W,
                                        Ho, off, device, stream);
  return launch<__nv_bfloat16, true>(g, img, flows, d_flows, B, F, C, H, W,
                                     Ho, off, device, stream);
}
