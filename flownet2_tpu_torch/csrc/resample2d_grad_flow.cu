// K4: the bilinear flow warp's flow gradient, float32 or bfloat16, for F
// flows over one image.
//
// Replaces flownet2_tpu/ops/resample2d_pallas.py: _grad_flow_kernel,
// reached from resample2d_grad_flow_pallas in the backward of the generic
// warp (ops/resample2d.py _resample2d_bwd).  It recomputes the sample point
// (fnet_bilinear's arithmetic), as the reference CUDA backward does, and
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
// Design: K2's row tiles (WarpTile, FnetWarpPixels in common.cuh): the
// same mapping, sample points, routes (the window of the corners in shared
// memory, or the image in global memory) and 16-byte pieces; a thread
// reads its cotangent by 16-byte loads, sums over the channels in registers
// (no shared memory for the reduction, no atomics) and stores its two
// d_flow planes by one 16-byte store each.  The sums are those of the
// one-pixel-a-thread form, term by term and in channel order, with the
// fused multiply-adds its compiled code had spelled out, so every tile and
// both routes give its bits.

#include <cstdint>

#include "common.cuh"

namespace {

// T: the element type of g, the image, the flows and d_flow.  The values
// are upcast to float as they are read, the sums are float, and d_flow is
// rounded once at the store.
template <typename T, int kPiece, bool kRows>
__global__ void
__launch_bounds__(WarpTile<T>::kThreads, WarpTile<T>::kMinBlocks)
resample2d_grad_flow_kernel(const T* __restrict__ g, const T* __restrict__ img,
                            const T* __restrict__ flows,
                            T* __restrict__ d_flows, int F, int C, int H,
                            int W, int ho_arg, int off_arg) {
  using Tile = WarpTile<T>;
  constexpr int kV = Tile::kV;
  __shared__ __align__(16) unsigned char raw[Tile::kWindowBytes];
  __shared__ int slots[Tile::kWarps][4];
  T* buf = reinterpret_cast<T*>(raw);
  // whole image: Ho = H and off = 0 folded in
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // g, flow and d_flow
  const int bf = blockIdx.z;  // b * F + f
  const T* src = img + static_cast<int64_t>(bf / F) * C * plane;

  FnetWarpPixels<T, kPiece> px;
  const FnetWindow w = px.setup(flows + static_cast<int64_t>(bf) * 2 * oplane,
                                slots, C, H, W, Ho, off);
  const int at = px.r * W + px.x;
  const T* gp = g + static_cast<int64_t>(bf) * C * oplane + at;
  float ddx[kV], ddy[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) ddx[i] = ddy[i] = 0.f;
  // channel c's terms from its plane ``p`` (the window's in shared memory,
  // or the image's: global), each sum's chain as the one-pixel-a-thread
  // form's code compiled to: (1-b)(iTR - iTL) fused onto b(iBR - iBL), then
  // fused onto the sum (likewise for dy)
  const auto sums = [&](auto global, const T* p, int c) {
    float gv[kV];
#pragma unroll
    for (int j = 0; j < kV / kPiece; ++j) {
      if (px.valid(j, W))
        fnet_load_piece<kPiece>(gv + j * kPiece, gp + c * oplane + j * kPiece);
      else
        for (int i = 0; i < kPiece; ++i) gv[j * kPiece + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float tl, tr, bl, br;
      px.template corners<decltype(global)::value>(p, w.pitch, i, tl, tr, bl,
                                                    br);
      const float a = px.a[i], b = px.b[i];
      const float sx = __fmaf_rn(1.f - b, tr - tl, __fmul_rn(b, br - bl));
      const float sy = __fmaf_rn(1.f - a, bl - tl, __fmul_rn(a, br - tr));
      ddx[i] = __fmaf_rn(sx, gv[i], ddx[i]);
      ddy[i] = __fmaf_rn(gv[i], sy, ddy[i]);
    }
  };
  if (w.shared) {
    px.stage(buf, src, w, C, H, W);
    for (int c = 0; c < C; ++c)
      sums(std::false_type(), buf + c * w.rows * w.pitch, c);
  } else {
    for (int c = 0; c < C; ++c) sums(std::true_type(), src + c * plane, c);
  }
  T* d = d_flows + static_cast<int64_t>(bf) * 2 * oplane + at;
#pragma unroll
  for (int j = 0; j < kV / kPiece; ++j) {
    if (px.valid(j, W)) {
      fnet_store_piece<kPiece>(d + j * kPiece, ddx + j * kPiece);
      fnet_store_piece<kPiece>(d + oplane + j * kPiece, ddy + j * kPiece);
    }
  }
}

template <typename T, int kPiece, bool kRows>
int launch_piece(const T* g, const T* img, const T* flows, T* d_flows, int B,
                 int F, int C, int H, int W, int Ho, int off,
                 cudaStream_t stream) {
  using Tile = WarpTile<T>;
  const auto kernel = resample2d_grad_flow_kernel<T, kPiece, kRows>;
  // as much L1 as the blocks' windows leave, for the global route
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      fnet_warp_carveout<T>()));
  if (err) return err;
  const dim3 grid((W + Tile::kCols - 1) / Tile::kCols,
                  (Ho + Tile::kTileRows - 1) / Tile::kTileRows, B * F);
  kernel<<<grid, Tile::kThreads, 0, stream>>>(g, img, flows, d_flows, F, C, H,
                                              W, Ho, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRows>
int launch(const T* g, const T* img, const T* flows, T* d_flows, int B, int F,
           int C, int H, int W, int Ho, int off, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  // offsets within one image plane, times 4, are int (FnetWarpPixels)
  if (static_cast<int64_t>(H) * W > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fnet_piece<T>(W, {g, img, flows, d_flows})) {
    case WarpTile<T>::kV:
      return launch_piece<T, WarpTile<T>::kV, kRows>(
          g, img, flows, d_flows, B, F, C, H, W, Ho, off, s);
    case 2:
      return launch_piece<T, 2, kRows>(g, img, flows, d_flows, B, F, C, H, W,
                                       Ho, off, s);
    default:
      return launch_piece<T, 1, kRows>(g, img, flows, d_flows, B, F, C, H, W,
                                       Ho, off, s);
  }
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
