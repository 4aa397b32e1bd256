// K2: bilinear flow warp, forward, float32, bfloat16 or half, for F flows
// over one image.
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
// flow (~15 us at 3.35 TB/s), ~82 MB for two (~24 us).  The DRAM bytes are
// not what held the one-pixel-a-thread form back: for a flow that is not
// smooth, each lane's corners lie on rows of their own, so one gather
// touches a cache line a lane, and L1 spends a cycle on each.
//
// bfloat16 (entry point resample2d_fwd_bf16): the TPU kernel's bf16 form
// (bf16 planes, pair-packed by _planes_pair_packed_bf16,
// resample2d_pallas.py:359-372, chosen at :385-387).  Its values, not its
// (L, R) lane packing: the flow is upcast to float for the coordinates, the
// four corners are upcast after the gather, the weights and the lerp are
// float, and the output is rounded once to bfloat16 (:239-259, :411).  At 2
// bytes a value the one-flow warp moves ~25 MB, the two-flow ~41 MB.
//
// half (entry point resample2d_fwd_fp16): the bf16 form's rule on half
// values, the same row tiles (2-byte elements, so bf16's tile and window).
// The JAX package's fp16 warp is its XLA path, which casts the weights to
// the image's dtype and multiplies in fp16 (ops/resample2d.py:105-108); the
// port keeps its kernels' rule, float weights and one rounding.
//
// Design: row tiles (WarpTile, FnetWarpPixels in common.cuh).  A block
// covers 64 columns x 16 rows (float32) or 32 rows (bfloat16) of one flow;
// a thread owns 16 bytes of one output row (4 or 8 columns), reads its dx
// and dy by one 16-byte load each and stores each channel's values by one
// 16-byte store (narrower pieces where a row is not 16-byte aligned).  The
// block takes the box of its corners.  Where the box of all C channels
// fits in 30 KB (float32) or 24 KB (bfloat16), as a +-8 px flow's does at
// C = 3, the block stages it in shared memory and gathers there: a gather
// then costs a few bank conflicts, not a cache line a lane.  A block whose
// box does not fit (a wild flow), or is hardly larger than the tile (a
// flow that barely moves it, whose corners L1 serves well), gathers from
// the image through the read-only path; each launch asks for the smallest
// shared-memory carveout that holds its blocks, so that L1 stays large for
// those gathers.  This is the TPU kernel's idea (_block_sweep,
// resample2d_pallas.py:165-237, sweeps only the source blocks in a tile's
// corner box) with the box in shared memory; its x-shifted planes and
// _fold_lr exist for lane-local gathers on that chip and are not carried
// over.  Each output value is the arithmetic of the one-pixel-a-thread form
// (the sample point as fnet_bilinear computes it, the four weighted
// corners in the same order, with the fused multiply-adds its compiled
// code had spelled out), so both routes and every tile give its bits.

#include <cstdint>

#include "common.cuh"

namespace {

// T: the element type of the image, the flows and the output.  The corners
// are upcast to float after the gather, the weights and the lerp are float,
// and the output is rounded once at the store.
template <typename T, int kPiece, bool kRows>
__global__ void
__launch_bounds__(WarpTile<T>::kThreads, WarpTile<T>::kMinBlocks)
resample2d_fwd_kernel(const T* __restrict__ img, const T* __restrict__ flows,
                      T* __restrict__ out, int F, int C, int H, int W,
                      int ho_arg, int off_arg) {
  using Tile = WarpTile<T>;
  constexpr int kV = Tile::kV;
  __shared__ __align__(16) unsigned char raw[Tile::kWindowBytes];
  __shared__ int slots[Tile::kWarps][4];
  T* buf = reinterpret_cast<T*>(raw);
  // whole image: Ho = H and off = 0 folded in
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // flow and output
  const int bf = blockIdx.z;  // b * F + f
  const T* src = img + static_cast<int64_t>(bf / F) * C * plane;

  FnetWarpPixels<T, kPiece> px;
  const FnetWindow w = px.setup(flows + static_cast<int64_t>(bf) * 2 * oplane,
                                slots, C, H, W, Ho, off);
  // the weights, and each value's chain as the one-pixel-a-thread form's
  // code compiled to: wTR*tr, then tl, bl and br fused in that order
  float wTL[kV], wTR[kV], wBL[kV], wBR[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float a = px.a[i], b = px.b[i];
    wTL[i] = __fmul_rn(1.f - a, 1.f - b);
    wTR[i] = __fmul_rn(a, 1.f - b);
    wBL[i] = __fmul_rn(1.f - a, b);
    wBR[i] = __fmul_rn(a, b);
  }
  T* dst = out + static_cast<int64_t>(bf) * C * oplane + px.r * W + px.x;
  // channel c's values from its plane ``p``: the window's in shared memory,
  // or the image's (global)
  const auto lerp = [&](auto global, const T* p, int c) {
    float v[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float tl, tr, bl, br;
      px.template corners<decltype(global)::value>(p, w.pitch, i, tl, tr, bl,
                                                    br);
      const float top = __fmaf_rn(wTL[i], tl, __fmul_rn(wTR[i], tr));
      v[i] = __fmaf_rn(wBR[i], br, __fmaf_rn(wBL[i], bl, top));
    }
#pragma unroll
    for (int j = 0; j < kV / kPiece; ++j)
      if (px.valid(j, W))
        fnet_store_piece<kPiece>(dst + c * oplane + j * kPiece,
                                 v + j * kPiece);
  };
  if (w.shared) {
    px.stage(buf, src, w, C, H, W);
    for (int c = 0; c < C; ++c)
      lerp(std::false_type(), buf + c * w.rows * w.pitch, c);
  } else {
    for (int c = 0; c < C; ++c) lerp(std::true_type(), src + c * plane, c);
  }
}

template <typename T, int kPiece, bool kRows>
int launch_piece(const T* img, const T* flows, T* out, int B, int F, int C,
                 int H, int W, int Ho, int off, cudaStream_t stream) {
  using Tile = WarpTile<T>;
  const auto kernel = resample2d_fwd_kernel<T, kPiece, kRows>;
  // as much L1 as the blocks' windows leave, for the global route
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      fnet_warp_carveout<T>()));
  if (err) return err;
  const dim3 grid((W + Tile::kCols - 1) / Tile::kCols,
                  (Ho + Tile::kTileRows - 1) / Tile::kTileRows, B * F);
  kernel<<<grid, Tile::kThreads, 0, stream>>>(img, flows, out, F, C, H, W, Ho,
                                              off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRows>
int launch(const T* img, const T* flows, T* out, int B, int F, int C, int H,
           int W, int Ho, int off, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  // offsets within one image plane, times 4, are int (FnetWarpPixels)
  if (static_cast<int64_t>(H) * W > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fnet_piece<T>(W, {img, flows, out})) {
    case WarpTile<T>::kV:
      return launch_piece<T, WarpTile<T>::kV, kRows>(img, flows, out, B, F, C,
                                                     H, W, Ho, off, s);
    case 2:
      return launch_piece<T, 2, kRows>(img, flows, out, B, F, C, H, W, Ho,
                                       off, s);
    default:
      return launch_piece<T, 1, kRows>(img, flows, out, B, F, C, H, W, Ho,
                                       off, s);
  }
}

}  // namespace

// img: (B, C, H, W); flows: (B, F, 2, Ho, W); out: (B, F, C, Ho, W); all
// float32 and contiguous; output row r is image row r + off.
extern "C" int resample2d_fwd(const float* img, const float* flows, float* out,
                              int B, int F, int C, int H, int W, int Ho,
                              int off, int device, void* stream) {
  // a whole-image call keeps the kernel with Ho = H and off = 0 folded in
  if (Ho == H && off == 0)
    return launch<float, false>(img, flows, out, B, F, C, H, W, Ho, off,
                                device, stream);
  return launch<float, true>(img, flows, out, B, F, C, H, W, Ho, off, device,
                             stream);
}

// The same for a bfloat16 image, bfloat16 flows and a bfloat16 output: the
// float warp of the upcast image by the upcast flows, rounded once, over the
// whole image or its rows [off, off + Ho).  The offset joins the integer row
// before the upcast flow is added, so a band's rows are the whole-image
// call's bits; the TPU band warp's _shift_dy, which adds it to the bf16
// flow, would round it to whole rows at an offset of 128 or more.
extern "C" int resample2d_fwd_bf16(const __nv_bfloat16* img,
                                   const __nv_bfloat16* flows,
                                   __nv_bfloat16* out, int B, int F, int C,
                                   int H, int W, int Ho, int off, int device,
                                   void* stream) {
  if (Ho == H && off == 0)
    return launch<__nv_bfloat16, false>(img, flows, out, B, F, C, H, W, Ho,
                                        off, device, stream);
  return launch<__nv_bfloat16, true>(img, flows, out, B, F, C, H, W, Ho, off,
                                     device, stream);
}

// The same for a half image, half flows and a half output: the float warp
// of the upcast image by the upcast flows, rounded once, over the whole
// image or its rows [off, off + Ho), as resample2d_fwd_bf16.
extern "C" int resample2d_fwd_fp16(const __half* img, const __half* flows,
                                   __half* out, int B, int F, int C, int H,
                                   int W, int Ho, int off, int device,
                                   void* stream) {
  if (Ho == H && off == 0)
    return launch<__half, false>(img, flows, out, B, F, C, H, W, Ho, off,
                                 device, stream);
  return launch<__half, true>(img, flows, out, B, F, C, H, W, Ho, off,
                              device, stream);
}
