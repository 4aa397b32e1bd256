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
// Design: K2's row tiles (WarpTile, FnetWarpPixels in common.cuh), with
// three outputs a channel.  A block covers 64 columns x 16 rows (float32)
// or 32 rows (bfloat16) of one flow; a thread owns 16 bytes of one output
// row (4 or 8 columns), reads its dx and dy by one 16-byte load each, and
// takes the block's route: the window of its corners staged in shared
// memory where it fits, the image in global memory otherwise.  The outputs
// are 64% of the bytes (49.5 of 77.1 MB for one float32 flow), so the
// stores come first: for each channel a thread stores out as one 16-byte
// piece of T and d1 and d2 as whole 32-byte sectors of float.  A float32
// thread's 4 columns of d1 are one 16-byte store, its warp's stores
// contiguous.  A bfloat16 thread's 8 columns are 32 bytes of float, and
// two 16-byte stores of them would each write half of every sector they
// touch (so built, the bfloat16 form ran no faster on an H100 than the
// one-pixel-a-thread form): two neighbouring threads swap halves by a
// shuffle, so that each store writes whole sectors (fnet_store_pair).
// Where a row is not 16-byte aligned, pieces of 2 elements, else 1, as
// K2, each piece stored as soon as its pixels are computed.  Each
// value is the one-pixel-a-thread form's arithmetic (the sample point as
// fnet_bilinear computes it, the weights, and the fused multiply-adds its
// compiled code had, spelled out), so both routes and every tile give its
// bits.

#include <cstdint>

#include "common.cuh"

namespace {

// out, d1 and d2 of one pixel at the fractional offsets (a, b) from its
// corners, each chain as the one-pixel-a-thread form's code compiled to:
// out as K2's (wTR*tr, then tl, bl and br fused in that order), d1 and d2
// as K4's sums ((1-b)(iTR - iTL) fused onto b(iBR - iBL); likewise d2).
static __device__ __forceinline__ void fnet_tangents(float a, float b,
                                                     float tl, float tr,
                                                     float bl, float br,
                                                     float& out, float& d1,
                                                     float& d2) {
  const float wTL = __fmul_rn(1.f - a, 1.f - b);
  const float wTR = __fmul_rn(a, 1.f - b);
  const float wBL = __fmul_rn(1.f - a, b);
  const float wBR = __fmul_rn(a, b);
  const float top = __fmaf_rn(wTL, tl, __fmul_rn(wTR, tr));
  out = __fmaf_rn(wBR, br, __fmaf_rn(wBL, bl, top));
  d1 = __fmaf_rn(1.f - b, tr - tl, __fmul_rn(b, br - bl));
  d2 = __fmaf_rn(1.f - a, bl - tl, __fmul_rn(a, br - tr));
}

// The 8 tangents of one thread (8 columns, 32 bytes of float) stored by
// the pair of threads that owns 16 consecutive columns of a row (threads
// 2m and 2m + 1 of a bfloat16 tile): the first store writes the even
// thread's 32 bytes, the second the odd thread's, each thread 16 bytes of
// them, so that each store fills whole 32-byte sectors; a thread storing
// its own 32 bytes as two 16-byte pieces would write half of each sector
// twice.  ``mine`` and ``theirs``: whether this thread's columns and its
// partner's lie in the row.  Every thread of the warp calls it.
static __device__ __forceinline__ void fnet_store_pair(float* p,
                                                       const float (&t)[8],
                                                       bool mine,
                                                       bool theirs) {
  const bool odd = threadIdx.x & 1;
  float first[4], second[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // the even thread hands over its upper half, the odd its lower
    const float got =
        __shfl_xor_sync(0xffffffffu, odd ? t[k] : t[4 + k], 1);
    first[k] = odd ? got : t[k];
    second[k] = odd ? t[4 + k] : got;
  }
  if (odd ? theirs : mine) fnet_store_piece<4>(p + (odd ? -4 : 0), first);
  if (odd ? mine : theirs) fnet_store_piece<4>(p + (odd ? 4 : 8), second);
}

// T: the element type of the image, the flows and out; d1 and d2 are
// float.  The corners are upcast to float after the gather, the weights,
// the lerp and the tangents are float, and out is rounded once at the
// store.
template <typename T, int kPiece, bool kRows>
__global__ void
__launch_bounds__(WarpTile<T>::kThreads, WarpTile<T>::kMinBlocks)
resample2d_tangents_kernel(const T* __restrict__ img,
                           const T* __restrict__ flows, T* __restrict__ out,
                           float* __restrict__ d1, float* __restrict__ d2,
                           int F, int C, int H, int W, int ho_arg,
                           int off_arg) {
  using Tile = WarpTile<T>;
  constexpr int kV = Tile::kV;
  // the tangents' stores: a piece of float (16 bytes at most) a thread, or
  // by thread pairs in a bfloat16 tile of 16-byte pieces, whose piece of
  // tangents is 32 bytes (fnet_store_pair)
  constexpr bool kPairs = kPiece == 8;
  __shared__ __align__(16) unsigned char raw[Tile::kWindowBytes];
  __shared__ int slots[Tile::kWarps][4];
  T* buf = reinterpret_cast<T*>(raw);
  // whole image: Ho = H and off = 0 folded in
  const int Ho = kRows ? ho_arg : H;
  const int off = kRows ? off_arg : 0;
  const int64_t plane = static_cast<int64_t>(H) * W;    // image
  const int64_t oplane = static_cast<int64_t>(Ho) * W;  // flow and outputs
  const int bf = blockIdx.z;  // b * F + f
  const T* src = img + static_cast<int64_t>(bf / F) * C * plane;

  FnetWarpPixels<T, kPiece> px;
  const FnetWindow w = px.setup(flows + static_cast<int64_t>(bf) * 2 * oplane,
                                slots, C, H, W, Ho, off);
  const int64_t at =
      static_cast<int64_t>(bf) * C * oplane + px.r * W + px.x;
  // channel c's values from its plane ``p``: the window's in shared memory,
  // or the image's (global)
  const auto channel = [&](auto global, const T* p, int c) {
    const int64_t o = at + c * oplane;
    float v[kV];
    if constexpr (kPairs) {
      float t1[kV], t2[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        float tl, tr, bl, br;
        px.template corners<decltype(global)::value>(p, w.pitch, i, tl, tr,
                                                      bl, br);
        fnet_tangents(px.a[i], px.b[i], tl, tr, bl, br, v[i], t1[i], t2[i]);
      }
      const bool mine = px.valid(0, W);
      const bool theirs =
          px.live && px.x + (threadIdx.x & 1 ? -kV : kV) < W;
      if (mine) fnet_store_piece<kPiece>(out + o, v);
      fnet_store_pair(d1 + o, t1, mine, theirs);
      fnet_store_pair(d2 + o, t2, mine, theirs);
    } else {
      // each piece's values stored as soon as its pixels are computed
#pragma unroll
      for (int j = 0; j < kV / kPiece; ++j) {
        float t1[kPiece], t2[kPiece];
#pragma unroll
        for (int e = 0; e < kPiece; ++e) {
          const int i = j * kPiece + e;
          float tl, tr, bl, br;
          px.template corners<decltype(global)::value>(p, w.pitch, i, tl,
                                                        tr, bl, br);
          fnet_tangents(px.a[i], px.b[i], tl, tr, bl, br, v[i], t1[e],
                        t2[e]);
        }
        if (px.valid(j, W)) {
          const int64_t q = o + j * kPiece;
          fnet_store_piece<kPiece>(out + q, v + j * kPiece);
          fnet_store_piece<kPiece>(d1 + q, t1);
          fnet_store_piece<kPiece>(d2 + q, t2);
        }
      }
    }
  };
  if (w.shared) {
    px.stage(buf, src, w, C, H, W);
    for (int c = 0; c < C; ++c)
      channel(std::false_type(), buf + c * w.rows * w.pitch, c);
  } else {
    for (int c = 0; c < C; ++c) channel(std::true_type(), src + c * plane, c);
  }
}

template <typename T, int kPiece, bool kRows>
int launch_piece(const T* img, const T* flows, T* out, float* d1, float* d2,
                 int B, int F, int C, int H, int W, int Ho, int off,
                 cudaStream_t stream) {
  using Tile = WarpTile<T>;
  const auto kernel = resample2d_tangents_kernel<T, kPiece, kRows>;
  // as much L1 as the blocks' windows leave, for the global route
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      fnet_warp_carveout<T>()));
  if (err) return err;
  const dim3 grid((W + Tile::kCols - 1) / Tile::kCols,
                  (Ho + Tile::kTileRows - 1) / Tile::kTileRows, B * F);
  kernel<<<grid, Tile::kThreads, 0, stream>>>(img, flows, out, d1, d2, F, C,
                                              H, W, Ho, off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRows>
int launch(const T* img, const T* flows, T* out, float* d1, float* d2, int B,
           int F, int C, int H, int W, int Ho, int off, int device,
           void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  // offsets within one image plane, times 4, are int (FnetWarpPixels)
  if (static_cast<int64_t>(H) * W > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (fnet_piece<T>(W, {img, flows, out}, {d1, d2})) {
    case WarpTile<T>::kV:
      return launch_piece<T, WarpTile<T>::kV, kRows>(
          img, flows, out, d1, d2, B, F, C, H, W, Ho, off, s);
    case 2:
      return launch_piece<T, 2, kRows>(img, flows, out, d1, d2, B, F, C, H,
                                       W, Ho, off, s);
    default:
      return launch_piece<T, 1, kRows>(img, flows, out, d1, d2, B, F, C, H,
                                       W, Ho, off, s);
  }
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
