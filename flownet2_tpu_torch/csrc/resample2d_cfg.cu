// The warp at the configurations no model uses: the bilinear warp with a
// K x K tap window (K != 1) and the nearest warp, and the bilinear warp's
// flow gradient summed over the taps; float32, bfloat16 or half.
//
// Counterpart of flownet2_tpu/ops/resample2d.py: _resample2d_bilinear_impl
// (:101-121), _resample2d_nearest_impl (:124-133) and the flow gradient of
// _resample2d_bwd (:281-305), which the JAX package runs through XLA for
// these configurations (the Pallas kernels' supported() refuses them,
// resample2d_pallas.py:91-97).  No Pallas kernel computes them; the port
// runs them here so that a CUDA tensor never takes a plain PyTorch version.
//
// With xf = x + dx, yf = y + dy (the flow upcast to float before it joins
// the integer coordinate; channel 0 is dx):
// * bilinear: x0 = floor(xf), a = xf - x0 (likewise y0, b), the corners
//   xL = clamp(x0), xR = clamp(x0 + 1), yT, yB clamped to the image; for
//   each tap (fy, fx) in [0, K)^2 the four corners are read at
//   min(yT + fy, H-1), min(xL + fx, W-1), ... with the unshifted weights
//   (1-a)(1-b), a(1-b), (1-a)b, ab, and the 4 K^2 terms are summed in that
//   order, tap by tap;
// * nearest: img[clamp(floor(yf + 0.5)), clamp(floor(xf + 0.5))]; K is
//   ignored; an exact gather in every dtype;
// * the flow gradient, for each tap a sum over the channels of
//     g ((1-b)(iTR - iTL) + b(iBR - iBL))   (dx)
//     g ((1-a)(iBL - iTL) + a(iBR - iTR))   (dy)
//   added tap by tap.
// Each product and sum is rounded as the plain versions in
// ops/resample2d.py round them (__fmul_rn, __fadd_rn: no fused
// multiply-add), so the kernels give the plain versions' bits where those
// sum in this order.
//
// Element types: loads go through fnet_load, the coordinates, weights and
// sums are float32, and fnet_store rounds once (the warp to the image's
// dtype, the flow gradient to the flow's, which is the image's).
//
// Design: a thread per output pixel, looping over the channels (and taps);
// image (B, C, H, W), flow and d_flow (B, 2, H, W), g and out (B, C, H, W).
// No speed work: these bodies serve configurations no model runs.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// floor of a coordinate clamped to [0, n): clamped in float first so that a
// wild flow cannot overflow the int conversion (the index clamp gives the
// same index).
__device__ __forceinline__ int clamp_index(float v, int n) {
  const int i = static_cast<int>(fminf(fmaxf(v, -1.f), static_cast<float>(n)));
  return min(max(i, 0), n - 1);
}

struct Corners {
  float a, b;             // fractional offsets in x and y
  int xL, xR, yT, yB;     // clamped corner indices
};

__device__ __forceinline__ Corners corners(float xf, float yf, int H, int W) {
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  Corners s;
  s.a = __fsub_rn(xf, x0);
  s.b = __fsub_rn(yf, y0);
  s.xL = clamp_index(x0, W);
  s.xR = clamp_index(__fadd_rn(x0, 1.f), W);
  s.yT = clamp_index(y0, H);
  s.yB = clamp_index(__fadd_rn(y0, 1.f), H);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resample2d_cfg_fwd_kernel(const T* __restrict__ img,
                          const T* __restrict__ flow, T* __restrict__ out,
                          int C, int H, int W, int K, int bilinear) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int b = blockIdx.y;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>(p / W);
  const T* fl = flow + static_cast<int64_t>(b) * 2 * plane;
  const T* im = img + static_cast<int64_t>(b) * C * plane;
  T* o = out + static_cast<int64_t>(b) * C * plane + p;
  const float xf = __fadd_rn(static_cast<float>(x), fnet_load(fl + p));
  const float yf = __fadd_rn(static_cast<float>(y), fnet_load(fl + plane + p));

  if (!bilinear) {
    const int xn = clamp_index(floorf(__fadd_rn(xf, 0.5f)), W);
    const int yn = clamp_index(floorf(__fadd_rn(yf, 0.5f)), H);
    const T* at = im + static_cast<int64_t>(yn) * W + xn;
    for (int c = 0; c < C; ++c) o[c * plane] = at[c * plane];
    return;
  }

  const Corners s = corners(xf, yf, H, W);
  const float na = __fsub_rn(1.f, s.a);
  const float nb = __fsub_rn(1.f, s.b);
  const float w_tl = __fmul_rn(na, nb);
  const float w_tr = __fmul_rn(s.a, nb);
  const float w_bl = __fmul_rn(na, s.b);
  const float w_br = __fmul_rn(s.a, s.b);
  for (int c = 0; c < C; ++c) {
    const T* im_c = im + c * plane;
    float acc = 0.f;
    for (int fy = 0; fy < K; ++fy) {
      const int64_t yt = static_cast<int64_t>(min(s.yT + fy, H - 1)) * W;
      const int64_t yb = static_cast<int64_t>(min(s.yB + fy, H - 1)) * W;
      for (int fx = 0; fx < K; ++fx) {
        const int xl = min(s.xL + fx, W - 1);
        const int xr = min(s.xR + fx, W - 1);
        acc = __fadd_rn(acc, __fmul_rn(w_tl, fnet_load(im_c + yt + xl)));
        acc = __fadd_rn(acc, __fmul_rn(w_tr, fnet_load(im_c + yt + xr)));
        acc = __fadd_rn(acc, __fmul_rn(w_bl, fnet_load(im_c + yb + xl)));
        acc = __fadd_rn(acc, __fmul_rn(w_br, fnet_load(im_c + yb + xr)));
      }
    }
    fnet_store(o + c * plane, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
resample2d_cfg_grad_flow_kernel(const T* __restrict__ g,
                                const T* __restrict__ img,
                                const T* __restrict__ flow,
                                T* __restrict__ d_flow, int C, int H, int W,
                                int K) {
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int b = blockIdx.y;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>(p / W);
  const T* fl = flow + static_cast<int64_t>(b) * 2 * plane;
  const T* im = img + static_cast<int64_t>(b) * C * plane;
  const T* gb = g + static_cast<int64_t>(b) * C * plane + p;
  const float xf = __fadd_rn(static_cast<float>(x), fnet_load(fl + p));
  const float yf = __fadd_rn(static_cast<float>(y), fnet_load(fl + plane + p));
  const Corners s = corners(xf, yf, H, W);
  const float na = __fsub_rn(1.f, s.a);
  const float nb = __fsub_rn(1.f, s.b);

  float d_dx = 0.f, d_dy = 0.f;
  for (int fy = 0; fy < K; ++fy) {
    const int64_t yt = static_cast<int64_t>(min(s.yT + fy, H - 1)) * W;
    const int64_t yb = static_cast<int64_t>(min(s.yB + fy, H - 1)) * W;
    for (int fx = 0; fx < K; ++fx) {
      const int xl = min(s.xL + fx, W - 1);
      const int xr = min(s.xR + fx, W - 1);
      float tap_dx = 0.f, tap_dy = 0.f;
      for (int c = 0; c < C; ++c) {
        const T* im_c = im + c * plane;
        const float i_tl = fnet_load(im_c + yt + xl);
        const float i_tr = fnet_load(im_c + yt + xr);
        const float i_bl = fnet_load(im_c + yb + xl);
        const float i_br = fnet_load(im_c + yb + xr);
        const float gv = fnet_load(gb + c * plane);
        const float ddx = __fadd_rn(__fmul_rn(nb, __fsub_rn(i_tr, i_tl)),
                                    __fmul_rn(s.b, __fsub_rn(i_br, i_bl)));
        const float ddy = __fadd_rn(__fmul_rn(na, __fsub_rn(i_bl, i_tl)),
                                    __fmul_rn(s.a, __fsub_rn(i_br, i_tr)));
        tap_dx = __fadd_rn(tap_dx, __fmul_rn(gv, ddx));
        tap_dy = __fadd_rn(tap_dy, __fmul_rn(gv, ddy));
      }
      d_dx = __fadd_rn(d_dx, tap_dx);
      d_dy = __fadd_rn(d_dy, tap_dy);
    }
  }
  T* d = d_flow + static_cast<int64_t>(b) * 2 * plane + p;
  fnet_store(d, d_dx);
  fnet_store(d + plane, d_dy);
}

inline bool grid_fits(int B, int H, int W) {
  return B <= 65535 && static_cast<int64_t>(H) * W <=
                           static_cast<int64_t>(INT_MAX) * kThreads;
}

template <typename T>
int launch_fwd(const T* img, const T* flow, T* out, int B, int C, int H,
               int W, int K, int bilinear, int device, void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0) return 0;  // nothing to write
  if (!grid_fits(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  B);
  resample2d_cfg_fwd_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          img, flow, out, C, H, W, K, bilinear);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_grad_flow(const T* g, const T* img, const T* flow, T* d_flow,
                     int B, int C, int H, int W, int K, int device,
                     void* stream) {
  const int err = fnet_set_device(device);
  if (err) return err;
  if (B <= 0 || H <= 0 || W <= 0) return 0;  // nothing to write
  if (!grid_fits(B, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t plane = static_cast<int64_t>(H) * W;
  const dim3 grid(static_cast<unsigned>((plane + kThreads - 1) / kThreads),
                  B);
  resample2d_cfg_grad_flow_kernel<T>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          g, img, flow, d_flow, C, H, W, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img, out: (B, C, H, W); flow: (B, 2, H, W); all float32 and contiguous.
// bilinear 1: the bilinear warp with a K x K tap window; 0: the nearest
// warp (K ignored).
extern "C" int resample2d_cfg_fwd(const float* img, const float* flow,
                                  float* out, int B, int C, int H, int W,
                                  int K, int bilinear, int device,
                                  void* stream) {
  return launch_fwd<float>(img, flow, out, B, C, H, W, K, bilinear, device,
                           stream);
}

// The same for a bfloat16 image, flow and out: float32 coordinates and
// sums, rounded once (the nearest warp copies the bf16 values).
extern "C" int resample2d_cfg_fwd_bf16(const __nv_bfloat16* img,
                                       const __nv_bfloat16* flow,
                                       __nv_bfloat16* out, int B, int C,
                                       int H, int W, int K, int bilinear,
                                       int device, void* stream) {
  return launch_fwd<__nv_bfloat16>(img, flow, out, B, C, H, W, K, bilinear,
                                   device, stream);
}

// The same for a half image, flow and out.
extern "C" int resample2d_cfg_fwd_fp16(const __half* img, const __half* flow,
                                       __half* out, int B, int C, int H,
                                       int W, int K, int bilinear, int device,
                                       void* stream) {
  return launch_fwd<__half>(img, flow, out, B, C, H, W, K, bilinear, device,
                            stream);
}

// The bilinear K x K warp's flow gradient.  g: (B, C, H, W); img: (B, C, H,
// W); flow, d_flow: (B, 2, H, W); all float32 and contiguous.
extern "C" int resample2d_cfg_grad_flow(const float* g, const float* img,
                                        const float* flow, float* d_flow,
                                        int B, int C, int H, int W, int K,
                                        int device, void* stream) {
  return launch_grad_flow<float>(g, img, flow, d_flow, B, C, H, W, K, device,
                                 stream);
}

// The same for bfloat16 g, image and flow, with a bfloat16 d_flow: float32
// sums of the upcast values, rounded once.
extern "C" int resample2d_cfg_grad_flow_bf16(const __nv_bfloat16* g,
                                             const __nv_bfloat16* img,
                                             const __nv_bfloat16* flow,
                                             __nv_bfloat16* d_flow, int B,
                                             int C, int H, int W, int K,
                                             int device, void* stream) {
  return launch_grad_flow<__nv_bfloat16>(g, img, flow, d_flow, B, C, H, W, K,
                                         device, stream);
}

// The same for half g, image and flow, with a half d_flow.
extern "C" int resample2d_cfg_grad_flow_fp16(const __half* g,
                                             const __half* img,
                                             const __half* flow,
                                             __half* d_flow, int B, int C,
                                             int H, int W, int K, int device,
                                             void* stream) {
  return launch_grad_flow<__half>(g, img, flow, d_flow, B, C, H, W, K, device,
                                  stream);
}
