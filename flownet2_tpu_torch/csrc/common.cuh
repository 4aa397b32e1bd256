// Shared by the kernel sources.  Each csrc/*.cu is compiled into its own
// shared library and includes this header once, so the definition below
// appears once in each library.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" const char* fnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Selects the device the tensors live on (each library links its own CUDA
// runtime, whose current device starts at 0) and returns the error, if any.
static inline int fnet_set_device(int device) {
  return static_cast<int>(cudaSetDevice(device));
}

// Asynchronous copies into shared memory (the correlation kernels' staging).
// cp_async copies kBytes (4 or 16) from device to shared memory, or writes
// zeros (and reads nothing) where ``valid`` is false; cp_async_commit closes
// a group of copies and cp_async_wait<n> waits until at most n groups are
// still in flight.
template <int kBytes>
static __device__ __forceinline__ void cp_async(float* dst, const float* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? kBytes : 0;
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  }
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The bf16 tensor-core bodies' pieces (correlation_fwd.cu,
// correlation_bwd.cu).  ldsm_x4 and ldsm_x4_trans load four 8x8 bf16
// matrices from shared memory, lane l giving the address of row l % 8 of
// matrix l / 8; .trans hands each lane a column pair instead of a row pair.
static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                               const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

static __device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                                     const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (to nearest even), lo in the low half.
static __device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copies kPiece bf16 values into shared memory, or zeros where ``ok`` is
// false: 8 (a 16-byte cp.async) or 2 (4-byte) asynchronously, 1 by a plain
// load and store.
template <int kPiece>
static __device__ __forceinline__ void stage_piece(__nv_bfloat16* dst,
                                                   const __nv_bfloat16* src,
                                                   bool ok) {
  if constexpr (kPiece == 1) {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
  } else {
    cp_async<2 * kPiece>(reinterpret_cast<float*>(dst),
                         reinterpret_cast<const float*>(src), ok);
  }
}

// Element types.  A kernel templated on its element type T loads with
// fnet_load (bfloat16 upcast exactly to float) and stores with fnet_store
// (float rounded to bfloat16 to nearest, ties to even, as torch's
// .to(torch.bfloat16) and JAX's astype round; never truncated).  For float
// both are the plain load and store, so a float instantiation compiles to
// the code it had before it was a template.
static __device__ __forceinline__ float fnet_load(
    const float* __restrict__ p) {
  return *p;
}

static __device__ __forceinline__ float fnet_load(
    const __nv_bfloat16* __restrict__ p) {
  return __bfloat162float(*p);
}

static __device__ __forceinline__ void fnet_store(float* p, float v) {
  *p = v;
}

static __device__ __forceinline__ void fnet_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The bilinear warp's sample point for output pixel p = r*W + x of one flow
// over Ho rows (dx at flow[p], dy at flow[Ho*W + p]), as the JAX package's
// ops/resample2d.py defines it: xf = x + dx, x0 = floor(xf), a = xf - x0
// (likewise y0, b), corners x0, x0+1, y0, y0+1 clamped to the H x W image,
// the weights not renormalised at the border.  Output row r of the flow is
// image row y = r + off: the flow may cover only the rows [off, off + Ho) of
// the image (one row band of a height-split warp).  The offset joins the
// integer row index before the flow is added, so a band's rows carry the
// very bits of the whole-image call; Ho = H, off = 0 is that call.  floorf
// (not an int cast, which truncates toward zero) gives the right corner for
// negative coordinates, and the coordinate is clamped in float first so a
// wild flow cannot overflow the int conversion (the index clamps give the
// same corners).
struct FnetBilinear {
  float a, b;                // fractional offsets in x and y
  int64_t tl, tr, bl, br;    // corner offsets in an H x W plane
};

// A bfloat16 flow is upcast to float before it joins the coordinates.
template <typename TF = float>
static __device__ __forceinline__ FnetBilinear fnet_bilinear(
    const TF* __restrict__ flow, int64_t p, int H, int W, int Ho, int off) {
  const int64_t plane = static_cast<int64_t>(Ho) * W;
  const int x = static_cast<int>(p % W);
  const int y = static_cast<int>(p / W) + off;
  const float xf = static_cast<float>(x) + fnet_load(flow + p);
  const float yf = static_cast<float>(y) + fnet_load(flow + plane + p);
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  const int xi = static_cast<int>(fminf(fmaxf(x0, -1.f), static_cast<float>(W)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, -1.f), static_cast<float>(H)));
  const int xL = min(max(xi, 0), W - 1);
  const int xR = min(max(xi + 1, 0), W - 1);
  const int yT = min(max(yi, 0), H - 1);
  const int yB = min(max(yi + 1, 0), H - 1);
  FnetBilinear s;
  s.a = xf - x0;
  s.b = yf - y0;
  s.tl = static_cast<int64_t>(yT) * W + xL;
  s.tr = static_cast<int64_t>(yT) * W + xR;
  s.bl = static_cast<int64_t>(yB) * W + xL;
  s.br = static_cast<int64_t>(yB) * W + xR;
  return s;
}
