// Shared by the kernel sources.  Each csrc/*.cu is compiled into its own
// shared library and includes this header once, so the definition below
// appears once in each library.
#pragma once

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// The row-tile warps, K2 (resample2d_fwd.cu), K3 (resample2d_tangents.cu)
// and K4 (resample2d_grad_flow.cu).
//
// A block covers kCols output columns x kTileRows output rows of one flow
// (grid: column tiles x row tiles x B*F); a thread owns kV consecutive
// columns of one row, 16 bytes of T.  The flow arrives, and K2's output,
// K3's three outputs and K4's cotangent and d_flow move, in pieces of kPiece
// elements: kV (16 bytes of T) where every row of every tensor starts
// 16-byte aligned, else 2, else 1; a piece past the row's last column is
// masked.  The block takes the bounding box of its sample points' clamped
// corners (its window) and chooses a route:
// - shared: the window's rows of all C channels are staged in shared
//   memory (cp.async) and the corners gathered there.  A block takes this
//   route where the window fits in kWindowBytes (a +-8 px flow needs 30 KB
//   at C = 3 in float32, 23 KB in bfloat16) and is more than a few pixels
//   larger than the tile's part of the map;
// - global: the corners are gathered from the image in global memory
//   through the read-only path.  This serves wild flows, whose window does
//   not fit, and flows that hardly move the tile, whose corners L1 serves
//   well.
// Both routes read the same values and run the same arithmetic, so they
// give the same bits.
template <typename T>
struct WarpTile {
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));
  static constexpr int kCols = 64;
  static constexpr int kTileRows = sizeof(T) == 4 ? 16 : 32;
  static constexpr int kThreadsX = kCols / kV;
  static constexpr int kThreads = kThreadsX * kTileRows;
  static constexpr int kWarps = kThreads / 32;
  // the window: a +-8 px flow's over C = 3 (32 x 80 x 3 float32, 48 x 80
  // x 3 bfloat16) fits
  static constexpr int kWindowBytes = sizeof(T) == 4 ? 30720 : 24576;
  // blocks an SM that the registers must allow (__launch_bounds__)
  static constexpr int kMinBlocks = sizeof(T) == 4 ? 3 : 2;
  // the flow and the cotangent read without a place in L1 (fnet_stream):
  // faster in float32 on an H100, slower in bfloat16
  static constexpr bool kStreamLoads = sizeof(T) == 4;
};

// The widest piece, in elements of T, on which every row of W elements of
// each tensor at ``ptrs`` starts: 16 bytes, 2 elements or 1.  The float
// tensors at ``floats`` (K3's tangents beside a bfloat16 image) move the
// same pieces of float, as words of 16 bytes at most, so their rows must
// start on such a word.
template <typename T>
static inline int fnet_piece(int W, std::initializer_list<const void*> ptrs,
                             std::initializer_list<const float*> floats = {}) {
  for (const int n : {16 / static_cast<int>(sizeof(T)), 2}) {
    bool ok = W % n == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % (n * sizeof(T)) == 0;
    for (const float* p : floats)
      ok = ok && reinterpret_cast<uintptr_t>(p) %
                         ((n < 4 ? n : 4) * sizeof(float)) == 0;
    if (ok) return n;
  }
  return 1;
}

// The shared-memory carveout to ask for (cudaFuncAttributePreferred-
// SharedMemoryCarveout, in percent of the SM's 228 KB): the smallest the
// H100 offers that holds kMinBlocks blocks' windows, so that the rest of
// the SM's 256 KB, the L1 cache, is as large as it can be.  The blocks that
// gather from global memory rely on it (CUDA rounds a percentage up to the
// next size it offers).
template <typename T>
static inline int fnet_warp_carveout() {
  using Tile = WarpTile<T>;
  const int need = Tile::kMinBlocks *
                   (Tile::kWindowBytes + Tile::kWarps * 4 * 4 +
                    1024);  // the runtime's own kilobyte a block
  for (const int kb : {0, 8, 16, 32, 64, 100, 132, 164, 196, 228})
    if (kb * 1024 >= need) return kb * 100 / 228;
  return 100;
}

// kN values of T moved as one access of kN * sizeof(T) bytes.
template <int kBytes> struct FnetWord;
template <> struct FnetWord<16> { using type = uint4; };
template <> struct FnetWord<8> { using type = uint2; };
template <> struct FnetWord<4> { using type = unsigned; };
template <> struct FnetWord<2> { using type = unsigned short; };

template <typename T, int kN>
union FnetPiece {
  typename FnetWord<kN * sizeof(T)>::type word;
  T v[kN];
};

static __device__ __forceinline__ float fnet_float(float v) { return v; }

static __device__ __forceinline__ float fnet_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One word read through the read-only path without a place in L1
// (ld.global.nc.L1::no_allocate): the row tiles' streamed inputs, so that
// L1 is left to the gathers.
static __device__ __forceinline__ uint4 fnet_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

static __device__ __forceinline__ uint2 fnet_stream(const uint2* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

static __device__ __forceinline__ unsigned fnet_stream(const unsigned* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

static __device__ __forceinline__ unsigned short fnet_stream(
    const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

// kN values at ``src`` (aligned to kN elements), upcast to float.
template <int kN, typename T>
static __device__ __forceinline__ void fnet_load_piece(float* dst,
                                                       const T* src) {
  using Word = typename FnetWord<kN * sizeof(T)>::type;
  FnetPiece<T, kN> p;
  if constexpr (WarpTile<T>::kStreamLoads)
    p.word = fnet_stream(reinterpret_cast<const Word*>(src));
  else
    p.word = *reinterpret_cast<const Word*>(src);
#pragma unroll
  for (int i = 0; i < kN; ++i) dst[i] = fnet_float(p.v[i]);
}

// One word stored without a place in L1 (st.global.L1::no_allocate): the
// row tiles' outputs, so that L1 is left to the gathers.
static __device__ __forceinline__ void fnet_stream_store(uint4* p, uint4 v) {
  asm volatile("st.global.L1::no_allocate.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
static __device__ __forceinline__ void fnet_stream_store(uint2* p, uint2 v) {
  asm volatile("st.global.L1::no_allocate.v2.u32 [%0], {%1, %2};\n"
               ::"l"(p), "r"(v.x), "r"(v.y) : "memory");
}
static __device__ __forceinline__ void fnet_stream_store(unsigned* p,
                                                         unsigned v) {
  asm volatile("st.global.L1::no_allocate.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
static __device__ __forceinline__ void fnet_stream_store(unsigned short* p,
                                                         unsigned short v) {
  asm volatile("st.global.L1::no_allocate.u16 [%0], %1;\n" ::"l"(p), "h"(v)
               : "memory");
}

// kN floats stored at ``dst`` (aligned to kN elements), each rounded once to
// T (fnet_store), without a place in L1 (fnet_stream_store).
template <int kN, typename T>
static __device__ __forceinline__ void fnet_store_piece(T* dst,
                                                        const float* src) {
  using Word = typename FnetWord<kN * sizeof(T)>::type;
  FnetPiece<T, kN> p;
#pragma unroll
  for (int i = 0; i < kN; ++i) fnet_store(&p.v[i], src[i]);
  fnet_stream_store(reinterpret_cast<Word*>(dst), p.word);
}

// Copies kBytes from device to shared memory: asynchronously (cp.async) for
// 4, 8 or 16 bytes, by a plain load and store for 2.
template <int kBytes>
static __device__ __forceinline__ void fnet_stage_bytes(void* dst,
                                                        const void* src) {
  if constexpr (kBytes == 2) {
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (kBytes == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(kBytes)
                   : "memory");
    }
  }
}

// A block's window: image rows [y0, y0 + rows) and columns [x0, x0 +
// pitch) of each channel plane, staged in shared memory with ``pitch``
// elements a row and rows * pitch a channel (shared), or else the image
// itself (y0 = x0 = 0, pitch W).
struct FnetWindow {
  int y0, x0, pitch, rows;
  bool shared;
};

// One thread's kV output pixels of a row-tile warp: columns [x, x + kV) of
// output row r (image row r + off) of one flow.  For each pixel the
// fractional offsets a, b (fnet_bilinear's arithmetic, the same bits) and
// ``code``: the offset o of its top-left corner in a channel plane of the
// block's window, times 4, plus 2 where the bottom corner is a row below
// the top one and 1 where the right corner is a column right of the left
// one (a corner clamped onto its neighbour is that neighbour).  A pixel
// past the row's end or the last row keeps a = b = code = 0.
template <typename T, int kPiece>
struct FnetWarpPixels {
  using Tile = WarpTile<T>;
  static constexpr int kV = Tile::kV;
  int x, r;
  bool live;  // the thread's row is an output row
  float a[kV], b[kV];
  int code[kV];

  // piece j (columns x + j*kPiece ..) lies in the row: W % kPiece == 0, so
  // a piece lies wholly in the row or wholly past its end
  __device__ __forceinline__ bool valid(int j, int W) const {
    return live && x + j * kPiece < W;
  }

  // The sample point of pixel i for the flow (dx, dy): fnet_bilinear's
  // arithmetic, the corners as clamped columns and rows.
  __device__ __forceinline__ void sample(int i, float dx, float dy, int H,
                                         int W, int off, float& fa, float& fb,
                                         int& xL, int& xR, int& yT,
                                         int& yB) const {
    const float xf = static_cast<float>(x + i) + dx;
    const float yf = static_cast<float>(r + off) + dy;
    const float x0 = floorf(xf);
    const float y0 = floorf(yf);
    const int xi =
        static_cast<int>(fminf(fmaxf(x0, -1.f), static_cast<float>(W)));
    const int yi =
        static_cast<int>(fminf(fmaxf(y0, -1.f), static_cast<float>(H)));
    xL = min(max(xi, 0), W - 1);
    xR = min(max(xi + 1, 0), W - 1);
    yT = min(max(yi, 0), H - 1);
    yB = min(max(yi + 1, 0), H - 1);
    fa = xf - x0;
    fb = yf - y0;
  }

  // Maps the thread, reads its flow (dx at ``flow``, dy one plane of Ho*W
  // further on), computes its sample points and the block's window and
  // route.  Every thread of the block calls it (it synchronises the
  // block).  The sample points are computed twice, for the window and then
  // for the offsets in it, so that only the flow is held across the
  // block's reduction.
  __device__ __forceinline__ FnetWindow setup(const T* __restrict__ flow,
                                              int (*slots)[4], int C, int H,
                                              int W, int Ho, int off) {
    const int tx = threadIdx.x % Tile::kThreadsX;
    const int ty = threadIdx.x / Tile::kThreadsX;
    x = blockIdx.x * Tile::kCols + tx * kV;
    r = blockIdx.y * Tile::kTileRows + ty;
    live = r < Ho;
    const int at = r * W + x;
    const int plane = Ho * W;
    float dx[kV], dy[kV];
#pragma unroll
    for (int j = 0; j < kV / kPiece; ++j) {
      if (valid(j, W)) {
        fnet_load_piece<kPiece>(dx + j * kPiece, flow + at + j * kPiece);
        fnet_load_piece<kPiece>(dy + j * kPiece,
                                flow + plane + at + j * kPiece);
      }
    }
    // the thread's box of clamped corner rows and columns
    int yl = INT_MAX, yh = INT_MIN, xl = INT_MAX, xh = INT_MIN;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      if (!valid(i / kPiece, W)) continue;
      float fa, fb;
      int xL, xR, yT, yB;
      sample(i, dx[i], dy[i], H, W, off, fa, fb, xL, xR, yT, yB);
      yl = min(yl, yT);
      yh = max(yh, yB);
      xl = min(xl, xL);
      xh = max(xh, xR);
    }
    // the block's box: a warp's by one reduction each, then the warps'
    const unsigned all = 0xffffffffu;
    yl = __reduce_min_sync(all, yl);
    yh = __reduce_max_sync(all, yh);
    xl = __reduce_min_sync(all, xl);
    xh = __reduce_max_sync(all, xh);
    if (threadIdx.x % 32 == 0) {
      int* s = slots[threadIdx.x / 32];
      s[0] = yl;
      s[1] = yh;
      s[2] = xl;
      s[3] = xh;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < Tile::kWarps; ++w) {
      yl = min(yl, slots[w][0]);
      yh = max(yh, slots[w][1]);
      xl = min(xl, slots[w][2]);
      xh = max(xh, slots[w][3]);
    }
    // the window: the box's rows, its columns widened to whole pieces; the
    // route: shared where it fits and is more than a few pixels larger
    // than the tile's part of the map
    FnetWindow win;
    win.y0 = yl;
    win.x0 = xl - xl % kPiece;
    win.pitch = (xh + kPiece) / kPiece * kPiece - win.x0;
    win.rows = yh - yl + 1;
    const int row0 = static_cast<int>(blockIdx.y) * Tile::kTileRows;
    const int tile_rows = min(Tile::kTileRows, Ho - row0);
    const int tile_cols =
        min(Tile::kCols, W - static_cast<int>(blockIdx.x) * Tile::kCols);
    const bool near = win.rows <= tile_rows + 2 &&
                      win.pitch <= tile_cols + 2 * kV;
    win.shared = !near && static_cast<int64_t>(C) * win.rows * win.pitch *
                                  sizeof(T) <= Tile::kWindowBytes;
    if (!win.shared) {
      win.y0 = 0;
      win.x0 = 0;
      win.pitch = W;
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      a[i] = b[i] = 0.f;
      code[i] = 0;
      if (!valid(i / kPiece, W)) continue;
      int xL, xR, yT, yB;
      sample(i, dx[i], dy[i], H, W, off, a[i], b[i], xL, xR, yT, yB);
      code[i] = ((yT - win.y0) * win.pitch + (xL - win.x0)) * 4 +
                (yB != yT ? 2 : 0) + (xR != xL ? 1 : 0);
    }
    return win;
  }

  // Stages the window of the C planes of ``img`` (one image, C x H x W)
  // into ``buf`` (shared, 16-byte aligned, Tile::kWindowBytes).  Every
  // thread of the block calls it.
  __device__ __forceinline__ void stage(T* buf, const T* __restrict__ img,
                                        const FnetWindow& win, int C, int H,
                                        int W) const {
    const int pieces = win.pitch / kPiece;
    const int n = win.rows * pieces;
    for (int c = 0; c < C; ++c) {
      const T* src = img + static_cast<int64_t>(c) * H * W + win.y0 * W +
                     win.x0;
      T* dst = buf + c * win.rows * win.pitch;
      for (int k = threadIdx.x; k < n; k += Tile::kThreads) {
        const int row = k / pieces;
        const int col = (k - row * pieces) * kPiece;
        fnet_stage_bytes<kPiece * sizeof(T)>(dst + row * win.pitch + col,
                                             src + row * W + col);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // The four corner values of pixel i in channel plane ``p`` (the window's
  // in shared memory, or the image's in global memory, read through the
  // read-only data path: kGlobal), ``pitch`` elements a row, upcast to
  // float.
  template <bool kGlobal>
  __device__ __forceinline__ void corners(const T* p, int pitch, int i,
                                          float& tl, float& tr, float& bl,
                                          float& br) const {
    const int dxo = code[i] & 1;
    const int dyo = code[i] & 2 ? pitch : 0;
    p += code[i] >> 2;
    if constexpr (kGlobal) {
      tl = fnet_float(__ldg(p));
      tr = fnet_float(__ldg(p + dxo));
      bl = fnet_float(__ldg(p + dyo));
      br = fnet_float(__ldg(p + dyo + dxo));
    } else {
      tl = fnet_float(p[0]);
      tr = fnet_float(p[dxo]);
      bl = fnet_float(p[dyo]);
      br = fnet_float(p[dyo + dxo]);
    }
  }
};
