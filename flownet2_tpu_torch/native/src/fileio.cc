// Native data path of flownet2_tpu_torch (a copy of flownet2_tpu's
// native/src/fileio.cc): image and flow decoding and parallel batch
// assembly on the host.
//
// PNG (libpng), JPEG (libjpeg), PPM/PGM and Middlebury .flo decoding (magic
// 202021.25) with a thread-pooled batch loader that decodes, crops and
// converts straight into the caller's float32 batch buffers: one memory
// pass, no Python in the loop.
//
// C ABI only (consumed via ctypes); all functions return 0 on success and a
// negative errno-style code on failure.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr float kFloMagic = 202021.25f;

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, 8-bit
};

// ---------------------------------------------------------------------------
// PPM / PGM (binary P5/P6): FlyingChairs' frames are .ppm.
// ---------------------------------------------------------------------------

int ppm_skip_ws(FILE* f) {
  int ch;
  for (;;) {
    ch = fgetc(f);
    if (ch == '#') {  // comment to end of line
      while (ch != '\n' && ch != EOF) ch = fgetc(f);
    } else if (!isspace(ch)) {
      return ch;
    }
  }
}

int ppm_read_int(FILE* f, int first) {
  int v = first - '0';
  int ch;
  while (isdigit(ch = fgetc(f))) v = v * 10 + (ch - '0');
  return v;
}

int read_ppm(FILE* f, Image* im) {
  if (fgetc(f) != 'P') return -2;
  int kind = fgetc(f);
  if (kind != '5' && kind != '6') return -2;
  int c = (kind == '6') ? 3 : 1;
  int w = ppm_read_int(f, ppm_skip_ws(f));
  int h = ppm_read_int(f, ppm_skip_ws(f));
  int maxval = ppm_read_int(f, ppm_skip_ws(f));
  if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) return -2;
  im->h = h;
  im->w = w;
  im->c = c;
  im->data.resize(static_cast<size_t>(h) * w * c);
  if (maxval < 256) {
    if (fread(im->data.data(), 1, im->data.size(), f) != im->data.size())
      return -3;
  } else {  // 16-bit big-endian -> take high byte
    std::vector<uint8_t> raw(im->data.size() * 2);
    if (fread(raw.data(), 1, raw.size(), f) != raw.size()) return -3;
    for (size_t i = 0; i < im->data.size(); ++i) im->data[i] = raw[2 * i];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// PNG via libpng: MPI-Sintel's frames.
// ---------------------------------------------------------------------------

int read_png(FILE* f, Image* im) {
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || png_sig_cmp(sig, 0, 8)) return -2;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -4;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -4;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  // Normalise everything to 8-bit RGB/gray, no alpha.
  png_set_strip_16(png);
  png_set_packing(png);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && png_get_bit_depth(png, info) < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  im->h = png_get_image_height(png, info);
  im->w = png_get_image_width(png, info);
  im->c = png_get_channels(png, info);
  im->data.resize(static_cast<size_t>(im->h) * im->w * im->c);
  std::vector<png_bytep> rows(im->h);
  size_t stride = static_cast<size_t>(im->w) * im->c;
  for (int y = 0; y < im->h; ++y) rows[y] = im->data.data() + y * stride;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG via libjpeg.
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jmp, 1);
}

int read_jpeg(FILE* f, Image* im) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  im->h = cinfo.output_height;
  im->w = cinfo.output_width;
  im->c = cinfo.output_components;
  size_t stride = static_cast<size_t>(im->w) * im->c;
  im->data.resize(static_cast<size_t>(im->h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = im->data.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// Dispatch by magic bytes.
// ---------------------------------------------------------------------------

int read_image_file(const char* path, Image* im) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int c0 = fgetc(f);
  int c1 = fgetc(f);
  rewind(f);
  int rc;
  if (c0 == 0x89 && c1 == 'P') {
    rc = read_png(f, im);
  } else if (c0 == 0xFF && c1 == 0xD8) {
    rc = read_jpeg(f, im);
  } else if (c0 == 'P' && (c1 == '5' || c1 == '6')) {
    rc = read_ppm(f, im);
  } else {
    rc = -2;
  }
  fclose(f);
  return rc;
}

int read_flo_file(const char* path, int* h, int* w, std::vector<float>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  float magic = 0;
  int32_t ww = 0, hh = 0;
  if (fread(&magic, 4, 1, f) != 1 || magic != kFloMagic ||
      fread(&ww, 4, 1, f) != 1 || fread(&hh, 4, 1, f) != 1 || ww <= 0 ||
      hh <= 0) {
    fclose(f);
    return -2;
  }
  out->resize(static_cast<size_t>(hh) * ww * 2);
  size_t n = fread(out->data(), 4, out->size(), f);
  fclose(f);
  if (n != out->size()) return -3;
  *h = hh;
  *w = ww;
  return 0;
}

// Copy a crop of an HWC uint8 image into float32 RGB output (grayscale
// replicated, extra channels dropped, as the PIL route reads them).
void crop_to_f32(const Image& im, int oy, int ox, int ch, int cw, float* dst) {
  for (int y = 0; y < ch; ++y) {
    const uint8_t* src = im.data.data() +
                         (static_cast<size_t>(oy + y) * im.w + ox) * im.c;
    float* d = dst + static_cast<size_t>(y) * cw * 3;
    if (im.c >= 3) {
      for (int x = 0; x < cw; ++x, src += im.c) {
        *d++ = src[0];
        *d++ = src[1];
        *d++ = src[2];
      }
    } else {
      for (int x = 0; x < cw; ++x, src += im.c) {
        float v = src[0];
        *d++ = v;
        *d++ = v;
        *d++ = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// --- single-file API -------------------------------------------------------

int f2t_image_info(const char* path, int* h, int* w, int* c) {
  Image im;
  int rc = read_image_file(path, &im);
  if (rc) return rc;
  *h = im.h;
  *w = im.w;
  *c = im.c;
  return 0;
}

// out must hold h*w*3 uint8; image is converted to RGB.
int f2t_image_read_rgb(const char* path, uint8_t* out, int h, int w) {
  Image im;
  int rc = read_image_file(path, &im);
  if (rc) return rc;
  if (im.h != h || im.w != w) return -5;
  const uint8_t* src = im.data.data();
  if (im.c == 3) {
    memcpy(out, src, static_cast<size_t>(h) * w * 3);
  } else {
    for (size_t i = 0; i < static_cast<size_t>(h) * w; ++i, src += im.c) {
      uint8_t r = src[0];
      uint8_t g = im.c >= 3 ? src[1] : r;
      uint8_t b = im.c >= 3 ? src[2] : r;
      out[3 * i] = r;
      out[3 * i + 1] = g;
      out[3 * i + 2] = b;
    }
  }
  return 0;
}

int f2t_flo_info(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  float magic = 0;
  int32_t ww = 0, hh = 0;
  int ok = fread(&magic, 4, 1, f) == 1 && magic == kFloMagic &&
           fread(&ww, 4, 1, f) == 1 && fread(&hh, 4, 1, f) == 1;
  fclose(f);
  if (!ok || ww <= 0 || hh <= 0) return -2;
  *h = hh;
  *w = ww;
  return 0;
}

int f2t_flo_read(const char* path, float* out, int h, int w) {
  int fh, fw;
  std::vector<float> buf;
  int rc = read_flo_file(path, &fh, &fw, &buf);
  if (rc) return rc;
  if (fh != h || fw != w) return -5;
  memcpy(out, buf.data(), buf.size() * 4);
  return 0;
}

int f2t_flo_write(const char* path, const float* data, int h, int w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int32_t ww = w, hh = h;
  size_t n = static_cast<size_t>(h) * w * 2;
  int ok = fwrite(&kFloMagic, 4, 1, f) == 1 && fwrite(&ww, 4, 1, f) == 1 &&
           fwrite(&hh, 4, 1, f) == 1 && fwrite(data, 4, n, f) == n;
  fclose(f);
  return ok ? 0 : -3;
}

// --- batch loader ----------------------------------------------------------
//
// Decodes n_img images and n_flo flow files in parallel, cropping each to
// (ch, cw) at per-item offsets, converting images to float32 RGB.
//
//   img_paths: n_img '\0'-separated paths; imgs_out: (n_img, ch, cw, 3) f32
//   flo_paths: n_flo paths;                flows_out: (n_flo, ch, cw, 2) f32
//   img_oy/ox, flo_oy/ox: per-item crop origins
//   flo_flip_v: if nonzero, reverse the flow rows before cropping
//               (ChairsSDHom's flows: flow[::-1, :, :], rows flipped,
//                components untouched)
//
// Returns 0, or the first nonzero per-item error code.
int f2t_batch_load(const char* img_paths, int n_img, float* imgs_out,
                   const int* img_oy, const int* img_ox, const char* flo_paths,
                   int n_flo, float* flows_out, const int* flo_oy,
                   const int* flo_ox, int ch, int cw, int flo_flip_v,
                   int n_threads) {
  std::vector<const char*> ipaths(n_img), fpaths(n_flo);
  {
    const char* p = img_paths;
    for (int i = 0; i < n_img; ++i) {
      ipaths[i] = p;
      p += strlen(p) + 1;
    }
    p = flo_paths;
    for (int i = 0; i < n_flo; ++i) {
      fpaths[i] = p;
      p += strlen(p) + 1;
    }
  }
  std::atomic<int> next(0), err(0);
  int total = n_img + n_flo;
  size_t img_stride = static_cast<size_t>(ch) * cw * 3;
  size_t flo_stride = static_cast<size_t>(ch) * cw * 2;

  auto work = [&] {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= total) return;
      if (i < n_img) {
        Image im;
        int rc = read_image_file(ipaths[i], &im);
        if (!rc && (img_oy[i] < 0 || img_ox[i] < 0 ||
                    img_oy[i] + ch > im.h || img_ox[i] + cw > im.w))
          rc = -5;
        if (rc) {
          int zero = 0;
          err.compare_exchange_strong(zero, rc);
          continue;
        }
        crop_to_f32(im, img_oy[i], img_ox[i], ch, cw,
                    imgs_out + i * img_stride);
      } else {
        int j = i - n_img;
        int fh, fw;
        std::vector<float> buf;
        int rc = read_flo_file(fpaths[j], &fh, &fw, &buf);
        if (!rc && (flo_oy[j] < 0 || flo_ox[j] < 0 || flo_oy[j] + ch > fh ||
                    flo_ox[j] + cw > fw))
          rc = -5;
        if (rc) {
          int zero = 0;
          err.compare_exchange_strong(zero, rc);
          continue;
        }
        float* dst = flows_out + j * flo_stride;
        for (int y = 0; y < ch; ++y) {
          // flip reads rows bottom-up (crop offsets are in flipped coords,
          // matching flow[::-1] followed by the crop)
          int sy = flo_flip_v ? (fh - 1 - (flo_oy[j] + y)) : (flo_oy[j] + y);
          const float* src =
              buf.data() + (static_cast<size_t>(sy) * fw + flo_ox[j]) * 2;
          memcpy(dst + static_cast<size_t>(y) * cw * 2, src,
                 static_cast<size_t>(cw) * 8);
        }
      }
    }
  };

  int nt = n_threads < 1 ? 1 : (n_threads > total ? total : n_threads);
  if (nt == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return err.load();
}

}  // extern "C"
