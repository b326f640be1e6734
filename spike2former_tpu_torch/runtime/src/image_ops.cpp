// Native image pipeline for the spike2former data loaders (the PyTorch
// port keeps its own copy of the JAX package's runtime source).
//
// TPU-native counterpart of the reference's native data path (torch's C++
// DataLoader workers + mmcv's C imread/imresize): JPEG/PNG decode, bilinear
// resize, crop/flip and float normalization in one C++ call so Python
// threads release the GIL for the whole per-image pipeline.
//
// Exposed C ABI (see runtime/__init__.py ctypes bindings):
//   s2f_decode_image(path, out_w, out_h, out_c) -> malloc'd RGB8 buffer
//   s2f_resize_bilinear_u8(src,h,w,c, dst,oh,ow)
//   s2f_resize_nearest_i32(src,h,w, dst,oh,ow)
//   s2f_normalize_f32(src,h,w, mean[3], std[3], dst)
//   s2f_free(ptr)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <algorithm>

#include <jpeglib.h>
#include <png.h>

extern "C" {

void s2f_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

static uint8_t* decode_jpeg(FILE* f, int* h, int* w, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  *c = 3;
  size_t stride = static_cast<size_t>(*w) * 3;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(stride * *h));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return buf;
}

// ---------------------------------------------------------------------------
// PNG (also used for annotation maps; returns native channel count)
// ---------------------------------------------------------------------------

static uint8_t* decode_png(FILE* f, int* h, int* w, int* c) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return nullptr;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return nullptr;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return nullptr;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  int channels = png_get_channels(png, info);
  size_t stride = static_cast<size_t>(width) * channels;
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(stride * height));
  for (png_uint_32 y = 0; y < height; y++) {
    png_bytep row = buf + stride * y;
    png_read_row(png, row, nullptr);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  *h = static_cast<int>(height);
  *w = static_cast<int>(width);
  *c = channels;
  return buf;
}

// Decode by sniffing magic bytes.  Returns malloc'd buffer (caller frees via
// s2f_free); fills h/w/c.  nullptr on failure.
uint8_t* s2f_decode_image(const char* path, int* h, int* w, int* c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t magic[8] = {0};
  size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  uint8_t* out = nullptr;
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    out = decode_jpeg(f, h, w, c);
  } else if (got >= 4 && magic[1] == 'P' && magic[2] == 'N' &&
             magic[3] == 'G') {
    out = decode_png(f, h, w, c);
  }
  std::fclose(f);
  return out;
}

// ---------------------------------------------------------------------------
// Resize
// ---------------------------------------------------------------------------

// Half-pixel bilinear (torch align_corners=False semantics), uint8, C chans.
void s2f_resize_bilinear_u8(const uint8_t* src, int h, int w, int c,
                            uint8_t* dst, int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  for (int y = 0; y < oh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, h - 1);
    float wy = fy - y0;
    for (int x = 0; x < ow; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
      int x0 = static_cast<int>(fx);
      int x1 = std::min(x0 + 1, w - 1);
      float wx = fx - x0;
      for (int ch = 0; ch < c; ch++) {
        float v00 = src[(y0 * w + x0) * c + ch];
        float v01 = src[(y0 * w + x1) * c + ch];
        float v10 = src[(y1 * w + x0) * c + ch];
        float v11 = src[(y1 * w + x1) * c + ch];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        float v = top + (bot - top) * wy;
        dst[(y * ow + x) * c + ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// torch F.interpolate(mode='nearest'): src = floor(dst * in/out).
void s2f_resize_nearest_i32(const int32_t* src, int h, int w,
                            int32_t* dst, int oh, int ow) {
  for (int y = 0; y < oh; y++) {
    int sy = std::min(static_cast<int>(y * (static_cast<float>(h) / oh)),
                      h - 1);
    for (int x = 0; x < ow; x++) {
      int sx = std::min(static_cast<int>(x * (static_cast<float>(w) / ow)),
                        w - 1);
      dst[y * ow + x] = src[sy * w + sx];
    }
  }
}

// (x - mean) / std normalization, RGB u8 -> f32.
void s2f_normalize_f32(const uint8_t* src, int h, int w,
                       const float* mean, const float* stdv, float* dst) {
  const float inv0 = 1.0f / stdv[0], inv1 = 1.0f / stdv[1],
              inv2 = 1.0f / stdv[2];
  const int n = h * w;
  for (int i = 0; i < n; i++) {
    dst[i * 3 + 0] = (src[i * 3 + 0] - mean[0]) * inv0;
    dst[i * 3 + 1] = (src[i * 3 + 1] - mean[1]) * inv1;
    dst[i * 3 + 2] = (src[i * 3 + 2] - mean[2]) * inv2;
  }
}

}  // extern "C"
