// Native data loader of focalnet_tpu_torch.
//
// The counterpart of the JAX package's native/dataloader/loader.cpp, with
// the same C ABI: decode PNG/JPEG to RGB (float32 in [0, 1] or uint8),
// encode RGB to PNG, and assemble training batches of paired random crops
// and horizontal flips in a std::thread pool.  Bound with ctypes by
// focalnet_tpu_torch/data/native_loader.py, which builds it with g++ at
// first use:
//
//   g++ -O3 -march=native -std=c++17 -fPIC -shared -pthread loader.cpp
//       -o libloader_<hash>.so -lz [-lpng] [-ljpeg]
//
// The build links libpng and libjpeg where the host has them (the binding
// probes each) and passes -DFNL_NO_LIBPNG / -DFNL_NO_LIBJPEG where it does
// not.  Without libpng, PNG goes through this file's own codec over zlib's
// inflate and deflate.  It gives the pixels that libpng gives under the
// transforms of decode_png_libpng below: every colour type and bit depth,
// the five row filters, Adam7, palette (tRNS read and, with all alpha,
// dropped), 16-bit samples cut to their high byte (png_set_strip_16), gray
// below 8 bits scaled to 8 (png_set_expand_gray_1_2_4_to_8).  Without
// libjpeg a JPEG does not decode (the binding names the missing library).
//
// RNG contract: each example gets a caller-supplied 64-bit seed driving a
// SplitMix64 stream; the crop's i0 then j0 are Lemire bounded draws and the
// flip is one uniform draw below 0.5, as in the JAX package's loader, so
// the same seeds give the same crops and flips there and here.
//
// Bound on the card's host: inflate and the row filters, a few ns a byte,
// one image a thread; the crop, flip and divide touch crop*crop*3 bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#if !defined(FNL_NO_LIBPNG) && __has_include(<png.h>)
#define FNL_LIBPNG 1
#include <png.h>
#endif
#if !defined(FNL_NO_LIBJPEG) && __has_include(<jpeglib.h>)
#define FNL_LIBJPEG 1
#include <jpeglib.h>
#endif

namespace {

// ---------------------------------------------------------------- RNG

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // Lemire bounded: uniform in [0, bound)
  uint64_t bounded(uint64_t bound) {
    if (bound == 0) return 0;
    __uint128_t m = (__uint128_t)next() * bound;
    return (uint64_t)(m >> 64);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// ---------------------------------------------------------------- decode

struct ImageU8 {
  int h = 0, w = 0;  // always 3-channel RGB
  std::vector<uint8_t> data;
};

#ifdef FNL_LIBPNG

bool decode_png_libpng(FILE* fp, ImageU8* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  // constructed BEFORE setjmp: a libpng longjmp must not skip a live
  // nontrivial object's initialization (UB) — the error branch then returns
  // normally and the destructor runs
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize every variant to 8-bit RGB
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  out->h = (int)h;
  out->w = (int)w;
  out->data.resize((size_t)h * w * 3);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->data.data() + (size_t)y * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

#else  // PNG over zlib

constexpr uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
constexpr uint32_t kPngMaxSide = 1000000;  // libpng's default user limit

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)(v >> 24);
  p[1] = (uint8_t)(v >> 16);
  p[2] = (uint8_t)(v >> 8);
  p[3] = (uint8_t)v;
}

bool read_all(FILE* fp, std::vector<uint8_t>* out) {
  uint8_t buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof buf, fp)) > 0) out->insert(out->end(), buf, buf + got);
  return !ferror(fp);
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0, channels = 0;
};

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool png_depth_ok(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

// bytes of one row of n pixels, without its filter byte
uint64_t png_row_bytes(const PngHeader& hd, uint64_t n) {
  return (n * hd.channels * hd.depth + 7) / 8;
}

// Adam7: pass p takes the pixels (y0 + k dy, x0 + k dx)
constexpr int kAdam7[7][4] = {  // x0, y0, dx, dy
    {0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
    {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

uint32_t pass_extent(uint32_t n, int start, int step) {
  return n > (uint32_t)start ? (n - start + step - 1) / step : 0;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// Undo the row filters of `rows` rows, each a filter byte then `stride`
// bytes, from `in` into `out` (rows x stride); `bpp` bytes per whole pixel.
bool unfilter(const uint8_t* in, uint8_t* out, size_t rows, size_t stride, size_t bpp) {
  const uint8_t* prev = nullptr;
  for (size_t r = 0; r < rows; ++r, in += stride + 1) {
    const uint8_t f = in[0];
    const uint8_t* src = in + 1;
    uint8_t* cur = out + r * stride;
    switch (f) {
      case 0:
        std::memcpy(cur, src, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

// sample k of an unfiltered row, cut to 8 bits as libpng's transforms do
inline int png_sample(const uint8_t* row, uint64_t k, int depth) {
  if (depth == 8) return row[k];
  if (depth == 16) return row[2 * k];  // png_set_strip_16: the high byte
  const uint64_t bit = k * depth;
  const int v = (row[bit >> 3] >> (8 - depth - (int)(bit & 7))) & ((1 << depth) - 1);
  return v * (255 / ((1 << depth) - 1));  // 1-, 2-, 4-bit gray: v * 255, 85, 17
}

// n pixels of one unfiltered row to RGB, every `step`-th pixel of `dst`
void png_row_to_rgb(const PngHeader& hd, const uint8_t* row, uint32_t n,
                    const std::vector<uint8_t>& palette, uint8_t* dst, size_t step) {
  const int ch = hd.channels;
  for (uint32_t x = 0; x < n; ++x, dst += 3 * step) {
    if (hd.ctype == 3) {
      // the index is never scaled; one beyond the palette reads black
      const uint64_t bit = (uint64_t)x * hd.depth;
      const int idx = hd.depth == 8 ? row[x]
                      : (row[bit >> 3] >> (8 - hd.depth - (int)(bit & 7))) & ((1 << hd.depth) - 1);
      if ((size_t)idx * 3 + 2 < palette.size()) {
        std::memcpy(dst, palette.data() + (size_t)idx * 3, 3);
      } else {
        dst[0] = dst[1] = dst[2] = 0;
      }
    } else if (ch <= 2) {  // gray, gray + alpha
      dst[0] = dst[1] = dst[2] = (uint8_t)png_sample(row, (uint64_t)x * ch, hd.depth);
    } else {  // RGB, RGBA
      for (int c = 0; c < 3; ++c)
        dst[c] = (uint8_t)png_sample(row, (uint64_t)x * ch + c, hd.depth);
    }
  }
}

bool decode_png_zlib(FILE* fp, ImageU8* out) {
  std::vector<uint8_t> file;
  if (!read_all(fp, &file) || file.size() < 8 || std::memcmp(file.data(), kPngSignature, 8))
    return false;
  PngHeader hd;
  bool have_header = false, ended = false;
  std::vector<uint8_t> palette, idat;
  for (size_t pos = 8; pos + 12 <= file.size();) {
    const uint32_t len = be32(&file[pos]);
    if (len > 0x7FFFFFFFu || pos + 12 + (uint64_t)len > file.size()) return false;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* body = type + 4;
    const bool critical = !(type[0] & 0x20);
    const uint32_t crc = (uint32_t)crc32(crc32(0L, type, 4), body, len);
    pos += 12 + (size_t)len;
    if (crc != be32(body + len)) {
      if (critical) return false;
      continue;  // libpng drops an ancillary chunk with a bad CRC
    }
    if (!std::memcmp(type, "IHDR", 4)) {
      if (have_header || len != 13) return false;
      hd.w = be32(body);
      hd.h = be32(body + 4);
      hd.depth = body[8];
      hd.ctype = body[9];
      hd.interlace = body[12];
      hd.channels = png_channels(hd.ctype);
      if (!hd.w || !hd.h || hd.w > kPngMaxSide || hd.h > kPngMaxSide ||
          !png_depth_ok(hd.ctype, hd.depth) || body[10] != 0 || body[11] != 0 ||
          hd.interlace > 1)
        return false;
      have_header = true;
    } else if (!have_header) {
      return false;  // IHDR comes first
    } else if (!std::memcmp(type, "PLTE", 4)) {
      if (len % 3 || len > 768) return false;
      palette.assign(body, body + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      ended = true;
      break;
    } else if (critical) {
      return false;  // an unknown critical chunk, as libpng
    }
    // tRNS and the other ancillary chunks: the alpha is dropped anyway
  }
  if (!have_header || !ended || idat.empty() || (hd.ctype == 3 && palette.empty()))
    return false;

  // the filtered bytes of every pass (one pass without Adam7)
  struct Pass { uint32_t w, h; int x0, y0, dx, dy; uint64_t stride; };
  std::vector<Pass> passes;
  uint64_t raw_size = 0;
  for (int p = 0; p < (hd.interlace ? 7 : 1); ++p) {
    const int* a = hd.interlace ? kAdam7[p] : nullptr;
    Pass ps{hd.w, hd.h, 0, 0, 1, 1, 0};
    if (a) ps = {pass_extent(hd.w, a[0], a[2]), pass_extent(hd.h, a[1], a[3]),
                 a[0], a[1], a[2], a[3], 0};
    if (!ps.w || !ps.h) continue;  // an empty pass has no bytes at all
    ps.stride = png_row_bytes(hd, ps.w);
    raw_size += ps.h * (ps.stride + 1);
    passes.push_back(ps);
  }
  std::vector<uint8_t> raw(raw_size);
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return false;
  // in pieces that fit zlib's 32-bit counts; data beyond the image's bytes
  // is ignored (libpng warns of it)
  constexpr size_t kPiece = size_t(1) << 30;
  size_t in_done = 0, out_done = 0;
  while (out_done < raw_size) {
    if (zs.avail_in == 0 && in_done < idat.size()) {
      const size_t n = std::min(idat.size() - in_done, kPiece);
      zs.next_in = idat.data() + in_done;
      zs.avail_in = (uInt)n;
      in_done += n;
    }
    const size_t n = std::min<size_t>(raw_size - out_done, kPiece);
    zs.next_out = raw.data() + out_done;
    zs.avail_out = (uInt)n;
    const int rc = inflate(&zs, Z_NO_FLUSH);
    out_done += n - zs.avail_out;
    if (rc != Z_OK) break;  // the stream's end, an error, or no progress
  }
  inflateEnd(&zs);
  if (out_done != raw_size) return false;

  out->h = (int)hd.h;
  out->w = (int)hd.w;
  out->data.resize((size_t)hd.h * hd.w * 3);
  const size_t bpp = std::max<size_t>(1, (size_t)hd.channels * hd.depth / 8);
  const uint8_t* in = raw.data();
  for (const Pass& ps : passes) {
    if (hd.ctype == 2 && hd.depth == 8 && !hd.interlace) {  // RGB8: unfilter in place
      if (!unfilter(in, out->data.data(), ps.h, ps.stride, bpp)) return false;
      continue;
    }
    std::vector<uint8_t> rows(ps.h * ps.stride);
    if (!unfilter(in, rows.data(), ps.h, ps.stride, bpp)) return false;
    for (uint32_t r = 0; r < ps.h; ++r) {
      uint8_t* dst = out->data.data() + ((size_t)(ps.y0 + r * ps.dy) * hd.w + ps.x0) * 3;
      png_row_to_rgb(hd, rows.data() + r * ps.stride, ps.w, palette, dst, ps.dx);
    }
    in += ps.h * (ps.stride + 1);
  }
  return true;
}

void put_chunk(std::vector<uint8_t>* out, const char* type, const uint8_t* body, size_t len) {
  uint8_t head[8];
  put_be32(head, (uint32_t)len);
  std::memcpy(head + 4, type, 4);
  out->insert(out->end(), head, head + 8);
  if (len) out->insert(out->end(), body, body + len);
  uLong sum = crc32(0L, (const uint8_t*)type, 4);
  if (len) sum = crc32(sum, body, (uInt)len);  // crc32 of a null buffer is 0, not sum
  uint8_t crc[4];
  put_be32(crc, (uint32_t)sum);
  out->insert(out->end(), crc, crc + 4);
}

#endif  // FNL_LIBPNG

#ifdef FNL_LIBJPEG

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* fp, ImageU8* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = (int)cinfo.output_height;
  out->w = (int)cinfo.output_width;
  out->data.resize((size_t)out->h * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

#endif  // FNL_LIBJPEG

bool decode_file(const char* path, ImageU8* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  uint8_t magic[4] = {0};
  size_t got = fread(magic, 1, 4, fp);
  rewind(fp);
  bool ok = false;
  try {  // an image too large to hold fails to decode, it does not abort
    if (got == 4 && magic[0] == 0x89 && magic[1] == 'P') {
#ifdef FNL_LIBPNG
      ok = decode_png_libpng(fp, out);
#else
      ok = decode_png_zlib(fp, out);
#endif
    } else if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
#ifdef FNL_LIBJPEG
      ok = decode_jpeg(fp, out);
#endif
    }
  } catch (const std::bad_alloc&) {
    ok = false;
  }
  fclose(fp);
  return ok;
}

// ---------------------------------------------------------------- augment

// true division (not reciprocal-multiply): bit-identical to numpy's
// uint8/255.0 conversion on the PIL path — parity tests compare exactly
constexpr float kU8Max = 255.0f;

// paired random crop + hflip + to-float, writing (crop, crop, 3) into out
void crop_flip_normalize(const ImageU8& img, int i0, int j0, int crop,
                         bool flip, float* out) {
  for (int y = 0; y < crop; ++y) {
    const uint8_t* src = img.data.data() + ((size_t)(i0 + y) * img.w + j0) * 3;
    float* dst = out + (size_t)y * crop * 3;
    if (!flip) {
      for (int x = 0; x < crop * 3; ++x) dst[x] = src[x] / kU8Max;
    } else {
      for (int x = 0; x < crop; ++x) {
        const uint8_t* s = src + (size_t)(crop - 1 - x) * 3;
        dst[(size_t)x * 3 + 0] = s[0] / kU8Max;
        dst[(size_t)x * 3 + 1] = s[1] / kU8Max;
        dst[(size_t)x * 3 + 2] = s[2] / kU8Max;
      }
    }
  }
}

int load_one_pair(const char* hazy_path, const char* gt_path, int crop,
                  uint64_t seed, float* out_hazy, float* out_gt) {
  ImageU8 hazy, gt;
  if (!decode_file(hazy_path, &hazy)) return -1;
  if (!decode_file(gt_path, &gt)) return -2;
  if (hazy.h != gt.h || hazy.w != gt.w) return -3;
  if (hazy.h < crop || hazy.w < crop) return -4;  // no padding, unlike paired_random_crop
  SplitMix64 rng(seed);
  int i0 = (int)rng.bounded((uint64_t)(hazy.h - crop + 1));
  int j0 = (int)rng.bounded((uint64_t)(hazy.w - crop + 1));
  bool flip = rng.uniform() < 0.5;
  crop_flip_normalize(hazy, i0, j0, crop, flip, out_hazy);
  crop_flip_normalize(gt, i0, j0, crop, flip, out_gt);
  return 0;
}

}  // namespace

extern "C" {

// Which codecs this build has, e.g. "png: libpng 1.6.39; jpeg: libjpeg 62;
// zlib 1.2.13" or "png: own codec over zlib; jpeg: none; zlib 1.3".
const char* fnl_build_info() {
  static const std::string info =
#ifdef FNL_LIBPNG
      std::string("png: libpng ") + PNG_LIBPNG_VER_STRING
#else
      std::string("png: own codec over zlib")
#endif
#ifdef FNL_LIBJPEG
      + "; jpeg: libjpeg " + std::to_string(JPEG_LIB_VERSION)
#else
      + "; jpeg: none"
#endif
      + "; zlib " + zlibVersion();
  return info.c_str();
}

int fnl_has_jpeg() {
#ifdef FNL_LIBJPEG
  return 1;
#else
  return 0;
#endif
}

// Decode one image to float32 RGB [0,1].  Caller passes a buffer of
// max_h*max_w*3 floats; actual (h, w) returned through out params.
// Returns 0 on success.
int fnl_decode_image(const char* path, float* out, int max_h, int max_w,
                     int* out_h, int* out_w) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  if (img.h > max_h || img.w > max_w) return -2;
  const size_t n = (size_t)img.h * img.w * 3;
  for (size_t i = 0; i < n; ++i) out[i] = img.data[i] / kU8Max;
  *out_h = img.h;
  *out_w = img.w;
  return 0;
}

// Decode one image to uint8 RGB: the serving upload format (the forward
// divides by 255 on the card).
int fnl_decode_image_u8(const char* path, uint8_t* out, int max_h, int max_w,
                        int* out_h, int* out_w) {
  ImageU8 img;
  if (!decode_file(path, &img)) return -1;
  if (img.h > max_h || img.w > max_w) return -2;
  std::memcpy(out, img.data.data(), img.data.size());
  *out_h = img.h;
  *out_w = img.w;
  return 0;
}

// Encode uint8 RGB (h, w, 3) to a PNG file, every row with the Sub filter.
// level: zlib compression 0-9 (1 = fast, the serving default — PNG is
// lossless at every level, so the decoded pixels are identical; only file
// size/speed differ).  Returns 0 on success.
int fnl_encode_png(const char* path, const uint8_t* rgb, int h, int w,
                   int level) {
#ifdef FNL_LIBPNG
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  png_structp png =
      png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_write_struct(&png, nullptr);
    fclose(fp);
    return -2;
  }
  // constructed + filled BEFORE setjmp (h/w are parameters): a libpng
  // longjmp over a nontrivial object's initialization is UB and would leak
  // the row array on every failed encode
  std::vector<png_bytep> rows((size_t)h);
  for (int y = 0; y < h; ++y)
    rows[y] = (png_bytep)(rgb + (size_t)y * w * 3);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_write_struct(&png, &info);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_set_compression_level(png, level);
  png_set_filter(png, 0, PNG_FILTER_SUB);  // cheap filter, good for photos
  png_set_IHDR(png, info, (png_uint_32)w, (png_uint_32)h, 8,
               PNG_COLOR_TYPE_RGB, PNG_INTERLACE_NONE,
               PNG_COMPRESSION_TYPE_DEFAULT, PNG_FILTER_TYPE_DEFAULT);
  png_write_info(png, info);
  png_write_image(png, rows.data());
  png_write_end(png, info);
  png_destroy_write_struct(&png, &info);
  fclose(fp);
  return 0;
#else
  if (h <= 0 || w <= 0) return -2;
  std::vector<uint8_t> filtered, packed, file;
  try {
    const size_t stride = (size_t)w * 3;
    filtered.resize((size_t)h * (stride + 1));
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = rgb + (size_t)y * stride;
      uint8_t* dst = filtered.data() + (size_t)y * (stride + 1);
      dst[0] = 1;  // Sub
      for (size_t i = 0; i < stride; ++i)
        dst[1 + i] = (uint8_t)(src[i] - (i >= 3 ? src[i - 3] : 0));
    }
    uLongf packed_len = compressBound((uLong)filtered.size());
    packed.resize(packed_len);
    if (compress2(packed.data(), &packed_len, filtered.data(), (uLong)filtered.size(),
                  level) != Z_OK)
      return -2;
    uint8_t ihdr[13];
    put_be32(ihdr, (uint32_t)w);
    put_be32(ihdr + 4, (uint32_t)h);
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 2;   // RGB
    ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate, adaptive filters, no interlace
    file.assign(kPngSignature, kPngSignature + 8);
    put_chunk(&file, "IHDR", ihdr, 13);
    put_chunk(&file, "IDAT", packed.data(), packed_len);
    put_chunk(&file, "IEND", nullptr, 0);
  } catch (const std::bad_alloc&) {
    return -2;
  }
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  const bool written = fwrite(file.data(), 1, file.size(), fp) == file.size();
  return (fclose(fp) == 0 && written) ? 0 : -3;
#endif
}

// Load a batch of augmented pairs in parallel.
// hazy_paths/gt_paths: arrays of n C strings; seeds: n 64-bit seeds;
// out_hazy/out_gt: (n, crop, crop, 3) float32 buffers.
// Returns 0 on success, or the first nonzero per-example error code.
int fnl_load_pair_batch(const char** hazy_paths, const char** gt_paths, int n,
                        int crop, const uint64_t* seeds, float* out_hazy,
                        float* out_gt, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads < 1) num_threads = 1;
  std::vector<int> errs(n, 0);
  const size_t stride = (size_t)crop * crop * 3;
  std::vector<std::thread> threads;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += num_threads) {
      errs[i] = load_one_pair(hazy_paths[i], gt_paths[i], crop, seeds[i],
                              out_hazy + (size_t)i * stride,
                              out_gt + (size_t)i * stride);
    }
  };
  if (num_threads == 1) {
    worker(0);
  } else {
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker, t);
    for (auto& th : threads) th.join();
  }
  for (int i = 0; i < n; ++i)
    if (errs[i] != 0) return errs[i];
  return 0;
}

}  // extern "C"
