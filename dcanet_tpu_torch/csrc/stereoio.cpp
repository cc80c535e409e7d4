// stereoio: host-side PNG decoding and ImageNet normalisation for the data
// pipeline (dcanet_tpu_torch/data/native.py).
//
// Replaces dcanet_tpu/data/native.py's library, native/stereoio.cpp, which
// calls libpng. This one needs the C++ standard library alone: the caller
// inflates the joined IDAT stream (Python's zlib.decompress, which releases
// the interpreter lock), and this file does the rest of a PNG decode. It is
// built by the host compiler (kernels/build.py) and loaded with ctypes,
// whose CDLL calls run without the interpreter lock, so the loader's decode
// threads run in parallel.
//
// The decoded form is what the JAX package's libpng reader gives after
// png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8 and
// png_set_strip_alpha, as float32 written straight into the caller's buffer:
//   grey (and grey + alpha)      -> (H, W), 1/2/4-bit grey scaled to 8 bits
//   RGB, RGBA and palette        -> (H, W, 3), tRNS and alpha dropped
//   8-bit samples in [0, 255], 16-bit samples raw (big-endian in the file)
// With palette_index set, a palette image gives its indices, (H, W), as
// PIL's array of a "P" image does.
//
// C interface (every int return is 0 on success, else a negative code; the
// codes are named in data/native.py):
//   sio_png_parse(file, n, header, palette, idat, idat_n)
//       checks the signature, chunk bounds, critical chunks' CRCs and IHDR,
//       copies PLTE into palette (768 bytes, zero-filled by the caller) and
//       the IDAT payloads, joined, into idat (capacity n); header (int64[8])
//       gets width, height, bit depth, colour type, interlace, samples per
//       pixel in the file, palette entries, and the inflated stream's length.
//   sio_png_reconstruct(raw, raw_n, header, palette, palette_index, out, out_n)
//       undoes the five row filters of the inflated stream, pass by pass
//       for Adam7, and writes the decoded form into out (out_n floats).
//   sio_normalize_imagenet(img255, out, npix)
//       (x / 255 - mean) / std of (npix, 3) float32, as the JAX package's.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Status {
  kOk = 0,
  kNotPng = -1,
  kTruncated = -2,
  kBadCrc = -3,
  kBadHeader = -4,
  kBadPalette = -5,
  kNoImageData = -6,
  kShortImageData = -7,
  kBadFilter = -8,
  kBadOutput = -9,
  kUnknownCriticalChunk = -10,
};

struct CrcTables {
  // slicing-by-8 tables of the PNG (zlib) CRC-32, reflected polynomial
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32(const uint8_t* p, int64_t n) {
  static const CrcTables tables;  // initialised once, thread-safe (C++11)
  const auto& t = tables.t;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {
    const uint32_t lo = c ^ (p[0] | p[1] << 8 | p[2] << 16 | uint32_t(p[3]) << 24);
    const uint32_t hi = p[4] | p[5] << 8 | p[6] << 16 | uint32_t(p[7]) << 24;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n > 0; --n) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

int samples_per_pixel(int color) {
  switch (color) {
    case 0: return 1;  // grey
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // grey + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool valid_depth(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

int64_t row_bytes(int64_t width, int spp, int depth) { return (width * spp * depth + 7) / 8; }

// Adam7's passes: first column, first row, column step, row step. A plain
// image is one pass of (0, 0, 1, 1).
struct Pass { int x0, y0, dx, dy; };
constexpr Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                            {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
constexpr Pass kPlain = {0, 0, 1, 1};

int64_t pass_extent(int64_t size, int first, int step) {
  return size > first ? (size - first + step - 1) / step : 0;
}

int64_t image_bytes(int64_t w, int64_t h, int spp, int depth, int interlace) {
  if (!interlace) return h * (1 + row_bytes(w, spp, depth));
  int64_t total = 0;
  for (const Pass& p : kAdam7) {
    const int64_t pw = pass_extent(w, p.x0, p.dx), ph = pass_extent(h, p.y0, p.dy);
    if (pw > 0 && ph > 0) total += ph * (1 + row_bytes(pw, spp, depth));
  }
  return total;
}

// The Paeth rows of one byte lane chain through the left neighbour, so a
// row is walked pixel by pixel with the BPP lanes side by side and the
// predictor chosen without branches (the choice follows the data: a branch
// on it mispredicts about as often as not on a textured image).
template <int BPP>
void unpaeth(const uint8_t* src, const uint8_t* prev, uint8_t* cur, int64_t n) {
  int a[BPP], c[BPP];
  for (int k = 0; k < BPP; ++k) {  // no left neighbour: the predictor is the byte above
    cur[k] = uint8_t(src[k] + prev[k]);
    a[k] = cur[k];
    c[k] = prev[k];
  }
  for (int64_t i = BPP; i < n; i += BPP)
    for (int k = 0; k < BPP; ++k) {
      const int b = prev[i + k];
      const int pa = std::abs(b - c[k]), pb = std::abs(a[k] - c[k]), pc = std::abs(a[k] + b - 2 * c[k]);
      int pred = pb <= pc ? b : c[k];
      pred = (pa <= pb) & (pa <= pc) ? a[k] : pred;
      a[k] = cur[i + k] = uint8_t(src[i + k] + pred);
      c[k] = b;
    }
}

// Undoes one row's filter: cur = src + predictor(left, up, up-left); the
// left neighbour is bpp bytes back (1 for sub-byte depths). n is a
// multiple of bpp.
bool unfilter(int type, const uint8_t* src, const uint8_t* prev, uint8_t* cur, int64_t n, int bpp) {
  switch (type) {
    case 0:
      std::memcpy(cur, src, n);
      return true;
    case 1:
      std::memcpy(cur, src, bpp);
      for (int64_t i = bpp; i < n; ++i) cur[i] = src[i] + cur[i - bpp];
      return true;
    case 2:
      for (int64_t i = 0; i < n; ++i) cur[i] = src[i] + prev[i];
      return true;
    case 3:
      for (int64_t i = 0; i < bpp; ++i) cur[i] = src[i] + (prev[i] >> 1);
      for (int64_t i = bpp; i < n; ++i) cur[i] = src[i] + ((cur[i - bpp] + prev[i]) >> 1);
      return true;
    case 4:
      switch (bpp) {  // the bytes per pixel PNG allows
        case 1: unpaeth<1>(src, prev, cur, n); return true;
        case 2: unpaeth<2>(src, prev, cur, n); return true;
        case 3: unpaeth<3>(src, prev, cur, n); return true;
        case 4: unpaeth<4>(src, prev, cur, n); return true;
        case 6: unpaeth<6>(src, prev, cur, n); return true;
        default: unpaeth<8>(src, prev, cur, n); return true;
      }
    default:
      return false;
  }
}

struct Format {
  int depth, color, spp;
  const uint8_t* palette;
  bool palette_index;
  int out_channels;
};

// Writes the pw pixels of one reconstructed row; pixel x goes to
// o[x * step], its channels contiguous.
void emit_row(const Format& f, const uint8_t* row, int64_t pw, float* o, int64_t step) {
  if (f.depth < 8) {  // grey or palette, several samples to a byte, first one high
    const int per = 8 / f.depth, mask = (1 << f.depth) - 1, scale = 255 / mask;
    for (int64_t x = 0; x < pw; ++x) {
      const int s = (row[x / per] >> (8 - f.depth * (x % per + 1))) & mask;
      float* q = o + x * step;
      if (f.color == 0) {
        q[0] = float(s * scale);
      } else if (f.palette_index) {
        q[0] = float(s);
      } else {
        q[0] = f.palette[3 * s];
        q[1] = f.palette[3 * s + 1];
        q[2] = f.palette[3 * s + 2];
      }
    }
  } else if (f.color == 3) {
    for (int64_t x = 0; x < pw; ++x) {
      const int s = row[x];
      float* q = o + x * step;
      if (f.palette_index) {
        q[0] = float(s);
      } else {
        q[0] = f.palette[3 * s];
        q[1] = f.palette[3 * s + 1];
        q[2] = f.palette[3 * s + 2];
      }
    }
  } else if (f.depth == 8 && f.spp == f.out_channels && step == f.spp) {  // grey or RGB, a plain image: one run
    for (int64_t i = 0; i < pw * f.spp; ++i) o[i] = row[i];
  } else if (f.depth == 8) {  // the first out_channels samples: alpha is last
    for (int64_t x = 0; x < pw; ++x)
      for (int k = 0; k < f.out_channels; ++k) o[x * step + k] = row[x * f.spp + k];
  } else {
    for (int64_t x = 0; x < pw; ++x)
      for (int k = 0; k < f.out_channels; ++k) {
        const uint8_t* s = row + 2 * (x * f.spp + k);
        o[x * step + k] = float(s[0] << 8 | s[1]);
      }
  }
}

}  // namespace

extern "C" {

int sio_png_parse(const uint8_t* file, int64_t n, int64_t* header, uint8_t* palette, uint8_t* idat,
                  int64_t* idat_n) {
  static const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(file, kSignature, 8) != 0) return kNotPng;
  int64_t pos = 8, joined = 0, entries = 0;
  bool have_header = false, have_data = false;
  int width = 0, height = 0, depth = 0, color = 0, interlace = 0;
  while (pos < n) {
    if (n - pos < 12) return kTruncated;
    const int64_t len = be32(file + pos);
    const uint8_t* type = file + pos + 4;
    const uint8_t* body = file + pos + 8;
    if (len > 0x7FFFFFFF || n - pos - 12 < len) return kTruncated;
    const bool critical = !(type[0] & 0x20);
    if (critical && crc32(type, len + 4) != be32(body + len)) return kBadCrc;
    pos += 12 + len;
    if (!have_header) {  // IHDR comes first
      if (std::memcmp(type, "IHDR", 4) != 0 || len != 13) return kBadHeader;
      const uint32_t w = be32(body), h = be32(body + 4);
      width = int(w), height = int(h), depth = body[8], color = body[9], interlace = body[12];
      if (w == 0 || h == 0 || w > 0x7FFFFFFF || h > 0x7FFFFFFF || !valid_depth(color, depth) || body[10] != 0 ||
          body[11] != 0 || interlace > 1)
        return kBadHeader;
      have_header = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len == 0 || len > 768 || have_data) return kBadPalette;
      std::memcpy(palette, body, len);
      entries = len / 3;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      std::memcpy(idat + joined, body, len);
      joined += len;
      have_data = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    } else if (critical) {
      return kUnknownCriticalChunk;
    }
  }
  if (!have_header) return kTruncated;
  if (color == 3 && entries == 0) return kBadPalette;
  if (!have_data) return kNoImageData;
  const int spp = samples_per_pixel(color);
  const int64_t fields[8] = {width, height, depth, color, interlace, spp, entries,
                             image_bytes(width, height, spp, depth, interlace)};
  std::memcpy(header, fields, sizeof(fields));
  *idat_n = joined;
  return kOk;
}

int sio_png_reconstruct(const uint8_t* raw, int64_t raw_n, const int64_t* header, const uint8_t* palette,
                        int palette_index, float* out, int64_t out_n) {
  const int64_t w = header[0], h = header[1];
  Format f{int(header[2]), int(header[3]), int(header[5]), palette, palette_index != 0, 1};
  if (f.color == 2 || f.color == 6 || (f.color == 3 && !f.palette_index)) f.out_channels = 3;
  if (raw_n < header[7]) return kShortImageData;
  if (out_n != w * h * f.out_channels) return kBadOutput;
  const int bpp = f.spp * f.depth >= 8 ? f.spp * f.depth / 8 : 1;
  const int64_t full_row = row_bytes(w, f.spp, f.depth);
  std::vector<uint8_t> rows(2 * full_row);
  const uint8_t* src = raw;
  const bool adam7 = header[4] != 0;
  for (int pi = 0; pi < (adam7 ? 7 : 1); ++pi) {
    const Pass& p = adam7 ? kAdam7[pi] : kPlain;
    const int64_t pw = pass_extent(w, p.x0, p.dx), ph = pass_extent(h, p.y0, p.dy);
    if (pw == 0 || ph == 0) continue;  // an empty pass has no rows, not even filter bytes
    const int64_t n = row_bytes(pw, f.spp, f.depth);
    uint8_t* prev = rows.data();
    uint8_t* cur = rows.data() + full_row;
    std::memset(prev, 0, n);  // each pass starts with a row of zeros above it
    for (int64_t r = 0; r < ph; ++r) {
      if (!unfilter(src[0], src + 1, prev, cur, n, bpp)) return kBadFilter;
      src += 1 + n;
      const int64_t y = p.y0 + r * p.dy;
      emit_row(f, cur, pw, out + (y * w + p.x0) * f.out_channels, int64_t(p.dx) * f.out_channels);
      uint8_t* t = prev;
      prev = cur;
      cur = t;
    }
  }
  return kOk;
}

void sio_normalize_imagenet(const float* img255, float* out, int64_t npix) {
  static const float mean[3] = {0.485f, 0.456f, 0.406f};
  static const float inv_std[3] = {1.0f / 0.229f, 1.0f / 0.224f, 1.0f / 0.225f};
  // x / 255 - mean as one fused multiply-add, rounded once whatever the
  // compiler's flags: the JAX package's library is built with -march=native
  // and fuses it there
  for (int64_t i = 0; i < npix; ++i)
    for (int k = 0; k < 3; ++k)
      out[3 * i + k] = std::fma(img255[3 * i + k], 1.0f / 255.0f, -mean[k]) * inv_std[k];
}

}  // extern "C"
