#include "png_codec.h"

#include <zlib.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace popup {

namespace {

const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t ReadU32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void PutU32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back(uint8_t(v >> 24));
  out->push_back(uint8_t(v >> 16));
  out->push_back(uint8_t(v >> 8));
  out->push_back(uint8_t(v));
}

// The Paeth predictor in int: p = a + b - c leaves the byte range.
inline int Paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters in place. raw holds rows * (stride + 1) bytes,
// each row led by its filter byte; out receives rows * stride bytes.
bool Unfilter(const uint8_t* raw, size_t rows, size_t stride, size_t bpp,
              uint8_t* out, std::string* err) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (size_t r = 0; r < rows; ++r) {
    const uint8_t* x = raw + r * (stride + 1);
    int kind = x[0];
    ++x;
    uint8_t* cur = out + r * stride;
    switch (kind) {
      case 0:
        std::memcpy(cur, x, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(x[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) cur[i] = uint8_t(x[i] + prev[i]);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = uint8_t(x[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = uint8_t(x[i] + Paeth(a, prev[i], c));
        }
        break;
      default:
        *err = "PNG: unknown row filter " + std::to_string(kind);
        return false;
    }
    prev = cur;
  }
  return true;
}

bool Inflate(const std::vector<uint8_t>& in, uint8_t* out, size_t out_size,
             std::string* err) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    *err = "PNG: inflateInit failed";
    return false;
  }
  zs.next_in = const_cast<Bytef*>(in.data());
  zs.avail_in = static_cast<uInt>(in.size());
  zs.next_out = out;
  zs.avail_out = static_cast<uInt>(out_size);
  int rc = inflate(&zs, Z_FINISH);
  bool full = zs.avail_out == 0;
  std::string msg = zs.msg ? zs.msg : std::to_string(rc);
  inflateEnd(&zs);
  // the rows must all be there; data after the last row is ignored, as
  // libpng does
  if (!full || !(rc == Z_STREAM_END || rc == Z_OK || rc == Z_BUF_ERROR)) {
    *err = "PNG: bad or truncated image data (zlib: " + msg + ")";
    return false;
  }
  return true;
}

// Channels of a color type (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA), or 0.
int SourceChannels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// Check the header fields and fill the output format of *out.
bool CheckFormat(uint32_t w, uint32_t h, int depth, int color, int interlace,
                 Image* out, std::string* err) {
  int src_ch = SourceChannels(color);
  if (src_ch == 0 || (depth != 8 && depth != 16) || interlace != 0 ||
      w == 0 || h == 0) {
    *err = "PNG: unsupported format (bit depth " + std::to_string(depth) +
           ", color type " + std::to_string(color) + ", interlace " +
           std::to_string(interlace) +
           "); 8- and 16-bit gray, gray+alpha, RGB and RGBA are read";
    return false;
  }
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->channels = src_ch <= 2 ? 1 : 3;
  out->bit_depth = depth == 16 && src_ch <= 2 ? 16 : 8;
  return true;
}

bool ReadFile(const std::string& path, std::vector<uint8_t>* out,
              std::string* err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0)
    out->insert(out->end(), buf, buf + n);
  bool ok = !std::ferror(f);
  std::fclose(f);
  if (!ok) *err = "read error on " + path;
  return ok;
}

}  // namespace

bool DecodePngBytes(const uint8_t* data, size_t size, Image* out,
                    std::string* err) {
  if (size < 8 || std::memcmp(data, kSignature, 8) != 0) {
    *err = "not a PNG file";
    return false;
  }
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  bool have_header = false;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= size) {
    uint32_t n = ReadU32(data + pos);
    const uint8_t* kind = data + pos + 4;
    if (n > size - pos - 12) {
      *err = "PNG: truncated chunk";
      return false;
    }
    const uint8_t* body = kind + 4;
    uint32_t crc = static_cast<uint32_t>(crc32(0L, kind, 4 + n));
    if (crc != ReadU32(body + n)) {
      *err = "PNG: CRC mismatch in chunk " + std::string((const char*)kind, 4);
      return false;
    }
    if (std::memcmp(kind, "IHDR", 4) == 0 && n == 13) {
      w = ReadU32(body);
      h = ReadU32(body + 4);
      depth = body[8];
      color = body[9];
      interlace = body[12];
      have_header = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + n);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + size_t(n);
  }
  if (!have_header) {
    *err = "PNG: no IHDR chunk";
    return false;
  }
  if (!CheckFormat(w, h, depth, color, interlace, out, err)) return false;
  int src_ch = SourceChannels(color);
  size_t nbytes = size_t(depth) / 8;
  size_t bpp = size_t(src_ch) * nbytes;
  size_t stride = size_t(w) * bpp;
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  if (!Inflate(idat, raw.data(), raw.size(), err)) return false;
  std::vector<uint8_t> px(size_t(h) * stride);
  if (!Unfilter(raw.data(), h, stride, bpp, px.data(), err)) return false;

  bool keep16 = out->bit_depth == 16;
  int out_ch = out->channels;
  size_t npx = size_t(w) * h;
  if (!keep16 && nbytes == 1 && src_ch == out_ch) {  // 8-bit gray, RGB
    out->u16.clear();
    out->u8 = std::move(px);
  } else if (keep16) {  // big-endian samples to host order, alpha dropped
    out->u8.clear();
    out->u16.resize(npx);
    for (size_t i = 0; i < npx; ++i) {
      const uint8_t* s = px.data() + i * bpp;
      out->u16[i] = uint16_t((s[0] << 8) | s[1]);
    }
  } else {  // the high byte of each kept sample
    out->u16.clear();
    out->u8.resize(npx * out_ch);
    for (size_t i = 0; i < npx; ++i) {
      const uint8_t* s = px.data() + i * bpp;
      for (int c = 0; c < out_ch; ++c) out->u8[i * out_ch + c] = s[c * nbytes];
    }
  }
  return true;
}

bool PngInfo(const std::string& path, Image* out, std::string* err) {
  uint8_t head[33];  // signature, IHDR length and type, 13 bytes, CRC
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  size_t got = std::fread(head, 1, sizeof(head), f);
  std::fclose(f);
  if (got != sizeof(head) || std::memcmp(head, kSignature, 8) != 0 ||
      std::memcmp(head + 12, "IHDR", 4) != 0) {
    *err = "not a PNG file (" + path + ")";
    return false;
  }
  const uint8_t* b = head + 16;
  return CheckFormat(ReadU32(b), ReadU32(b + 4), b[8], b[9], b[12], out,
                     err);
}

bool DecodePng(const std::string& path, Image* out, std::string* err) {
  std::vector<uint8_t> data;
  if (!ReadFile(path, &data, err)) return false;
  if (!DecodePngBytes(data.data(), data.size(), out, err)) {
    *err += " (" + path + ")";
    return false;
  }
  return true;
}

bool EncodePngBytes(const Image& img, std::vector<uint8_t>* out,
                    std::string* err) {
  if (img.bit_depth != 8 && img.bit_depth != 16) {
    *err = "unsupported bit depth";
    return false;
  }
  if (img.bit_depth == 16 && img.channels != 1) {
    *err = "16-bit encode supports 1 channel only";
    return false;
  }
  if (img.channels != 1 && img.channels != 3) {
    *err = "encode supports 1 or 3 channels";
    return false;
  }
  size_t stride = size_t(img.width) * img.channels * (img.bit_depth / 8);
  std::vector<uint8_t> raw;
  raw.reserve(size_t(img.height) * (stride + 1));
  for (int y = 0; y < img.height; ++y) {
    raw.push_back(0);  // filter 0
    if (img.bit_depth == 16) {
      const uint16_t* row = img.u16.data() + size_t(y) * img.width;
      for (int x = 0; x < img.width; ++x) {
        raw.push_back(uint8_t(row[x] >> 8));
        raw.push_back(uint8_t(row[x]));
      }
    } else {
      const uint8_t* row = img.u8.data() + size_t(y) * stride;
      raw.insert(raw.end(), row, row + stride);
    }
  }
  uLongf zlen = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), static_cast<uLong>(raw.size()),
                Z_DEFAULT_COMPRESSION) != Z_OK) {
    *err = "PNG: deflate failed";
    return false;
  }
  z.resize(zlen);

  auto chunk = [out](const char* kind, const uint8_t* body, size_t n) {
    PutU32(out, static_cast<uint32_t>(n));
    size_t start = out->size();
    out->insert(out->end(), kind, kind + 4);
    out->insert(out->end(), body, body + n);
    PutU32(out, static_cast<uint32_t>(
                    crc32(0L, out->data() + start, static_cast<uInt>(4 + n))));
  };
  out->assign(kSignature, kSignature + 8);
  uint8_t ihdr[13];
  uint32_t dims[2] = {uint32_t(img.width), uint32_t(img.height)};
  for (int k = 0; k < 2; ++k)
    for (int b = 0; b < 4; ++b) ihdr[4 * k + b] = uint8_t(dims[k] >> (24 - 8 * b));
  ihdr[8] = uint8_t(img.bit_depth);
  ihdr[9] = img.channels == 3 ? 2 : 0;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", z.data(), z.size());
  chunk("IEND", nullptr, 0);
  return true;
}

bool EncodePng(const std::string& path, const Image& img, std::string* err) {
  std::vector<uint8_t> bytes;
  if (!EncodePngBytes(img, &bytes, err)) return false;
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) {
    *err = "cannot open for write: " + path;
    return false;
  }
  bool ok = std::fwrite(bytes.data(), 1, bytes.size(), f) == bytes.size();
  ok = (std::fclose(f) == 0) && ok;
  if (!ok) *err = "write error on " + path;
  return ok;
}

}  // namespace popup
