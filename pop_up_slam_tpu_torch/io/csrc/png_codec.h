// PNG decode/encode on zlib alone (no libpng).
//
// Counterpart of the reference's native/png_codec.{h,cc}, which link
// libpng.  Decode inflates the IDAT stream with zlib and undoes the five
// row filters (0-4) here; encode writes filter 0 on every row and
// deflates with zlib at its default level, in one IDAT chunk.
//
// Formats (not interlaced), as the reference's decoder returns them:
//   - 8-bit gray, gray+alpha, RGB, RGBA -> 8-bit, 1 or 3 channels (alpha
//     dropped);
//   - 16-bit gray, gray+alpha           -> uint16 in host order, 1 channel;
//   - 16-bit RGB, RGBA                  -> 8-bit RGB (the high byte).
// Palette and sub-byte depths are refused with an error.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

namespace popup {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;   // 1 or 3
  int bit_depth = 0;  // 8 or 16
  // 8-bit data lives in u8 (h*w*c); 16-bit in u16 (h*w, channels==1).
  std::vector<uint8_t> u8;
  std::vector<uint16_t> u16;

  size_t num_bytes() const {
    return bit_depth == 16 ? u16.size() * 2 : u8.size();
  }
};

// The decoded image's dimensions (width, height, channels, bit_depth
// filled, pixel storage left empty) from the file's header alone.
bool PngInfo(const std::string& path, Image* out, std::string* err);

// Decode PNG bytes. Returns true on success; on failure fills *err.
bool DecodePngBytes(const uint8_t* data, size_t size, Image* out,
                    std::string* err);

// Decode a PNG file.
bool DecodePng(const std::string& path, Image* out, std::string* err);

// Encode to PNG bytes (8-bit gray/RGB or 16-bit gray).
bool EncodePngBytes(const Image& img, std::vector<uint8_t>* out,
                    std::string* err);

// Encode an image to a PNG file.
bool EncodePng(const std::string& path, const Image& img, std::string* err);

}  // namespace popup
