// C interface of the native runtime, bound from Python with ctypes
// (pop_up_slam_tpu_torch/io/native_loader.py).
//
// Counterpart of the reference's native/api.cc with the same entry
// points. Handles are opaque pointers created and destroyed here; image
// payloads are copied once into caller-provided buffers (the caller asks
// for the dimensions first). Errors come back through a per-call buffer.
// Every entry point refuses a null handle.

#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>

#include "png_codec.h"
#include "tum_loader.h"

using popup::Image;

namespace {

void SetErr(char* err_buf, int err_len, const std::string& msg) {
  if (!err_buf || err_len <= 0) return;
  std::snprintf(err_buf, static_cast<size_t>(err_len), "%s", msg.c_str());
}

struct SeqHandle {
  popup::Sequence seq;
  std::unique_ptr<popup::Prefetcher> prefetch;
  Image pending;  // the frame handed out by next_info, awaiting its copy
  double pending_stamp = 0.0;
  bool has_pending = false;
};

const void* Payload(const Image& img) {
  return img.bit_depth == 16 ? static_cast<const void*>(img.u16.data())
                             : static_cast<const void*>(img.u8.data());
}

bool MakeImage(const void* buf, int w, int h, int channels, int bit_depth,
               Image* img, std::string* err) {
  if (!buf || w <= 0 || h <= 0 || (channels != 1 && channels != 3) ||
      (bit_depth != 8 && bit_depth != 16)) {
    *err = "bad image arguments";
    return false;
  }
  img->width = w;
  img->height = h;
  img->channels = channels;
  img->bit_depth = bit_depth;
  size_t n = size_t(w) * h * channels;
  if (bit_depth == 16)
    img->u16.assign(static_cast<const uint16_t*>(buf),
                    static_cast<const uint16_t*>(buf) + n);
  else
    img->u8.assign(static_cast<const uint8_t*>(buf),
                   static_cast<const uint8_t*>(buf) + n);
  return true;
}

}  // namespace

extern "C" {

// The decoded dimensions (w, h, channels, bit_depth) of a file, from its
// header.
int popup_png_info(const char* path, int* w, int* h, int* channels,
                   int* bit_depth, char* err_buf, int err_len) {
  Image img;
  std::string err;
  if (!popup::PngInfo(path, &img, &err)) {
    SetErr(err_buf, err_len, err);
    return -1;
  }
  *w = img.width;
  *h = img.height;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  return 0;
}

// Decode a file into a caller buffer of buf_bytes (sized from
// popup_png_info); the decoded dimensions are written back.
int popup_png_decode(const char* path, void* buf, long buf_bytes, int* w,
                     int* h, int* channels, int* bit_depth, char* err_buf,
                     int err_len) {
  Image img;
  std::string err;
  try {
    if (!popup::DecodePng(path, &img, &err)) {
      SetErr(err_buf, err_len, err);
      return -1;
    }
  } catch (const std::exception& e) {
    SetErr(err_buf, err_len, std::string("decode failed: ") + e.what());
    return -1;
  }
  *w = img.width;
  *h = img.height;
  *channels = img.channels;
  *bit_depth = img.bit_depth;
  if (!buf || buf_bytes < 0 ||
      static_cast<size_t>(buf_bytes) < img.num_bytes()) {
    SetErr(err_buf, err_len, "buffer too small");
    return -1;
  }
  std::memcpy(buf, Payload(img), img.num_bytes());
  return 0;
}

int popup_png_encode(const char* path, const void* buf, int w, int h,
                     int channels, int bit_depth, char* err_buf,
                     int err_len) {
  Image img;
  std::string err;
  try {
    if (!MakeImage(buf, w, h, channels, bit_depth, &img, &err) ||
        !popup::EncodePng(path, img, &err)) {
      SetErr(err_buf, err_len, err);
      return -1;
    }
  } catch (const std::exception& e) {
    SetErr(err_buf, err_len, std::string("encode failed: ") + e.what());
    return -1;
  }
  return 0;
}

void* popup_seq_open(const char* root, char* err_buf, int err_len) {
  try {
    auto h = std::make_unique<SeqHandle>();
    std::string err;
    if (!popup::OpenSequence(root, &h->seq, &err)) {
      SetErr(err_buf, err_len, err);
      return nullptr;
    }
    return h.release();
  } catch (const std::exception& e) {
    SetErr(err_buf, err_len, std::string("open failed: ") + e.what());
    return nullptr;
  }
}

// Stops a running prefetch stream (joins its workers) and frees the
// handle.
void popup_seq_close(void* handle) { delete static_cast<SeqHandle*>(handle); }

int popup_seq_num_rgb(void* handle) {
  if (!handle) return -1;
  return static_cast<int>(static_cast<SeqHandle*>(handle)->seq.rgb.size());
}
int popup_seq_num_depth(void* handle) {
  if (!handle) return -1;
  return static_cast<int>(static_cast<SeqHandle*>(handle)->seq.depth.size());
}
int popup_seq_num_gt(void* handle) {
  if (!handle) return -1;
  return static_cast<int>(static_cast<SeqHandle*>(handle)->seq.gt.size());
}
int popup_seq_has_seg(void* handle) {
  if (!handle) return -1;
  return static_cast<SeqHandle*>(handle)->seq.seg.empty() ? 0 : 1;
}

// Copy out stamps: kind 0 = rgb, 1 = depth, 2 = gt.
int popup_seq_stamps(void* handle, int kind, double* out, int capacity) {
  if (!handle) return -1;
  auto* h = static_cast<SeqHandle*>(handle);
  auto fill = [&](auto const& v) {
    int n = std::min<int>(capacity, static_cast<int>(v.size()));
    for (int i = 0; i < n; ++i) out[i] = v[i].stamp;
    return n;
  };
  if (kind == 0) return fill(h->seq.rgb);
  if (kind == 1) return fill(h->seq.depth);
  if (kind == 2) return fill(h->seq.gt);
  return -1;
}

// Copy out ground-truth poses: (n, 7) doubles [tx ty tz qx qy qz qw].
int popup_seq_gt(void* handle, double* out, int capacity) {
  if (!handle) return -1;
  auto* h = static_cast<SeqHandle*>(handle);
  int n = std::min<int>(capacity, static_cast<int>(h->seq.gt.size()));
  for (int i = 0; i < n; ++i) {
    const auto& g = h->seq.gt[i];
    double* row = out + 7 * i;
    for (int k = 0; k < 3; ++k) row[k] = g.t[k];
    for (int k = 0; k < 4; ++k) row[3 + k] = g.q[k];
  }
  return n;
}

// File path of rgb frame i.
int popup_seq_rgb_path(void* handle, int i, char* out, int capacity) {
  if (!handle) return -1;
  auto* h = static_cast<SeqHandle*>(handle);
  if (i < 0 || i >= static_cast<int>(h->seq.rgb.size())) return -1;
  std::snprintf(out, static_cast<size_t>(capacity), "%s",
                h->seq.rgb[i].path.c_str());
  return 0;
}

// Associate two stamp arrays; writes up to `capacity` (i, j) pairs and
// returns how many there are.
int popup_associate(const double* a, int na, const double* b, int nb,
                    double max_difference, int* out_pairs, int capacity) {
  try {
    std::vector<double> va(a, a + na), vb(b, b + nb);
    auto pairs = popup::Associate(va, vb, max_difference);
    int n = std::min<int>(capacity, static_cast<int>(pairs.size()));
    for (int i = 0; i < n; ++i) {
      out_pairs[2 * i] = pairs[i].first;
      out_pairs[2 * i + 1] = pairs[i].second;
    }
    return static_cast<int>(pairs.size());
  } catch (const std::exception&) {
    return -1;
  }
}

// Start a prefetch stream over the rgb frames (all of them, or the given
// indices in the given order). A running stream is stopped first.
int popup_prefetch_start(void* handle, const int* indices, int n_indices,
                         int num_threads, int lookahead, char* err_buf,
                         int err_len) {
  if (!handle) {
    SetErr(err_buf, err_len, "sequence is closed");
    return -1;
  }
  auto* h = static_cast<SeqHandle*>(handle);
  try {
    std::vector<popup::StampedFile> files;
    if (indices && n_indices > 0) {
      files.reserve(n_indices);
      for (int k = 0; k < n_indices; ++k) {
        int i = indices[k];
        if (i < 0 || i >= static_cast<int>(h->seq.rgb.size())) {
          SetErr(err_buf, err_len,
                 "frame index " + std::to_string(i) + " out of range");
          return -1;
        }
        files.push_back(h->seq.rgb[i]);
      }
    } else {
      files = h->seq.rgb;
    }
    h->prefetch.reset();
    h->prefetch = std::make_unique<popup::Prefetcher>(std::move(files),
                                                      num_threads, lookahead);
  } catch (const std::exception& e) {
    SetErr(err_buf, err_len, std::string("prefetch start failed: ") +
                                 e.what());
    return -1;
  }
  h->has_pending = false;
  return 0;
}

// Phase 1: wait for the next frame and report its dimensions.
// Returns 1 ok, 0 end of stream, -1 error.
int popup_prefetch_next_info(void* handle, int* w, int* h_, int* channels,
                             int* bit_depth, double* stamp, char* err_buf,
                             int err_len) {
  if (!handle) {
    SetErr(err_buf, err_len, "sequence is closed");
    return -1;
  }
  auto* h = static_cast<SeqHandle*>(handle);
  if (!h->prefetch) {
    SetErr(err_buf, err_len, "prefetch not started");
    return -1;
  }
  std::string err;
  if (!h->prefetch->NextFrame(&h->pending, &h->pending_stamp, &err)) {
    if (err.empty()) return 0;
    SetErr(err_buf, err_len, err);
    return -1;
  }
  h->has_pending = true;
  *w = h->pending.width;
  *h_ = h->pending.height;
  *channels = h->pending.channels;
  *bit_depth = h->pending.bit_depth;
  *stamp = h->pending_stamp;
  return 1;
}

// Phase 2: copy the pending frame into the caller buffer.
int popup_prefetch_next_copy(void* handle, void* buf, long buf_bytes,
                             char* err_buf, int err_len) {
  if (!handle) {
    SetErr(err_buf, err_len, "sequence is closed");
    return -1;
  }
  auto* h = static_cast<SeqHandle*>(handle);
  if (!h->has_pending) {
    SetErr(err_buf, err_len, "no pending frame");
    return -1;
  }
  size_t need = h->pending.num_bytes();
  if (buf_bytes < 0 || static_cast<size_t>(buf_bytes) < need) {
    SetErr(err_buf, err_len, "buffer too small");
    return -1;
  }
  std::memcpy(buf, Payload(h->pending), need);
  h->has_pending = false;
  h->pending = Image{};
  return 0;
}

// Stop the stream: the workers finish a decode in flight and are joined.
void popup_prefetch_stop(void* handle) {
  if (handle) static_cast<SeqHandle*>(handle)->prefetch.reset();
}

}  // extern "C"
