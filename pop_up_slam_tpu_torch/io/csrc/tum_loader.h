// TUM-sequence loader, timestamp association and a threaded prefetch
// scheduler.
//
// Counterpart of the reference's native/tum_loader.{h,cc}: a C++ worker
// pool decodes frames ahead of the consumer into a bounded in-order
// window, and NextFrame hands the Python layer a ready host buffer while
// the workers keep decoding (ctypes releases the GIL around each call).
#pragma once

#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include "png_codec.h"

namespace popup {

struct StampedFile {
  double stamp;
  std::string path;  // root-joined
};

struct GtPose {
  double stamp;
  double t[3];
  double q[4];  // x y z w (TUM order)
};

// Parsed index files of one TUM sequence directory.
struct Sequence {
  std::string root;
  std::vector<StampedFile> rgb;
  std::vector<StampedFile> depth;
  std::vector<StampedFile> seg;  // aligned with rgb; path empty if absent
  std::vector<GtPose> gt;
};

// Parse rgb.txt (required), depth.txt and groundtruth.txt (optional) and
// the optional seg/ directory.
bool OpenSequence(const std::string& root, Sequence* out, std::string* err);

// Greedy nearest-stamp association (TUM's associate.py; the Python
// version is evaluation.ate.associate): candidate pairs closer than
// max_difference, taken by increasing distance, each side used once,
// returned sorted by i.
std::vector<std::pair<int, int>> Associate(const std::vector<double>& a,
                                           const std::vector<double>& b,
                                           double max_difference);

// In-order prefetching decoder over a list of files.
class Prefetcher {
 public:
  // `lookahead` bounds how far the workers run ahead of the consumer.
  Prefetcher(std::vector<StampedFile> files, int num_threads, int lookahead);
  // Stops the workers (a decode in flight finishes first) and joins them.
  ~Prefetcher();

  // Blocks until the next frame is decoded and moves it out. Returns
  // false at the end (err empty) or on that frame's decode error.
  bool NextFrame(Image* out, double* stamp, std::string* err);

 private:
  struct Slot {
    enum State { kEmpty, kClaimed, kReady, kError };
    State state = kEmpty;
    Image img;
    std::string err;
  };

  void WorkerLoop();

  std::vector<StampedFile> files_;
  std::vector<Slot> slots_;  // one per frame, released once handed out
  int lookahead_;
  std::mutex mu_;
  std::condition_variable cv_ready_;  // the consumer waits for its frame
  std::condition_variable cv_space_;  // workers wait for window space
  int next_claim_ = 0;                // next frame index to decode
  int consumer_pos_ = 0;              // next frame index to hand out
  bool stop_ = false;
  std::vector<std::thread> workers_;
};

}  // namespace popup
