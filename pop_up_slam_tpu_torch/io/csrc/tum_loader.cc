#include "tum_loader.h"

#include <sys/stat.h>

#include <algorithm>
#include <cmath>
#include <exception>
#include <fstream>
#include <sstream>

namespace popup {

namespace {

bool FileExists(const std::string& p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0;
}

std::string Basename(const std::string& p) {
  size_t k = p.find_last_of('/');
  return k == std::string::npos ? p : p.substr(k + 1);
}

using IndexLines = std::vector<std::pair<double, std::vector<std::string>>>;

// Parse "timestamp rest..." index lines, skipping comments and blanks.
bool ReadIndex(const std::string& path, IndexLines* out) {
  std::ifstream f(path);
  if (!f.is_open()) return false;
  std::string line;
  while (std::getline(f, line)) {
    size_t first = line.find_first_not_of(" \t\r");
    if (first == std::string::npos || line[first] == '#') continue;
    std::istringstream ss(line);
    double stamp;
    if (!(ss >> stamp)) continue;
    std::vector<std::string> rest;
    std::string tok;
    while (ss >> tok) rest.push_back(tok);
    out->emplace_back(stamp, std::move(rest));
  }
  return true;
}

}  // namespace

bool OpenSequence(const std::string& root, Sequence* out, std::string* err) {
  out->root = root;
  IndexLines idx;
  if (!ReadIndex(root + "/rgb.txt", &idx)) {
    *err = "missing " + root + "/rgb.txt";
    return false;
  }
  for (auto& [stamp, rest] : idx)
    if (!rest.empty()) out->rgb.push_back({stamp, root + "/" + rest[0]});
  idx.clear();
  if (ReadIndex(root + "/depth.txt", &idx))
    for (auto& [stamp, rest] : idx)
      if (!rest.empty()) out->depth.push_back({stamp, root + "/" + rest[0]});
  idx.clear();
  if (ReadIndex(root + "/groundtruth.txt", &idx)) {
    for (auto& [stamp, rest] : idx) {
      if (rest.size() < 7) continue;
      GtPose g;
      g.stamp = stamp;
      try {
        for (int k = 0; k < 3; ++k) g.t[k] = std::stod(rest[k]);
        for (int k = 0; k < 4; ++k) g.q[k] = std::stod(rest[3 + k]);
      } catch (const std::exception&) {
        *err = "bad ground-truth line in " + root + "/groundtruth.txt";
        return false;
      }
      out->gt.push_back(g);
    }
  }
  if (FileExists(root + "/seg")) {
    out->seg.reserve(out->rgb.size());
    for (const auto& r : out->rgb) {
      std::string cand = root + "/seg/" + Basename(r.path);
      out->seg.push_back({r.stamp, FileExists(cand) ? cand : std::string()});
    }
  }
  return true;
}

std::vector<std::pair<int, int>> Associate(const std::vector<double>& a,
                                           const std::vector<double>& b,
                                           double max_difference) {
  struct Cand {
    double d;
    int i, j;
  };
  std::vector<Cand> cands;
  // scan b in stamp order, bounded by binary search
  std::vector<int> order(b.size());
  for (size_t k = 0; k < b.size(); ++k) order[k] = static_cast<int>(k);
  std::stable_sort(order.begin(), order.end(),
                   [&](int x, int y) { return b[x] < b[y]; });
  std::vector<double> bs(b.size());
  for (size_t k = 0; k < b.size(); ++k) bs[k] = b[order[k]];
  for (size_t i = 0; i < a.size(); ++i) {
    auto lo = std::lower_bound(bs.begin(), bs.end(), a[i] - max_difference);
    auto hi = std::upper_bound(bs.begin(), bs.end(), a[i] + max_difference);
    for (auto it = lo; it != hi; ++it) {
      int j = order[it - bs.begin()];
      double d = std::fabs(a[i] - b[j]);
      if (d < max_difference) cands.push_back({d, static_cast<int>(i), j});
    }
  }
  // equal distances in the candidates' row-major (i, j) order, as a
  // stable sort of them does
  std::sort(cands.begin(), cands.end(), [](const Cand& x, const Cand& y) {
    if (x.d != y.d) return x.d < y.d;
    if (x.i != y.i) return x.i < y.i;
    return x.j < y.j;
  });
  std::vector<char> used_a(a.size(), 0), used_b(b.size(), 0);
  std::vector<std::pair<int, int>> out;
  for (const auto& c : cands) {
    if (used_a[c.i] || used_b[c.j]) continue;
    used_a[c.i] = used_b[c.j] = 1;
    out.emplace_back(c.i, c.j);
  }
  std::sort(out.begin(), out.end());
  return out;
}

Prefetcher::Prefetcher(std::vector<StampedFile> files, int num_threads,
                       int lookahead)
    : files_(std::move(files)),
      slots_(files_.size()),
      lookahead_(std::max(lookahead, 1)) {
  num_threads = std::max(1, num_threads);
  workers_.reserve(num_threads);
  for (int k = 0; k < num_threads; ++k)
    workers_.emplace_back([this] { WorkerLoop(); });
}

Prefetcher::~Prefetcher() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_ = true;
  }
  cv_space_.notify_all();
  cv_ready_.notify_all();
  for (auto& t : workers_) t.join();
}

void Prefetcher::WorkerLoop() {
  for (;;) {
    int idx;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [this] {
        return stop_ || (next_claim_ < static_cast<int>(files_.size()) &&
                         next_claim_ < consumer_pos_ + lookahead_);
      });
      if (stop_) return;
      idx = next_claim_++;
      slots_[idx].state = Slot::kClaimed;
    }
    Image img;
    std::string err;
    bool ok;
    try {  // nothing may escape a worker thread: it would terminate
      ok = DecodePng(files_[idx].path, &img, &err);
    } catch (const std::exception& e) {
      ok = false;
      err = std::string("decode of ") + files_[idx].path + " failed: " +
            e.what();
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stop_) return;
      if (ok) {
        slots_[idx].img = std::move(img);
        slots_[idx].state = Slot::kReady;
      } else {
        slots_[idx].err = std::move(err);
        slots_[idx].state = Slot::kError;
      }
    }
    cv_ready_.notify_all();
  }
}

bool Prefetcher::NextFrame(Image* out, double* stamp, std::string* err) {
  std::unique_lock<std::mutex> lk(mu_);
  if (consumer_pos_ >= static_cast<int>(files_.size())) {
    err->clear();
    return false;  // end of the stream
  }
  int idx = consumer_pos_;
  cv_ready_.wait(lk, [this, idx] {
    return stop_ || slots_[idx].state == Slot::kReady ||
           slots_[idx].state == Slot::kError;
  });
  if (stop_) {
    *err = "prefetcher stopped";
    return false;
  }
  ++consumer_pos_;
  bool ok = slots_[idx].state == Slot::kReady;
  if (ok) {
    *out = std::move(slots_[idx].img);
    *stamp = files_[idx].stamp;
  } else {
    *err = slots_[idx].err;
  }
  slots_[idx] = Slot{};  // release storage; the window slides forward
  lk.unlock();
  cv_space_.notify_all();
  return ok;
}

}  // namespace popup
