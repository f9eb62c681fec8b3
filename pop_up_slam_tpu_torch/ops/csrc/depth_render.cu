// K2: dense depth render of the popped-up plane model.
//
// Replaces pop_up_slam_tpu/ops/depth_render.py::depth_render_pallas (row
// tiles of a padded f32 mask, per-wall scalars in SMEM).  Here one wave of
// blocks (at most kBlocksPerSM resident per SM) walks the image with a
// grid-stride loop, four consecutive pixels (of the row-major image) per
// thread and step: one 4-byte mask load and one 16-byte depth store,
// scalar accesses for the last H*W % 4 pixels or unaligned pointers.
// Each block's prologue stages the camera, the pose, the ground plane and
// the terms of the valid walls, in wall order (one thread per wall,
// computed from the pop-up's planes, endpoints, clipped and valid flags),
// in shared memory once, so the whole render is a single launch with no
// parameter packing.  A thread reads each wall's terms once for its four
// pixels and runs the four pixels' tests side by side (independent
// chains); when all four are ground pixels (mask set and the ground ray
// hits) it skips the wall loop, whose result they would discard.  The
// per-pixel arithmetic is the same expressions in the same order as the
// one-pixel-per-thread kernel it replaced, so the output is the same bit
// for bit.
//
// Bound on the H100: per frame it reads H*W mask bytes and writes H*W f32
// depths (0.3 MB + 1.2 MB at 480x640) against ~20 flops per pixel and
// wall, so it is memory- and launch-bound; the design reads and writes
// each pixel exactly once, coalesced and 16 bytes a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// shared block: fx fy cx cy | R_wc (9) | t_wc (3) | ground_c (4); then per
// valid wall: n (3) | num | e0 (2) | d_unit (2) | seg_len | lo_pad | hi_pad
constexpr int kHdr = 20;
constexpr int kPerWall = 11;
constexpr int kMaxThreads = 1024;
constexpr int kBlocksPerSM = 2;  // of the one wave; 1, 2, 4 measured alike

struct Inputs {
  const float *fx, *fy, *cx, *cy;  // 0-d intrinsics
  const float* R;                  // (3, 3) camera-to-world rotation
  const float* t;                  // (3,) camera position
  const float* ground;             // (4,) ground plane, camera frame
  const float* planes;             // (S, 4) wall planes, world frame
  const float* endpoints;          // (S, 2, 3) wall ground-line endpoints
  const uint8_t* clipped;          // (S, 2) extent clipped at either end
  const uint8_t* valid;            // (S,)
  int S;
  float max_depth, wall_height, extent_pad;
};

// Depths of NP consecutive pixels of the row-major image from (u, v) on,
// from the staged parameters p and the nv valid walls after them.
template <int NP>
__device__ __forceinline__ void render(const float* p, int nv,
                                       const Inputs& in, int u, int v, int W,
                                       const bool* gmask, float big,
                                       float* d) {
  const float fx = p[0], fy = p[1], cx = p[2], cy = p[3];
  const float* R = p + 4;
  const float* t = p + 13;
  const float* g = p + 16;
  const float max_depth = in.max_depth;
  const float wall_h = in.wall_height;

  float rx[NP], ry[NP], s_g[NP];
  bool ground[NP];
  bool all_ground = true;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    rx[k] = ((float)u - cx) / fx;
    ry[k] = ((float)v - cy) / fy;
    const float den_g = g[0] * rx[k] + g[1] * ry[k] + g[2];
    const float safe_g = fabsf(den_g) < 1e-6f ? 1e-6f : den_g;
    s_g[k] = -g[3] / safe_g;
    const bool ok_g = (fabsf(den_g) >= 1e-6f) && (s_g[k] > 0.0f);
    ground[k] = gmask[k] && ok_g;
    all_ground = all_ground && ground[k];
    if (++u == W) { u = 0; ++v; }
  }
  if (all_ground) {
#pragma unroll
    for (int k = 0; k < NP; ++k) d[k] = fminf(fmaxf(s_g[k], 0.0f), max_depth);
    return;
  }
  float rwx[NP], rwy[NP], rwz[NP], best[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    rwx[k] = R[0] * rx[k] + R[1] * ry[k] + R[2];
    rwy[k] = R[3] * rx[k] + R[4] * ry[k] + R[5];
    rwz[k] = R[6] * rx[k] + R[7] * ry[k] + R[8];
    best[k] = big;
  }
  for (int s = 0; s < nv; ++s) {
    const float* w = p + kHdr + kPerWall * s;
    const float n0 = w[0], n1 = w[1], n2 = w[2], num = w[3];
    const float e0x = w[4], e0y = w[5], dux = w[6], duy = w[7];
    const float seg_len = w[8], lo_pad = w[9], hi_pad = w[10];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const float den = n0 * rwx[k] + n1 * rwy[k] + n2 * rwz[k];
      const float safe = fabsf(den) < 1e-9f ? 1e-9f : den;
      const float sw = num / safe;
      const float hx = t[0] + sw * rwx[k];
      const float hy = t[1] + sw * rwy[k];
      const float hz = t[2] + sw * rwz[k];
      const float u_par = (hx - e0x) * dux + (hy - e0y) * duy;
      const bool ok = (sw > 1e-6f) && (fabsf(den) >= 1e-9f) &&
                      (u_par >= -lo_pad) && (u_par <= seg_len + hi_pad) &&
                      (hz >= -0.1f) && (hz <= wall_h + 0.1f);
      if (ok && sw < best[k]) best[k] = sw;
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float wall_depth = best[k] >= big ? max_depth : best[k];
    const float depth = ground[k] ? s_g[k] : wall_depth;
    d[k] = fminf(fmaxf(depth, 0.0f), max_depth);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
depth_render_kernel(Inputs in, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int H, int W, float big,
                    bool vec) {
  extern __shared__ float p[];
  __shared__ int n_valid;
  const int lt = threadIdx.x;
  const int nthr = blockDim.x;
  if (lt == 0) {
    p[0] = *in.fx; p[1] = *in.fy; p[2] = *in.cx; p[3] = *in.cy;
    int c = 0;
    for (int s = 0; s < in.S; ++s) c += in.valid[s] != 0;
    n_valid = c;
  }
  if (lt < 9) p[4 + lt] = in.R[lt];
  if (lt < 3) p[13 + lt] = in.t[lt];
  if (lt < 4) p[16 + lt] = in.ground[lt];
  // one thread per wall: its loads all issued at once, its terms stored
  // only if the wall is valid, at its rank among the valid walls
  for (int s = lt; s < in.S; s += nthr) {
    const bool ok = in.valid[s] != 0;
    int slot = 0;
    for (int j = 0; j < s; ++j) slot += in.valid[j] != 0;
    const float* pl = in.planes + 4 * s;
    const float* e = in.endpoints + 6 * s;
    const float sx = e[3] - e[0], sy = e[4] - e[1];
    const float seg_len = sqrtf(fmaxf(sx * sx + sy * sy, 1e-12f));
    const float num =
        -(pl[0] * in.t[0] + pl[1] * in.t[1] + pl[2] * in.t[2] + pl[3]);
    const float lo = in.clipped[2 * s] ? in.max_depth : in.extent_pad;
    const float hi = in.clipped[2 * s + 1] ? in.max_depth : in.extent_pad;
    if (!ok) continue;
    float* w = p + kHdr + kPerWall * slot;
    w[0] = pl[0]; w[1] = pl[1]; w[2] = pl[2];
    w[3] = num;
    w[4] = e[0]; w[5] = e[1];
    w[6] = sx / seg_len; w[7] = sy / seg_len;
    w[8] = seg_len;
    w[9] = lo;
    w[10] = hi;
  }

  // H * W < 2^31 (the wrapper checks): 32-bit pixel indices
  const int N = H * W;
  const int n4 = vec ? N / 4 : 0;  // pixel quads on the vector path
  const int stride = gridDim.x * nthr;
  const uchar4* mask4 = reinterpret_cast<const uchar4*>(mask);
  int q = blockIdx.x * nthr + lt;
  // the first quad's mask load overlaps the prologue, each next one the
  // current quad's work
  uchar4 m_next = q < n4 ? mask4[q] : make_uchar4(0, 0, 0, 0);
  __syncthreads();
  const int nv = n_valid;
  for (; q < n4; q += stride) {
    const uchar4 m = m_next;
    if (q + stride < n4) m_next = mask4[q + stride];
    const int i0 = 4 * q;
    const int v = i0 / W, u = i0 - v * W;
    const bool gm[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
    float d[4];
    render<4>(p, nv, in, u, v, W, gm, big, d);
    reinterpret_cast<float4*>(out)[q] = make_float4(d[0], d[1], d[2], d[3]);
  }
  // the pixels past the last whole quad (all of them when not vectorized)
  for (int i = 4 * n4 + blockIdx.x * nthr + lt; i < N; i += stride) {
    const int v = i / W, u = i - v * W;
    const bool gm = mask[i] != 0;
    render<1>(p, nv, in, u, v, W, &gm, big, out + i);
  }
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

extern "C" int popup_depth_render(
    const float* fx, const float* fy, const float* cx, const float* cy,
    const float* R, const float* t, const float* ground, const float* planes,
    const float* endpoints, const uint8_t* clipped, const uint8_t* valid,
    int S, const uint8_t* mask, float* out, int H, int W, float max_depth,
    float wall_height, float extent_pad, void* stream) {
  Inputs in{fx, fy, cx, cy, R, t, ground, planes, endpoints, clipped, valid,
            S, max_depth, wall_height, extent_pad};
  const long long N = (long long)H * W;
  if (N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)mask % 4 == 0) && ((uintptr_t)out % 16 == 0);
  // one wave, the work spread evenly: kBlocksPerSM blocks per SM, each
  // sized to take its share of quads (or pixels) in one step
  const long long work = vec ? N / 4 : N;
  const long long slots = (long long)kBlocksPerSM * num_sms();
  long long threads = (work + slots - 1) / slots;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                        : threads);
  long long grid = (work + threads - 1) / threads;
  grid = grid < 1 ? 1 : (grid > slots ? slots : grid);
  const int smem = (int)sizeof(float) * (kHdr + kPerWall * S);
  depth_render_kernel<<<(int)grid, (int)threads, smem,
                        (cudaStream_t)stream>>>(in, mask, out, H, W,
                                                max_depth * 1e6f, vec);
  return (int)cudaGetLastError();
}
