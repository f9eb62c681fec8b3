// K2: dense depth render of the popped-up plane model.
//
// Replaces pop_up_slam_tpu/ops/depth_render.py::depth_render_pallas (row
// tiles of a padded f32 mask, per-wall scalars in SMEM).  Here: one thread
// per pixel on a 2-D grid.  Each block's prologue stages the camera, the
// pose, the ground plane and the per-wall terms (one thread per wall,
// computed from the pop-up's planes, endpoints, clipped and valid flags)
// in shared memory, so the whole render is a single launch.  The mask is
// read as the 1-byte bool tensor it is, and the ragged image edge is
// masked by the thread itself, so nothing is padded.
//
// Bound on the H100: per frame it reads H*W mask bytes and writes H*W f32
// depths (0.3 MB + 1.2 MB at 480x640) against ~20 flops per pixel and
// wall, so it is memory- and launch-bound; the design reads and writes
// each pixel exactly once with coalesced row-major accesses.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// shared block: fx fy cx cy | R_wc (9) | t_wc (3) | ground_c (4); then per
// wall: n (3) | valid | num | e0 (2) | d_unit (2) | seg_len | lo_pad | hi_pad
constexpr int kHdr = 20;
constexpr int kPerWall = 12;

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

__global__ void depth_render_kernel(Inputs in, const uint8_t* __restrict__ mask,
                                    float* __restrict__ out, int H, int W,
                                    float big) {
  extern __shared__ float p[];
  const int lt = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  if (lt == 0) {
    p[0] = *in.fx; p[1] = *in.fy; p[2] = *in.cx; p[3] = *in.cy;
  }
  if (lt < 9) p[4 + lt] = in.R[lt];
  if (lt < 3) p[13 + lt] = in.t[lt];
  if (lt < 4) p[16 + lt] = in.ground[lt];
  for (int s = lt; s < in.S; s += nthr) {
    const float* pl = in.planes + 4 * s;
    const float* e = in.endpoints + 6 * s;
    float* w = p + kHdr + kPerWall * s;
    const float sx = e[3] - e[0], sy = e[4] - e[1];
    const float seg_len = sqrtf(fmaxf(sx * sx + sy * sy, 1e-12f));
    w[0] = pl[0]; w[1] = pl[1]; w[2] = pl[2];
    w[3] = in.valid[s] ? 1.0f : 0.0f;
    w[4] = -(pl[0] * in.t[0] + pl[1] * in.t[1] + pl[2] * in.t[2] + pl[3]);
    w[5] = e[0]; w[6] = e[1];
    w[7] = sx / seg_len; w[8] = sy / seg_len;
    w[9] = seg_len;
    w[10] = in.clipped[2 * s] ? in.max_depth : in.extent_pad;
    w[11] = in.clipped[2 * s + 1] ? in.max_depth : in.extent_pad;
  }
  __syncthreads();

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= W || v >= H) return;

  const float fx = p[0], fy = p[1], cx = p[2], cy = p[3];
  const float* R = p + 4;
  const float* t = p + 13;
  const float* g = p + 16;
  const float max_depth = in.max_depth;
  const float wall_h = in.wall_height;

  const float rx = ((float)u - cx) / fx;
  const float ry = ((float)v - cy) / fy;
  const float rwx = R[0] * rx + R[1] * ry + R[2];
  const float rwy = R[3] * rx + R[4] * ry + R[5];
  const float rwz = R[6] * rx + R[7] * ry + R[8];

  const float den_g = g[0] * rx + g[1] * ry + g[2];
  const float safe_g = fabsf(den_g) < 1e-6f ? 1e-6f : den_g;
  const float s_g = -g[3] / safe_g;
  const bool ok_g = (fabsf(den_g) >= 1e-6f) && (s_g > 0.0f);

  float best = big;
  for (int s = 0; s < in.S; ++s) {
    const float* w = p + kHdr + kPerWall * s;
    if (w[3] < 0.5f) continue;
    const float den = w[0] * rwx + w[1] * rwy + w[2] * rwz;
    const float safe = fabsf(den) < 1e-9f ? 1e-9f : den;
    const float sw = w[4] / safe;
    const float hx = t[0] + sw * rwx;
    const float hy = t[1] + sw * rwy;
    const float hz = t[2] + sw * rwz;
    const float u_par = (hx - w[5]) * w[7] + (hy - w[6]) * w[8];
    const bool ok = (sw > 1e-6f) && (fabsf(den) >= 1e-9f) &&
                    (u_par >= -w[10]) && (u_par <= w[9] + w[11]) &&
                    (hz >= -0.1f) && (hz <= wall_h + 0.1f);
    if (ok && sw < best) best = sw;
  }
  const float wall_depth = best >= big ? max_depth : best;
  const bool ground_px = mask[(size_t)v * W + u] != 0 && ok_g;
  const float depth = ground_px ? s_g : wall_depth;
  out[(size_t)v * W + u] = fminf(fmaxf(depth, 0.0f), max_depth);
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
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  const int smem = (int)sizeof(float) * (kHdr + kPerWall * S);
  depth_render_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      in, mask, out, H, W, max_depth * 1e6f);
  return (int)cudaGetLastError();
}
