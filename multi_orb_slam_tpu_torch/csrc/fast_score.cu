// FAST-9/16 corner strength over a batch of images on one canvas.
//
// Replaces: multi_orb_slam_tpu/ops/pallas_kernels.py `fast_score_pallas` /
// `_fast_kernel` (one Pallas call per pyramid level, 64-row bands DMA'd into
// VMEM).  Here one launch scores every (camera, level) image of a frame:
// the canvas is [B, H, W] and image b is valid in rows [0, h[b]) and columns
// [0, w[b]).  Pixels outside an image's extent read as zero, exactly as the
// Pallas kernel's zero padding does, and score 0.
//
// Bound on the H100: memory.  Each output pixel needs 17 input reads, 16
// subtractions and ~300 min/max; a 32x8 block stages its 38x14 input tile
// (3-pixel halo) in shared memory once, so device memory sees one read and
// one write per pixel (~2 x 4 B x 16 x 480 x 640 = 39 MB per frame at the
// 640x480, 2-camera, 8-level shape, ~12 us at 3.35 TB/s).  The arithmetic is
// exact: ring differences are single float32 subtractions and min/max do not
// round, so the result is bit-identical to the plain PyTorch version.
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kR = 3;
constexpr int kMaxImages = 64;

struct Extents {
  int h[kMaxImages];
  int w[kMaxImages];
};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  Extents ext, float* __restrict__ out,
                                  int H, int W) {
  __shared__ float tile[kTileY + 2 * kR][kTileX + 2 * kR];
  const int b = blockIdx.z;
  const int h = ext.h[b];
  const int w = ext.w[b];
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const float* src = img + static_cast<size_t>(b) * H * W;
  constexpr int kTw = kTileX + 2 * kR;
  constexpr int kTn = (kTileY + 2 * kR) * kTw;
  for (int i = threadIdx.y * kTileX + threadIdx.x; i < kTn;
       i += kTileX * kTileY) {
    const int ty = i / kTw;
    const int tx = i - ty * kTw;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? src[static_cast<size_t>(gy) * W + gx]
                       : 0.0f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  float score = 0.0f;
  if (y < h && x < w) {
    const int ty = threadIdx.y + kR;
    const int tx = threadIdx.x + kR;
    const float c = tile[ty][tx];
    float d[16];
    // Bresenham circle of radius 3 in FAST-16 order (dy, dx)
    d[0] = tile[ty - 3][tx + 0] - c;
    d[1] = tile[ty - 3][tx + 1] - c;
    d[2] = tile[ty - 2][tx + 2] - c;
    d[3] = tile[ty - 1][tx + 3] - c;
    d[4] = tile[ty + 0][tx + 3] - c;
    d[5] = tile[ty + 1][tx + 3] - c;
    d[6] = tile[ty + 2][tx + 2] - c;
    d[7] = tile[ty + 3][tx + 1] - c;
    d[8] = tile[ty + 3][tx + 0] - c;
    d[9] = tile[ty + 3][tx - 1] - c;
    d[10] = tile[ty + 2][tx - 2] - c;
    d[11] = tile[ty + 1][tx - 3] - c;
    d[12] = tile[ty + 0][tx - 3] - c;
    d[13] = tile[ty - 1][tx - 3] - c;
    d[14] = tile[ty - 2][tx - 2] - c;
    d[15] = tile[ty - 3][tx - 1] - c;
    float bright = 0.0f;
    float dark = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      float amin = d[k];
      float amax = d[k];
#pragma unroll
      for (int j = 1; j < 9; ++j) {
        amin = fminf(amin, d[(k + j) & 15]);
        amax = fmaxf(amax, d[(k + j) & 15]);
      }
      bright = (k == 0) ? amin : fmaxf(bright, amin);
      dark = (k == 0) ? -amax : fmaxf(dark, -amax);
    }
    score = fmaxf(bright, dark);
  }
  out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + x] = score;
}

}  // namespace

extern "C" int fast_score_launch(const float* img, const int* h_host,
                                 const int* w_host, float* out, int B, int H,
                                 int W, void* stream) {
  if (B < 1 || B > kMaxImages || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Extents ext;
  for (int i = 0; i < kMaxImages; ++i) {
    ext.h[i] = i < B ? h_host[i] : 0;
    ext.w[i] = i < B ? w_host[i] : 0;
  }
  dim3 block(kTileX, kTileY);
  dim3 grid((W + kTileX - 1) / kTileX, (H + kTileY - 1) / kTileY, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, ext, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
