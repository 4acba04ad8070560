// FAST-9/16 corner strength over a batch of images on one canvas.
//
// Replaces: multi_orb_slam_tpu/ops/pallas_kernels.py `fast_score_pallas` /
// `_fast_kernel` (one Pallas call per pyramid level, 64-row bands DMA'd into
// VMEM).  Here one launch scores every (camera, level) image of a frame:
// the canvas is [B, H, W] and image b is valid in rows [0, h[b]) and columns
// [0, w[b]).  Pixels outside an image's extent read as zero, exactly as the
// Pallas kernel's zero padding does, and score 0.
//
// score = max(max_k min(arc_k), max_k -max(arc_k)) over the sixteen 9-long
// arcs of ring differences d[j] = ring_j - centre.  No early rejection: the
// score is defined, and compared bit for bit, where it is negative too.
//
// Bound on the H100: bytes (the live pixels in, the canvas out: 27 MB at the
// 640x480, 2-camera, 8-level shape, 8.2 us at 3.35 TB/s); the least
// arithmetic known, ~140 operations a live pixel, is 4 us at the float32
// rate.  The first version took 61 us: 288 min/max a pixel, one pixel a
// thread, and every block of the canvas staged a tile, 61% of them for
// nothing.  What this design does about it:
// - the sixteen arc minima come from block prefixes and suffixes, not from
//   16 x 8 steps: the ring is two blocks of 8; suf[k] = min(d[k .. end of
//   k's block]) and pre[k] = min(d[start of k's block .. k]) cost 7 each per
//   block, and arc[k] = min(suf[k], pre[k+8]) (indices mod 16); the maxima
//   likewise: 2 x (28 + 16 + 15) + 1 = 119 min/max instead of 288 (doubling,
//   m2 -> m4 -> m8, needs 159 and measured 1.3x slower).  min and max do not
//   round, so the result is bit-identical;
// - the grid is sized per image from its extent: block (x, b) of image b is
//   one of its live 64x16 tiles, or one of the 8-row bands that zero what no
//   live tile covers (16-byte stores), or returns at once.  Nothing outside
//   the extents is staged or scored;
// - a thread scores 4 pixels along x: the 7 ring rows come from shared
//   memory as 16-byte loads (21 for 4 pixels instead of 68 scalar ones) and
//   are reused from registers, and the 4 scores leave as one 16-byte store.
//   The tile is staged with 16-byte loads too.  A canvas whose width is not
//   a multiple of 4, or whose base is not 16-byte aligned, takes the same
//   kernel with scalar loads and stores;
// - 64 registers a thread, so four blocks share an SM.
// Measured at that shape: 28 us; a build with the scoring left out took
// 8.7 us (the bytes' bound), one with the ring loads, the 16 differences and
// their sum but no min/max 15.9 us: the three phases of a block (stage, load
// the ring, score) add up, since only four blocks an SM are there to overlap
// them.  Ordered-integer keys with Hopper's 3-input min/max (80 of them)
// measured the same 28 us.
// Ring differences are single float32 subtractions, so the result equals
// the plain PyTorch version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPx = 4;            // pixels per thread along x
constexpr int kThreadsX = 16;
constexpr int kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileX = kPx * kThreadsX;   // 64
constexpr int kTileY = kThreadsY;         // 16
constexpr int kR = 3;
constexpr int kPadX = 4;                  // left halo, kept 16-byte aligned
constexpr int kSmemW = kTileX + 2 * kPadX;   // 72 floats: gx = x0 - 4 ... x0 + 67
constexpr int kSmemH = kTileY + 2 * kR;      // 22 rows:   gy = y0 - 3 ... y0 + 18
constexpr int kZeroRows = 8;              // rows per zeroing block
constexpr int kMaxImages = 64;
constexpr int kMinBlocks = 4;             // blocks per SM: 64 registers a thread

struct Images {
  int h[kMaxImages];
  int w[kMaxImages];
  int tiles_x[kMaxImages];   // live tiles along x
  int n_tiles[kMaxImages];   // live tiles of the image
  int n_zero[kMaxImages];    // zeroing bands of the image
};

// The extreme over the sixteen arcs of the arcs' own opposite extreme:
// kMin: max_k min(d[k .. k+8]); else: min_k max(d[k .. k+8]).
template <bool kMin>
__device__ __forceinline__ float arc_extreme(const float (&d)[16]) {
  auto in = [](float a, float b) { return kMin ? fminf(a, b) : fmaxf(a, b); };
  auto out = [](float a, float b) { return kMin ? fmaxf(a, b) : fminf(a, b); };
  // the ring as two blocks of 8: suf[k] = extreme of d[k .. block end],
  // pre[k] = extreme of d[block start .. k]; the arc k .. k+8 is the rest
  // of k's block and the other block up to k+8
  float suf[16], pre[16];
#pragma unroll
  for (int blk = 0; blk < 16; blk += 8) {
    suf[blk + 7] = d[blk + 7];
    pre[blk] = d[blk];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      suf[blk + 7 - i] = in(d[blk + 7 - i], suf[blk + 8 - i]);
      pre[blk + i] = in(d[blk + i], pre[blk + i - 1]);
    }
  }
  float best = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float m9 = in(suf[k], pre[(k + 8) & 15]);
    best = (k == 0) ? m9 : out(best, m9);
  }
  return best;
}

__device__ __forceinline__ float arcs_score(const float (&d)[16]) {
  // bright: every pixel of some arc above the centre; dark: below it
  return fmaxf(arc_extreme<true>(d), -arc_extreme<false>(d));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fast_score_kernel(const float* __restrict__ img, Images im,
                  float* __restrict__ out, int H, int W) {
  __shared__ __align__(16) float tile[kSmemH][kSmemW];
  const int b = blockIdx.y;
  const int h = im.h[b];
  const int w = im.w[b];
  const int n_tiles = im.n_tiles[b];
  const int tiles_x = im.tiles_x[b];
  const size_t plane = static_cast<size_t>(b) * H * W;
  float* dst = out + plane;
  int blk = blockIdx.x;

  if (blk >= n_tiles) {
    // zeroing band: what no live tile of this image covers
    blk -= n_tiles;
    if (blk >= im.n_zero[b]) return;
    const int wc = min(W, tiles_x * kTileX);                          // columns the tiles cover
    const int hc = n_tiles > 0 ? min(H, (n_tiles / tiles_x) * kTileY) : 0;   // rows they cover
    const int first_row = wc < W ? 0 : hc;
    const int y_begin = first_row + blk * kZeroRows;
    const int y_end = min(H, y_begin + kZeroRows);
    for (int y = y_begin; y < y_end; ++y) {
      const int x_begin = y < hc ? wc : 0;
      float* row = dst + static_cast<size_t>(y) * W;
      if (kVec) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int x = x_begin + 4 * threadIdx.x; x < W; x += 4 * kThreads) {
          *reinterpret_cast<float4*>(row + x) = z;
        }
      } else {
        for (int x = x_begin + threadIdx.x; x < W; x += kThreads) row[x] = 0.f;
      }
    }
    return;
  }

  const int x0 = (blk % tiles_x) * kTileX;
  const int y0 = (blk / tiles_x) * kTileY;
  const float* src = img + plane;

  // stage the tile and its halo; zero outside the image's extent
  if (kVec) {
    constexpr int kChunks = kSmemW / 4;
    for (int i = threadIdx.x; i < kSmemH * kChunks; i += kThreads) {
      const int ty = i / kChunks;
      const int tc = i - ty * kChunks;
      const int gy = y0 + ty - kR;
      const int gx = x0 + 4 * tc - kPadX;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        v = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<size_t>(gy) * W + gx));
        if (gx + 1 >= w) v.y = 0.f;
        if (gx + 2 >= w) v.z = 0.f;
        if (gx + 3 >= w) v.w = 0.f;
      }
      *reinterpret_cast<float4*>(&tile[ty][4 * tc]) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kSmemH * kSmemW; i += kThreads) {
      const int ty = i / kSmemW;
      const int tx = i - ty * kSmemW;
      const int gy = y0 + ty - kR;
      const int gx = x0 + tx - kPadX;
      tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                         ? __ldg(src + static_cast<size_t>(gy) * W + gx)
                         : 0.0f;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % kThreadsX;
  const int ty = threadIdx.x / kThreadsX;
  const int x = x0 + kPx * tx;   // first of this thread's 4 pixels
  const int y = y0 + ty;
  if (x >= W || y >= H) return;

  float score[kPx] = {0.f, 0.f, 0.f, 0.f};
  if (y < h && x < w) {
    // v[r][j]: row y - 3 + r, column x - 4 + j
    float v[2 * kR + 1][3 * 4];
#pragma unroll
    for (int r = 0; r < 2 * kR + 1; ++r) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float4 t =
            *reinterpret_cast<const float4*>(&tile[ty + r][kPx * tx + 4 * j]);
        v[r][4 * j + 0] = t.x;
        v[r][4 * j + 1] = t.y;
        v[r][4 * j + 2] = t.z;
        v[r][4 * j + 3] = t.w;
      }
    }
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      const int o = kPadX + p;   // the pixel's column in v
      const float c = v[3][o];
      float d[16];
      // Bresenham circle of radius 3 in FAST-16 order (dy, dx)
      d[0] = v[0][o + 0] - c;
      d[1] = v[0][o + 1] - c;
      d[2] = v[1][o + 2] - c;
      d[3] = v[2][o + 3] - c;
      d[4] = v[3][o + 3] - c;
      d[5] = v[4][o + 3] - c;
      d[6] = v[5][o + 2] - c;
      d[7] = v[6][o + 1] - c;
      d[8] = v[6][o + 0] - c;
      d[9] = v[6][o - 1] - c;
      d[10] = v[5][o - 2] - c;
      d[11] = v[4][o - 3] - c;
      d[12] = v[3][o - 3] - c;
      d[13] = v[2][o - 3] - c;
      d[14] = v[1][o - 2] - c;
      d[15] = v[0][o - 1] - c;
      // a pixel past the extent's right edge scores 0
      score[p] = (x + p < w) ? arcs_score(d) : 0.f;
    }
  }
  float* px = dst + static_cast<size_t>(y) * W + x;
  if (kVec) {
    *reinterpret_cast<float4*>(px) =
        make_float4(score[0], score[1], score[2], score[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      if (x + p < W) px[p] = score[p];
    }
  }
}

}  // namespace

extern "C" int fast_score_launch(const float* img, const int* h_host,
                                 const int* w_host, float* out, int B, int H,
                                 int W, void* stream) {
  if (B < 1 || B > kMaxImages || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Images im;
  int grid_x = 1;
  for (int i = 0; i < kMaxImages; ++i) {
    const int h = i < B ? h_host[i] : 0;
    const int w = i < B ? w_host[i] : 0;
    if (h < 0 || h > H || w < 0 || w > W) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool live = h > 0 && w > 0;
    const int tiles_x = live ? (w + kTileX - 1) / kTileX : 1;
    const int tiles_y = live ? (h + kTileY - 1) / kTileY : 0;
    const int wc = tiles_x * kTileX < W ? tiles_x * kTileX : W;
    const int hc = tiles_y * kTileY < H ? tiles_y * kTileY : H;
    const int zero_rows = (live && wc >= W) ? H - hc : H;
    im.h[i] = live ? h : 0;
    im.w[i] = live ? w : 0;
    im.tiles_x[i] = tiles_x;
    im.n_tiles[i] = tiles_x * tiles_y;
    im.n_zero[i] = (zero_rows + kZeroRows - 1) / kZeroRows;
    if (i < B && im.n_tiles[i] + im.n_zero[i] > grid_x) {
      grid_x = im.n_tiles[i] + im.n_zero[i];
    }
  }
  dim3 grid(grid_x, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      W % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    fast_score_kernel<true><<<grid, kThreads, 0, s>>>(img, im, out, H, W);
  } else {
    fast_score_kernel<false><<<grid, kThreads, 0, s>>>(img, im, out, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
