// Fused gated best/second-best Hamming matcher.
//
// Replaces: multi_orb_slam_tpu/ops/pallas_kernels.py `window_match_pallas` /
// `_window_match_kernel` (a [256 x F] VMEM tile per program: gate masks,
// XOR-popcount over 8 words, then two argmins).  On the TPU the searches
// kept a jnp formulation; in this port the kernel carries the gated inner
// loop of all three searches (ops/search.py).  A leading camera axis makes
// each search one launch: queries are [C, Q], frame features [C, F].
//
// Per query q of camera c, a frame feature f is a candidate when
//   |u_q - x_f| < rad_q  and  |v_q - y_f| < rad_q          (window)
//   lmin_q <= level_f <= lmax_q                             (scale)
//   ur_f < 0  or  |ur_q - ur_f| < rad_q  or  ur_q < -1e8    (virtual stereo)
//   mask_f                                                  (feature valid)
// and its distance is popcount(desc_q ^ desc_f) over 256 bits.  Outputs per
// query: best index, best distance, second distance, second index, with
// distance 2^20 where no candidate exists.  Tie rules equal
// `window_match_reference`: the best is the first argmin, the second is the
// first argmin once the best's column is set to 2^20.  Scanning features in
// ascending order with strict `<`, starting from bi = b2i = 0, and demoting
// the old best to second when a new best arrives, gives exactly that.
//
// Bound on the H100: instruction issue, not memory.  Each (query, feature)
// pair costs ~10 gate instructions plus 8 XOR+popc when the gates pass; at
// Q = 2048, F = 1024, C = 2 that is ~4M pairs per search.  One thread owns
// one query and keeps its descriptor and its best/second in registers; the
// block stages the frame features (x, y, ur, level, mask, 8-word descriptor)
// tile by tile in shared memory, where every thread of a warp reads the same
// feature at once (a broadcast, no bank conflicts).  Device memory sees each
// query once and each feature once per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // queries per block
constexpr int kTileF = 256;    // frame features staged per shared tile
constexpr int kBig = 1 << 20;

__global__ void window_match_kernel(
    const float* __restrict__ q_uv, const float* __restrict__ q_rad,
    const int* __restrict__ q_lmin, const int* __restrict__ q_lmax,
    const float* __restrict__ q_ur, const uint32_t* __restrict__ q_desc,
    long long qd_cam_stride, const float* __restrict__ f_xy,
    const float* __restrict__ f_ur, const int* __restrict__ f_level,
    const uint8_t* __restrict__ f_mask, const uint32_t* __restrict__ f_desc,
    int* __restrict__ out, int C, int Q, int F) {
  __shared__ float s_x[kTileF];
  __shared__ float s_y[kTileF];
  __shared__ float s_ur[kTileF];
  __shared__ int s_lv[kTileF];
  __shared__ uint8_t s_ok[kTileF];
  __shared__ uint32_t s_desc[kTileF][8];

  const int c = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < Q;
  const size_t qi = static_cast<size_t>(c) * Q + (live ? q : 0);

  float qu = 0.f, qv = 0.f, rad = -1.f, qur = 0.f;
  int lmin = 0, lmax = -1;
  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = 0u;
  if (live) {
    qu = q_uv[2 * qi];
    qv = q_uv[2 * qi + 1];
    rad = q_rad[qi];
    qur = q_ur[qi];
    lmin = q_lmin[qi];
    lmax = q_lmax[qi];
    const uint32_t* dq = q_desc + static_cast<size_t>(c) * qd_cam_stride +
                         static_cast<size_t>(q) * 8;
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = dq[w];
  }
  const bool ur_off = qur < -1e8f;

  int bi = 0, b2i = 0, bd = kBig, b2 = kBig;
  const size_t fbase = static_cast<size_t>(c) * F;
  for (int t0 = 0; t0 < F; t0 += kTileF) {
    const int nt = min(kTileF, F - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      const size_t fi = fbase + t0 + i;
      s_x[i] = f_xy[2 * fi];
      s_y[i] = f_xy[2 * fi + 1];
      s_ur[i] = f_ur[fi];
      s_lv[i] = f_level[fi];
      s_ok[i] = f_mask[fi];
#pragma unroll
      for (int w = 0; w < 8; ++w) s_desc[i][w] = f_desc[fi * 8 + w];
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float fur = s_ur[i];
      const int lv = s_lv[i];
      const bool cand = s_ok[i] && fabsf(qu - s_x[i]) < rad &&
                        fabsf(qv - s_y[i]) < rad && lv >= lmin &&
                        lv <= lmax &&
                        (fur < 0.f || fabsf(qur - fur) < rad || ur_off);
      int d = kBig;
      if (cand) {
        d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(qd[w] ^ s_desc[i][w]);
      }
      const int f = t0 + i;
      if (d < bd) {
        b2 = bd;
        b2i = bi;
        bd = d;
        bi = f;
      } else if (d < b2) {
        b2 = d;
        b2i = f;
      }
    }
  }
  if (live) {
    const size_t plane = static_cast<size_t>(C) * Q;
    out[qi] = bi;
    out[plane + qi] = bd;
    out[2 * plane + qi] = b2;
    out[3 * plane + qi] = b2i;
  }
}

}  // namespace

extern "C" int window_match_launch(
    const float* q_uv, const float* q_rad, const int* q_lmin,
    const int* q_lmax, const float* q_ur, const int* q_desc,
    long long qd_cam_stride, const float* f_xy, const float* f_ur,
    const int* f_level, const unsigned char* f_mask, const int* f_desc,
    int* out, int C, int Q, int F, void* stream) {
  if (C < 1 || Q < 1 || F < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid((Q + kThreads - 1) / kThreads, C);
  window_match_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q_uv, q_rad, q_lmin, q_lmax, q_ur,
      reinterpret_cast<const uint32_t*>(q_desc), qd_cam_stride, f_xy, f_ur,
      f_level, f_mask, reinterpret_cast<const uint32_t*>(f_desc), out, C, Q,
      F);
  return static_cast<int>(cudaGetLastError());
}
