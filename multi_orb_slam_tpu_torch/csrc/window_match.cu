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
// distance 2^20 and index 0 where no candidate exists.  Tie rules equal
// `window_match_reference`: the best is the first argmin, the second is the
// first argmin once the best's column is set to 2^20.  That is: order the
// candidates by (distance, feature index), take the smallest and the next.
//
// Bound on the H100: instruction issue (the gates of C x Q x F pairs, ~12
// operations each: 0.75 us for 4.2 M pairs at the float32 rate) in the
// windowed searches, the popcount unit (16 lanes a clock on each SM, 8
// popcounts a pair: ~4.5 us for 2.1 M pairs) when every gate is open; the
// inputs (~0.4 MB) live in L1/L2.  The first version gave a query to a
// thread and put 128 warps on the card; each walked all F features alone,
// one dependent step after another, so its time (110 us, 193 us dense) was
// exposed latency.  Here a warp owns a query and its lanes stride over the
// features, so C x Q = 4096 queries are 4096 warps:
// - the block packs each feature's gates into one 16-byte record in shared
//   memory (x, y, ur, level; a masked-out feature gets x = NaN, which fails
//   the window test as the mask would): one LDS.128 per feature and lane;
// - descriptors are read from device memory (L1) as two 16-byte loads, and
//   only for a feature that passes some query's gates;
// - a candidate is one integer key, distance above feature index, so the
//   (distance, index) order is the integers' order; a lane keeps its two
//   smallest keys (min/max, no branch), and five __shfl_xor steps merge the
//   lanes' sorted pairs, keeping the two smallest of four.  An empty slot
//   is the all-ones key and carries no index of its own.  The key is 32
//   bits, distance << 10 | index in the tile of 1024 staged features; after
//   each tile the merged pair is folded into the query's (distance, feature
//   index) best and second, which start as (2^20, 0), so any F fits.
// Measured (C = 2, Q = 2048, F = 1024): 7.4 us, 12.5 us with every gate open
// (Q = 1024).  Blocks of 16 warps with 4 features in flight a lane were the
// best of the block sizes tried (8, 16, 32 warps); two or four queries a
// warp (fewer, fatter warps) lost up to 1.8x on the dense shape.  One key of
// distance << 22 | feature index, merged once after the last tile, measured
// 4% less (7.1 / 11.9 us) but ends at 2^22 features; 64-bit keys in the
// merge took 7.9 us.  What is left is ~15 instructions a pair and lane to get
// through, plus each block's staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;     // warps, so queries, per block
constexpr int kUnroll = 4;     // features a lane has in flight
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBits = 10;
constexpr int kTileF = 1 << kTileBits;   // frame features staged per shared tile
constexpr int kBig = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmpty = ~0u;

__global__ void __launch_bounds__(kThreads) window_match_kernel(
    const float* __restrict__ q_uv, const float* __restrict__ q_rad,
    const int* __restrict__ q_lmin, const int* __restrict__ q_lmax,
    const float* __restrict__ q_ur, const uint32_t* __restrict__ q_desc,
    long long qd_cam_stride, const float* __restrict__ f_xy,
    const float* __restrict__ f_ur, const int* __restrict__ f_level,
    const uint8_t* __restrict__ f_mask, const uint32_t* __restrict__ f_desc,
    int* __restrict__ out, int C, int Q, int F) {
  __shared__ float4 s_gate[kTileF];

  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const bool live = q < Q;   // a warp past the end still helps to stage
  const size_t qi = static_cast<size_t>(c) * Q + (live ? q : 0);

  // the warp's query: the same values in every lane
  const float qu = __ldg(q_uv + 2 * qi);
  const float qv = __ldg(q_uv + 2 * qi + 1);
  const float rad = live ? __ldg(q_rad + qi) : -1.f;   // -1: no candidate
  const float qur = __ldg(q_ur + qi);
  const int lmin = __ldg(q_lmin + qi);
  const int lmax = __ldg(q_lmax + qi);
  const uint4* dq = reinterpret_cast<const uint4*>(
      q_desc + static_cast<size_t>(c) * qd_cam_stride + (qi - static_cast<size_t>(c) * Q) * 8);
  const uint4 qlo = __ldg(dq);
  const uint4 qhi = __ldg(dq + 1);
  const bool ur_off = qur < -1e8f;
  int bi = 0, bd = kBig, sd = kBig, si = 0;   // the query's best and second so far

  const size_t fbase = static_cast<size_t>(c) * F;
  for (int t0 = 0; t0 < F; t0 += kTileF) {
    const int nt = min(kTileF, F - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt; i += kThreads) {
      const size_t fi = fbase + t0 + i;
      const float x = __ldg(f_mask + fi) ? __ldg(f_xy + 2 * fi)
                                         : __int_as_float(0x7fc00000);
      s_gate[i] = make_float4(x, __ldg(f_xy + 2 * fi + 1), __ldg(f_ur + fi),
                              __int_as_float(__ldg(f_level + fi)));
    }
    __syncthreads();
    uint32_t t1 = kEmpty, t2 = kEmpty;   // this tile's two smallest
#pragma unroll kUnroll
    for (int i = lane; i < nt; i += 32) {
      const float4 g = s_gate[i];
      const int lv = __float_as_int(g.w);
      const bool cand =
          (fabsf(qu - g.x) < rad) & (fabsf(qv - g.y) < rad) & (lv >= lmin) &
          (lv <= lmax) & ((g.z < 0.f) | (fabsf(qur - g.z) < rad) | ur_off);
      if (cand) {
        const uint4* df = reinterpret_cast<const uint4*>(
            f_desc + (fbase + t0 + i) * 8);
        const uint4 lo = __ldg(df);
        const uint4 hi = __ldg(df + 1);
        const int d = __popc(qlo.x ^ lo.x) + __popc(qlo.y ^ lo.y) +
                      __popc(qlo.z ^ lo.z) + __popc(qlo.w ^ lo.w) +
                      __popc(qhi.x ^ hi.x) + __popc(qhi.y ^ hi.y) +
                      __popc(qhi.z ^ hi.z) + __popc(qhi.w ^ hi.w);
        const uint32_t key = (static_cast<uint32_t>(d) << kTileBits) | i;
        t2 = min(t2, max(t1, key));
        t1 = min(t1, key);
      }
    }
    // merge the lanes' sorted pairs: the two smallest of four, five times;
    // every lane ends with the tile's pair
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint32_t o1 = __shfl_xor_sync(kFull, t1, off);
      const uint32_t o2 = __shfl_xor_sync(kFull, t2, off);
      const uint32_t hi = max(t1, o1);
      t1 = min(t1, o1);
      t2 = min(hi, min(t2, o2));
    }
    // fold it into the query's best and second.  The tile's features come
    // after all earlier ones, so at equal distance the earlier one stays; an
    // empty key's distance, 2^22 - 1, is above kBig and never wins
    const int d1 = static_cast<int>(t1 >> kTileBits);
    const int d2 = static_cast<int>(t2 >> kTileBits);
    const int i1 = t0 + static_cast<int>(t1 & (kTileF - 1));
    const int i2 = t0 + static_cast<int>(t2 & (kTileF - 1));
    const bool wins = d1 < bd;
    // the second: the loser of the two bests against the winner's runner-up
    const bool tile2 = wins ? d2 < bd : d1 < sd;
    sd = wins ? (tile2 ? d2 : bd) : (tile2 ? d1 : sd);
    si = wins ? (tile2 ? i2 : bi) : (tile2 ? i1 : si);
    bd = wins ? d1 : bd;
    bi = wins ? i1 : bi;
  }

  if (lane == 0 && live) {
    const size_t plane = static_cast<size_t>(C) * Q;
    out[qi] = bi;
    out[plane + qi] = bd;
    out[2 * plane + qi] = sd;
    out[3 * plane + qi] = si;
  }
}

}  // namespace

extern "C" int window_match_launch(
    const float* q_uv, const float* q_rad, const int* q_lmin,
    const int* q_lmax, const float* q_ur, const int* q_desc,
    long long qd_cam_stride, const float* f_xy, const float* f_ur,
    const int* f_level, const unsigned char* f_mask, const int* f_desc,
    int* out, int C, int Q, int F, void* stream) {
  if (C < 1 || C > 65535 || Q < 1 || F < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the descriptors are read 16 bytes at a time
  if ((reinterpret_cast<uintptr_t>(q_desc) | reinterpret_cast<uintptr_t>(f_desc)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  dim3 grid((Q + kWarps - 1) / kWarps, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* qd = reinterpret_cast<const uint32_t*>(q_desc);
  const uint32_t* fd = reinterpret_cast<const uint32_t*>(f_desc);
  window_match_kernel<<<grid, kThreads, 0, s>>>(
      q_uv, q_rad, q_lmin, q_lmax, q_ur, qd, qd_cam_stride, f_xy, f_ur,
      f_level, f_mask, fd, out, C, Q, F);
  return static_cast<int>(cudaGetLastError());
}
