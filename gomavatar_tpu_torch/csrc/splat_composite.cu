// Kernels B2 and B3 for Hopper: the train-path splat compositing forward and
// its analytic backward.
//
// Replace the TPU kernels gomavatar_tpu/ops/splat/pallas_kernel.py:_fwd_kernel
// (B2) and _bwd_kernel (B3).  Entries are (nch, dp) f32, channel-major: mean
// xy, conic abc, opacity (already zero on padding entries and gated by the
// entry's splat flag), C colors, zero rows.  Tile t owns the 128-aligned
// segment [tile_start[t], tile_start[t] + tile_count[t]) and sweeps at most
// ncmax chunks of it, front to back in depth order.
//
// Forward, per pixel: power = -0.5 (a dx^2 + c dy^2) - b dx dy with
// dx = px - mean_x; alpha = min(0.99, op e^power), zero when power > 0 or
// alpha < 1/255; weight w = T alpha while the transmittance after the
// entry stays >= 1e-4, and the pixel takes nothing more once it does not.
// color = sum w * color_e, alpha = sum w.
//
// Backward (the reference's VJP, pallas_kernel.py:313-347), with
// u_e = sum_c g_color[c] color_e[c] + g_alpha and the suffix sum
// S_e = sum_{k > e} u_k w_k:
//   d alpha_e = T_e u_e [T_incl >= 1e-4, alpha_e > 0] - S_e / (1 - alpha_e)
//   d raw     = d alpha_e where 1/255 <= op e^power <= 0.99 and power <= 0
//   d op = sum_p d raw e^power;  d power = d raw op e^power, giving
//   d conic = d power * (-dx^2/2, -dx dy, -dy^2/2),
//   d mean  = d power * (a dx + b dy, c dy + b dx),
//   d color[c] = sum_p g_color[c] w.
// Pass A replays the forward and sums u w per pixel; pass B walks the
// entries again with the running prefix, so S_e = total - prefix.  Both
// passes add the same terms in the same order, so S is exactly 0 from the
// entry at which a pixel saturates on, and a saturated pixel contributes
// nothing more (as in the reference, up to its rounding).
//
// What bounds them on the card: arithmetic.  A 512^2 frame of the trained
// avatar sweeps ~2e5 entries (~13 MB) as ~5e7 (pixel, entry) pairs of ~30
// (forward) and ~90 (backward, with its per-entry reductions) fp32
// operations and one exp each.  Design:
//   * grid: one block per tile (empty tiles write zeros and return);
//     256 threads, one per pixel; every per-pixel sum in registers;
//   * each 128-entry chunk is staged once in shared memory, coalesced along
//     the entry axis, and read by all threads as broadcasts;
//   * transmittance is a running product T *= (1 - alpha), not the
//     reference's exp of a log-space cumulative sum: a pixel whose
//     transmittance lands within rounding of 1e-4 may keep or drop one
//     entry, which the kernel tests' tolerances cover;
//   * a block stops once every pixel of its tile is saturated;
//   * B3's per-entry gradients are block reductions over the 256 pixels:
//     warp shuffles, then one partial per warp in shared memory, then one
//     plain store per (row, entry).  Every entry belongs to exactly one
//     tile, so nothing needs an atomic; a warp whose 32 pixels contribute
//     nothing to an entry skips its shuffles;
//   * B3 writes every slot its tile owns (the first min(count, ncmax*128)
//     entries), all nch rows, zeros included; slots no tile owns are left
//     unwritten, and the wrapper selects them out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int NWARP = P / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

enum { E_MX = 0, E_MY, E_CA, E_CB, E_CC, E_OP, E_COL };

struct Splat {
  float dx, dy, power, G, raw, alpha;
};

__device__ __forceinline__ Splat splat_at(const float (*sh)[CHUNK], int j, float px, float py) {
  Splat s;
  s.dx = px - sh[E_MX][j];
  s.dy = py - sh[E_MY][j];
  s.power = -0.5f * (sh[E_CA][j] * s.dx * s.dx + sh[E_CC][j] * s.dy * s.dy) - sh[E_CB][j] * s.dx * s.dy;
  s.G = expf(s.power);
  s.raw = sh[E_OP][j] * s.G;
  // fminf returns 0.99 for a NaN raw (0 * inf on a padding entry); power > 0
  // zeroes it then
  float alpha = s.power > 0.0f ? 0.0f : fminf(s.raw, ALPHA_MAX);
  s.alpha = alpha < ALPHA_MIN ? 0.0f : alpha;
  return s;
}

template <int NR>
__device__ __forceinline__ void stage_chunk(float (*sh)[CHUNK], const float* __restrict__ entries,
                                            long long dp, long long base) {
  for (int i = threadIdx.x; i < NR * CHUNK; i += P) {
    const int r = i / CHUNK, l = i % CHUNK;
    sh[r][l] = entries[r * dp + base + l];
  }
}

template <int C>
__global__ void __launch_bounds__(P) splat_fwd_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int tiles_x, int ncmax, float* __restrict__ color_out, float* __restrict__ alpha_out) {
  __shared__ float sh[6 + C][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long start = tile_start[t];
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);

  float T = 1.0f, acc_a = 0.0f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;

  for (int k = 0; k < nchunks; ++k) {
    if (__syncthreads_and(done)) break;  // also: the previous chunk is consumed
    stage_chunk<6 + C>(sh, entries, dp, start + k * CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK && !done; ++j) {
      const Splat s = splat_at(sh, j, px, py);
      const float t_next = T * (1.0f - s.alpha);
      if (t_next < T_EPS) {
        done = true;
      } else {
        const float w = T * s.alpha;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * sh[E_COL + c][j];
        acc_a += w;
        T = t_next;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) color_out[(static_cast<long long>(t) * C + c) * P + p] = acc[c];
  alpha_out[static_cast<long long>(t) * P + p] = acc_a;
}

template <int C>
__global__ void __launch_bounds__(P) splat_bwd_kernel(
    const float* __restrict__ entries, int nch, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int tiles_x, int ncmax,
    const float* __restrict__ g_color, const float* __restrict__ g_alpha,
    float* __restrict__ d_entries) {
  constexpr int NV = 6 + C;  // gradient rows: mean xy, conic abc, opacity, colors
  __shared__ float sh[NV][CHUNK];
  __shared__ float red[NWARP][NV][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const long long start = tile_start[t];
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);

  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_color[(static_cast<long long>(t) * C + c) * P + p];
  const float ga = g_alpha[static_cast<long long>(t) * P + p];

  // ---- pass A: replay the forward, sum u * w per pixel
  float T = 1.0f, total = 0.0f;
  bool done = false;
  for (int k = 0; k < nchunks; ++k) {
    if (__syncthreads_and(done)) break;
    stage_chunk<NV>(sh, entries, dp, start + k * CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK && !done; ++j) {
      const Splat s = splat_at(sh, j, px, py);
      const float t_next = T * (1.0f - s.alpha);
      if (t_next < T_EPS) {
        done = true;
      } else {
        float u = ga;
#pragma unroll
        for (int c = 0; c < C; ++c) u += g[c] * sh[E_COL + c][j];
        total += u * (T * s.alpha);
        T = t_next;
      }
    }
  }

  // ---- pass B: per-entry gradients, front to back
  T = 1.0f;
  float prefix = 0.0f;
  done = false;
  int k = 0;
  for (; k < nchunks; ++k) {
    if (__syncthreads_and(done)) break;
    stage_chunk<NV>(sh, entries, dp, start + k * CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK; ++j) {
      float v[NV];
#pragma unroll
      for (int r = 0; r < NV; ++r) v[r] = 0.0f;
      bool nonzero = false;
      if (!done) {
        const Splat s = splat_at(sh, j, px, py);
        const float t_next = T * (1.0f - s.alpha);
        const bool live = t_next >= T_EPS;  // inclusive transmittance kept
        const float w = live ? T * s.alpha : 0.0f;
        float u = ga;
#pragma unroll
        for (int c = 0; c < C; ++c) u += g[c] * sh[E_COL + c][j];
        prefix += u * w;
        const float suffix = total - prefix;
        const float d_alpha = ((live && s.alpha > 0.0f) ? T * u : 0.0f) - suffix / (1.0f - s.alpha);
        const bool gate = s.power <= 0.0f && s.raw >= ALPHA_MIN && s.raw <= ALPHA_MAX;
        const float d_raw = gate ? d_alpha : 0.0f;
        const float d_power = d_raw * sh[E_OP][j] * s.G;
        const float ca = sh[E_CA][j], cb = sh[E_CB][j], cc = sh[E_CC][j];
        v[E_MX] = d_power * (ca * s.dx + cb * s.dy);
        v[E_MY] = d_power * (cc * s.dy + cb * s.dx);
        v[E_CA] = d_power * (-0.5f * s.dx * s.dx);
        v[E_CB] = d_power * (-s.dx * s.dy);
        v[E_CC] = d_power * (-0.5f * s.dy * s.dy);
        v[E_OP] = d_raw * s.G;
#pragma unroll
        for (int c = 0; c < C; ++c) v[E_COL + c] = g[c] * w;
        nonzero = d_raw != 0.0f || w != 0.0f;
        if (live) {
          T = t_next;
        } else {
          done = true;
        }
      }
      if (__any_sync(FULL, nonzero)) {
#pragma unroll
        for (int r = 0; r < NV; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v[r] += __shfl_down_sync(FULL, v[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NV; ++r) red[warp][r][j] = v[r];
      }
    }
    __syncthreads();
    float* out = d_entries + start + static_cast<long long>(k) * CHUNK;
    for (int i = p; i < nch * CHUNK; i += P) {
      const int r = i / CHUNK, j = i % CHUNK;
      float sum = 0.0f;
      if (r < NV) {
#pragma unroll
        for (int w = 0; w < NWARP; ++w) sum += red[w][r][j];
      }
      out[r * dp + j] = sum;
    }
  }
  // chunks after every pixel saturated: zero gradient, still written
  for (; k < nchunks; ++k) {
    float* out = d_entries + start + static_cast<long long>(k) * CHUNK;
    for (int i = p; i < nch * CHUNK; i += P) out[(i / CHUNK) * dp + i % CHUNK] = 0.0f;
  }
}

template <int C>
void launch_fwd(const float* entries, long long dp, const int32_t* tile_start, const int32_t* tile_count,
                int num_tiles, int tiles_x, int ncmax, float* color, float* alpha, cudaStream_t st) {
  splat_fwd_kernel<C><<<num_tiles, P, 0, st>>>(entries, dp, tile_start, tile_count, tiles_x, ncmax, color, alpha);
}

template <int C>
void launch_bwd(const float* entries, int nch, long long dp, const int32_t* tile_start,
                const int32_t* tile_count, int num_tiles, int tiles_x, int ncmax,
                const float* g_color, const float* g_alpha, float* d_entries, cudaStream_t st) {
  splat_bwd_kernel<C><<<num_tiles, P, 0, st>>>(entries, nch, dp, tile_start, tile_count, tiles_x, ncmax,
                                               g_color, g_alpha, d_entries);
}

}  // namespace

// Launches B2 on `stream`: entries (nch, dp) f32; tile_start, tile_count
// (num_tiles,) i32; outputs color (num_tiles, C, 256) and alpha
// (num_tiles, 1, 256) f32, every tile written.  Returns the CUDA error of
// the launch (0 on success); C outside 1..4 returns cudaErrorInvalidValue.
extern "C" int gom_splat_fwd(const float* entries, int nch, long long dp, const int32_t* tile_start,
                             const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                             float* color, float* alpha, void* stream) {
  if (num_tiles <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_fwd<1>(entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, color, alpha, st); break;
    case 2: launch_fwd<2>(entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, color, alpha, st); break;
    case 3: launch_fwd<3>(entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, color, alpha, st); break;
    case 4: launch_fwd<4>(entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, color, alpha, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches B3 on `stream`: as B2, plus the cotangents g_color
// (num_tiles, C, 256) and g_alpha (num_tiles, 1, 256) f32; writes
// d_entries (nch, dp) on every slot a tile owns.  Returns the CUDA error of
// the launch.
extern "C" int gom_splat_bwd(const float* entries, int nch, long long dp, const int32_t* tile_start,
                             const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                             const float* g_color, const float* g_alpha, float* d_entries, void* stream) {
  if (num_tiles <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: launch_bwd<1>(entries, nch, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, g_color, g_alpha, d_entries, st); break;
    case 2: launch_bwd<2>(entries, nch, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, g_color, g_alpha, d_entries, st); break;
    case 3: launch_bwd<3>(entries, nch, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, g_color, g_alpha, d_entries, st); break;
    case 4: launch_bwd<4>(entries, nch, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, g_color, g_alpha, d_entries, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
