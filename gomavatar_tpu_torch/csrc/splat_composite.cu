// Kernels B2 and B3 for Hopper: the train-path splat compositing forward and
// its analytic backward, B3 in two launches (B3a, B3b).
//
// Replace the TPU kernels gomavatar_tpu/ops/splat/pallas_kernel.py:_fwd_kernel
// (B2) and _bwd_kernel (B3).  Entries are (nch, dp) f32, channel-major: mean
// xy, conic abc, opacity (already zero on padding entries and gated by the
// entry's splat flag), C colors, zero rows.  Tile t owns the 128-aligned
// segment [tile_start[t], tile_start[t] + tile_count[t]) and sweeps its
// first min(tile_count[t] / 128, ncmax) chunks, front to back in depth
// order; chunk k of tile t is slot tile_start[t] / 128 + k of the buffer.
//
// Forward, per pixel: power = -0.5 (a dx^2 + c dy^2) - b dx dy with
// dx = px - mean_x; alpha = min(0.99, op e^power), zero when power > 0 or
// alpha < 1/255; weight w = T alpha while the transmittance after the
// entry stays >= 1e-4, and the pixel takes nothing more once it does not
// (it is "spent").  color = sum w * color_e, alpha = sum w.  T is a running
// product T *= (1 - alpha), not the reference's exp of a log-space
// cumulative sum: a pixel whose transmittance lands within rounding of 1e-4
// may keep or drop one entry, which the kernel tests' tolerances cover.
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
//
// What bounds them on the card: arithmetic.  A 512^2 frame of the trained
// avatar reads ~1.4e3 chunks (~6 MB) as ~2.4e7 live (pixel, entry) pairs
// of ~30 (forward) and ~100 (backward, with its per-entry reductions) fp32
// operations and one exp each.  Design:
//   * B2: one block per tile, 256 threads (one per pixel), every per-pixel
//     sum in registers; each 128-entry chunk is staged once in shared
//     memory and read by all threads as broadcasts; a block stops once
//     every pixel of its tile is spent.  B2 also saves, for the backward,
//     each pixel's T at the start of every chunk its tile owns, or -1 once
//     the pixel is spent: a (dp / 128, 256) array, the sentinel written
//     into the chunks an early stop skips too.
//   * B3 does not replay the forward.  Its grid runs over chunks, not
//     tiles: one block per 128-entry slot of the buffer (sized from dp on
//     the host), which finds the tile that owns the slot on the device
//     (common.cuh: owner_of, a scan of tile_start / tile_count, which also
//     states what happens where buffer clamping makes tiles share a
//     tile_start) and returns at once if none does.  So the longest
//     segment no longer runs on one SM.
//   * B3a: per pixel, from the saved T, the partial sum of u w over its own
//     chunk alone, (dp / 128, 256) f32.
//   * B3b: per pixel, the suffix at the chunk's end is the sum of the later
//     chunks' partials of the tile (at most ncmax - 1 reads); walking the
//     chunk again with the local prefix gives S_e = later + (partial -
//     prefix_e).  B2, B3a and B3b evaluate alpha, T and u w with the same
//     round-to-nearest intrinsics (never contracted into FMAs), so a pixel
//     is spent at the same entry in all three, the local prefix equals the
//     partial exactly there, and S is exactly 0 from that entry on: a spent
//     pixel contributes nothing more.
//   * B3b's per-entry gradients are block reductions over the 256 pixels
//     (T is sequential in the entry): each warp folds its 6 + C values
//     (padded to 16) in 16 shuffles, halving the values at each step, so
//     that lane pair i holds the warp's sum of value i (a shuffle tree per
//     value takes 5 (6 + C) shuffles and ran 13 % slower on the trained
//     512^2 frame; PERF.md); one partial per warp in shared memory; one
//     plain store per (row, entry).  Every entry
//     belongs to one tile, so nothing needs an atomic; a warp whose 32
//     pixels contribute nothing to an entry skips its shuffles.
//   * B3b writes every slot its tile owns, all nch rows, zeros included;
//     slots no tile owns are left unwritten, and the wrapper selects them
//     out.

#include "common.cuh"

namespace {

constexpr int NWARP = P / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float SPENT = -1.0f;  // the chunk-start state of a spent pixel

enum { E_MX = 0, E_MY, E_CA, E_CB, E_CC, E_OP, E_COL };

struct Splat {
  float dx, dy, power, G, raw, alpha;
};

// The plain version's arithmetic, operation for operation.
__device__ __forceinline__ Splat splat_at(const float (*sh)[CHUNK], int j, float px, float py) {
  Splat s;
  s.dx = sub(px, sh[E_MX][j]);
  s.dy = sub(py, sh[E_MY][j]);
  const float q = add(mul(mul(sh[E_CA][j], s.dx), s.dx), mul(mul(sh[E_CC][j], s.dy), s.dy));
  s.power = sub(mul(-0.5f, q), mul(mul(sh[E_CB][j], s.dx), s.dy));
  s.G = expf(s.power);
  s.raw = mul(sh[E_OP][j], s.G);
  // fminf returns 0.99 for a NaN raw (0 * inf on a padding entry); power > 0
  // zeroes it then
  const float alpha = s.power > 0.0f ? 0.0f : fminf(s.raw, ALPHA_MAX);
  s.alpha = alpha < ALPHA_MIN ? 0.0f : alpha;
  return s;
}

// u = g_alpha + sum_c g_color[c] color_e[c]
template <int C>
__device__ __forceinline__ float u_at(const float (*sh)[CHUNK], int j, const float (&g)[C], float ga) {
  float u = ga;
#pragma unroll
  for (int c = 0; c < C; ++c) u = fmaf(g[c], sh[E_COL + c][j], u);
  return u;
}

template <int NR>
__device__ __forceinline__ void stage_chunk(float (*sh)[CHUNK], const float* __restrict__ entries,
                                            long long dp, long long base) {
  for (int i = threadIdx.x; i < NR * CHUNK; i += P) {
    const int r = i / CHUNK, l = i % CHUNK;
    sh[r][l] = entries[r * dp + base + l];
  }
}

// One step of the warp fold: lanes with bit O set keep the upper N of their
// 2N values, the others the lower N, and each adds its partner's copy.
template <int N, int O>
__device__ __forceinline__ void fold(float (&v)[16], bool hi) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = hi ? v[i] : v[i + N];
    const float keep = hi ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// The warp's sum of each of 16 values in 16 shuffles: lane L returns the
// sum of value L >> 1.
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
  fold<8, 16>(v, lane & 16);
  fold<4, 8>(v, lane & 8);
  fold<2, 4>(v, lane & 4);
  fold<1, 2>(v, lane & 2);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

template <int C>
__global__ void __launch_bounds__(P) splat_fwd_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int tiles_x, int ncmax, float* __restrict__ color_out, float* __restrict__ alpha_out,
    float* __restrict__ t_start) {
  __shared__ float sh[6 + C][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long start = tile_start[t];
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  float* state = t_start + (start / CHUNK) * P + p;  // chunk k's state at state[k * P]

  float T = 1.0f, acc_a = 0.0f, acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;

  for (int k = 0; k < nchunks; ++k) {
    if (__syncthreads_and(done)) {  // also: the previous chunk is consumed
      for (; k < nchunks; ++k) state[static_cast<long long>(k) * P] = SPENT;
      break;
    }
    state[static_cast<long long>(k) * P] = done ? SPENT : T;
    stage_chunk<6 + C>(sh, entries, dp, start + k * CHUNK);
    __syncthreads();
    for (int j = 0; j < CHUNK && !done; ++j) {
      const Splat s = splat_at(sh, j, px, py);
      const float t_next = mul(T, sub(1.0f, s.alpha));
      if (t_next < T_EPS) {
        done = true;
      } else {
        const float w = mul(T, s.alpha);
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


// B3a: per pixel, the sum of u w over this chunk's entries alone, walked
// from the T that B2 saved at the chunk's start.
template <int C>
__global__ void __launch_bounds__(P) splat_bwd_partials_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count, int num_tiles,
    int tiles_x, int ncmax, const float* __restrict__ g_color, const float* __restrict__ g_alpha,
    const float* __restrict__ t_start, float* __restrict__ partial) {
  __shared__ int s_owner;
  __shared__ float sh[6 + C][CHUNK];
  const long long slot = blockIdx.x;
  const int t = owner_of(slot, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const int p = threadIdx.x;
  const long long o = slot * P + p;
  float T = t_start[o];
  bool done = T < 0.0f;
  if (__syncthreads_and(done)) {  // every pixel of the tile is spent
    partial[o] = 0.0f;
    return;
  }
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_color[(static_cast<long long>(t) * C + c) * P + p];
  const float ga = g_alpha[static_cast<long long>(t) * P + p];
  stage_chunk<6 + C>(sh, entries, dp, slot * CHUNK);
  __syncthreads();
  float sum = 0.0f;
  for (int j = 0; j < CHUNK && !done; ++j) {
    const Splat s = splat_at(sh, j, px, py);
    const float t_next = mul(T, sub(1.0f, s.alpha));
    if (t_next < T_EPS) {
      done = true;
    } else {
      sum = add(sum, mul(u_at<C>(sh, j, g, ga), mul(T, s.alpha)));
      T = t_next;
    }
  }
  partial[o] = sum;
}

// B3b: the per-entry gradients of this chunk, with the suffix of each
// pixel from the later chunks' partials.
template <int C>
__global__ void __launch_bounds__(P) splat_bwd_grads_kernel(
    const float* __restrict__ entries, int nch, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count, int num_tiles,
    int tiles_x, int ncmax, const float* __restrict__ g_color, const float* __restrict__ g_alpha,
    const float* __restrict__ t_start, const float* __restrict__ partial, float* __restrict__ d_entries) {
  constexpr int NV = 6 + C;  // gradient rows: mean xy, conic abc, opacity, colors
  static_assert(NV <= 16, "the warp fold takes at most 16 values");
  __shared__ int s_owner;
  __shared__ float sh[NV][CHUNK];
  __shared__ float red[NWARP][NV][CHUNK];
  const long long slot = blockIdx.x;
  const int t = owner_of(slot, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const long long o = slot * P + p;
  float* out = d_entries + slot * CHUNK;
  float T = t_start[o];
  bool done = T < 0.0f;
  if (__syncthreads_and(done)) {  // every pixel of the tile is spent: zero gradient, still written
    for (int i = p; i < nch * CHUNK; i += P) out[(i / CHUNK) * dp + i % CHUNK] = 0.0f;
    return;
  }
  const long long s0 = tile_start[t] / CHUNK;
  const long long s_end = s0 + min(tile_count[t] / CHUNK, ncmax);
  float later = 0.0f;
  for (long long s = slot + 1; s < s_end; ++s) later += partial[s * P + p];
  const float part = partial[o];
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  float g[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g[c] = g_color[(static_cast<long long>(t) * C + c) * P + p];
  const float ga = g_alpha[static_cast<long long>(t) * P + p];
  stage_chunk<NV>(sh, entries, dp, slot * CHUNK);
  __syncthreads();

  float prefix = 0.0f;
  for (int j = 0; j < CHUNK; ++j) {
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = 0.0f;
    bool nonzero = false;
    if (!done) {
      const Splat s = splat_at(sh, j, px, py);
      const float t_next = mul(T, sub(1.0f, s.alpha));
      const bool live = t_next >= T_EPS;  // inclusive transmittance kept
      const float w = live ? mul(T, s.alpha) : 0.0f;
      const float u = u_at<C>(sh, j, g, ga);
      prefix = add(prefix, mul(u, w));
      const float suffix = later + sub(part, prefix);
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
    const float sum = __any_sync(FULL, nonzero) ? warp_sum16(v, lane) : 0.0f;
    if ((lane & 1) == 0 && (lane >> 1) < NV) red[warp][lane >> 1][j] = sum;
  }
  __syncthreads();
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

}  // namespace

// Launches B2 on `stream`: entries (nch, dp) f32; tile_start, tile_count
// (num_tiles,) i32; outputs color (num_tiles, C, 256) and alpha
// (num_tiles, 1, 256) f32, every tile written, and the chunk-start state
// t_start (dp / 128, 256) f32 on every slot a tile owns.  Returns the CUDA
// error of the launch (0 on success); C outside 1..4 returns
// cudaErrorInvalidValue.
extern "C" int gom_splat_fwd(const float* entries, int nch, long long dp, const int32_t* tile_start,
                             const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                             float* color, float* alpha, float* t_start, void* stream) {
  if (num_tiles <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOM_SPLAT_FWD(NC)                                                                           \
  splat_fwd_kernel<NC><<<num_tiles, P, 0, st>>>(entries, dp, tile_start, tile_count, tiles_x, ncmax, \
                                                color, alpha, t_start)
  switch (C) {
    case 1: GOM_SPLAT_FWD(1); break;
    case 2: GOM_SPLAT_FWD(2); break;
    case 3: GOM_SPLAT_FWD(3); break;
    case 4: GOM_SPLAT_FWD(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOM_SPLAT_FWD
  return static_cast<int>(cudaGetLastError());
}

// Launches B3a on `stream`: entries and tiles as B2, the cotangents g_color
// (num_tiles, C, 256) and g_alpha (num_tiles, 1, 256) f32 and B2's t_start;
// writes partial (dp / 128, 256) f32 on every slot a tile owns.  Returns the
// CUDA error of the launch.
extern "C" int gom_splat_bwd_partials(const float* entries, int nch, long long dp, const int32_t* tile_start,
                                      const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                                      const float* g_color, const float* g_alpha, const float* t_start,
                                      float* partial, void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0 || n_slots <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOM_SPLAT_B3A(NC)                                                                                 \
  splat_bwd_partials_kernel<NC><<<n_slots, P, 0, st>>>(entries, dp, tile_start, tile_count, num_tiles, \
                                                       tiles_x, ncmax, g_color, g_alpha, t_start, partial)
  switch (C) {
    case 1: GOM_SPLAT_B3A(1); break;
    case 2: GOM_SPLAT_B3A(2); break;
    case 3: GOM_SPLAT_B3A(3); break;
    case 4: GOM_SPLAT_B3A(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOM_SPLAT_B3A
  return static_cast<int>(cudaGetLastError());
}

// Launches B3b on `stream`: as B3a, plus B3a's partial; writes d_entries
// (nch, dp) on every slot a tile owns.  Returns the CUDA error of the
// launch.
extern "C" int gom_splat_bwd_grads(const float* entries, int nch, long long dp, const int32_t* tile_start,
                                   const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                                   const float* g_color, const float* g_alpha, const float* t_start,
                                   const float* partial, float* d_entries, void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0 || n_slots <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOM_SPLAT_B3B(NC)                                                                                  \
  splat_bwd_grads_kernel<NC><<<n_slots, P, 0, st>>>(entries, nch, dp, tile_start, tile_count, num_tiles, \
                                                    tiles_x, ncmax, g_color, g_alpha, t_start, partial, d_entries)
  switch (C) {
    case 1: GOM_SPLAT_B3B(1); break;
    case 2: GOM_SPLAT_B3B(2); break;
    case 3: GOM_SPLAT_B3B(3); break;
    case 4: GOM_SPLAT_B3B(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOM_SPLAT_B3B
  return static_cast<int>(cudaGetLastError());
}
