// Kernels B2 and B3 for Hopper: the train-path splat compositing forward and
// its analytic backward, each in two launches over the chunks of the entry
// buffer (B2a, B2b; B3a, B3b).
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
// operations and one exp each.  Its tiles own ~6 chunks each on average
// but up to ~14, so no kernel here runs one block per tile: every grid
// runs over chunks, one block per 128-entry slot of the buffer (sized from
// dp on the host), 256 threads (one per pixel).  Each block finds the tile
// that owns its slot on the device (common.cuh: owner_of, a scan of
// tile_start / tile_count, which also states what happens where buffer
// clamping makes tiles share a tile_start) and returns at once if none
// does.  So the longest segment no longer runs on one SM.  Each block
// stages its chunk once in shared memory, read by all threads as
// broadcasts, and keeps every per-pixel sum in registers.  Design:
//   * B2a: per pixel, the chunk swept alone from T = 1 with the per-entry
//     rule: the local colour and alpha sums and the local transmittance
//     T_k, or CROSSED where the local sweep already fell below 1e-4 (it
//     stops there: T never rises).  (dp / 128, C + 2, 256) f32 of partials.
//   * B2b, one block per owned slot (tile t, chunk k): each pixel's T
//     entering chunk k is the product of the earlier chunks' T_j while
//     every one of them lets it through (below); a pixel that reaches
//     chunk k and is not let through re-sweeps it from that T with the
//     per-entry rule (those pixels packed into the block's first threads)
//     and stores what it took and where it ended.  Some 20 pixels of a
//     chunk do so on the trained frame, one warp that other warps do not
//     hide, so each evaluates the alphas of AHEAD entries before the steps
//     of T that take them.  Then the block takes a
//     ticket (atomicAdd after a __threadfence); the tile's last block walks
//     its chunks in order and writes colour, alpha and the state row of
//     every owned chunk: each pixel's T at the chunk's start, or -1 from
//     its stop on (SPENT, also in the chunks after an early stop).  A chunk
//     that lets the pixel through adds T times its partials and T *= T_k;
//     a re-swept chunk adds the stored re-sweep, and the pixel is spent
//     there or carries on from the re-sweep's end T; after such a carry the
//     last block re-sweeps, itself, any later chunk that does not let the
//     pixel through (a second pass, which costs a block barrier per chunk
//     and runs only where some pixel carried).  The last block resets the
//     tile's ticket (B2a zeroes
//     them), so B2b can run again on the same partials.  A tile that sweeps
//     no chunk has no block of its own: block t of B2b's grid (at least
//     num_tiles blocks) writes its zero outputs.
//   * The rule that keeps B3 exact.  B3a and B3b replay each chunk from the
//     state B2b wrote and must spend a pixel at the very entry where B2
//     did.  A chunk lets a pixel through unswept only if it did not cross
//     on its own and T * T_k >= T_THROUGH = 1e-4 (1 + 1e-3).  This margin
//     suffices: T_k and B3a's replay from the state T are products of the
//     same <= 128 factors (1 - alpha) (the same floats: splat_at), each
//     multiply rounded to nearest, so each lies within (1 +- 2^-24)^128 of
//     its exact product, and T * T_k adds one rounding: the replay's end
//     differs from T * T_k by less than 257 * 2^-24 ~ 1.53e-5 relative, and
//     ends above 1e-4 (1 + 1e-3)(1 - 1.53e-5) > 1e-4.  T never rises (a
//     factor <= 1 rounded to nearest cannot exceed T), so no entry before
//     the end crosses either: B3a sweeps a let-through chunk whole.  Every
//     other chunk a pixel reaches is re-swept from the T written as its
//     state, in B3a's arithmetic, so B2 stops where B3a stops, or carries
//     on from the T B3a ends with, which is the next chunk's state.
//   * B3 does not replay the forward: it runs from B2's state.
//   * B3a: per pixel, from the saved T, the partial sum of u w over its own
//     chunk alone, (dp / 128, 256) f32.
//   * B3b: per pixel, the suffix at the chunk's end is the sum of the later
//     chunks' partials of the tile (at most ncmax - 1 reads); walking the
//     chunk again with the local prefix gives S_e = later + (partial -
//     prefix_e).  B2a, B2b, B3a and B3b evaluate alpha, T and u w with the
//     same expf and round-to-nearest intrinsics (never contracted into
//     FMAs), so with the margin above a pixel is spent at the same entry in
//     B2 and B3, the local prefix equals the
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
constexpr float CROSSED = -1.0f;  // B2a's local T of a chunk whose sweep from T = 1 fell below T_EPS
constexpr float T_THROUGH = 1.001e-4f;  // T_EPS (1 + 1e-3): the least T * T_k that lets a chunk through

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

// A pixel's splat state over the entries it sweeps: transmittance, colour
// and alpha sums, and whether an entry took T below T_EPS (it is spent).
template <int C>
struct Blend {
  float T, a, col[C];
  bool stopped;
};

template <int C>
__device__ __forceinline__ Blend<C> blend_from(float T) {
  Blend<C> b;
  b.T = T;
  b.a = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) b.col[c] = 0.0f;
  b.stopped = false;
  return b;
}

// The per-entry rule over a staged chunk, from b.T, for the pixel at (px,
// py): each entry's weight T alpha while the transmittance after it stays
// >= T_EPS; the first entry that takes it below spends the pixel.  B3a
// walks a chunk by the same arithmetic.  The alphas of U entries are
// evaluated before the U steps of T take them (they do not depend on T),
// so that their latencies overlap; the result is the same for every U.
template <int C, int U = 1>
__device__ __forceinline__ void sweep_chunk(const float (*sh)[CHUNK], float px, float py, Blend<C>& b) {
  static_assert(CHUNK % U == 0, "U divides the chunk");
  for (int j0 = 0; j0 < CHUNK && !b.stopped; j0 += U) {
    float alpha[U];
#pragma unroll
    for (int u = 0; u < U; ++u) alpha[u] = splat_at(sh, j0 + u, px, py).alpha;
#pragma unroll
    for (int u = 0; u < U && !b.stopped; ++u) {
      const float t_next = mul(b.T, sub(1.0f, alpha[u]));
      if (t_next < T_EPS) {
        b.stopped = true;
      } else {
        const float w = mul(b.T, alpha[u]);
#pragma unroll
        for (int c = 0; c < C; ++c) b.col[c] += w * sh[E_COL + c][j0 + u];
        b.a += w;
        b.T = t_next;
      }
    }
  }
}

// Store a sweep's sums and its end (T, or CROSSED when it stopped) as C + 2
// rows of stride P.
template <int C>
__device__ __forceinline__ void store_blend(float* out, const Blend<C>& b) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * P] = b.col[c];
  out[C * P] = b.a;
  out[(C + 1) * P] = b.stopped ? CROSSED : b.T;
}

// B2a: one block per slot of the buffer; each pixel sweeps the slot's chunk
// alone from T = 1.  The block of a tile's first chunk zeroes its ticket
// for B2b.
template <int C>
__global__ void __launch_bounds__(P) splat_fwd_partials_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count, int num_tiles,
    int tiles_x, int ncmax, float* __restrict__ part, int32_t* __restrict__ tickets) {
  __shared__ int s_owner;
  __shared__ float sh[6 + C][CHUNK];
  const long long slot = blockIdx.x;
  const int t = owner_of(slot, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const int p = threadIdx.x;
  if (p == 0 && slot == tile_start[t] / CHUNK) tickets[t] = 0;
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  stage_chunk<6 + C>(sh, entries, dp, slot * CHUNK);
  __syncthreads();
  Blend<C> b = blend_from<C>(1.0f);
  sweep_chunk<C>(sh, px, py, b);
  store_blend<C>(part + slot * (C + 2) * P + threadIdx.x, b);
}

// Entries whose alphas B2b's re-sweeps evaluate ahead of the chain of T: a
// chunk's ~20 re-sweeping pixels (on average) fill one warp, so its
// latency is not hidden by other warps, and with one entry at a time each
// step waits on the whole alpha arithmetic (expf included).  B2a's eight
// full warps per block hide it, and sweep one entry at a time.
constexpr int AHEAD = 4;

// Whether chunk j lets a pixel with transmittance T through unswept: it did
// not cross on its own, and T * T_j clears the margin.
__device__ __forceinline__ bool lets_through(float T, float t_j) {
  return t_j != CROSSED && mul(T, t_j) >= T_THROUGH;
}

// B2b: one block per owned slot (and at least one per tile): the re-sweep
// of the chunk where each pixel is not let through, then, in the tile's
// last block, the merge of its chunks in order.
template <int C>
__global__ void __launch_bounds__(P) splat_fwd_merge_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count, int num_tiles,
    int tiles_x, int ncmax, const float* __restrict__ part, float* sweep, int32_t* tickets,
    float* __restrict__ color_out, float* __restrict__ alpha_out, float* __restrict__ t_start) {
  constexpr int NR = C + 2;  // rows of a partial and of a re-sweep record
  __shared__ int s_owner, s_last, s_n;
  __shared__ float sh[6 + C][CHUNK];
  __shared__ int s_pix[P];  // the pixels that re-sweep this chunk, and their T
  __shared__ float s_t[P];
  const long long b = blockIdx.x;
  const int p = threadIdx.x;
  if (b < num_tiles && min(tile_count[b] / CHUNK, ncmax) <= 0) {  // tile b sweeps nothing: zero outputs
#pragma unroll
    for (int c = 0; c < C; ++c) color_out[(b * C + c) * P + p] = 0.0f;
    alpha_out[b * P + p] = 0.0f;
  }
  if (b >= dp / CHUNK) return;
  const int t = owner_of(b, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const long long s0 = tile_start[t] / CHUNK;
  const int n = min(tile_count[t] / CHUNK, ncmax);
  const int k = static_cast<int>(b - s0);
  const float x0 = static_cast<float>((t % tiles_x) * TILE);
  const float y0 = static_cast<float>((t / tiles_x) * TILE);
  const float* t_row = part + (s0 * NR + C + 1) * P + p;  // T_j at t_row[j * NR * P]

  // the transmittance entering chunk k, while every earlier chunk lets the
  // pixel through (no early exit, so that the loads go out together)
  float T = 1.0f;
  bool alive = true;
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float t_j = t_row[static_cast<long long>(j) * NR * P];
    alive = alive && lets_through(T, t_j);
    if (alive) T = mul(T, t_j);
  }
  const bool here = alive && !lets_through(T, t_row[static_cast<long long>(k) * NR * P]);
  // those pixels re-sweep chunk k from T, packed into the first threads
  if (p == 0) s_n = 0;
  __syncthreads();
  if (here) {
    const int i = atomicAdd(&s_n, 1);
    s_pix[i] = p;
    s_t[i] = T;
  }
  __syncthreads();
  const int n_sweep = s_n;
  if (n_sweep > 0) {
    stage_chunk<6 + C>(sh, entries, dp, b * CHUNK);
    __syncthreads();
    if (p < n_sweep) {
      const int q = s_pix[p];
      Blend<C> r = blend_from<C>(s_t[p]);
      sweep_chunk<C, AHEAD>(sh, x0 + static_cast<float>(q % TILE), y0 + static_cast<float>(q / TILE), r);
      store_blend<C>(sweep + b * NR * P + q, r);
    }
  }

  // the tile's last block to finish merges its chunks
  __threadfence();  // this block's re-sweeps are visible before its ticket
  __syncthreads();
  if (p == 0) s_last = atomicAdd(&tickets[t], 1) == n - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (p == 0) tickets[t] = 0;  // reset for the next launch

  // chunks that let the pixel through, then the re-sweep of the chunk where
  // it stops, which block j stored from the same T
  Blend<C> acc = blend_from<C>(1.0f);
  bool carried = false;  // a re-sweep ended without a stop: T went on from it
  int pend = n;  // after a carry, the first chunk that does not let the pixel through
  for (int j = 0; j < n && pend == n; ++j) {
    const long long row = s0 + j;
    if (acc.stopped) {
      t_start[row * P + p] = SPENT;
      continue;
    }
    const float* in = part + row * NR * P + p;
    float v[NR];  // loaded together: one round trip per chunk
#pragma unroll
    for (int r = 0; r < NR; ++r) v[r] = in[r * P];
    t_start[row * P + p] = acc.T;
    if (lets_through(acc.T, v[C + 1])) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc.col[c] += acc.T * v[c];
      acc.a += acc.T * v[C];
      acc.T = mul(acc.T, v[C + 1]);
    } else if (!carried) {  // read from L2, not from a stale L1 line
      const float* sw = sweep + row * NR * P + p;
#pragma unroll
      for (int c = 0; c < C; ++c) acc.col[c] += __ldcg(sw + c * P);
      acc.a += __ldcg(sw + C * P);
      const float t_end = __ldcg(sw + (C + 1) * P);
      acc.stopped = t_end == CROSSED;
      carried = !acc.stopped;
      if (carried) acc.T = t_end;
    } else {
      pend = j;
    }
  }
  // rare: after a carry, the block re-sweeps the chunks that do not let the
  // pixel through itself, from the carried T
  if (__syncthreads_or(pend < n)) {
    const float px = x0 + static_cast<float>(p % TILE);
    const float py = y0 + static_cast<float>(p / TILE);
    for (int j = 0; j < n; ++j) {
      const long long row = s0 + j;
      bool own = false;
      if (j > pend) t_start[row * P + p] = acc.stopped ? SPENT : acc.T;
      if (j >= pend && !acc.stopped) {
        const float* in = part + row * NR * P + p;
        const float t_j = in[(C + 1) * P];
        own = j == pend || !lets_through(acc.T, t_j);
        if (!own) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc.col[c] += acc.T * in[c * P];
          acc.a += acc.T * in[C * P];
          acc.T = mul(acc.T, t_j);
        }
      }
      if (__syncthreads_or(own)) {
        stage_chunk<6 + C>(sh, entries, dp, row * CHUNK);
        __syncthreads();
        if (own) {
          Blend<C> r = blend_from<C>(acc.T);
          sweep_chunk<C, AHEAD>(sh, px, py, r);
#pragma unroll
          for (int c = 0; c < C; ++c) acc.col[c] += r.col[c];
          acc.a += r.a;
          acc.stopped = r.stopped;
          if (!r.stopped) acc.T = r.T;
        }
        __syncthreads();  // the chunk is consumed before the next stage
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) color_out[(static_cast<long long>(t) * C + c) * P + p] = acc.col[c];
  alpha_out[static_cast<long long>(t) * P + p] = acc.a;
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

// Launches B2a on `stream` over dp / 128 blocks: entries (nch, dp) f32;
// tile_start, tile_count (num_tiles,) i32; writes part (dp / 128, C + 2,
// 256) f32 on every slot a tile owns (colour sums, alpha sum, local T or
// CROSSED) and zeroes tickets (num_tiles,) i32 of every tile that sweeps a
// chunk.  Returns the CUDA error of the launch (0 on success); C outside
// 1..4 returns cudaErrorInvalidValue.
extern "C" int gom_splat_fwd_partials(const float* entries, int nch, long long dp, const int32_t* tile_start,
                                      const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                                      float* part, int32_t* tickets, void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0 || n_slots <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GOM_SPLAT_B2A(NC)                                                                                 \
  splat_fwd_partials_kernel<NC><<<n_slots, P, 0, st>>>(entries, dp, tile_start, tile_count, num_tiles, \
                                                       tiles_x, ncmax, part, tickets)
  switch (C) {
    case 1: GOM_SPLAT_B2A(1); break;
    case 2: GOM_SPLAT_B2A(2); break;
    case 3: GOM_SPLAT_B2A(3); break;
    case 4: GOM_SPLAT_B2A(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOM_SPLAT_B2A
  return static_cast<int>(cudaGetLastError());
}

// Launches B2b on `stream` over max(dp / 128, num_tiles) blocks: the inputs
// of B2a, its partials and tickets, and the scratch sweep (dp / 128, C + 2,
// 256) f32.  Writes color (num_tiles, C, 256) and alpha (num_tiles, 1, 256)
// f32, every tile, and the chunk-start state t_start (dp / 128, 256) f32 on
// every slot a tile owns; leaves part and tickets as it found them.
// Returns the CUDA error of the launch.
extern "C" int gom_splat_fwd_merge(const float* entries, int nch, long long dp, const int32_t* tile_start,
                                   const int32_t* tile_count, int num_tiles, int tiles_x, int C, int ncmax,
                                   const float* part, float* sweep, int32_t* tickets, float* color, float* alpha,
                                   float* t_start, void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0) return 0;
  if (nch < 6 + C) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long grid = n_slots > num_tiles ? n_slots : num_tiles;
#define GOM_SPLAT_B2B(NC)                                                                                    \
  splat_fwd_merge_kernel<NC><<<grid, P, 0, st>>>(entries, dp, tile_start, tile_count, num_tiles, tiles_x, \
                                                 ncmax, part, sweep, tickets, color, alpha, t_start)
  switch (C) {
    case 1: GOM_SPLAT_B2B(1); break;
    case 2: GOM_SPLAT_B2B(2); break;
    case 3: GOM_SPLAT_B2B(3); break;
    case 4: GOM_SPLAT_B2B(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GOM_SPLAT_B2B
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
