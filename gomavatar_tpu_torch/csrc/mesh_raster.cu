// Kernels B4 and B5 for Hopper: the train-path mesh raster (hard normal
// z-buffer + soft silhouette) forward and its analytic backward.
//
// Replace the TPU kernels gomavatar_tpu/ops/mesh_raster_pallas.py:_fwd_kernel
// (B4) and _bwd_kernel (B5).  Entries are (16, dp) f32: x0 y0 x1 y1 x2 y2
// (pixel coordinates of the three vertices) | z0 z1 z2 | summed vertex
// normal xyz | valid (the entry's mesh flag times the face's in-front flag)
// | zero rows.  Tile t owns the 128-aligned segment
// [tile_start[t], tile_start[t] + tile_count[t]) and sweeps its first
// min(tile_count[t] / 128, ncmax) chunks in depth order.
//
// Hard pass, per pixel: 2D barycentrics w0, w1 by the edge functions over
// the signed area (IEEE division), w2 = 1 - w0 - w1, z = w0 z0 + w1 z1 +
// w2 z2; a covered, valid, non-degenerate entry with z < best_z wins, so
// the FIRST entry at the minimum depth wins.  Output: its summed normal and
// the hit flag.  This arithmetic uses round-to-nearest intrinsics, which
// the compiler never contracts into FMAs, so depths round exactly as the
// plain version's separate operations do and the same face wins.
//
// Soft pass, per pixel: S = sum_e log1p(-min(sigmoid(-signed_e / s2),
// 1 - 1e-7)) over valid entries, signed = -d2 inside the triangle and +d2
// outside, d2 the squared distance to the nearest edge segment, s2 the
// temperature in px^2; soft = 1 - e^S.  Once every pixel of the tile has
// S <= log_sat (-18) at a chunk's start, that chunk's soft term is skipped:
// it would change the silhouette by < e^-18 per face.  S never rises, so
// the live chunks are a prefix of the segment.
//
// B4 also saves what the backward needs, three values its merge ends with:
//   win  (T, 256) i32: the entry index (offset into dp) of each pixel's
//        winner, -1 where nothing hit;
//   S    (T, 256) f32: the final sum above (0 with the soft pass off);
//   live (T,) i32: the number of chunks whose soft term ran.
//
// Backward (B5), from those residuals alone: the normal cotangent of pixel
// p goes to entry win[p]; the soft cotangent dL/dS = -g_soft e^S flows, in
// the live chunks only, through the chain written out by hand (the
// reference takes jax.vjp of the same function inside its kernel):
//   d/dq log1p(-q) = -1/(1 - q), zero where the clamp q = 1 - 1e-7 holds;
//   sigmoid' = p (1 - p); d signed/d d2 = -1 inside, +1 outside;
//   the minimum over three edges -> its argmin edge, ties split evenly
//   (a tie sits at a shared vertex, where the split does not change the
//   sum); the edge projection t = clip(((p-a).(b-a)) / |b-a|^2, 0, 1),
//   its gradient passed strictly inside (0, 1) and halved at a bound.
// A skipped chunk gets zero soft gradient: the exact gradient of the
// truncated sum the forward computed.  Nothing flows through the hard mask
// or through z.  `inside` keeps the hard pass's FMA-free arithmetic, so the
// sign of each term is the forward's.  `ops/mesh_raster_pallas.py:
// soft_log1m_grad` is the same chain in plain PyTorch, held to the
// reference's autodiff by the tests.
//
// What bounds them on the card: arithmetic.  The soft term costs ~60 fp32
// operations, an exp and a log per (pixel, entry) pair in B4, its chain
// ~240 in B5; the entries are 64 B each.  A tile's segment runs to 14
// chunks on the trained 512^2 frame while the mean is 6.5, so the pair
// work runs one block per chunk, not per tile: one block per 128-entry slot
// of the entry buffer (sized from dp on the host); the block finds the tile
// that owns its slot on the device (common.cuh: owner_of, a scan of
// tile_start / tile_count, which also states what happens where buffer
// clamping makes tiles share a tile_start) and returns at once if none
// does.  Design:
//   * B4 is two launches.  B4a, one block per chunk, 256 threads (one per
//     pixel): the block derives each entry's barycentric and edge set-up
//     once into shared memory (the hard pass's values bit-equal to a
//     per-pair derivation: same round-to-nearest operations), then each
//     pixel sweeps the chunk alone and stores its hard partial, the first
//     entry at the minimum z as (z, entry index), and its soft partial, the
//     chunk's sum of log(1 - p) from 0.  The soft partial is computed for
//     every chunk, live or not: whether a chunk is live depends on the sum
//     of the chunks before it, which B4a cannot see.  B4b, one block per
//     tile, walks the tile's partials in chunk order: the live rule at each
//     chunk's start (one barrier), S += the live partials, and a strict <
//     on z in chunk order, which keeps the first entry at the minimum z as
//     the one-pass sweep does.  It writes the outputs and the residuals.
//     The scratch is 12 bytes per (slot, pixel), allocated by the wrapper.
//   * B5 replays nothing: with win and S saved, the z-buffer and the soft
//     sum need no pass of their own.  It gives each entry its own threads
//     (one block per chunk, as B4a).  The block stages the tile's
//     per-pixel dL/dS, win and normal cotangent in shared memory (5 KB);
//     each thread keeps its entry's vertices, edge constants and nine
//     gradient sums in registers and loops over its pixels (a warp reads
//     one pixel at a time, as a broadcast).  No shuffles, no cross-warp
//     reductions, no atomics: every entry belongs to one tile, so its two
//     threads own all of its gradient, add their halves once at the end
//     and store its 16 rows once, zeros included.  Two threads per entry,
//     each over half the pixels, ran faster than one or four on the
//     trained 512^2 frame (one holds the same 24 warps per SM, with twice
//     the loop per block; four fit only 16; PERF.md).
//   * Slots no tile owns are left unwritten; the wrapper selects them out.

#include "common.cuh"

namespace {

constexpr int NCH = 16;
constexpr float BIG = 1e10f;
constexpr float ONE_MINUS = 1.0f - 1e-7f;

enum { E_X0 = 0, E_Y0, E_X1, E_Y1, E_X2, E_Y2, E_Z0, E_Z1, E_Z2, E_NX, E_NY, E_NZ, E_VALID };

// The barycentric set-up of one triangle, in the plain version's arithmetic.
struct Bary {
  float a12, b21, a20, b02;  // y1 - y2, x2 - x1, y2 - y0, x0 - x2
  float ds;                  // the signed area, 1 where degenerate
  bool degenerate;
};

__device__ __forceinline__ Bary bary_setup(float x0, float y0, float x1, float y1, float x2, float y2) {
  Bary b;
  b.a12 = sub(y1, y2);
  b.b21 = sub(x2, x1);
  b.a20 = sub(y2, y0);
  b.b02 = sub(x0, x2);
  const float denom = add(mul(b.a12, b.b02), mul(b.b21, sub(y0, y2)));
  b.degenerate = fabsf(denom) < 1e-12f;
  b.ds = b.degenerate ? 1.0f : denom;
  return b;
}

// w0 and w1 (IEEE division), their numerators from the pixel's offset to
// vertex 2.
__device__ __forceinline__ void bary_at(const Bary& b, float dxp, float dyp, float& w0, float& w1) {
  w0 = __fdiv_rn(add(mul(b.a12, dxp), mul(b.b21, dyp)), b.ds);
  w1 = __fdiv_rn(add(mul(b.a20, dxp), mul(b.b02, dyp)), b.ds);
}

struct Edge {
  float abx, aby, d2ab, inv;  // per edge: b - a, |b - a|^2, 1 / max(|b - a|^2, 1e-12)
};

__device__ __forceinline__ Edge edge_setup(float ax, float ay, float bx, float by) {
  Edge e;
  e.abx = bx - ax;
  e.aby = by - ay;
  e.d2ab = e.abx * e.abx + e.aby * e.aby;
  e.inv = 1.0f / fmaxf(e.d2ab, 1e-12f);
  return e;
}

// The pixel's projection onto one edge segment.
struct Proj {
  float num, t, tc, dx, dy, d2;
};

__device__ __forceinline__ Proj proj_at(const Edge& e, float px, float py, float ax, float ay) {
  Proj q;
  q.num = (px - ax) * e.abx + (py - ay) * e.aby;
  q.t = q.num * e.inv;
  q.tc = fminf(fmaxf(q.t, 0.0f), 1.0f);
  q.dx = px - (ax + q.tc * e.abx);
  q.dy = py - (ay + q.tc * e.aby);
  q.d2 = q.dx * q.dx + q.dy * q.dy;
  return q;
}

// d(edge d2)/d(a, b) times g_d, added into ga/gb (x, y).
__device__ __forceinline__ void edge_grad(const Edge& e, const Proj& q, float px, float py, float ax, float ay,
                                          float g_d, float& gax, float& gay, float& gbx, float& gby) {
  const float gdx = 2.0f * q.dx * g_d, gdy = 2.0f * q.dy * g_d;
  const float g_tc = -(gdx * e.abx + gdy * e.aby);
  const float pass_t = (q.t > 0.0f && q.t < 1.0f) ? 1.0f : ((q.t == 0.0f || q.t == 1.0f) ? 0.5f : 0.0f);
  const float g_t = g_tc * pass_t;
  const float g_num = g_t * e.inv;
  const float g_d2ab = e.d2ab > 1e-12f ? -g_t * q.num * e.inv * e.inv : 0.0f;
  gax += gdx * (q.tc - 1.0f) + g_num * (-e.abx - (px - ax)) - 2.0f * e.abx * g_d2ab;
  gbx += -gdx * q.tc + g_num * (px - ax) + 2.0f * e.abx * g_d2ab;
  gay += gdy * (q.tc - 1.0f) + g_num * (-e.aby - (py - ay)) - 2.0f * e.aby * g_d2ab;
  gby += -gdy * q.tc + g_num * (py - ay) + 2.0f * e.aby * g_d2ab;
}

__device__ __forceinline__ float sigmoid_of_signed(float d2, bool inside, float sigma_px2) {
  const float signed_d2 = inside ? -d2 : d2;
  return 1.0f / (1.0f + expf(signed_d2 / sigma_px2));  // sigmoid(-signed / s2)
}

// Each entry's set-up in B4a's shared memory: the vertices, the depths,
// the barycentric set-up, the three edges' (b - a, 1 / |b - a|^2) and two
// flags: hard (valid and not degenerate) and soft (valid).
enum { S_X0 = 0, S_Y0, S_X1, S_Y1, S_X2, S_Y2, S_Z0, S_Z1, S_Z2, S_A12, S_B21, S_A20, S_B02, S_DS,
       S_E01, S_E12 = S_E01 + 3, S_E20 = S_E12 + 3, S_HARD = S_E20 + 3, S_SOFT, NSET };

__device__ __forceinline__ void stage_edge(float (*sh)[CHUNK], int row, int j, const Edge& e) {
  sh[row][j] = e.abx;
  sh[row + 1][j] = e.aby;
  sh[row + 2][j] = e.inv;
}

__device__ __forceinline__ Edge staged_edge(const float (*sh)[CHUNK], int row, int j) {
  Edge e;
  e.abx = sh[row][j];
  e.aby = sh[row + 1][j];
  e.d2ab = 0.0f;  // not read by proj_at
  e.inv = sh[row + 2][j];
  return e;
}

// B4a: one block per chunk slot, one thread per pixel of the owning tile.
// Writes, for its slot, each pixel's hard partial (z_part: the depth of the
// first eligible entry at the chunk's minimum z, BIG where none; i_part: its
// entry index, -1 where none) and soft partial (s_part: the chunk's sum of
// log(1 - p) over valid entries, 0 with the soft pass off).
__global__ void __launch_bounds__(P) mesh_fwd_chunk_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int num_tiles, int tiles_x, int ncmax, int soft, float sigma_px2,
    float* __restrict__ z_part, int32_t* __restrict__ i_part, float* __restrict__ s_part) {
  __shared__ int s_owner;
  __shared__ float sh[NSET][CHUNK];
  const long long slot = blockIdx.x;
  const int t = owner_of(slot, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const long long base = slot * CHUNK;
  if (threadIdx.x < CHUNK) {
    const int j = threadIdx.x;
    const long long e = base + j;
    const float x0 = entries[E_X0 * dp + e], y0 = entries[E_Y0 * dp + e];
    const float x1 = entries[E_X1 * dp + e], y1 = entries[E_Y1 * dp + e];
    const float x2 = entries[E_X2 * dp + e], y2 = entries[E_Y2 * dp + e];
    const Bary b = bary_setup(x0, y0, x1, y1, x2, y2);
    const bool valid = entries[E_VALID * dp + e] > 0.0f;
    sh[S_X0][j] = x0;
    sh[S_Y0][j] = y0;
    sh[S_X1][j] = x1;
    sh[S_Y1][j] = y1;
    sh[S_X2][j] = x2;
    sh[S_Y2][j] = y2;
    sh[S_Z0][j] = entries[E_Z0 * dp + e];
    sh[S_Z1][j] = entries[E_Z1 * dp + e];
    sh[S_Z2][j] = entries[E_Z2 * dp + e];
    sh[S_A12][j] = b.a12;
    sh[S_B21][j] = b.b21;
    sh[S_A20][j] = b.a20;
    sh[S_B02][j] = b.b02;
    sh[S_DS][j] = b.ds;
    stage_edge(sh, S_E01, j, edge_setup(x0, y0, x1, y1));
    stage_edge(sh, S_E12, j, edge_setup(x1, y1, x2, y2));
    stage_edge(sh, S_E20, j, edge_setup(x2, y2, x0, y0));
    sh[S_HARD][j] = valid && !b.degenerate ? 1.0f : 0.0f;
    sh[S_SOFT][j] = valid ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int p = threadIdx.x;
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  float best_z = BIG, log_om = 0.0f;
  int best_j = -1;
  for (int j = 0; j < CHUNK; ++j) {
    Bary b;
    b.a12 = sh[S_A12][j];
    b.b21 = sh[S_B21][j];
    b.a20 = sh[S_A20][j];
    b.b02 = sh[S_B02][j];
    b.ds = sh[S_DS][j];
    const float x0 = sh[S_X0][j], y0 = sh[S_Y0][j], x1 = sh[S_X1][j], y1 = sh[S_Y1][j];
    const float x2 = sh[S_X2][j], y2 = sh[S_Y2][j];
    float w0, w1;
    bary_at(b, sub(px, x2), sub(py, y2), w0, w1);
    const float w2 = sub(sub(1.0f, w0), w1);
    const bool inside = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f;
    const float z = add(add(mul(w0, sh[S_Z0][j]), mul(w1, sh[S_Z1][j])), mul(w2, sh[S_Z2][j]));
    if (inside && sh[S_HARD][j] > 0.0f && z < best_z) {
      best_z = z;
      best_j = j;
    }
    if (soft && sh[S_SOFT][j] > 0.0f) {
      const float d2 = fminf(proj_at(staged_edge(sh, S_E01, j), px, py, x0, y0).d2,
                             fminf(proj_at(staged_edge(sh, S_E12, j), px, py, x1, y1).d2,
                                   proj_at(staged_edge(sh, S_E20, j), px, py, x2, y2).d2));
      log_om += log1pf(-fminf(sigmoid_of_signed(d2, inside, sigma_px2), ONE_MINUS));
    }
  }
  const long long o = slot * P + p;
  z_part[o] = best_z;
  i_part[o] = best_j < 0 ? -1 : static_cast<int>(base) + best_j;
  s_part[o] = log_om;
}

// B4b: one block per tile, one thread per pixel: the tile's partials merged
// in chunk order into the outputs and B5's residuals.
__global__ void __launch_bounds__(P) mesh_fwd_merge_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count, int ncmax, int soft,
    float log_sat, const float* __restrict__ z_part, const int32_t* __restrict__ i_part,
    const float* __restrict__ s_part, float* __restrict__ hard_out, float* __restrict__ soft_out,
    int32_t* __restrict__ win_out, float* __restrict__ s_out, int32_t* __restrict__ live_out) {
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long s0 = tile_start[t] / CHUNK;
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  float best_z = BIG, log_om = 0.0f;
  int best_i = -1, live = 0;
  for (int k = 0; k < nchunks; ++k) {
    const long long o = (s0 + k) * P + p;
    // the barrier decides, for the whole tile, whether the soft term of
    // chunk k is live
    if (__syncthreads_or(soft && log_om > log_sat)) {
      live = k + 1;
      log_om += s_part[o];
    }
    const float z = z_part[o];
    if (z < best_z) {  // strict, in chunk order: the first entry at the minimum z
      best_z = z;
      best_i = i_part[o];
    }
  }
  const long long o = static_cast<long long>(t) * 4 * P + p;
  const bool hit = best_z < BIG;
  hard_out[o] = hit ? entries[E_NX * dp + best_i] : 0.0f;
  hard_out[o + P] = hit ? entries[E_NY * dp + best_i] : 0.0f;
  hard_out[o + 2 * P] = hit ? entries[E_NZ * dp + best_i] : 0.0f;
  hard_out[o + 3 * P] = hit ? 1.0f : 0.0f;
  const long long op = static_cast<long long>(t) * P + p;
  soft_out[op] = soft ? 1.0f - expf(log_om) : 0.0f;
  win_out[op] = hit ? best_i : -1;
  s_out[op] = log_om;
  if (p == 0) live_out[t] = live;
}

// Threads per entry in B5, each over P / SPLIT of the pixels.
constexpr int SPLIT = 2;

__global__ void __launch_bounds__(CHUNK * SPLIT) mesh_bwd_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int num_tiles, int tiles_x, int ncmax, int soft, float sigma_px2,
    const float* __restrict__ g_hard, const float* __restrict__ g_soft,
    const int32_t* __restrict__ win, const float* __restrict__ s_in, const int32_t* __restrict__ live,
    float* __restrict__ d_entries) {
  constexpr int NV = 9;  // gradient values: 6 coordinates, 3 normal
  __shared__ int s_owner;
  __shared__ float s_dl[P], s_gn[3][P];
  __shared__ int s_win[P];
  __shared__ float s_part[SPLIT - 1][NV][CHUNK];
  const long long slot = blockIdx.x;
  const int t = owner_of(slot, tile_start, tile_count, num_tiles, ncmax, &s_owner);
  if (t < 0) return;  // no tile owns this slot
  const int k = static_cast<int>(slot - tile_start[t] / CHUNK);
  const bool soft_live = soft && k < live[t];
  for (int p = threadIdx.x; p < P; p += CHUNK * SPLIT) {
    const long long op = static_cast<long long>(t) * P + p;
    // soft = 1 - e^S, so dL/dS = -g_soft e^S
    s_dl[p] = soft_live ? -g_soft[op] * expf(s_in[op]) : 0.0f;
    s_win[p] = win[op];
    const long long oh = static_cast<long long>(t) * 4 * P + p;
    s_gn[0][p] = g_hard[oh];
    s_gn[1][p] = g_hard[oh + P];
    s_gn[2][p] = g_hard[oh + 2 * P];
  }
  __syncthreads();

  const int j = threadIdx.x % CHUNK, part = threadIdx.x / CHUNK;
  const long long e = slot * CHUNK + j;
  const float x0 = entries[E_X0 * dp + e], y0 = entries[E_Y0 * dp + e];
  const float x1 = entries[E_X1 * dp + e], y1 = entries[E_Y1 * dp + e];
  const float x2 = entries[E_X2 * dp + e], y2 = entries[E_Y2 * dp + e];
  const bool live_entry = soft_live && entries[E_VALID * dp + e] > 0.0f;
  const Bary b = bary_setup(x0, y0, x1, y1, x2, y2);
  const Edge e01 = edge_setup(x0, y0, x1, y1), e12 = edge_setup(x1, y1, x2, y2), e20 = edge_setup(x2, y2, x0, y0);
  const int tx0 = (t % tiles_x) * TILE, ty0 = (t / tiles_x) * TILE;
  const int ent = static_cast<int>(e);

  float v[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = 0.0f;
  for (int i = 0; i < P / SPLIT; ++i) {
    const int p = part * (P / SPLIT) + i;
    if (s_win[p] == ent) {
      v[6] += s_gn[0][p];
      v[7] += s_gn[1][p];
      v[8] += s_gn[2][p];
    }
    const float dl_ds = s_dl[p];
    if (dl_ds == 0.0f || !live_entry) continue;
    const float px = static_cast<float>(tx0 + p % TILE), py = static_cast<float>(ty0 + p / TILE);
    float w0, w1;
    bary_at(b, sub(px, x2), sub(py, y2), w0, w1);
    const bool inside = w0 >= 0.0f && w1 >= 0.0f && sub(sub(1.0f, w0), w1) >= 0.0f;
    const Proj q01 = proj_at(e01, px, py, x0, y0), q12 = proj_at(e12, px, py, x1, y1);
    const Proj q20 = proj_at(e20, px, py, x2, y2);
    const float m12 = fminf(q12.d2, q20.d2);
    const float prob = sigmoid_of_signed(fminf(q01.d2, m12), inside, sigma_px2);
    const float q = fminf(prob, ONE_MINUS);
    const float g_q = -dl_ds / (1.0f - q);
    const float g_prob = prob < ONE_MINUS ? g_q : (prob == ONE_MINUS ? 0.5f * g_q : 0.0f);
    const float g_signed = -(g_prob * prob * (1.0f - prob)) / sigma_px2;
    const float g_d2 = inside ? -g_signed : g_signed;
    // the argmin edge of min(d01, min(d12, d20)), ties split evenly
    const float t0 = q01.d2 == m12 ? 0.5f : 0.0f;
    const float g01 = g_d2 * (q01.d2 < m12 ? 1.0f : t0);
    const float g_m12 = g_d2 * (m12 < q01.d2 ? 1.0f : t0);
    const float t1 = q12.d2 == q20.d2 ? 0.5f : 0.0f;
    const float g12 = g_m12 * (q12.d2 < q20.d2 ? 1.0f : t1);
    const float g20 = g_m12 * (q20.d2 < q12.d2 ? 1.0f : t1);
    edge_grad(e01, q01, px, py, x0, y0, g01, v[0], v[1], v[2], v[3]);
    edge_grad(e12, q12, px, py, x1, y1, g12, v[2], v[3], v[4], v[5]);
    edge_grad(e20, q20, px, py, x2, y2, g20, v[4], v[5], v[0], v[1]);
  }
  if (part > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) s_part[part - 1][i][j] = v[i];
  }
  __syncthreads();
  if (part > 0) return;
#pragma unroll
  for (int s = 0; s < SPLIT - 1; ++s) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += s_part[s][i][j];
  }
  // rows 0-5 take the coordinate gradients, rows 9-11 the normal's, the
  // rest zeros
#pragma unroll
  for (int row = 0; row < NCH; ++row) {
    const float val = row < 6 ? v[row] : (row >= E_NX && row <= E_NZ ? v[row - E_NX + 6] : 0.0f);
    d_entries[row * dp + e] = val;
  }
}

}  // namespace

// Launches B4a on `stream`: entries (16, dp) f32; tile_start, tile_count
// (num_tiles,) i32; one block per 128-entry slot of dp.  Writes the
// partials z_part (dp / 128, 256) f32, i_part (dp / 128, 256) i32 and s_part
// (dp / 128, 256) f32 on every slot a tile owns.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int gom_mesh_fwd_partials(const float* entries, long long dp, const int32_t* tile_start,
                                     const int32_t* tile_count, int num_tiles, int tiles_x, int ncmax, int soft,
                                     float sigma_px2, float* z_part, int32_t* i_part, float* s_part,
                                     void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0 || n_slots <= 0) return 0;
  mesh_fwd_chunk_kernel<<<n_slots, P, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, soft, sigma_px2, z_part, i_part, s_part);
  return static_cast<int>(cudaGetLastError());
}

// Launches B4b on `stream`: entries and tiles as B4a, its partials; outputs
// hard (num_tiles, 4, 256) = [normal xyz, hit] and soft (num_tiles, 1, 256)
// f32 (0 when `soft` is 0), and the residuals of B5: win (num_tiles, 256)
// i32, S (num_tiles, 256) f32, live (num_tiles,) i32; every tile written.
// Returns the CUDA error of the launch.
extern "C" int gom_mesh_fwd_merge(const float* entries, long long dp, const int32_t* tile_start,
                                  const int32_t* tile_count, int num_tiles, int ncmax, int soft, float log_sat,
                                  const float* z_part, const int32_t* i_part, const float* s_part, float* hard,
                                  float* soft_out, int32_t* win, float* s_out, int32_t* live, void* stream) {
  if (num_tiles <= 0) return 0;
  mesh_fwd_merge_kernel<<<num_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, dp, tile_start, tile_count, ncmax, soft, log_sat, z_part, i_part, s_part, hard, soft_out, win, s_out,
      live);
  return static_cast<int>(cudaGetLastError());
}

// Launches B5 on `stream`: entries and tiles as B4, the cotangents g_hard
// (num_tiles, 4, 256) (the hit row is ignored) and g_soft (num_tiles, 1,
// 256) f32, and B4's residuals win, S, live; one block per 128-entry slot
// of dp.  Writes d_entries (16, dp) on every slot a tile owns.  Returns the
// CUDA error of the launch.
extern "C" int gom_mesh_bwd(const float* entries, long long dp, const int32_t* tile_start,
                            const int32_t* tile_count, int num_tiles, int tiles_x, int ncmax, int soft,
                            float sigma_px2, const float* g_hard, const float* g_soft, const int32_t* win,
                            const float* s_in, const int32_t* live, float* d_entries, void* stream) {
  const long long n_slots = dp / CHUNK;
  if (num_tiles <= 0 || n_slots <= 0) return 0;
  mesh_bwd_kernel<<<n_slots, CHUNK * SPLIT, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, dp, tile_start, tile_count, num_tiles, tiles_x, ncmax, soft, sigma_px2, g_hard, g_soft, win, s_in,
      live, d_entries);
  return static_cast<int>(cudaGetLastError());
}
