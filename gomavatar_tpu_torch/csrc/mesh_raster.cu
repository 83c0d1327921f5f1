// Kernels B4 and B5 for Hopper: the train-path mesh raster (hard normal
// z-buffer + soft silhouette) forward and its analytic backward.
//
// Replace the TPU kernels gomavatar_tpu/ops/mesh_raster_pallas.py:_fwd_kernel
// (B4) and _bwd_kernel (B5).  Entries are (16, dp) f32: x0 y0 x1 y1 x2 y2
// (pixel coordinates of the three vertices) | z0 z1 z2 | summed vertex
// normal xyz | valid (the entry's mesh flag times the face's in-front flag)
// | zero rows.  Tile t owns the 128-aligned segment
// [tile_start[t], tile_start[t] + tile_count[t]) and sweeps at most ncmax
// chunks of it in depth order.
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
// S < log_sat (-18) at a chunk's start, that chunk's soft term is skipped:
// it would change the silhouette by < e^-18 per face.
//
// Backward.  Pass A replays best_z and S (with the same skips).  Pass B:
// the normal cotangent goes to the one winning entry of each pixel, the
// first with z <= best_z (the `claimed` flag); the soft cotangent dL/dS =
// -g_soft e^S flows through the chain written out by hand (the reference
// takes jax.vjp of the same function inside its kernel):
//   d/dq log1p(-q) = -1/(1 - q), zero where the clamp q = 1 - 1e-7 holds;
//   sigmoid' = p (1 - p); d signed/d d2 = -1 inside, +1 outside;
//   the minimum over three edges -> its argmin edge, ties split evenly
//   (a tie sits at a shared vertex, where the split does not change the
//   sum); the edge projection t = clip(((p-a).(b-a)) / |b-a|^2, 0, 1),
//   its gradient passed strictly inside (0, 1) and halved at a bound.
// A skipped chunk gets zero soft gradient: the exact gradient of the
// truncated sum the forward computed.  Nothing flows through the hard mask
// or through z.  `ops/mesh_raster_pallas.py:soft_log1m_grad` is the same
// chain in plain PyTorch, held to the reference's autodiff by the tests.
//
// What bounds them on the card: arithmetic.  The soft term costs ~60 fp32
// operations, an exp and a log per (pixel, entry) pair in B4 and ~150 with
// the chain in B5; entries are ~16 B x 16 rows each.  Design: one block per
// tile, 256 threads (one per pixel), every per-pixel carry in registers,
// each chunk staged once in shared memory; B5's per-entry gradients are
// block reductions (warp shuffles, one partial per warp in shared memory,
// one plain store per (row, entry)), with no atomics since every entry
// belongs to one tile; B5 writes all 16 rows of every slot its tile owns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int NWARP = P / 32;
constexpr int NCH = 16;
constexpr int NSTAGE = 13;  // rows read by the kernels: coords, z, normal, valid
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e10f;
constexpr float ONE_MINUS = 1.0f - 1e-7f;

enum { E_X0 = 0, E_Y0, E_X1, E_Y1, E_X2, E_Y2, E_Z0, E_Z1, E_Z2, E_NX, E_NY, E_NZ, E_VALID };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Hard {
  bool inside;  // barycentric coverage (used by the soft sign too)
  bool ok;      // covered, valid, non-degenerate
  float z;
};

// The plain version's arithmetic, operation for operation.
__device__ __forceinline__ Hard hard_at(const float (*sh)[CHUNK], int j, float px, float py) {
  const float x0 = sh[E_X0][j], y0 = sh[E_Y0][j], x1 = sh[E_X1][j], y1 = sh[E_Y1][j];
  const float x2 = sh[E_X2][j], y2 = sh[E_Y2][j];
  const float denom = add(mul(sub(y1, y2), sub(x0, x2)), mul(sub(x2, x1), sub(y0, y2)));
  const bool degenerate = fabsf(denom) < 1e-12f;
  const float ds = degenerate ? 1.0f : denom;
  const float w0 = __fdiv_rn(add(mul(sub(y1, y2), sub(px, x2)), mul(sub(x2, x1), sub(py, y2))), ds);
  const float w1 = __fdiv_rn(add(mul(sub(y2, y0), sub(px, x2)), mul(sub(x0, x2), sub(py, y2))), ds);
  const float w2 = sub(sub(1.0f, w0), w1);
  Hard h;
  h.inside = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f;
  h.ok = h.inside && sh[E_VALID][j] > 0.0f && !degenerate;
  h.z = add(add(mul(w0, sh[E_Z0][j]), mul(w1, sh[E_Z1][j])), mul(w2, sh[E_Z2][j]));
  return h;
}

struct Edge {
  float abx, aby, d2ab, inv, num, t, tc, dx, dy, d2;
};

__device__ __forceinline__ Edge edge_at(float px, float py, float ax, float ay, float bx, float by) {
  Edge e;
  e.abx = bx - ax;
  e.aby = by - ay;
  e.d2ab = e.abx * e.abx + e.aby * e.aby;
  e.inv = 1.0f / fmaxf(e.d2ab, 1e-12f);
  e.num = (px - ax) * e.abx + (py - ay) * e.aby;
  e.t = e.num * e.inv;
  e.tc = fminf(fmaxf(e.t, 0.0f), 1.0f);
  e.dx = px - (ax + e.tc * e.abx);
  e.dy = py - (ay + e.tc * e.aby);
  e.d2 = e.dx * e.dx + e.dy * e.dy;
  return e;
}

// d(edge d2)/d(a, b) times g_d, added into ga/gb (x, y).
__device__ __forceinline__ void edge_grad(const Edge& e, float px, float py, float ax, float ay, float g_d,
                                          float& gax, float& gay, float& gbx, float& gby) {
  const float gdx = 2.0f * e.dx * g_d, gdy = 2.0f * e.dy * g_d;
  const float g_tc = -(gdx * e.abx + gdy * e.aby);
  const float pass_t = (e.t > 0.0f && e.t < 1.0f) ? 1.0f : ((e.t == 0.0f || e.t == 1.0f) ? 0.5f : 0.0f);
  const float g_t = g_tc * pass_t;
  const float g_num = g_t * e.inv;
  const float g_d2ab = e.d2ab > 1e-12f ? -g_t * e.num * e.inv * e.inv : 0.0f;
  gax += gdx * (e.tc - 1.0f) + g_num * (-e.abx - (px - ax)) - 2.0f * e.abx * g_d2ab;
  gbx += -gdx * e.tc + g_num * (px - ax) + 2.0f * e.abx * g_d2ab;
  gay += gdy * (e.tc - 1.0f) + g_num * (-e.aby - (py - ay)) - 2.0f * e.aby * g_d2ab;
  gby += -gdy * e.tc + g_num * (py - ay) + 2.0f * e.aby * g_d2ab;
}

struct Soft {
  Edge e01, e12, e20;
  float m12, d2, prob, log1m;
};

__device__ __forceinline__ Soft soft_at(const float (*sh)[CHUNK], int j, float px, float py, bool inside,
                                        float sigma_px2) {
  const float x0 = sh[E_X0][j], y0 = sh[E_Y0][j], x1 = sh[E_X1][j], y1 = sh[E_Y1][j];
  const float x2 = sh[E_X2][j], y2 = sh[E_Y2][j];
  Soft s;
  s.e01 = edge_at(px, py, x0, y0, x1, y1);
  s.e12 = edge_at(px, py, x1, y1, x2, y2);
  s.e20 = edge_at(px, py, x2, y2, x0, y0);
  s.m12 = fminf(s.e12.d2, s.e20.d2);
  s.d2 = fminf(s.e01.d2, s.m12);
  const float signed_d2 = inside ? -s.d2 : s.d2;
  s.prob = 1.0f / (1.0f + expf(signed_d2 / sigma_px2));  // sigmoid(-signed / s2)
  s.log1m = log1pf(-fminf(s.prob, ONE_MINUS));
  return s;
}

__device__ __forceinline__ void stage_chunk(float (*sh)[CHUNK], const float* __restrict__ entries, long long dp,
                                            long long base) {
  for (int i = threadIdx.x; i < NSTAGE * CHUNK; i += P) {
    const int r = i / CHUNK, l = i % CHUNK;
    sh[r][l] = entries[r * dp + base + l];
  }
}

__global__ void __launch_bounds__(P) mesh_fwd_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int tiles_x, int ncmax, int soft, float sigma_px2, float log_sat,
    float* __restrict__ hard_out, float* __restrict__ soft_out) {
  __shared__ float sh[NSTAGE][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const long long start = tile_start[t];
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);

  float best_z = BIG, nx = 0.0f, ny = 0.0f, nz = 0.0f, log_om = 0.0f;
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // the previous chunk is consumed
    stage_chunk(sh, entries, dp, start + static_cast<long long>(k) * CHUNK);
    // the barrier also decides, for the whole tile, whether the soft term
    // of this chunk is live
    const bool do_soft = __syncthreads_or(soft && log_om > log_sat);
    for (int j = 0; j < CHUNK; ++j) {
      const Hard h = hard_at(sh, j, px, py);
      if (h.ok && h.z < best_z) {
        best_z = h.z;
        nx = sh[E_NX][j];
        ny = sh[E_NY][j];
        nz = sh[E_NZ][j];
      }
      if (do_soft && sh[E_VALID][j] > 0.0f) log_om += soft_at(sh, j, px, py, h.inside, sigma_px2).log1m;
    }
  }
  const long long o = static_cast<long long>(t) * 4 * P + p;
  const bool hit = best_z < BIG;
  hard_out[o] = hit ? nx : 0.0f;
  hard_out[o + P] = hit ? ny : 0.0f;
  hard_out[o + 2 * P] = hit ? nz : 0.0f;
  hard_out[o + 3 * P] = hit ? 1.0f : 0.0f;
  soft_out[static_cast<long long>(t) * P + p] = soft ? 1.0f - expf(log_om) : 0.0f;
}

__global__ void __launch_bounds__(P) mesh_bwd_kernel(
    const float* __restrict__ entries, long long dp,
    const int32_t* __restrict__ tile_start, const int32_t* __restrict__ tile_count,
    int tiles_x, int ncmax, int soft, float sigma_px2, float log_sat,
    const float* __restrict__ g_hard, const float* __restrict__ g_soft,
    float* __restrict__ d_entries) {
  constexpr int NV = 9;  // gradient values: 6 coordinates, 3 normal
  __shared__ float sh[NSTAGE][CHUNK];
  __shared__ float red[NWARP][NV][CHUNK];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32, lane = p % 32;
  const long long start = tile_start[t];
  const int nchunks = min(tile_count[t] / CHUNK, ncmax);
  const float px = static_cast<float>((t % tiles_x) * TILE + p % TILE);
  const float py = static_cast<float>((t / tiles_x) * TILE + p / TILE);
  const long long o = static_cast<long long>(t) * 4 * P + p;
  const float gnx = g_hard[o], gny = g_hard[o + P], gnz = g_hard[o + 2 * P];

  // ---- pass A: best z and S, with the forward's skips
  float best_z = BIG, log_om = 0.0f;
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();
    stage_chunk(sh, entries, dp, start + static_cast<long long>(k) * CHUNK);
    const bool do_soft = __syncthreads_or(soft && log_om > log_sat);
    for (int j = 0; j < CHUNK; ++j) {
      const Hard h = hard_at(sh, j, px, py);
      if (h.ok) best_z = fminf(best_z, h.z);
      if (do_soft && sh[E_VALID][j] > 0.0f) log_om += soft_at(sh, j, px, py, h.inside, sigma_px2).log1m;
    }
  }
  // soft = 1 - e^S, so dL/dS = -g_soft e^S
  const float dl_ds = soft ? -g_soft[static_cast<long long>(t) * P + p] * expf(log_om) : 0.0f;

  // ---- pass B: per-entry gradients
  bool claimed = false;
  float log_om_b = 0.0f;
  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // the previous chunk's reductions are stored
    stage_chunk(sh, entries, dp, start + static_cast<long long>(k) * CHUNK);
    const bool do_soft = __syncthreads_or(soft && log_om_b > log_sat);
    for (int j = 0; j < CHUNK; ++j) {
      float v[NV];
#pragma unroll
      for (int r = 0; r < NV; ++r) v[r] = 0.0f;
      bool nonzero = false;
      const Hard h = hard_at(sh, j, px, py);
      if (!claimed && best_z < BIG && h.ok && h.z <= best_z) {
        claimed = true;
        v[6] = gnx;
        v[7] = gny;
        v[8] = gnz;
        nonzero = true;
      }
      if (do_soft && sh[E_VALID][j] > 0.0f) {
        const Soft s = soft_at(sh, j, px, py, h.inside, sigma_px2);
        log_om_b += s.log1m;
        const float q = fminf(s.prob, ONE_MINUS);
        const float g_q = -dl_ds / (1.0f - q);
        const float g_prob = s.prob < ONE_MINUS ? g_q : (s.prob == ONE_MINUS ? 0.5f * g_q : 0.0f);
        const float g_signed = -(g_prob * s.prob * (1.0f - s.prob)) / sigma_px2;
        const float g_d2 = h.inside ? -g_signed : g_signed;
        // the argmin edge of min(d01, min(d12, d20)), ties split evenly
        const float t0 = s.e01.d2 == s.m12 ? 0.5f : 0.0f;
        const float g01 = g_d2 * (s.e01.d2 < s.m12 ? 1.0f : t0);
        const float g_m12 = g_d2 * (s.m12 < s.e01.d2 ? 1.0f : t0);
        const float t1 = s.e12.d2 == s.e20.d2 ? 0.5f : 0.0f;
        const float g12 = g_m12 * (s.e12.d2 < s.e20.d2 ? 1.0f : t1);
        const float g20 = g_m12 * (s.e20.d2 < s.e12.d2 ? 1.0f : t1);
        const float x0 = sh[E_X0][j], y0 = sh[E_Y0][j], x1 = sh[E_X1][j], y1 = sh[E_Y1][j];
        const float x2 = sh[E_X2][j], y2 = sh[E_Y2][j];
        edge_grad(s.e01, px, py, x0, y0, g01, v[0], v[1], v[2], v[3]);
        edge_grad(s.e12, px, py, x1, y1, g12, v[2], v[3], v[4], v[5]);
        edge_grad(s.e20, px, py, x2, y2, g20, v[4], v[5], v[0], v[1]);
        nonzero = nonzero || g_d2 != 0.0f;
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
    for (int i = p; i < NCH * CHUNK; i += P) {
      const int r = i / CHUNK, j = i % CHUNK;
      // rows 0-5 take the coordinate gradients, rows 9-11 the normal's
      const int src = r < 6 ? r : (r >= E_NX && r <= E_NZ ? r - E_NX + 6 : -1);
      float sum = 0.0f;
      if (src >= 0) {
#pragma unroll
        for (int w = 0; w < NWARP; ++w) sum += red[w][src][j];
      }
      out[r * dp + j] = sum;
    }
  }
}

}  // namespace

// Launches B4 on `stream`: entries (16, dp) f32; tile_start, tile_count
// (num_tiles,) i32; outputs hard (num_tiles, 4, 256) = [normal xyz, hit] and
// soft (num_tiles, 1, 256) f32, every tile written (soft is 0 when `soft` is
// 0).  Returns the CUDA error of the launch (0 on success).
extern "C" int gom_mesh_fwd(const float* entries, long long dp, const int32_t* tile_start,
                            const int32_t* tile_count, int num_tiles, int tiles_x, int ncmax, int soft,
                            float sigma_px2, float log_sat, float* hard, float* soft_out, void* stream) {
  if (num_tiles <= 0) return 0;
  mesh_fwd_kernel<<<num_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, dp, tile_start, tile_count, tiles_x, ncmax, soft, sigma_px2, log_sat, hard, soft_out);
  return static_cast<int>(cudaGetLastError());
}

// Launches B5 on `stream`: as B4, plus the cotangents g_hard
// (num_tiles, 4, 256) (the hit row is ignored) and g_soft (num_tiles, 1, 256)
// f32; writes d_entries (16, dp) on every slot a tile owns.  Returns the
// CUDA error of the launch.
extern "C" int gom_mesh_bwd(const float* entries, long long dp, const int32_t* tile_start,
                            const int32_t* tile_count, int num_tiles, int tiles_x, int ncmax, int soft,
                            float sigma_px2, float log_sat, const float* g_hard, const float* g_soft,
                            float* d_entries, void* stream) {
  if (num_tiles <= 0) return 0;
  mesh_bwd_kernel<<<num_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      entries, dp, tile_start, tile_count, tiles_x, ncmax, soft, sigma_px2, log_sat, g_hard, g_soft, d_entries);
  return static_cast<int>(cudaGetLastError());
}
