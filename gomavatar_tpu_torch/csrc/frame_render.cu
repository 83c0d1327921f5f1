// Kernel B1 for Hopper: the fused eval-frame sweep.
//
// Replaces the TPU kernel gomavatar_tpu/ops/frame_render.py:_frame_kernel /
// _frame_tile (launched by _frame_call).  Per active 16x16 tile it walks the
// tile's depth-sorted segment of the (24, Dcap) entry table front to back
// and computes
//   * the splat blend: power from tile-local quadratic coefficients,
//     alpha = min(0.99, op * e^power), zeroed when power > 0 or
//     alpha < 1/255, weight 0 once the transmittance after the entry falls
//     below 1e-4; rgb and alpha accumulate the weights;
//   * the mesh z-buffer: barycentrics and depth from the per-face planes,
//     the valid row 18, and a strict z < best_z so that the first entry at
//     the minimum depth wins; it selects rows 19-22 (normal, shading).
// The entry layout and the semantics are those of ops/geometry.py and
// ops/frame_render.py in this package; the plain PyTorch version there is
// the reference this kernel is tested against.
//
// What bounds it on the card: arithmetic.  A 512^2 frame of the trained
// avatar sweeps ~163k (face, tile) entries, i.e. ~42M (pixel, entry) pairs
// of ~50 fp32 operations and one exp each, against ~16 MB of entries read.
// Its largest tile holds 14 chunks of 128 entries while the mean holds 6.8,
// so B1 does not run one block per tile: it is two launches, both over
// (tile, chunk) pairs, 256 threads (one per pixel) per block.
//   * The chunk plan: each active slot's chunk count, min(ceil((head +
//     count) / 128), ncmax) and at least 1, and their inclusive cumsum
//     chunk_end.  Every B1a block derives it from the slot arrays, 256
//     slots at a time (a block-wide scan; n_active is read on the device,
//     so the host never waits), until it has found its (slot, chunk) pair;
//     it returns when it has none.  Block r also stores slots [256 r,
//     256 r + 256) of the plan for B1b and zeroes B1b's tickets there; B1b
//     finds its pair by counting the slots of the stored plan that end at or
//     before it.  Neither holds the plan in shared memory, so the number of
//     active slots has no limit.  The grid is sized on the host from shapes:
//     segments are disjoint, so the pairs number at most ceil(Dcap / 128)
//     plus one per slot.  Segments are not 128-aligned: a tile sweeps from
//     its aligned-down start, keeping the reference's 64-chunk clamp counted
//     from there, so neighbouring tiles share a chunk slot and each pair has
//     its own block.
//   * B1a: the block loads its chunk once (coalesced along the entry axis)
//     and derives the TILE-LOCAL coefficients in the same step -- threads
//     0..127 the splat terms, 128..255 the mesh terms -- since
//     image-absolute coefficients would cancel to ~1e-4 (ops/geometry.py).
//     Each pixel then sweeps the chunk's lanes from T = 1 and stores its
//     local colour and alpha sums, its local transmittance T_k (or -1 where
//     the local sweep already crossed 1e-4) and its z-buffer partial (z,
//     entry index).
//   * B1b, per pair (tile, chunk k): each pixel's transmittance entering
//     chunk k is the product of the earlier chunks' T_j while every one of
//     them lets it through (not crossed, T * T_j >= 1e-4).  A pixel whose
//     stop lies in chunk k re-sweeps that chunk from T with the per-entry
//     rule (the block stages the chunk's splat terms again when some pixel
//     needs them, and packs those pixels, some 20 per chunk on the trained
//     frame, into its first threads) and stores what it took and where it
//     ended.  So each pixel re-sweeps at most one chunk, and the re-sweeps
//     of a tile run in as many blocks as it has chunks.  The block then
//     takes a ticket (atomicAdd on its slot's counter, after a
//     __threadfence); the last of the slot's blocks to finish walks the
//     slot's chunks in order: a chunk
//     that lets the pixel through adds T times its partials and T *= T_k;
//     the chunk where it stops adds the stored re-sweep; from there on the
//     pixel takes nothing.  If rounding carried a re-sweep through its
//     chunk without a stop, the pixel's T goes on and the last block
//     re-sweeps the later chunk where it stops itself.  The z-buffer merges
//     by a strict < in chunk order: the first entry at the minimum depth,
//     as in one sweep.  The last block resets its slot's ticket to 0, so
//     B1b can run again on the same partials; B1a zeroes every ticket.
//   * The scratch, 48 bytes per (pair, pixel), is allocated by the wrapper.
//     The re-sweeps are bound by latency: a chunk's ~20 stopping pixels
//     fill one warp, which walks up to 128 lanes in series (PERF.md).
//
// Transmittance is a running product T *= (1 - alpha), not the reference's
// exp of the cumulative sum of log1p(-alpha): one multiply per pair instead
// of a log1p and two exps; across chunks it is T * T_k.  e^power is the
// fast __expf (a few ulp from expf).  The two agree to float rounding; a
// pixel whose transmittance lands within rounding of 1e-4 may keep or drop
// one entry (the tolerance of the kernel tests covers this).
//
// The mesh terms use round-to-nearest intrinsics (__fmul_rn, __fadd_rn),
// which the compiler never contracts into FMAs, so barycentrics and depths
// round exactly as the plain version's separate multiplies and adds do and
// the z-buffer picks the same face on the same inputs.

#include "common.cuh"

namespace {

constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr float BIG = 1e10f;

// rows of the entry table (ops/geometry.py channel layout)
enum { E_MX = 0, E_MY, E_CA, E_CB, E_CC, E_OP, E_R, E_G, E_B,
       E_W0X, E_W0Y, E_W1X, E_W1Y, E_X2, E_Y2, E_ZX, E_ZY, E_Z2, E_MV,
       E_NX, E_NY, E_NZ, E_SH };

// tile-local per-entry coefficients held in shared memory
enum { S_QC = 0, S_QX, S_QY, S_CA, S_CB, S_CC, S_OP, S_R, S_G, S_B, NSPLAT };
enum { M_W0C = 0, M_W0X, M_W0Y, M_W1C, M_W1X, M_W1Y, M_ZC, M_ZX, M_ZY, M_MV, NMESH };

// rows of a pixel's partials: local rgb and alpha sums, local transmittance
// (-1 once crossed), the z of its chunk winner; B1b's re-sweep of the
// chunk: rgb and alpha taken, the transmittance it ended with (-1 when it
// stopped there)
enum { PART_R = 0, PART_G, PART_B, PART_A, PART_T, PART_Z, NPART };
enum { SWEEP_R = 0, SWEEP_G, SWEEP_B, SWEEP_A, SWEEP_T, NSWEEP };
constexpr float CROSSED = -1.0f;

// A slot's segment: its tile, its aligned-down start and its lane window.
struct Segment {
  int tile, astart, head, count;
};

__device__ __forceinline__ Segment segment_of(int s, const int32_t* __restrict__ active_id,
                                              const int32_t* __restrict__ seg_start,
                                              const int32_t* __restrict__ seg_count) {
  Segment g;
  g.tile = active_id[s];
  const int start = seg_start[s];
  g.astart = (start / CHUNK) * CHUNK;
  g.head = start - g.astart;
  g.count = seg_count[s];
  return g;
}

// Stage chunk k of a segment: threads 0..127 the splat terms of lane
// threadIdx.x, threads 128..255 (with the mesh pass) its mesh terms.
// Lanes outside the segment are left as they were; the sweeps never read
// them.
template <bool WITH_MESH>
__device__ __forceinline__ void stage_chunk(float (*splat)[CHUNK], float (*mesh)[CHUNK],
                                            const float* __restrict__ entries, long long dcap,
                                            const Segment& g, int k, float px0, float py0) {
  const int lane = threadIdx.x & (CHUNK - 1);
  const int pos = k * CHUNK + lane;
  if (pos < g.head || pos >= g.head + g.count) return;
  const float* e = entries + g.astart + pos;
  if (threadIdx.x < CHUNK) {
    const float mx = e[E_MX * dcap], my = e[E_MY * dcap];
    const float ca = e[E_CA * dcap], cb = e[E_CB * dcap], cc = e[E_CC * dcap];
    const float dx0 = px0 - mx, dy0 = py0 - my;
    splat[S_QC][lane] = -0.5f * (ca * dx0 * dx0 + cc * dy0 * dy0) - cb * dx0 * dy0;
    splat[S_QX][lane] = -(ca * dx0 + cb * dy0);
    splat[S_QY][lane] = -(cc * dy0 + cb * dx0);
    splat[S_CA][lane] = ca;
    splat[S_CB][lane] = cb;
    splat[S_CC][lane] = cc;
    splat[S_OP][lane] = e[E_OP * dcap];
    splat[S_R][lane] = e[E_R * dcap];
    splat[S_G][lane] = e[E_G * dcap];
    splat[S_B][lane] = e[E_B * dcap];
  } else if constexpr (WITH_MESH) {
    const float w0x = e[E_W0X * dcap], w0y = e[E_W0Y * dcap];
    const float w1x = e[E_W1X * dcap], w1y = e[E_W1Y * dcap];
    const float zx = e[E_ZX * dcap], zy = e[E_ZY * dcap];
    const float dx2 = sub(px0, e[E_X2 * dcap]), dy2 = sub(py0, e[E_Y2 * dcap]);
    mesh[M_W0C][lane] = add(mul(w0x, dx2), mul(w0y, dy2));
    mesh[M_W1C][lane] = add(mul(w1x, dx2), mul(w1y, dy2));
    mesh[M_ZC][lane] = add(add(mul(zx, dx2), mul(zy, dy2)), e[E_Z2 * dcap]);
    mesh[M_W0X][lane] = w0x;
    mesh[M_W0Y][lane] = w0y;
    mesh[M_W1X][lane] = w1x;
    mesh[M_W1Y][lane] = w1y;
    mesh[M_ZX][lane] = zx;
    mesh[M_ZY][lane] = zy;
    mesh[M_MV][lane] = e[E_MV * dcap];
  }
}

// A pixel's splat state over the lanes it sweeps.
struct Blend {
  float T, r, g, b, a;
  bool stopped;  // the transmittance after an entry fell below T_EPS
};

// The alpha of staged lane j for the pixel at tile-local (prx, pry): the
// power from the tile-local coefficients, min(0.99, op e^power), 0 where
// power > 0 or below 1/255.
__device__ __forceinline__ float alpha_at(const float (*splat)[CHUNK], int j, float prx, float pry) {
  const float power = splat[S_QC][j] + splat[S_QX][j] * prx + splat[S_QY][j] * pry
                      - 0.5f * (splat[S_CA][j] * (prx * prx) + splat[S_CC][j] * (pry * pry))
                      - splat[S_CB][j] * (prx * pry);
  const float alpha = fminf(ALPHA_MAX, splat[S_OP][j] * __expf(power));
  return power > 0.0f || alpha < ALPHA_MIN ? 0.0f : alpha;
}

// Sweep lanes [lo, hi) of a staged chunk for the pixel at tile-local
// (prx, pry), from b.T, until the transmittance is spent.
__device__ __forceinline__ void blend_lanes(const float (*splat)[CHUNK], int lo, int hi, float prx, float pry,
                                            Blend& b) {
  for (int j = lo; j < hi && !b.stopped; ++j) {
    const float alpha = alpha_at(splat, j, prx, pry);
    const float t_next = b.T * (1.0f - alpha);
    if (t_next < T_EPS) {
      b.stopped = true;
    } else {
      const float w = b.T * alpha;
      b.r += w * splat[S_R][j];
      b.g += w * splat[S_G][j];
      b.b += w * splat[S_B][j];
      b.a += w;
      b.T = t_next;
    }
  }
}

// The inclusive sum of x over the block's threads; *total gets the block's
// sum.  Every thread calls it.
__device__ __forceinline__ int block_inclusive_sum(int x, int* total) {
  __shared__ int s_warp[P / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < P / 32 ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < P / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const int out = x + (warp > 0 ? s_warp[warp - 1] : 0);
  *total = s_warp[P / 32 - 1];
  __syncthreads();  // s_warp is read before the next call writes it
  return out;
}

// Where pair b of the chunk plan lies: its slot (-1 past the plan's last
// pair) and the slot's first pair.
struct PairSlot {
  int slot, first;
};

// The chunk plan, one run of P slots at a time: chunk_end[s] is the
// inclusive cumsum of each slot's chunk count, min(ceil((head + count) /
// CHUNK), ncmax) and at least 1 below n_active, 0 above, capped at n_pairs.
// Block b stores run b of it for B1b (and zeroes that run's tickets) and
// returns where its pair b lies, the first s with chunk_end[s] > b.  It
// scans runs until it has done both, so the plan has no size limit and
// takes no shared array.  Every thread calls it.
__device__ PairSlot plan_chunks(const int32_t* __restrict__ seg_start, const int32_t* __restrict__ seg_count,
                                const int32_t* __restrict__ n_active, int active_cap, int ncmax, int n_pairs,
                                int32_t* __restrict__ chunk_end, int32_t* __restrict__ tickets) {
  __shared__ PairSlot s_found;
  const int nact = min(__ldg(n_active), active_cap);
  const int b = blockIdx.x;
  if (threadIdx.x == 0) s_found = {-1, 0};
  int before = 0;  // the pairs of the earlier runs
  for (int r = 0; r * P < active_cap; ++r) {
    const int s = r * P + threadIdx.x;
    int n = 0;
    if (s < nact) n = max(min((seg_start[s] % CHUNK + seg_count[s] + CHUNK - 1) / CHUNK, ncmax), 1);
    int total;
    const int end = before + block_inclusive_sum(n, &total);
    if (r == b && s < active_cap) {
      chunk_end[s] = min(end, n_pairs);
      tickets[s] = 0;
    }
    if (s < active_cap && end - n <= b && b < end) s_found = {s, end - n};  // one slot holds pair b
    __syncthreads();
    const PairSlot found = s_found;
    if (found.slot >= 0 && r >= b) return found;
    before += total;
  }
  return s_found;
}

// Where pair b lies in the plan B1a stored: the first s with chunk_end[s] >
// b is the count of slots whose chunks end at or before b, counted one run
// of P slots at a time until a run holds a slot that ends after b.  Every
// thread calls it.
__device__ PairSlot slot_of_pair(int b, const int32_t* __restrict__ chunk_end, int active_cap) {
  int below = 0;
  for (int r = 0; r * P < active_cap; ++r) {
    const int s = r * P + threadIdx.x;
    const int n = __syncthreads_count(s < active_cap && chunk_end[s] <= b);
    below += n;
    if (n < min(P, active_cap - r * P)) break;
  }
  if (below >= active_cap) return {-1, 0};
  return {below, below > 0 ? chunk_end[below - 1] : 0};
}

// B1a: one block per (slot, chunk) pair, one thread per pixel.
template <bool WITH_MESH>
__global__ void __launch_bounds__(P) frame_chunk_kernel(
    const float* __restrict__ entries, long long dcap,
    const int32_t* __restrict__ active_id, const int32_t* __restrict__ seg_start,
    const int32_t* __restrict__ seg_count, const int32_t* __restrict__ n_active, int active_cap, int ncmax,
    int n_pairs, int num_tiles_x, float* __restrict__ part, int32_t* __restrict__ part_idx,
    int32_t* __restrict__ chunk_end, int32_t* __restrict__ tickets) {
  const int pair = blockIdx.x;
  const PairSlot where = plan_chunks(seg_start, seg_count, n_active, active_cap, ncmax, n_pairs, chunk_end,
                                     tickets);
  const int s = where.slot;
  if (s < 0) return;
  const int k = pair - where.first;

  __shared__ float splat[NSPLAT][CHUNK];
  __shared__ float mesh[WITH_MESH ? NMESH : 1][CHUNK];
  const Segment g = segment_of(s, active_id, seg_start, seg_count);
  const float px0 = static_cast<float>((g.tile % num_tiles_x) * TILE);
  const float py0 = static_cast<float>((g.tile / num_tiles_x) * TILE);
  stage_chunk<WITH_MESH>(splat, mesh, entries, dcap, g, k, px0, py0);
  __syncthreads();

  const int p = threadIdx.x;
  const float prx = static_cast<float>(p % TILE);
  const float pry = static_cast<float>(p / TILE);
  const int lo = max(g.head - k * CHUNK, 0);
  const int hi = min(g.head + g.count - k * CHUNK, CHUNK);
  Blend b = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  blend_lanes(splat, lo, hi, prx, pry, b);
  float* out = part + static_cast<long long>(pair) * NPART * P + p;
  out[PART_R * P] = b.r;
  out[PART_G * P] = b.g;
  out[PART_B * P] = b.b;
  out[PART_A * P] = b.a;
  out[PART_T * P] = b.stopped ? CROSSED : b.T;
  if constexpr (WITH_MESH) {
    float best_z = BIG;
    int best_j = -1;
    for (int j = lo; j < hi; ++j) {
      const float w0 = add(add(mesh[M_W0C][j], mul(mesh[M_W0X][j], prx)), mul(mesh[M_W0Y][j], pry));
      const float w1 = add(add(mesh[M_W1C][j], mul(mesh[M_W1X][j], prx)), mul(mesh[M_W1Y][j], pry));
      const float z = add(add(mesh[M_ZC][j], mul(mesh[M_ZX][j], prx)), mul(mesh[M_ZY][j], pry));
      const float w2 = sub(sub(1.0f, w0), w1);
      if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && mesh[M_MV][j] > 0.0f && z < best_z) {
        best_z = z;
        best_j = j;
      }
    }
    out[PART_Z * P] = best_z;
    part_idx[static_cast<long long>(pair) * P + p] = best_j < 0 ? -1 : g.astart + k * CHUNK + best_j;
  }
}

// Whether chunk j lets a pixel with transmittance T through: not crossed on
// its own, and T * T_j >= T_EPS.
__device__ __forceinline__ bool lets_through(float T, float t_j) { return t_j != CROSSED && T * t_j >= T_EPS; }

// Add a chunk's partials (row pointer `in`), scaled by b.T, and take its
// transmittance t_j.
__device__ __forceinline__ void add_partials(Blend& b, const float* in, float t_j) {
  b.r += b.T * in[PART_R * P];
  b.g += b.T * in[PART_G * P];
  b.b += b.T * in[PART_B * P];
  b.a += b.T * in[PART_A * P];
  b.T *= t_j;
}

// Add the re-sweep another block of this launch stored (read from L2, not
// from a stale L1 line); returns whether it ended without a stop, T going
// on from it.
__device__ __forceinline__ bool add_sweep(Blend& b, const float* sw) {
  b.r += __ldcg(sw + SWEEP_R * P);
  b.g += __ldcg(sw + SWEEP_G * P);
  b.b += __ldcg(sw + SWEEP_B * P);
  b.a += __ldcg(sw + SWEEP_A * P);
  const float t_after = __ldcg(sw + SWEEP_T * P);
  b.stopped = t_after == CROSSED;
  if (!b.stopped) b.T = t_after;
  return !b.stopped;
}

// B1b: one block per (slot, chunk) pair, one thread per pixel: the re-sweep
// of the chunk where the pixel stops, then, in the last block of the slot,
// the merge of the slot's chunks in order.
template <bool WITH_MESH>
__global__ void __launch_bounds__(P) frame_merge_kernel(
    const float* __restrict__ entries, long long dcap,
    const int32_t* __restrict__ active_id, const int32_t* __restrict__ seg_start,
    const int32_t* __restrict__ seg_count, const int32_t* __restrict__ chunk_end, int active_cap,
    int num_tiles_x, const float* __restrict__ part, const int32_t* __restrict__ part_idx, float* sweep,
    int32_t* tickets, float* __restrict__ rgb_out, float* __restrict__ alpha_out, float* __restrict__ sel_out) {
  __shared__ float splat[NSPLAT][CHUNK];
  __shared__ int s_last, s_n;
  __shared__ int s_pix[P];  // the pixels that re-sweep chunk k, and their T
  __shared__ float s_t[P];
  const int pair = blockIdx.x;
  const PairSlot where = slot_of_pair(pair, chunk_end, active_cap);
  const int s = where.slot;
  if (s < 0) return;
  const int c0 = where.first;
  const int nchunks = chunk_end[s] - c0;
  const int k = pair - c0;

  const Segment g = segment_of(s, active_id, seg_start, seg_count);
  const float px0 = static_cast<float>((g.tile % num_tiles_x) * TILE);
  const float py0 = static_cast<float>((g.tile / num_tiles_x) * TILE);
  const int p = threadIdx.x;
  const float prx = static_cast<float>(p % TILE);
  const float pry = static_cast<float>(p / TILE);
  const float* t_row = part + static_cast<long long>(c0) * NPART * P + PART_T * P + p;  // T_j at t_row[j * NPART * P]

  // the transmittance entering chunk k, while every earlier chunk lets the
  // pixel through
  float T = 1.0f;
  bool alive = true;
  for (int j = 0; j < k && alive; ++j) {
    const float t_j = t_row[static_cast<long long>(j) * NPART * P];
    alive = lets_through(T, t_j);
    if (alive) T *= t_j;
  }
  const bool stops_here = alive && !lets_through(T, t_row[static_cast<long long>(k) * NPART * P]);
  // the pixels that stop in chunk k re-sweep it from T, packed into the
  // block's first threads: a chunk holds some 20 such pixels, and scattered
  // over eight warps they would leave most lanes idle
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if (stops_here) {
    const int i = atomicAdd(&s_n, 1);
    s_pix[i] = p;
    s_t[i] = T;
  }
  __syncthreads();
  const int n_sweep = s_n;
  if (n_sweep > 0) {
    stage_chunk<false>(splat, nullptr, entries, dcap, g, k, px0, py0);
    __syncthreads();
    for (int i = threadIdx.x; i < n_sweep; i += P) {
      const int q = s_pix[i];
      Blend b = {s_t[i], 0.0f, 0.0f, 0.0f, 0.0f, false};
      blend_lanes(splat, max(g.head - k * CHUNK, 0), min(g.head + g.count - k * CHUNK, CHUNK),
                  static_cast<float>(q % TILE), static_cast<float>(q / TILE), b);
      float* out = sweep + static_cast<long long>(pair) * NSWEEP * P + q;
      out[SWEEP_R * P] = b.r;
      out[SWEEP_G * P] = b.g;
      out[SWEEP_B * P] = b.b;
      out[SWEEP_A * P] = b.a;
      out[SWEEP_T * P] = b.stopped ? CROSSED : b.T;
    }
  }

  // the last block of the slot to finish merges its chunks
  __threadfence();  // this block's re-sweeps are visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(&tickets[s], 1) == nchunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[s] = 0;  // reset for the next launch

  float best_z = BIG;
  int best_i = -1;
  if constexpr (WITH_MESH) {
    for (int j = 0; j < nchunks; ++j) {
      const long long row = static_cast<long long>(c0 + j);
      const float z = part[row * NPART * P + PART_Z * P + p];
      if (z < best_z) {  // strict, in chunk order: the first entry at the minimum z
        best_z = z;
        best_i = part_idx[row * P + p];
      }
    }
  }
  // chunks that let the pixel through, then the re-sweep of the chunk where
  // it stops, which block j stored from the same T
  Blend acc = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  bool carried = false;  // a re-sweep ended without a stop: T went on from it
  bool pending = false;  // after a carry, a later chunk where it stops
  for (int j = 0; j < nchunks && !acc.stopped && !pending; ++j) {
    const long long row = static_cast<long long>(c0 + j);
    const float* in = part + row * NPART * P + p;
    const float t_j = in[PART_T * P];
    if (lets_through(acc.T, t_j)) {
      add_partials(acc, in, t_j);
    } else if (!carried) {
      carried = add_sweep(acc, sweep + row * NSWEEP * P + p);
    } else {
      pending = true;
    }
  }
  // rare: rounding carried a re-sweep through its chunk; such pixels are
  // merged again, re-sweeping here the later chunk where they stop
  if (__syncthreads_or(pending)) {
    Blend slow = {1.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
    bool slow_carried = false;
    for (int j = 0; j < nchunks; ++j) {
      const long long row = static_cast<long long>(c0 + j);
      const float* in = part + row * NPART * P + p;
      const float t_j = in[PART_T * P];
      const bool live = pending && !slow.stopped;
      const bool through = lets_through(slow.T, t_j);
      if (live && through) add_partials(slow, in, t_j);
      const bool own = live && !through && slow_carried;
      if (live && !through && !slow_carried) slow_carried = add_sweep(slow, sweep + row * NSWEEP * P + p);
      if (__syncthreads_or(own)) {
        stage_chunk<false>(splat, nullptr, entries, dcap, g, j, px0, py0);
        __syncthreads();
        if (own) blend_lanes(splat, max(g.head - j * CHUNK, 0), min(g.head + g.count - j * CHUNK, CHUNK), prx, pry, slow);
        __syncthreads();  // the chunk is consumed before the next stage
      }
    }
    if (pending) acc = slow;
  }

  rgb_out[(s * 3 + 0) * P + p] = acc.r;
  rgb_out[(s * 3 + 1) * P + p] = acc.g;
  rgb_out[(s * 3 + 2) * P + p] = acc.b;
  alpha_out[s * P + p] = acc.a;
  if constexpr (WITH_MESH) {
    const bool hit = best_z < BIG;
    sel_out[(s * 5 + 0) * P + p] = hit ? entries[E_NX * dcap + best_i] : 0.0f;
    sel_out[(s * 5 + 1) * P + p] = hit ? entries[E_NY * dcap + best_i] : 0.0f;
    sel_out[(s * 5 + 2) * P + p] = hit ? entries[E_NZ * dcap + best_i] : 0.0f;
    sel_out[(s * 5 + 3) * P + p] = hit ? entries[E_SH * dcap + best_i] : 0.0f;
    sel_out[(s * 5 + 4) * P + p] = hit ? 1.0f : 0.0f;
  }
}

}  // namespace

// Launches B1a on `stream` over n_pairs blocks.  entries: (24, dcap) f32
// row-major; active_id, seg_start, seg_count: (active_cap,) i32; n_active:
// () i32 on the device.  Writes part (n_pairs, 6,
// 256) f32 and (with the mesh pass) part_idx (n_pairs, 256) i32 for every
// pair of the chunk plan, the plan chunk_end (active_cap,) i32, and zeroes
// tickets (active_cap,) i32.  n_pairs must be at least the pairs the plan
// counts (ceil(dcap / 128) + active_cap bounds them for disjoint segments);
// it caps the plan.  Returns the CUDA error of the launch (0 on success).
extern "C" int gom_frame_partials(
    const float* entries, long long dcap,
    const int32_t* active_id, const int32_t* seg_start, const int32_t* seg_count, const int32_t* n_active,
    int active_cap, int ncmax, int n_pairs, int num_tiles_x, int with_mesh,
    float* part, int32_t* part_idx, int32_t* chunk_end, int32_t* tickets, void* stream) {
  if (active_cap <= 0 || n_pairs <= 0) return 0;
  if (n_pairs < (active_cap + P - 1) / P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_mesh) {
    frame_chunk_kernel<true><<<n_pairs, P, 0, st>>>(entries, dcap, active_id, seg_start, seg_count, n_active,
                                                    active_cap, ncmax, n_pairs, num_tiles_x, part, part_idx,
                                                    chunk_end, tickets);
  } else {
    frame_chunk_kernel<false><<<n_pairs, P, 0, st>>>(entries, dcap, active_id, seg_start, seg_count, n_active,
                                                     active_cap, ncmax, n_pairs, num_tiles_x, part, part_idx,
                                                     chunk_end, tickets);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches B1b on `stream` over n_pairs blocks: the inputs of B1a, its
// partials, plan and tickets, and the scratch sweep (n_pairs, 5, 256) f32.
// Outputs (active_cap, 3|1|5, 256) f32; slots at or above n_active are left
// unwritten.  sel is ignored when with_mesh is 0.  Returns the CUDA error of
// the launch.
extern "C" int gom_frame_merge(
    const float* entries, long long dcap,
    const int32_t* active_id, const int32_t* seg_start, const int32_t* seg_count, const int32_t* chunk_end,
    int active_cap, int n_pairs, int num_tiles_x, int with_mesh, const float* part, const int32_t* part_idx,
    float* sweep, int32_t* tickets, float* rgb, float* alpha, float* sel, void* stream) {
  if (active_cap <= 0 || n_pairs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_mesh) {
    frame_merge_kernel<true><<<n_pairs, P, 0, st>>>(entries, dcap, active_id, seg_start, seg_count, chunk_end,
                                                    active_cap, num_tiles_x, part, part_idx, sweep, tickets, rgb,
                                                    alpha, sel);
  } else {
    frame_merge_kernel<false><<<n_pairs, P, 0, st>>>(entries, dcap, active_id, seg_start, seg_count, chunk_end,
                                                     active_cap, num_tiles_x, part, part_idx, sweep, tickets, rgb,
                                                     alpha, sel);
  }
  return static_cast<int>(cudaGetLastError());
}
