// Kernel B1 for Hopper: the fused eval-frame sweep.
//
// Replaces the TPU kernel gomavatar_tpu/ops/frame_render.py:_frame_kernel /
// _frame_tile (launched by _frame_call).  Per active 16x16 tile it walks the
// tile's depth-sorted segment of the (24, Dcap) entry table front to back
// and computes, in one pass,
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
// The design therefore keeps every byte of an entry chunk in shared memory
// and every per-pixel accumulator in registers:
//   * grid: one block per slot of active_cap; a block at or above n_active
//     (read from device memory, so the host never waits) returns at once;
//   * 256 threads, one per pixel of the tile;
//   * per chunk of 128 entries the block loads the chunk once (coalesced
//     along the entry axis) and derives the TILE-LOCAL coefficients in the
//     same step -- threads 0..127 the splat terms, 128..255 the mesh terms
//     -- so no thread repeats per-entry work; image-absolute coefficients
//     would cancel to ~1e-4 (ops/geometry.py);
//   * each thread then walks the chunk's valid lanes in order.
// The walk keeps the reference's 64-chunk clamp counted from the
// aligned-down segment start, so entries past astart + 64*128 are not swept.
// While the mesh pass is on there is no block-level early exit (the
// z-buffer needs every entry); a pixel whose transmittance is spent only
// skips its own splat arithmetic.  Without the mesh pass the block stops
// once every pixel is spent.
//
// Transmittance is a running product T *= (1 - alpha), not the reference's
// exp of the cumulative sum of log1p(-alpha): one multiply per pair instead
// of a log1p and two exps.  The two agree to float rounding; a pixel whose
// transmittance lands within rounding of 1e-4 may keep or drop one entry
// (the tolerance of the kernel tests covers this).
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
enum { M_W0C = 0, M_W0X, M_W0Y, M_W1C, M_W1X, M_W1Y, M_ZC, M_ZX, M_ZY,
       M_MV, M_NX, M_NY, M_NZ, M_SH, NMESH };

template <bool WITH_MESH>
__global__ void __launch_bounds__(P) frame_kernel(
    const float* __restrict__ entries, long long dcap,
    const int32_t* __restrict__ active_id,
    const int32_t* __restrict__ seg_start,
    const int32_t* __restrict__ seg_count,
    const int32_t* __restrict__ n_active,
    int num_tiles_x, int ncmax,
    float* __restrict__ rgb_out, float* __restrict__ alpha_out,
    float* __restrict__ sel_out) {
  const int s = blockIdx.x;
  if (s >= __ldg(n_active)) return;

  __shared__ float splat[NSPLAT][CHUNK];
  __shared__ float mesh[WITH_MESH ? NMESH : 1][CHUNK];

  const int tile = active_id[s];
  const int start = seg_start[s];
  const int count = seg_count[s];
  const int astart = (start / CHUNK) * CHUNK;
  const int head = start - astart;
  const int nchunks = min((head + count + CHUNK - 1) / CHUNK, ncmax);

  const float px0 = static_cast<float>((tile % num_tiles_x) * TILE);
  const float py0 = static_cast<float>((tile / num_tiles_x) * TILE);
  const int p = threadIdx.x;
  const float prx = static_cast<float>(p % TILE);
  const float pry = static_cast<float>(p / TILE);
  const float prx2 = prx * prx, pry2 = pry * pry, prxy = prx * pry;

  float T = 1.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  bool spent = false;  // transmittance fell below T_EPS: no more splat weight
  float best_z = BIG, sel_nx = 0.0f, sel_ny = 0.0f, sel_nz = 0.0f, sel_sh = 0.0f;

  for (int k = 0; k < nchunks; ++k) {
    __syncthreads();  // the previous chunk is consumed
    const int lane = p & (CHUNK - 1);
    const int pos = k * CHUNK + lane;
    if (pos >= head && pos < head + count) {
      const float* e = entries + astart + pos;
      if (p < CHUNK) {
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
        mesh[M_NX][lane] = e[E_NX * dcap];
        mesh[M_NY][lane] = e[E_NY * dcap];
        mesh[M_NZ][lane] = e[E_NZ * dcap];
        mesh[M_SH][lane] = e[E_SH * dcap];
      }
    }
    __syncthreads();
    if constexpr (!WITH_MESH) {
      if (__syncthreads_and(spent)) break;
    }

    const int lo = max(head - k * CHUNK, 0);
    const int hi = min(head + count - k * CHUNK, CHUNK);
    for (int j = lo; j < hi; ++j) {
      if (!spent) {
        const float power = splat[S_QC][j] + splat[S_QX][j] * prx + splat[S_QY][j] * pry
                            - 0.5f * (splat[S_CA][j] * prx2 + splat[S_CC][j] * pry2)
                            - splat[S_CB][j] * prxy;
        float alpha = fminf(ALPHA_MAX, splat[S_OP][j] * expf(power));
        if (power > 0.0f || alpha < ALPHA_MIN) alpha = 0.0f;
        const float t_next = T * (1.0f - alpha);
        if (t_next < T_EPS) {
          spent = true;
        } else {
          const float w = T * alpha;
          acc_r += w * splat[S_R][j];
          acc_g += w * splat[S_G][j];
          acc_b += w * splat[S_B][j];
          acc_a += w;
          T = t_next;
        }
      }
      if constexpr (WITH_MESH) {
        const float w0 = add(add(mesh[M_W0C][j], mul(mesh[M_W0X][j], prx)), mul(mesh[M_W0Y][j], pry));
        const float w1 = add(add(mesh[M_W1C][j], mul(mesh[M_W1X][j], prx)), mul(mesh[M_W1Y][j], pry));
        const float z = add(add(mesh[M_ZC][j], mul(mesh[M_ZX][j], prx)), mul(mesh[M_ZY][j], pry));
        const float w2 = sub(sub(1.0f, w0), w1);
        if (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f && mesh[M_MV][j] > 0.0f && z < best_z) {
          best_z = z;
          sel_nx = mesh[M_NX][j];
          sel_ny = mesh[M_NY][j];
          sel_nz = mesh[M_NZ][j];
          sel_sh = mesh[M_SH][j];
        }
      }
    }
  }

  rgb_out[(s * 3 + 0) * P + p] = acc_r;
  rgb_out[(s * 3 + 1) * P + p] = acc_g;
  rgb_out[(s * 3 + 2) * P + p] = acc_b;
  alpha_out[s * P + p] = acc_a;
  if constexpr (WITH_MESH) {
    sel_out[(s * 5 + 0) * P + p] = sel_nx;
    sel_out[(s * 5 + 1) * P + p] = sel_ny;
    sel_out[(s * 5 + 2) * P + p] = sel_nz;
    sel_out[(s * 5 + 3) * P + p] = sel_sh;
    sel_out[(s * 5 + 4) * P + p] = best_z < BIG ? 1.0f : 0.0f;
  }
}

}  // namespace

// Launches B1 on `stream`.  entries: (24, dcap) f32 row-major; active_id,
// seg_start, seg_count: (active_cap,) i32; n_active: () i32 on the device.
// Outputs (active_cap, 3|1|5, 256) f32; slots at or above n_active are left
// unwritten.  sel is ignored when with_mesh is 0.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int gom_frame_render(
    const float* entries, long long dcap,
    const int32_t* active_id, const int32_t* seg_start, const int32_t* seg_count,
    const int32_t* n_active, int active_cap, int num_tiles_x, int ncmax,
    int with_mesh, float* rgb, float* alpha, float* sel, void* stream) {
  if (active_cap <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_mesh) {
    frame_kernel<true><<<active_cap, P, 0, st>>>(
        entries, dcap, active_id, seg_start, seg_count, n_active,
        num_tiles_x, ncmax, rgb, alpha, sel);
  } else {
    frame_kernel<false><<<active_cap, P, 0, st>>>(
        entries, dcap, active_id, seg_start, seg_count, n_active,
        num_tiles_x, ncmax, rgb, alpha, sel);
  }
  return static_cast<int>(cudaGetLastError());
}
