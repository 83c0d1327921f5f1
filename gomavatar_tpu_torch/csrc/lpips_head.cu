// LPIPS's distance head on the card, after the trunk's taps: for each tap k
// with the prediction's features fp and the target's fg ((1, C, h, w),
// NCHW or channels-last (NHWC) contiguous, bfloat16 or float32, straight out
// of the ReLU) and the
// head's weights w (C float32, clamped at 0 here),
//
//   rp = rsqrt(sum_c fp^2 + 1e-20), rg likewise         (per pixel, float32)
//   d  = sum_c max(w_c, 0) (fp_c rp - fg_c rg)^2         (a difference, squared)
//   total = sum over k = 0.. of mean_pixels(d)           (taps added in order)
//
// and its gradient in fp, with g the upstream scalar read from the card:
//
//   g_c = 2 max(w_c, 0) (fp_c rp - fg_c rg) g / (h w),   S = sum_c g_c fp_c,
//   d total / d fp_c = rp g_c - rp^3 fp_c S              (rounded once to the tap's type)
//
// The plain version, the function this must match, is
// gomavatar_tpu_torch/models/lpips.py:lpips_head_plain.  The difference is
// squared, never expanded (A rp^2 + B rg^2 - 2 X rp rg cancels where pred is
// close to gt).  An all-zero feature vector (a flat post-ReLU region) gives
// rp = 1e10 and a finite product, as autograd does; the ReLU's backward
// then zeroes its gradient.
//
// Replaces no TPU kernel: the JAX package (gomavatar_tpu/models/lpips.py:
// lpips) leaves this head to XLA, which fuses it into a few fusions, while
// PyTorch runs it eagerly as ~180 launches moving ~6 GB a train step.  It is
// bound by bytes: the forward reads every tap element of both images once
// (4 B an element in bfloat16), the backward reads both again and writes
// the prediction's gradient (6 B an element); ~0.1 ms a 512^2 step at
// 3.35 TB/s.
//
// Design.  One forward launch covers every tap: the grid walks a table of
// per-tap entries, and a block owns `tile` consecutive pixels of one tap
// (a power of two from 8 to 256, as large as fits both images' tiles in 48 KB
// of shared memory: 128 pixels at C = 64 in bfloat16, 16 at C = 512).  It
// copies the tile of both images into shared memory with `vec`-byte loads,
// so the second sweep over the channels never reads device memory again.
// An NCHW tap's tile is C channel rows of `tile` pixels, loaded along the
// pixel axis (16 B where the rows allow it: h w a multiple of 8 in bfloat16;
// narrower for 34^2 = 1,156 pixels, 8 B, or odd sizes, 2 B).  A
// channels-last tap's tile is one contiguous run of tile x C elements, loaded
// 16 B at a time whatever h w (C x 2 B is a multiple of 16 for every VGG and
// AlexNet tap), and kept in shared memory as pixel rows R = C + 4 / (bytes an
// element) apart: an odd number of 4-byte words, so the sweeps' reads down a
// channel, a lane a pixel, fall in 32 banks; each lane writes the words of its
// load in an order turned by its lane and address, so the stores do too.  The
// sweeps read either layout through its two strides, in the same order, so
// both give the same bits.  Thread (p, g) of the block sums the channels
// c = g (mod 256 / tile) at pixel p; the groups' sums meet in shared memory
// in a fixed order.  The forward keeps rp and rg per pixel for the backward
// and writes one partial sum a block; a second launch of one block adds
// them per tap and the taps in order, with no float atomics, so a replayed
// graph gives the same bits every run.  The backward is one launch over the
// same tiling: S as the forward's sums, then the gradient written over the
// tile of fp in shared memory and stored with the same vector width.
// Launched on the caller's stream; no allocation, no synchronisation.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TAPS = 8;
constexpr int SMEM_MAX = 48 * 1024;
constexpr float EPS = 1e-20f;

struct Tap {
  const void* fp;
  const void* fg;
  const float* head;
  void* grad;
  int C, P, tile, vec;  // channels, pixels, pixels a block, bytes a load
  int nhwc;             // 1: channels-last (each pixel's C channels contiguous); 0: NCHW
  int block0;           // the tap's first block
  long long r0;         // the tap's first pixel in rp (and in rg)
};

struct Taps {
  Tap t[MAX_TAPS];
  int n, blocks;
  long long pixels;  // every tap's pixels: rp at r[0, pixels), rg at r[pixels, 2 pixels)
};

// the elements of one image's tile in shared memory: C rows of `tile`
// pixels (NCHW), or `tile` pixel rows of C + 4 / elem (channels-last)
__host__ __device__ __forceinline__ int tile_elems(const Tap& tap, int elem) {
  return tap.nhwc ? tap.tile * (tap.C + 4 / elem) : tap.C * tap.tile;
}

// the shared memory of a block of `tap`: both images' tiles, the clamped
// head, the groups' sums
int smem_bytes(const Tap& tap, int elem) {
  return 2 * tile_elems(tap, elem) * elem + 4 * tap.C + 8 * THREADS;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

// rows [0, C) x pixels [p0, p0 + tile) of the (C, P) array `src` into the
// (C, tile) tile `dst`, VB bytes a load; pixels past P read as 0
template <int VB, typename T>
__device__ __forceinline__ void rows_in(const T* __restrict__ src, T* dst, int C, int P, int p0, int tile) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int per_row = tile / E, n = C * per_row;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int c = i / per_row, j = (i - c * per_row) * E;
    V v{};
    if (p0 + j < P) v = *reinterpret_cast<const V*>(src + static_cast<long long>(c) * P + p0 + j);
    *reinterpret_cast<V*>(dst + c * tile + j) = v;
  }
}

// the tile `src` back into rows [0, C) x pixels [p0, min(p0 + tile, P)) of `dst`
template <int VB, typename T>
__device__ __forceinline__ void rows_out(const T* src, T* __restrict__ dst, int C, int P, int p0, int tile) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int per_row = tile / E, n = C * per_row;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int c = i / per_row, j = (i - c * per_row) * E;
    if (p0 + j < P)
      *reinterpret_cast<V*>(dst + static_cast<long long>(c) * P + p0 + j) = *reinterpret_cast<const V*>(src + c * tile + j);
  }
}

__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ unsigned word(const uint2& v, int j) { return j == 0 ? v.x : v.y; }
__device__ __forceinline__ void set_word(uint4& v, int j, unsigned x) {
  v.x = j == 0 ? x : v.x;
  v.y = j == 1 ? x : v.y;
  v.z = j == 2 ? x : v.z;
  v.w = j == 3 ? x : v.w;
}
__device__ __forceinline__ void set_word(uint2& v, int j, unsigned x) {
  v.x = j == 0 ? x : v.x;
  v.y = j == 1 ? x : v.y;
}

// Where a lane starts in the words of its vector at shared address `at`
// (4-byte aligned): in round s it moves word (s + lane / 8 - at / 4) mod the
// words, so in each round the warp's 32 lanes meet 32 banks.
__device__ __forceinline__ int first_word(const void* at) {
  const int a = static_cast<int>(__cvta_generic_to_shared(at) >> 2);
  return ((threadIdx.x & 31) >> 3) - a;
}

// v into shared memory at `dst` (VB >= 4: 4-byte aligned), a word a store
template <int VB>
__device__ __forceinline__ void put(void* dst, const typename Vec<VB>::type& v) {
  if constexpr (VB <= 4) {
    *static_cast<typename Vec<VB>::type*>(dst) = v;
  } else {
    constexpr int W = VB / 4;
    unsigned* d = static_cast<unsigned*>(dst);
    const int r = first_word(dst);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const int j = (s + r) & (W - 1);
      d[j] = word(v, j);
    }
  }
}

// the VB-byte vector at `src` in shared memory, read as `put` wrote it
template <int VB>
__device__ __forceinline__ typename Vec<VB>::type take(const void* src) {
  typename Vec<VB>::type v{};
  if constexpr (VB <= 4) {
    v = *static_cast<const typename Vec<VB>::type*>(src);
  } else {
    constexpr int W = VB / 4;
    const unsigned* d = static_cast<const unsigned*>(src);
    const int r = first_word(src);
#pragma unroll
    for (int s = 0; s < W; ++s) {
      const int j = (s + r) & (W - 1);
      set_word(v, j, d[j]);
    }
  }
  return v;
}

// pixels [p0, p0 + tile) x channels [0, C) of the channels-last (P, C) array
// `src`, one contiguous run, into the tile `dst` of pixel rows R apart, VB
// bytes a load; pixels past P read as 0
template <int VB, typename T>
__device__ __forceinline__ void pixels_in(const T* __restrict__ src, T* dst, int C, int R, int P, int p0, int tile) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int per_px = C / E, n = tile * per_px;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int q = i / per_px, c = (i - q * per_px) * E;
    V v{};
    if (p0 + q < P) v = *reinterpret_cast<const V*>(src + (static_cast<long long>(p0) + q) * C + c);
    put<VB>(dst + q * R + c, v);
  }
}

// the tile `src` back into pixels [p0, min(p0 + tile, P)) of the
// channels-last `dst`
template <int VB, typename T>
__device__ __forceinline__ void pixels_out(const T* src, T* __restrict__ dst, int C, int R, int P, int p0, int tile) {
  using V = typename Vec<VB>::type;
  constexpr int E = VB / static_cast<int>(sizeof(T));
  const int per_px = C / E, n = tile * per_px;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int q = i / per_px, c = (i - q * per_px) * E;
    if (p0 + q < P)
      *reinterpret_cast<V*>(dst + (static_cast<long long>(p0) + q) * C + c) = take<VB>(src + q * R + c);
  }
}

template <typename T>
__device__ __forceinline__ void tile_in(const T* src, T* dst, const Tap& tap, int p0) {
  if (tap.nhwc) {
    const int R = tap.C + 4 / static_cast<int>(sizeof(T));
    switch (tap.vec) {
      case 16: pixels_in<16>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      case 8: pixels_in<8>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      case 4: pixels_in<4>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      default:
        if constexpr (sizeof(T) == 2) pixels_in<2>(src, dst, tap.C, R, tap.P, p0, tap.tile);
    }
    return;
  }
  switch (tap.vec) {
    case 16: rows_in<16>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    case 8: rows_in<8>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    case 4: rows_in<4>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    default:
      if constexpr (sizeof(T) == 2) rows_in<2>(src, dst, tap.C, tap.P, p0, tap.tile);
  }
}

template <typename T>
__device__ __forceinline__ void tile_out(const T* src, T* dst, const Tap& tap, int p0) {
  if (tap.nhwc) {
    const int R = tap.C + 4 / static_cast<int>(sizeof(T));
    switch (tap.vec) {
      case 16: pixels_out<16>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      case 8: pixels_out<8>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      case 4: pixels_out<4>(src, dst, tap.C, R, tap.P, p0, tap.tile); break;
      default:
        if constexpr (sizeof(T) == 2) pixels_out<2>(src, dst, tap.C, R, tap.P, p0, tap.tile);
    }
    return;
  }
  switch (tap.vec) {
    case 16: rows_out<16>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    case 8: rows_out<8>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    case 4: rows_out<4>(src, dst, tap.C, tap.P, p0, tap.tile); break;
    default:
      if constexpr (sizeof(T) == 2) rows_out<2>(src, dst, tap.C, tap.P, p0, tap.tile);
  }
}

// the block's sum of `v`, in a fixed order, valid in thread 0; every thread
// calls it
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // scratch may still be read
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < WARPS; ++i) s += scratch[i];
  return s;
}

__device__ __forceinline__ int tap_of(const Taps& taps) {
  int k = 0;
  while (k + 1 < taps.n && static_cast<int>(blockIdx.x) >= taps.t[k + 1].block0) ++k;
  return k;
}

// A block's view of its tile: its tap, first pixel, both images' tiles in
// shared memory, the clamped head, the groups' scratch, its thread's pixel p
// and channel group g of G, and the tile's strides: element (c, p) at
// c cs + p ps (NCHW: cs = tile, ps = 1; channels-last: cs = 1, ps = R).
template <typename T>
struct Block {
  Tap tap;
  int p0, p, g, G, cs, ps;
  T *sp, *sg;
  float *w, *red;

  __device__ __forceinline__ Block(const Taps& taps, unsigned char* smem) {
    tap = taps.t[tap_of(taps)];
    p0 = (static_cast<int>(blockIdx.x) - tap.block0) * tap.tile;
    const int n = tile_elems(tap, static_cast<int>(sizeof(T)));
    cs = tap.nhwc ? 1 : tap.tile;
    ps = tap.nhwc ? tap.C + 4 / static_cast<int>(sizeof(T)) : 1;
    sp = reinterpret_cast<T*>(smem);
    sg = sp + n;
    w = reinterpret_cast<float*>(sg + n);
    red = w + tap.C;
    p = threadIdx.x % tap.tile;
    g = threadIdx.x / tap.tile;
    G = THREADS / tap.tile;
    tile_in(static_cast<const T*>(tap.fp), sp, tap, p0);
    tile_in(static_cast<const T*>(tap.fg), sg, tap, p0);
    for (int c = threadIdx.x; c < tap.C; c += THREADS) w[c] = fmaxf(tap.head[c], 0.f);
    __syncthreads();
  }

  __device__ __forceinline__ int at(int c) const { return c * cs + p * ps; }
  __device__ __forceinline__ float x(int c) const { return to_f(sp[at(c)]); }
  __device__ __forceinline__ float y(int c) const { return to_f(sg[at(c)]); }

  // the sum over every group of each thread's `a` at this thread's pixel,
  // in group order (red[j THREADS ...] for j = 0, 1)
  __device__ __forceinline__ float gather(int j) const {
    float s = 0.f;
    for (int k = 0; k < G; ++k) s += red[j * THREADS + k * tap.tile + p];
    return s;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) lpips_head_fwd_kernel(const Taps taps, float* __restrict__ r,
                                                                 float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block<T> b(taps, smem);
  const int C = b.tap.C;
  float a = 0.f, q = 0.f;
  for (int c = b.g; c < C; c += b.G) {
    const float x = b.x(c), y = b.y(c);
    a = fmaf(x, x, a);
    q = fmaf(y, y, q);
  }
  b.red[threadIdx.x] = a;
  b.red[THREADS + threadIdx.x] = q;
  __syncthreads();
  const float rp = rsqrtf(b.gather(0) + EPS), rg = rsqrtf(b.gather(1) + EPS);
  float s = 0.f;
  for (int c = b.g; c < C; c += b.G) {
    const float e = b.x(c) * rp - b.y(c) * rg;
    s = fmaf(b.w[c] * e, e, s);
  }
  const int pix = b.p0 + b.p;
  if (b.g == 0 && pix < b.tap.P) {
    r[b.tap.r0 + pix] = rp;
    r[taps.pixels + b.tap.r0 + pix] = rg;
  }
  s = block_sum(s, b.red);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS) lpips_head_reduce_kernel(const Taps taps, const float* __restrict__ partial,
                                                                    float* __restrict__ out) {
  __shared__ float scratch[WARPS];
  float total = 0.f;
  for (int k = 0; k < taps.n; ++k) {
    const int b1 = k + 1 < taps.n ? taps.t[k + 1].block0 : taps.blocks;
    float s = 0.f;
    for (int i = taps.t[k].block0 + static_cast<int>(threadIdx.x); i < b1; i += THREADS) s += partial[i];
    s = block_sum(s, scratch);
    if (threadIdx.x == 0) total += s / static_cast<float>(taps.t[k].P);
  }
  if (threadIdx.x == 0) out[0] = total;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) lpips_head_bwd_kernel(const Taps taps, const float* __restrict__ r,
                                                                 const float* __restrict__ gout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block<T> b(taps, smem);
  const int C = b.tap.C, pix = b.p0 + b.p;
  const float coef = 2.f * gout[0] / static_cast<float>(b.tap.P);
  float rp = 0.f, rg = 0.f;  // pixels past P: x = y = 0, nothing stored
  if (pix < b.tap.P) {
    rp = r[b.tap.r0 + pix];
    rg = r[taps.pixels + b.tap.r0 + pix];
  }
  float s = 0.f;
  for (int c = b.g; c < C; c += b.G) {
    const float x = b.x(c);
    const float gc = b.w[c] * (x * rp - b.y(c) * rg) * coef;
    s = fmaf(gc, x, s);
  }
  b.red[threadIdx.x] = s;
  __syncthreads();
  const float S = b.gather(0), r3 = rp * rp * rp;
  for (int c = b.g; c < C; c += b.G) {
    const float x = b.x(c);
    const float gc = b.w[c] * (x * rp - b.y(c) * rg) * coef;
    b.sp[b.at(c)] = from_f<T>(rp * gc - r3 * x * S);  // the thread's own element of the tile
  }
  __syncthreads();
  tile_out(b.sp, static_cast<T*>(b.tap.grad), b.tap, b.p0);
}

// The per-tap table from the host's arrays; returns a CUDA error code.
int make_taps(int n, int elem, const void* const* fp, const void* const* fg, const void* const* head,
              void* const* grad, const int* C, const int* P, const int* tile, const int* vec, const int* nhwc,
              Taps* taps, int* smem) {
  if (n < 1 || n > MAX_TAPS || (elem != 2 && elem != 4)) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = 0, pixels = 0;
  *smem = 0;
  for (int k = 0; k < n; ++k) {
    Tap& t = taps->t[k];
    t = Tap{fp[k], fg[k], static_cast<const float*>(head[k]), grad ? grad[k] : nullptr, C[k], P[k], tile[k], vec[k],
            nhwc[k] != 0, static_cast<int>(blocks), pixels};
    // a load runs along a channel's pixels (NCHW) or a pixel's channels
    const long long run = static_cast<long long>(t.nhwc ? t.C : t.P) * elem;
    const bool pow2 = t.tile >= 8 && t.tile <= THREADS && (t.tile & (t.tile - 1)) == 0;
    const bool vec_ok = (t.vec == 2 || t.vec == 4 || t.vec == 8 || t.vec == 16) && t.vec >= elem && run % t.vec == 0;
    if (t.C < 1 || t.P < 1 || !pow2 || !vec_ok || smem_bytes(t, elem) > SMEM_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    *smem = smem_bytes(t, elem) > *smem ? smem_bytes(t, elem) : *smem;
    blocks += (t.P + t.tile - 1) / t.tile;
    pixels += t.P;
  }
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  taps->n = n;
  taps->blocks = static_cast<int>(blocks);
  taps->pixels = pixels;
  return 0;
}

}  // namespace

// The forward on `stream`: n taps (fp[k], fg[k] the two images' (1, C[k],
// P[k]) features of `elem`-byte floats, 2 bfloat16 or 4 float32, NCHW or,
// where nhwc[k], channels-last; head[k] C[k] float32), tile[k] pixels a
// block and vec[k] bytes a load.  Writes
// r (2 x the taps' pixels: rp then rg, float32), partial (one float32 a
// block: sum over k of ceil(P[k] / tile[k])) and out (the total, one
// float32).  Returns the CUDA error of the launches.
extern "C" int gom_lpips_head_fwd(float* r, float* partial, float* out, int n, int elem, const void* const* fp,
                                  const void* const* fg, const void* const* head, const int* C, const int* P,
                                  const int* tile, const int* vec, const int* nhwc, void* stream) {
  Taps taps;
  int smem = 0;
  const int err = make_taps(n, elem, fp, fg, head, nullptr, C, P, tile, vec, nhwc, &taps, &smem);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 2)
    lpips_head_fwd_kernel<__nv_bfloat16><<<taps.blocks, THREADS, smem, s>>>(taps, r, partial);
  else
    lpips_head_fwd_kernel<float><<<taps.blocks, THREADS, smem, s>>>(taps, r, partial);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  lpips_head_reduce_kernel<<<1, THREADS, 0, s>>>(taps, partial, out);
  return static_cast<int>(cudaGetLastError());
}

// The backward on `stream`: the forward's r, gout (the upstream scalar,
// one float32 on the card), taps and tiling; writes grad[k], the gradient
// in fp[k], in fp[k]'s type, shape and layout.  Returns the CUDA error of
// the launch.
extern "C" int gom_lpips_head_bwd(const float* r, const float* gout, void* const* grad, int n, int elem,
                                  const void* const* fp, const void* const* fg, const void* const* head, const int* C,
                                  const int* P, const int* tile, const int* vec, const int* nhwc, void* stream) {
  Taps taps;
  int smem = 0;
  const int err = make_taps(n, elem, fp, fg, head, grad, C, P, tile, vec, nhwc, &taps, &smem);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 2)
    lpips_head_bwd_kernel<__nv_bfloat16><<<taps.blocks, THREADS, smem, s>>>(taps, r, gout);
  else
    lpips_head_bwd_kernel<float><<<taps.blocks, THREADS, smem, s>>>(taps, r, gout);
  return static_cast<int>(cudaGetLastError());
}
