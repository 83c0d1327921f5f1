// A train item's composite and resize on the card: the frame's undistorted
// uint8 image and one-channel mask -> the float32 target image (its
// composite over the item's background, resized with OpenCV's
// INTER_LANCZOS4, / 255) and the float32 target mask (resized with OpenCV's
// INTER_LINEAR), bit for bit what the host path computes with float64 numpy
// and cv2.resize.  The semantics, the tables and the plain float64 version
// the kernel is held to are in gomavatar_tpu_torch/data/composite.py.
//
// Bit for bit: every operation is one IEEE double operation rounded to
// nearest, in the host's order: __dmul_rn / __dadd_rn / __ddiv_rn, so that
// nvcc contracts none into a fused multiply-add; the mask's interpolation
// is OpenCV's fused multiply-add, __fma_rn.  Each output pixel recomputes
// the composite of the source pixels it reads (8 x 8 for the image, 2 x 2
// for the mask) and sums them in OpenCV's order: each of its 8 source rows
// horizontally tap by tap, then those rows vertically.
//
// One thread per output pixel, 128 a block along a row; ~64 source pixels
// a thread from L1/L2, ~400 float64 operations: tens of microseconds for a
// 512^2 item, on the dataset's own stream beside the train step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 8;
constexpr int THREADS = 128;

__global__ void composite_resize_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask, int W,
                                        double bg0, double bg1, double bg2,
                                        const int32_t* __restrict__ lx, const float* __restrict__ cx,
                                        const int32_t* __restrict__ ly, const float* __restrict__ cy,
                                        const int32_t* __restrict__ mx, const double* __restrict__ fx,
                                        const int32_t* __restrict__ my, const double* __restrict__ fy,
                                        float* __restrict__ rgb, float* __restrict__ out_mask, int OW) {
  const int ox = blockIdx.x * THREADS + threadIdx.x;
  const int oy = blockIdx.y;
  // mask / 255 for every mask value, divided once a block
  __shared__ double alpha[256];
  for (int v = threadIdx.x; v < 256; v += THREADS) alpha[v] = __ddiv_rn(static_cast<double>(v), 255.0);
  __syncthreads();
  if (ox >= OW) return;
  const double bg[3] = {bg0, bg1, bg2};

  double acc[3] = {0.0, 0.0, 0.0};
  for (int k = 0; k < TAPS; ++k) {
    const long long row = static_cast<long long>(ly[oy * TAPS + k]) * W;
    double h[3] = {0.0, 0.0, 0.0};
    for (int j = 0; j < TAPS; ++j) {
      const long long p = row + lx[ox * TAPS + j];
      const double c = static_cast<double>(cx[ox * TAPS + j]);
      const double a = alpha[mask[p]], na = __dsub_rn(1.0, a);
      for (int ch = 0; ch < 3; ++ch) {
        // the composite alpha * img + (1 - alpha) * bg, then its tap
        const double v = __dadd_rn(__dmul_rn(a, static_cast<double>(img[3 * p + ch])), __dmul_rn(na, bg[ch]));
        const double t = __dmul_rn(v, c);
        h[ch] = j == 0 ? t : __dadd_rn(h[ch], t);
      }
    }
    const double b = static_cast<double>(cy[oy * TAPS + k]);
    for (int ch = 0; ch < 3; ++ch) {
      const double t = __dmul_rn(h[ch], b);
      acc[ch] = k == 0 ? t : __dadd_rn(acc[ch], t);
    }
  }
  const long long o = static_cast<long long>(oy) * OW + ox;
  for (int ch = 0; ch < 3; ++ch) rgb[3 * o + ch] = __double2float_rn(__ddiv_rn(acc[ch], 255.0));

  const long long r0 = static_cast<long long>(my[2 * oy]) * W, r1 = static_cast<long long>(my[2 * oy + 1]) * W;
  const int x0 = mx[2 * ox], x1 = mx[2 * ox + 1];
  const double f = fx[ox];
  const double a00 = alpha[mask[r0 + x0]], a01 = alpha[mask[r0 + x1]];
  const double a10 = alpha[mask[r1 + x0]], a11 = alpha[mask[r1 + x1]];
  const double h0 = __fma_rn(__dsub_rn(a01, a00), f, a00);
  const double h1 = __fma_rn(__dsub_rn(a11, a10), f, a10);
  out_mask[o] = __double2float_rn(__fma_rn(__dsub_rn(h1, h0), fy[oy], h0));
}

}  // namespace

// Launches the kernel on `stream`: img (H, W, 3) and mask (H, W) uint8,
// the background color (0-255, float32 values), the Lanczos tables (taps
// int32 and coefficients float32, (OW, 8) and (OH, 8)) and the linear ones
// (taps int32 (OW, 2) and (OH, 2), fractions float64 (OW,) and (OH,)).
// Outputs rgb (OH, OW, 3) and mask (OH, OW) float32.  Returns the CUDA
// error of the launch.
extern "C" int gom_composite_resize(const uint8_t* img, const uint8_t* mask, int H, int W, double bg0, double bg1,
                                    double bg2, const int32_t* lx, const float* cx, const int32_t* ly, const float* cy,
                                    const int32_t* mx, const double* fx, const int32_t* my, const double* fy,
                                    float* rgb, float* out_mask, int OH, int OW, void* stream) {
  if (H <= 0 || W <= 0 || OH <= 0 || OW <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((OW + THREADS - 1) / THREADS, OH);
  composite_resize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, mask, W, bg0, bg1, bg2, lx, cx, ly, cy, mx, fx, my, fy, rgb, out_mask, OW);
  return static_cast<int>(cudaGetLastError());
}
