// upfirdn2d for NHWC tensors on Hopper (sm_90a): zero-stuff by `up`, pad or
// crop by (py0, py1, px0, px1), filter with the FIR taps as a true
// convolution (flipped), keep every `down`-th sample.  Accumulates in f32 and
// stores in the input's dtype (f32 or bf16).
//
// Replaces the TPU kernel multi_stylegan_tpu/ops/pallas_kernels.py::
// _make_upfirdn_kernel (launched by _upfirdn2d_pallas_fwd_impl), which only
// took up = down = 1 and non-negative pads below k.  This kernel takes any
// up, down >= 1 and any pads, as the reference's own CUDA op does, so it
// also serves the generator's up=2 skip upsample (C = 3) and, later, the
// discriminator's resampling and the down=2 backward.
//
// Bound on an H100: bytes.  At the generator's top blur site in f32,
// [16,256,256,512] in and out is 4.3 GB, about 1.3 ms at 3.35 TB/s, against
// 16 taps x 2 flops x 537M outputs = 17 GFLOP, 0.26 ms at 67 TFLOP/s.
// Design: the direct form.  One thread per output element with channels
// fastest, so a warp's loads and stores cover 32 neighbouring channels of
// one pixel and coalesce; the kh x kw window re-reads neighbouring pixels,
// which L1/L2 serve.  Each thread visits only the taps that land on a real
// input sample (the zero-stuffed ones are skipped by stepping `up`), with
// the taps in shared memory.  Blocks walk output rows (b, oy) in y and a
// row's (ox, c) elements in x; offsets into x and y are 64-bit, since at
// batch 64 the top site holds more than 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) { return __ldg(p); }
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Shape {
  int B, H, W, C;   // input
  int Ho, Wo;       // output
  int kh, kw, up, down, py0, px0;
};

// First tap t >= 0 whose zero-stuffed coordinate u0 + t is a real sample:
// u0 + t >= 0 and (u0 + t) % up == 0.
__device__ __forceinline__ int first_tap(int u0, int up) {
  return u0 < 0 ? -u0 : (up - u0 % up) % up;
}

template <typename T>
__global__ void upfirdn2d_nhwc_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                                      T* __restrict__ y, Shape s) {
  extern __shared__ float s_taps[];
  for (int i = threadIdx.x; i < s.kh * s.kw; i += blockDim.x) s_taps[i] = taps[i];
  __syncthreads();

  const int row_elems = s.Wo * s.C;  // the wrapper checks it fits an int
  const int rows = s.B * s.Ho;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int b = r / s.Ho;
    const int oy = r - b * s.Ho;
    const int uy0 = oy * s.down - s.py0;  // zero-stuffed row under tap 0
    const int ty0 = first_tap(uy0, s.up);
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < row_elems;
         q += gridDim.x * blockDim.x) {
      const int ox = q / s.C;
      const int c = q - ox * s.C;
      const int ux0 = ox * s.down - s.px0;
      const int tx0 = first_tap(ux0, s.up);
      float acc = 0.f;
      for (int ty = ty0; ty < s.kh; ty += s.up) {
        const int iy = (uy0 + ty) / s.up;
        if (iy >= s.H) break;
        const T* xrow = x + (static_cast<int64_t>(b) * s.H + iy) * s.W * s.C + c;
        // true convolution: tap (ty, tx) of the window takes k[kh-1-ty][kw-1-tx]
        const float* trow = s_taps + (s.kh - 1 - ty) * s.kw + (s.kw - 1);
        for (int tx = tx0; tx < s.kw; tx += s.up) {
          const int ix = (ux0 + tx) / s.up;
          if (ix >= s.W) break;
          acc += load_f32<T>(xrow + static_cast<int64_t>(ix) * s.C) * trow[-tx];
        }
      }
      y[static_cast<int64_t>(r) * row_elems + q] = from_f32<T>(acc);
    }
  }
}

template <typename T>
void launch(const void* x, const void* taps, void* y, const Shape& s, cudaStream_t stream) {
  const int threads = 256;
  const long long row_elems = static_cast<long long>(s.Wo) * s.C;
  const long long rows = static_cast<long long>(s.B) * s.Ho;
  dim3 grid(static_cast<unsigned>((row_elems + threads - 1) / threads),
            static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const size_t smem = static_cast<size_t>(s.kh) * s.kw * sizeof(float);
  upfirdn2d_nhwc_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<T*>(y), s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int upfirdn2d_nhwc(const void* x, const void* taps, void* y, int dtype,
                              int B, int H, int W, int C, int Ho, int Wo, int kh, int kw,
                              int up, int down, int py0, int px0, void* stream) {
  const Shape s{B, H, W, C, Ho, Wo, kh, kw, up, down, py0, px0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(x, taps, y, s, st); break;
    case 1: launch<__nv_bfloat16>(x, taps, y, s, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
