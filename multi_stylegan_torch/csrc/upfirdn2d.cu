// upfirdn2d for NHWC and planar (NCHW) tensors on Hopper (sm_90a): zero-stuff by `up`, pad or
// crop by (py0, py1, px0, px1), filter with the FIR taps as a true
// convolution (flipped), keep every `down`-th sample.  Accumulates in f32 and
// stores in the input's dtype (f32 or bf16).
//
// Replaces the TPU kernel multi_stylegan_tpu/ops/pallas_kernels.py::
// _make_upfirdn_kernel (launched by _upfirdn2d_pallas_fwd_impl), which only
// took up = down = 1 and non-negative pads below k.  The same source serves
// the forward op (K3) and its adjoint (K4: flipped taps, up and down swapped,
// adjoint pads) at every call site of the models: the generator's blurs and
// C = 3 skip upsamples, the discriminator's downscale blurs on odd maps and
// its decoder upsamples, and the down=2 adjoints of every up=2 site.
//
// Bound on an H100: bytes.  At the generator's top blur site in f32,
// [24,256,256,512] in and out is 6.4 GB, 1.92 ms at 3.35 TB/s, against
// 16 taps x 2 flops x 805M outputs = 26 GFLOP, 0.38 ms at 67 TFLOP/s.
// The first version, the direct form kept below as the general kernel (one
// thread per output element, each of the 16 taps an integer division and a
// 4-byte load), ran that site at 32.4 ms, 6% of the bound, where its note
// had predicted 1.3 ms at batch 16 (17x off): it was bound by instruction
// issue, and the window's 16-fold reuse went to L2.
//
// Design: specialised tiled kernels for the three forms the models run,
// chosen by the Python wrapper (ops/upfirdn2d.py::_plan) and checked here:
//   up 1 down 1 (blurs, up=1 adjoints, their double backward),
//   up 2 down 1 (upsamples and the double backward of their adjoints),
//   up 1 down 2 (the adjoints of the up=2 sites),
// for 4x4 taps, C a multiple of the 16-byte vector (4 f32 / 8 bf16) and
// 16-byte aligned input and output.  One block computes one batch element's
// TH x TW outputs for one chunk of 8 channel vectors (128 bytes a pixel):
// it stages the input tile with its halo in shared memory by 16-byte
// cp.async copies that zero-fill outside [0, H) x [0, W) (which gives pads,
// crops and ragged tile edges in one mechanism), then each thread computes
// one channel vector for MY rows x S consecutive columns, loading each staged
// pixel of its window once and keeping the 16 taps and the sums in
// registers.  up 2 is polyphase: the phase of every (output, tap) pair is
// fixed at compile time from the pads' parities (RY, RX), so no zero-stuffed
// sample is read and nothing is divided.  Blocks are not double-buffered:
// two to four resident blocks a SM overlap one block's copies with
// another's arithmetic.  Tiles (TH x TW, MY x S per thread, threads, shared
// memory):
//   up1 down1: 16 x 16, f32 1 x 8 (256 threads), bf16 1 x 4 (512), 45 KB
//   up2 down1: 16 x 16, f32 2 x 4 (256),         bf16 2 x 2 (512), 12.5 KB
//   up1 down2:  8 x 16, f32 1 x 4 (256),         bf16 1 x 2 (512), 76.5 KB
// Everything else (C = 3, other taps, misaligned views) takes the general
// kernel, the direct form.  Each output is written once, without atomics.
// Offsets are 64-bit from the batch base: at batch 64 the top site holds
// more than 2^31 elements.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, f32, in two runs: the top blur site and its adjoint 2.20-2.22 ms,
// 0.87 of the bound; the D decoder's 24x128x128x256 up 2 at 0.71 ms (0.85)
// and its down 2 adjoint at 0.66 ms (0.92); D's 127x127 blur at 0.14 ms
// (0.85).  Every batch-12 and batch-24 site from 64x64 up reaches 0.77-0.92
// of the bound.  Below that, a launch costs 0.03-0.07 ms of host dispatch,
// whatever the kernel does.
//
// Planar forms.  The generator's f32 forward with autograd off keeps its
// activations NCHW-contiguous (cuDNN's f32 convolutions are NCHW kernels),
// and the wrapper passes such a tensor as its permute(0, 2, 3, 1) view.  A
// planar tensor is B*C independent H x W planes, and the same Variant codes
// above kPlanarGeneral name its forms:
//   planar general: the general kernel on the planes as [B*C, H, W, 1];
//   planar up 1 down 1 (the blur after every up-conv, odd maps included)
//   and planar up 2 down 1 (the skip upsamples, C = 3 among them): f32, 4x4
//   taps, any pads.  One block walks down a column strip of one plane, a
//   TH x TW tile at a time: it stages a tile's input rows with their halo in
//   shared memory by 4-byte cp.async copies that zero-fill outside the
//   plane (rows of an odd width are not 16-byte aligned), the next tile's
//   while it computes this one's; each thread computes MY rows x 4
//   consecutive columns, reading each staged row of its window with 16-byte
//   (up 1) or 8-byte (up 2) shared loads, which a quarter- or half-warp of
//   consecutive threads take without bank conflicts.  up 2 is polyphase, as
//   above.  Each output sums the same products in the same order as the
//   NHWC forms.  Rows are stored as one 16-byte vector a thread where Wo is
//   a multiple of 4 and the output 16-byte aligned, else element by element.
//   One tile for both: 32 x 32 outputs, 8 x 16 threads of 2 rows each, up
//   to 4 tiles a block.  Offsets are 64-bit
//   from the plane base: config F's 1024x1024 maps at batch 16 and 32
//   channels are 2^29 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// Variant codes, the ones ops/upfirdn2d.py::_plan emits: NHWC forms, then
// planar (NCHW-contiguous) ones.
enum Variant {
  kGeneral = 0, kUp1Down1 = 1, kUp2Down1 = 2, kUp1Down2 = 3,
  kPlanarGeneral = 4, kPlanarUp1Down1 = 5, kPlanarUp2Down1 = 6
};

struct Shape {
  int B, H, W, C;   // input
  int Ho, Wo;       // output
  int kh, kw, up, down, py0, px0;
};

// ------------------------------------------------------------ general form

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

// First tap t >= 0 whose zero-stuffed coordinate u0 + t is a real sample:
// u0 + t >= 0 and (u0 + t) % up == 0.
__device__ __forceinline__ int first_tap(int u0, int up) {
  return u0 < 0 ? -u0 : (up - u0 % up) % up;
}

// One thread per output element, channels fastest; any up, down, taps, pads.
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
int launch_general(const void* x, const void* taps, void* y, const Shape& s,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long row_elems = static_cast<long long>(s.Wo) * s.C;
  const long long rows = static_cast<long long>(s.B) * s.Ho;
  dim3 grid(static_cast<unsigned>((row_elems + threads - 1) / threads),
            static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const size_t smem = static_cast<size_t>(s.kh) * s.kw * sizeof(float);
  upfirdn2d_nhwc_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- tiled forms

constexpr int kLanes = 8;  // 16-byte channel vectors per staged pixel (128 bytes)
constexpr int kTaps = 4;   // the tiled forms take 4 x 4 taps

template <typename T> struct Vec;  // channels per 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T> __device__ __forceinline__ void unpack(const uint4& r, float* v);
template <> __device__ __forceinline__ void unpack<float>(const uint4& r, float* v) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& r, float* v) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address holds the lower half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T> __device__ __forceinline__ uint4 pack(const float* v);
template <> __device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 16-byte global -> shared copy; src-size 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 16 : 0));
}

// Tile geometry of one form.  Output row m of a tile whose first output row
// is O reads zero-stuffed rows DOWN*(O+m) - py0 + t; with the staged tile's
// first input row I0 = floor((DOWN*O - py0) / UP) and RY = DOWN*O - py0 -
// UP*I0 (0 for up 1, the parity of py0 for up 2, since O is even), tap t of
// output row m lands on staged row (DOWN*m + t + RY) / UP when that divides,
// and on a zero-stuffed sample otherwise.  Likewise along W with RX.
template <typename T, int UP, int DOWN, int TH, int TW, int MY, int S, int RY, int RX>
struct Tile {
  static constexpr int N = Vec<T>::N;
  static constexpr int THREADS = kLanes * (TH / MY) * (TW / S);
  static constexpr int IH = (DOWN * (TH - 1) + kTaps - 1 + RY) / UP + 1;  // staged rows
  static constexpr int IW = (DOWN * (TW - 1) + kTaps - 1 + RX) / UP + 1;  // staged columns
  static constexpr int JY = (DOWN * (MY - 1) + kTaps - 1 + RY) / UP + 1;  // rows a thread reads
  static constexpr int JX = (DOWN * (S - 1) + kTaps - 1 + RX) / UP + 1;   // columns it reads
  static constexpr size_t SMEM = static_cast<size_t>(IH) * IW * kLanes * sizeof(uint4);
  static_assert(MY % UP == 0 && S % UP == 0 && TH % MY == 0 && TW % S == 0,
                "a thread's first output must sit on phase 0");
};

template <typename T, int UP, int DOWN, int TH, int TW, int MY, int S, int RY, int RX>
__global__ void __launch_bounds__((Tile<T, UP, DOWN, TH, TW, MY, S, RY, RX>::THREADS))
upfirdn2d_tiled_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                       T* __restrict__ y, Shape s) {
  using G = Tile<T, UP, DOWN, TH, TW, MY, S, RY, RX>;
  constexpr int N = G::N, IH = G::IH, IW = G::IW;
  extern __shared__ uint4 tile[];  // [IH][IW][kLanes]

  const int chunks = (s.C + kLanes * N - 1) / (kLanes * N);
  const int tiles_x = (s.Wo + TW - 1) / TW;
  const int chunk = blockIdx.x % chunks;
  const int t = blockIdx.x / chunks;
  const int oy0 = (t / tiles_x) * TH, ox0 = (t % tiles_x) * TW;
  const int b = blockIdx.y;
  const int iy0 = (DOWN * oy0 - s.py0 - RY) / UP;  // exact: the numerator divides
  const int ix0 = (DOWN * ox0 - s.px0 - RX) / UP;
  const int c0 = chunk * kLanes * N;
  const T* xb = x + static_cast<int64_t>(b) * s.H * s.W * s.C;

  for (int i = threadIdx.x; i < IH * IW * kLanes; i += G::THREADS) {
    const int lane = i % kLanes, p = i / kLanes;
    const int iy = iy0 + p / IW, ix = ix0 + p % IW, c = c0 + lane * N;
    const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W && c < s.C;
    cp_async16(&tile[i], in ? xb + (static_cast<int64_t>(iy) * s.W + ix) * s.C + c : x, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float k[kTaps * kTaps];  // flipped on use: tap (ty, tx) takes k[3-ty][3-tx]
#pragma unroll
  for (int i = 0; i < kTaps * kTaps; ++i) k[i] = __ldg(taps + i);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x % kLanes, rest = threadIdx.x / kLanes;
  const int my0 = (rest / (TW / S)) * MY, mx0 = (rest % (TW / S)) * S;
  float acc[MY][S][N];
#pragma unroll
  for (int a = 0; a < MY; ++a)
#pragma unroll
    for (int m = 0; m < S; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n) acc[a][m][n] = 0.f;

  const uint4* win = tile + ((DOWN * my0 / UP) * IW + DOWN * mx0 / UP) * kLanes + lane;
#pragma unroll
  for (int jy = 0; jy < G::JY; ++jy) {
#pragma unroll
    for (int jx = 0; jx < G::JX; ++jx) {
      float v[N];
      unpack<T>(win[(jy * IW + jx) * kLanes], v);
#pragma unroll
      for (int a = 0; a < MY; ++a) {
        const int ty = UP * jy - DOWN * a - RY;  // the tap row that lands here
        if (ty < 0 || ty >= kTaps) continue;
#pragma unroll
        for (int m = 0; m < S; ++m) {
          const int tx = UP * jx - DOWN * m - RX;
          if (tx < 0 || tx >= kTaps) continue;
          const float w = k[(kTaps - 1 - ty) * kTaps + (kTaps - 1 - tx)];
#pragma unroll
          for (int n = 0; n < N; ++n) acc[a][m][n] = fmaf(v[n], w, acc[a][m][n]);
        }
      }
    }
  }

  const int c = c0 + lane * N;
  if (c >= s.C) return;
#pragma unroll
  for (int a = 0; a < MY; ++a) {
    const int oy = oy0 + my0 + a;
    if (oy >= s.Ho) continue;
    T* yrow = y + (static_cast<int64_t>(b) * s.Ho + oy) * s.Wo * s.C + c;
#pragma unroll
    for (int m = 0; m < S; ++m) {
      const int ox = ox0 + mx0 + m;
      if (ox < s.Wo) *reinterpret_cast<uint4*>(yrow + static_cast<int64_t>(ox) * s.C) = pack<T>(acc[a][m]);
    }
  }
}

template <typename T, int UP, int DOWN, int TH, int TW, int MY, int S, int RY, int RX>
int launch_tiled_phase(const void* x, const void* taps, void* y, const Shape& s,
                       cudaStream_t stream) {
  using G = Tile<T, UP, DOWN, TH, TW, MY, S, RY, RX>;
  auto kernel = upfirdn2d_tiled_kernel<T, UP, DOWN, TH, TW, MY, S, RY, RX>;
  if (G::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long chunks = (s.C + kLanes * G::N - 1) / (kLanes * G::N);
  const long long tiles = static_cast<long long>((s.Ho + TH - 1) / TH) * ((s.Wo + TW - 1) / TW);
  dim3 grid(static_cast<unsigned>(chunks * tiles), static_cast<unsigned>(s.B));
  kernel<<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<T*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int UP, int DOWN, int TH, int TW, int MY, int S>
int launch_tiled(const void* x, const void* taps, void* y, const Shape& s, cudaStream_t st) {
  if constexpr (UP == 1) {
    return launch_tiled_phase<T, UP, DOWN, TH, TW, MY, S, 0, 0>(x, taps, y, s, st);
  } else {
    switch ((s.py0 & 1) * 2 + (s.px0 & 1)) {  // up 2: the pads' parities fix the phases
      case 0: return launch_tiled_phase<T, UP, DOWN, TH, TW, MY, S, 0, 0>(x, taps, y, s, st);
      case 1: return launch_tiled_phase<T, UP, DOWN, TH, TW, MY, S, 0, 1>(x, taps, y, s, st);
      case 2: return launch_tiled_phase<T, UP, DOWN, TH, TW, MY, S, 1, 0>(x, taps, y, s, st);
      default: return launch_tiled_phase<T, UP, DOWN, TH, TW, MY, S, 1, 1>(x, taps, y, s, st);
    }
  }
}

// The tiled forms' conditions, as _plan checks them (the grid count is taken
// at the smallest tile, 8 x 16, for every form).
bool tiled_ok(int variant, int vec, const void* x, const void* y, const Shape& s) {
  const int up = variant == kUp2Down1 ? 2 : 1, down = variant == kUp1Down2 ? 2 : 1;
  const long long chunks = (s.C + kLanes * vec - 1) / (kLanes * vec);
  const long long tiles = static_cast<long long>((s.Ho + 7) / 8) * ((s.Wo + 15) / 16);
  return s.kh == kTaps && s.kw == kTaps && s.up == up && s.down == down && s.C % vec == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         s.B <= 65535 && chunks * tiles <= INT_MAX;
}

// ----------------------------------------------------------- planar forms

// 4-byte global -> shared copy; src-size 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(fill ? 4 : 0));
}

template <int N> struct FloatVec;  // an N-float shared load
template <> struct FloatVec<2> { using type = float2; };
template <> struct FloatVec<4> { using type = float4; };

// Planar tile geometry: the tile's output rows start at O (a multiple of
// TH); its first staged input row is I0 = (O - py0 - RY) / UP, and tap t of
// output row m lands on staged row (m + t + RY) / UP when that divides, as
// in Tile above (DOWN 1).  A thread's 4 columns start on staged column 4 tx
// / UP and its MY rows on staged row MY ty / UP; it reads JX columns of JY
// rows through NL shared loads of L floats a row.
template <int UP, int TX, int TY, int MY, int RY, int RX>
struct PlanarTile {
  static constexpr int S = 4;  // output columns a thread
  static constexpr int THREADS = TX * TY;
  static constexpr int TH = TY * MY, TW = TX * S;
  static constexpr int IH = (TH - 1 + kTaps - 1 + RY) / UP + 1;  // staged rows
  static constexpr int JY = (MY - 1 + kTaps - 1 + RY) / UP + 1;  // rows a thread reads
  static constexpr int JX = (S - 1 + kTaps - 1 + RX) / UP + 1;   // columns it reads
  static constexpr int L = UP == 1 ? 4 : 2;
  static constexpr int NL = (JX + L - 1) / L;
  static constexpr int IW = (S / UP) * (TX - 1) + NL * L;  // staged columns, as read
  static constexpr int STRIDE = (IW + 3) / 4 * 4;          // a staged row, 16-byte aligned
  static_assert(MY % UP == 0 && S % UP == 0, "a thread's first output must sit on phase 0");
};

// Stages one tile's input rows (rows iy0 .. iy0 + IH of the plane, columns
// ix0 .. ix0 + STRIDE) into buf; zeros outside the plane.
template <typename G>
__device__ __forceinline__ void stage_planar(float* buf, const float* xp, const float* x,
                                             int iy0, int ix0, const Shape& s) {
  for (int i = threadIdx.x; i < G::IH * G::STRIDE; i += G::THREADS) {
    const int iy = iy0 + i / G::STRIDE, ix = ix0 + i % G::STRIDE;
    const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    cp_async4(&buf[i], in ? xp + static_cast<int64_t>(iy) * s.W + ix : x, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block walks down a column strip of one plane: `steps` tiles of TH x
// TW outputs, one under the other, staging the next tile's rows while it
// computes the current one (two buffers), so loads stay in flight through
// the arithmetic and a tile's halo rows come from cache.  Blocks run the
// strips of a plane's row band side by side (strip fastest, then band, then
// plane), so neighbouring strips share their halo columns in L2 too.
template <int UP, int TX, int TY, int MY, int RY, int RX>
__global__ void __launch_bounds__(TX * TY)
upfirdn2d_tiled_kernel_planar(const float* __restrict__ x, const float* __restrict__ taps,
                              float* __restrict__ y, Shape s, int steps, bool vst) {
  using G = PlanarTile<UP, TX, TY, MY, RY, RX>;
  using V = typename FloatVec<G::L>::type;
  constexpr int S = G::S, STRIDE = G::STRIDE, BUF = G::IH * G::STRIDE;
  __shared__ __align__(16) float tiles[2 * BUF];

  const int strips = (s.Wo + G::TW - 1) / G::TW;
  const int bands = ((s.Ho + G::TH - 1) / G::TH + steps - 1) / steps;
  const int strip = blockIdx.x % strips, rest = blockIdx.x / strips;
  const int band = rest % bands, plane = rest / bands;
  const int ox0 = strip * G::TW;
  const int ix0 = (ox0 - s.px0 - RX) / UP;  // exact: the numerator divides
  const int first = band * steps;
  const int n = min(steps, (s.Ho + G::TH - 1) / G::TH - first);
  const float* xp = x + static_cast<int64_t>(plane) * s.H * s.W;
  float* yp = y + static_cast<int64_t>(plane) * s.Ho * s.Wo;

  // tile t's first staged row: (t TH - py0 - RY) / UP, exact as t TH is even
  stage_planar<G>(tiles, xp, x, (first * G::TH - s.py0 - RY) / UP, ix0, s);
  float k[kTaps * kTaps];  // flipped on use: tap (ty, tx) takes k[3-ty][3-tx]
#pragma unroll
  for (int i = 0; i < kTaps * kTaps; ++i) k[i] = __ldg(taps + i);

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int ox = ox0 + S * tx;
  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) {
      stage_planar<G>(tiles + ((t + 1) & 1) * BUF, xp, x,
                      ((first + t + 1) * G::TH - s.py0 - RY) / UP, ix0, s);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int oy = (first + t) * G::TH + MY * ty;
    if (ox < s.Wo && oy < s.Ho) {
      float acc[MY][S];
#pragma unroll
      for (int a = 0; a < MY; ++a)
#pragma unroll
        for (int m = 0; m < S; ++m) acc[a][m] = 0.f;
      const float* win = tiles + (t & 1) * BUF + (MY * ty / UP) * STRIDE + S * tx / UP;
#pragma unroll
      for (int jy = 0; jy < G::JY; ++jy) {
        float v[G::NL * G::L];
#pragma unroll
        for (int l = 0; l < G::NL; ++l)
          *reinterpret_cast<V*>(v + l * G::L) =
              *reinterpret_cast<const V*>(win + jy * STRIDE + l * G::L);
        // the NHWC forms' order: taps by staged row, then by staged column
#pragma unroll
        for (int jx = 0; jx < G::JX; ++jx) {
#pragma unroll
          for (int a = 0; a < MY; ++a) {
            const int ky = UP * jy - a - RY;  // the tap row that lands here
            if (ky < 0 || ky >= kTaps) continue;
#pragma unroll
            for (int m = 0; m < S; ++m) {
              const int kx = UP * jx - m - RX;
              if (kx < 0 || kx >= kTaps) continue;
              acc[a][m] = fmaf(v[jx], k[(kTaps - 1 - ky) * kTaps + (kTaps - 1 - kx)], acc[a][m]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MY; ++a) {
        if (oy + a >= s.Ho) break;
        float* yrow = yp + static_cast<int64_t>(oy + a) * s.Wo + ox;
        if (vst) {
          *reinterpret_cast<float4*>(yrow) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        } else {
#pragma unroll
          for (int m = 0; m < S; ++m)
            if (ox + m < s.Wo) yrow[m] = acc[a][m];
        }
      }
    }
    __syncthreads();  // every read of this buffer done before it is staged again
  }
}

// The planar tile: 8 x 16 threads, 2 rows a thread: 32 x 32 outputs; a
// block walks up to kPlanarSteps tiles down its strip, fewer where the grid
// would otherwise hold under kPlanarMinBlocks blocks (about four waves of
// an H100's resident blocks: the skips' few planes of 3 channels).
constexpr int kPlanarTX = 8, kPlanarTY = 16, kPlanarMY = 2, kPlanarSteps = 4;
constexpr long long kPlanarMinBlocks = 8192;

template <int UP, int RY, int RX>
int launch_planar_phase(const void* x, const void* taps, void* y, const Shape& s,
                        cudaStream_t stream) {
  using G = PlanarTile<UP, kPlanarTX, kPlanarTY, kPlanarMY, RY, RX>;
  const long long columns = static_cast<long long>(s.B) * s.C * ((s.Wo + G::TW - 1) / G::TW);
  const long long tiles_y = (s.Ho + G::TH - 1) / G::TH;
  int steps = kPlanarSteps;
  while (steps > 1 && columns * ((tiles_y + steps - 1) / steps) < kPlanarMinBlocks) steps /= 2;
  const bool vst = s.Wo % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  upfirdn2d_tiled_kernel_planar<UP, kPlanarTX, kPlanarTY, kPlanarMY, RY, RX>
      <<<static_cast<unsigned>(columns * ((tiles_y + steps - 1) / steps)), G::THREADS, 0,
         stream>>>(static_cast<const float*>(x), static_cast<const float*>(taps),
                   static_cast<float*>(y), s, steps, vst);
  return static_cast<int>(cudaGetLastError());
}

template <int UP>
int launch_planar(const void* x, const void* taps, void* y, const Shape& s, cudaStream_t st) {
  if constexpr (UP == 1) {
    return launch_planar_phase<1, 0, 0>(x, taps, y, s, st);
  } else {
    switch ((s.py0 & 1) * 2 + (s.px0 & 1)) {  // the pads' parities fix the phases
      case 0: return launch_planar_phase<2, 0, 0>(x, taps, y, s, st);
      case 1: return launch_planar_phase<2, 0, 1>(x, taps, y, s, st);
      case 2: return launch_planar_phase<2, 1, 0>(x, taps, y, s, st);
      default: return launch_planar_phase<2, 1, 1>(x, taps, y, s, st);
    }
  }
}

// The planar tiled forms' conditions, as _plan checks them (the grid at
// its largest: a block for every 32 x 32 tile).
bool planar_tiled_ok(int variant, int dtype, const Shape& s) {
  const int up = variant == kPlanarUp2Down1 ? 2 : 1;
  const long long planes = static_cast<long long>(s.B) * s.C;
  return dtype == 0 && s.kh == kTaps && s.kw == kTaps && s.up == up && s.down == 1 &&
         planes * ((s.Wo + 31) / 32) * ((s.Ho + 31) / 32) <= INT_MAX;
}

template <typename T>
int launch(int variant, const void* x, const void* taps, void* y, const Shape& s,
           cudaStream_t st) {
  if (variant >= kUp1Down1 && variant <= kUp1Down2 && !tiled_ok(variant, Vec<T>::N, x, y, s))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((variant == kPlanarUp1Down1 || variant == kPlanarUp2Down1) &&
      !planar_tiled_ok(variant, sizeof(T) == 4 ? 0 : 1, s))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool f32 = sizeof(T) == 4;
  switch (variant) {
    case kGeneral: return launch_general<T>(x, taps, y, s, st);
    case kUp1Down1: return launch_tiled<T, 1, 1, 16, 16, 1, f32 ? 8 : 4>(x, taps, y, s, st);
    case kUp2Down1: return launch_tiled<T, 2, 1, 16, 16, 2, f32 ? 4 : 2>(x, taps, y, s, st);
    case kUp1Down2: return launch_tiled<T, 1, 2, 8, 16, 1, f32 ? 4 : 2>(x, taps, y, s, st);
    case kPlanarGeneral: {  // B*C planes of one channel each
      Shape p = s;
      p.B = s.B * s.C;
      p.C = 1;
      return launch_general<T>(x, taps, y, p, st);
    }
    case kPlanarUp1Down1: if constexpr (f32) return launch_planar<1>(x, taps, y, s, st); break;
    case kPlanarUp2Down1: if constexpr (f32) return launch_planar<2>(x, taps, y, s, st); break;
    default: break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; variant: a Variant code from _plan; the shape is
// (B, H, W, C) whatever the layout the variant names.  Returns
// cudaErrorInvalidValue for a variant the shape, dtype or alignment does not
// allow, else cudaGetLastError() after the launch (0 on success); the Python
// wrapper raises on anything but 0.
extern "C" int upfirdn2d_launch(const void* x, const void* taps, void* y, int dtype, int variant,
                              int B, int H, int W, int C, int Ho, int Wo, int kh, int kw,
                              int up, int down, int py0, int px0, void* stream) {
  const Shape s{B, H, W, C, Ho, Wo, kh, kw, up, down, py0, px0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(variant, x, taps, y, s, st);
    case 1: return launch<__nv_bfloat16>(variant, x, taps, y, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
