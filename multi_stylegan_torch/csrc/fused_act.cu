// The gradient of fused bias + leaky ReLU (K2) for Hopper (sm_90a), on a
// row-major [M, C] view of g and of the forward output `out`:
//
//   dx = g * (out >= 0 ? 1 : slope) * scale          stored in g's dtype
//   db = sum over rows of the stored dx, in f32       (optional)
//
// with an optional f32 addend [C] added to g first: the sum is rounded to
// g's dtype before the mask, so the result is bitwise
// `K2(g + addend.to(g.dtype))`.  That is the double backward, whose
// cotangent of db broadcasts over the rows.
//
// Replaces the TPU kernel multi_stylegan_tpu/ops/pallas_kernels.py::
// _flr_grad_kernel (:106, via _flr_grad_from_out) together with the bias sum
// of _flr_2d_bwd (:153).
//
// Bound on an H100: bytes.  One call reads g and out and writes dx once,
// 3 * M * C * sizeof(T) bytes, plus 4 * C for db or the addend; it does 4
// f32 operations an element.  At the generator's top site in bf16
// ([24, 256, 256, 512]) that is 4.8 GB, 1.44 ms at 3.35 TB/s, against
// 3.2 GFLOP, 0.05 ms at 67 TFLOP/s.
//
// On an NVIDIA H100 80GB HBM3 at a 700 W limit the Triton form this
// replaces reached 0.47-0.59 of the bound per training iteration, with the
// same ~60-67 ms gap to it in f32 and bf16.  What the design does about
// each cause of that gap:
//   1. A second launch summed an f32 partial array of n_programs x C rows
//      (12,288 rows at the 256^2 sites) on ceil(C / 128) programs.  Here one
//      launch does both: a persistent grid of 3 blocks a SM (the wrapper's
//      _BLOCKS_PER_SM; never more than the rows need) writes one f32 partial
//      row per block, a few hundred rows at most, and the last block to
//      finish sums them in the same launch.
//   2. A cross-warp reduction and a barrier on every row tile.  Here each
//      thread owns one 16-byte column slice (4 f32 or 8 bf16) and walks the
//      block's rows with kUnroll rows in flight, keeping its column sums in
//      registers with no barrier inside the walk; the block reduces its row
//      groups in shared memory once, at the end.  A warp spans 512 bytes of
//      a row (or several rows of a narrower one: C = 128 in bf16 is 256
//      bytes), so every load and store is a full 16-byte, coalesced access
//      in either dtype.  The loads keep their raw bits (4 registers a
//      vector in either dtype) until used, so 3 blocks fit a SM
//      (kBlocksPerSm) and the grid is one wave.
//   3. Host work per call (two Triton launches, three allocations, a copy of
//      g).  Here one ctypes call; the wrapper allocates dx and db only (the
//      autograd Functions copy only a cotangent that arrives in another
//      layout), and the partial rows and tickets come from a per-stream
//      cache.
//   4. The double backward ran a full-size broadcast add and a K2 whose
//      bias sum was thrown away.  Here the addend rides into the same pass
//      and a dx-only form skips the sums, the partials and the ticket.
//
// Measured by chip_smoke.py on the same card: 0.82 of the bound per f32
// training iteration and 0.79 per bf16 one; 0.86-0.88 at the top site.
//
// Deterministic: every partial row is the sum of a fixed set of rows in a
// fixed order, and the last block (whichever it is) adds the partial rows
// of its column slice in a fixed order, so db has the same bits on every
// run of the same shape on the same card.  The last block resets its
// ticket, so the next launch on the stream finds it 0.  Offsets are 64-bit:
// M * C passes 2^31 at batch 64 and 256^2 x 512.
//
// The grid is planned by the Python wrapper (ops/fused_act.py::_grad_plan)
// from the same constants; the C side re-checks it and refuses a mismatch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;    // threads a block
constexpr int kBlocksPerSm = 3;  // resident blocks a SM the registers must allow
constexpr int kLanes = 32;       // column threads a row at most: one warp across it
constexpr int kUnroll = 4;       // rows a thread has in flight
constexpr int kMaxVec = 8;       // elements a 16-byte vector holds at most

template <typename T> struct Vec;  // elements per 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T (round to nearest even, as torch's .to() does), as f32.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// Packs values already rounded to T, so the conversion is exact.
template <typename T> __device__ __forceinline__ uint4 pack(const float* v);
template <> __device__ __forceinline__ uint4 pack<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (__float_as_uint(v[2 * i]) >> 16) | (__float_as_uint(v[2 * i + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// V elements at p as they lie in memory: one 16-byte access in the vector
// form (V = Vec<T>::N), one element in the scalar form (V = 1).  Loads keep
// the raw bits, 4 registers a vector whatever the dtype, and are unpacked
// to f32 only when used.
template <typename T, int V>
using Raw = typename std::conditional<V == 1, T, uint4>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* __restrict__ p) {
  if constexpr (V == 1) {
    return *p;
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

template <typename T, int V>
__device__ __forceinline__ void to_f32s(const Raw<T, V>& r, float* v) {
  if constexpr (V == 1) {
    v[0] = to_f32<T>(r);
  } else {
    unpack<T>(r, v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    *reinterpret_cast<uint4*>(p) = pack<T>(v);
  }
}

struct Args {
  const void* g;
  const void* out;
  const float* addend;    // [C] or null
  void* dx;
  float* db;              // [C], or null for the dx-only form
  float* partials;        // [gridDim.x, C] when gridDim.x > 1 and db is wanted
  unsigned int* tickets;  // [gridDim.y], 0 between launches
  long long M;
  long long rows_per_block;
  int C;
  int lanes;              // column threads a row: kLanes, or fewer for a narrow C
  float slope;
  float scale;
};

// One block: rows [blockIdx.x * rows_per_block, +rows_per_block) of the
// column slice blockIdx.y (lanes * V columns).  Thread (group, lane) owns
// columns c0 .. c0 + V - 1 and the rows group, group + groups, ...; with
// fewer than kLanes lanes (a row narrower than a warp's 512 bytes) a warp
// spans several rows.
template <typename T, int V, bool NEED_DB, bool HAS_ADD>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) flr_grad_kernel(Args a) {
  __shared__ float s_sum[kThreads * kMaxVec];
  __shared__ bool s_last;
  const T* __restrict__ g = static_cast<const T*>(a.g);
  const T* __restrict__ o = static_cast<const T*>(a.out);
  T* __restrict__ dx = static_cast<T*>(a.dx);
  const int W = a.lanes * V;  // columns of a slice
  const int groups = kThreads / a.lanes;
  const int lane = threadIdx.x % a.lanes;
  const int group = threadIdx.x / a.lanes;
  const int c0 = blockIdx.y * W + lane * V;
  // the vector form takes C a multiple of V, so a slice is all in or all out
  const bool col_ok = c0 < a.C;
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long r1 = min(a.M, r0 + a.rows_per_block);

  float add[V], acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc[j] = 0.f;
    add[j] = (HAS_ADD && col_ok) ? round_to<T>(a.addend[c0 + j]) : 0.f;
  }
  if (col_ok) {
    for (long long r = r0 + group; r < r1; r += kUnroll * groups) {
      Raw<T, V> graw[kUnroll], oraw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every load of the step first
        const long long row = r + u * groups;
        if (row < r1) {
          const long long off = row * a.C + c0;
          graw[u] = load<T, V>(g + off);
          oraw[u] = load<T, V>(o + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = r + u * groups;
        if (row < r1) {
          float gv[V], ov[V], d[V];
          to_f32s<T, V>(graw[u], gv);
          to_f32s<T, V>(oraw[u], ov);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            // rounded products (no FMA contraction): the plain version's
            // arithmetic, and the sum adds exactly the stored values
            float s = gv[j];
            if (HAS_ADD) s = round_to<T>(__fadd_rn(s, add[j]));
            const float m = ov[j] >= 0.f ? s : __fmul_rn(s, a.slope);
            d[j] = round_to<T>(__fmul_rn(m, a.scale));
            if (NEED_DB) acc[j] += d[j];
          }
          store<T, V>(dx + row * a.C + c0, d);
        }
      }
    }
  }
  if constexpr (!NEED_DB) {
    return;
  } else {
    // the block's row groups, added in group order
#pragma unroll
    for (int j = 0; j < V; ++j) s_sum[group * W + lane * V + j] = acc[j];
    __syncthreads();
    float* dst = gridDim.x == 1 ? a.db : a.partials + static_cast<long long>(blockIdx.x) * a.C;
    for (int col = threadIdx.x; col < W; col += kThreads) {
      const int c = blockIdx.y * W + col;
      float s = 0.f;
      for (int k = 0; k < groups; ++k) s += s_sum[k * W + col];
      if (c < a.C) dst[c] = s;
    }
    if (gridDim.x == 1) return;

    // The last block of this slice to finish adds the partial rows.
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      s_last = atomicAdd(a.tickets + blockIdx.y, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // F floats a thread (16 bytes where the rows allow: C % 4 == 0 in the
    // vector form), kThreads / (W / F) row groups over the partial rows
    constexpr int F = V == 1 ? 1 : 4;
    const int CT = W / F;
    const int NG = kThreads / CT;
    const int col = (threadIdx.x % CT) * F;
    const int pg = threadIdx.x / CT;
    const int c = blockIdx.y * W + col;
    float s[F];
#pragma unroll
    for (int j = 0; j < F; ++j) s[j] = 0.f;
    if (c < a.C) {
#pragma unroll 8
      for (int p = pg; p < static_cast<int>(gridDim.x); p += NG) {
        const float* src = a.partials + static_cast<long long>(p) * a.C + c;
        if constexpr (F == 4) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(src));
          s[0] += q.x; s[1] += q.y; s[2] += q.z; s[3] += q.w;
        } else {
          s[0] += __ldcg(src);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < F; ++j) s_sum[pg * W + col + j] = s[j];
    __syncthreads();
    for (int cc = threadIdx.x; cc < W; cc += kThreads) {
      float t = 0.f;
      for (int k = 0; k < NG; ++k) t += s_sum[k * W + cc];
      if (blockIdx.y * W + cc < a.C) a.db[blockIdx.y * W + cc] = t;
    }
    if (threadIdx.x == 0) a.tickets[blockIdx.y] = 0;
  }
}

template <typename T, int V>
int launch_form(const Args& a, dim3 grid, cudaStream_t stream) {
  const bool need_db = a.db != nullptr, has_add = a.addend != nullptr;
  if (need_db && has_add) {
    flr_grad_kernel<T, V, true, true><<<grid, kThreads, 0, stream>>>(a);
  } else if (need_db) {
    flr_grad_kernel<T, V, true, false><<<grid, kThreads, 0, stream>>>(a);
  } else if (has_add) {
    flr_grad_kernel<T, V, false, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    flr_grad_kernel<T, V, false, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const Args& a, int vector, int grid_x, cudaStream_t stream) {
  const int v = vector ? Vec<T>::N : 1;
  if (a.lanes < 1 || a.lanes > kLanes || kLanes % a.lanes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long width = static_cast<long long>(a.lanes) * v;
  const long long grid_y = (a.C + width - 1) / width;
  // the plan the wrapper made, re-checked: the forms, the grid's cover of
  // the rows, the scratch the partial sums need
  if (vector && (a.C % v != 0 || !aligned16(a.g) || !aligned16(a.out) || !aligned16(a.dx) ||
                 (a.partials != nullptr && !aligned16(a.partials)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid_x < 1 || grid_y > 65535 || a.rows_per_block < 1 ||
      static_cast<long long>(grid_x) * a.rows_per_block < a.M ||
      static_cast<long long>(grid_x - 1) * a.rows_per_block >= a.M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.db != nullptr && grid_x > 1 && (a.partials == nullptr || a.tickets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  return vector ? launch_form<T, Vec<T>::N>(a, grid, stream) : launch_form<T, 1>(a, grid, stream);
}

}  // namespace

// g, out, dx: [M, C] contiguous in the dtype (0 f32, 1 bf16); addend: f32
// [C] or null; db: f32 [C] or null (the dx-only form); partials: f32
// [grid_x, C] and tickets: uint32 [ceil(C / (lanes * vector width))],
// zeroed once, both needed when db is wanted and grid_x > 1.  lanes: 1, 2,
// 4, 8, 16 or 32 column threads a row.  Returns the launch's cudaError_t.
extern "C" int flr_grad(const void* g, const void* out, const void* addend, void* dx, void* db,
                        void* partials, void* tickets, long long M, int C, float slope,
                        float scale, int dtype, int vector, int lanes, int grid_x,
                        long long rows_per_block, void* stream) {
  if (M < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{g, out, static_cast<const float*>(addend), dx, static_cast<float*>(db),
               static_cast<float*>(partials), static_cast<unsigned int*>(tickets),
               M, rows_per_block, C, lanes, slope, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(a, vector, grid_x, st);
    case 1: return launch<__nv_bfloat16>(a, vector, grid_x, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
