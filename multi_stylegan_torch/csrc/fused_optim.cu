// The training iteration's optimizer updates for Hopper (sm_90a), each over
// every leaf of a model at once (multi-tensor launches):
//
//   Adam (train/state.py::ClippedAdam): a global-norm clip, then Adam with
//   one learning rate a leaf, under a finite guard, in two launches;
//   EMA (train/ema.py::ema_update): e = e * decay + p * (1 - decay), one
//   launch.
//
// Replaces no TPU kernel: the JAX package leaves the optax chain to XLA,
// which fuses it into a few loops over the parameter tree.  The port's
// plain version (ops/fused_optim.py::clipped_adam_ref, ema_update_ref) runs
// ~30 elementwise launches a leaf; at the paper's widths (G 164 leaves,
// D 64) that was ~9,100 launches a main iteration, ~88% of the optimizer's
// time idle while the host issued them.
//
// Bound on an H100: bytes, and at these sizes launch latency.  An Adam step
// reads g twice (the norm, then the update) and reads and writes p, m and v:
// 32 bytes a value, ~1.7 GB a G step (53.0 M values), 0.51 ms at 3.35 TB/s;
// an EMA update reads e and p and writes e, 12 bytes a value, 0.19 ms.  Each
// does ~12 f32 operations a value: far below the byte bound.
//
// Layout: the wrapper cuts every leaf into chunks of kChunk values and gives
// each chunk one block (a table of (leaf, chunk index) pairs, built once
// with the leaves' table: parameter, moment and EMA pointers never move).
// The gradients' pointers change every step, so they travel as kernel
// arguments with a byte each for their memory order: up to kMaxLeaves
// leaves (2,880 bytes of the 4 KB of parameters), which the wrapper checks;
// the port's models have at most 164.
//
// Adam, launch 1 (adam_reduce_kernel): each block writes its chunk's f32 sum
// of squares (under tensor parallelism: as replicated or sharded, by its
// leaf) and whether it holds a non-finite value as one float4 partial; the
// last block to finish (a ticket) adds the partials in chunk order into
// totals = (replicated, sharded, non-finite).  Every sum is over a fixed set
// in a fixed order, so a step is the same bits run to run.  Between the
// launches the wrapper sums the sharded part over the model axis
// (parallel/mesh.py::model_sum).
//
// Adam, launch 2 (adam_update_kernel): every block reads the totals and the
// old counters and works out g_norm, finite, apply, clip, the new count and
// the bias corrections itself, then updates its chunk of p, m and v in
// place when the step applies.  The last block to finish (a second ticket,
// so every block has read the old counters) writes the counters and the
// applied flag.  The arithmetic is the plain version's, operation by
// operation, with rounded products (no FMA contraction): only g_norm's
// order of summation differs.
//
// Vector form: 16-byte loads and stores where every pointer of the chunk is
// 16-byte aligned (chunks start at multiples of kChunk values); a gradient
// that is a view into a data-parallel bucket may not be, and that chunk
// takes the scalar form.  A conv weight's gradient may come in another
// memory order than its leaf's (cuDNN's: channels-last, or input channels
// outermost through a double backward; the wrapper copies any other): the
// sum of squares reads its memory as it lies (a chunk is then a set of the
// leaf's values, not a run of them), and the update gathers each value's
// gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block
constexpr int kChunk = 1 << 15;    // values a block
constexpr int kMaxLeaves = 320;    // gradient pointers a launch carries

struct AdamLeaf {      // 48 bytes, ops/fused_optim.py::ADAM_LEAF
  float* p;
  float* m;
  float* v;
  long long n;
  float neg_lr;        // -lr, as the plain version's scalar
  int sharded;         // the leaf is this rank's block of a sharded parameter
  int inner;           // the leaf as [O, I, K] (a 4-d one [O, I, H, W] with
  int taps;            // K = H * W, a 2-d one K = 1): I and K, else 0
};
static_assert(sizeof(AdamLeaf) == 48, "AdamLeaf layout");

struct EmaLeaf {       // 24 bytes, ops/fused_optim.py::EMA_LEAF
  float* e;
  const float* p;
  long long n;
};
static_assert(sizeof(EmaLeaf) == 24, "EmaLeaf layout");

struct GradPtrs {      // the step's gradients, aligned with the leaves' table
  const float* g[kMaxLeaves];
  unsigned char order[kMaxLeaves];  // each one's memory order (below)
};

// The memory order of a gradient seen as [O, I, K], its axes outer to inner
// (ops/fused_optim.py::ORDERS): 0 (O, I, K) the leaf's own; 1 (O, K, I)
// channels-last; 2 (I, O, K) as cuDNN gives a weight's gradient through a
// double backward.
__device__ __forceinline__ void order_strides(int order, long long O, long long I,
                                              long long K, long long& so, long long& si,
                                              long long& sk) {
  switch (order) {
    case 1: so = K * I; sk = I; si = 1; break;
    case 2: si = O * K; so = K; sk = 1; break;
    default: so = I * K; si = K; sk = 1; break;
  }
}

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, max_norm;
  int skip_nonfinite;
  int max_consecutive;
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

__device__ __forceinline__ bool dev_aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether x is neither infinite nor NaN: its exponent is not all ones.
__device__ __forceinline__ int nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// A block's sum of v over its threads, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* s_red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // s_red free from an earlier call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) t += s_red[w];
  return t;
}

__global__ void __launch_bounds__(kThreads) adam_reduce_kernel(
    GradPtrs grads, const AdamLeaf* __restrict__ leaves, const int2* __restrict__ chunks,
    int total_chunks, float4* partials, unsigned int* ticket, float* totals) {
  __shared__ float s_red[kThreads / 32];
  __shared__ bool s_last;
  const int c = blockIdx.x;
  const int2 ch = chunks[c];
  const AdamLeaf leaf = leaves[ch.x];
  const float* __restrict__ g = grads.g[ch.x];
  const long long start = static_cast<long long>(ch.y) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), leaf.n - start));
  float sq = 0.f;
  int bad = 0;
  if (g != nullptr) {
    g += start;
    int i0 = 0;
    if (dev_aligned16(g)) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int i = threadIdx.x; i < n / 4; i += kThreads) {
        const float4 x = g4[i];
        sq = fmaf(x.x, x.x, sq);
        sq = fmaf(x.y, x.y, sq);
        sq = fmaf(x.z, x.z, sq);
        sq = fmaf(x.w, x.w, sq);
        bad |= nonfinite(x.x) | nonfinite(x.y) | nonfinite(x.z) | nonfinite(x.w);
      }
      i0 = n / 4 * 4;
    }
    for (int i = i0 + threadIdx.x; i < n; i += kThreads) {
      const float x = g[i];
      sq = fmaf(x, x, sq);
      bad |= nonfinite(x);
    }
  }
  sq = block_sum(sq, s_red);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    partials[c] = leaf.sharded ? make_float4(0.f, sq, bad ? 1.f : 0.f, 0.f)
                               : make_float4(sq, 0.f, bad ? 1.f : 0.f, 0.f);
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == static_cast<unsigned>(total_chunks - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float rep = 0.f, shard = 0.f, flag = 0.f;
  for (int i = threadIdx.x; i < total_chunks; i += kThreads) {
    const float4 q = __ldcg(partials + i);
    rep += q.x;
    shard += q.y;
    flag = fmaxf(flag, q.z);
  }
  rep = block_sum(rep, s_red);
  shard = block_sum(shard, s_red);
  const bool any_bad = __syncthreads_or(flag > 0.f);
  if (threadIdx.x == 0) {
    totals[0] = rep;
    totals[1] = shard;
    totals[2] = any_bad ? 1.f : 0.f;
    *ticket = 0;
  }
}

// p, m, v <- the Adam step of one value (the plain version's operations).
__device__ __forceinline__ void adam_value(float g, float& p, float& m, float& v, bool clip,
                                           float g_norm, float bc1, float bc2,
                                           float neg_lr, const Hyper& h) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, g_norm), h.max_norm);
  const float mu = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, m));
  const float nu = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps);
  p = __fadd_rn(p, __fmul_rn(neg_lr, __fdiv_rn(__fdiv_rn(mu, bc1), den)));
  m = mu;
  v = nu;
}

__global__ void __launch_bounds__(kThreads) adam_update_kernel(
    GradPtrs grads, const AdamLeaf* __restrict__ leaves, const int2* __restrict__ chunks,
    int total_chunks, const float* rep, const float* blocks, int* count, int* notfinite,
    bool* applied, unsigned int* ticket, Hyper h) {
  __shared__ float s_gnorm, s_bc1, s_bc2;
  __shared__ int s_apply, s_clip, s_count, s_notfinite;
  if (threadIdx.x == 0) {
    // the plain version's scalars: g_norm = sqrt(replicated + sharded sums),
    // finite unless a rank saw a non-finite value, the skip and its count
    const float g_norm = __fsqrt_rn(__fadd_rn(rep[0], blocks[0]));
    const bool finite = blocks[1] == 0.f;
    const int old_count = *count;
    int nf = *notfinite;
    bool apply = true;
    if (h.skip_nonfinite) {
      nf = finite ? 0 : nf + 1;
      apply = finite || nf > h.max_consecutive;
    }
    const int cnt = apply ? old_count + 1 : old_count;
    s_gnorm = g_norm;
    s_clip = g_norm >= h.max_norm;
    s_apply = apply;
    s_count = cnt;
    s_notfinite = nf;
    s_bc1 = __fsub_rn(1.f, powf(h.b1, static_cast<float>(cnt)));
    s_bc2 = __fsub_rn(1.f, powf(h.b2, static_cast<float>(cnt)));
  }
  __syncthreads();
  if (s_apply) {
    const int2 ch = chunks[blockIdx.x];
    const AdamLeaf leaf = leaves[ch.x];
    const float* __restrict__ g = grads.g[ch.x];
    const long long start = static_cast<long long>(ch.y) * kChunk;
    const int n = static_cast<int>(min(static_cast<long long>(kChunk), leaf.n - start));
    float* __restrict__ p = leaf.p + start;
    float* __restrict__ m = leaf.m + start;
    float* __restrict__ v = leaf.v + start;
    const bool clip = s_clip;
    const float g_norm = s_gnorm, bc1 = s_bc1, bc2 = s_bc2, neg_lr = leaf.neg_lr;
    const int order = g != nullptr ? grads.order[ch.x] : 0;
    if (order != 0) {
      // value (o, i, k) of the leaf lies elsewhere in the gradient: gathered,
      // the leaf's and the moments' side coalesced (32-bit index arithmetic:
      // the wrapper gathers only leaves of fewer than 2^31 values)
      const unsigned I = leaf.inner, K = leaf.taps, slab = I * K;
      long long so, si, sk;
      order_strides(order, leaf.n / slab, I, K, so, si, sk);
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const unsigned j = static_cast<unsigned>(start) + i;
        const unsigned o = j / slab;
        const unsigned r = j - o * slab;
        const unsigned ii = r / K, k = r - ii * K;
        float pv = p[i], mv = m[i], vv = v[i];
        adam_value(g[o * so + ii * si + k * sk], pv, mv, vv, clip, g_norm, bc1, bc2, neg_lr,
                   h);
        p[i] = pv;
        m[i] = mv;
        v[i] = vv;
      }
    } else {
      if (g != nullptr) g += start;
      int i0 = 0;
      if (dev_aligned16(p) && dev_aligned16(m) && dev_aligned16(v) &&
          (g == nullptr || dev_aligned16(g))) {
        for (int i = threadIdx.x; i < n / 4; i += kThreads) {
          const float4 gv = g != nullptr ? reinterpret_cast<const float4*>(g)[i]
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          float4 pv = reinterpret_cast<float4*>(p)[i];
          float4 mv = reinterpret_cast<float4*>(m)[i];
          float4 vv = reinterpret_cast<float4*>(v)[i];
          adam_value(gv.x, pv.x, mv.x, vv.x, clip, g_norm, bc1, bc2, neg_lr, h);
          adam_value(gv.y, pv.y, mv.y, vv.y, clip, g_norm, bc1, bc2, neg_lr, h);
          adam_value(gv.z, pv.z, mv.z, vv.z, clip, g_norm, bc1, bc2, neg_lr, h);
          adam_value(gv.w, pv.w, mv.w, vv.w, clip, g_norm, bc1, bc2, neg_lr, h);
          reinterpret_cast<float4*>(p)[i] = pv;
          reinterpret_cast<float4*>(m)[i] = mv;
          reinterpret_cast<float4*>(v)[i] = vv;
        }
        i0 = n / 4 * 4;
      }
      for (int i = i0 + threadIdx.x; i < n; i += kThreads) {
        float pv = p[i], mv = m[i], vv = v[i];
        adam_value(g != nullptr ? g[i] : 0.f, pv, mv, vv, clip, g_norm, bc1, bc2, neg_lr, h);
        p[i] = pv;
        m[i] = mv;
        v[i] = vv;
      }
    }
  }
  // the last block, once every block has read the old counters, writes them
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ticket, 1u) == static_cast<unsigned>(total_chunks - 1)) {
      *count = s_count;
      if (h.skip_nonfinite) *notfinite = s_notfinite;
      *applied = s_apply != 0;
      *ticket = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ema_kernel(
    const EmaLeaf* __restrict__ leaves, const int2* __restrict__ chunks, float decay,
    float one_minus_decay) {
  const int2 ch = chunks[blockIdx.x];
  const EmaLeaf leaf = leaves[ch.x];
  const long long start = static_cast<long long>(ch.y) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), leaf.n - start));
  float* __restrict__ e = leaf.e + start;
  const float* __restrict__ p = leaf.p + start;
  int i0 = 0;
  if (dev_aligned16(e) && dev_aligned16(p)) {
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      float4 ev = reinterpret_cast<float4*>(e)[i];
      const float4 pv = reinterpret_cast<const float4*>(p)[i];
      ev.x = __fadd_rn(__fmul_rn(ev.x, decay), __fmul_rn(pv.x, one_minus_decay));
      ev.y = __fadd_rn(__fmul_rn(ev.y, decay), __fmul_rn(pv.y, one_minus_decay));
      ev.z = __fadd_rn(__fmul_rn(ev.z, decay), __fmul_rn(pv.z, one_minus_decay));
      ev.w = __fadd_rn(__fmul_rn(ev.w, decay), __fmul_rn(pv.w, one_minus_decay));
      reinterpret_cast<float4*>(e)[i] = ev;
    }
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += kThreads) {
    e[i] = __fadd_rn(__fmul_rn(e[i], decay), __fmul_rn(p[i], one_minus_decay));
  }
}

// The step's gradient pointers and their orders as a kernel argument; false
// where the leaves are more than a launch carries or there is no chunk.
bool grad_ptrs(const void* const* grads, const unsigned char* order, int n_leaves,
               int total_chunks, GradPtrs& gp) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || total_chunks < 1) return false;
  for (int i = 0; i < kMaxLeaves; ++i) {
    const bool in = i < n_leaves;
    gp.g[i] = in ? static_cast<const float*>(grads[i]) : nullptr;
    gp.order[i] = in ? order[i] : 0;
  }
  return true;
}

}  // namespace

// grads: host array of the step's n_leaves gradient pointers (f32, dense,
// null for a leaf without one), aligned with leaves (a device AdamLeaf
// table), and order: host array of their memory orders (above); chunks:
// device int2 (leaf, chunk index) table of total_chunks; partials: float4
// [total_chunks], ticket: uint32, zeroed once; totals: f32 [3] (replicated
// sum, sharded sum, non-finite flag).
extern "C" int adam_reduce(const void* const* grads, const unsigned char* order, int n_leaves,
                           const void* leaves, const void* chunks, int total_chunks,
                           void* partials, void* ticket, void* totals, void* stream) {
  GradPtrs gp;
  if (!aligned16(partials) || !grad_ptrs(grads, order, n_leaves, total_chunks, gp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  adam_reduce_kernel<<<total_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, static_cast<const AdamLeaf*>(leaves), static_cast<const int2*>(chunks), total_chunks,
      static_cast<float4*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<float*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// rep: f32 [1], the replicated sum of squares; blocks: f32 [2], the sharded
// sum and the non-finite flag summed over the model axis; count, notfinite:
// int32 [1], updated; applied: bool [1], written; ticket: uint32, zeroed
// once (not adam_reduce's).
extern "C" int adam_update(const void* const* grads, const unsigned char* order, int n_leaves,
                           const void* leaves, const void* chunks, int total_chunks,
                           const void* rep, const void* blocks, void* count, void* notfinite,
                           void* applied, void* ticket, float b1, float b2, float one_minus_b1,
                           float one_minus_b2, float eps, float max_norm, int skip_nonfinite,
                           int max_consecutive, void* stream) {
  GradPtrs gp;
  if (!grad_ptrs(grads, order, n_leaves, total_chunks, gp)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper h{b1, b2, one_minus_b1, one_minus_b2, eps, max_norm, skip_nonfinite,
                max_consecutive};
  adam_update_kernel<<<total_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, static_cast<const AdamLeaf*>(leaves), static_cast<const int2*>(chunks), total_chunks,
      static_cast<const float*>(rep), static_cast<const float*>(blocks),
      static_cast<int*>(count), static_cast<int*>(notfinite), static_cast<bool*>(applied),
      static_cast<unsigned int*>(ticket), h);
  return static_cast<int>(cudaGetLastError());
}

// leaves: a device EmaLeaf table; chunks: its device int2 table of n_chunks.
extern "C" int ema_update(const void* leaves, const void* chunks, int n_chunks, float decay,
                          float one_minus_decay, void* stream) {
  if (n_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  ema_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const EmaLeaf*>(leaves), static_cast<const int2*>(chunks), decay,
      one_minus_decay);
  return static_cast<int>(cudaGetLastError());
}
