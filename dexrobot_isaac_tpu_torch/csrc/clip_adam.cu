// The PPO learner's optimizer step: optax's chain(clip_by_global_norm, adam)
// followed by apply_updates, over every leaf of the network in two launches.
//
// Replaces no TPU kernel: the JAX learner leaves its optimizer to XLA, which
// fuses the per-leaf elementwise ops. In the port those ops ran eagerly, ~15
// launches a leaf and ~365 a minibatch update on the recipe's 17 leaves,
// each costing the host more than the card spends on the whole update
// (PERF.md). The wrapper is ops/clip_adam.py; its plain version is the
// arithmetic this file reproduces.
//
// What bounds it on the H100: per element it reads the parameter, gradient
// and both moments and writes the parameter and both moments, 28 bytes, and
// does ~17 f32 operations. At the recipe's 481,957 parameters that is
// ~13.5 MB, ~4 us at 3.35 TB/s, against ~0.1 us of operations: bytes bound
// it. The design:
//
// - Two launches per call and none per leaf. The leaves reach the kernels
//   as a table of (pointers, element count, offset in the flat element
//   space) inside the kernel-argument struct (`__grid_constant__`, so a
//   block indexes it in place, with no copy); there is no host-to-device
//   copy per call. Each block owns one contiguous range of the flat element
//   space and walks the leaves that meet it, so a leaf of 18 elements and
//   one of 150,016 cost the same per element.
// - Launch 1 (`clip_adam_norm`, only with the clip on) writes one partial
//   sum of g*g per block; launch 2 (`clip_adam_update`) first folds the
//   partial sums into ||g||: every block the same fixed-order sum, so all
//   blocks hold the same bits. No float atomic anywhere: two calls on the
//   same inputs give the same bits, so ranks that feed it the same
//   all-reduced gradients keep bitwise-equal parameters.
// - Nothing waits for the host: the step count and the learning rate are
//   read on the device, block 0 writes count + 1, and the clip's test
//   ||g|| < max_norm and its scale run on the device.
// - Element by element the plain version's arithmetic, in its order, with
//   no contraction into FMA (the __f*_rn intrinsics) and IEEE division and
//   square root: g' = where(||g|| < c, g, (g / ||g||) * c);
//   mu' = (1 - b1) g' + b1 mu; nu' = (1 - b2) (g' g') + b2 nu;
//   p' = p + (-lr) ((mu' / bc1) / (sqrt(nu' / bc2) + eps)), with
//   bc = 1 - b^count in f32 (powf, as torch's pow of a float). Given the
//   same ||g|| every output equals the plain version's bits; only the
//   norm's order of summation differs from it.
// - The outputs are three fresh flat buffers (the wrapper's), so the
//   inputs are left as they were.
//
// The file also compiles as plain C++ (no __CUDACC__): the host build runs
// each block's threads as a loop and each warp's shuffle tree on an array,
// in the order of the card's (clip_adam_host), for the CPU tests.
#include <math.h>
#include <string.h>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CA_DEV __device__ __forceinline__
#else
#define CA_DEV static inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return sqrtf(a); }
#endif

#define CA_MAX_LEAVES 32
#define CA_THREADS 256
#define CA_WARPS (CA_THREADS / 32)
#define CA_NORM_TILE 2048    // elements per block of launch 1 (8 a thread)
#define CA_NORM_BLOCKS 1024  // launch 1's most blocks: its partial sums' slots
#define CA_UPDATE_TILE 1024  // elements per block of launch 2 (4 a thread)
// scratch: CA_NORM_BLOCKS partial sums, then ||g|| (written by block 0 of
// launch 2 for the tests and the card's checks)
#define CA_SCRATCH (CA_NORM_BLOCKS + 1)

typedef struct {
  const float* p;
  const float* g;
  const float* mu;
  const float* nu;
  long long n, off;  // element count; offset in the flat element space
} CaLeaf;

typedef struct {
  CaLeaf leaf[CA_MAX_LEAVES];
  float* p_out;
  float* mu_out;
  float* nu_out;
  float* scratch;
  const int* count;
  int* count_out;
  const float* lr;
  long long total, norm_chunk, update_chunk;
  int n_leaves, clip, norm_blocks, update_blocks;
  float max_norm, b1, b2, one_m_b1, one_m_b2, eps;
} CaArgs;

// The part [s, e) of leaf L that lies in [lo, hi) of the flat element
// space (s >= e: none).
CA_DEV void ca_span(const CaLeaf& L, long long lo, long long hi, long long* s, long long* e) {
  *s = lo > L.off ? lo : L.off;
  *e = hi < L.off + L.n ? hi : L.off + L.n;
}

// Thread `tid` of launch-1 block `b`: its sum of g*g, in index order.
CA_DEV float ca_norm_thread(const CaArgs& a, int b, int tid) {
  const long long lo = (long long)b * a.norm_chunk;
  const long long hi = lo + a.norm_chunk < a.total ? lo + a.norm_chunk : a.total;
  float acc = 0.f;
  for (int l = 0; l < a.n_leaves; ++l) {
    const CaLeaf& L = a.leaf[l];
    long long s, e;
    ca_span(L, lo, hi, &s, &e);
    for (long long j = s - L.off + tid; j < e - L.off; j += CA_THREADS)
      acc = fmaf(L.g[j], L.g[j], acc);
  }
  return acc;
}

// Thread `tid` of launch-2 block `b`: the clip and Adam on its elements.
CA_DEV void ca_update_thread(const CaArgs& a, int b, int tid, float g_norm) {
  const float cf = (float)(*a.count + 1);
  const float bc1 = __fadd_rn(1.f, -powf(a.b1, cf));
  const float bc2 = __fadd_rn(1.f, -powf(a.b2, cf));
  const float neg_lr = -*a.lr;
  const bool scale = a.clip && !(g_norm < a.max_norm);
  const long long lo = (long long)b * a.update_chunk;
  const long long hi = lo + a.update_chunk < a.total ? lo + a.update_chunk : a.total;
  for (int l = 0; l < a.n_leaves; ++l) {
    const CaLeaf& L = a.leaf[l];
    long long s, e;
    ca_span(L, lo, hi, &s, &e);
    for (long long i = s + tid; i < e; i += CA_THREADS) {
      const long long j = i - L.off;
      float g = L.g[j];
      if (scale) g = __fmul_rn(__fdiv_rn(g, g_norm), a.max_norm);
      const float m = __fadd_rn(__fmul_rn(a.one_m_b1, g), __fmul_rn(a.b1, L.mu[j]));
      const float v = __fadd_rn(__fmul_rn(a.one_m_b2, __fmul_rn(g, g)), __fmul_rn(a.b2, L.nu[j]));
      const float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
      a.p_out[i] = __fadd_rn(L.p[j], __fmul_rn(neg_lr, u));
      a.mu_out[i] = m;
      a.nu_out[i] = v;
    }
  }
}

// Lane `lane`'s share of the partial sums, in slot order.
CA_DEV float ca_partials_lane(const CaArgs& a, int lane) {
  float v = 0.f;
  for (int b = lane; b < a.norm_blocks; b += 32) v += a.scratch[b];
  return v;
}

#ifdef __CUDACC__
// The warp's butterfly: after it every lane holds the same sum (each level
// adds the same two operands on both lanes of a pair).
__device__ __forceinline__ float ca_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(CA_THREADS) clip_adam_norm(const __grid_constant__ CaArgs a) {
  __shared__ float ws[CA_WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float v = ca_warp_sum(ca_norm_thread(a, blockIdx.x, threadIdx.x));
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float s = ca_warp_sum(lane < CA_WARPS ? ws[lane] : 0.f);
    if (lane == 0) a.scratch[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(CA_THREADS) clip_adam_update(const __grid_constant__ CaArgs a) {
  __shared__ float g_norm;
  if (a.clip) {
    if (threadIdx.x < 32) {
      const float s = __fsqrt_rn(ca_warp_sum(ca_partials_lane(a, threadIdx.x)));
      if (threadIdx.x == 0) {
        g_norm = s;
        if (blockIdx.x == 0) a.scratch[CA_NORM_BLOCKS] = s;
      }
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count_out = *a.count + 1;
  ca_update_thread(a, blockIdx.x, threadIdx.x, a.clip ? g_norm : 0.f);
}
#else
// The card's butterfly for lane 0, on the 32 lanes' values.
static float ca_warp_sum_host(const float* lanes) {
  float v[32], w[32];
  memcpy(v, lanes, sizeof v);
  for (int o = 16; o; o >>= 1) {
    for (int k = 0; k < 32; ++k) w[k] = v[k] + v[k ^ o];
    memcpy(v, w, sizeof v);
  }
  return v[0];
}
#endif

// The argument struct of one call (0, or cudaErrorInvalidValue's 1 on a
// table the kernels do not take). ptrs: n_leaves rows of (p, g, mu, nu).
static int ca_args(CaArgs* a, const long long* ptrs, const long long* sizes, int n_leaves,
                   float* p_out, float* mu_out, float* nu_out, float* scratch, const int* count,
                   int* count_out, const float* lr, int clip, double max_norm, double b1,
                   double b2, double eps) {
  if (n_leaves < 1 || n_leaves > CA_MAX_LEAVES) return 1;
  memset(a, 0, sizeof *a);
  long long total = 0;
  for (int l = 0; l < n_leaves; ++l) {
    if (sizes[l] < 0) return 1;
    a->leaf[l].p = (const float*)ptrs[4 * l];
    a->leaf[l].g = (const float*)ptrs[4 * l + 1];
    a->leaf[l].mu = (const float*)ptrs[4 * l + 2];
    a->leaf[l].nu = (const float*)ptrs[4 * l + 3];
    a->leaf[l].n = sizes[l];
    a->leaf[l].off = total;
    total += sizes[l];
  }
  if (total < 1) return 1;
  a->p_out = p_out;
  a->mu_out = mu_out;
  a->nu_out = nu_out;
  a->scratch = scratch;
  a->count = count;
  a->count_out = count_out;
  a->lr = lr;
  a->total = total;
  a->n_leaves = n_leaves;
  a->clip = clip != 0;
  long long nb = (total + CA_NORM_TILE - 1) / CA_NORM_TILE;
  a->norm_blocks = (int)(nb < CA_NORM_BLOCKS ? nb : CA_NORM_BLOCKS);
  a->norm_chunk = (total + a->norm_blocks - 1) / a->norm_blocks;
  a->update_chunk = CA_UPDATE_TILE;
  a->update_blocks = (int)((total + CA_UPDATE_TILE - 1) / CA_UPDATE_TILE);
  // the plain version's constants: Python floats cast to f32 where they
  // meet a tensor, 1 - b taken in double first
  a->max_norm = (float)max_norm;
  a->b1 = (float)b1;
  a->b2 = (float)b2;
  a->one_m_b1 = (float)(1.0 - b1);
  a->one_m_b2 = (float)(1.0 - b2);
  a->eps = (float)eps;
  return 0;
}

extern "C" {

int clip_adam_max_leaves() { return CA_MAX_LEAVES; }
int clip_adam_scratch() { return CA_SCRATCH; }

#ifdef __CUDACC__
// Launch 1 (with the clip on) and launch 2 on `stream`; cudaGetLastError()
// after each.
int clip_adam_launch(const long long* ptrs, const long long* sizes, int n_leaves, float* p_out,
                     float* mu_out, float* nu_out, float* scratch, const int* count,
                     int* count_out, const float* lr, int clip, double max_norm, double b1,
                     double b2, double eps, void* stream) {
  CaArgs a;
  if (ca_args(&a, ptrs, sizes, n_leaves, p_out, mu_out, nu_out, scratch, count, count_out, lr,
              clip, max_norm, b1, b2, eps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.clip) {
    clip_adam_norm<<<a.norm_blocks, CA_THREADS, 0, s>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  clip_adam_update<<<a.update_blocks, CA_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
#else
// The same two launches on the host: each block's threads in a loop, each
// warp's butterfly on an array. Pointers are host memory.
int clip_adam_host(const long long* ptrs, const long long* sizes, int n_leaves, float* p_out,
                   float* mu_out, float* nu_out, float* scratch, const int* count, int* count_out,
                   const float* lr, int clip, double max_norm, double b1, double b2, double eps) {
  CaArgs a;
  if (ca_args(&a, ptrs, sizes, n_leaves, p_out, mu_out, nu_out, scratch, count, count_out, lr,
              clip, max_norm, b1, b2, eps))
    return 1;
  float g_norm = 0.f;
  if (a.clip) {
    float t[CA_THREADS], ws[32];
    for (int b = 0; b < a.norm_blocks; ++b) {
      for (int tid = 0; tid < CA_THREADS; ++tid) t[tid] = ca_norm_thread(a, b, tid);
      memset(ws, 0, sizeof ws);
      for (int w = 0; w < CA_WARPS; ++w) ws[w] = ca_warp_sum_host(t + 32 * w);
      scratch[b] = ca_warp_sum_host(ws);
    }
    float lanes[32];
    for (int lane = 0; lane < 32; ++lane) lanes[lane] = ca_partials_lane(a, lane);
    g_norm = __fsqrt_rn(ca_warp_sum_host(lanes));
    scratch[CA_NORM_BLOCKS] = g_norm;
  }
  for (int b = 0; b < a.update_blocks; ++b)
    for (int tid = 0; tid < CA_THREADS; ++tid) ca_update_thread(a, b, tid, g_norm);
  *count_out = *count + 1;
  return 0;
}
#endif

}  // extern "C"
