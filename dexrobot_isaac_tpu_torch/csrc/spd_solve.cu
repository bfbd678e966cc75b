// K3: the batched dense SPD solve A x = b of the engine's implicit-PD step.
//
// Replaces the TPU kernel of dexrobot_isaac_tpu/ops/linalg.py
// (_cholesky_solve_kernel, reached through _spd_solve_pallas, pallas_call at
// :113). The arithmetic is the TPU kernel's: a left-looking Cholesky whose
// pivots go through rsqrt (L[j][j] = s * rsqrt(s), the off-diagonals and both
// substitutions multiply by the stored rsqrt), then forward and back
// substitution, each sum taken over k in the TPU kernel's order. The TPU
// layout artefacts (the (n, n, N) transpose, the identity padding of N to
// blocks of 256) are not carried over: A is read in the (N, n, n) layout the
// engine builds, b and x as (N, n), and the system index is bounds-checked.
//
// Design: one warp per system. Lane i owns row i (n = 26 <= 32). The factor,
// the column sums, the pivots' rsqrt and both solution vectors live in the
// warp's slice of shared memory (rows padded to n + 1 floats, so the lanes'
// row-wise reads fall in distinct banks); a __syncwarp separates the steps.
// Each column j of the factor is one step in which every lane i >= j forms
// its row's sum; the forward substitution is column-oriented (after y_k is
// known, every lane i > k subtracts L[i][k] y_k, which is row i's sum in the
// TPU order); the back substitution's row sums run over L's columns, so lane
// i forms x_i alone, in the TPU order k = i+1 .. n-1.
//
// What bounds it on the H100: per system it must read the lower triangle of
// A (351 floats at n = 26) and b (26) and write x (26): 1.6 KB, ~6.6 MB at
// 4096 systems, ~2 us at 3.35 TB/s; the ~7.2 kFLOP per system (n^3/3 for the
// factor, 2 n^2 for the solves) are ~0.44 us at 67 TFLOP/s. So bytes bound
// it. This simple design is latency-bound instead: ~4 n dependent warp steps
// per system. Reading the whole matrix row-major, as here, touches the upper
// triangle's sectors too.
//
// The file also compiles as plain C++ (no __CUDACC__): the host build runs
// the same per-lane steps with a loop over the lanes in place of the warp.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SPD_DEV __device__ __forceinline__
#define SPD_RSQRT(x) rsqrtf(x)
#else
#include <math.h>
#define SPD_DEV static inline
#define SPD_RSQRT(x) (1.0f / sqrtf(x))
#endif

#define SPD_N 26       // the system size the kernel is built for (the hand's DOFs)
#define SPD_WARPS 4    // systems (warps) per block
#define SPD_LANES 32

struct SpdShared {
  float L[SPD_N][SPD_N + 1];  // A's lower triangle, overwritten by the factor
  float v[SPD_N];             // column sums (factor), running sums (forward)
  float dinv[SPD_N];          // rsqrt of the pivots
  float y[SPD_N];
  float x[SPD_N];
};

// The steps of one system, each run by every lane; on the card a
// __syncwarp separates consecutive steps.
SPD_DEV void spd_load(SpdShared* s, const float* A, const float* b, int lane) {
  for (int t = lane; t < SPD_N * SPD_N; t += SPD_LANES) {
    int r = t / SPD_N, c = t - r * SPD_N;
    if (c <= r) s->L[r][c] = A[t];
  }
  if (lane < SPD_N) s->y[lane] = b[lane];
}

// column j, first half: row sums s_i = A[i][j] - sum_k L[i][k] L[j][k]
SPD_DEV void spd_col_sum(SpdShared* s, int j, int lane) {
  if (lane < j || lane >= SPD_N) return;
  float v = s->L[lane][j];
  for (int k = 0; k < j; ++k) v = v - s->L[lane][k] * s->L[j][k];
  s->v[lane] = v;
}

// column j, second half: the pivot's rsqrt scales the column
SPD_DEV void spd_col_scale(SpdShared* s, int j, int lane) {
  if (lane < j || lane >= SPD_N) return;
  float d = SPD_RSQRT(s->v[j]);
  s->L[lane][j] = s->v[lane] * d;  // lane j: s * rsqrt(s)
  if (lane == j) s->dinv[j] = d;
}

// forward substitution L y = b, step k: y_k is final; rows below subtract
// L[i][k] y_k (s->y holds b on entry and y on exit)
SPD_DEV void spd_forward(SpdShared* s, int k, int lane) {
  if (lane < k || lane >= SPD_N) return;
  float yk = s->v[k] * s->dinv[k];
  if (lane == k) s->y[k] = yk;
  else s->v[lane] = s->v[lane] - s->L[lane][k] * yk;
}

SPD_DEV void spd_forward_init(SpdShared* s, int lane) {
  if (lane < SPD_N) s->v[lane] = s->y[lane];
}

// back substitution L^T x = y, row i (descending): x_i from the x_k, k > i
SPD_DEV void spd_back(SpdShared* s, int i, int lane) {
  if (lane != i) return;
  float v = s->y[i];
  for (int k = i + 1; k < SPD_N; ++k) v = v - s->L[k][i] * s->x[k];
  s->x[i] = v * s->dinv[i];
}

SPD_DEV void spd_store(const SpdShared* s, float* x, int lane) {
  if (lane < SPD_N) x[lane] = s->x[lane];
}

// One whole system: each step runs on every lane before the next starts
// (on the card the warp's lanes, then a __syncwarp; on the host a loop).
#ifdef __CUDACC__
#define SPD_EACH_LANE(step)                   \
  do {                                        \
    const int lane = threadIdx.x % SPD_LANES; \
    step;                                     \
    __syncwarp();                             \
  } while (0)
#else
#define SPD_EACH_LANE(step) \
  do {                      \
    for (int lane = 0; lane < SPD_LANES; ++lane) step; \
  } while (0)
#endif

SPD_DEV void spd_system(SpdShared* s, const float* A, const float* b, float* x) {
  SPD_EACH_LANE(spd_load(s, A, b, lane));
  for (int j = 0; j < SPD_N; ++j) {
    SPD_EACH_LANE(spd_col_sum(s, j, lane));
    SPD_EACH_LANE(spd_col_scale(s, j, lane));
  }
  SPD_EACH_LANE(spd_forward_init(s, lane));
  for (int k = 0; k < SPD_N; ++k) SPD_EACH_LANE(spd_forward(s, k, lane));
  for (int i = SPD_N - 1; i >= 0; --i) SPD_EACH_LANE(spd_back(s, i, lane));
  SPD_EACH_LANE(spd_store(s, x, lane));
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SPD_WARPS * SPD_LANES)
    spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, int n_sys) {
  __shared__ SpdShared sh[SPD_WARPS];
  int w = threadIdx.x / SPD_LANES;
  int e = blockIdx.x * SPD_WARPS + w;
  if (e >= n_sys) return;  // the whole warp leaves together
  spd_system(&sh[w], A + (size_t)e * SPD_N * SPD_N, b + (size_t)e * SPD_N,
             x + (size_t)e * SPD_N);
}
#endif

extern "C" {

int spd_solve_dim() { return SPD_N; }

#ifdef __CUDACC__
int spd_solve_launch(const float* A, const float* b, float* x, int n_sys, int n,
                     void* stream) {
  if (n != SPD_N || n_sys < 1) return (int)cudaErrorInvalidValue;
  int blocks = (n_sys + SPD_WARPS - 1) / SPD_WARPS;
  spd_solve_kernel<<<blocks, SPD_WARPS * SPD_LANES, 0, (cudaStream_t)stream>>>(A, b, x, n_sys);
  return (int)cudaGetLastError();
}
#else
// Host build of the same steps (no CUDA): every system in a loop.
int spd_solve_host(const float* A, const float* b, float* x, int n_sys, int n) {
  if (n != SPD_N) return 1;
  SpdShared s;
  for (int e = 0; e < n_sys; ++e)
    spd_system(&s, A + (size_t)e * SPD_N * SPD_N, b + (size_t)e * SPD_N, x + (size_t)e * SPD_N);
  return 0;
}
#endif

}  // extern "C"
