// K3: the batched dense SPD solve A x = b of the engine's implicit-PD step.
//
// Replaces the TPU kernel of dexrobot_isaac_tpu/ops/linalg.py
// (_cholesky_solve_kernel, reached through _spd_solve_pallas, pallas_call at
// :113). The TPU layout artefacts (the (n, n, N) transpose, the identity
// padding of N to blocks of 256) are not carried over: A is read in the
// (N, n, n) layout the engine builds, b and x as (N, n), and the system index
// is bounds-checked.
//
// What bounds it on the H100: per system it must read the lower triangle of
// A (351 floats at n = 26) and b (26) and write x (26): 1.6 KB, ~6.6 MB at
// 4096 systems, ~2 us at 3.35 TB/s; the ~7.2 kFLOP per system are ~0.44 us
// at 67 TFLOP/s. So bytes bound it. A warp per system is held back instead
// by its chain of dependent steps and, with 32 systems on each SM, by the
// SM's shared-memory pipe, which every broadcast of a column, store and
// shuffle passes through (measured: PERF.md). The design keeps both short:
//
// - One warp per system; lane i holds row i of A in registers (SPD_N is a
//   compile-time constant and every loop over a column is unrolled, so the
//   row array is never indexed at run time). The factor is right-looking:
//   at step j every lane has d_j = rsqrt(s_j); lanes i > j form
//   L[i][j] = a[i][j] d_j and publish it to the warp's column buffer in
//   shared memory, and after a __syncwarp every lane subtracts
//   L[i][j] L[c][j] from a[i][c], c > j, with independent FMAs fed by
//   broadcast 16-byte shared loads (lanes i <= j update entries above the
//   diagonal, which no lane reads: no branch). Each entry receives its
//   subtractions over k ascending with the operands of the TPU kernel's
//   left-looking sums (linalg.py:37-47): the factor's arithmetic is the TPU
//   kernel's, with every multiply-subtract one fused FMA.
// - The next pivot leaves the chain early: at step j every lane also forms
//   a[i][j+1] - L[i][j]^2, which for lane j + 1 is its whole pivot sum
//   s_{j+1} (the same FMA on the same operands as its later update), and a
//   shuffle carries it to every lane while the column's shared round trip
//   runs. The critical path is 26 steps of {shfl, rsqrt, mul, fma}.
// - The forward substitution rides along: b is a 27th register. At step j
//   lane j, whose forward sum v_j is final after the steps k < j, puts v_j
//   where its pivot sum was (the shuffle already carried s_j) so the
//   column's scaling makes it y_j = v_j d_j in the column's slot j, and lanes
//   i > j subtract L[i][j] y_j: each row's sum over k ascending, as in
//   linalg.py:48-54.
// - Each step stores one word a lane: the columns of L stay in shared memory
//   (swizzled so that a step's stores and the back substitution's loads are
//   free of bank conflicts), and lane 31, which holds no row, files d_j in
//   the column's spare slot. The back substitution runs across the lanes:
//   for k = n-1 down to 1, lane k forms x_k = v_k d_k, a shuffle broadcasts
//   it and lanes i < k subtract L[k][i] x_k. This is the one change of arithmetic:
//   each back-substitution sum runs over k descending, where the TPU
//   kernel's runs ascending (linalg.py:55-61); both stay within 1e-5
//   relative of a float64 solve.
// - The system (2,704 contiguous bytes, 169 16-byte segments) is staged into
//   the warp's shared slice with coalesced 16-byte loads of the 72 segments
//   that lie wholly in the lower triangle (a 32-bit mask per round of
//   segments, constants of the build) and scalar loads of the 63 lower
//   entries in the 31 segments that straddle the diagonal or a row's start
//   (each lane its own row's, at most 5): the kernel addresses no byte of
//   the upper triangle. Each lane then takes its row with 8-byte shared
//   loads. A TMA bulk copy would move the whole 2,704 bytes, upper triangle
//   included, and its mbarrier wait adds latency to a copy this small that
//   the coalesced loads already keep in one round trip.
// - No atomics, no sum split or reordered between runs: two launches on the
//   same inputs give the same bits. 8 warps (systems) per block; registers
//   are capped at 64 a thread (the first steps load their long columns in
//   two halves to fit), so 32 systems stay resident per SM and 4096 systems
//   run in one wave on 132 SMs.
//
// The file also compiles as plain C++ (no __CUDACC__): the host build runs
// each phase as a loop over the lanes, each with its own register state, and
// a shuffle reads the value its source lane produced in an earlier phase;
// lane_order_host(1) runs the lanes in reverse, so a phase that reads what
// another lane writes in it gives other bits.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SPD_DEV __device__ __forceinline__
#define SPD_UNROLL _Pragma("unroll")
typedef float4 SpdF4;
typedef float2 SpdF2;
#else
#include <math.h>
#include <string.h>
#define SPD_DEV static inline
#define SPD_UNROLL
struct SpdF4 { float x, y, z, w; };
struct SpdF2 { float x, y; };
#endif

#define SPD_N 26       // the system size the kernel is built for (the hand's DOFs)
#define SPD_WARPS 8    // systems (warps) per block
#define SPD_LANES 32
#define SPD_THREADS (SPD_WARPS * SPD_LANES)
#define SPD_MIN_BLOCKS 4  // resident blocks per SM asked of ptxas: 64 registers
#define SPD_SEGS (SPD_N * SPD_N / 4)                          // 16-byte segments of A
#define SPD_SEG_ROUNDS ((SPD_SEGS + SPD_LANES - 1) / SPD_LANES)
#define SPD_QUADS ((SPD_N + 3) / 4)  // 16-byte words of a column
#define SPD_SPLIT 8                  // steps j < 8 load their column in two halves

// Bit `lane` of round k: segment lane + 32 k lies wholly in the lower
// triangle (checked against spd_full_segs below).
#define SPD_FULL_SEGS {0x4000000u, 0x18304082u, 0x38e1c306u, 0xf1e78f1cu, 0xf7cfbe7cu, 0x1fbu}

// Column j of L lives in slots j * 32 + (i ^ j): a step's stores (lane i,
// column j) and the back substitution's loads (lane i, column i, row k)
// each hit 32 distinct banks, and a 16-byte word of a column stays a word.
SPD_DEV int spd_slot(int j, int i) { return j * SPD_LANES + (i ^ j); }

union alignas(16) SpdWarp {  // 16-byte loads and stores in every warp's slice
  float a[SPD_N * SPD_N];         // the system's lower triangle as staged
  float col[SPD_N * SPD_LANES];   // then L[i][j] (i > j), y_j (i = j), d_j (i = 31)
                                  // at spd_slot(j, i)
};

struct SpdLane {
  float row[SPD_N];  // row `lane` of A, then of L (c < lane)
  float v;           // b, then the forward sum, y_lane, the back substitution's sum
  float d;           // rsqrt of this lane's pivot
  float dj;          // rsqrt of the current step's pivot
  float pn;          // row[j + 1] less L[lane][j]^2: lane j + 1's next pivot sum
};

#ifdef __CUDACC__
// On the card a lane's state is its registers and a shuffle reads the source
// lane's value in the same instruction.
#define SPD_SRC(src) L
#define SPD_SHFL(val, src) __shfl_sync(0xffffffffu, (val), (src))
#define SPD_SYNC() __syncwarp()
#define SPD_WARP(step) \
  do {                 \
    step;              \
  } while (0)
SPD_DEV SpdF4 spd_ld4(const float* p) { return *reinterpret_cast<const SpdF4*>(p); }
SPD_DEV SpdF2 spd_ld2(const float* p) { return *reinterpret_cast<const SpdF2*>(p); }
SPD_DEV void spd_st4(float* p, SpdF4 v) { *reinterpret_cast<SpdF4*>(p) = v; }
SPD_DEV float spd_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
// rsqrtf without its fix-up for subnormal inputs (an SPD pivot is normal)
SPD_DEV float spd_rsqrt(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// The system index, read again from the special registers: a value kept
// through the solve would hold a register.
SPD_DEV int spd_late_index(int) {
  unsigned c, t;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(c));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return (int)(c * SPD_WARPS + t / SPD_LANES);
}
#else
static int spd_lane_reverse = 0;  // host build: run the lanes in reverse order
#define SPD_SRC(src) Ls[src]
#define SPD_SHFL(val, src) (val)
#define SPD_SYNC()
#define SPD_WARP(step)                                                      \
  do {                                                                      \
    for (int k_ = 0; k_ < SPD_LANES; ++k_) {                                \
      const int lane = spd_lane_reverse ? SPD_LANES - 1 - k_ : k_;          \
      SpdLane& L = Ls[lane];                                                \
      step;                                                                 \
    }                                                                       \
  } while (0)
SPD_DEV SpdF4 spd_ld4(const float* p) { SpdF4 v; memcpy(&v, p, sizeof v); return v; }
SPD_DEV SpdF2 spd_ld2(const float* p) { SpdF2 v; memcpy(&v, p, sizeof v); return v; }
SPD_DEV void spd_st4(float* p, SpdF4 v) { memcpy(p, &v, sizeof v); }
SPD_DEV float spd_fma(float a, float b, float c) { return fmaf(a, b, c); }
SPD_DEV float spd_rsqrt(float x) { return 1.0f / sqrtf(x); }
SPD_DEV int spd_late_index(int e) { return e; }
#endif

// SPD_FULL_SEGS from its definition: a segment starts at (r, c0), and a
// float past the end of row r is (r + 1, c <= 1), in the lower triangle.
constexpr unsigned spd_full_segs(int k) {
  unsigned m = 0;
  for (int lane = 0; lane < SPD_LANES; ++lane) {
    const int q = lane + SPD_LANES * k, r = 4 * q / SPD_N, c0 = 4 * q - r * SPD_N;
    bool full = q < SPD_SEGS;
    for (int e = 0; e < 4; ++e) full = full && (c0 + e >= SPD_N || c0 + e <= r);
    if (full) m |= 1u << lane;
  }
  return m;
}
constexpr unsigned spd_full_table[SPD_SEG_ROUNDS] = SPD_FULL_SEGS;
static_assert(spd_full_table[0] == spd_full_segs(0) && spd_full_table[1] == spd_full_segs(1) &&
                  spd_full_table[2] == spd_full_segs(2) && spd_full_table[3] == spd_full_segs(3) &&
                  spd_full_table[4] == spd_full_segs(4) && spd_full_table[5] == spd_full_segs(5),
              "SPD_FULL_SEGS is stale");

// Load: the lower triangle into the warp's slice, b into v. The wholly lower
// segments by rounds of 16-byte loads; then each lane its own row's lower
// entries in straddling segments: those of the diagonal's segment (unless
// the diagonal ends it) and, on odd rows (which start 8 bytes into a
// segment), the row's first two.
SPD_DEV void spd_stage(SpdWarp* s, SpdLane& L, const float* A, const float* b, int lane) {
  const unsigned full[SPD_SEG_ROUNDS] = SPD_FULL_SEGS;
  SPD_UNROLL for (int k = 0; k < SPD_SEG_ROUNDS; ++k) {
    const int t = 4 * (lane + SPD_LANES * k);
    if ((full[k] >> lane) & 1u) spd_st4(s->a + t, spd_ld4(A + t));
  }
  if (lane < SPD_N) {
    const int d = (SPD_N + 1) * lane, r0 = SPD_N * lane;
    const int lo = (d & 3) == 3 ? d + 1 : ((d & ~3) > r0 ? d & ~3 : r0);
    SPD_UNROLL for (int e = 0; e < 3; ++e)
      if (lo + e <= d) s->a[lo + e] = A[lo + e];
    SPD_UNROLL for (int e = 0; e < 2; ++e)
      if ((lane & 1) && r0 + e < lo) s->a[r0 + e] = A[r0 + e];
  }
  L.v = lane < SPD_N ? b[lane] : 0.f;
}

// Each lane takes its row (zeros above the diagonal and on lanes >= n).
SPD_DEV void spd_take_row(const SpdWarp* s, SpdLane& L, int lane) {
  const int i = lane < SPD_N ? lane : -1;
  const float* r = s->a + SPD_N * (i < 0 ? 0 : i);
  SPD_UNROLL for (int p = 0; p < SPD_N / 2; ++p) {
    SpdF2 t = {0.f, 0.f};
    if (2 * p <= i) t = spd_ld2(r + 2 * p);
    L.row[2 * p] = t.x;
    L.row[2 * p + 1] = 2 * p + 1 <= i ? t.y : 0.f;
  }
}

// Before step 0: every lane takes rsqrt of lane 0's diagonal.
SPD_DEV void spd_first_pivot(SpdLane& L, const SpdLane* Ls) {
  (void)Ls;
  L.dj = spd_rsqrt(SPD_SHFL(SPD_SRC(0).row[0], 0));
}

// Step j, first half: the pivot's rsqrt scales column j. Lanes below form
// L[i][j]; lane j swaps its pivot sum (s_j, no longer needed: lane j + 1's
// shuffle carried it) for its forward sum v_j, which scales to y_j. Each
// lane files the result in column j, where the next half-step and the back
// substitution read it; every lane forms its row's next pivot sum as far as its own L[i][j]
// reaches it, which is lane j + 1's whole sum. Lanes above j form entries no
// lane reads.
SPD_DEV void spd_pivot(SpdWarp* s, SpdLane& L, int lane, int j) {
  if (lane == j) L.row[j] = L.v;
  L.row[j] = L.row[j] * L.dj;
  // lane 31, which holds no row, files d_j in column j's last slot
  s->col[spd_slot(j, lane)] = lane == SPD_LANES - 1 ? L.dj : L.row[j];
  if (j + 1 < SPD_N) L.pn = spd_fma(-L.row[j], L.row[j], L.row[j + 1]);
}

// Step j, second half: the next pivot's rsqrt from lane j + 1's sum; rows
// below subtract L[i][j] L[c][j] and L[i][j] y_j (the updates of lanes
// i <= j fall above the diagonal, where no lane reads).
SPD_DEV void spd_update(const SpdWarp* s, SpdLane& L, const SpdLane* Ls, int lane, int j) {
  (void)Ls;
  L.dj = spd_rsqrt(SPD_SHFL(SPD_SRC(j + 1).pn, j + 1));
  // the column's 16-byte words; a long column in two halves, so that it and
  // the rows fit 64 registers
  const float* col = s->col + SPD_LANES * j;
  const int q0 = j / 4, qh = j < SPD_SPLIT ? (q0 + SPD_QUADS + 1) / 2 : SPD_QUADS;
  float cv[4 * SPD_QUADS];
  SPD_UNROLL for (int h = 0; h < 2; ++h) {
    const int qa = h ? qh : q0, qb = h ? SPD_QUADS : qh;
    if (h && qa == qb) break;
    if (h) {
      SPD_SYNC();
    }
    SPD_UNROLL for (int q = qa; q < qb; ++q) {
      const int qp = q ^ (j >> 2);  // the word's place in the swizzled column
      const SpdF4 t = spd_ld4(col + 4 * qp);
      const float w[4] = {t.x, t.y, t.z, t.w};
      SPD_UNROLL for (int e = 0; e < 4; ++e) cv[(4 * qp + e) ^ j] = w[e];
    }
    SPD_UNROLL for (int c = (h ? 4 * qa : j + 1); c < SPD_N && c < 4 * qb; ++c)
      L.row[c] = spd_fma(-L.row[j], cv[c], L.row[c]);
  }
  const float v = spd_fma(-L.row[j], cv[j], L.v);
  if (lane > j) L.v = v;
}

// After the factor: y_i = v_i d_i.
SPD_DEV void spd_forward_end(const SpdWarp* s, SpdLane& L, int lane) {
  L.d = lane < SPD_N ? s->col[spd_slot(lane, SPD_LANES - 1)] : 0.f;
  L.v = L.v * L.d;
}

// Back substitution L^T x = y, step k: x_k goes to every lane; rows above
// subtract L[k][i] x_k.
SPD_DEV void spd_back(const SpdWarp* s, SpdLane& L, const SpdLane* Ls, int lane, int k) {
  (void)Ls;
  const float lk = lane < k ? s->col[spd_slot(lane, k)] : 0.f;
  const float xk = SPD_SHFL(SPD_SRC(k).v * SPD_SRC(k).d, k);
  const float v = spd_fma(-lk, xk, L.v);
  if (lane < k) L.v = v;
}

SPD_DEV void spd_store(const SpdLane& L, float* x, int lane) {
  if (lane < SPD_N) x[lane] = L.v * L.d;
}

// System e. On the card `Ls` is this lane's state alone.
SPD_DEV void spd_system(SpdWarp* s, SpdLane* Ls, const float* A, const float* b, float* x,
                        int e, int lane_id) {
#ifdef __CUDACC__
  SpdLane& L = Ls[0];
  const int lane = lane_id;
#else
  (void)lane_id;
#endif
  SPD_WARP(spd_stage(s, L, A + (size_t)e * SPD_N * SPD_N, b + (size_t)e * SPD_N, lane));
  SPD_SYNC();
  SPD_WARP(spd_take_row(s, L, lane));
  SPD_SYNC();  // L's columns overwrite the staged matrix
  SPD_WARP(spd_first_pivot(L, Ls));
  SPD_UNROLL for (int j = 0; j < SPD_N; ++j) {
    SPD_WARP(spd_pivot(s, L, lane, j));
    if (j + 1 == SPD_N) break;
    SPD_SYNC();
    SPD_WARP(spd_update(s, L, Ls, lane, j));
  }
  SPD_SYNC();
  SPD_WARP(spd_forward_end(s, L, lane));
  SPD_UNROLL for (int k = SPD_N - 1; k > 0; --k) SPD_WARP(spd_back(s, L, Ls, lane, k));
  SPD_WARP(spd_store(L, x + (size_t)spd_late_index(e) * SPD_N, lane));
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(SPD_THREADS, SPD_MIN_BLOCKS)
    spd_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, int n_sys) {
  __shared__ SpdWarp sh[SPD_WARPS];
  const int w = threadIdx.x / SPD_LANES;
  const int e = blockIdx.x * SPD_WARPS + w;
  if (e >= n_sys) return;  // the whole warp leaves together
  SpdLane L;
  spd_system(&sh[w], &L, A, b, x, e, threadIdx.x % SPD_LANES);
}
#endif

extern "C" {

int spd_solve_dim() { return SPD_N; }

#ifdef __CUDACC__
// Shared bytes per block, resident blocks per SM and systems per block.
int spd_solve_occupancy(int* smem, int* blocks_per_sm, int* per_block) {
  *smem = SPD_WARPS * (int)sizeof(SpdWarp);
  *per_block = SPD_WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, spd_solve_kernel,
                                                            SPD_THREADS, 0);
}

int spd_solve_launch(const float* A, const float* b, float* x, int n_sys, int n,
                     void* stream) {
  if (n != SPD_N || n_sys < 1 || ((size_t)A & 15)) return (int)cudaErrorInvalidValue;
  int blocks = (n_sys + SPD_WARPS - 1) / SPD_WARPS;
  spd_solve_kernel<<<blocks, SPD_THREADS, 0, (cudaStream_t)stream>>>(A, b, x, n_sys);
  return (int)cudaGetLastError();
}
#else
// Host build of the same code (no CUDA): blocks in a loop, each system's
// phases a loop over the lanes (in reverse order after lane_order_host(1)).
void lane_order_host(int reverse) { spd_lane_reverse = reverse; }

int spd_solve_host(const float* A, const float* b, float* x, int n_sys, int n) {
  if (n != SPD_N) return 1;
  const int blocks = (n_sys + SPD_WARPS - 1) / SPD_WARPS;
  for (int blk = 0; blk < blocks; ++blk)
    for (int w = 0; w < SPD_WARPS; ++w) {
      const int e = blk * SPD_WARPS + w;
      if (e >= n_sys) break;
      SpdWarp s;
      memset(&s, 0, sizeof s);
      SpdLane Ls[SPD_LANES];
      memset(Ls, 0, sizeof Ls);
      spd_system(&s, Ls, A, b, x, e, 0);
    }
  return 0;
}
#endif

}  // extern "C"
