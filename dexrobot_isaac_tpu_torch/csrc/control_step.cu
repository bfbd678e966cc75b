// K2: the physics-only control step, and the spawn-projection min_site_z.
//
// Replaces the TPU kernel of dexrobot_isaac_tpu/physics/pallas_step.py
// build_control_step (kernel, pallas_call at :1141) and the lane min_site_z
// (:986) that the factory's reset closure traces. A half-warp per env (the
// design of lane_physics.cuh) runs `total_substeps` substeps, then the final
// FK and the site poses; LP_ENVS envs share a block.
//
// What bounds it on the H100: per env it reads q, qd, targets (26 each),
// spawn (3), box (13), DR (4) = 98 floats and writes q, qd (26 each), box
// (13), contact forces (78), box force (3) and the kinematics rows (26*19 +
// 10*7 = 564) = 710 floats: ~3.2 KB/env, ~13 MB at 4096 envs, ~4 us at
// 3.35 TB/s. The 16 substeps carry ~5e5 f32 FLOPs/env (FK, 39 spheres x
// ground/box, 40 pairs, CRBA, LTL), ~2e9 at 4096 envs, ~30 us at 67 TFLOP/s:
// the FLOPs bound it. The two-cube build (-DLP_HAS_BOX2=1, its own library)
// adds 13 box rows in and out and 3 box-force rows, and per substep 39
// spheres vs the second box, its 8 corners and 16 cube-cube corners, in a
// second contact pass over the first's words. The half-warp design is
// bound by its serial phases; what hides their latency is the number of
// envs resident per SM (the shared slot per env, LpEnv, and the registers
// per thread: 32 envs in both builds).
//
// The rows x N layout (envs contiguous) is kept: the block stages its envs'
// columns through shared memory, each row read and written by consecutive
// threads on consecutive envs. The inputs land in the envs' LpEnv fields;
// the kinematics rows are assembled in the LpEnv union, dead after the last
// substep.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "lane_physics.cuh"

// min_site_z's slot per pose
struct MszEnv {
  float kin[LP_MAXB][LP_KIN];
  float q[LP_MAXB], spawn[3], zs[LP_MAXSITE], out;
};

// One env's control step (half-warp): substeps, final FK, then q, qd, box, cf,
// bf stay in s and the kinematics rows go to the union: per body pos3 |
// quat4 | lin3 | ang3 | axis3 | anchor3 (group-major), then per site pos3,
// then per site quat4.
LP_DEV void cs_env(const LaneModel* m, LpEnv* s, LpLane* Ls) {
  for (int it = 0; it < m->total_substeps; ++it) lp_substep(m, s, Ls);
  lp_fk(m, s->q, s->qd, s->spawn, s->kin, (float (*)[6])0, Ls);
  float* out = (float*)&s->u;
  const int nb = m->nb, nsite = m->nsite;
  LP_WARP(LP_EACH_BODY(k, i,
    const float* ki = s->kin[i];
    for (int c = 0; c < 3; ++c) {
      out[3 * i + c] = ki[c];
      out[nb * 7 + 3 * i + c] = ki[7 + c];
      out[nb * 10 + 3 * i + c] = ki[10 + c];
      out[nb * 13 + 3 * i + c] = L.axw[k][c];
      out[nb * 16 + 3 * i + c] = L.orig[k][c];
    }
    for (int c = 0; c < 4; ++c) out[nb * 3 + 4 * i + c] = ki[3 + c];)
  for (int st = lane; st < nsite; st += LP_W)
    lp_site(m, s->kin, st, &out[nb * 19 + 3 * st], &out[nb * 19 + nsite * 3 + 4 * st]););
}

// The block's envs: stage in, a half-warp per env, stage out. `tid`/`nthr` are
// the block's threads (the host build: 0 and 1).
#define CS_STRIDE ((int)(sizeof(LpEnv) / sizeof(float)))
LP_DEV void cs_stage_in(const LaneModel* m, LpEnv* envs, int e0, int n, const float* q,
                        const float* qd, const float* tgt, const float* spawn,
                        const float* box, const float* dr, int tid, int nthr) {
  const int nb = m->nb;
  lp_stage_in(q, nb, n, e0, envs[0].q, CS_STRIDE, tid, nthr);
  lp_stage_in(qd, nb, n, e0, envs[0].qd, CS_STRIDE, tid, nthr);
  lp_stage_in(tgt, nb, n, e0, envs[0].tgt, CS_STRIDE, tid, nthr);
  lp_stage_in(spawn, 3, n, e0, envs[0].spawn, CS_STRIDE, tid, nthr);
  lp_stage_in(box, LP_BOX_ROWS, n, e0, envs[0].box, CS_STRIDE, tid, nthr);
  lp_stage_in(dr, 4, n, e0, envs[0].drv, CS_STRIDE, tid, nthr);
}

LP_DEV void cs_stage_out(const LaneModel* m, const LpEnv* envs, int e0, int n, float* q_out,
                         float* qd_out, float* box_out, float* cf_out, float* bf_out,
                         float* kin_out, int tid, int nthr) {
  const int nb = m->nb;
  lp_stage_out(q_out, nb, n, e0, envs[0].q, CS_STRIDE, tid, nthr);
  lp_stage_out(qd_out, nb, n, e0, envs[0].qd, CS_STRIDE, tid, nthr);
  lp_stage_out(box_out, LP_BOX_ROWS, n, e0, envs[0].box, CS_STRIDE, tid, nthr);
  lp_stage_out(cf_out, nb * 3, n, e0, envs[0].cf, CS_STRIDE, tid, nthr);
  lp_stage_out(bf_out, LP_BF_ROWS, n, e0, envs[0].bf, CS_STRIDE, tid, nthr);
  lp_stage_out(kin_out, nb * 19 + m->nsite * 7, n, e0, (const float*)&envs[0].u, CS_STRIDE,
               tid, nthr);
}

#define MSZ_STRIDE ((int)(sizeof(MszEnv) / sizeof(float)))
LP_DEV void msz_env(const LaneModel* m, MszEnv* s, int site_mask, LpLane* Ls) {
  lp_min_site_z(m, s->q, s->spawn, site_mask, s->kin, s->zs, &s->out, Ls);
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(LP_THREADS, LP_MIN_BLOCKS)
    control_step_kernel(const LaneModel* __restrict__ m, const float* __restrict__ q,
                        const float* __restrict__ qd, const float* __restrict__ tgt,
                        const float* __restrict__ spawn, const float* __restrict__ box,
                        const float* __restrict__ dr, float* __restrict__ q_out,
                        float* __restrict__ qd_out, float* __restrict__ box_out,
                        float* __restrict__ cf_out, float* __restrict__ bf_out,
                        float* __restrict__ kin_out, int n) {
  extern __shared__ float lp_smem[];
  LpEnv* envs = (LpEnv*)lp_smem;
  const int e0 = blockIdx.x * LP_ENVS, tid = threadIdx.x, nthr = blockDim.x;
  cs_stage_in(m, envs, e0, n, q, qd, tgt, spawn, box, dr, tid, nthr);
  __syncthreads();
  const int e = tid / LP_W;
  const bool live = e0 + e < n;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (live) {  // the env's half-warp takes the branch together
    LpLane L;
    L.mask = mask;
    cs_env(m, &envs[e], &L);
  }
  __syncthreads();
  cs_stage_out(m, envs, e0, n, q_out, qd_out, box_out, cf_out, bf_out, kin_out, tid, nthr);
}

__global__ void __launch_bounds__(LP_THREADS)
    min_site_z_kernel(const LaneModel* __restrict__ m, const float* __restrict__ q,
                      const float* __restrict__ spawn, int site_mask,
                      float* __restrict__ out, int n) {
  extern __shared__ float lp_smem[];
  MszEnv* envs = (MszEnv*)lp_smem;
  const int e0 = blockIdx.x * LP_ENVS, tid = threadIdx.x, nthr = blockDim.x;
  lp_stage_in(q, m->nb, n, e0, envs[0].q, MSZ_STRIDE, tid, nthr);
  lp_stage_in(spawn, 3, n, e0, envs[0].spawn, MSZ_STRIDE, tid, nthr);
  __syncthreads();
  const int e = tid / LP_W;
  const bool live = e0 + e < n;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (live) {
    LpLane L;
    L.mask = mask;
    msz_env(m, &envs[e], site_mask, &L);
  }
  __syncthreads();
  lp_stage_out(out, 1, n, e0, &envs[0].out, MSZ_STRIDE, tid, nthr);
}
#endif

extern "C" {

int lane_model_layout(LP_LAYOUT_ARGS) {
  LP_STRUCT_LAYOUT(LaneModel, LANE_MODEL_FIELDS)
}

// The lane kernel's static sizes the model buffer must respect: mass-matrix
// entries and lanes per env; and whether this build carries the second box.
int lane_caps(int* max_m, int* lanes_per_env, int* has_box2) {
  *max_m = LP_MAXM;
  *lanes_per_env = LP_W;
  *has_box2 = LP_HAS_BOX2;
  return 0;
}

// Shared memory per env of K2 and of min_site_z, envs per block, and the
// design's budget per env (bytes).
int control_step_shared(int* cs_bytes, int* msz_bytes, int* envs_per_block, int* budget) {
  *cs_bytes = (int)sizeof(LpEnv);
  *msz_bytes = (int)sizeof(MszEnv);
  *envs_per_block = LP_ENVS;
  *budget = LP_SHARED_BUDGET;
  return 0;
}

#ifdef __CUDACC__
// Shared bytes per block and resident blocks per SM of both kernels.
int control_step_occupancy(int* cs_smem, int* cs_blocks, int* msz_smem, int* msz_blocks) {
  *cs_smem = LP_ENVS * (int)sizeof(LpEnv);
  *msz_smem = LP_ENVS * (int)sizeof(MszEnv);
  int err = lp_prepare(control_step_kernel, *cs_smem, cs_blocks);
  return err ? err : lp_prepare(min_site_z_kernel, *msz_smem, msz_blocks);
}

int control_step_launch(const void* model, const float* q, const float* qd,
                        const float* tgt, const float* spawn, const float* box,
                        const float* dr, float* q_out, float* qd_out, float* box_out,
                        float* cf_out, float* bf_out, float* kin_out, int n,
                        void* stream) {
  static int ready = -1;
  const int smem = LP_ENVS * (int)sizeof(LpEnv);
  if (ready < 0) ready = lp_prepare(control_step_kernel, smem, (int*)0);
  if (ready) return ready;
  int blocks = (n + LP_ENVS - 1) / LP_ENVS;
  control_step_kernel<<<blocks, LP_THREADS, smem, (cudaStream_t)stream>>>(
      (const LaneModel*)model, q, qd, tgt, spawn, box, dr, q_out, qd_out, box_out,
      cf_out, bf_out, kin_out, n);
  return (int)cudaGetLastError();
}

int min_site_z_launch(const void* model, const float* q, const float* spawn,
                      int site_mask, float* out, int n, void* stream) {
  static int ready = -1;
  const int smem = LP_ENVS * (int)sizeof(MszEnv);
  if (ready < 0) ready = lp_prepare(min_site_z_kernel, smem, (int*)0);
  if (ready) return ready;
  int blocks = (n + LP_ENVS - 1) / LP_ENVS;
  min_site_z_kernel<<<blocks, LP_THREADS, smem, (cudaStream_t)stream>>>(
      (const LaneModel*)model, q, spawn, site_mask, out, n);
  return (int)cudaGetLastError();
}
#else
// Host build of the same code (no CUDA): blocks in a loop, each warp phase a
// loop over the lanes (in reverse order after lane_order_host(1)).
void lane_order_host(int reverse) { lp_lane_reverse = reverse; }

int control_step_host(const void* model, const float* q, const float* qd, const float* tgt,
                      const float* spawn, const float* box, const float* dr, float* q_out,
                      float* qd_out, float* box_out, float* cf_out, float* bf_out,
                      float* kin_out, int n) {
  const LaneModel* m = (const LaneModel*)model;
  LpEnv* envs = new LpEnv[LP_ENVS];
  LpLane Ls[LP_W];
  for (int e0 = 0; e0 < n; e0 += LP_ENVS) {
    cs_stage_in(m, envs, e0, n, q, qd, tgt, spawn, box, dr, 0, 1);
    for (int e = 0; e < LP_ENVS && e0 + e < n; ++e) cs_env(m, &envs[e], Ls);
    cs_stage_out(m, envs, e0, n, q_out, qd_out, box_out, cf_out, bf_out, kin_out, 0, 1);
  }
  delete[] envs;
  return 0;
}

int min_site_z_host(const void* model, const float* q, const float* spawn, int site_mask,
                    float* out, int n) {
  const LaneModel* m = (const LaneModel*)model;
  MszEnv envs[LP_ENVS];
  LpLane Ls[LP_W];
  for (int e0 = 0; e0 < n; e0 += LP_ENVS) {
    lp_stage_in(q, m->nb, n, e0, envs[0].q, MSZ_STRIDE, 0, 1);
    lp_stage_in(spawn, 3, n, e0, envs[0].spawn, MSZ_STRIDE, 0, 1);
    for (int e = 0; e < LP_ENVS && e0 + e < n; ++e) msz_env(m, &envs[e], site_mask, Ls);
    lp_stage_out(out, 1, n, e0, &envs[0].out, MSZ_STRIDE, 0, 1);
  }
  return 0;
}
#endif

}  // extern "C"
