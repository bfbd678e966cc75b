// K2: the physics-only control step, and the spawn-projection min_site_z.
//
// Replaces the TPU kernel of dexrobot_isaac_tpu/physics/pallas_step.py
// build_control_step (kernel, pallas_call at :1141) and the lane min_site_z
// (:986) that the factory's reset closure traces. One thread per env runs
// `total_substeps` substeps of lane_physics.cuh, then the final FK and the
// site poses, and writes them as rows x N (envs contiguous).
//
// What bounds it on the H100: per env it reads q, qd, targets (26 each),
// spawn (3), box (13), DR (4) = 98 floats and writes q, qd (26 each), box
// (13), contact forces (78), box force (3) and the kinematics rows (26*19 +
// 10*7 = 564) = 710 floats: ~3.2 KB/env, ~13 MB at 4096 envs, ~4 us at
// 3.35 TB/s. The 16 substeps carry ~5e5 f32 FLOPs/env (FK, 39 spheres x
// ground/box, 40 pairs, CRBA, LTL), ~2e9 at 4096 envs, ~30 us at 67 TFLOP/s:
// the FLOPs bound it. This simple design does not come near that: one thread
// per env fills only 128 warps at 4096 envs (under one per SM), and the
// per-body arrays sit in local memory. Blocks of 32 threads spread those
// warps over all SMs. A warp or block per env group, with the state in shared
// memory and registers, is later work.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#include "lane_physics.cuh"

#define LP_THREADS 32

LP_DEV void cs_env(const LaneModel* m, int i, int n, const float* q_in, const float* qd_in,
                   const float* tgt_in, const float* spawn_in, const float* box_in,
                   const float* dr_in, float* q_out, float* qd_out, float* box_out,
                   float* cf_out, float* bf_out, float* kin_out) {
  const int nb = m->nb;
  float q[LP_MAXB], qd[LP_MAXB], tgt[LP_MAXB], spawn[3], box[13], drv[4];
  float cf[LP_MAXB * 3], bf[3] = {0.f, 0.f, 0.f};
  lp_load(q_in, nb, n, i, q);
  lp_load(qd_in, nb, n, i, qd);
  lp_load(tgt_in, nb, n, i, tgt);
  lp_load(spawn_in, 3, n, i, spawn);
  lp_load(box_in, 13, n, i, box);
  lp_load(dr_in, 4, n, i, drv);
  for (int c = 0; c < nb * 3; ++c) cf[c] = 0.f;
  LpScratch s;
  for (int it = 0; it < m->total_substeps; ++it)
    lp_substep(m, q, qd, box, tgt, spawn, drv, cf, bf, &s);
  lp_store(q_out, nb, n, i, q);
  lp_store(qd_out, nb, n, i, qd);
  lp_store(box_out, 13, n, i, box);
  lp_store(cf_out, nb * 3, n, i, cf);
  lp_store(bf_out, 3, n, i, bf);
  // final-state kinematics rows: per body pos3 | quat4 | lin3 | ang3 | axis3
  // | anchor3 (group-major), then per site pos3, then per site quat4
  LpFk* k = &s.fk;
  lp_fk(m, q, qd, spawn, k);
  size_t r = 0;
#define KPUT(v) kin_out[(r++) * n + i] = (v)
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 3; ++c) KPUT(k->pos[b][c]);
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 4; ++c) KPUT(k->quat[b][c]);
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 3; ++c) KPUT(k->lin[b][c]);
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 3; ++c) KPUT(k->ang[b][c]);
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 3; ++c) KPUT(k->axw[b][c]);
  for (int b = 0; b < nb; ++b) for (int c = 0; c < 3; ++c) KPUT(k->orig[b][c]);
  float sp[LP_MAXSITE][3], sq[LP_MAXSITE][4];
  for (int st = 0; st < m->nsite; ++st) lp_site(m, k, st, sp[st], sq[st]);
  for (int st = 0; st < m->nsite; ++st) for (int c = 0; c < 3; ++c) KPUT(sp[st][c]);
  for (int st = 0; st < m->nsite; ++st) for (int c = 0; c < 4; ++c) KPUT(sq[st][c]);
#undef KPUT
}

LP_DEV void msz_env(const LaneModel* m, int i, int n, const float* q_in,
                    const float* spawn_in, int site_mask, float* out) {
  float q[LP_MAXB], spawn[3];
  lp_load(q_in, m->nb, n, i, q);
  lp_load(spawn_in, 3, n, i, spawn);
  LpFk k;
  out[i] = lp_min_site_z(m, q, spawn, site_mask, &k);
}

#ifdef __CUDACC__
__global__ void control_step_kernel(const LaneModel* __restrict__ m,
                                    const float* __restrict__ q, const float* __restrict__ qd,
                                    const float* __restrict__ tgt,
                                    const float* __restrict__ spawn,
                                    const float* __restrict__ box, const float* __restrict__ dr,
                                    float* __restrict__ q_out, float* __restrict__ qd_out,
                                    float* __restrict__ box_out, float* __restrict__ cf_out,
                                    float* __restrict__ bf_out, float* __restrict__ kin_out,
                                    int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  cs_env(m, i, n, q, qd, tgt, spawn, box, dr, q_out, qd_out, box_out, cf_out, bf_out, kin_out);
}

__global__ void min_site_z_kernel(const LaneModel* __restrict__ m, const float* __restrict__ q,
                                  const float* __restrict__ spawn, int site_mask,
                                  float* __restrict__ out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  msz_env(m, i, n, q, spawn, site_mask, out);
}
#endif

extern "C" {

int lane_model_layout(LP_LAYOUT_ARGS) {
  LP_STRUCT_LAYOUT(LaneModel, LANE_MODEL_FIELDS)
}

#ifdef __CUDACC__
int control_step_launch(const void* model, const float* q, const float* qd,
                        const float* tgt, const float* spawn, const float* box,
                        const float* dr, float* q_out, float* qd_out, float* box_out,
                        float* cf_out, float* bf_out, float* kin_out, int n,
                        void* stream) {
  int blocks = (n + LP_THREADS - 1) / LP_THREADS;
  control_step_kernel<<<blocks, LP_THREADS, 0, (cudaStream_t)stream>>>(
      (const LaneModel*)model, q, qd, tgt, spawn, box, dr, q_out, qd_out, box_out,
      cf_out, bf_out, kin_out, n);
  return (int)cudaGetLastError();
}

int min_site_z_launch(const void* model, const float* q, const float* spawn,
                      int site_mask, float* out, int n, void* stream) {
  int blocks = (n + LP_THREADS - 1) / LP_THREADS;
  min_site_z_kernel<<<blocks, LP_THREADS, 0, (cudaStream_t)stream>>>(
      (const LaneModel*)model, q, spawn, site_mask, out, n);
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-env code (no CUDA): every env in a loop.
int control_step_host(const void* model, const float* q, const float* qd, const float* tgt,
                      const float* spawn, const float* box, const float* dr, float* q_out,
                      float* qd_out, float* box_out, float* cf_out, float* bf_out,
                      float* kin_out, int n) {
  for (int i = 0; i < n; ++i)
    cs_env((const LaneModel*)model, i, n, q, qd, tgt, spawn, box, dr, q_out, qd_out, box_out,
           cf_out, bf_out, kin_out);
  return 0;
}

int min_site_z_host(const void* model, const float* q, const float* spawn, int site_mask,
                    float* out, int n) {
  for (int i = 0; i < n; ++i) msz_env((const LaneModel*)model, i, n, q, spawn, site_mask, out);
  return 0;
}
#endif

}  // extern "C"
