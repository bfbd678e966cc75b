// Per-env lane physics of the DexHand scene, shared by the two kernels that
// run it: control_step.cu (K2, the physics-only control step and the
// spawn-projection min_site_z) and fused_step.cu (K1, the whole env step).
//
// Replaces the lane simulator of dexrobot_isaac_tpu/physics/pallas_step.py
// (build_lane_sim: fk_lane, contact_force, substep, min_site_z), which both
// TPU kernels inline. One CUDA thread runs one env; the state is SoA rows x N
// with envs contiguous (row r of env i at r*N + i), so every warp load and
// store is coalesced. The model constants (tree, attach frames, joint axes,
// inertias, collision spheres, pruned self-collision pairs, sites, limits,
// gains) are DATA in a LaneModel buffer built once by the wrapper
// (physics/lane_step.py), not trace-time unrolled code: loops run over bodies
// with parent[i] < i.
//
// Simple first design: per-body arrays (26 x pos/quat/linvel/angvel, the
// sparse mass matrix, the contact accumulators) live in per-thread local
// memory. Register pressure and spills are its known cost; a warp or block
// per env group with shared memory is later work.
//
// Per substep, as pallas_step.py substep: FK + velocity propagation, penalty
// contacts (sphere-ground, pruned finger pairs, sphere-box, box corners-
// ground) with the impulse clamp, gravity and contact wrenches summed per
// subtree, CRBA composite inertias -> mass matrix on ancestor pairs, the
// implicit-PD system, the zero-fill-in leaf-to-root LTL factorization and
// its two triangular solves, integration with joint-limit projection, and
// box integration with velocity caps.
//
// The file also compiles as plain C++ (no __CUDACC__), so the same arithmetic
// can be built for the host.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define LP_DEV __device__ __forceinline__
#define LP_RSQRT(x) rsqrtf(x)
#else
#define LP_DEV static inline
#define LP_RSQRT(x) (1.0f / sqrtf(x))
#endif

#define LP_MAXB 26     // bodies = DOFs
#define LP_MAXD 12     // max ancestor-chain depth (incl. self)
#define LP_MAXS 48     // collision spheres
#define LP_MAXSC 96    // pruned self-collision pairs
#define LP_MAXSITE 16  // sites

// X-macro field list: the struct below and the layout table the wrapper
// builds its numpy record from (lane_model_layout), so the layout is written
// down here only. S = scalar, A = array. Every field is 4 bytes wide.
#define LANE_MODEL_FIELDS(S, A)                                              \
  S(int, nb) S(int, ns) S(int, n_sc) S(int, nsite) S(int, total_substeps)    \
  S(int, has_box)                                                            \
  S(float, h) S(float, inv_h) S(float, gz) S(float, k_contact)               \
  S(float, d_contact) S(float, k_friction) S(float, beta_inv_h)              \
  S(float, max_depen) S(float, mu_hg) S(float, mu_hb) S(float, mu_bg)        \
  S(float, mu_hh) S(float, box_mass) S(float, box_inertia) S(float, half)    \
  A(int, parent, LP_MAXB) A(int, is_prism, LP_MAXB)                          \
  A(int, has_post, LP_MAXB) A(int, depth, LP_MAXB)                           \
  A(int, anc, LP_MAXB * LP_MAXD)                                             \
  A(float, axis, LP_MAXB * 3) A(float, apos, LP_MAXB * 3)                    \
  A(float, aquat, LP_MAXB * 4) A(float, post, LP_MAXB * 4)                   \
  A(float, mass, LP_MAXB) A(float, subtree_mass, LP_MAXB)                    \
  A(float, com, LP_MAXB * 3) A(float, inertia, LP_MAXB * 9)                  \
  A(float, lower, LP_MAXB) A(float, upper, LP_MAXB) A(float, kp, LP_MAXB)    \
  A(float, kd, LP_MAXB) A(float, arm, LP_MAXB)                               \
  A(int, sb, LP_MAXS) A(float, spos, LP_MAXS * 3) A(float, srad, LP_MAXS)    \
  A(float, smeff, LP_MAXS)                                                   \
  A(int, sc_i, LP_MAXSC) A(int, sc_j, LP_MAXSC) A(float, sc_rsum, LP_MAXSC)  \
  A(float, sc_meff, LP_MAXSC)                                                \
  A(int, site_b, LP_MAXSITE) A(float, site_pos, LP_MAXSITE * 3)              \
  A(float, site_quat, LP_MAXSITE * 4)

#define LP_DECL_S(t, n) t n;
#define LP_DECL_A(t, n, c) t n[c];
struct LaneModel {
  LANE_MODEL_FIELDS(LP_DECL_S, LP_DECL_A)
};

// Body of a host function reporting a struct's layout from its X-macro field
// list: for each of the first `cap` fields its byte offset, element count (0
// for a scalar) and float-ness; the names as one comma-separated string and
// the struct size. Returns the number of fields. The wrapper builds the numpy
// dtype of its record from this (physics/lane_step.py struct_dtype).
#define LP_OFF(t, n, c) \
  if (k < cap) { offsets[k] = (int)offsetof(LP_T, n); counts[k] = c; is_float[k] = (t)0.5 != (t)0; } \
  ++k;
#define LP_OFF_S(t, n) LP_OFF(t, n, 0)
#define LP_OFF_A(t, n, c) LP_OFF(t, n, c)
#define LP_NAME_S(t, n) #n ","
#define LP_NAME_A(t, n, c) #n ","
#define LP_STRUCT_LAYOUT(T, FIELDS) \
  typedef T LP_T;                    \
  int k = 0;                         \
  FIELDS(LP_OFF_S, LP_OFF_A)         \
  *size = (int)sizeof(T);            \
  *names = FIELDS(LP_NAME_S, LP_NAME_A); \
  return k;
#define LP_LAYOUT_ARGS \
  int cap, int *offsets, int *counts, int *is_float, int *size, const char **names

// ---------------------------------------------------------------- vec math
LP_DEV void lp_qmul(const float* a, const float* b, float* o) {
  float x = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  float y = a[3] * b[1] + a[1] * b[3] + a[2] * b[0] - a[0] * b[2];
  float z = a[3] * b[2] + a[0] * b[1] + a[2] * b[3] - a[1] * b[0];
  float w = a[3] * b[3] - (a[0] * b[0] + a[1] * b[1] + a[2] * b[2]);
  o[0] = x; o[1] = y; o[2] = z; o[3] = w;
}

LP_DEV void lp_qrot(const float* q, const float* v, float* o) {
  float tx = 2.0f * (q[1] * v[2] - q[2] * v[1]);
  float ty = 2.0f * (q[2] * v[0] - q[0] * v[2]);
  float tz = 2.0f * (q[0] * v[1] - q[1] * v[0]);
  float x = v[0] + q[3] * tx + q[1] * tz - q[2] * ty;
  float y = v[1] + q[3] * ty + q[2] * tx - q[0] * tz;
  float z = v[2] + q[3] * tz + q[0] * ty - q[1] * tx;
  o[0] = x; o[1] = y; o[2] = z;
}

LP_DEV void lp_qrot_inv(const float* q, const float* v, float* o) {
  float c[4] = {-q[0], -q[1], -q[2], q[3]};
  lp_qrot(c, v, o);
}

LP_DEV void lp_cross(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

LP_DEV float lp_dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// row-major 3x3 rotation from an xyzw quaternion
LP_DEV void lp_rotmat(const float* q, float* R) {
  float xx = q[0] * q[0], yy = q[1] * q[1], zz = q[2] * q[2];
  float xy = q[0] * q[1], xz = q[0] * q[2], yz = q[1] * q[2];
  float wx = q[3] * q[0], wy = q[3] * q[1], wz = q[3] * q[2];
  R[0] = 1.0f - 2.0f * (yy + zz); R[1] = 2.0f * (xy - wz); R[2] = 2.0f * (xz + wy);
  R[3] = 2.0f * (xy + wz); R[4] = 1.0f - 2.0f * (xx + zz); R[5] = 2.0f * (yz - wx);
  R[6] = 2.0f * (xz - wy); R[7] = 2.0f * (yz + wx); R[8] = 1.0f - 2.0f * (xx + yy);
}

LP_DEV void lp_matvec(const float* R, const float* v, float* o) {
  float x = R[0] * v[0] + R[1] * v[1] + R[2] * v[2];
  float y = R[3] * v[0] + R[4] * v[1] + R[5] * v[2];
  float z = R[6] * v[0] + R[7] * v[1] + R[8] * v[2];
  o[0] = x; o[1] = y; o[2] = z;
}

LP_DEV void lp_matTvec(const float* R, const float* v, float* o) {
  float x = R[0] * v[0] + R[3] * v[1] + R[6] * v[2];
  float y = R[1] * v[0] + R[4] * v[1] + R[7] * v[2];
  float z = R[2] * v[0] + R[5] * v[1] + R[8] * v[2];
  o[0] = x; o[1] = y; o[2] = z;
}

// ---------------------------------------------------------------- FK
struct LpFk {
  float pos[LP_MAXB][3], quat[LP_MAXB][4], lin[LP_MAXB][3], ang[LP_MAXB][3];
  float axw[LP_MAXB][3], orig[LP_MAXB][3];
};

// FK + velocity propagation over the tree (pallas_step.py fk_lane).
LP_DEV void lp_fk(const LaneModel* m, const float* q, const float* qd,
                  const float* spawn, LpFk* k) {
  const float ident[4] = {0.f, 0.f, 0.f, 1.f};
  const float zero3[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < m->nb; ++i) {
    int p = m->parent[i];
    const float *pp, *pq, *pv, *pw;
    if (p < 0) {
      pp = spawn; pq = ident; pv = zero3; pw = zero3;
    } else {
      pp = k->pos[p]; pq = k->quat[p]; pv = k->lin[p]; pw = k->ang[p];
    }
    float o[3], jq[4], a_w[3], t[3], d[3], v_o[3];
    lp_qrot(pq, &m->apos[3 * i], t);
    for (int c = 0; c < 3; ++c) o[c] = pp[c] + t[c];
    lp_qmul(pq, &m->aquat[4 * i], jq);
    lp_qrot(jq, &m->axis[3 * i], a_w);
    for (int c = 0; c < 3; ++c) d[c] = o[c] - pp[c];
    lp_cross(pw, d, t);
    for (int c = 0; c < 3; ++c) v_o[c] = pv[c] + t[c];
    float* bp = k->pos[i];
    float* bq = k->quat[i];
    float* bv = k->lin[i];
    float* bw = k->ang[i];
    if (m->is_prism[i]) {
      for (int c = 0; c < 3; ++c) bp[c] = o[c] + a_w[c] * q[i];
      for (int c = 0; c < 4; ++c) bq[c] = jq[c];
      for (int c = 0; c < 3; ++c) d[c] = bp[c] - o[c];
      lp_cross(pw, d, t);
      for (int c = 0; c < 3; ++c) bv[c] = v_o[c] + t[c] + a_w[c] * qd[i];
      for (int c = 0; c < 3; ++c) bw[c] = pw[c];
    } else {
      for (int c = 0; c < 3; ++c) bp[c] = o[c];
      float hq = q[i] * 0.5f;
      float sq = sinf(hq), cq = cosf(hq);
      const float* ax = &m->axis[3 * i];
      float jr[4] = {ax[0] * sq, ax[1] * sq, ax[2] * sq, cq};
      lp_qmul(jq, jr, bq);
      for (int c = 0; c < 3; ++c) bv[c] = v_o[c];
      for (int c = 0; c < 3; ++c) bw[c] = pw[c] + a_w[c] * qd[i];
    }
    if (m->has_post[i]) {
      float tq[4];
      lp_qmul(bq, &m->post[4 * i], tq);
      for (int c = 0; c < 4; ++c) bq[c] = tq[c];
    }
    for (int c = 0; c < 3; ++c) { k->axw[i][c] = a_w[c]; k->orig[i][c] = o[c]; }
  }
}

LP_DEV void lp_site(const LaneModel* m, const LpFk* k, int s, float* pos, float* quat) {
  int b = m->site_b[s];
  float t[3];
  lp_qrot(k->quat[b], &m->site_pos[3 * s], t);
  for (int c = 0; c < 3; ++c) pos[c] = k->pos[b][c] + t[c];
  lp_qmul(k->quat[b], &m->site_quat[4 * s], quat);
}

// Lowest world z over the sites in `site_mask` at pose q, zero velocity
// (pallas_step.py min_site_z): the spawn-validity projection's FK, shared by
// the factory's reset path and the fused kernel's reset rows.
LP_DEV float lp_min_site_z(const LaneModel* m, const float* q, const float* spawn,
                           int site_mask, LpFk* k) {
  float qd0[LP_MAXB];
  for (int i = 0; i < m->nb; ++i) qd0[i] = 0.f;
  lp_fk(m, q, qd0, spawn, k);
  float mz = INFINITY;
  for (int s = 0; s < m->nsite; ++s) {
    if (!((site_mask >> s) & 1)) continue;
    int b = m->site_b[s];
    float t[3];
    lp_qrot(k->quat[b], &m->site_pos[3 * s], t);
    float z = k->pos[b][2] + t[2];
    mz = fminf(mz, z);
  }
  return mz;
}

// ---------------------------------------------------------------- contacts
// Penalty contact force on the first body (pallas_step.py contact_force):
// spring-damper bounded by the one-substep stopping impulse; friction capped
// by Coulomb and the tangential impulse. rel is the PREDICTED relative
// velocity; mt is the tangential clamp mass.
LP_DEV void lp_contact_force(const LaneModel* m, float depth, const float* n,
                             const float* rel, float mu, float meff, float mt,
                             float* f) {
  float active = depth > 0.f ? 1.f : 0.f;
  float vn = lp_dot(rel, n);
  float fn_spring = m->k_contact * depth - m->d_contact * vn;
  float corr = fminf(m->beta_inv_h * depth, m->max_depen);
  float fn_imp = (meff * m->inv_h) * (-vn + corr);
  float fn = fmaxf(fminf(fn_spring, fn_imp), 0.f) * active;
  float vt[3];
  for (int c = 0; c < 3; ++c) vt[c] = rel[c] - n[c] * vn;
  float vt_n = sqrtf(lp_dot(vt, vt) + 1e-12f);
  float ft = fminf(fminf(m->k_friction * vt_n, mu * fn), (mt * m->inv_h) * vt_n);
  float s = -ft / (vt_n + 1e-6f);
  for (int c = 0; c < 3; ++c) f[c] = n[c] * fn + vt[c] * s;
}

// Sphere s (world pos sp) vs the box in its frame: geometry shared by the
// active-count pass and the force pass.
struct LpBoxGeo {
  float loc[3], cl[3], d[3], gap[3], dist;
};

LP_DEV float lp_box_geo(const LaneModel* m, const float* R, const float* bpos,
                        const float* sp, float r, LpBoxGeo* g) {
  float rel[3] = {sp[0] - bpos[0], sp[1] - bpos[1], sp[2] - bpos[2]};
  lp_matTvec(R, rel, g->loc);
  for (int c = 0; c < 3; ++c) {
    g->cl[c] = fminf(fmaxf(g->loc[c], -m->half), m->half);
    g->d[c] = g->loc[c] - g->cl[c];
    g->gap[c] = m->half - fabsf(g->loc[c]);
  }
  g->dist = sqrtf(lp_dot(g->d, g->d) + 1e-18f);
  float gap_min = fminf(fminf(g->gap[0], g->gap[1]), g->gap[2]);
  return g->dist > 1e-9f ? r - g->dist : r + gap_min;
}

struct LpScratch {
  LpFk fk;
  float sp[LP_MAXS][3], sv[LP_MAXS][3];
  float bF[LP_MAXB][3], bN[LP_MAXB][3];
  float T[LP_MAXB][6], K[LP_MAXB][3];
  float ftop[LP_MAXB][3], fbot[LP_MAXB][3];
  float M[LP_MAXB][LP_MAXD];  // M[b][t]: entry (anc[b][t], b); t = depth-1 is the diagonal
  float Q[LP_MAXB], rhs[LP_MAXB], inv_d[LP_MAXB], w[LP_MAXB], qdn[LP_MAXB];
};

LP_DEV void lp_add3(float* a, const float* b) { a[0] += b[0]; a[1] += b[1]; a[2] += b[2]; }
LP_DEV void lp_sub3(float* a, const float* b) { a[0] -= b[0]; a[1] -= b[1]; a[2] -= b[2]; }

// One integrator substep (pallas_step.py substep). q, qd (nb), box (13) are
// updated in place; cf (nb*3) and bf (3) receive this substep's reported
// body contact forces and the box's net contact force.
LP_DEV void lp_substep(const LaneModel* m, float* q, float* qd, float* box,
                       const float* tgt, const float* spawn, const float* drv,
                       float* cf, float* bf, LpScratch* s) {
  const int nb = m->nb;
  const float h = m->h, gz = m->gz;
  const float kp_s = drv[0], kd_s = drv[1], bm_s = drv[2], fr_s = drv[3];
  LpFk* k = &s->fk;
  lp_fk(m, q, qd, spawn, k);

  for (int i = 0; i < nb; ++i)
    for (int c = 0; c < 3; ++c) { cf[3 * i + c] = 0.f; s->bF[i][c] = 0.f; s->bN[i][c] = 0.f; }
  float box_f[3] = {0.f, 0.f, 0.f}, box_t[3] = {0.f, 0.f, 0.f};

  for (int j = 0; j < m->ns; ++j) {
    int b = m->sb[j];
    float t[3], d[3];
    lp_qrot(k->quat[b], &m->spos[3 * j], t);
    for (int c = 0; c < 3; ++c) s->sp[j][c] = k->pos[b][c] + t[c];
    for (int c = 0; c < 3; ++c) d[c] = s->sp[j][c] - k->pos[b][c];
    lp_cross(k->ang[b], d, t);
    for (int c = 0; c < 3; ++c) s->sv[j][c] = k->lin[b][c] + t[c];
  }

  const float* bpos = box;
  const float* bquat = box + 3;
  const float* blin = box + 7;
  const float* bang = box + 10;
  float Rb[9];
  float inv_box_mass = 0.f, inv_box_in = 0.f, share_bm = 0.f;
  if (m->has_box) {
    inv_box_mass = 1.0f / (m->box_mass * bm_s);
    inv_box_in = 1.0f / (m->box_inertia * bm_s);
    lp_rotmat(bquat, Rb);
    float n_act = 0.f;
    for (int j = 0; j < m->ns; ++j) {
      LpBoxGeo g;
      float depth = lp_box_geo(m, Rb, bpos, s->sp[j], m->srad[j], &g);
      n_act += depth > 0.f ? 1.f : 0.f;
    }
    share_bm = fmaxf(n_act, 1.0f) * inv_box_mass;
  }

  const float up[3] = {0.f, 0.f, 1.f};
  for (int j = 0; j < m->ns; ++j) {
    int b = m->sb[j];
    const float* sp = s->sp[j];
    const float* sv = s->sv[j];
    float r = m->srad[j], meff = m->smeff[j];
    float f[3];
    lp_contact_force(m, r - sp[2], up, sv, m->mu_hg * fr_s, meff, meff, f);
    if (m->has_box) {
      LpBoxGeo g;
      lp_box_geo(m, Rb, bpos, sp, r, &g);
      bool outside = g.dist > 1e-9f;
      bool m01 = g.gap[0] < g.gap[1];
      bool m2 = (m01 ? g.gap[0] : g.gap[1]) < g.gap[2];
      bool sel0 = m01 && m2, sel1 = !m01 && m2, sel2 = !m2;
      float nl[3], surf[3], nw[3], r_c[3], t[3], rel[3];
      float inv = 1.0f / (g.dist + 1e-9f);
      if (outside) {
        for (int c = 0; c < 3; ++c) { nl[c] = g.d[c] * inv; surf[c] = g.cl[c]; }
      } else {
        nl[0] = sel0 ? (g.loc[0] >= 0.f ? 1.f : -1.f) : 0.f;
        nl[1] = sel1 ? (g.loc[1] >= 0.f ? 1.f : -1.f) : 0.f;
        nl[2] = sel2 ? (g.loc[2] >= 0.f ? 1.f : -1.f) : 0.f;
        for (int c = 0; c < 3; ++c) surf[c] = g.loc[c];
      }
      float depth_b = outside ? r - g.dist
                              : r + (sel0 ? g.gap[0] : (sel1 ? g.gap[1] : g.gap[2]));
      lp_matvec(Rb, nl, nw);
      lp_matvec(Rb, surf, r_c);
      lp_cross(bang, r_c, t);
      for (int c = 0; c < 3; ++c) rel[c] = sv[c] - (blin[c] + t[c]);
      rel[2] = rel[2] - gz * h;  // the box's gravity kick (rel = sphere - box)
      float rxn[3];
      lp_cross(r_c, nw, rxn);
      float ang_n = lp_dot(rxn, rxn) * inv_box_in;
      float m_red_n = 1.0f / (1.0f / meff + share_bm + ang_n);
      float vn_p = lp_dot(rel, nw);
      float vt_p[3];
      for (int c = 0; c < 3; ++c) vt_p[c] = rel[c] - nw[c] * vn_p;
      float vt_p_n = sqrtf(lp_dot(vt_p, vt_p) + 1e-18f);
      float it = 1.0f / (vt_p_n + 1e-9f);
      float t_hat[3] = {vt_p[0] * it, vt_p[1] * it, vt_p[2] * it};
      float rxt[3];
      lp_cross(r_c, t_hat, rxt);
      float ang_t = lp_dot(rxt, rxt) * inv_box_in;
      float m_red_t = 1.0f / (1.0f / meff + share_bm + ang_t);
      float fb[3], react[3];
      lp_contact_force(m, depth_b, nw, rel, m->mu_hb * fr_s, m_red_n, m_red_t, fb);
      lp_add3(f, fb);
      for (int c = 0; c < 3; ++c) react[c] = -fb[c];
      lp_add3(box_f, react);
      lp_cross(r_c, react, t);
      lp_add3(box_t, t);
    }
    float t[3];
    lp_add3(&cf[3 * b], f);
    lp_add3(s->bF[b], f);
    lp_cross(sp, f, t);
    lp_add3(s->bN[b], t);
  }

  // finger-finger self-collision over the pruned pairs: +f on sphere i at its
  // center, -f on sphere j
  for (int p = 0; p < m->n_sc; ++p) {
    int si = m->sc_i[p], sj = m->sc_j[p];
    int bi = m->sb[si], bj = m->sb[sj];
    float d3[3], rel[3], n3[3], f[3], t[3];
    for (int c = 0; c < 3; ++c) {
      d3[c] = s->sp[si][c] - s->sp[sj][c];
      rel[c] = s->sv[si][c] - s->sv[sj][c];
    }
    float dist = sqrtf(lp_dot(d3, d3) + 1e-18f);
    float inv = 1.0f / (dist + 1e-9f);
    for (int c = 0; c < 3; ++c) n3[c] = d3[c] * inv;
    lp_contact_force(m, m->sc_rsum[p] - dist, n3, rel, m->mu_hh * fr_s,
                     m->sc_meff[p], m->sc_meff[p], f);
    lp_add3(&cf[3 * bi], f);
    lp_add3(s->bF[bi], f);
    lp_cross(s->sp[si], f, t);
    lp_add3(s->bN[bi], t);
    lp_sub3(&cf[3 * bj], f);
    lp_sub3(s->bF[bj], f);
    lp_cross(s->sp[sj], f, t);
    lp_sub3(s->bN[bj], t);
  }

  if (m->has_box) {
    // box corners vs ground
    for (int c8 = 0; c8 < 8; ++c8) {
      float cl[3] = {(c8 & 4) ? m->half : -m->half, (c8 & 2) ? m->half : -m->half,
                     (c8 & 1) ? m->half : -m->half};
      float cw[3], r_c[3], t[3], vc[3], fc[3];
      lp_matvec(Rb, cl, t);
      for (int c = 0; c < 3; ++c) { cw[c] = bpos[c] + t[c]; r_c[c] = cw[c] - bpos[c]; }
      float cwz = cw[2];
      lp_cross(bang, r_c, t);
      for (int c = 0; c < 3; ++c) vc[c] = blin[c] + t[c];
      vc[2] = vc[2] + gz * h;  // the box is the first body here: its kick adds
      lp_cross(r_c, up, t);
      float ang8 = lp_dot(t, t) * inv_box_in;
      float m_c = 1.0f / (4.0f * inv_box_mass + ang8);
      lp_contact_force(m, -cwz, up, vc, m->mu_bg * fr_s, m_c, m_c, fc);
      lp_add3(box_f, fc);
      lp_cross(r_c, fc, t);
      lp_add3(box_t, t);
    }
  }

  // gravity at each body's COM, then subtree sums (children before parents)
  float Rall[LP_MAXB][9], cw_all[LP_MAXB][3];
  for (int i = 0; i < nb; ++i) {
    if (m->mass[i] == 0.f) continue;
    lp_rotmat(k->quat[i], Rall[i]);
    float t[3];
    lp_matvec(Rall[i], &m->com[3 * i], t);
    for (int c = 0; c < 3; ++c) cw_all[i][c] = k->pos[i][c] + t[c];
    float fg[3] = {0.f, 0.f, m->mass[i] * gz};
    s->bF[i][2] += fg[2];
    lp_cross(cw_all[i], fg, t);
    lp_add3(s->bN[i], t);
  }
  for (int i = nb - 1; i >= 0; --i) {
    int p = m->parent[i];
    if (p >= 0) { lp_add3(s->bF[p], s->bF[i]); lp_add3(s->bN[p], s->bN[i]); }
  }
  // motion subspace S_j = (ang, lin): prismatic (0, a), revolute (a, o x a)
  float Sa[LP_MAXB][3], Sl[LP_MAXB][3];
  for (int j = 0; j < nb; ++j) {
    if (m->is_prism[j]) {
      for (int c = 0; c < 3; ++c) { Sa[j][c] = 0.f; Sl[j][c] = k->axw[j][c]; }
      s->Q[j] = lp_dot(k->axw[j], s->bF[j]);
    } else {
      for (int c = 0; c < 3; ++c) Sa[j][c] = k->axw[j][c];
      lp_cross(k->orig[j], k->axw[j], Sl[j]);
      s->Q[j] = lp_dot(Sa[j], s->bN[j]) + lp_dot(Sl[j], s->bF[j]);
    }
  }

  // CRBA: per body about the world origin T = Ic_w - m [c]x[c]x (6 terms of
  // the symmetric 3x3), K = m c; composited over subtrees
  for (int i = 0; i < nb; ++i) {
    float mi = m->mass[i];
    if (mi == 0.f) {
      for (int c = 0; c < 6; ++c) s->T[i][c] = 0.f;
      for (int c = 0; c < 3; ++c) s->K[i][c] = 0.f;
      continue;
    }
    const float* R = Rall[i];
    const float* Ic = &m->inertia[9 * i];
    const float* cw = cw_all[i];
    float RI[9];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        RI[3 * a + c] = R[3 * a + 0] * Ic[c] + R[3 * a + 1] * Ic[3 + c] + R[3 * a + 2] * Ic[6 + c];
    const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
    float c2 = lp_dot(cw, cw);
    for (int e = 0; e < 6; ++e) {
      int a = ia[e], c = ib[e];
      float icw = RI[3 * a] * R[3 * c] + RI[3 * a + 1] * R[3 * c + 1] + RI[3 * a + 2] * R[3 * c + 2];
      float cc = cw[a] * cw[c];
      if (a == c) cc = cc - c2;
      s->T[i][e] = icw - mi * cc;
    }
    for (int c = 0; c < 3; ++c) s->K[i][c] = cw[c] * mi;
  }
  for (int i = nb - 1; i >= 0; --i) {
    int p = m->parent[i];
    if (p < 0) continue;
    for (int c = 0; c < 6; ++c) s->T[p][c] += s->T[i][c];
    lp_add3(s->K[p], s->K[i]);
  }
  // f_j = Ic_j S_j: ftop = T a + K x v ; fbot = -(K x a) + m v
  for (int j = 0; j < nb; ++j) {
    const float* a3 = Sa[j];
    const float* v3 = Sl[j];
    const float* t6 = s->T[j];
    float Ta[3] = {t6[0] * a3[0] + t6[1] * a3[1] + t6[2] * a3[2],
                   t6[1] * a3[0] + t6[3] * a3[1] + t6[4] * a3[2],
                   t6[2] * a3[0] + t6[4] * a3[1] + t6[5] * a3[2]};
    float kv[3], ka[3];
    lp_cross(s->K[j], v3, kv);
    lp_cross(s->K[j], a3, ka);
    float ms = m->subtree_mass[j];
    for (int c = 0; c < 3; ++c) {
      s->ftop[j][c] = Ta[c] + kv[c];
      s->fbot[j][c] = v3[c] * ms - ka[c];
    }
  }
  // mass matrix on ancestor pairs: entry (i, b) = S_i . f_b for i in anc(b)
  for (int b = 0; b < nb; ++b) {
    int D = m->depth[b];
    for (int t = 0; t < D; ++t) {
      int i = m->anc[b * LP_MAXD + t];
      s->M[b][t] = lp_dot(Sa[i], s->ftop[b]) + lp_dot(Sl[i], s->fbot[b]);
    }
  }
  // implicit PD: A = M + diag(arm + h kd + h^2 kp); rhs = (M + arm) qd + h(kp(tgt - q) + Q)
  for (int i = 0; i < nb; ++i) s->rhs[i] = 0.f;
  for (int b = 0; b < nb; ++b) {
    int D = m->depth[b];
    for (int t = 0; t < D; ++t) {
      int a = m->anc[b * LP_MAXD + t];
      s->rhs[b] += s->M[b][t] * qd[a];
      if (a != b) s->rhs[a] += s->M[b][t] * qd[b];
    }
  }
  for (int i = 0; i < nb; ++i) {
    float kp_i = m->kp[i] * kp_s;
    float acc = s->rhs[i] + m->arm[i] * qd[i];
    s->rhs[i] = acc + h * (kp_i * (tgt[i] - q[i]) + s->Q[i]);
    int D = m->depth[i];
    s->M[i][D - 1] = s->M[i][D - 1] + m->arm[i] + (h * m->kd[i]) * kd_s + (h * h) * kp_i;
  }
  // sparse LTL factorization, leaf to root (zero fill-in: L's nonzeros are
  // exactly the ancestor pairs; parent[i] < i)
  for (int kk = nb - 1; kk >= 0; --kk) {
    int D = m->depth[kk];
    float d = LP_RSQRT(s->M[kk][D - 1]);
    s->inv_d[kk] = d;
    s->M[kk][D - 1] *= d;
    for (int t = 0; t < D - 1; ++t) s->M[kk][t] *= d;
    for (int ii = 0; ii < D - 1; ++ii) {
      int i = m->anc[kk * LP_MAXD + ii];  // i's chain is anc[kk][0..ii]
      for (int jj = 0; jj <= ii; ++jj) s->M[i][jj] -= s->M[kk][ii] * s->M[kk][jj];
    }
  }
  // L^T w = rhs: descendants feed ancestors (descending)
  for (int i = 0; i < nb; ++i) s->w[i] = s->rhs[i];
  for (int i = nb - 1; i >= 0; --i) {
    s->w[i] *= s->inv_d[i];
    int D = m->depth[i];
    for (int t = 0; t < D - 1; ++t) s->w[m->anc[i * LP_MAXD + t]] -= s->M[i][t] * s->w[i];
  }
  // L qd' = w: ancestors feed descendants (ascending)
  for (int i = 0; i < nb; ++i) {
    float v = s->w[i];
    int D = m->depth[i];
    for (int t = 0; t < D - 1; ++t) v -= s->M[i][t] * s->qdn[m->anc[i * LP_MAXD + t]];
    s->qdn[i] = v * s->inv_d[i];
  }
  // integration with joint-limit projection
  for (int i = 0; i < nb; ++i) {
    float v = s->qdn[i];
    float qn = q[i] + h * v;
    float lo = m->lower[i], up_ = m->upper[i];
    bool low_hit = qn < lo, high_hit = qn > up_;
    qn = fminf(fmaxf(qn, lo), up_);
    if (low_hit && v < 0.f) v = 0.f;
    if (high_hit && v > 0.f) v = 0.f;
    q[i] = qn;
    qd[i] = v;
  }

  // box integration with PhysX-style velocity caps
  if (m->has_box) {
    float lv[3] = {blin[0] + h * (box_f[0] * inv_box_mass),
                   blin[1] + h * (box_f[1] * inv_box_mass),
                   blin[2] + h * (box_f[2] * inv_box_mass + gz)};
    float hs = h * inv_box_in;
    float av[3] = {bang[0] + box_t[0] * hs, bang[1] + box_t[1] * hs, bang[2] + box_t[2] * hs};
    float ln = sqrtf(lp_dot(lv, lv) + 1e-18f);
    float ls = fminf(1.0f, 10.0f / (ln + 1e-9f));
    for (int c = 0; c < 3; ++c) lv[c] *= ls;
    float an = sqrtf(lp_dot(av, av) + 1e-18f);
    float as = fminf(1.0f, 64.0f / (an + 1e-9f));
    for (int c = 0; c < 3; ++c) av[c] *= as;
    float oq[4] = {av[0], av[1], av[2], 0.f}, dq[4], qn4[4];
    lp_qmul(oq, bquat, dq);
    for (int c = 0; c < 4; ++c) qn4[c] = bquat[c] + 0.5f * h * dq[c];
    float nrm = sqrtf(qn4[0] * qn4[0] + qn4[1] * qn4[1] + qn4[2] * qn4[2] + qn4[3] * qn4[3] + 1e-18f);
    float inrm = 1.0f / nrm;
    for (int c = 0; c < 3; ++c) box[c] = bpos[c] + lv[c] * h;
    for (int c = 0; c < 4; ++c) box[3 + c] = qn4[c] * inrm;
    for (int c = 0; c < 3; ++c) { box[7 + c] = lv[c]; box[10 + c] = av[c]; }
  }
  for (int c = 0; c < 3; ++c) bf[c] = box_f[c];
}

// Column loads/stores of SoA rows (row r of env i at r*n + i).
LP_DEV void lp_load(const float* src, int rows, int n, int i, float* dst) {
  for (int r = 0; r < rows; ++r) dst[r] = src[(size_t)r * n + i];
}

LP_DEV void lp_store(float* dst, int rows, int n, int i, const float* src) {
  for (int r = 0; r < rows; ++r) dst[(size_t)r * n + i] = src[r];
}
