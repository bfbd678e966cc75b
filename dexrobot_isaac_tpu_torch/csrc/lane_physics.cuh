// Per-env lane physics of the DexHand scene, shared by the two kernels that
// run it: control_step.cu (K2, the physics-only control step and the
// spawn-projection min_site_z) and fused_step.cu (K1, the whole env step).
//
// Replaces the lane simulator of dexrobot_isaac_tpu/physics/pallas_step.py
// (build_lane_sim: fk_lane, contact_force, substep, min_site_z), which both
// TPU kernels inline. The model constants (tree, attach frames, joint axes,
// inertias, collision spheres, pruned self-collision pairs, sites, limits,
// gains, and the tree's levels, child lists and per-body contact lists) are
// DATA in a LaneModel buffer built once by the wrapper (physics/lane_step.py),
// not trace-time unrolled code. Lanes read it through the read-only data
// path (a const __restrict__ global pointer): they index it by body and
// sphere, which constant memory would serialize, and a copy in each block's
// shared memory (~20 KB) cuts residency from 32 to 24 envs per SM, which
// measured slower (utils/lane_probe.py `model_shared`).
//
// Design: a half-warp (LP_W = 16 lanes) per env, two envs per warp, LP_ENVS
// envs per block. Each lane owns up to two of the 26 bodies (its slots,
// LaneModel.slot_body: each tree level in one slot, so a level phase runs
// one slot); lane 15 also owns the box, and in the two-cube build
// (LP_HAS_BOX2, a separate library) lane 14 owns the second box. What
// another lane must read lives in the env's slice of shared memory (LpEnv);
// what only the owner reads lives in that lane's registers (LpLane). Each
// substep is a fixed sequence of phases separated by __syncwarp(); within a
// phase a lane writes only values no other lane reads in that phase.
//   1. FK and velocity propagation, one phase per tree level (root first;
//      the level is the body's depth - 1, LaneModel.depth, n_levels levels);
//      every lane first takes sin/cos of its bodies' half angles.
//   2. Sphere poses and velocities and the box-contact flags, lanes over the
//      39 spheres; then the forces, lanes over spheres (ground + box), the
//      40 finger pairs and the 8 box corners, each into its own slot.
//   3. Each body sums its own contacts (LaneModel.bc: its spheres, then its
//      pairs, then its spheres against the second box, in index order, as
//      the lane kernel does), adds gravity and forms its CRBA terms; the box
//      lane sums the box's contact wrench (spheres, then corners, then the
//      cube-cube terms) and integrates the box, the second box's lane the
//      same for its box. Neither box is read by the other lane here: the
//      cube-cube slots of phase 2 hold all either needs.
//   The two-cube build runs 2 and 3 as two passes over the same contact
//   words. Its flags (the first box's, the second box's and the 2 x 8
//   cube-cube corners', each cube's corners against the other) are lane
//   bitmasks (a ballot per 16 spheres), outside the union. Pass A is 2 as
//   above, then each body sums its spheres and pairs into its wrench
//   registers and cf, and the box lane the box's spheres and corners into
//   LpEnv.bw. Pass B writes, over A's slots (sp, sv carry over): the
//   spheres vs the second box (its own share count), its 8 corners vs the
//   ground and the cube-cube corners (each direction its own share count);
//   then each body adds its spheres against the second box to A's sums and
//   goes on with 3, and both boxes integrate, the first box after adding
//   the cube-cube terms to bw. Every sum keeps its order.
//   4. Subtree sums of the wrenches and of T/K, one phase per level, deepest
//      first; each body adds its children in descending index (the lane
//      kernel's order: children after their own subtrees, i descending).
//   5. Per body: Q_b and its row of the sparse mass matrix (ancestor pairs);
//      then its rhs entry (own row, then descendants ascending) and the
//      implicit-PD diagonal.
//   6. The zero-fill-in LTL factorization fused with the L^T w = rhs solve:
//      one phase per kk from nb-1 down; lanes run over the step's updates of
//      kk's ancestors' rows and w entries (one entry each, LaneModel.ltl),
//      with row kk scaled on the fly (every lane forms the same rsqrt), so
//      row kk is never written while read. Each row's own scaling is applied
//      when the forward solve reads it.
//   7. L qd' = w by level, root first, fused with the integration and the
//      joint-limit projection of each body's DOF.
// No sum is split and none is reordered: every element's arithmetic is the
// lane kernel's, in its order; no atomics, so the results are the same from
// run to run.
//
// What bounds it on the H100: ~5e5 f32 operations per env per control step
// (16 substeps), ~2e9 at 4096 envs, ~30 us at 67 TFLOP/s; its bytes are a
// tenth of that. This design is bound instead by its serial phases (10 FK
// levels, 9 subtree levels, 26 LTL steps and 10 forward levels per substep),
// in which few lanes work and each phase's latency chain (global model
// reads, shared loads, one rsqrt) must be hidden by the other resident
// env-warps: 32 envs (16 warps) per SM, the limit of both shared memory
// (LpEnv ~6 KB per env) and registers (<= 128 per thread), so 4096 envs run
// in one wave on 132 SMs. The two-cube build holds the same 32: in one
// contact buffer the second box's slots (39 sphere forces, its 39 + 8
// wrenches, 16 cube-cube corners) would grow the union from 808 to 1,416
// floats and K1's slot to 9,560 B, over the 7,168 B an env may take at 4
// blocks of 8 per SM ((233,472 / 4 - 1,024) / 8); the two passes need 768
// and 792 floats (the union 792, K1's slot ~7.1 KB), and each pass's
// working registers are one box's.
//
// The file also compiles as plain C++ (no __CUDACC__): each phase is a
// function run once per lane, and the host build loops over the lanes where
// the card has __syncwarp() (in forward or, for the lane-order test, reverse
// order).
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

#ifndef LP_HAS_BOX2
#define LP_HAS_BOX2 0  // 1: the build with the second free box (SimParams.has_box2)
#endif
#define LP_W 16        // lanes per env (a half-warp)
#define LP_SLOTS 2     // bodies per lane (LaneModel.slot_body)
#define LP_BOX_LANE (LP_W - 1)   // the lane that also owns the box
#define LP_BOX2_LANE (LP_W - 2)  // the lane that also owns the second box
#define LP_ENVS 8      // envs per block (4 warps)
#define LP_THREADS (LP_ENVS * LP_W)
// K1's and K2's blocks resident per SM, at least, in every build: 4 x 8 =
// 32 envs, which caps the registers per thread at 65536 / (4 x 128) = 128
#define LP_MIN_BLOCKS 4
// the design's shared memory per env: an SM's 228 KB over LP_MIN_BLOCKS
// blocks of LP_ENVS envs, less the 1 KB the card reserves per block
#define LP_SHARED_BUDGET ((233472 / LP_MIN_BLOCKS - 1024) / LP_ENVS)
#define LP_MAXB 26     // bodies = DOFs
#define LP_MAXD 12     // max ancestor-chain depth (incl. self)
#define LP_MAXM 208    // mass-matrix entries on ancestor pairs (sum of depths)
#define LP_MAXS 40     // collision spheres
#define LP_MAXSC 40    // pruned self-collision pairs
#define LP_MAXSITE 16  // sites
#define LP_MAXCH 8     // children per body
#define LP_MAXBC (LP_HAS_BOX2 ? 48 : 32)  // contacts per body (its spheres, its pairs[, its spheres vs the second box])
#define LP_KIN 13      // per body: pos3 quat4 lin3 ang3
#define LP_BOX_ROWS (LP_HAS_BOX2 ? 26 : 13)  // box state rows (pos3 quat4 lin3 ang3 per box)
#define LP_BF_ROWS (LP_HAS_BOX2 ? 6 : 3)     // box contact-force rows
#define LP_FLAG_WORDS ((LP_MAXS + LP_W - 1) / LP_W)  // the two-cube build's flag words per box
#define LP_TRI (LP_MAXD * (LP_MAXD - 1) / 2)  // LTL updates per step, at most
#define LP_TRI_ROUNDS 3  // LTL updates per lane held in registers at once

// X-macro field list: the struct below and the layout table the wrapper
// builds its numpy record from (lane_model_layout), so the layout is written
// down here only. S = scalar, A = array. Every field is 4 bytes wide.
// bc entries: force slot (spheres 0..ns-1, then pairs, then the spheres
// against the second box) | arm sphere << 8 |
// 1 << 16 where the force acts with a minus sign (a pair's second body).
// slot_body[k * LP_W + lane]: the lane's body in slot k, or -1; each tree
// level lies in one slot where it fits. ltl[kk * LP_TRI + e], for the e-th
// pair (ii, jj <= ii) of step kk's ancestor rows: index of M entry (anc[kk][ii],
// jj) | ii << 16 | jj << 24. desc[desc_off[i] .. desc_off[i + 1]): body i's
// descendants b, ascending: index of M entry (i, b) | b << 16.
#define LANE_MODEL_FIELDS(S, A)                                              \
  S(int, nb) S(int, ns) S(int, n_sc) S(int, nsite) S(int, total_substeps)    \
  S(int, has_box) S(int, n_levels)                                           \
  S(float, h) S(float, inv_h) S(float, gz) S(float, k_contact)               \
  S(float, d_contact) S(float, k_friction) S(float, beta_inv_h)              \
  S(float, max_depen) S(float, mu_hg) S(float, mu_hb) S(float, mu_bg)        \
  S(float, mu_hh) S(float, box_mass) S(float, box_inertia) S(float, half)    \
  S(int, has_box2) S(float, mu_hb2) S(float, mu_b2g) S(float, mu_bb)         \
  S(float, box2_mass) S(float, box2_inertia) S(float, half2)                 \
  A(int, parent, LP_MAXB) A(int, is_prism, LP_MAXB)                          \
  A(int, has_post, LP_MAXB) A(int, depth, LP_MAXB)                           \
  A(int, anc, LP_MAXB * LP_MAXD) A(int, moff, LP_MAXB)                       \
  A(int, desc_off, LP_MAXB + 1) A(int, desc, LP_MAXM)                       \
  A(int, nchild, LP_MAXB)                                                    \
  A(int, child, LP_MAXB * LP_MAXCH) A(int, nbc, LP_MAXB)                     \
  A(int, bc, LP_MAXB * LP_MAXBC) A(int, slot_body, LP_SLOTS * LP_W)         \
  A(int, ltl, LP_MAXB * LP_TRI)                                              \
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

LP_DEV void lp_add3(float* a, const float* b) { a[0] += b[0]; a[1] += b[1]; a[2] += b[2]; }
LP_DEV void lp_sub3(float* a, const float* b) { a[0] -= b[0]; a[1] -= b[1]; a[2] -= b[2]; }

// ---------------------------------------------------------------- env state
// Per substep, the contact phases (dead once each body has summed its own).
struct LpContactBuf {
  float sp[LP_MAXS][3], sv[LP_MAXS][3];  // sphere world position, velocity
  // hand-side force: spheres (ground + box), pairs
  float F[LP_MAXS + LP_MAXSC][3];
  float BW[LP_MAXS + 8][6];              // box-side force, torque: spheres, corners
#if !LP_HAS_BOX2
  float act[LP_MAXS];                    // 1 where the sphere touches the box
#endif
};

#if LP_HAS_BOX2
// The two-cube build's second contact pass, over the words of the first
// (LpContactBuf), whose sums are taken by then; sp and sv carry over.
struct LpContactBuf2 {
  float sp[LP_MAXS][3], sv[LP_MAXS][3];
  float F2[LP_MAXS][3];       // hand-side force of each sphere vs the second box
  float BW2[LP_MAXS + 8][6];  // the second box's side: spheres, corners
  // cube-cube corner c (0-7: the box's corners in the second box, 8-15 the
  // second box's in the box): the force on the corner's cube, its torque
  // about that cube, and the force's torque about the other cube
  float BB[16][9];
};
#endif

// Per substep, after the contact phases: the subtree sums, the sparse mass
// matrix and the two triangular solves.
struct LpTreeBuf {
  float W[LP_MAXB][6];  // wrench about the world origin: force, torque
  float T[LP_MAXB][6], K[LP_MAXB][3];  // CRBA: symmetric 3x3 (6 terms), m c
  float M[LP_MAXM];     // row b at moff[b]: entry (anc[b][t], b); t = depth-1 the diagonal
  float w[LP_MAXB], qdn[LP_MAXB], inv_d[LP_MAXB];
};

// One env's slice of shared memory: what crosses lanes.
struct LpEnv {
  float q[LP_MAXB], qd[LP_MAXB], tgt[LP_MAXB];
  float box[LP_BOX_ROWS], spawn[3], drv[4];
  float cf[LP_MAXB * 3], bf[LP_BF_ROWS];  // the last substep's contact forces
  float kin[LP_MAXB][LP_KIN];    // FK: pos3 quat4 lin3 ang3
  float S[LP_MAXB][6];           // motion subspace (ang3, lin3)
  float Rb[9];                   // the box's rotation
#if LP_HAS_BOX2
  float Rb2[9];                  // the second box's rotation
  float bw[6];                   // the box's contact wrench of pass A: force, torque
  // contact flags as lane bitmasks (bit l of word r: sphere 16 r + l): the
  // spheres vs the box, vs the second box; the cube-cube corners
  unsigned act[LP_FLAG_WORDS], act2[LP_FLAG_WORDS], actbb;
#endif
  union {
    LpContactBuf c;
#if LP_HAS_BOX2
    LpContactBuf2 c2;
#endif
    LpTreeBuf t;
  } u;  // also a kernel's output staging after the last substep
};
#define LP_UNION_FLOATS ((int)(sizeof(((LpEnv*)0)->u) / sizeof(float)))

// One lane's registers: values only their owner reads, for each of its
// bodies (slot k: body lane + LP_W * k).
struct LpLane {
  float sq[LP_SLOTS], cq[LP_SLOTS];           // sin, cos of the joint's half angle
  float axw[LP_SLOTS][3], orig[LP_SLOTS][3];  // joint axis and anchor, world (the last FK)
  float W[LP_SLOTS][6], T[LP_SLOTS][6], K[LP_SLOTS][3];  // wrench, CRBA terms (3 -> 4a)
  float Q[LP_SLOTS];                          // generalized force
  unsigned mask;                              // the warp's lanes with a live env
};

#ifdef __CUDACC__
#define LP_UNROLL _Pragma("unroll")
#else
#define LP_UNROLL
#endif

// Each of the lane's bodies: `i` is the body in slot `k`.
#define LP_EACH_BODY(k, i, ...)                        \
  LP_UNROLL for (int k = 0; k < LP_SLOTS; ++k) {       \
    const int i = m->slot_body[LP_W * k + lane];       \
    if (i >= 0) { __VA_ARGS__ }                        \
  }

// One phase: the statements run on every lane of the env's half-warp, then
// the lanes meet. On the card `Ls` points at the lane's own LpLane and the
// two envs of a warp run the same phases (the model fixes their sequence);
// on the host `Ls` holds the env's LP_W lanes and they run one after another.
#ifdef __CUDACC__
#define LP_WARP(...)                                  \
  do {                                                \
    {                                                 \
      const int lane = (int)(threadIdx.x % LP_W);     \
      LpLane& L = Ls[0];                              \
      (void)lane; (void)L;                            \
      __VA_ARGS__                                     \
    }                                                 \
    __syncwarp(Ls[0].mask);                           \
  } while (0)
#else
static int lp_lane_reverse = 0;  // host build: run the lanes in reverse order
#define LP_WARP(...)                                                        \
  do {                                                                      \
    for (int lp_k = 0; lp_k < LP_W; ++lp_k) {                               \
      const int lane = lp_lane_reverse ? LP_W - 1 - lp_k : lp_k;            \
      LpLane& L = Ls[lane];                                                 \
      (void)lane; (void)L;                                                  \
      __VA_ARGS__                                                           \
    }                                                                       \
  } while (0)
#endif

#if LP_HAS_BOX2
// In a phase: `word` (bit l: lane l's `pred`) written by lane 0, a ballot of
// the env's half-warp on the card; the host build ORs each lane in as it
// runs (the first lane to run starts the word). LP_POPC counts its bits.
#ifdef __CUDACC__
#define LP_BALLOT(word, pred, mask)                                            \
  do {                                                                         \
    const unsigned lp_b = __ballot_sync(mask, pred) >> (threadIdx.x & LP_W);  \
    if (lane == 0) (word) = lp_b & 0xffffu;                                    \
  } while (0)
#define LP_POPC(x) __popc(x)
#else
#define LP_BALLOT(word, pred, mask)                                            \
  do {                                                                         \
    const unsigned lp_b = (pred) ? 1u << lane : 0u;                            \
    (void)(mask);                                                              \
    (word) = lane == (lp_lane_reverse ? LP_W - 1 : 0) ? lp_b : (word) | lp_b;  \
  } while (0)
#define LP_POPC(x) __builtin_popcount(x)
#endif
#endif

// ---------------------------------------------------------------- FK
// Body i from its parent's pose and velocity (pallas_step.py fk_lane). qd
// may be null (zero velocity); S, when given, receives the motion subspace.
LP_DEV void lp_fk_body(const LaneModel* m, float (*kin)[LP_KIN], int i, float qi, float qdi,
                       float sq, float cq, const float* spawn, float* S, float* axw,
                       float* orig) {
  const float ident[4] = {0.f, 0.f, 0.f, 1.f};
  const float zero3[3] = {0.f, 0.f, 0.f};
  int p = m->parent[i];
  const float *pp, *pq, *pv, *pw;
  if (p < 0) {
    pp = spawn; pq = ident; pv = zero3; pw = zero3;
  } else {
    pp = kin[p]; pq = kin[p] + 3; pv = kin[p] + 7; pw = kin[p] + 10;
  }
  float o[3], jq[4], a_w[3], t[3], d[3], v_o[3];
  lp_qrot(pq, &m->apos[3 * i], t);
  for (int c = 0; c < 3; ++c) o[c] = pp[c] + t[c];
  lp_qmul(pq, &m->aquat[4 * i], jq);
  lp_qrot(jq, &m->axis[3 * i], a_w);
  for (int c = 0; c < 3; ++c) d[c] = o[c] - pp[c];
  lp_cross(pw, d, t);
  for (int c = 0; c < 3; ++c) v_o[c] = pv[c] + t[c];
  float bp[3], bq[4], bv[3], bw[3];
  if (m->is_prism[i]) {
    for (int c = 0; c < 3; ++c) bp[c] = o[c] + a_w[c] * qi;
    for (int c = 0; c < 4; ++c) bq[c] = jq[c];
    for (int c = 0; c < 3; ++c) d[c] = bp[c] - o[c];
    lp_cross(pw, d, t);
    for (int c = 0; c < 3; ++c) bv[c] = v_o[c] + t[c] + a_w[c] * qdi;
    for (int c = 0; c < 3; ++c) bw[c] = pw[c];
  } else {
    for (int c = 0; c < 3; ++c) bp[c] = o[c];
    const float* ax = &m->axis[3 * i];
    float jr[4] = {ax[0] * sq, ax[1] * sq, ax[2] * sq, cq};
    lp_qmul(jq, jr, bq);
    for (int c = 0; c < 3; ++c) bv[c] = v_o[c];
    for (int c = 0; c < 3; ++c) bw[c] = pw[c] + a_w[c] * qdi;
  }
  if (m->has_post[i]) {
    float tq[4];
    lp_qmul(bq, &m->post[4 * i], tq);
    for (int c = 0; c < 4; ++c) bq[c] = tq[c];
  }
  float* k = kin[i];
  for (int c = 0; c < 3; ++c) { k[c] = bp[c]; k[7 + c] = bv[c]; k[10 + c] = bw[c]; }
  for (int c = 0; c < 4; ++c) k[3 + c] = bq[c];
  for (int c = 0; c < 3; ++c) { axw[c] = a_w[c]; orig[c] = o[c]; }
  if (S) {  // S_j = (ang, lin): prismatic (0, a), revolute (a, o x a)
    if (m->is_prism[i]) {
      for (int c = 0; c < 3; ++c) { S[c] = 0.f; S[3 + c] = a_w[c]; }
    } else {
      for (int c = 0; c < 3; ++c) S[c] = a_w[c];
      lp_cross(o, a_w, S + 3);
    }
  }
}

// FK phase of tree level `lev` (bodies of depth lev + 1); at level 0 every
// lane first takes sin/cos of its own half angle.
LP_DEV void lp_fk_phase(const LaneModel* m, int lev, int lane, LpLane& L, const float* q,
                        const float* qd, const float* spawn, float (*kin)[LP_KIN],
                        float (*S)[6]) {
  LP_EACH_BODY(k, i,
    if (lev == 0) {
      float hq = q[i] * 0.5f;
      L.sq[k] = sinf(hq);
      L.cq[k] = cosf(hq);
    }
    if (m->depth[i] == lev + 1)
      lp_fk_body(m, kin, i, q[i], qd ? qd[i] : 0.f, L.sq[k], L.cq[k], spawn,
                 S ? S[i] : (float*)0, L.axw[k], L.orig[k]);)
}

// The whole FK of pose q (qd null: zero velocity) into kin, level by level.
LP_DEV void lp_fk(const LaneModel* m, const float* q, const float* qd, const float* spawn,
                  float (*kin)[LP_KIN], float (*S)[6], LpLane* Ls) {
  for (int lev = 0; lev < m->n_levels; ++lev)
    LP_WARP(lp_fk_phase(m, lev, lane, L, q, qd, spawn, kin, S););
}

LP_DEV void lp_site(const LaneModel* m, const float (*kin)[LP_KIN], int s, float* pos,
                    float* quat) {
  int b = m->site_b[s];
  float t[3];
  lp_qrot(kin[b] + 3, &m->site_pos[3 * s], t);
  for (int c = 0; c < 3; ++c) pos[c] = kin[b][c] + t[c];
  lp_qmul(kin[b] + 3, &m->site_quat[4 * s], quat);
}

// Lowest world z over the sites in `site_mask` at pose q, zero velocity
// (pallas_step.py min_site_z), into *out: the spawn-validity projection's FK,
// shared by the min_site_z kernel (the factory's reset path) and the fused
// kernel's reset rows. kin and zs (LP_MAXSITE floats) are scratch.
LP_DEV void lp_min_site_z(const LaneModel* m, const float* q, const float* spawn,
                          int site_mask, float (*kin)[LP_KIN], float* zs, float* out,
                          LpLane* Ls) {
  lp_fk(m, q, (const float*)0, spawn, kin, (float (*)[6])0, Ls);
  LP_WARP(for (int s = lane; s < m->nsite; s += LP_W) {
    int b = m->site_b[s];
    float t[3];
    lp_qrot(kin[b] + 3, &m->site_pos[3 * s], t);
    zs[s] = kin[b][2] + t[2];
  });
  LP_WARP(if (lane == 0) {
    float mz = INFINITY;
    for (int s = 0; s < m->nsite; ++s)
      if ((site_mask >> s) & 1) mz = fminf(mz, zs[s]);
    *out = mz;
  });
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

LP_DEV float lp_box_geo(float half, const float* R, const float* bpos, const float* sp,
                        float r, LpBoxGeo* g) {
  float rel[3] = {sp[0] - bpos[0], sp[1] - bpos[1], sp[2] - bpos[2]};
  lp_matTvec(R, rel, g->loc);
  for (int c = 0; c < 3; ++c) {
    g->cl[c] = fminf(fmaxf(g->loc[c], -half), half);
    g->d[c] = g->loc[c] - g->cl[c];
    g->gap[c] = half - fabsf(g->loc[c]);
  }
  g->dist = sqrtf(lp_dot(g->d, g->d) + 1e-18f);
  float gap_min = fminf(fminf(g->gap[0], g->gap[1]), g->gap[2]);
  return g->dist > 1e-9f ? r - g->dist : r + gap_min;
}

// Sphere s (world position sp, velocity sv, radius r, apparent mass meff)
// vs one cube (rotation R, state b = pos3 quat4 lin3 ang3, half-size half):
// the force on the sphere into fb, the cube's side (force, torque about its
// center) into bw (pallas_step.py, the sphere-vs-box pass). The second box's
// pass; lp_forces_phase writes the first box's out.
LP_DEV void lp_sphere_box(const LaneModel* m, const float* R, const float* b, float half,
                          const float* sp, const float* sv, float r, float meff,
                          float share_bm, float inv_in, float mu, float* fb, float* bw) {
  const float* blin = b + 7;
  const float* bang = b + 10;
  LpBoxGeo g;
  lp_box_geo(half, R, b, sp, r, &g);
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
  lp_matvec(R, nl, nw);
  lp_matvec(R, surf, r_c);
  lp_cross(bang, r_c, t);
  for (int c = 0; c < 3; ++c) rel[c] = sv[c] - (blin[c] + t[c]);
  rel[2] = rel[2] - m->gz * m->h;  // the box's gravity kick (rel = sphere - box)
  float rxn[3];
  lp_cross(r_c, nw, rxn);
  float ang_n = lp_dot(rxn, rxn) * inv_in;
  float m_red_n = 1.0f / (1.0f / meff + share_bm + ang_n);
  float vn_p = lp_dot(rel, nw);
  float vt_p[3];
  for (int c = 0; c < 3; ++c) vt_p[c] = rel[c] - nw[c] * vn_p;
  float vt_p_n = sqrtf(lp_dot(vt_p, vt_p) + 1e-18f);
  float it = 1.0f / (vt_p_n + 1e-9f);
  float t_hat[3] = {vt_p[0] * it, vt_p[1] * it, vt_p[2] * it};
  float rxt[3];
  lp_cross(r_c, t_hat, rxt);
  float ang_t = lp_dot(rxt, rxt) * inv_in;
  float m_red_t = 1.0f / (1.0f / meff + share_bm + ang_t);
  lp_contact_force(m, depth_b, nw, rel, mu, m_red_n, m_red_t, fb);
  for (int c = 0; c < 3; ++c) bw[c] = -fb[c];
  lp_cross(r_c, bw, bw + 3);
}

// Corner c8 of one cube (rotation R, state b, half-size half) vs the ground:
// the cube's force and torque into bw.
LP_DEV void lp_corner_ground(const LaneModel* m, const float* R, const float* b, float half,
                             int c8, float inv_mass, float inv_in, float mu, float* bw) {
  const float up[3] = {0.f, 0.f, 1.f};
  const float* blin = b + 7;
  const float* bang = b + 10;
  float cl[3] = {(c8 & 4) ? half : -half, (c8 & 2) ? half : -half, (c8 & 1) ? half : -half};
  float cw[3], r_c[3], t[3], vc[3];
  lp_matvec(R, cl, t);
  for (int c = 0; c < 3; ++c) { cw[c] = b[c] + t[c]; r_c[c] = cw[c] - b[c]; }
  float cwz = cw[2];
  lp_cross(bang, r_c, t);
  for (int c = 0; c < 3; ++c) vc[c] = blin[c] + t[c];
  vc[2] = vc[2] + m->gz * m->h;  // the box is the first body here: its kick adds
  lp_cross(r_c, up, t);
  float ang8 = lp_dot(t, t) * inv_in;
  float m_c = 1.0f / (4.0f * inv_mass + ang8);
  lp_contact_force(m, -cwz, up, vc, mu, m_c, m_c, bw);
  lp_cross(r_c, bw, bw + 3);
}

#if LP_HAS_BOX2
// Corner c8 of cube A (rotation RA, state a, half-size ha) vs cube B
// (pallas_step.py corners_vs_box): returns the depth (> 0 inside B). With
// bb given, also the penalty force on A along B's nearest face normal
// (bb[0..2]), its torque about A (bb[3..5]) and about B (bb[6..8]); `share`
// is the direction's active-corner count.
LP_DEV float lp_corner_box(const LaneModel* m, const float* RA, const float* a, float ha,
                           const float* RB, const float* b, float hb, int c8, float share,
                           float inv_ma, float inv_ia, float inv_mb, float inv_ib, float mu,
                           float* bb) {
  float cl[3] = {(c8 & 4) ? ha : -ha, (c8 & 2) ? ha : -ha, (c8 & 1) ? ha : -ha};
  float cw[3], t[3], loc[3], gap[3];
  lp_matvec(RA, cl, t);
  for (int c = 0; c < 3; ++c) { cw[c] = a[c] + t[c]; t[c] = cw[c] - b[c]; }
  lp_matTvec(RB, t, loc);
  for (int c = 0; c < 3; ++c) gap[c] = hb - fabsf(loc[c]);
  const float depth = fminf(fminf(gap[0], gap[1]), gap[2]);
  if (!bb) return depth;
  bool m01 = gap[0] < gap[1];
  bool m2 = (m01 ? gap[0] : gap[1]) < gap[2];
  bool sel0 = m01 && m2, sel1 = !m01 && m2, sel2 = !m2;
  float nl[3] = {sel0 ? (loc[0] >= 0.f ? 1.f : -1.f) : 0.f,
                 sel1 ? (loc[1] >= 0.f ? 1.f : -1.f) : 0.f,
                 sel2 ? (loc[2] >= 0.f ? 1.f : -1.f) : 0.f};
  float nw[3], r_a[3], r_b[3], va[3], vb[3], rel[3];
  lp_matvec(RB, nl, nw);
  for (int c = 0; c < 3; ++c) { r_a[c] = cw[c] - a[c]; r_b[c] = cw[c] - b[c]; }
  lp_cross(a + 10, r_a, t);
  for (int c = 0; c < 3; ++c) va[c] = a[7 + c] + t[c];
  lp_cross(b + 10, r_b, t);
  for (int c = 0; c < 3; ++c) vb[c] = b[7 + c] + t[c];
  // both cubes get the same gravity kick: the predicted relative velocity
  // is the current one
  for (int c = 0; c < 3; ++c) rel[c] = va[c] - vb[c];
  float rxa[3], rxb[3];
  lp_cross(r_a, nw, rxa);
  lp_cross(r_b, nw, rxb);
  float m_red = 1.0f / (share * inv_ma + lp_dot(rxa, rxa) * inv_ia + share * inv_mb +
                        lp_dot(rxb, rxb) * inv_ib);
  lp_contact_force(m, depth, nw, rel, mu, m_red, m_red, bb);
  lp_cross(r_a, bb, bb + 3);
  lp_cross(r_b, bb, bb + 6);
  return depth;
}

// Cube-cube corner c (0-7: the box's corners in the second box; 8-15: the
// second box's in the box), as lp_corner_box.
LP_DEV float lp_cube_corner(const LaneModel* m, const LpEnv* s, int c, float share,
                            float* bb) {
  const float bm_s = s->drv[2];
  const float ib1 = 1.0f / (m->box_mass * bm_s), ii1 = 1.0f / (m->box_inertia * bm_s);
  const float ib2 = 1.0f / (m->box2_mass * bm_s), ii2 = 1.0f / (m->box2_inertia * bm_s);
  const float mu = m->mu_bb * s->drv[3];
  return c < 8 ? lp_corner_box(m, s->Rb, s->box, m->half, s->Rb2, s->box + 13, m->half2, c,
                               share, ib1, ii1, ib2, ii2, mu, bb)
               : lp_corner_box(m, s->Rb2, s->box + 13, m->half2, s->Rb, s->box, m->half,
                               c - 8, share, ib2, ii2, ib1, ii1, mu, bb);
}
#endif

// ---------------------------------------------------------------- substep phases
// 1 (at level 0). Each box's lane forms its rotation matrix.
LP_DEV void lp_box_rots(const LaneModel* m, LpEnv* s, int lane) {
  if (lane == LP_BOX_LANE && m->has_box) lp_rotmat(s->box + 3, s->Rb);
#if LP_HAS_BOX2
  if (lane == LP_BOX2_LANE) lp_rotmat(s->box + 16, s->Rb2);
#endif
}

#if LP_HAS_BOX2
// 2a (two-cube build). Sphere poses and velocities; the flags of both boxes'
// sphere contacts, a ballot per round of 16 spheres (every lane takes part
// in each), and of the 16 cube-cube corners (lane c: corner c).
LP_DEV void lp_spheres_phase(const LaneModel* m, LpEnv* s, int lane, unsigned mask) {
  LpContactBuf* cb = &s->u.c;
  for (int r = 0; r * LP_W < m->ns; ++r) {
    const int j = r * LP_W + lane;
    bool on1 = false, on2 = false;
    if (j < m->ns) {
      const float* bk = s->kin[m->sb[j]];
      float t[3], d[3];
      lp_qrot(bk + 3, &m->spos[3 * j], t);
      for (int c = 0; c < 3; ++c) cb->sp[j][c] = bk[c] + t[c];
      for (int c = 0; c < 3; ++c) d[c] = cb->sp[j][c] - bk[c];
      lp_cross(bk + 10, d, t);
      for (int c = 0; c < 3; ++c) cb->sv[j][c] = bk[7 + c] + t[c];
      LpBoxGeo g;
      if (m->has_box) on1 = lp_box_geo(m->half, s->Rb, s->box, cb->sp[j], m->srad[j], &g) > 0.f;
      on2 = lp_box_geo(m->half2, s->Rb2, s->box + 13, cb->sp[j], m->srad[j], &g) > 0.f;
    }
    LP_BALLOT(s->act[r], on1, mask);
    LP_BALLOT(s->act2[r], on2, mask);
  }
  LP_BALLOT(s->actbb, lp_cube_corner(m, s, lane, 0.f, (float*)0) > 0.f, mask);
}
#else
// 2a. Sphere poses and velocities; the box-contact flags.
LP_DEV void lp_spheres_phase(const LaneModel* m, LpEnv* s, int lane) {
  LpContactBuf* cb = &s->u.c;
  for (int j = lane; j < m->ns; j += LP_W) {
    const float* bk = s->kin[m->sb[j]];
    float t[3], d[3];
    lp_qrot(bk + 3, &m->spos[3 * j], t);
    for (int c = 0; c < 3; ++c) cb->sp[j][c] = bk[c] + t[c];
    for (int c = 0; c < 3; ++c) d[c] = cb->sp[j][c] - bk[c];
    lp_cross(bk + 10, d, t);
    for (int c = 0; c < 3; ++c) cb->sv[j][c] = bk[7 + c] + t[c];
    if (m->has_box) {
      LpBoxGeo g;
      float depth = lp_box_geo(m->half, s->Rb, s->box, cb->sp[j], m->srad[j], &g);
      cb->act[j] = depth > 0.f ? 1.f : 0.f;
    }
  }
}
#endif

// 2b. Contact forces: spheres vs ground and box, finger pairs, box corners
// vs ground, each into its own slot (the two-cube build's pass A).
LP_DEV void lp_forces_phase(const LaneModel* m, LpEnv* s, int lane) {
  LpContactBuf* cb = &s->u.c;
  const float bm_s = s->drv[2], fr_s = s->drv[3];
  const float up[3] = {0.f, 0.f, 1.f};
  float inv_box_mass = 0.f, inv_box_in = 0.f, share_bm = 0.f;
  if (m->has_box) {
    inv_box_mass = 1.0f / (m->box_mass * bm_s);
    inv_box_in = 1.0f / (m->box_inertia * bm_s);
    float n_act = 0.f;
#if LP_HAS_BOX2
    int n_on = 0;
    for (int r = 0; r * LP_W < m->ns; ++r) n_on += LP_POPC(s->act[r]);
    n_act = (float)n_on;
#else
    for (int j = 0; j < m->ns; ++j) n_act += cb->act[j];
#endif
    share_bm = fmaxf(n_act, 1.0f) * inv_box_mass;
  }
  for (int j = lane; j < m->ns; j += LP_W) {
    const float* sp = cb->sp[j];
    const float* sv = cb->sv[j];
    float r = m->srad[j], meff = m->smeff[j];
    float f[3];
    lp_contact_force(m, r - sp[2], up, sv, m->mu_hg * fr_s, meff, meff, f);
    if (m->has_box) {
      // the box's pass is lp_sphere_box written out: as a call, the one-box
      // K2 build compiled to 4 bytes of spills (ptxas on sm_90a), the
      // one-box builds' registers and stack are kept as they were
      const float h = m->h, gz = m->gz;
      const float* Rb = s->Rb;
      const float* bpos = s->box;
      const float* blin = s->box + 7;
      const float* bang = s->box + 10;
      LpBoxGeo g;
      lp_box_geo(m->half, Rb, bpos, sp, r, &g);
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
      rel[2] = rel[2] - gz * h;
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
      float fb[3];
      lp_contact_force(m, depth_b, nw, rel, m->mu_hb * fr_s, m_red_n, m_red_t, fb);
      lp_add3(f, fb);
      float* bw = cb->BW[j];
      for (int c = 0; c < 3; ++c) bw[c] = -fb[c];
      lp_cross(r_c, bw, bw + 3);
    }
    for (int c = 0; c < 3; ++c) cb->F[j][c] = f[c];
  }
  // finger-finger self-collision over the pruned pairs: +f on sphere i at its
  // center, -f on sphere j
  for (int p = lane; p < m->n_sc; p += LP_W) {
    int si = m->sc_i[p], sj = m->sc_j[p];
    float d3[3], rel[3], n3[3];
    for (int c = 0; c < 3; ++c) {
      d3[c] = cb->sp[si][c] - cb->sp[sj][c];
      rel[c] = cb->sv[si][c] - cb->sv[sj][c];
    }
    float dist = sqrtf(lp_dot(d3, d3) + 1e-18f);
    float inv = 1.0f / (dist + 1e-9f);
    for (int c = 0; c < 3; ++c) n3[c] = d3[c] * inv;
    lp_contact_force(m, m->sc_rsum[p] - dist, n3, rel, m->mu_hh * fr_s, m->sc_meff[p],
                     m->sc_meff[p], cb->F[m->ns + p]);
  }
  // box corners vs ground (lanes 0-7)
  for (int c8 = lane; m->has_box && c8 < 8; c8 += LP_W)
    lp_corner_ground(m, s->Rb, s->box, m->half, c8, inv_box_mass, inv_box_in,
                     m->mu_bg * fr_s, cb->BW[m->ns + c8]);
}

#if LP_HAS_BOX2
// 3, pass A's sums (two-cube build). Each body its spheres, then its pairs
// (LaneModel.bc up to the second box's entries, which come last), into its
// wrench registers and cf; the box lane the box's spheres, then corners,
// into bw.
LP_DEV void lp_body_sums_phase(const LaneModel* m, LpEnv* s, LpLane& L, int lane) {
  const LpContactBuf* cb = &s->u.c;
  const int split = m->ns + m->n_sc;  // the first force slot of the second box's
  LP_EACH_BODY(k, i,
    float cf[3] = {0.f, 0.f, 0.f}, bF[3] = {0.f, 0.f, 0.f}, bN[3] = {0.f, 0.f, 0.f};
    for (int h = 0; h < m->nbc[i]; ++h) {
      const int e = m->bc[i * LP_MAXBC + h];
      if ((e & 255) >= split) break;
      const float* f = cb->F[e & 255];
      float t[3];
      lp_cross(cb->sp[(e >> 8) & 255], f, t);
      if (e >> 16) { lp_sub3(cf, f); lp_sub3(bF, f); lp_sub3(bN, t); }
      else { lp_add3(cf, f); lp_add3(bF, f); lp_add3(bN, t); }
    }
    for (int c = 0; c < 3; ++c) {
      s->cf[3 * i + c] = cf[c];
      L.W[k][c] = bF[c];
      L.W[k][3 + c] = bN[c];
    })
  if (lane == LP_BOX_LANE && m->has_box) {
    float box_f[3] = {0.f, 0.f, 0.f}, box_t[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < m->ns + 8; ++j) {
      lp_add3(box_f, cb->BW[j]);
      lp_add3(box_t, cb->BW[j] + 3);
    }
    for (int c = 0; c < 3; ++c) { s->bw[c] = box_f[c]; s->bw[3 + c] = box_t[c]; }
  }
}

// 2, pass B (two-cube build), over pass A's words: the spheres vs the second
// box (its own share count), its corners vs ground (lanes 8-15), then the
// cube-cube corners (a lane each), each direction with its own share count,
// each into its own slot.
LP_DEV void lp_box2_forces_phase(const LaneModel* m, LpEnv* s, int lane) {
  LpContactBuf2* cb = &s->u.c2;
  const float bm_s = s->drv[2], fr_s = s->drv[3];
  const float inv_box2_mass = 1.0f / (m->box2_mass * bm_s);
  const float inv_box2_in = 1.0f / (m->box2_inertia * bm_s);
  int n_on = 0;
  for (int r = 0; r * LP_W < m->ns; ++r) n_on += LP_POPC(s->act2[r]);
  const float share2_bm = fmaxf((float)n_on, 1.0f) * inv_box2_mass;
  for (int j = lane; j < m->ns; j += LP_W)
    lp_sphere_box(m, s->Rb2, s->box + 13, m->half2, cb->sp[j], cb->sv[j], m->srad[j],
                  m->smeff[j], share2_bm, inv_box2_in, m->mu_hb2 * fr_s, cb->F2[j], cb->BW2[j]);
  for (int c8 = lane - 8; c8 >= 0 && c8 < 8; c8 += LP_W)
    lp_corner_ground(m, s->Rb2, s->box + 13, m->half2, c8, inv_box2_mass, inv_box2_in,
                     m->mu_b2g * fr_s, cb->BW2[m->ns + c8]);
  const float n_bb[2] = {(float)LP_POPC(s->actbb & 0xffu), (float)LP_POPC(s->actbb >> 8)};
  for (int c = lane; c < 16; c += LP_W)
    lp_cube_corner(m, s, c, fmaxf(n_bb[c >> 3], 1.0f), cb->BB[c]);
}
#endif

// Box integration with PhysX-style velocity caps (box lane).
LP_DEV void lp_box_integrate(const LaneModel* m, float* box, const float* box_f,
                             const float* box_t, float inv_box_mass, float inv_box_in) {
  const float h = m->h;
  const float* bpos = box;
  const float* bquat = box + 3;
  const float* blin = box + 7;
  const float* bang = box + 10;
  float lv[3] = {blin[0] + h * (box_f[0] * inv_box_mass),
                 blin[1] + h * (box_f[1] * inv_box_mass),
                 blin[2] + h * (box_f[2] * inv_box_mass + m->gz)};
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

// 3. Body lanes: own contacts (spheres, then pairs, then spheres vs the
// second box, in index order), gravity at the COM and the CRBA terms about
// the world origin (T = Ic_w - m [c]x[c]x, 6 terms of the symmetric 3x3; K =
// m c), into registers. Box lane: the box's contact wrench (spheres, then
// corners, then the cube-cube sums) and its integration; the second box's
// lane the same for its box. In the two-cube build (pass B) each sum goes
// on from pass A's (lp_body_sums_phase).
LP_DEV void lp_body_own(const LaneModel* m, LpEnv* s, int i, float* W, float* T, float* K) {
#if LP_HAS_BOX2
  const LpContactBuf2* cb = &s->u.c2;
  const int split = m->ns + m->n_sc;
  float cf[3], bF[3], bN[3];
  for (int c = 0; c < 3; ++c) { cf[c] = s->cf[3 * i + c]; bF[c] = W[c]; bN[c] = W[3 + c]; }
  for (int k = 0; k < m->nbc[i]; ++k) {
    int e = m->bc[i * LP_MAXBC + k];
    if ((e & 255) < split) continue;
    const float* f = cb->F2[(e & 255) - split];
    float t[3];
    lp_cross(cb->sp[(e >> 8) & 255], f, t);
    if (e >> 16) { lp_sub3(cf, f); lp_sub3(bF, f); lp_sub3(bN, t); }
    else { lp_add3(cf, f); lp_add3(bF, f); lp_add3(bN, t); }
  }
#else
  const LpContactBuf* cb = &s->u.c;
  float cf[3] = {0.f, 0.f, 0.f}, bF[3] = {0.f, 0.f, 0.f}, bN[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < m->nbc[i]; ++k) {
    int e = m->bc[i * LP_MAXBC + k];
    const float* f = cb->F[e & 255];
    float t[3];
    lp_cross(cb->sp[(e >> 8) & 255], f, t);
    if (e >> 16) { lp_sub3(cf, f); lp_sub3(bF, f); lp_sub3(bN, t); }
    else { lp_add3(cf, f); lp_add3(bF, f); lp_add3(bN, t); }
  }
#endif
  for (int c = 0; c < 3; ++c) s->cf[3 * i + c] = cf[c];
  float mi = m->mass[i];
  if (mi == 0.f) {
    for (int c = 0; c < 6; ++c) T[c] = 0.f;
    for (int c = 0; c < 3; ++c) K[c] = 0.f;
  } else {
    const float* k = s->kin[i];
    float R[9], cw[3], t[3];
    lp_rotmat(k + 3, R);
    lp_matvec(R, &m->com[3 * i], t);
    for (int c = 0; c < 3; ++c) cw[c] = k[c] + t[c];
    float fg[3] = {0.f, 0.f, mi * m->gz};
    bF[2] += fg[2];
    lp_cross(cw, fg, t);
    lp_add3(bN, t);
    const float* Ic = &m->inertia[9 * i];
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
      T[e] = icw - mi * cc;
    }
    for (int c = 0; c < 3; ++c) K[c] = cw[c] * mi;
  }
  for (int c = 0; c < 3; ++c) { W[c] = bF[c]; W[3 + c] = bN[c]; }
}

LP_DEV void lp_body_phase(const LaneModel* m, LpEnv* s, LpLane& L, int lane) {
#if LP_HAS_BOX2
  const LpContactBuf2* cb = &s->u.c2;
#else
  const LpContactBuf* cb = &s->u.c;
#endif
  LP_EACH_BODY(k, i, lp_body_own(m, s, i, L.W[k], L.T[k], L.K[k]);)
  if (lane == LP_BOX_LANE) {
    float box_f[3] = {0.f, 0.f, 0.f}, box_t[3] = {0.f, 0.f, 0.f};
    if (m->has_box) {
      const float bm_s = s->drv[2];
#if LP_HAS_BOX2
      // pass A's spheres and corners (bw), + (fa1 + fa2): its corners in the
      // second box, then the second box's corners in it (the reaction: minus
      // the force, minus its torque about this box)
      for (int c = 0; c < 3; ++c) { box_f[c] = s->bw[c]; box_t[c] = s->bw[3 + c]; }
      float fa1[3] = {0.f, 0.f, 0.f}, ta1[3] = {0.f, 0.f, 0.f};
      float fa2[3] = {0.f, 0.f, 0.f}, ta2[3] = {0.f, 0.f, 0.f};
      for (int c = 0; c < 8; ++c) { lp_add3(fa1, cb->BB[c]); lp_add3(ta1, cb->BB[c] + 3); }
      for (int c = 8; c < 16; ++c) { lp_sub3(fa2, cb->BB[c]); lp_sub3(ta2, cb->BB[c] + 6); }
      for (int c = 0; c < 3; ++c) { box_f[c] += fa1[c] + fa2[c]; box_t[c] += ta1[c] + ta2[c]; }
#else
      for (int j = 0; j < m->ns + 8; ++j) {
        lp_add3(box_f, cb->BW[j]);
        lp_add3(box_t, cb->BW[j] + 3);
      }
#endif
      lp_box_integrate(m, s->box, box_f, box_t, 1.0f / (m->box_mass * bm_s),
                       1.0f / (m->box_inertia * bm_s));
    }
    for (int c = 0; c < 3; ++c) s->bf[c] = box_f[c];
  }
#if LP_HAS_BOX2
  if (lane == LP_BOX2_LANE) {
    // spheres, corners, then + (fb1 + fb2): the box's corners in it (the
    // reaction), then its own corners in the box
    const float bm_s = s->drv[2];
    float f2[3] = {0.f, 0.f, 0.f}, t2[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < m->ns + 8; ++j) {
      lp_add3(f2, cb->BW2[j]);
      lp_add3(t2, cb->BW2[j] + 3);
    }
    float fb1[3] = {0.f, 0.f, 0.f}, tb1[3] = {0.f, 0.f, 0.f};
    float fb2[3] = {0.f, 0.f, 0.f}, tb2[3] = {0.f, 0.f, 0.f};
    for (int c = 0; c < 8; ++c) { lp_sub3(fb1, cb->BB[c]); lp_sub3(tb1, cb->BB[c] + 6); }
    for (int c = 8; c < 16; ++c) { lp_add3(fb2, cb->BB[c]); lp_add3(tb2, cb->BB[c] + 3); }
    for (int c = 0; c < 3; ++c) { f2[c] += fb1[c] + fb2[c]; t2[c] += tb1[c] + tb2[c]; }
    lp_box_integrate(m, s->box + 13, f2, t2, 1.0f / (m->box2_mass * bm_s),
                     1.0f / (m->box2_inertia * bm_s));
    for (int c = 0; c < 3; ++c) s->bf[3 + c] = f2[c];
  }
#endif
}

// 4a. Own wrench and CRBA terms into shared memory (the contact buffers are
// dead now).
LP_DEV void lp_tree_store(const LaneModel* m, LpEnv* s, const LpLane& L, int lane) {
  LpTreeBuf* tb = &s->u.t;
  LP_EACH_BODY(k, i,
    for (int c = 0; c < 6; ++c) { tb->W[i][c] = L.W[k][c]; tb->T[i][c] = L.T[k][c]; }
    for (int c = 0; c < 3; ++c) tb->K[i][c] = L.K[k][c];)
}

// 4b. Subtree sums at level lev: each body adds its children's (final)
// sums, children in descending index.
LP_DEV void lp_tree_level(const LaneModel* m, LpEnv* s, int lev, int lane) {
  LpTreeBuf* tb = &s->u.t;
  LP_EACH_BODY(k, i,
    if (m->depth[i] == lev + 1 && m->nchild[i] > 0) {
      float W[6], T[6], K[3];
      for (int c = 0; c < 6; ++c) { W[c] = tb->W[i][c]; T[c] = tb->T[i][c]; }
      for (int c = 0; c < 3; ++c) K[c] = tb->K[i][c];
      for (int h = 0; h < m->nchild[i]; ++h) {
        int ch = m->child[i * LP_MAXCH + h];
        for (int c = 0; c < 6; ++c) { W[c] += tb->W[ch][c]; T[c] += tb->T[ch][c]; }
        lp_add3(K, tb->K[ch]);
      }
      for (int c = 0; c < 6; ++c) { tb->W[i][c] = W[c]; tb->T[i][c] = T[c]; }
      for (int c = 0; c < 3; ++c) tb->K[i][c] = K[c];
    })
}

// 5a. Q_j and row j of the mass matrix: f_j = Ic_j S_j (ftop = T a + K x v,
// fbot = -(K x a) + m v), entry (i, j) = S_i . f_j for i in anc(j).
LP_DEV float lp_mass_row_own(const LaneModel* m, LpEnv* s, int j) {
  LpTreeBuf* tb = &s->u.t;
  const float* a3 = s->S[j];
  const float* v3 = s->S[j] + 3;
  const float* bF = tb->W[j];
  const float* bN = tb->W[j] + 3;
  float Q = m->is_prism[j] ? lp_dot(v3, bF) : lp_dot(a3, bN) + lp_dot(v3, bF);
  const float* t6 = tb->T[j];
  float Ta[3] = {t6[0] * a3[0] + t6[1] * a3[1] + t6[2] * a3[2],
                 t6[1] * a3[0] + t6[3] * a3[1] + t6[4] * a3[2],
                 t6[2] * a3[0] + t6[4] * a3[1] + t6[5] * a3[2]};
  float kv[3], ka[3], ftop[3], fbot[3];
  lp_cross(tb->K[j], v3, kv);
  lp_cross(tb->K[j], a3, ka);
  float ms = m->subtree_mass[j];
  for (int c = 0; c < 3; ++c) {
    ftop[c] = Ta[c] + kv[c];
    fbot[c] = v3[c] * ms - ka[c];
  }
  float* row = &tb->M[m->moff[j]];
  for (int t = 0; t < m->depth[j]; ++t) {
    const float* Si = s->S[m->anc[j * LP_MAXD + t]];
    row[t] = lp_dot(Si, ftop) + lp_dot(Si + 3, fbot);
  }
  return Q;
}

LP_DEV void lp_mass_row(const LaneModel* m, LpEnv* s, LpLane& L, int lane) {
  LP_EACH_BODY(k, i, L.Q[k] = lp_mass_row_own(m, s, i);)
}

// 5b. rhs_i = (M + arm) qd + h (kp (tgt - q) + Q), the row sum in the lane
// kernel's order (own row, then descendants ascending), into w; then the
// implicit-PD diagonal A = M + arm + h kd + h^2 kp.
LP_DEV void lp_rhs_own(const LaneModel* m, LpEnv* s, int i, float Q) {
  const int D = m->depth[i];
  const float h = m->h;
  LpTreeBuf* tb = &s->u.t;
  float* row = &tb->M[m->moff[i]];
  float r = 0.f;
  for (int t = 0; t < D; ++t) r += row[t] * s->qd[m->anc[i * LP_MAXD + t]];
  for (int e = m->desc_off[i]; e < m->desc_off[i + 1]; ++e) {
    const int t = m->desc[e];
    r += tb->M[t & 0xffff] * s->qd[t >> 16];
  }
  float kp_i = m->kp[i] * s->drv[0];
  float acc = r + m->arm[i] * s->qd[i];
  tb->w[i] = acc + h * (kp_i * (s->tgt[i] - s->q[i]) + Q);
  row[D - 1] = row[D - 1] + m->arm[i] + (h * m->kd[i]) * s->drv[1] + (h * h) * kp_i;
}

LP_DEV void lp_rhs(const LaneModel* m, LpEnv* s, const LpLane& L, int lane) {
  LP_EACH_BODY(k, i, lp_rhs_own(m, s, i, L.Q[k]);)
}

// 6. Step kk of the sparse LTL factorization, leaf to root (zero fill-in:
// L's nonzeros are exactly the ancestor pairs), fused with step kk of
// L^T w = rhs (descendants feed ancestors). Row kk and w_kk are final here,
// scaled on the fly by their pivot's rsqrt (every lane forms the same one);
// lanes run over the step's updates, one entry each: (anc[kk][ii], jj) for
// jj <= ii < depth - 1, then w[anc[kk][ii]]. Each entry gets one update per
// step, so its updates keep the lane kernel's order (kk descending).
LP_DEV void lp_ltl_phase(const LaneModel* m, LpEnv* s, int lane, int kk) {
  const int D = m->depth[kk];
  LpTreeBuf* tb = &s->u.t;
  const float* rk = &tb->M[m->moff[kk]];
  const float d = LP_RSQRT(rk[D - 1]);
  if (lane == 0) tb->inv_d[kk] = d;
  const int n_tri = (D - 1) * D / 2;
  for (int e0 = lane; e0 < n_tri; e0 += LP_W * LP_TRI_ROUNDS) {
    int idx[LP_TRI_ROUNDS];
    float upd[LP_TRI_ROUNDS];
    LP_UNROLL for (int r = 0; r < LP_TRI_ROUNDS; ++r) {  // the loads before the stores
      const int e = e0 + LP_W * r;
      if (e < n_tri) {
        const int t = m->ltl[kk * LP_TRI + e];
        const float sii = rk[(t >> 16) & 255] * d;
        idx[r] = t & 0xffff;
        upd[r] = tb->M[idx[r]] - sii * (rk[t >> 24] * d);
      }
    }
    LP_UNROLL for (int r = 0; r < LP_TRI_ROUNDS; ++r)
      if (e0 + LP_W * r < n_tri) tb->M[idx[r]] = upd[r];
  }
  const float wk = tb->w[kk] * d;
  for (int e = lane; e < D - 1; e += LP_W) tb->w[m->anc[kk * LP_MAXD + e]] -= (rk[e] * d) * wk;
}

// 7. L qd' = w at level lev (ancestors feed descendants), with the row and
// w scaled by the owner's pivot; then the integration with joint-limit
// projection of the body's DOF.
LP_DEV void lp_forward_own(const LaneModel* m, LpEnv* s, int i, float d) {
  const int D = m->depth[i];
  LpTreeBuf* tb = &s->u.t;
  const float* row = &tb->M[m->moff[i]];
  float v = tb->w[i] * d;
  for (int t = 0; t < D - 1; ++t) v -= (row[t] * d) * tb->qdn[m->anc[i * LP_MAXD + t]];
  v = v * d;
  tb->qdn[i] = v;
  float qn = s->q[i] + m->h * v;
  float lo = m->lower[i], up_ = m->upper[i];
  bool low_hit = qn < lo, high_hit = qn > up_;
  qn = fminf(fmaxf(qn, lo), up_);
  if (low_hit && v < 0.f) v = 0.f;
  if (high_hit && v > 0.f) v = 0.f;
  s->q[i] = qn;
  s->qd[i] = v;
}

LP_DEV void lp_forward_phase(const LaneModel* m, LpEnv* s, int lane, int lev) {
  LP_EACH_BODY(k, i, if (m->depth[i] == lev + 1) lp_forward_own(m, s, i, s->u.t.inv_d[i]);)
}

// One integrator substep (pallas_step.py substep) of the env in s: q, qd and
// box (both boxes in the two-cube build) are updated; cf and bf receive this
// substep's body contact forces and each box's net contact force.
LP_DEV void lp_substep(const LaneModel* m, LpEnv* s, LpLane* Ls) {
  for (int lev = 0; lev < m->n_levels; ++lev)
    LP_WARP(lp_fk_phase(m, lev, lane, L, s->q, s->qd, s->spawn, s->kin, s->S);
            if (lev == 0) lp_box_rots(m, s, lane););
#if LP_HAS_BOX2
  LP_WARP(lp_spheres_phase(m, s, lane, L.mask););
  LP_WARP(lp_forces_phase(m, s, lane););
  LP_WARP(lp_body_sums_phase(m, s, L, lane););
  LP_WARP(lp_box2_forces_phase(m, s, lane););
#else
  LP_WARP(lp_spheres_phase(m, s, lane););
  LP_WARP(lp_forces_phase(m, s, lane););
#endif
  LP_WARP(lp_body_phase(m, s, L, lane););
  LP_WARP(lp_tree_store(m, s, L, lane););
  for (int lev = m->n_levels - 2; lev >= 0; --lev) LP_WARP(lp_tree_level(m, s, lev, lane););
  LP_WARP(lp_mass_row(m, s, L, lane););
  LP_WARP(lp_rhs(m, s, L, lane););
  for (int kk = m->nb - 1; kk >= 0; --kk) LP_WARP(lp_ltl_phase(m, s, lane, kk););
  for (int lev = 0; lev < m->n_levels; ++lev) LP_WARP(lp_forward_phase(m, s, lane, lev););
}

// ---------------------------------------------------------------- block I/O
// Rows x LP_ENVS columns of a rows x n array (envs contiguous) to or from the
// block's env slots: env e's row r at base[e * stride + r] (stride in words).
// Consecutive threads take consecutive envs of one row, so the global
// accesses of a row are contiguous.
template <typename T>
LP_DEV void lp_stage_in(const T* g, int rows, int n, int e0, T* base, int stride, int tid,
                        int nthr) {
  for (int k = tid; k < rows * LP_ENVS; k += nthr) {
    int r = k / LP_ENVS, e = k - r * LP_ENVS, i = e0 + e;
    base[(size_t)e * stride + r] = i < n ? g[(size_t)r * n + i] : (T)0;
  }
}

template <typename T>
LP_DEV void lp_stage_out(T* g, int rows, int n, int e0, const T* base, int stride, int tid,
                         int nthr) {
  for (int k = tid; k < rows * LP_ENVS; k += nthr) {
    int r = k / LP_ENVS, e = k - r * LP_ENVS, i = e0 + e;
    if (i < n) g[(size_t)r * n + i] = base[(size_t)e * stride + r];
  }
}

#ifdef __CUDACC__
// Dynamic shared memory per block, raised above the 48 KB default where
// needed, and the blocks resident per SM at that size.
template <typename K>
static int lp_prepare(K kernel, int smem, int* blocks_per_sm) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && blocks_per_sm)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        LP_THREADS, smem);
  return (int)err;
}
#endif
