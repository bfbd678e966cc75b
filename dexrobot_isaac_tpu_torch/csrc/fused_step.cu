// K1: the fused env step, one whole control step per env, for each of the six
// tasks.
//
// Replaces the TPU kernel of dexrobot_isaac_tpu/envs/fused_step.py
// (build_fused_step -> kernel_body, pallas_call at :1080 in
// call_kernel_pallas). A half-warp per env (the design of lane_physics.cuh),
// LP_ENVS envs per block. Per env, on its staged column: the action pipeline
// (position / position_delta, velocity and position clamps, 18 -> 26
// coupling) on lane 0; the lane physics (physics_steps_per_control x
// substeps substeps, then the final FK) on the whole warp; the spawn
// projection of the reset rows (lp_min_site_z, the min_site_z kernel's code,
// which the factory's reset closure calls) on the whole warp, for every env
// since whether it resets is known only after the task step; then on lane 0
// the fingertip/pad sites, the default observations, the task's step, the
// hitting-ground check (the task's own, where it has one, takes precedence),
// termination, the common + task rewards and their weighted sum, the
// obs/reward/mask/component rows and the done-masked reset merge. rows_f /
// rows_i are read and written IN PLACE (the JAX kernel aliases them): a
// block stages all of its envs' columns into shared memory before any is
// overwritten.
//
// The task is chosen at compile time, each build its own library
// (utils/kernel_build.py BUILDS), as the JAX package traces one kernel per
// task: FS_TASK 1 BlindGrasping (the default), 0 BaseTask (no task step:
// the builtin hitting-ground criterion and the common rewards), 2
// BoxStacking (with -DLP_HAS_BOX2=1: the platform cube's 13 state rows, its
// 7 reset rows, its contact force), 3 BoxReorientation, 4
// InHandReorientation, 5 BoxPushing (their task states all come from the
// reset rows). Each build's working set holds its own task's observations
// and state only (FsObs, FsTaskState), so that one task's fields take no
// words of another build's output staging. The static plan (obs key order, reward
// weights, component order, active criteria and flag rows, row offsets,
// action limits, task constants) is DATA in a FusedConfig buffer built by
// envs/fused_step.py.
//
// What bounds it on the H100: per env (BlindGrasping) it reads rows_f (141)
// + rows_i (22) + actions (18) + reset rows (43) + DR (4) + spawn (3) = 231
// words and writes rows_f + rows_i (163), rows_c (104), obs (158), reward
// (1), masks (4) and components (39) = 469 words: ~2.8 KB/env, ~11.5 MB at
// 4096 envs, ~3.4 us at 3.35 TB/s. The 16 substeps of lane physics carry
// ~5e5 f32 FLOPs/env (~2e9 at 4096 envs, ~30 us at 67 TFLOP/s), so the
// FLOPs bound it; BoxStacking's second box adds to both. The half-warp
// design is bound by the physics' serial phases, hidden by the envs
// resident per SM: 32 in every build (4 blocks of 8), BoxStacking's too,
// whose two-box contacts run as two passes over the LpEnv union (its slot
// 7,116 B of the 7,168 an env may take). The staged column (~1 KB,
// FS_IN_CAP words sized per build) makes K1's slot of shared memory larger
// than K2's, and lane 0's part (the two envs of a warp run theirs side by
// side) works on shared memory, not the thread's stack. Rows are staged in
// and out with
// consecutive threads on consecutive envs, so global accesses stay
// coalesced in the rows x N layout.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

#ifndef FS_TASK
#define FS_TASK 1  // 0 BaseTask, 1 BlindGrasping, 2 BoxStacking, 3 BoxReorientation,
                   // 4 InHandReorientation, 5 BoxPushing
#endif

#include "lane_physics.cuh"

#if FS_TASK == 2 && !LP_HAS_BOX2
#error "BoxStacking's K1 needs the two-cube lane physics (-DLP_HAS_BOX2=1)"
#endif

#define FUSED_CONFIG_FIELDS(S, A)                                                \
  S(int, n_act) S(int, position_mode) S(int, controls_base) S(int, controls_fingers) \
  S(int, n_filters) A(int, filters, 4) A(float, lo, 18) A(float, hi, 18)        \
  A(float, md, 18) A(int, csrc, 26) A(float, cscale, 26) A(int, act_idx, 18)    \
  S(int, nc) A(int, contact_body, 8) S(float, contact_binary_threshold)         \
  S(float, control_dt) S(int, hand_b) A(int, tip_site, 5) A(int, pad_site, 5)  \
  S(int, n_obs_keys) A(int, obs_keys, 64) S(int, obs_dim)                       \
  S(int, rows_f) S(int, rows_i) S(int, rows_c) S(int, rst_rows)                 \
  S(int, f_q) S(int, f_qd) S(int, f_box_pos) S(int, f_box_quat)                 \
  S(int, f_box_linvel) S(int, f_box_angvel) S(int, f_active_prev_targets)       \
  S(int, f_prev_actions) S(int, f_prev_contact_binary)                          \
  S(int, f_prev_finger_dof_vel) S(int, f_prev_hand_vel)                         \
  S(int, f_prev_hand_ang_vel) A(int, f_dr, 4) S(int, f_initial_box_pos)         \
  S(int, f_stage_contact_duration) S(int, f_time_in_stage)                      \
  S(int, i_episode_step_count) S(int, i_contact_duration_steps)                 \
  S(int, i_prev_contacts) S(int, i_current_stage) S(int, i_just_t2)             \
  S(int, i_just_t3) S(int, i_success_conditions_met)                            \
  S(int, i_success_duration_steps) S(int, c_full_dof_targets)                   \
  S(int, c_body_contact_force)                                                  \
  S(int, n_sflags) A(int, sflag_crit, 8) A(int, sflag_row, 8)                   \
  S(int, n_fflags) A(int, fflag_crit, 8) A(int, fflag_row, 8)                   \
  S(int, max_episode_length) S(float, success_reward) S(float, failure_penalty) \
  S(float, timeout_penalty) S(int, has_height_safety)                           \
  S(float, handbase_threshold) S(float, fingertip_threshold)                    \
  S(int, has_proj) S(float, proj_clear) A(float, proj_spawn, 3)                 \
  S(int, proj_site_mask)                                                        \
  S(int, n_rew) A(int, rew_term, 32) A(float, rew_w, 32)                        \
  S(int, n_comp) A(int, comp_kind, 96) A(int, comp_idx, 96)                     \
  A(float, finger_lower, 20) A(float, finger_upper, 20)                         \
  S(float, bg_contact_thr) S(float, bg_prox_thr) S(float, bg_height_thr)        \
  S(int, bg_min_fingers) S(float, bg_max_box_dist) S(float, bg_s1_dur)          \
  S(float, bg_s2_dur) S(float, bg_s2_contact_thr) S(float, bg_d_ha)             \
  S(float, bg_d_cp) S(float, bg_d_os) S(float, bg_d_fhc) S(float, bg_d_fpp)     \
  S(float, bg_d_bs) S(float, bg_tol_h) S(float, bg_tol_c)                       \
  S(float, bg_tol_drift) S(float, bg_tol_vel) S(float, bg_box_z)                \
  S(float, bg_s3_den) S(float, bg_pen_thr) S(float, bg_min_reward_dist)         \
  S(float, bg_pen_scale) S(float, bg_ub_half) S(float, bg_ub_margin)            \
  S(float, bg_ub_ground_z) S(float, bg_cdt) S(int, bg_threshold_steps)          \
  S(int, f_box2_pos) S(int, f_box2_quat) S(int, f_box2_linvel)                  \
  S(int, f_box2_angvel) S(int, f_platform_spawn_xy) S(int, f_prev_transport_dist) \
  S(int, f_spawn_difficulty) S(int, i_hold_duration_steps)                      \
  S(int, r_hold_duration_steps) S(int, r_platform_spawn_xy)                     \
  S(int, r_prev_transport_dist) S(int, r_spawn_difficulty)                      \
  S(float, bs_stack_dz) S(float, bs_pos_tol) S(float, bs_height_tol)            \
  S(float, bs_rest_speed) S(float, bs_hold_thr) S(float, bs_hold_min)           \
  S(float, bs_box_far) S(float, bs_move_tol) S(float, bs_contact_thr)           \
  S(float, bs_prox_thr) S(float, bs_d_prox) S(float, bs_d_transport)            \
  S(float, bs_d_place) S(float, bs_release_end) S(float, bs_tol_relax)          \
  S(int, bs_hg_override) S(float, bs_tip_bridge_margin) S(float, bs_pocket_margin) \
  S(float, bs_pocket_radius) S(float, bs_pocket_end) S(float, bs_handbase_thr)  \
  S(float, bs_fingertip_thr) S(float, bs_lift_z) S(float, bs_ub_half)           \
  S(float, bs_ub_margin) S(float, bs_ub_ground_z) S(float, bs_drift_free)       \
  S(float, t_contact_thr) S(float, t_prox_thr) S(int, t_thr_steps)              \
  S(float, t_lift_z) S(float, t_d_prox) S(int, r_initial_box_pos)               \
  S(int, f_target_yaw) S(int, f_prev_yaw_error) S(int, i_aligned_duration_steps) \
  S(int, r_target_yaw) S(int, r_prev_yaw_error) S(int, r_aligned_duration_steps) \
  S(float, ro_period) S(float, ro_yaw_tol) S(float, ro_d_orient)                \
  S(float, ro_drift_tol) S(float, ro_max_drift) S(float, ro_d_drift)            \
  S(float, ih_hang_z) S(float, ih_drop_band) S(float, ih_drop_z)                \
  S(float, ih_escape) S(float, ih_d_height)                                     \
  S(int, f_target_xy) S(int, f_initial_dist) S(int, f_prev_dist)                \
  S(int, r_target_xy) S(int, r_initial_dist) S(int, r_prev_dist)                \
  S(float, bp_pos_tol) S(float, bp_rest_speed) S(float, bp_overshoot)           \
  S(float, bp_d_dist)

struct FusedConfig {
  FUSED_CONFIG_FIELDS(LP_DECL_S, LP_DECL_A)
};

// observation keys (envs/fused_step.py OBS_KEYS order): the default keys,
// then the tasks' (a build fills the default keys and its task's)
enum {
  OK_BASE_DOF_POS, OK_BASE_DOF_VEL, OK_ACTIVE_FINGER_DOF_POS, OK_ACTIVE_FINGER_DOF_VEL,
  OK_ALL_FINGER_DOF_POS, OK_ALL_FINGER_DOF_VEL, OK_HAND_POSE, OK_HAND_POSE_ARR_ALIGNED,
  OK_CONTACT_FORCES, OK_CONTACT_FORCE_MAGNITUDE, OK_CONTACT_BINARY, OK_CONTACT_DURATION,
  OK_PREV_ACTIONS, OK_ACTIVE_PREV_TARGETS, OK_BASE_DOF_TARGET, OK_ACTIVE_FINGER_DOF_TARGET,
  OK_ALL_FINGER_DOF_TARGET, OK_FINGERTIP_POSES_WORLD, OK_FINGERTIP_POSES_HAND,
  OK_FINGERPAD_POSES_WORLD, OK_FINGERPAD_POSES_HAND, OK_EPISODE_TIME,
  OK_OBJECT_POS, OK_OBJECT_VEL, OK_FINGER_TO_OBJECT_DISTANCES,
  OK_AVG_FINGER_TO_OBJECT_DISTANCE, OK_FINGER_TO_OBJECT_HEIGHT_DIFF,
  OK_AVG_FINGER_TO_OBJECT_HEIGHT_DIFF, OK_HAND_TO_OBJECT_DISTANCE, OK_FINGERPAD_DISTANCES,
  OK_FIRST_THREE_FINGERPAD_CENTROID, OK_THUMB_CONTACT, OK_OTHER_FINGERS_CONTACT,
  OK_GRASP_STATE, OK_GRASP_DURATION, OK_CURRENT_STAGE, OK_TIME_IN_STAGE, OK_STAGE_PROGRESS,
  OK_OBJECT_QUAT, OK_PLATFORM_POS, OK_PLATFORM_QUAT, OK_TO_STACK_TARGET, OK_STACK_DIST,
  OK_FINGERS_ON_BOX, OK_HOLD_DURATION,
  OK_OBJECT_ANGVEL, OK_OBJECT_YAW_SINCOS, OK_TARGET_YAW_SINCOS, OK_YAW_ERROR, OK_BOX_DRIFT,
  OK_ALIGNED_DURATION, OK_OBJECT_REL_HAND, OK_TARGET_XY, OK_TO_TARGET, OK_DIST_TO_TARGET,
};

// reward terms (envs/fused_step.py reward_terms_for: the common terms, then
// the task's), and the criteria (success_criteria_for / failure_criteria_for)
enum {
  RT_ALIVE, RT_HEIGHT_SAFETY, RT_FINGER_VELOCITY, RT_HAND_VELOCITY,
  RT_HAND_ANGULAR_VELOCITY, RT_JOINT_LIMIT, RT_FINGER_ACCELERATION, RT_HAND_ACCELERATION,
  RT_HAND_ANGULAR_ACCELERATION, RT_CONTACT_STABILITY, RT_TASK0
};
enum { FC_HITTING_GROUND };
#if FS_TASK == 1
enum {
  RT_S1_HEIGHT_ALIGNMENT = RT_TASK0, RT_S1_CENTROID_POSITIONING, RT_S1_OBJECT_STABILITY,
  RT_S1_FINGER_HEIGHT_CONSISTENCY, RT_S1_THUMB_ROTATION, RT_S2_THUMB_CONTACT,
  RT_S2_OTHER_FINGERS_CONTACT, RT_S2_GRASP_ACHIEVEMENT, RT_S2_FINGERPAD_PROXIMITY,
  RT_S2_BASE_STABILITY, RT_S3_OBJECT_HEIGHT, RT_S3_GRASP_MAINTENANCE, RT_S3_GRASP_DURATION,
  RT_S1_COMPLETION, RT_S2_COMPLETION, RT_PENETRATION_PENALTY, RT_UNDER_BOX_PENALTY,
  RT_COUNT
};
enum { SC_GRASP_LIFT_SUCCESS, SC_COUNT };
enum { FC_BOX_TOO_FAR = FC_HITTING_GROUND + 1, FC_S1_PREGRASP_FAILED, FC_S2_CONTACT_FAILED,
       FC_S3_GRASP_LOST, FC_COUNT };
#elif FS_TASK == 2
enum {
  RT_FINGERPAD_PROXIMITY = RT_TASK0, RT_FINGER_CONTACT, RT_LIFT, RT_TRANSPORT,
  RT_TRANSPORT_DELTA, RT_PLACE, RT_STACKED_HOLD, RT_RELEASE, RT_UNDER_BOX_PENALTY,
  RT_PLATFORM_DRIFT_PENALTY, RT_COUNT
};
enum { SC_STACK_SUCCESS, SC_COUNT };
enum { FC_BOX_TOO_FAR = FC_HITTING_GROUND + 1, FC_PLATFORM_MOVED, FC_COUNT };
#elif FS_TASK == 3
enum {
  RT_ORIENTATION_TRACKING = RT_TASK0, RT_ORIENTATION_DELTA, RT_FINGERPAD_PROXIMITY,
  RT_POSITION_STABILITY, RT_FINGER_CONTACT, RT_ALIGNMENT_HOLD, RT_COUNT
};
enum { SC_REORIENT_SUCCESS, SC_COUNT };
enum { FC_BOX_PUSHED_AWAY = FC_HITTING_GROUND + 1, FC_BOX_LIFTED, FC_COUNT };
#elif FS_TASK == 4
enum {
  RT_ORIENTATION_TRACKING = RT_TASK0, RT_ORIENTATION_DELTA, RT_GRASP_MAINTENANCE,
  RT_HEIGHT_KEEP, RT_ALIGNMENT_HOLD, RT_COUNT
};
enum { SC_REORIENT_SUCCESS, SC_COUNT };
enum { FC_BOX_DROPPED = FC_HITTING_GROUND + 1, FC_BOX_ESCAPED, FC_COUNT };
#elif FS_TASK == 5
enum {
  RT_DISTANCE_TRACKING = RT_TASK0, RT_DISTANCE_DELTA, RT_FINGERPAD_PROXIMITY,
  RT_FINGER_CONTACT, RT_TARGET_HOLD, RT_COUNT
};
enum { SC_PUSH_SUCCESS, SC_COUNT };
enum { FC_BOX_LOST = FC_HITTING_GROUND + 1, FC_BOX_LIFTED, FC_COUNT };
#else
enum { RT_COUNT = RT_TASK0 };
enum { SC_COUNT = 0 };
enum { FC_COUNT = FC_HITTING_GROUND + 1 };
#endif

// component kinds: 0 raw term, 1 weighted term, then TERM_COMPONENTS order
enum { CK_RAW, CK_WEIGHTED, CK_TOTAL, CK_TERM_SUCCESS, CK_TERM_SUCCESS_W,
       CK_TERM_FAILURE, CK_TERM_FAILURE_W, CK_TERM_TIMEOUT, CK_TERM_TIMEOUT_W };

#define FS_SQRT_HALF 0.7071067811865476f
#define FS_HALF_PI 1.5707963267948966f

// everything the observation plan can read, per env: the default keys' and
// the box's, then the task's (each build holds its own task's fields only, so
// that one task's observations cost another build's staging nothing)
struct FsObs {
  float q[LP_MAXB], dvel[LP_MAXB], full[LP_MAXB], t[18], acts[32];
  float hand_pos[3], hand_quat[4];
  float tip_pos[5][3], tip_quat[5][4], pad_pos[5][3], pad_quat[5][4];
  float cfc[8][3], mags[8], binary[8];
  int new_dur[8], epi_old;
  float box[LP_BOX_ROWS];  // the box (and the platform cube: rows 13-25)
#if FS_TASK >= 1
  float d_f2o[5];          // fingerpad-to-box distances
#endif
#if FS_TASK >= 2
  float fob[5];            // fingers on the box
#endif
#if FS_TASK == 1
  float hdiff[5], h2o, fpd[10], centroid[3];
  float thumb, other, grasp, grasp_dur, stage, tis, progress;
#elif FS_TASK == 2
  float to_target[3], stack_dist, hold_dur;
#elif FS_TASK == 3 || FS_TASK == 4
  float yaw_sc[2], target_sc[2], yaw_err, aligned_dur;
#if FS_TASK == 3
  float drift;
#else
  float rel_hand[3], grasp;
#endif
#elif FS_TASK == 5
  float target_xy[2], to_target[2], dist, hold_dur;
#endif
};

// the task step's new task state, read by the reset merge
struct FsTaskState {
  int steps;  // BlindGrasping: success duration; BoxStacking, BoxPushing: hold
              // duration; the reorientation tasks: aligned duration
#if FS_TASK == 1
  int stage;
  float tis, scd;
  bool s1c, s2c, cond;
#elif FS_TASK >= 2
  float last;  // BoxStacking: transport distance; the reorientation tasks:
               // yaw error; BoxPushing: distance to the target
#endif
};

// lane 0's working set after the physics, in the env's LpEnv union (after
// the output rows): shared memory, not the thread's stack, since the lane
// indexes it by runtime values
struct FsWork {
  FsObs o;
  FsTaskState ts;
  float r[RT_COUNT];
  bool fail[FC_COUNT];
  bool succ[SC_COUNT > 0 ? SC_COUNT : 1];
  int sflag_new[8], fflag_new[8], contacts[8];
};
#define FS_WORK_FLOATS ((int)((sizeof(FsWork) + sizeof(float) - 1) / sizeof(float)))

LP_DEV float fs_norm3(const float* a, const float* b) {
  float x = a[0] - b[0], y = a[1] - b[1], z = a[2] - b[2];
  return sqrtf(x * x + y * y + z * z);
}

LP_DEV float fs_clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

LP_DEV void fs_pose_hand(const FsObs& o, const float* p, const float* qt, float* out) {
  float d[3] = {p[0] - o.hand_pos[0], p[1] - o.hand_pos[1], p[2] - o.hand_pos[2]};
  float hc[4] = {-o.hand_quat[0], -o.hand_quat[1], -o.hand_quat[2], o.hand_quat[3]};
  lp_qrot(hc, d, out);
  lp_qmul(hc, qt, out + 3);
}

// Write one observation key's values as rows [row, row + width) of obs.
LP_DEV int fs_put_obs(int key, const FsObs& o, const FusedConfig* c, float* obs, int row) {
#define PUT(v) obs[row++] = (v)
  float tmp[7];
  switch (key) {
    case OK_BASE_DOF_POS: for (int j = 0; j < 6; ++j) PUT(o.q[j]); break;
    case OK_BASE_DOF_VEL: for (int j = 0; j < 6; ++j) PUT(o.dvel[j]); break;
    case OK_ACTIVE_FINGER_DOF_POS: for (int j = 6; j < 18; ++j) PUT(o.q[c->act_idx[j]]); break;
    case OK_ACTIVE_FINGER_DOF_VEL: for (int j = 6; j < 18; ++j) PUT(o.dvel[c->act_idx[j]]); break;
    case OK_ALL_FINGER_DOF_POS: for (int j = 6; j < 26; ++j) PUT(o.q[j]); break;
    case OK_ALL_FINGER_DOF_VEL: for (int j = 6; j < 26; ++j) PUT(o.dvel[j]); break;
    case OK_HAND_POSE:
      for (int j = 0; j < 3; ++j) PUT(o.hand_pos[j]);
      for (int j = 0; j < 4; ++j) PUT(o.hand_quat[j]);
      break;
    case OK_HAND_POSE_ARR_ALIGNED: {
      const float inv[4] = {0.f, -FS_SQRT_HALF, 0.f, FS_SQRT_HALF};
      lp_qmul(o.hand_quat, inv, tmp);
      for (int j = 0; j < 3; ++j) PUT(o.hand_pos[j]);
      for (int j = 0; j < 4; ++j) PUT(tmp[j]);
    } break;
    case OK_CONTACT_FORCES:
      for (int b = 0; b < c->nc; ++b) for (int j = 0; j < 3; ++j) PUT(o.cfc[b][j]);
      break;
    case OK_CONTACT_FORCE_MAGNITUDE: for (int b = 0; b < c->nc; ++b) PUT(o.mags[b]); break;
    case OK_CONTACT_BINARY: for (int b = 0; b < c->nc; ++b) PUT(o.binary[b]); break;
    case OK_CONTACT_DURATION:
      for (int b = 0; b < c->nc; ++b) PUT((float)o.new_dur[b] * c->control_dt);
      break;
    case OK_PREV_ACTIONS: for (int j = 0; j < c->n_act; ++j) PUT(o.acts[j]); break;
    case OK_ACTIVE_PREV_TARGETS: for (int j = 0; j < 18; ++j) PUT(o.t[j]); break;
    case OK_BASE_DOF_TARGET: for (int j = 0; j < 6; ++j) PUT(o.full[j]); break;
    case OK_ACTIVE_FINGER_DOF_TARGET:
      for (int j = 6; j < 18; ++j) PUT(o.full[c->act_idx[j]]);
      break;
    case OK_ALL_FINGER_DOF_TARGET: for (int j = 6; j < 26; ++j) PUT(o.full[j]); break;
    case OK_FINGERTIP_POSES_WORLD:
      for (int f = 0; f < 5; ++f) {
        for (int j = 0; j < 3; ++j) PUT(o.tip_pos[f][j]);
        for (int j = 0; j < 4; ++j) PUT(o.tip_quat[f][j]);
      }
      break;
    case OK_FINGERTIP_POSES_HAND:
      for (int f = 0; f < 5; ++f) {
        fs_pose_hand(o, o.tip_pos[f], o.tip_quat[f], tmp);
        for (int j = 0; j < 7; ++j) PUT(tmp[j]);
      }
      break;
    case OK_FINGERPAD_POSES_WORLD:
      for (int f = 0; f < 5; ++f) {
        for (int j = 0; j < 3; ++j) PUT(o.pad_pos[f][j]);
        for (int j = 0; j < 4; ++j) PUT(o.pad_quat[f][j]);
      }
      break;
    case OK_FINGERPAD_POSES_HAND:
      for (int f = 0; f < 5; ++f) {
        fs_pose_hand(o, o.pad_pos[f], o.pad_quat[f], tmp);
        for (int j = 0; j < 7; ++j) PUT(tmp[j]);
      }
      break;
    case OK_EPISODE_TIME: PUT((float)o.epi_old * c->control_dt); break;
    case OK_OBJECT_POS: for (int j = 0; j < 3; ++j) PUT(o.box[j]); break;
    case OK_OBJECT_QUAT: for (int j = 0; j < 4; ++j) PUT(o.box[3 + j]); break;
    case OK_OBJECT_VEL: for (int j = 0; j < 3; ++j) PUT(o.box[7 + j]); break;
    case OK_OBJECT_ANGVEL: for (int j = 0; j < 3; ++j) PUT(o.box[10 + j]); break;
#if FS_TASK >= 1
    case OK_FINGER_TO_OBJECT_DISTANCES: for (int f = 0; f < 5; ++f) PUT(o.d_f2o[f]); break;
#endif
#if FS_TASK >= 2
    case OK_FINGERS_ON_BOX: for (int f = 0; f < 5; ++f) PUT(o.fob[f]); break;
#endif
#if FS_TASK == 1
    case OK_AVG_FINGER_TO_OBJECT_DISTANCE:
      PUT((o.d_f2o[0] + o.d_f2o[1] + o.d_f2o[2] + o.d_f2o[3] + o.d_f2o[4]) / 5.0f);
      break;
    case OK_FINGER_TO_OBJECT_HEIGHT_DIFF: for (int f = 0; f < 5; ++f) PUT(o.hdiff[f]); break;
    case OK_AVG_FINGER_TO_OBJECT_HEIGHT_DIFF:
      PUT((o.hdiff[0] + o.hdiff[1] + o.hdiff[2] + o.hdiff[3] + o.hdiff[4]) / 5.0f);
      break;
    case OK_HAND_TO_OBJECT_DISTANCE: PUT(o.h2o); break;
    case OK_FINGERPAD_DISTANCES: for (int j = 0; j < 10; ++j) PUT(o.fpd[j]); break;
    case OK_FIRST_THREE_FINGERPAD_CENTROID: for (int j = 0; j < 3; ++j) PUT(o.centroid[j]); break;
    case OK_THUMB_CONTACT: PUT(o.thumb); break;
    case OK_OTHER_FINGERS_CONTACT: PUT(o.other); break;
    case OK_GRASP_DURATION: PUT(o.grasp_dur); break;
    case OK_CURRENT_STAGE: PUT(o.stage); break;
    case OK_TIME_IN_STAGE: PUT(o.tis); break;
    case OK_STAGE_PROGRESS: PUT(o.progress); break;
#endif
#if FS_TASK == 1 || FS_TASK == 4
    case OK_GRASP_STATE: PUT(o.grasp); break;
#endif
#if FS_TASK == 2
    case OK_PLATFORM_POS: for (int j = 0; j < 3; ++j) PUT(o.box[13 + j]); break;
    case OK_PLATFORM_QUAT: for (int j = 0; j < 4; ++j) PUT(o.box[16 + j]); break;
    case OK_TO_STACK_TARGET: for (int j = 0; j < 3; ++j) PUT(o.to_target[j]); break;
    case OK_STACK_DIST: PUT(o.stack_dist); break;
#endif
#if FS_TASK == 2 || FS_TASK == 5
    case OK_HOLD_DURATION: PUT(o.hold_dur); break;
#endif
#if FS_TASK == 3 || FS_TASK == 4
    case OK_OBJECT_YAW_SINCOS: PUT(o.yaw_sc[0]); PUT(o.yaw_sc[1]); break;
    case OK_TARGET_YAW_SINCOS: PUT(o.target_sc[0]); PUT(o.target_sc[1]); break;
    case OK_YAW_ERROR: PUT(o.yaw_err); break;
    case OK_ALIGNED_DURATION: PUT(o.aligned_dur); break;
#endif
#if FS_TASK == 3
    case OK_BOX_DRIFT: PUT(o.drift); break;
#elif FS_TASK == 4
    case OK_OBJECT_REL_HAND: for (int j = 0; j < 3; ++j) PUT(o.rel_hand[j]); break;
#elif FS_TASK == 5
    case OK_TARGET_XY: PUT(o.target_xy[0]); PUT(o.target_xy[1]); break;
    case OK_TO_TARGET: PUT(o.to_target[0]); PUT(o.to_target[1]); break;
    case OK_DIST_TO_TARGET: PUT(o.dist); break;
#endif
  }
#undef PUT
  return row;
}

// Action pipeline (envs/action.py process_actions): the active targets t
// (18) and the full 26-DOF targets from the actions and the previous active
// targets.
LP_DEV void fs_actions(const LaneModel* m, const FusedConfig* c, const float* rows_f,
                       const float* act, float* t, float* full) {
  float prev_t[18];
  for (int j = 0; j < 18; ++j) {
    prev_t[j] = rows_f[c->f_active_prev_targets + j];
    t[j] = prev_t[j];
  }
  int ofs = 0;
  for (int part = 0; part < 2; ++part) {
    bool on = part == 0 ? c->controls_base : c->controls_fingers;
    if (!on) continue;
    int base = part == 0 ? 0 : 6, cnt = part == 0 ? 6 : 12;
    for (int j = 0; j < cnt; ++j) {
      int d = base + j;
      float a = act[ofs + j];
      t[d] = c->position_mode ? (a + 1.0f) * 0.5f * (c->hi[d] - c->lo[d]) + c->lo[d]
                              : prev_t[d] + a * c->md[d];
    }
    ofs += cnt;
  }
  if (!c->position_mode)
    for (int d = 0; d < 18; ++d) t[d] = fminf(fmaxf(t[d], c->lo[d]), c->hi[d]);
  for (int f = 0; f < c->n_filters; ++f) {
    for (int d = 0; d < 18; ++d) {
      if (c->filters[f] == 1)
        t[d] = prev_t[d] + fminf(fmaxf(t[d] - prev_t[d], -c->md[d]), c->md[d]);
      else
        t[d] = fminf(fmaxf(t[d], c->lo[d]), c->hi[d]);
    }
  }
  for (int d = 0; d < m->nb; ++d)
    full[d] = c->cscale[d] != 0.f ? t[c->csrc[d]] * c->cscale[d] : 0.f;
}

// The task steps: task observations into o, the task's criteria into
// fail[]/succ[], its reward terms into r[] and its new task state into ts.
#if FS_TASK == 1
// BlindGrasping (blind_grasping.py lane_step). bf is the box's contact
// force; min_tip the lowest fingertip z.
LP_DEV void fs_task_step(const FusedConfig* c, const float* rows_f, const int* rows_i,
                         const float* bf, float min_tip, FsWork* wk) {
#define FR(r) rows_f[(r)]
#define IR(r) rows_i[(r)]
  FsObs& o = wk->o;
  FsTaskState& ts = wk->ts;
  bool* fail = wk->fail;
  bool* succ = wk->succ;
  float* r = wk->r;
  const float dt = c->control_dt;
  float init_box[3];
  for (int j = 0; j < 3; ++j) init_box[j] = FR(c->f_initial_box_pos + j);
  const int stage_old = IR(c->i_current_stage);
  const int sds_old = IR(c->i_success_duration_steps);
  const float tis_old = FR(c->f_time_in_stage);
  const float scd_old = FR(c->f_stage_contact_duration);
  const float* bpos = o.box;
  const float* bvel = o.box + 7;
  for (int f = 0; f < 5; ++f) {
    o.d_f2o[f] = fs_norm3(o.pad_pos[f], bpos);
    o.hdiff[f] = fabsf(o.pad_pos[f][2] - bpos[2]);
  }
  o.h2o = fs_norm3(o.hand_pos, bpos);
  for (int a = 0, e = 0; a < 5; ++a)
    for (int b = a + 1; b < 5; ++b) o.fpd[e++] = fs_norm3(o.pad_pos[a], o.pad_pos[b]);
  for (int j = 0; j < 3; ++j)
    o.centroid[j] = (o.pad_pos[0][j] + o.pad_pos[1][j] + o.pad_pos[2][j]) / 3.0f;
  const float zero3[3] = {0.f, 0.f, 0.f};
  bool box_has = fs_norm3(bf, zero3) > c->bg_contact_thr;
  bool fingc[5], fb[5];
  int num_on_box = 0;
  for (int f = 0; f < 5; ++f) {
    fingc[f] = o.binary[f] > 0.5f;
    fb[f] = fingc[f] && box_has && (o.d_f2o[f] < c->bg_prox_thr);
    num_on_box += fb[f] ? 1 : 0;
  }
  bool thumb_c = fb[0], other_c = fb[1] || fb[2] || fb[3] || fb[4];
  bool grasp = thumb_c && other_c;
  o.thumb = thumb_c ? 1.f : 0.f;
  o.other = other_c ? 1.f : 0.f;
  o.grasp = grasp ? 1.f : 0.f;
  bool cond = (bpos[2] > c->bg_height_thr) && (num_on_box >= c->bg_min_fingers);
  int steps = cond ? sds_old + 1 : 0;
  o.grasp_dur = (float)steps * dt;
  int stage = stage_old;
  float tis = tis_old + dt;
  bool thumb_and_other = fingc[0] && (fingc[1] || fingc[2] || fingc[3] || fingc[4]);
  bool in_s2 = stage == 2;
  float scd = in_s2 ? (thumb_and_other ? scd_old + dt : 0.f) : scd_old;
  bool s1c = (stage == 1) && (tis >= c->bg_s1_dur);
  bool s2c = (in_s2 && (scd >= c->bg_s2_contact_thr)) || (in_s2 && (tis >= c->bg_s2_dur));
  if (s1c) stage = 2;
  if (s2c) stage = 3;
  if (s1c || s2c) { tis = 0.f; scd = 0.f; }
  o.stage = (float)stage;
  o.tis = tis;
  o.progress = stage == 1 ? fs_clip01(tis / c->bg_s1_dur)
                          : (stage == 2 ? fs_clip01(tis / c->bg_s2_dur) : 1.f);
  bool hdiff3_ok = (o.hdiff[0] <= c->bg_tol_h) && (o.hdiff[1] <= c->bg_tol_h) &&
                   (o.hdiff[2] <= c->bg_tol_h);
  float centroid_dist = fs_norm3(o.centroid, bpos);
  float drift = fs_norm3(bpos, init_box);
  float velmag = fs_norm3(bvel, zero3);
  bool pregrasp_ok = hdiff3_ok && (centroid_dist <= c->bg_tol_c) &&
                     (drift <= c->bg_tol_drift) && (velmag <= c->bg_tol_vel);
  fail[FC_BOX_TOO_FAR] = o.h2o > c->bg_max_box_dist;
  fail[FC_S1_PREGRASP_FAILED] = s1c && !pregrasp_ok;
  fail[FC_S2_CONTACT_FAILED] = s2c && !grasp;
  fail[FC_S3_GRASP_LOST] = (stage == 3) && !grasp;
  succ[SC_GRASP_LIFT_SUCCESS] = steps >= c->bg_threshold_steps;

  float s1 = stage == 1 ? 1.f : 0.f, s2 = stage == 2 ? 1.f : 0.f, s3 = stage == 3 ? 1.f : 0.f;
  float avg_h = (o.hdiff[0] + o.hdiff[1] + o.hdiff[2] + o.hdiff[3] + o.hdiff[4]) / 5.0f;
  r[RT_S1_HEIGHT_ALIGNMENT] = expf(-c->bg_d_ha * avg_h) * s1;
  r[RT_S1_CENTROID_POSITIONING] = expf(-c->bg_d_cp * centroid_dist) * s1;
  r[RT_S1_OBJECT_STABILITY] = expf(-c->bg_d_os * (drift + velmag)) * s1;
  float h0 = o.pad_pos[0][2], h1 = o.pad_pos[1][2], h2 = o.pad_pos[2][2];
  float hm = (h0 + h1 + h2) / 3.0f;
  float hvar = ((h0 - hm) * (h0 - hm) + (h1 - hm) * (h1 - hm) + (h2 - hm) * (h2 - hm)) / 2.0f;
  r[RT_S1_FINGER_HEIGHT_CONSISTENCY] = expf(-c->bg_d_fhc * hvar) * s1;
  r[RT_S1_THUMB_ROTATION] = expf(-5.0f * fabsf(o.q[6] - FS_HALF_PI)) * s1;
  r[RT_S2_THUMB_CONTACT] = o.thumb * s2;
  r[RT_S2_OTHER_FINGERS_CONTACT] = o.other * s2;
  r[RT_S2_GRASP_ACHIEVEMENT] = o.grasp * s2;
  float min_dist = fs_norm3(o.tip_pos[0], bpos);
  for (int f = 1; f < 5; ++f) min_dist = fminf(min_dist, fs_norm3(o.tip_pos[f], bpos));
  r[RT_S2_FINGERPAD_PROXIMITY] = expf(-c->bg_d_fpp * fmaxf(min_dist, c->bg_min_reward_dist)) * s2;
  float bv = 0.f;
  for (int j = 0; j < 6; ++j) bv += o.dvel[j] * o.dvel[j];
  r[RT_S2_BASE_STABILITY] = expf(-c->bg_d_bs * sqrtf(bv)) * s2;
  r[RT_S3_OBJECT_HEIGHT] = fs_clip01((bpos[2] - c->bg_box_z) / c->bg_s3_den) * s3;
  r[RT_S3_GRASP_MAINTENANCE] = o.grasp * s3;
  r[RT_S3_GRASP_DURATION] = fs_clip01(o.grasp_dur / c->bg_cdt) * s3;
  r[RT_S1_COMPLETION] = (s1c && !fail[FC_S1_PREGRASP_FAILED]) ? 1.f : 0.f;
  r[RT_S2_COMPLETION] = (s2c && !fail[FC_S2_CONTACT_FAILED]) ? 1.f : 0.f;
  r[RT_PENETRATION_PENALTY] = fmaxf(c->bg_pen_thr - min_dist, 0.f) * c->bg_pen_scale;
  float under = 0.f;
  for (int f = 0; f < 5; ++f) {
    bool in_fp = (fabsf(o.tip_pos[f][0] - bpos[0]) < c->bg_ub_half) &&
                 (fabsf(o.tip_pos[f][1] - bpos[1]) < c->bg_ub_half);
    under += (in_fp ? 1.f : 0.f) * fmaxf(c->bg_ub_margin - o.tip_pos[f][2], 0.f);
  }
  r[RT_UNDER_BOX_PENALTY] = under * (bpos[2] < c->bg_ub_ground_z ? 1.f : 0.f);
  (void)min_tip;
  ts.stage = stage; ts.steps = steps; ts.tis = tis; ts.scd = scd;
  ts.s1c = s1c; ts.s2c = s2c; ts.cond = cond;
#undef FR
#undef IR
}
#elif FS_TASK == 2
// BoxStacking (box_stacking.py lane_step): the pick cube is the box, the
// platform the second box (o.box rows 13-25). bf is the box's contact force.
LP_DEV void fs_task_step(const FusedConfig* c, const float* rows_f, const int* rows_i,
                         const float* bf, float min_tip, FsWork* wk) {
  FsObs& o = wk->o;
  bool* fail = wk->fail;
  float* r = wk->r;
  const float dt = c->control_dt;
  const float* bpos = o.box;
  const float* bvel = o.box + 7;
  const float* ppos = o.box + 13;
  const float sd = rows_f[c->f_spawn_difficulty];
  const float spawn_x = rows_f[c->f_platform_spawn_xy], spawn_y = rows_f[c->f_platform_spawn_xy + 1];
  const float target[3] = {ppos[0], ppos[1], ppos[2] + c->bs_stack_dz};
  for (int j = 0; j < 3; ++j) o.to_target[j] = target[j] - bpos[j];
  const float* tt = o.to_target;
  const float transport_dist = sqrtf(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]);
  const float xy_err = sqrtf(tt[0] * tt[0] + tt[1] * tt[1]);
  const float z_err = fabsf(tt[2]);
  const float speed = sqrtf(bvel[0] * bvel[0] + bvel[1] * bvel[1] + bvel[2] * bvel[2]);
  o.stack_dist = transport_dist;
  for (int f = 0; f < 5; ++f) o.d_f2o[f] = fs_norm3(o.pad_pos[f], bpos);
  // finger-box contact (tasks/api.py detect_finger_box_contacts)
  const bool box_has = sqrtf(bf[0] * bf[0] + bf[1] * bf[1] + bf[2] * bf[2]) > c->bs_contact_thr;
  int n_on_i = 0;
  for (int f = 0; f < 5; ++f) {
    bool fb = (o.binary[f] > 0.5f) && box_has && (o.d_f2o[f] < c->bs_prox_thr);
    o.fob[f] = fb ? 1.f : 0.f;
    n_on_i += fb ? 1 : 0;
  }
  const float n_on = (float)n_on_i;
  // the bridge anneal: 1 at difficulty 0 -> 0 at release_anneal_end
  const float bridge = c->bs_release_end > 0.f ? fs_clip01(1.0f - sd / c->bs_release_end) : 0.f;
  const float relax = 1.0f + (c->bs_tol_relax - 1.0f) * bridge;
  const bool at_pose = (xy_err < c->bs_pos_tol * relax) && (z_err < c->bs_height_tol * relax);
  const int allowed = (int)floorf(3.0f * bridge + 1e-6f);
  const bool stacked = at_pose && (speed < c->bs_rest_speed) && (n_on_i <= allowed);
  const int steps = stacked ? rows_i[c->i_hold_duration_steps] + 1 : 0;
  o.hold_dur = (float)steps * dt;
  const float hold_secs = c->bs_hold_thr - (c->bs_hold_thr - c->bs_hold_min) * bridge;
  wk->succ[SC_STACK_SUCCESS] = steps >= (int)rintf(hold_secs / dt);
  const float mx = ppos[0] - spawn_x, my = ppos[1] - spawn_y;
  const float plat_moved = sqrtf(mx * mx + my * my);
  fail[FC_BOX_TOO_FAR] = sqrtf(bpos[0] * bpos[0] + bpos[1] * bpos[1]) > c->bs_box_far;
  fail[FC_PLATFORM_MOVED] = plat_moved > c->bs_move_tol * relax;
  if (c->bs_hg_override) {
    // the task's hitting_ground: each tip's limit relaxes by the bridged
    // margin, and by the pocket margin while the cube and the tip are in
    // the pocket around the stack point
    const bool cube_in_pocket = transport_dist < c->bs_pocket_radius;
    const float pocket_bridge =
        c->bs_pocket_end > 0.f ? fs_clip01(1.0f - sd / c->bs_pocket_end) : 0.f;
    bool tip_violation = false;
    for (int f = 0; f < 5; ++f) {
      const float* tp = o.tip_pos[f];
      const float dx = tp[0] - target[0], dy = tp[1] - target[1];
      const float tip_xy = sqrtf(dx * dx + dy * dy);
      const float mg = c->bs_tip_bridge_margin * bridge +
          ((cube_in_pocket && tip_xy < c->bs_pocket_radius) ? c->bs_pocket_margin * pocket_bridge
                                                             : 0.f);
      tip_violation = tip_violation || (tp[2] < c->bs_fingertip_thr - mg);
    }
    fail[FC_HITTING_GROUND] = (o.hand_pos[2] < c->bs_handbase_thr) || tip_violation;
  }
  float dmin = o.d_f2o[0];
  for (int f = 1; f < 5; ++f) dmin = fminf(dmin, o.d_f2o[f]);
  r[RT_FINGERPAD_PROXIMITY] = expf(-c->bs_d_prox * dmin);
  r[RT_FINGER_CONTACT] = fminf(n_on, 3.0f) / 3.0f;
  const bool carrying = (n_on_i >= 2) && (bpos[2] > c->bs_lift_z) && !at_pose;
  r[RT_LIFT] = carrying ? 1.f : 0.f;
  r[RT_TRANSPORT] = (carrying ? 1.f : 0.f) * expf(-c->bs_d_transport * transport_dist);
  r[RT_TRANSPORT_DELTA] = rows_f[c->f_prev_transport_dist] - transport_dist;
  r[RT_PLACE] = expf(-c->bs_d_place * (xy_err + z_err));
  r[RT_STACKED_HOLD] = stacked ? 1.f : 0.f;
  r[RT_RELEASE] = (at_pose ? 1.f : 0.f) * (1.0f - fminf(n_on, 3.0f) / 3.0f);
  float under = 0.f;
  for (int f = 0; f < 5; ++f) {
    const float* tp = o.tip_pos[f];
    const bool in_fp = (fabsf(tp[0] - bpos[0]) < c->bs_ub_half) &&
                       (fabsf(tp[1] - bpos[1]) < c->bs_ub_half);
    under = under + (in_fp ? 1.f : 0.f) * fmaxf(c->bs_ub_margin - tp[2], 0.f);
  }
  r[RT_UNDER_BOX_PENALTY] = under * (bpos[2] < c->bs_ub_ground_z ? 1.f : 0.f);
  r[RT_PLATFORM_DRIFT_PENALTY] = fmaxf(plat_moved - c->bs_drift_free, 0.f) * (1.0f - bridge);
  wk->ts.steps = steps;
  wk->ts.last = transport_dist;
  (void)min_tip;
}
#elif FS_TASK >= 3
// The single-box tasks' common parts: the fingerpad-to-box distances and the
// fingers on the box (tasks/api.py detect_finger_box_contacts) into o, their
// count returned; bf is the box's contact force.
LP_DEV int fs_fingers_on_box(const FusedConfig* c, FsObs& o, const float* bf) {
  const float zero3[3] = {0.f, 0.f, 0.f};
  const bool box_has = fs_norm3(bf, zero3) > c->t_contact_thr;
  int n_on = 0;
  for (int f = 0; f < 5; ++f) {
    o.d_f2o[f] = fs_norm3(o.pad_pos[f], o.box);
    const bool fb = (o.binary[f] > 0.5f) && box_has && (o.d_f2o[f] < c->t_prox_thr);
    o.fob[f] = fb ? 1.f : 0.f;
    n_on += fb ? 1 : 0;
  }
  return n_on;
}

LP_DEV float fs_min5(const float* d) {
  float m = d[0];
  for (int f = 1; f < 5; ++f) m = fminf(m, d[f]);
  return m;
}

#if FS_TASK == 3 || FS_TASK == 4
// BoxReorientation (box_reorientation.py lane_step: the box on the ground,
// turned in place) and InHandReorientation (in_hand_reorientation.py
// lane_step: the box pinched in mid-air): the box's yaw from its quaternion
// (_box_yaw), its error to the target modulo the cube's symmetry period
// (tasks/api.py symmetric_angle_error; rintf rounds half to even, as
// jnp.round and torch.round do), the aligned-duration counter and success.
LP_DEV void fs_task_step(const FusedConfig* c, const float* rows_f, const int* rows_i,
                         const float* bf, float min_tip, FsWork* wk) {
  FsObs& o = wk->o;
  bool* fail = wk->fail;
  float* r = wk->r;
  const float* bpos = o.box;
  const float* bq = o.box + 3;
  const float yaw = atan2f(2.0f * (bq[3] * bq[2] + bq[0] * bq[1]),
                           1.0f - 2.0f * (bq[1] * bq[1] + bq[2] * bq[2]));
  const float target = rows_f[c->f_target_yaw];
  const float e = yaw - target;
  const float err = e - c->ro_period * rintf(e / c->ro_period);
  const float abs_err = fabsf(err);
  o.yaw_sc[0] = sinf(yaw);
  o.yaw_sc[1] = cosf(yaw);
  o.target_sc[0] = sinf(target);
  o.target_sc[1] = cosf(target);
  o.yaw_err = err;
  const int n_on = fs_fingers_on_box(c, o, bf);
#if FS_TASK == 3
  const float dx = bpos[0] - rows_f[c->f_initial_box_pos];
  const float dy = bpos[1] - rows_f[c->f_initial_box_pos + 1];
  const float drift = sqrtf(dx * dx + dy * dy);
  o.drift = drift;
  const bool aligned = (abs_err < c->ro_yaw_tol) && (drift < c->ro_drift_tol);
#else
  for (int j = 0; j < 3; ++j) o.rel_hand[j] = bpos[j] - o.hand_pos[j];
  const float* rh = o.rel_hand;
  const float hand_dist = sqrtf(rh[0] * rh[0] + rh[1] * rh[1] + rh[2] * rh[2]);
  const float height_err = fabsf(bpos[2] - c->ih_hang_z);
  const bool grasped = (o.fob[0] > 0.5f) && ((o.fob[1] > 0.5f) || (o.fob[2] > 0.5f) ||
                                             (o.fob[3] > 0.5f) || (o.fob[4] > 0.5f));
  o.grasp = grasped ? 1.f : 0.f;
  const bool aligned = (abs_err < c->ro_yaw_tol) && (height_err < c->ih_drop_band);
#endif
  const int steps = aligned ? rows_i[c->i_aligned_duration_steps] + 1 : 0;
  o.aligned_dur = (float)steps * c->control_dt;
  wk->succ[SC_REORIENT_SUCCESS] = steps >= c->t_thr_steps;
  r[RT_ORIENTATION_TRACKING] = expf(-c->ro_d_orient * abs_err);
  r[RT_ORIENTATION_DELTA] = fabsf(rows_f[c->f_prev_yaw_error]) - abs_err;
  r[RT_ALIGNMENT_HOLD] = aligned ? 1.f : 0.f;
#if FS_TASK == 3
  fail[FC_BOX_PUSHED_AWAY] = drift > c->ro_max_drift;
  fail[FC_BOX_LIFTED] = bpos[2] > c->t_lift_z;
  r[RT_FINGERPAD_PROXIMITY] = expf(-c->t_d_prox * fs_min5(o.d_f2o));
  r[RT_POSITION_STABILITY] = expf(-c->ro_d_drift * drift);
  r[RT_FINGER_CONTACT] = n_on > 0 ? 1.f : 0.f;
#else
  fail[FC_BOX_DROPPED] = bpos[2] < c->ih_drop_z;
  fail[FC_BOX_ESCAPED] = hand_dist > c->ih_escape;
  r[RT_GRASP_MAINTENANCE] = o.grasp;
  r[RT_HEIGHT_KEEP] = expf(-c->ih_d_height * height_err);
  (void)n_on;
#endif
  wk->ts.steps = steps;
  wk->ts.last = err;
  (void)min_tip;
}
#else
// BoxPushing (box_pushing.py lane_step): the box's distance to the sampled
// target_xy, the hold counter at the target and success; the target and the
// distances come from the reset rows.
LP_DEV void fs_task_step(const FusedConfig* c, const float* rows_f, const int* rows_i,
                         const float* bf, float min_tip, FsWork* wk) {
  FsObs& o = wk->o;
  bool* fail = wk->fail;
  float* r = wk->r;
  const float* bpos = o.box;
  const float* bvel = o.box + 7;
  for (int j = 0; j < 2; ++j) {
    o.target_xy[j] = rows_f[c->f_target_xy + j];
    o.to_target[j] = o.target_xy[j] - bpos[j];
  }
  const float dist = sqrtf(o.to_target[0] * o.to_target[0] + o.to_target[1] * o.to_target[1]);
  o.dist = dist;
  const float speed = sqrtf(bvel[0] * bvel[0] + bvel[1] * bvel[1] + bvel[2] * bvel[2]);
  const int n_on = fs_fingers_on_box(c, o, bf);
  const bool at_target = (dist < c->bp_pos_tol) && (speed < c->bp_rest_speed);
  const int steps = at_target ? rows_i[c->i_hold_duration_steps] + 1 : 0;
  o.hold_dur = (float)steps * c->control_dt;
  wk->succ[SC_PUSH_SUCCESS] = steps >= c->t_thr_steps;
  fail[FC_BOX_LOST] = dist > rows_f[c->f_initial_dist] + c->bp_overshoot;
  fail[FC_BOX_LIFTED] = bpos[2] > c->t_lift_z;
  r[RT_DISTANCE_TRACKING] = expf(-c->bp_d_dist * dist);
  r[RT_DISTANCE_DELTA] = rows_f[c->f_prev_dist] - dist;
  r[RT_FINGERPAD_PROXIMITY] = expf(-c->t_d_prox * fs_min5(o.d_f2o));
  r[RT_FINGER_CONTACT] = n_on > 0 ? 1.f : 0.f;
  r[RT_TARGET_HOLD] = at_target ? 1.f : 0.f;
  wk->ts.steps = steps;
  wk->ts.last = dist;
  (void)min_tip;
}
#endif
#else
// BaseTask: no task step.
LP_DEV void fs_task_step(const FusedConfig* c, const float* rows_f, const int* rows_i,
                         const float* bf, float min_tip, FsWork* wk) {
  (void)c; (void)rows_f; (void)rows_i; (void)bf; (void)min_tip; (void)wk;
}
#endif

// The task's share of the done-masked reset merge: its task-state rows.
LP_DEV void fs_task_merge(const LaneModel* m, const FusedConfig* c, bool done,
                          const FsTaskState& ts, const float* rst, float* rows_f, int* rows_i) {
#define FR(r) rows_f[(r)]
#define IR(r) rows_i[(r)]
#if FS_TASK == 1
  for (int j = 0; j < 3; ++j)  // the initial box position is the reset box's
    FR(c->f_initial_box_pos + j) = done ? rst[m->nb + j] : FR(c->f_initial_box_pos + j);
  FR(c->f_time_in_stage) = done ? 0.f : ts.tis;
  FR(c->f_stage_contact_duration) = done ? 0.f : ts.scd;
  IR(c->i_current_stage) = done ? 1 : ts.stage;
  IR(c->i_just_t2) = done ? 0 : (int)ts.s1c;
  IR(c->i_just_t3) = done ? 0 : (int)ts.s2c;
  IR(c->i_success_conditions_met) = done ? 0 : (int)ts.cond;
  IR(c->i_success_duration_steps) = done ? 0 : ts.steps;
#elif FS_TASK == 2
  // every task state comes from the sampled reset rows
  for (int j = 0; j < 2; ++j)
    FR(c->f_platform_spawn_xy + j) = done ? rst[c->r_platform_spawn_xy + j]
                                          : FR(c->f_platform_spawn_xy + j);
  FR(c->f_prev_transport_dist) = done ? rst[c->r_prev_transport_dist] : ts.last;
  FR(c->f_spawn_difficulty) = done ? rst[c->r_spawn_difficulty] : FR(c->f_spawn_difficulty);
  IR(c->i_hold_duration_steps) = done ? (int)rst[c->r_hold_duration_steps] : ts.steps;
#elif FS_TASK == 3 || FS_TASK == 4
  // every task state comes from the sampled reset rows
  FR(c->f_target_yaw) = done ? rst[c->r_target_yaw] : FR(c->f_target_yaw);
#if FS_TASK == 3
  for (int j = 0; j < 3; ++j)
    FR(c->f_initial_box_pos + j) =
        done ? rst[c->r_initial_box_pos + j] : FR(c->f_initial_box_pos + j);
#endif
  FR(c->f_prev_yaw_error) = done ? rst[c->r_prev_yaw_error] : ts.last;
  IR(c->i_aligned_duration_steps) = done ? (int)rst[c->r_aligned_duration_steps] : ts.steps;
  (void)m;
#elif FS_TASK == 5
  // every task state comes from the sampled reset rows
  for (int j = 0; j < 2; ++j)
    FR(c->f_target_xy + j) = done ? rst[c->r_target_xy + j] : FR(c->f_target_xy + j);
  FR(c->f_initial_dist) = done ? rst[c->r_initial_dist] : FR(c->f_initial_dist);
  FR(c->f_prev_dist) = done ? rst[c->r_prev_dist] : ts.last;
  IR(c->i_hold_duration_steps) = done ? (int)rst[c->r_hold_duration_steps] : ts.steps;
  (void)m;
#else
  (void)m; (void)c; (void)done; (void)ts; (void)rst; (void)rows_f; (void)rows_i;
#endif
#undef FR
#undef IR
}

// Everything after the physics, on one lane: the default observations, the
// task's step, termination, rewards, the obs/reward/mask/component rows, and
// the done-masked reset merge into rows_f / rows_i (in place: the env's
// staged column). s holds the state after the physics and its final FK; t
// the active targets; mz the reset pose's lowest tip.
LP_DEV void fs_post(const LaneModel* m, const FusedConfig* c, const LpEnv* s, const float* t,
                    float mz, float* rows_f, int* rows_i, const float* act, float* rst,
                    const float* drn, float* rows_c, float* obs, float* rew, int* msk,
                    float* cmp, FsWork* wk) {
  const int nc = c->nc;
  const float dt = c->control_dt;
#define FR(r) rows_f[(r)]
#define IR(r) rows_i[(r)]
  FsObs& o = wk->o;
  const float* q0 = rows_f + c->f_q;  // the staged column: read here before the merge
  float drv_old[4];
  const float* qd = s->qd;
  const float* cf = s->cf;
  const float* bf = s->bf;
  for (int j = 0; j < c->n_act; ++j) o.acts[j] = act[j];
  for (int j = 0; j < 18; ++j) o.t[j] = t[j];
  for (int j = 0; j < m->nb; ++j) { o.q[j] = s->q[j]; o.full[j] = s->tgt[j]; }
  for (int j = 0; j < LP_BOX_ROWS; ++j) o.box[j] = s->box[j];
  for (int j = 0; j < 4; ++j) drv_old[j] = FR(c->f_dr[j]);
  const float* prev_cb = rows_f + c->f_prev_contact_binary;
  const float* prev_fvel = rows_f + c->f_prev_finger_dof_vel;
  const int* dur_old = rows_i + c->i_contact_duration_steps;
  const int* prev_contacts = rows_i + c->i_prev_contacts;
  float prev_hvel[3], prev_havel[3];
  for (int j = 0; j < 3; ++j) {
    prev_hvel[j] = FR(c->f_prev_hand_vel + j);
    prev_havel[j] = FR(c->f_prev_hand_ang_vel + j);
  }
  o.epi_old = IR(c->i_episode_step_count);

  // ---- the final FK: hand and fingertip/pad sites
  const int hb = c->hand_b;
  const float* hk = s->kin[hb];
  for (int j = 0; j < 3; ++j) o.hand_pos[j] = hk[j];
  for (int j = 0; j < 4; ++j) o.hand_quat[j] = hk[3 + j];
  float hand_lin[3], hand_ang[3];
  for (int j = 0; j < 3; ++j) { hand_lin[j] = hk[7 + j]; hand_ang[j] = hk[10 + j]; }
  for (int f = 0; f < 5; ++f) {
    lp_site(m, s->kin, c->tip_site[f], o.tip_pos[f], o.tip_quat[f]);
    lp_site(m, s->kin, c->pad_site[f], o.pad_pos[f], o.pad_quat[f]);
  }

  // ---- default observations (prev_dof_pos == pre-physics q)
  for (int j = 0; j < m->nb; ++j) o.dvel[j] = (o.q[j] - q0[j]) / dt;
  for (int b = 0; b < nc; ++b) {
    const float* f3 = &cf[3 * c->contact_body[b]];
    for (int j = 0; j < 3; ++j) o.cfc[b][j] = f3[j];
    o.mags[b] = sqrtf(f3[0] * f3[0] + f3[1] * f3[1] + f3[2] * f3[2]);
    o.binary[b] = o.mags[b] > c->contact_binary_threshold ? 1.f : 0.f;
    bool started = o.binary[b] > 0.5f && prev_cb[b] < 0.5f;
    bool active = o.binary[b] > 0.5f;
    o.new_dur[b] = started ? 1 : (active ? dur_old[b] + 1 : 0);
  }

  // ---- the task's step, then the builtin hitting-ground check unless the
  // task gave its own
  bool* fail = wk->fail;
  bool* succ = wk->succ;
  float min_tip = o.tip_pos[0][2];
  for (int f = 1; f < 5; ++f) min_tip = fminf(min_tip, o.tip_pos[f][2]);
  fs_task_step(c, rows_f, rows_i, bf, min_tip, wk);
#if FS_TASK == 2
  const bool task_hg = c->bs_hg_override != 0;
#else
  const bool task_hg = false;
#endif
  if (!task_hg)
    fail[FC_HITTING_GROUND] = c->has_height_safety &&
        ((o.hand_pos[2] < c->handbase_threshold) || (min_tip < c->fingertip_threshold));

  // ---- termination (termination.py evaluate_termination)
  const int new_count = o.epi_old + 1;
  bool ep_succ = false, ep_fail = false;
  int* sflag_new = wk->sflag_new;
  int* fflag_new = wk->fflag_new;
  for (int j = 0; j < c->n_sflags; ++j) {
    bool cr = succ[c->sflag_crit[j]];
    sflag_new[j] = ((!ep_succ && cr) || IR(c->sflag_row[j]) != 0) ? 1 : 0;
    ep_succ = ep_succ || cr;
  }
  for (int j = 0; j < c->n_fflags; ++j) {
    bool cr = fail[c->fflag_crit[j]];
    fflag_new[j] = ((!ep_fail && cr) || IR(c->fflag_row[j]) != 0) ? 1 : 0;
    ep_fail = ep_fail || cr;
  }
  bool timeout = new_count >= c->max_episode_length - 1;
  bool done = ep_succ || ep_fail || timeout;
  bool succ_t = ep_succ && done;
  bool fail_t = ep_fail && !ep_succ && done;
  bool tout_t = timeout && !ep_succ && !ep_fail && done;
  float term_reward = (succ_t ? 1.f : 0.f) * c->success_reward -
                      (fail_t ? 1.f : 0.f) * c->failure_penalty -
                      (tout_t ? 1.f : 0.f) * c->timeout_penalty;

  // ---- rewards: common terms (the task's are in), weighted sum in
  // sorted-name order
  float* r = wk->r;
  const float zero3[3] = {0.f, 0.f, 0.f};
  const float* fvel = o.dvel + 6;
  float nf = 0.f, ndf = 0.f;
  for (int j = 0; j < 20; ++j) {
    float dv = fvel[j] - prev_fvel[j];
    nf += fvel[j] * fvel[j];
    ndf += dv * dv;
  }
  r[RT_ALIVE] = 1.f;
  r[RT_HEIGHT_SAFETY] = fs_clip01(1.0f - expf(-(min_tip - 0.02f) * 20.0f));
  r[RT_FINGER_VELOCITY] = expf(-0.1f * sqrtf(nf));
  r[RT_HAND_VELOCITY] = expf(-0.2f * fs_norm3(hand_lin, zero3));
  r[RT_HAND_ANGULAR_VELOCITY] = expf(-0.2f * fs_norm3(hand_ang, zero3));
  float over = 0.f;
  for (int j = 0; j < 20; ++j) {
    float rng = c->finger_upper[j] - c->finger_lower[j];
    if (rng > 0.f) over += fs_clip01(fabsf(2.0f * (o.q[6 + j] - c->finger_lower[j]) / rng - 1.0f) - 0.8f);
  }
  r[RT_JOINT_LIMIT] = 1.0f - over / 20.0f;
  r[RT_FINGER_ACCELERATION] = expf(-2.0f * sqrtf(ndf));
  r[RT_HAND_ACCELERATION] = expf(-0.5f * fs_norm3(hand_lin, prev_hvel));
  r[RT_HAND_ANGULAR_ACCELERATION] = expf(-0.5f * fs_norm3(hand_ang, prev_havel));
  int* contacts = wk->contacts;
  float changes = 0.f;
  for (int b = 0; b < nc; ++b) {
    contacts[b] = o.mags[b] > 0.1f ? 1 : 0;
    changes += (contacts[b] != (prev_contacts[b] != 0)) ? 1.f : 0.f;
  }
  r[RT_CONTACT_STABILITY] = expf(-changes);
  float total = 0.f;
  for (int j = 0; j < c->n_rew; ++j) total += r[c->rew_term[j]] * c->rew_w[j];

  // ---- output rows (terminal obs: computed before the merge)
  int row = 0;
  for (int j = 0; j < c->n_obs_keys; ++j) row = fs_put_obs(c->obs_keys[j], o, c, obs, row);
  rew[0] = total + term_reward;
  msk[0] = done;
  msk[1] = succ_t;
  msk[2] = fail_t;
  msk[3] = tout_t;
  for (int j = 0; j < c->n_comp; ++j) {
    int ti = c->comp_idx[j];
    float v = 0.f;
    switch (c->comp_kind[j]) {
      case CK_RAW: v = r[ti]; break;
      case CK_WEIGHTED: {
        for (int e = 0; e < c->n_rew; ++e) if (c->rew_term[e] == ti) v = r[ti] * c->rew_w[e];
      } break;
      case CK_TOTAL: v = total; break;
      case CK_TERM_SUCCESS: v = succ_t ? 1.f : 0.f; break;
      case CK_TERM_SUCCESS_W: v = (succ_t ? 1.f : 0.f) * c->success_reward; break;
      case CK_TERM_FAILURE: v = fail_t ? 1.f : 0.f; break;
      case CK_TERM_FAILURE_W: v = -(fail_t ? 1.f : 0.f) * c->failure_penalty; break;
      case CK_TERM_TIMEOUT: v = tout_t ? 1.f : 0.f; break;
      case CK_TERM_TIMEOUT_W: v = -(tout_t ? 1.f : 0.f) * c->timeout_penalty; break;
    }
    cmp[j] = v;
  }

  // ---- reset rows, spawn-projected (only the done envs read them); mz is
  // the lowest tip of the reset pose, computed for every env beforehand
  float* rdof = rst;  // the staged reset rows, projected in place
  float rbpos[3], rbquat[4];
  for (int j = 0; j < 3; ++j) rbpos[j] = rst[m->nb + j];
  for (int j = 0; j < 4; ++j) rbquat[j] = rst[m->nb + 3 + j];
  if (done && c->has_proj) rdof[2] = rdof[2] + fmaxf(0.f, c->proj_clear - mz);

  // ---- done-masked reset merge into the carried rows (in place)
  for (int j = 0; j < m->nb; ++j) {
    FR(c->f_q + j) = done ? rdof[j] : o.q[j];
    FR(c->f_qd + j) = done ? 0.f : qd[j];
    rows_c[c->c_full_dof_targets + j] = done ? rdof[j] : o.full[j];
  }
  for (int j = 0; j < m->nb * 3; ++j)
    rows_c[c->c_body_contact_force + j] = done ? 0.f : cf[j];
  for (int j = 0; j < 3; ++j) {
    FR(c->f_box_pos + j) = done ? rbpos[j] : o.box[j];
    FR(c->f_box_linvel + j) = done ? 0.f : o.box[7 + j];
    FR(c->f_box_angvel + j) = done ? 0.f : o.box[10 + j];
    FR(c->f_prev_hand_vel + j) = done ? 0.f : hand_lin[j];
    FR(c->f_prev_hand_ang_vel + j) = done ? 0.f : hand_ang[j];
  }
  for (int j = 0; j < 4; ++j) {
    FR(c->f_box_quat + j) = done ? rbquat[j] : o.box[3 + j];
    FR(c->f_dr[j]) = done ? drn[j] : drv_old[j];
  }
#if LP_HAS_BOX2
  // the platform cube: its reset pose follows the box's in the reset rows
  const float* rb2 = rst + m->nb + 7;
  for (int j = 0; j < 3; ++j) {
    FR(c->f_box2_pos + j) = done ? rb2[j] : o.box[13 + j];
    FR(c->f_box2_linvel + j) = done ? 0.f : o.box[20 + j];
    FR(c->f_box2_angvel + j) = done ? 0.f : o.box[23 + j];
  }
  for (int j = 0; j < 4; ++j) FR(c->f_box2_quat + j) = done ? rb2[3 + j] : o.box[16 + j];
#endif
  for (int j = 0; j < 18; ++j) FR(c->f_active_prev_targets + j) = done ? rdof[c->act_idx[j]] : o.t[j];
  for (int j = 0; j < c->n_act; ++j) FR(c->f_prev_actions + j) = done ? 0.f : o.acts[j];
  for (int b = 0; b < nc; ++b) {
    FR(c->f_prev_contact_binary + b) = done ? 0.f : o.binary[b];
    IR(c->i_contact_duration_steps + b) = done ? 0 : o.new_dur[b];
    IR(c->i_prev_contacts + b) = done ? 0 : contacts[b];
  }
  for (int j = 0; j < 20; ++j) FR(c->f_prev_finger_dof_vel + j) = done ? 0.f : fvel[j];
  IR(c->i_episode_step_count) = done ? 0 : new_count;
  for (int j = 0; j < c->n_sflags; ++j) IR(c->sflag_row[j]) = done ? 0 : sflag_new[j];
  for (int j = 0; j < c->n_fflags; ++j) IR(c->fflag_row[j]) = done ? 0 : fflag_new[j];
  fs_task_merge(m, c, done, wk->ts, rst, rows_f, rows_i);
#undef FR
#undef IR
}

// One env's slot: the lane physics, its staged column (rows_f | rows_i |
// actions | reset rows | DR | spawn), the active targets and the reset
// pose's lowest tip. The output rows (rows_c | obs | reward | masks |
// components) are assembled in the LpEnv union after the physics. The
// column's words per build, with room for up to 8 contact bodies:
// BlindGrasping's 231 (its cap of 240 kept), BaseTask's 206, BoxStacking's
// 239, BoxReorientation's 221, InHandReorientation's 214 and BoxPushing's 219.
#if FS_TASK == 1
#define FS_IN_CAP 240
#elif FS_TASK == 2
#define FS_IN_CAP 248
#elif FS_TASK >= 3
#define FS_IN_CAP 232
#else
#define FS_IN_CAP 224
#endif
struct FsEnv {
  LpEnv lp;
  float in[FS_IN_CAP];
  float t[18];
  float mz;
};
#define FS_STRIDE ((int)(sizeof(FsEnv) / sizeof(float)))

struct FsRows {  // word offsets of the staged rows
  int ri, act, rst, drn, spw, in_end;  // in FsEnv.in
  int obs, rew, msk, cmp, out_end;     // in the LpEnv union (rows_c at 0)
};

LP_DEV FsRows fs_rows(const FusedConfig* c) {
  FsRows r;
  r.ri = c->rows_f;
  r.act = r.ri + c->rows_i;
  r.rst = r.act + c->n_act;
  r.drn = r.rst + c->rst_rows;
  r.spw = r.drn + 4;
  r.in_end = r.spw + 3;
  r.obs = c->rows_c;
  r.rew = r.obs + c->obs_dim;
  r.msk = r.rew + 1;
  r.cmp = r.msk + 4;
  r.out_end = r.cmp + c->n_comp;
  return r;
}

// Lanes 0-3: the second box's carried rows into the lane physics' state.
LP_DEV void fs_load_box2(const FusedConfig* c, const float* rf, LpEnv* s, int lane) {
#if LP_HAS_BOX2
  if (lane < 3) {
    s->box[13 + lane] = rf[c->f_box2_pos + lane];
    s->box[20 + lane] = rf[c->f_box2_linvel + lane];
    s->box[23 + lane] = rf[c->f_box2_angvel + lane];
  }
  if (lane < 4) s->box[16 + lane] = rf[c->f_box2_quat + lane];
#else
  (void)c; (void)rf; (void)s; (void)lane;
#endif
}

// One env's step (half-warp): the action pipeline and the state on lane 0 and
// the lanes, the physics, the final FK, the spawn projection of the reset
// pose (for every env: whether it resets is known only after the task step;
// lp_min_site_z is the min_site_z kernel's code), then the rest on lane 0.
LP_DEV void fs_env(const LaneModel* m, const FusedConfig* c, FsEnv* f, LpLane* Ls) {
  LpEnv* s = &f->lp;
  float* rf = f->in;
  const FsRows o = fs_rows(c);
  LP_WARP(if (lane == 0) { fs_actions(m, c, rf, f->in + o.act, f->t, s->tgt); f->mz = 0.f; }
          LP_EACH_BODY(k, i, s->q[i] = rf[c->f_q + i]; s->qd[i] = rf[c->f_qd + i];)
          if (lane < 3) {
            s->box[lane] = rf[c->f_box_pos + lane];
            s->box[7 + lane] = rf[c->f_box_linvel + lane];
            s->box[10 + lane] = rf[c->f_box_angvel + lane];
            s->spawn[lane] = rf[o.spw + lane];
          }
          if (lane < 4) { s->box[3 + lane] = rf[c->f_box_quat + lane]; s->drv[lane] = rf[c->f_dr[lane]]; }
          fs_load_box2(c, rf, s, lane););
  for (int it = 0; it < m->total_substeps; ++it) lp_substep(m, s, Ls);
  lp_fk(m, s->q, s->qd, s->spawn, s->kin, (float (*)[6])0, Ls);
  float* u = (float*)&s->u;
  if (c->has_proj)
    lp_min_site_z(m, f->in + o.rst, c->proj_spawn, c->proj_site_mask, (float (*)[LP_KIN])u,
                  u + LP_MAXB * LP_KIN, &f->mz, Ls);
  LP_WARP(if (lane == 0)
            fs_post(m, c, s, f->t, f->mz, f->in, (int*)(f->in + o.ri), f->in + o.act,
                    f->in + o.rst, f->in + o.drn, u, u + o.obs, u + o.rew, (int*)(u + o.msk),
                    u + o.cmp, (FsWork*)(u + LP_UNION_FLOATS - FS_WORK_FLOATS)););
}

LP_DEV void fs_stage_in(const FusedConfig* c, FsEnv* envs, int e0, int n, const float* rows_f,
                        const int* rows_i, const float* act, const float* rst,
                        const float* drn, const float* spw, int tid, int nthr) {
  const FsRows o = fs_rows(c);
  float* b = envs[0].in;
  lp_stage_in(rows_f, c->rows_f, n, e0, b, FS_STRIDE, tid, nthr);
  lp_stage_in(rows_i, c->rows_i, n, e0, (int*)(b + o.ri), FS_STRIDE, tid, nthr);
  lp_stage_in(act, c->n_act, n, e0, b + o.act, FS_STRIDE, tid, nthr);
  lp_stage_in(rst, c->rst_rows, n, e0, b + o.rst, FS_STRIDE, tid, nthr);
  lp_stage_in(drn, 4, n, e0, b + o.drn, FS_STRIDE, tid, nthr);
  lp_stage_in(spw, 3, n, e0, b + o.spw, FS_STRIDE, tid, nthr);
}

LP_DEV void fs_stage_out(const FusedConfig* c, const FsEnv* envs, int e0, int n, float* rows_f,
                         int* rows_i, float* rows_c, float* obs, float* rew, int* msk,
                         float* cmp, int tid, int nthr) {
  const FsRows o = fs_rows(c);
  const float* b = envs[0].in;
  const float* u = (const float*)&envs[0].lp.u;
  lp_stage_out(rows_f, c->rows_f, n, e0, b, FS_STRIDE, tid, nthr);
  lp_stage_out(rows_i, c->rows_i, n, e0, (const int*)(b + o.ri), FS_STRIDE, tid, nthr);
  lp_stage_out(rows_c, c->rows_c, n, e0, u, FS_STRIDE, tid, nthr);
  lp_stage_out(obs, c->obs_dim, n, e0, u + o.obs, FS_STRIDE, tid, nthr);
  lp_stage_out(rew, 1, n, e0, u + o.rew, FS_STRIDE, tid, nthr);
  lp_stage_out(msk, 4, n, e0, (const int*)(u + o.msk), FS_STRIDE, tid, nthr);
  lp_stage_out(cmp, c->n_comp, n, e0, u + o.cmp, FS_STRIDE, tid, nthr);
}

#ifdef __CUDACC__
// rows_f / rows_i are read and written in place: a block stages all of its
// envs' columns before any warp runs, and writes them back after all have.
__global__ void __launch_bounds__(LP_THREADS, LP_MIN_BLOCKS)
    fused_step_kernel(const LaneModel* __restrict__ m, const FusedConfig* __restrict__ c,
                      float* rows_f, int* rows_i, const float* __restrict__ act,
                      const float* __restrict__ rst, const float* __restrict__ drn,
                      const float* __restrict__ spw, float* __restrict__ rows_c,
                      float* __restrict__ obs, float* __restrict__ rew,
                      int* __restrict__ msk, float* __restrict__ cmp, int n) {
  extern __shared__ float lp_smem[];
  FsEnv* envs = (FsEnv*)lp_smem;
  const int e0 = blockIdx.x * LP_ENVS, tid = threadIdx.x, nthr = blockDim.x;
  fs_stage_in(c, envs, e0, n, rows_f, rows_i, act, rst, drn, spw, tid, nthr);
  __syncthreads();
  const int e = tid / LP_W;
  const bool live = e0 + e < n;
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (live) {  // the env's half-warp takes the branch together
    LpLane L;
    L.mask = mask;
    fs_env(m, c, &envs[e], &L);
  }
  __syncthreads();
  fs_stage_out(c, envs, e0, n, rows_f, rows_i, rows_c, obs, rew, msk, cmp, tid, nthr);
}
#endif

extern "C" {

int fused_config_layout(LP_LAYOUT_ARGS) {
  LP_STRUCT_LAYOUT(FusedConfig, FUSED_CONFIG_FIELDS)
}

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

// Shared memory per env, envs per block, the design's budget per env
// (bytes), and the words per env the staged input column and the output
// rows may take.
int fused_step_shared(int* bytes, int* envs_per_block, int* budget, int* in_cap,
                      int* out_cap) {
  *bytes = (int)sizeof(FsEnv);
  *envs_per_block = LP_ENVS;
  *budget = LP_SHARED_BUDGET;
  *in_cap = FS_IN_CAP;
  *out_cap = LP_UNION_FLOATS - FS_WORK_FLOATS;
  return 0;
}

#ifdef __CUDACC__
// Shared bytes per block and resident blocks per SM.
int fused_step_occupancy(int* smem, int* blocks_per_sm) {
  *smem = LP_ENVS * (int)sizeof(FsEnv);
  return lp_prepare(fused_step_kernel, *smem, blocks_per_sm);
}

int fused_step_launch(const void* model, const void* cfg, float* rows_f, int* rows_i,
                      const float* act, const float* rst, const float* drn, const float* spw,
                      float* rows_c, float* obs, float* rew, int* msk, float* cmp, int n,
                      void* stream) {
  static int ready = -1;
  const int smem = LP_ENVS * (int)sizeof(FsEnv);
  if (ready < 0) ready = lp_prepare(fused_step_kernel, smem, (int*)0);
  if (ready) return ready;
  int blocks = (n + LP_ENVS - 1) / LP_ENVS;
  fused_step_kernel<<<blocks, LP_THREADS, smem, (cudaStream_t)stream>>>(
      (const LaneModel*)model, (const FusedConfig*)cfg, rows_f, rows_i, act, rst, drn, spw,
      rows_c, obs, rew, msk, cmp, n);
  return (int)cudaGetLastError();
}
#else
// Host build of the same code (no CUDA): blocks in a loop, each warp phase a
// loop over the lanes (in reverse order after lane_order_host(1)).
void lane_order_host(int reverse) { lp_lane_reverse = reverse; }

int fused_step_host(const void* model, const void* cfg, float* rows_f, int* rows_i,
                    const float* act, const float* rst, const float* drn, const float* spw,
                    float* rows_c, float* obs, float* rew, int* msk, float* cmp, int n) {
  const LaneModel* m = (const LaneModel*)model;
  const FusedConfig* c = (const FusedConfig*)cfg;
  FsEnv* envs = new FsEnv[LP_ENVS];
  LpLane Ls[LP_W];
  for (int e0 = 0; e0 < n; e0 += LP_ENVS) {
    fs_stage_in(c, envs, e0, n, rows_f, rows_i, act, rst, drn, spw, 0, 1);
    for (int e = 0; e < LP_ENVS && e0 + e < n; ++e) fs_env(m, c, &envs[e], Ls);
    fs_stage_out(c, envs, e0, n, rows_f, rows_i, rows_c, obs, rew, msk, cmp, 0, 1);
  }
  delete[] envs;
  return 0;
}
#endif

}  // extern "C"
