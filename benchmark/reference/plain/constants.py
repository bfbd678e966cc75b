"""DOF layout, joint/body naming and the 12-control -> 19-DOF finger
coupling map of the DexHand021 hand.

The port's own copy of `dexrobot_isaac_tpu/constants.py` (the port imports
nothing of the JAX package); the two must stay equal.
"""

# DOF dimensions
NUM_BASE_DOFS = 6  # ARTx, ARTy, ARTz, ARRx, ARRy, ARRz
NUM_ACTIVE_FINGER_DOFS = 12  # 12 finger controls mapping onto 19 driven DOFs
NUM_TOTAL_FINGER_DOFS = 20  # 5 fingers x 4 joints (incl. fixed r_f_joint3_1)
NUM_FINGERS = 5  # thumb, index, middle, ring, pinky
NUM_DOFS = NUM_BASE_DOFS + NUM_TOTAL_FINGER_DOFS  # 26
NUM_ACTIVE_TARGETS = NUM_BASE_DOFS + NUM_ACTIVE_FINGER_DOFS  # 18

BASE_JOINT_NAMES = ["ARTx", "ARTy", "ARTz", "ARRx", "ARRy", "ARRz"]

FINGER_JOINT_NAMES = [
    "r_f_joint1_1",
    "r_f_joint1_2",
    "r_f_joint1_3",
    "r_f_joint1_4",
    "r_f_joint2_1",
    "r_f_joint2_2",
    "r_f_joint2_3",
    "r_f_joint2_4",
    "r_f_joint3_1",
    "r_f_joint3_2",
    "r_f_joint3_3",
    "r_f_joint3_4",
    "r_f_joint4_1",
    "r_f_joint4_2",
    "r_f_joint4_3",
    "r_f_joint4_4",
    "r_f_joint5_1",
    "r_f_joint5_2",
    "r_f_joint5_3",
    "r_f_joint5_4",
]

DOF_NAMES = BASE_JOINT_NAMES + FINGER_JOINT_NAMES
DOF_INDEX = {name: i for i, name in enumerate(DOF_NAMES)}

FINGERTIP_BODY_NAMES = [
    "r_f_link1_tip",
    "r_f_link2_tip",
    "r_f_link3_tip",
    "r_f_link4_tip",
    "r_f_link5_tip",
]

FINGERPAD_BODY_NAMES = [
    "r_f_link1_pad",
    "r_f_link2_pad",
    "r_f_link3_pad",
    "r_f_link4_pad",
    "r_f_link5_pad",
]

# Default bodies monitored for contact-force observations (distal phalanges),
# mirrors cfg/task/BaseTask.yaml `contact_force_bodies`.
DEFAULT_CONTACT_FORCE_BODIES = [
    "r_f_link1_4",
    "r_f_link2_4",
    "r_f_link3_4",
    "r_f_link4_4",
    "r_f_link5_4",
]

# Finger DOF coupling (12 controls -> 19 driven DOFs; r_f_joint3_1 fixed at 0).
# Control k drives each listed (joint, scale) pair with target = control * scale.
# Mirrors reference FINGER_COUPLING_MAP (constants.py:71-88): thumb DIP pair
# coupled, spread control drives joints 2_1/4_1 at 1.0 and 5_1 at 2.0.
FINGER_COUPLING_MAP = {
    0: [("r_f_joint1_1", 1.0)],  # thumb spread/rotation
    1: [("r_f_joint1_2", 1.0)],  # thumb MCP
    2: [("r_f_joint1_3", 1.0), ("r_f_joint1_4", 1.0)],  # thumb DIP (coupled)
    3: [
        ("r_f_joint2_1", 1.0),
        ("r_f_joint4_1", 1.0),
        ("r_f_joint5_1", 2.0),
    ],  # finger spread (pinky 2x)
    4: [("r_f_joint2_2", 1.0)],  # index MCP
    5: [("r_f_joint2_3", 1.0), ("r_f_joint2_4", 1.0)],  # index DIP
    6: [("r_f_joint3_2", 1.0)],  # middle MCP
    7: [("r_f_joint3_3", 1.0), ("r_f_joint3_4", 1.0)],  # middle DIP
    8: [("r_f_joint4_2", 1.0)],  # ring MCP
    9: [("r_f_joint4_3", 1.0), ("r_f_joint4_4", 1.0)],  # ring DIP
    10: [("r_f_joint5_2", 1.0)],  # pinky MCP
    11: [("r_f_joint5_3", 1.0), ("r_f_joint5_4", 1.0)],  # pinky DIP
}

# The "primary" DOF of each finger control (first joint listed above). Used for
# extracting active finger targets back out of full 26-DOF vectors
# (inverse of the coupling; reference action_processor.py:616-666).
ACTIVE_FINGER_PRIMARY_JOINTS = [
    pairs[0][0] for _, pairs in sorted(FINGER_COUPLING_MAP.items())
]

# DOF indices (into the 26-vector) of the primary joint of each finger control.
ACTIVE_FINGER_DOF_INDICES = [DOF_INDEX[j] for j in ACTIVE_FINGER_PRIMARY_JOINTS]

FIXED_FINGER_JOINTS = ["r_f_joint3_1"]  # held at 0, not driven by any control
