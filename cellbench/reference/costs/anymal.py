"""K1's cost of the anymal task: the weights and heights of the port's
`tasks/anymal.AnymalObjective` as the benchmark holds them."""
from ..ops.fused_physics import TASK_ANYMAL, CostSpec

WEIGHTS = {"robot_to_goal": 1.0, "robot_off_ground": 5.0, "knees_off_ground": 5.0}
BODY_HEIGHT, KNEE_HEIGHT = 0.65, 0.35
LEGS = ("LF", "RF", "LH", "RH")
BODY_LINKS = ("base", "face_front", "face_rear")


def kernel_cost(built) -> CostSpec:
    scene = built.scene
    rows = ([(link, BODY_HEIGHT, WEIGHTS["robot_off_ground"]) for link in BODY_LINKS]
            + [(f"{leg}_KFE", KNEE_HEIGHT, WEIGHTS["knees_off_ground"]) for leg in LEGS])
    return CostSpec(
        task=TASK_ANYMAL,
        ee_body=scene.body_index("base", "anymal"),
        goal_actor=scene.actor_index("goal"),
        w_dist=WEIGHTS["robot_to_goal"],
        w_ori=0.0,
        ht_body=tuple(scene.body_index(link, "anymal") for link, _, _ in rows),
        ht_z=tuple(z for _, z, _ in rows),
        ht_w=tuple(w for _, _, w in rows),
    )
