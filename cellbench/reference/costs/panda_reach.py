"""K1's cost of the panda reach task: the weights of the port's
`tasks/panda_reach.PandaReachObjective` (end effector `panda_ee_tip`) as the
benchmark holds them."""
from ..ops.fused_physics import TASK_PANDA_REACH, CostSpec

WEIGHTS = {"robot_to_goal": 1.0, "robot_ori": 0.5}


def kernel_cost(built) -> CostSpec:
    scene = built.scene
    return CostSpec(
        task=TASK_PANDA_REACH,
        ee_body=scene.body_index("panda_ee_tip", "panda"),
        goal_actor=scene.actor_index("goal"),
        w_dist=WEIGHTS["robot_to_goal"],
        w_ori=WEIGHTS["robot_ori"],
    )
