"""K1's cost of the panda_pick task: the weights of the port's
`tasks/panda_pick.PandaPickObjective` as the benchmark holds them."""
from ..ops.fused_physics import TASK_PANDA_PICK, CostSpec

WEIGHTS = {"robot_to_block": 40.0, "block_to_goal": 10.0, "collision": 26.0, "robot_ori": 2.0}


def kernel_cost(built) -> CostSpec:
    scene = built.scene
    table = scene.actor_index("table")
    return CostSpec(
        task=TASK_PANDA_PICK,
        ee_body=scene.body_index("panda_ee", "panda"),
        goal_actor=scene.actor_index("goal"),
        w_dist=WEIGHTS["robot_to_block"],
        w_ori=WEIGHTS["robot_ori"],
        block_actor=scene.actor_index("panda_pick_block"),
        force_body0=int(scene.body_offset[table]),
        force_nbody=int(scene.actors[table].nbody),
        w_block=WEIGHTS["block_to_goal"],
        w_force=WEIGHTS["collision"],
    )
