"""Point-robot world process: a 1-env world in real time against the planner
process, until the robot is within 0.1 m of its goal or n_steps have run.

    python -m mppiisaac_tpu_torch.examples.point_robot.world [device=cuda|cpu]
        [endpoint=tcp://127.0.0.1:4242] [n_steps=N] [conf overrides ...]
"""
from ...tasks.point_robot import PointRobotObjective, success_fn
from ..common import DEFAULT_ENDPOINT, run_world


def run(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT, observer=None, verbose=True):
    return run_world("point_robot", argv, device=device, endpoint=endpoint,
                     make_success=lambda cfg: success_fn(PointRobotObjective(cfg).nav_goal),
                     observer=observer, verbose=verbose)


def main(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT):
    run(argv, device=device, endpoint=endpoint)


if __name__ == "__main__":
    main()
