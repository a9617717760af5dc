"""Point-robot planner process: serves MPPIisaacPlanner over TCP.

    python -m mppiisaac_tpu_torch.examples.point_robot.planner [device=cuda|cpu]
        [endpoint=tcp://127.0.0.1:4242] [mppi.num_samples=... ...]
"""
from ...tasks.point_robot import PointRobotObjective
from ..common import DEFAULT_ENDPOINT, serve


def main(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT):
    serve("point_robot", PointRobotObjective, argv, device=device, endpoint=endpoint)


if __name__ == "__main__":
    main()
