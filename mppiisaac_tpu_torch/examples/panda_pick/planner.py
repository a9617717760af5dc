"""panda_pick planner process: serves MPPIisaacPlanner over TCP.

    python -m mppiisaac_tpu_torch.examples.panda_pick.planner [device=cuda|cpu]
        [endpoint=tcp://127.0.0.1:4242] [mppi.num_samples=... ...]
"""
from ...tasks.panda_pick import PandaPickObjective
from ..common import DEFAULT_ENDPOINT, serve


def main(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT):
    serve("panda_pick", PandaPickObjective, argv, device=device, endpoint=endpoint)


if __name__ == "__main__":
    main()
