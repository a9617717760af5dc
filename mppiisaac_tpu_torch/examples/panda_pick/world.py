"""panda_pick world process: a 1-env world in real time against the planner
process, until ‖block − goal‖ < 0.2 m or n_steps have run.

    python -m mppiisaac_tpu_torch.examples.panda_pick.world [device=cuda|cpu]
        [endpoint=tcp://127.0.0.1:4242] [n_steps=N] [conf overrides ...]
"""
from ...tasks.panda_pick import success_fn
from ..common import DEFAULT_ENDPOINT, run_world


def run(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT, observer=None, verbose=True):
    return run_world("panda_pick", argv, device=device, endpoint=endpoint,
                     make_success=lambda cfg: success_fn(), observer=observer, verbose=verbose)


def main(argv=None, device="cuda", endpoint=DEFAULT_ENDPOINT):
    run(argv, device=device, endpoint=endpoint)


if __name__ == "__main__":
    main()
