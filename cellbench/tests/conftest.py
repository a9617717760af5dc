"""The benchmark's own tests: `python -m pytest cellbench/tests -q`.

They run on the CPU. A test that needs the card takes the `cuda_card`
fixture, which skips without one; whether a card is there is decided inside
the fixture, never while a module is imported."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ANYMAL = {"objective": "mppiisaac_tpu_torch.tasks.anymal:AnymalObjective", "objective_kwargs": {},
          "prior": "mppiisaac_tpu_torch.tasks.anymal:gait_prior", "cost": "anymal",
          "reference_prior": "anymal_trot"}


def anymal(num_samples: int = 8, **mppi) -> dict:
    """A configuration file of the anymal task as the benchmark would hold it,
    composed from the repo's `conf/tasks/anymal.yaml` (the trot tape prior
    on, prior_blend 0.5), with K cut to `num_samples` and the other `mppi`
    keys given."""
    import os

    from cellbench.reference.utils import confsys
    from cellbench.spec import ROOT

    root = os.path.join(ROOT, "conf")
    conf = confsys.compose(root, "tasks/anymal", [])
    conf["actors"] = [confsys.load_yaml(os.path.join(root, "actors", f"{n}.yaml"))
                      for n in conf["actors"]]
    conf["mppi"].update(num_samples=num_samples, **mppi)
    return dict(ANYMAL, conf=conf, checked_steps=2)


@pytest.fixture(scope="session")
def anymal_config():
    return anymal
