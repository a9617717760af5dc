"""The port's wire transport and RPC against the JAX package's, and the
two-process point_robot example on the CPU:

* transport: `torch.save` bytes from either package's `torch_to_bytes` load
  in the other's reader exactly (tensors and numpy arrays, float32 and int);
* RPC: a fake planner behind the port's Server answers the port's Client and
  the JAX package's Client (the same protocol), and a remote error comes
  back as the caller's RuntimeError with its type and message;
* two processes: the point_robot planner example as a subprocess (K=16,
  H=4, port 0) against the world example in this process for 3 steps; the
  first action over RPC equals, bit for bit, the action of an in-process
  planner at the same seed from the same state (`compute_action_tensor`);
* the new modules import without JAX.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mppiisaac_tpu.runtime import server as jserver
from mppiisaac_tpu.runtime import transport as jtransport

from mppiisaac_tpu_torch.examples.point_robot import world as pr_world
from mppiisaac_tpu_torch.planner.mppi_isaac import MPPIisaacPlanner
from mppiisaac_tpu_torch.runtime.loop import goal_world
from mppiisaac_tpu_torch.runtime.server import Client, Server
from mppiisaac_tpu_torch.runtime.transport import bytes_to_torch, torch_to_bytes
from mppiisaac_tpu_torch.tasks.point_robot import PointRobotObjective
from mppiisaac_tpu_torch.utils.config_store import load_config
from planner_process import launch_planner, stop_planner

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["mppi.num_samples=16", "mppi.horizon=4"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_transport_round_trips_with_jax(dtype):
    x = (np.random.RandomState(0).normal(size=(5, 13)) * 10).astype(dtype)
    # JAX package → port
    t = bytes_to_torch(jtransport.torch_to_bytes(x))
    assert t.dtype == torch.from_numpy(x).dtype and np.array_equal(t.numpy(), x)
    t = bytes_to_torch(jtransport.jnp_to_bytes(x), device="cpu")
    assert np.array_equal(t.numpy(), x)
    # port → JAX package, from a tensor and from a numpy array
    for src in (torch.as_tensor(x), x):
        back = jtransport.bytes_to_torch(torch_to_bytes(src))
        assert isinstance(back, torch.Tensor) and torch.equal(back, torch.as_tensor(x))
    if dtype == np.float32:
        assert np.array_equal(np.asarray(jtransport.bytes_to_jnp(torch_to_bytes(x))), x)


class _FakePlanner:
    def __init__(self):
        self.weights = None

    def compute_action_tensor(self, dof_bytes, root_bytes):
        dof, root = bytes_to_torch(dof_bytes), bytes_to_torch(root_bytes)
        return torch_to_bytes(dof[:, 0] * 2.0 + root[0, 0])

    def update_weights(self, weights):
        self.weights = dict(weights)
        return sorted(weights)

    def add_to_env(self, additions):
        raise ValueError(f"cannot add {len(additions)} actors")


@pytest.mark.parametrize("client_of", ["port", "jax"])
def test_rpc_round_trip_and_error_relay(client_of):
    fake = _FakePlanner()
    srv = Server(fake).bind("tcp://127.0.0.1:0")
    srv.run_in_thread()
    client = (Client if client_of == "port" else jserver.Client)()
    try:
        client.connect(f"tcp://127.0.0.1:{srv.port}")
        dof = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        root = torch.full((2, 13), 0.5)
        out = bytes_to_torch(client.compute_action_tensor(torch_to_bytes(dof), torch_to_bytes(root)))
        assert torch.equal(out, dof[:, 0] * 2.0 + 0.5)
        assert client.update_weights({"nav": 2.0, "coll": 1.0}) == ["coll", "nav"]
        assert fake.weights == {"nav": 2.0, "coll": 1.0}
        with pytest.raises(RuntimeError, match="remote error: ValueError: cannot add 1 actors"):
            client.add_to_env([{"type": "sphere"}])
        # the connection survives a remote error
        assert client.update_weights({"a": 1}) == ["a"]
    finally:
        client.close()
        srv.stop()


def test_jax_server_answers_port_client():
    srv = jserver.Server(_FakePlanner()).bind("tcp://127.0.0.1:0")
    srv.run_in_thread()
    client = Client().connect(f"tcp://127.0.0.1:{srv.port}")
    try:
        assert client.update_weights({"b": 1, "a": 2}) == ["a", "b"]
        with pytest.raises(RuntimeError, match="ValueError: cannot add 2 actors"):
            client.add_to_env([{}, {}])
    finally:
        client.close()
        srv.stop()


def test_two_process_point_robot_matches_in_process():
    """The planner example in its own process, the world example here; the
    first RPC action is the in-process planner's, bit for bit (both
    processes run torch on one thread, so the same float sums)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc, endpoint = launch_planner(
        "mppiisaac_tpu_torch.examples.point_robot.planner",
        ["device=cpu", "endpoint=tcp://127.0.0.1:0", *SMALL], timeout=240, cwd=REPO, env=env)
    try:
        assert endpoint.startswith("tcp://127.0.0.1:") and not endpoint.endswith(":0")
        actions = []
        m = pr_world.run(["device=cpu", f"endpoint={endpoint}", "n_steps=3", *SMALL],
                         device="cpu", verbose=False,
                         observer=lambda step, world, action: actions.append(action.clone()))
        assert proc.poll() is None, "".join(proc.log)
    finally:
        stop_planner(proc)
    assert m.steps == 3 and len(actions) == 3 and m.final_state_finite
    assert all(a.shape == (3,) and bool(torch.isfinite(a).all()) for a in actions)

    cfg = load_config("tasks/point_robot", SMALL)
    world = goal_world(cfg, torch.device("cpu"))
    planner = MPPIisaacPlanner(cfg, PointRobotObjective(cfg), device="cpu")
    direct = bytes_to_torch(planner.compute_action_tensor(
        torch_to_bytes(world.dof_state[0]), torch_to_bytes(world.root_state[0])))
    assert torch.equal(actions[0], direct), (actions[0], direct)


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "import mppiisaac_tpu_torch.runtime.transport, mppiisaac_tpu_torch.runtime.server\n"
        "import mppiisaac_tpu_torch.runtime.loop, mppiisaac_tpu_torch.utils.conversions\n"
        "import mppiisaac_tpu_torch.validate, mppiisaac_tpu_torch.examples.common\n"
        "import mppiisaac_tpu_torch.examples.point_robot.planner\n"
        "import mppiisaac_tpu_torch.examples.point_robot.world\n"
        "import mppiisaac_tpu_torch.examples.panda_pick.planner\n"
        "import mppiisaac_tpu_torch.examples.panda_pick.world\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mppiisaac_tpu.'))\n"
        "       or m == 'mppiisaac_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
