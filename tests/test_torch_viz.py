"""The port's viz modules (`mppiisaac_tpu_torch/viz/`) against the JAX
package's, drawing the same state: a JAX world of a point robot, a block,
the goal and a sphere obstacle, the robot and the block moved by the JAX
world's setters, converted to the port with
`convert.sim_state_from_jax`, and the same (H, K, 3) rollout lines from a
numpy seed (a tensor for the port, an array for JAX).

* `render_scene`: the two PNG files are the same image, pixel for pixel
  (tolerance 0: matplotlib draws the same float32 poses the same way);
* `LiveViewer.update`: the same patches (kind, position, size, colour) and
  the same line data, and the same saved frame; `save_episode_gif` makes a
  GIF of those frames;
* a goal key (`LiveViewer._on_key`) moves the goal as JAX's does.

They skip only where matplotlib (or, for the GIF, pillow) is missing.
"""
import numpy as np
import pytest
import torch

from mppiisaac_tpu.runtime.sim import Simulation as JSim
from mppiisaac_tpu.scene.builder import SimConfig as JConfig

from mppiisaac_tpu_torch.convert import sim_state_from_jax
from mppiisaac_tpu_torch.runtime.sim import Simulation as TSim
from mppiisaac_tpu_torch.scene.builder import SimConfig as TConfig

torch.set_num_threads(1)
ACTORS = ["point_robot", "block", "goal", "paper_obst1"]


@pytest.fixture(scope="module")
def worlds():
    pytest.importorskip("matplotlib")
    js = JSim(JConfig(dt=0.05, substeps=1), ACTORS, num_envs=1)
    js.reset_robot_state([0.3, -0.2, 0.4], [0.0, 0.0, 0.0])
    js.set_actor_position_by_name("block", np.array([0.6, -0.4, 0.1]))
    ts = TSim(TConfig(dt=0.05, substeps=1), ACTORS, num_envs=1, device="cpu")
    ts.state = sim_state_from_jax(js.state)
    ro = np.random.RandomState(0).uniform(-1, 1, (6, 80, 3)).astype(np.float32)
    return js, ts, ro


def _image(path):
    import matplotlib.image

    return matplotlib.image.imread(path)


def test_render_scene_draws_the_same_image(worlds, tmp_path):
    from mppiisaac_tpu.viz.render import render_scene as j_render
    from mppiisaac_tpu_torch.viz.render import render_scene as t_render

    js, ts, ro = worlds
    jp = j_render(js, ro, path=str(tmp_path / "jax.png"))
    tp = t_render(ts, torch.from_numpy(ro), path=str(tmp_path / "port.png"))
    a, b = _image(jp), _image(tp)
    assert a.shape == b.shape and np.array_equal(a, b)


def _drawn(ax):
    patches = []
    for p in ax.patches:
        kind = type(p).__name__
        geo = (p.center, p.radius) if kind == "Circle" else (p.get_xy(), p.get_width(),
                                                             p.get_height())
        patches.append((kind, np.round(np.hstack([np.ravel(g) for g in geo]), 6).tolist(),
                        tuple(p.get_facecolor())))
    lines = [np.asarray(l.get_xydata()) for l in ax.lines]
    return patches, lines


def test_live_viewer_draws_the_same_patches_and_lines(worlds, tmp_path):
    from mppiisaac_tpu.viz.live import LiveViewer as JViewer
    from mppiisaac_tpu_torch.viz.live import LiveViewer as TViewer
    from mppiisaac_tpu_torch.viz.render import save_episode_gif

    js, ts, ro = worlds
    jv = JViewer(js, frame_dir=str(tmp_path / "jax"))
    tv = TViewer(ts, frame_dir=str(tmp_path / "port"))
    try:
        for step in range(2):
            jv.update(step, ro)
            tv.update(step, torch.from_numpy(ro))
        (jp, jl), (tp, tl) = _drawn(jv.ax), _drawn(tv.ax)
        assert len(tp) == len(jp) and tp == jp
        assert len(tl) == len(jl) > 0
        for a, b in zip(jl, tl):
            assert np.array_equal(a, b)
        for a, b in zip(jv.frames, tv.frames):
            assert np.array_equal(_image(a), _image(b))
    finally:
        jv.close()
        tv.close()
    pytest.importorskip("PIL")
    gif = save_episode_gif(tv.frames, str(tmp_path / "episode.gif"), fps=5)
    from PIL import Image

    with Image.open(gif) as im:
        assert im.n_frames == 2


def test_goal_key_moves_the_goal_as_jax(worlds, tmp_path):
    from types import SimpleNamespace

    from mppiisaac_tpu.viz.live import LiveViewer as JViewer
    from mppiisaac_tpu_torch.viz.live import LiveViewer as TViewer

    js, ts, _ = worlds
    jv, tv = JViewer(js), TViewer(ts)
    try:
        for key in ("a", "w", "q", "x"):
            jv._on_key(SimpleNamespace(key=key))
            tv._on_key(SimpleNamespace(key=key))
        np.testing.assert_allclose(ts.get_actor_position_by_name("goal").numpy(),
                                   np.asarray(js.get_actor_position_by_name("goal")), atol=1e-6)
    finally:
        jv.close()
        tv.close()
