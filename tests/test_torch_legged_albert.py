"""The port's plain K2 against the JAX package's FusedWorldStep in interpret
mode on albert resting on its wheels under a drive command: 2 world steps,
16 sweeps, contact_lam included, with the tolerances of
tests/test_torch_legged.py (which holds K1 there too, marked slow). A file
of its own, so that its compile runs beside the other test files.
"""
from test_torch_legged import check_world, resting_albert


def test_albert_resting_world_step_matches_pallas():
    _, _, jb, je, tw, js, drive = resting_albert()
    check_world(jb, je, tw.built, tw.engine, js, drive)
