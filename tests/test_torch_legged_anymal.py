"""The port's plain K2 against the JAX package's FusedWorldStep in interpret
mode on anymal after landing (dt 0.1, 8 substeps, the stiction blocks of its
feet live): 2 world steps, 16 sweeps, contact_lam included, with the
tolerances of tests/test_torch_legged.py (which holds K1 there too, marked
slow). A file of its own, so that its compile runs beside the other test
files.
"""
from test_torch_legged import check_world, landed_anymal


def test_anymal_landed_world_step_matches_pallas():
    _, _, jb, je, tw, js, drive = landed_anymal()
    check_world(jb, je, tw.built, tw.engine, js, drive)
