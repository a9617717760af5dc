"""Conversions (parity: the JAX package's `utils/conversions.py`, itself the
reference's `mppiisaac/utils/conversions.py`)."""
from ..physics.math3d import (  # noqa: F401
    matrix_to_quat as matrix_to_quaternion,
    quat_to_euler_zyx,
    quat_to_matrix as quaternion_to_matrix,
    quat_to_yaw as quaternion_to_yaw,
)
