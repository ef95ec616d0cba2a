"""The Euler-convention conversions under their own module name
(counterpart of ``helicon_tpu/euler.py``)."""

from .angular import (  # noqa: F401
    euler_relion2eman,
    euler_eman2relion,
    eman_euler2quaternion,
    relion_euler2quaternion,
    quaternion2euler,
)
