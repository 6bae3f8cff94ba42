"""pointclouds_jax.core"""

from .view import (  # noqa: F401
    CloudView,
    HasColor,
    HasIntensity,
    HasNormal,
    HasPosition,
    PointXYZ,
    PointXYZI,
    PointXYZNormal,
    PointXYZRGB,
)
