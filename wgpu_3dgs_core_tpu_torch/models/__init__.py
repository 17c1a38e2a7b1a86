from .gaussian import (
    SH0_TO_LINEAR_FACTOR,
    SPZ_SH0_TO_LINEAR_FACTOR,
    Gaussians,
    GaussianSoA,
    GaussiansSource,
)
from .ply import (
    NUM_PLY_PROPERTIES,
    PLY_PROPERTIES,
    PlyGaussians,
    PlyHeader,
    read_ply,
)
from .spz import (
    SpzEncodeOptions,
    SpzGaussians,
    SpzHeader,
    read_spz,
)

__all__ = [
    "SH0_TO_LINEAR_FACTOR",
    "SPZ_SH0_TO_LINEAR_FACTOR",
    "Gaussians",
    "GaussianSoA",
    "GaussiansSource",
    "NUM_PLY_PROPERTIES",
    "PLY_PROPERTIES",
    "PlyGaussians",
    "PlyHeader",
    "read_ply",
    "SpzEncodeOptions",
    "SpzGaussians",
    "SpzHeader",
    "read_spz",
]
