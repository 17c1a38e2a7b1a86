from .camera import Camera
from .reference import render_reference
from .renderer import (
    RenderResult,
    measure_max_fragments,
    measure_max_rows,
    project_and_color,
    rasterize_splats,
    render,
    render_gaussians,
)
from .train import TrainableGaussians, fit, l2_image_loss, make_train_step

__all__ = [
    "Camera",
    "render_reference",
    "RenderResult",
    "measure_max_fragments",
    "measure_max_rows",
    "project_and_color",
    "rasterize_splats",
    "render",
    "render_gaussians",
    "TrainableGaussians",
    "fit",
    "l2_image_loss",
    "make_train_step",
]
