from lightzero_tpu_torch.loss_landscape.core import (
    random_direction,
    loss_surface_1d,
    loss_surface_2d,
    loss_landscape_api,
)
from lightzero_tpu_torch.loss_landscape.plots import (
    plot_1d,
    plot_2d_contour,
    export_vtk,
    pca_directions,
    project_trajectory,
    unflatten_like,
    render_landscape_dir,
)
