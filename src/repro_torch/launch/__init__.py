"""Command-line entry points, and the meshes they train and serve on."""
from repro_torch.launch.mesh import (
    make_production_mesh,
    make_mesh,
    make_host_mesh,
    dp_width,
)
