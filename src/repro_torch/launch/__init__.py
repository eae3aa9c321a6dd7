"""Command-line entry points of the port, and its meshes.

`repro_torch.launch.dryrun` is not imported here (as the reference's
package does not import its dry run): it sets up a fake process group
of 256 or 512 ranks, which only its own process should see.
"""
from .mesh import (chips, make_local_mesh, make_msc_mesh,
                   make_production_mesh, mesh_name, msc_mesh_shape)
