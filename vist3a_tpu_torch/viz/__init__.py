"""Visualization: layout, labels, colours, colour maps, drawing, camera
trajectories and 3-D validation views.

Port of `vist3a_tpu/viz` (the reference's `src/visualization/`), with the
same exports.  Layout, labels, colours, the 2-D colour map and the
trajectories are host numpy; the colour maps run on numpy arrays or on
tensors on their device; the drawing and the validation renders run on
the card by default (`device=`).
"""

from vist3a_tpu_torch.viz.annotation import add_label, draw_label  # noqa: F401
from vist3a_tpu_torch.viz.color_map import (  # noqa: F401
    apply_color_map,
    apply_color_map_2d,
    apply_color_map_to_image,
)
from vist3a_tpu_torch.viz.colors import get_distinct_color  # noqa: F401
from vist3a_tpu_torch.viz.drawing import (  # noqa: F401
    draw_cameras,
    draw_lines,
    draw_points,
)
from vist3a_tpu_torch.viz.layout import (  # noqa: F401
    add_border,
    hcat,
    overlay,
    vcat,
)
from vist3a_tpu_torch.viz.validation_in_3d import (  # noqa: F401
    pad,
    render_camera_poses,
    render_projections,
)
from vist3a_tpu_torch.viz.trajectories import (  # noqa: F401
    generate_spin,
    generate_wobble,
    generate_wobble_transformation,
    interpolate_extrinsics,
    interpolate_intrinsics,
)
