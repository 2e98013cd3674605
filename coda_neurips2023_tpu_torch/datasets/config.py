"""Dataset configuration (the part the detector's eval forward reads).

Counterpart of coda_neurips2023_tpu/datasets/config.py:89-148:
`DatasetConfigBase` (angle bins, box slots and the two corner
parametrizations) and `SunrgbdAnonymousConfig`.  Class vocabularies and
train/test class ranges are not read by the eval forward and are not ported.
"""

from __future__ import annotations

from coda_neurips2023_tpu_torch.ops import box_ops


class DatasetConfigBase:
    num_semcls: int = 1
    num_angle_bin: int = 12
    max_num_obj: int = 64

    def box_parametrization_to_corners(self, center_unnorm, size, angle):
        center_upright = box_ops.flip_axis_to_camera(center_unnorm)
        return box_ops.get_3d_box_batch(size, angle, center_upright)

    def box_parametrization_to_corners_xyz(self, center_unnorm, size, angle):
        return box_ops.get_3d_box_batch_xyz(size, angle, center_unnorm)


class SunrgbdAnonymousConfig(DatasetConfigBase):
    """OV-SUN RGB-D training config: class-agnostic ground truth (one
    semantic class), 12 heading-angle bins, 64 box slots a scene."""
