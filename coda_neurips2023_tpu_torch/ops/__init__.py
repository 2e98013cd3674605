"""Point and attention ops: kernels A-D on CUDA, plain PyTorch on the CPU."""

from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points
from coda_neurips2023_tpu_torch.ops.grouping import ball_query, group_points, query_and_group
from coda_neurips2023_tpu_torch.ops.interpolate import (
    interpolation_weights,
    three_interpolate,
    three_nn,
)
