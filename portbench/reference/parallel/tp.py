"""No tensor-parallel grid: the hooks the copied modules call on a block
whose `grid` is None."""

from __future__ import annotations


def copy_to_mp(*xs, grid=None):
    if grid is not None:
        raise ValueError("the reference runs no tensor-parallel grid")
    return xs


def row_parallel(*args, **kwargs):
    raise ValueError("the reference runs no tensor-parallel grid")


def local_columns(w):
    raise ValueError("the reference runs no tensor-parallel grid")
