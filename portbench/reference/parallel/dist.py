"""One process: the collectives the copied modules call are identities."""

from __future__ import annotations


def get_world_size() -> int:
    return 1


def is_distributed() -> bool:
    return False


def global_sum(x):
    return x


def differentiable_global_sum(x):
    return x
