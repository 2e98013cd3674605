from portbench.reference.parallel import dist, tp  # noqa: F401
