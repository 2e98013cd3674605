"""Data and tensor parallelism over ranks: `dist` (the collectives), `ddp`
(the world-size rule, the launcher, the row rule and the gradient
all-reduce) and `tp` (the (dp, mp) grid and the sharded blocks)."""

from coda_neurips2023_tpu_torch.parallel import ddp, dist, tp  # noqa: F401
