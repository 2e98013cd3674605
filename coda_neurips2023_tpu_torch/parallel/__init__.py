"""Data parallelism over ranks: `dist` (the collectives) and `ddp` (the
world-size rule, the launcher, the row rule and the gradient all-reduce)."""
