"""Optimal assignment of proposals to ground-truth boxes (scipy, on the host).

Counterpart of coda_neurips2023_tpu/ops/hungarian.py :: matcher_assignments,
in the reference's own design (its criterion.py:59-80, which the JAX
docstring cites): `scipy.optimize.linear_sum_assignment` per problem, on the
host.  The JAX package solves on the device instead (a Jonker-Volgenant
loop); moving the matcher onto the card is later, measured work.

One call takes the cost of every decoder layer at once, (L, B, nprop, ngt)
on the device: it is copied to the host once, the L * B problems are
solved, and the assignments are copied back once, so a training step syncs
once for the matcher, not once per layer.  Problem (l, b) is the cost of its
first nactual_gt[b] columns (the live ground truth); the result is an
optimal assignment, with the same total cost as the JAX one (an assignment
itself may differ only where costs tie).

The round trip runs in two spans (utils/spans.py): "matcher:wait", the
copy down, which waits for the device to finish computing the cost, and
"matcher:solve", the host's solve and the copy back up.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from coda_neurips2023_tpu_torch.utils.spans import span


def matcher_assignments(cost: torch.Tensor, nactual_gt: torch.Tensor) -> dict:
    """cost (..., B, nprop, ngt), nactual_gt (B,) int -> a dict of
      per_prop_gt_inds (..., B, nprop) int64: matched ground-truth index per
        proposal, 0 where unmatched;
      proposal_matched_mask (..., B, nprop) float32: 1 where matched;
    on the cost's device.
    """
    lead = cost.shape[:-3]
    b, nprop, ngt = cost.shape[-3:]
    # one copy down: the costs with the ground-truth counts appended
    packed = torch.cat([cost.detach().float().reshape(-1), nactual_gt.detach().float()])
    with span("matcher:wait"):
        packed = packed.cpu().numpy()
    with span("matcher:solve"):
        host = packed[: cost.numel()].reshape(-1, b, nprop, ngt)
        nactual = packed[cost.numel():].astype(np.int64)
        # -1 marks an unmatched proposal
        inds = np.full(host.shape[:-1], -1, np.int64)
        for layer in range(host.shape[0]):
            for bi in range(b):
                n = int(nactual[bi])
                if n == 0:
                    continue
                rows, cols = linear_sum_assignment(host[layer, bi, :, :n])
                inds[layer, bi, rows] = cols
        # one copy up; the two outputs are formed on the device
        inds = torch.from_numpy(inds.reshape(*lead, b, nprop)).to(cost.device)
    return {
        "per_prop_gt_inds": torch.clamp(inds, min=0),
        "proposal_matched_mask": (inds >= 0).float(),
    }
