"""Checkpoints: saving and resuming a training run, and loading weights.

Counterpart of coda_neurips2023_tpu/utils/io.py: `save_checkpoint` (:63-99),
`resume_if_possible` (:106-116) and `restore_params_only` (:119-172).

A checkpoint is a `torch.save` of the reference layout,

    {"model": state_dict, "optimizer": AdamW.state_dict(), "epoch": int,
     "best_val_metrics": {name: float}},

with every tensor on the CPU and nothing but tensors, numbers, strings and
dicts, so it loads with `weights_only=True`.  It is written to
`<checkpoint_dir>/<name>.pth` under the JAX package's names (`checkpoint`,
`checkpoint_best`, `checkpoint_{epoch:04d}`, `last_checkpoint`): first to a
temporary file beside it, which `os.replace` then puts in its place, so a
run killed while saving leaves the last whole checkpoint behind.  The
tensors come to the host in one copy for each dtype (the model's weights and
buffers and AdamW's two moments, packed on the device first).  The JAX
package keeps an orbax directory and a JSON sidecar instead; it reads the
port's file through its own converter (utils/torch_convert.py), as it reads
the reference's.  Under a tensor-parallel grid (parallel/tp.py) every
process calls `save_checkpoint`: each block's processes gather their shards
of the weights and moments, and process 0 writes whole tensors, as the JAX
package writes a sharded state; `resume_if_possible` reads whole tensors
and keeps this process's slices.

`restore_params_only` takes a reference-format checkpoint (`.pth` or `.pt`:
a torch pickle of {"model": state_dict, ...}, or the state dict alone), for
--test_ckpt and --checkpoint_file, and loads it by parameter name with
`load_state_dict(strict=True)`: the port's modules carry the reference's
names (utils/weights.py), so no conversion runs.  A path without a suffix
(the stage-2 script passes `outputs/coda_sunrgbd_stage1/last_checkpoint`,
which the JAX package reads as its orbax directory) resolves to `<path>.pth`
when that file exists, and raises naming both paths otherwise.  The loader
takes only the detector's weights, leaving out what the JAX converter reads
past (the "module." prefix of DDP, the frozen CLIP towers under clip_model.
and test_clip_model., logit_scale, and BatchNorm's num_batches_tracked)
unless the model itself has such an entry.  Any other difference of names
raises, naming the missing and unexpected keys.  An orbax checkpoint
directory of the JAX package raises: export it to a `.pth` first with the
JAX package's exporter,
`python -m coda_neurips2023_tpu.utils.torch_convert export <dir> out.pth`.
"""

from __future__ import annotations

import os

import torch

from coda_neurips2023_tpu_torch.parallel import tp
from coda_neurips2023_tpu_torch.parallel.dist import is_primary

# entries of a reference checkpoint that are not the detector's weights
_NOT_DETECTOR_PREFIXES = ("clip_model.", "test_clip_model.")
_NOT_DETECTOR_KEYS = ("logit_scale",)
_NOT_DETECTOR_SUFFIXES = (".num_batches_tracked",)
SUFFIX = ".pth"


def _is_detector_key(key: str) -> bool:
    return not (key.startswith(_NOT_DETECTOR_PREFIXES) or key in _NOT_DETECTOR_KEYS
                or key.endswith(_NOT_DETECTOR_SUFFIXES))


def checkpoint_path(checkpoint_dir: str, filename: str = "checkpoint") -> str:
    return os.path.join(checkpoint_dir, filename + SUFFIX)


def _to_host(tensors: list) -> list:
    """CPU copies of `tensors`: those of one device and dtype are packed into
    one buffer there and copied back at once."""
    out = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for (device, _), idx in groups.items():
        if device.type == "cpu":
            for i in idx:
                out[i] = tensors[i].detach().clone()
            continue
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx]).cpu()
        for i, piece in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def save_checkpoint(checkpoint_dir: str, model: torch.nn.Module, optimizer, epoch: int,
                    best_val_metrics: dict = None, filename: str = "checkpoint") -> str:
    """Write `model`'s state dict, `optimizer`'s state, `epoch` and
    `best_val_metrics` to <checkpoint_dir>/<filename>.pth; returns the path
    (None where this process does not write).  Under a grid every process
    must call it: the shards are gathered first."""
    grid = tp.grid_of(model)
    if grid is not None:
        model_sd, opt_sd = tp.gather_state_tp(grid, model), tp.gather_optimizer_tp(grid, optimizer)
    if not is_primary():
        return None
    os.makedirs(checkpoint_dir, exist_ok=True)
    if grid is None:
        model_sd, opt_sd = model.state_dict(), optimizer.state_dict()
    names = list(model_sd)
    moments = [(key, name) for key in ("mu", "nu") for name in opt_sd[key]]
    host = _to_host([model_sd[n] for n in names] + [opt_sd[k][n] for k, n in moments])
    optim = {"count": int(opt_sd["count"]), "mu": {}, "nu": {}}
    for (key, name), t in zip(moments, host[len(names):]):
        optim[key][name] = t
    payload = {
        "model": dict(zip(names, host[: len(names)])),
        "optimizer": optim,
        "epoch": int(epoch),
        "best_val_metrics": {k: float(v) for k, v in (best_val_metrics or {}).items()},
    }
    path = checkpoint_path(checkpoint_dir, filename)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def resume_if_possible(checkpoint_dir: str, model: torch.nn.Module, optimizer,
                       filename: str = "checkpoint"):
    """Restore `model` and `optimizer` in place from
    <checkpoint_dir>/<filename>.pth; returns (epoch, best_val_metrics), or
    (-1, {}) when there is no such file (the caller starts at epoch 0)."""
    path = checkpoint_path(checkpoint_dir, filename) if checkpoint_dir else None
    if path is None or not os.path.isfile(path):
        return -1, {}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    model_sd, opt_sd = obj["model"], obj["optimizer"]
    if tp.grid_of(model) is not None:  # whole tensors: this process's slices
        model_sd = tp.local_slices(model_sd, model.state_dict(keep_vars=True))
        named = dict(zip(optimizer.names, optimizer.params))
        opt_sd = dict(opt_sd, **{k: tp.local_slices(opt_sd[k], named) for k in ("mu", "nu")})
    model.load_state_dict(model_sd, strict=True)
    optimizer.load_state_dict(opt_sd)
    return int(obj["epoch"]), dict(obj.get("best_val_metrics", {}))


def load_reference_state_dict(path: str) -> dict:
    """The state dict of a reference-format `.pth`/`.pt`, on the CPU, with
    DDP's "module." prefix taken off."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def resolve_checkpoint_file(path: str) -> str:
    """`path` itself when it ends in .pth or .pt; else `<path>.pth` when that
    file exists (a suffix-less name, as the stage-2 script passes stage 1's
    last_checkpoint); else it raises."""
    if path.endswith((".pth", ".pt")):
        return path
    if os.path.isfile(path + SUFFIX):
        return path + SUFFIX
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?) and "
            f"{path}{SUFFIX} does not exist; the port reads reference-format .pth files: export "
            f"it with `python -m coda_neurips2023_tpu.utils.torch_convert export {path} "
            "out.pth` and pass out.pth"
        )
    raise ValueError(f"{path}: expected a .pth or .pt file, and neither {path} nor "
                     f"{path}{SUFFIX} is one")


def restore_params_only(checkpoint_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the detector's weights of `checkpoint_path` into `model` (in place,
    on the model's device) and return it."""
    path = resolve_checkpoint_file(checkpoint_path)
    sd = load_reference_state_dict(path)
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own or _is_detector_key(k)}
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"checkpoint {path} does not match the built model: "
            f"missing={missing[:8]} unexpected={unexpected[:8]} "
            "(is --model_name consistent with the checkpoint's head set?)"
        )
    model.load_state_dict(sd, strict=True)
    return model
