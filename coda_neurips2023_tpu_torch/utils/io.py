"""Checkpoint loading: the --test_ckpt path.

Counterpart of coda_neurips2023_tpu/utils/io.py :: restore_params_only
(:119-172).  A reference-format checkpoint (`.pth` or `.pt`: a torch pickle
of {"model": state_dict, ...}, or the state dict alone) loads by parameter
name with `load_state_dict(strict=True)`: the port's modules carry the
reference's names (utils/weights.py), so no conversion runs.  The JAX
package reads the same file and takes from it only the detector's
weights; so does this loader, leaving out what the JAX converter reads past
(the "module." prefix of DDP, the frozen CLIP towers under clip_model. and
test_clip_model., logit_scale, and BatchNorm's num_batches_tracked) unless
the model itself has such an entry.  Any other difference of names raises,
naming the missing and unexpected keys.

An orbax checkpoint directory of the JAX package raises: export it to a
`.pth` first with the JAX package's exporter,
`python -m coda_neurips2023_tpu.utils.torch_convert export <dir> out.pth`.
Saving, and resuming a training run, come with the training loop.
"""

from __future__ import annotations

import os

import torch

# entries of a reference checkpoint that are not the detector's weights
_NOT_DETECTOR_PREFIXES = ("clip_model.", "test_clip_model.")
_NOT_DETECTOR_KEYS = ("logit_scale",)
_NOT_DETECTOR_SUFFIXES = (".num_batches_tracked",)


def _is_detector_key(key: str) -> bool:
    return not (key.startswith(_NOT_DETECTOR_PREFIXES) or key in _NOT_DETECTOR_KEYS
                or key.endswith(_NOT_DETECTOR_SUFFIXES))


def load_reference_state_dict(path: str) -> dict:
    """The state dict of a reference-format `.pth`/`.pt`, on the CPU, with
    DDP's "module." prefix taken off."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def restore_params_only(checkpoint_path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load the detector's weights of `checkpoint_path` into `model` (in place,
    on the model's device) and return it."""
    if os.path.isdir(checkpoint_path):
        raise ValueError(
            f"{checkpoint_path} is a directory (an orbax checkpoint of the JAX package?); "
            "the port reads reference-format .pth files: export it with "
            f"`python -m coda_neurips2023_tpu.utils.torch_convert export {checkpoint_path} "
            "out.pth` and pass --test_ckpt out.pth"
        )
    if not checkpoint_path.endswith((".pth", ".pt")):
        raise ValueError(f"--test_ckpt {checkpoint_path}: expected a .pth or .pt file")
    sd = load_reference_state_dict(checkpoint_path)
    own = model.state_dict()
    sd = {k: v for k, v in sd.items() if k in own or _is_detector_key(k)}
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"checkpoint {checkpoint_path} does not match the built model: "
            f"missing={missing[:8]} unexpected={unexpected[:8]} "
            "(is --model_name consistent with the checkpoint's head set?)"
        )
    model.load_state_dict(sd, strict=True)
    return model
