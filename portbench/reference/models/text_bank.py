"""CLIP text embedding banks.

Counterpart of coda_neurips2023_tpu/models/text_bank.py: the prompt
'a photo of a {name} in the scene' for each class name, encoded by the
port's CLIP text tower into (ncls, 512) row-normalized banks for four
vocabularies (train-range classes, test classes, the cmp (OV-3DETR)
vocabulary, the LVIS superset).  Without a CLIP model the banks are the
same deterministic pseudo-embeddings, seeded by the prompt, as the JAX
package's.  Banks are numpy arrays, as there.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from portbench.reference.models.tokenizer import tokenize


def prompt(name: str) -> str:
    return "a photo of a " + name.replace("_", " ").lower() + " in the scene"


def _pseudo_embedding(names, dim=512):
    rows = []
    for n in names:
        seed = int(hashlib.md5(n.encode()).hexdigest()[:8], 16)
        rows.append(np.random.default_rng(seed).standard_normal(dim))
    e = np.stack(rows).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def encode_prompts(prompts, clip_model=None, bpe_path=None, batch=64):
    """Full prompt strings -> (len(prompts), 512) row-normalized float32,
    through `clip_model.encode_text` on the model's device."""
    if clip_model is None:
        return _pseudo_embedding(prompts)
    toks = tokenize(list(prompts), context_length=clip_model.context_length, bpe_path=bpe_path)
    toks = np.minimum(toks, clip_model.vocab_size - 1)
    device = clip_model.token_embedding.weight.device
    outs = []
    with torch.inference_mode():
        for i in range(0, len(prompts), batch):
            t = torch.from_numpy(toks[i : i + batch].astype(np.int64)).to(device)
            outs.append(clip_model.encode_text(t).float().cpu().numpy())
    e = np.concatenate(outs, 0)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def encode_names(names, clip_model=None, bpe_path=None, batch=64):
    """Class names -> (len(names), 512) row-normalized float32."""
    return encode_prompts([prompt(n) for n in names], clip_model, bpe_path, batch)


def superset_prompt_list(class_names, superset_names, seen_idx):
    """Prompts of the seen classes first, then every superset prompt not
    already present, deduplicated at the prompt level in order."""
    keys = []
    for i in seen_idx:
        p = prompt(class_names[i])
        if p not in keys:
            keys.append(p)
    for n in superset_names:
        p = prompt(n)
        if p not in keys:
            keys.append(p)
    return keys


def build_text_banks(
    dataset_config,
    train_range_max: int,
    test_range_max: int,
    superset_names: Optional[list] = None,
    cmp_names: Optional[list] = None,
    seen_idx: Optional[list] = None,
    if_clip_more_prompts: bool = False,
    clip_model=None,
    bpe_path=None,
):
    """Returns {train, test, cmp, superset} -> (ncls, 512) normalized arrays
    plus "superset_prompts" (the resolved prompt list).

    The "train" bank covers the full test vocabulary with
    if_clip_more_prompts, else its first train_range_max rows; the superset
    bank is seen classes first plus the LVIS additions; the cmp bank is the
    OV-3DETR vocabulary.  seen_idx defaults to the first train_range_max rows.
    """
    class_names = getattr(dataset_config, "vocab_names", None) or [
        dataset_config.class2type.get(i, f"class_{i:04d}") for i in range(test_range_max)
    ]
    class_names = list(class_names)[:test_range_max]
    while len(class_names) < test_range_max:
        class_names.append(f"class_{len(class_names):04d}")
    test_bank = encode_names(class_names, clip_model, bpe_path)
    train_bank = test_bank if if_clip_more_prompts else test_bank[:train_range_max]
    banks = {
        "train": train_bank,
        "test": test_bank,
        "cmp": encode_names(cmp_names, clip_model, bpe_path) if cmp_names else test_bank,
    }
    if superset_names:
        if seen_idx is None:
            seen_idx = list(range(train_range_max))
        keys = superset_prompt_list(class_names, superset_names, seen_idx)
        # the seen rows are the test bank's rows of the same prompts; only the
        # additions are encoded
        seen_rows, seen_prompts = [], set()
        for i in seen_idx:
            p = prompt(class_names[i])
            if p not in seen_prompts:
                seen_prompts.add(p)
                seen_rows.append(test_bank[i])
        extra = keys[len(seen_rows):]
        parts = [np.stack(seen_rows)] if seen_rows else []
        if extra:
            parts.append(encode_prompts(extra, clip_model, bpe_path))
        banks["superset"] = np.concatenate(parts, 0)
        banks["superset_prompts"] = keys
    else:
        banks["superset"] = test_bank
        banks["superset_prompts"] = [prompt(n) for n in class_names]
    return banks
