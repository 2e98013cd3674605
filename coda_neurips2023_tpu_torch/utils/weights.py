"""JAX package variables -> the port's state dict (numpy only).

Counterpart of coda_neurips2023_tpu/utils/torch_convert.py ::
export_reference_state_dict (:292-352), written without importing the JAX
package.  It turns a CoDA3DETR flax variable tree (`params`, `batch_stats`,
`constants`, as numpy arrays) into reference state-dict names and layouts,
which are the port's own parameter names:

  conv{i}/kernel (I, O)              -> pre_encoder.mlp_module.layer{i}.conv.weight (O, I, 1, 1)
  bn{i}/{scale, bias} + {mean, var}  -> ...layer{i}.bn.bn.{weight, bias, running_mean, running_var}
  encoder/interim_downsampling/...   -> encoder.interim_downsampling.mlp_module.layer{i}... (the
                                        masked encoder's SA, as the pre-encoder's)
  MHA query/key/value (in, H, D)     -> in_proj_weight (3C, in), in_proj_bias (3C,)
  MHA out (H, D, out)                -> out_proj.weight (out, C), out_proj.bias
  GenericMLP layer{h}/out (I, O)     -> layers.{idx}.weight (O, I, 1)
  pos_embedding/gauss_B              -> pos_embedding.gauss_B

`clip_state_dict_from_flax` does the same for the JAX package's CLIP params:
it is the exact inverse of `models/clip.py :: convert_openai_state_dict`
there, so flax CLIP weights load into the port under OpenAI's names:

  conv1/kernel (kh, kw, in, out)     -> visual.conv1.weight (out, in, kh, kw)
  resblock{i}/attn query/key/value   -> ...resblocks.{i}.attn.in_proj_weight (3W, W), in_proj_bias
  resblock{i}/c_fc, c_proj           -> ...resblocks.{i}.mlp.c_fc, mlp.c_proj
  token_embedding/embedding          -> token_embedding.weight

`grads_from_flax` maps a gradient tree of the CoDA3DETR params (same
structure as `params`) onto the port's parameter names, so gradients of the
two packages can be compared.  `to_torch` wraps either state dict for
`load_state_dict(strict=True)`.  A key of the CoDA3DETR tree that the
bridge does not map raises ValueError, naming it, so no weight is left
behind without a word.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

HEAD_NAMES = (
    "sem_cls_head", "center_head", "size_head", "angle_cls_head",
    "angle_residual_head", "text_correlation_head",
)


def _conv(k):  # (I, O) -> (O, I, 1)
    return np.asarray(k).T[..., None]


def _linear(p, sd, prefix):
    sd[prefix + ".weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[prefix + ".bias"] = np.asarray(p["bias"])


def _norm(p, sd, prefix):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _bn(p, s, sd, prefix):
    _norm(p, sd, prefix)
    sd[prefix + ".running_mean"] = np.asarray(s["mean"])
    sd[prefix + ".running_var"] = np.asarray(s["var"])
    sd[prefix + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _mha(p, sd, prefix):
    ws, bs = [], []
    for name in ("query", "key", "value"):
        k = np.asarray(p[name]["kernel"])  # (in, H, D)
        ws.append(k.reshape(k.shape[0], -1).T)
        bs.append(np.asarray(p[name]["bias"]).reshape(-1))
    sd[prefix + "in_proj_weight"] = np.concatenate(ws, axis=0)
    sd[prefix + "in_proj_bias"] = np.concatenate(bs, axis=0)
    k = np.asarray(p["out"]["kernel"])  # (H, D, out)
    sd[prefix + "out_proj.weight"] = k.reshape(-1, k.shape[-1]).T
    sd[prefix + "out_proj.bias"] = np.asarray(p["out"]["bias"])


_ENCODER_LAYER_KEYS = {"self_attn", "linear1", "linear2", "norm1", "norm2"}
_DECODER_LAYER_KEYS = _ENCODER_LAYER_KEYS | {"multihead_attn", "norm3"}


def _encoder_layer(p, sd, prefix, keys=_ENCODER_LAYER_KEYS):
    _unmapped(prefix, set(p) - keys)
    _mha(p["self_attn"], sd, prefix + ".self_attn.")
    _linear(p["linear1"], sd, prefix + ".linear1")
    _linear(p["linear2"], sd, prefix + ".linear2")
    _norm(p["norm1"], sd, prefix + ".norm1")
    _norm(p["norm2"], sd, prefix + ".norm2")


def _generic_mlp(p, s, sd, prefix, hidden_norm: bool, n_hidden: int,
                 out_norm: bool, dropout: bool):
    """Flax layer{h}/norm{h}/out/out_norm -> the reference Sequential indices:
    conv, [bn], activation, [dropout] for each hidden layer, then conv, [bn]."""
    known = {f"layer{h}" for h in range(n_hidden)} | {"out"}
    known |= {f"norm{h}" for h in range(n_hidden)} if hidden_norm else set()
    _unmapped(prefix, set(p) - known - ({"out_norm"} if out_norm else set()))
    idx = 0
    for h in range(n_hidden):
        layer = p[f"layer{h}"]
        sd[f"{prefix}.layers.{idx}.weight"] = _conv(layer["kernel"])
        if "bias" in layer:
            sd[f"{prefix}.layers.{idx}.bias"] = np.asarray(layer["bias"])
        idx += 1
        if hidden_norm:
            _bn(p[f"norm{h}"], s[f"norm{h}"], sd, f"{prefix}.layers.{idx}")
            idx += 1
        idx += 1 + int(dropout)  # activation, dropout
    sd[f"{prefix}.layers.{idx}.weight"] = _conv(p["out"]["kernel"])
    if "bias" in p["out"]:
        sd[f"{prefix}.layers.{idx}.bias"] = np.asarray(p["out"]["bias"])
    if out_norm:
        _bn(p["out_norm"], s["out_norm"], sd, f"{prefix}.layers.{idx + 1}")


def _unmapped(what: str, keys) -> None:
    if keys:
        raise ValueError(f"weight bridge: {what} has keys it does not map: {sorted(keys)}")


def _layers(tree: dict):
    """The `layer{i}` entries of a flax tree, by i."""
    return sorted(((int(k[5:]), v) for k, v in tree.items()
                   if k.startswith("layer") and k[5:].isdigit()), key=lambda kv: kv[0])


def _shared_mlp(p, s, sd, prefix):
    """A PointNet SA's `mlp_module` (conv{i} without bias, bn{i})."""
    n = sum(1 for k in p if k.startswith("conv"))
    _unmapped(prefix, set(p) - {f"{kind}{i}" for kind in ("conv", "bn") for i in range(n)})
    for i in range(n):
        sd[f"{prefix}.layer{i}.conv.weight"] = _conv(p[f"conv{i}"]["kernel"])[..., None]
        _bn(p[f"bn{i}"], s[f"bn{i}"], sd, f"{prefix}.layer{i}.bn.bn")


def state_dict_from_flax(params: dict, batch_stats: dict, constants: dict) -> Dict[str, np.ndarray]:
    """CoDA3DETR flax variables -> {reference name: numpy array}."""
    sd: Dict[str, np.ndarray] = {}
    _unmapped("params", set(params) - {"pre_encoder", "encoder", "decoder",
                                       "encoder_to_decoder_projection", "query_projection",
                                       *HEAD_NAMES})
    _unmapped("constants", set(constants) - {"pos_embedding"})
    _unmapped("pre_encoder", set(params["pre_encoder"]) - {"mlp_module"})
    _shared_mlp(params["pre_encoder"]["mlp_module"], batch_stats["pre_encoder"]["mlp_module"],
                sd, "pre_encoder.mlp_module")

    enc = params["encoder"]
    layers = _layers(enc)
    _unmapped("encoder", set(enc) - {f"layer{i}" for i, _ in layers} - {"interim_downsampling"})
    for i, layer in layers:
        _encoder_layer(layer, sd, f"encoder.layers.{i}")
    if "interim_downsampling" in enc:
        interim = enc["interim_downsampling"]
        _unmapped("encoder.interim_downsampling", set(interim) - {"mlp_module"})
        _shared_mlp(interim["mlp_module"],
                    batch_stats["encoder"]["interim_downsampling"]["mlp_module"], sd,
                    "encoder.interim_downsampling.mlp_module")

    dec = params["decoder"]
    layers = _layers(dec)
    _unmapped("decoder", set(dec) - {f"layer{i}" for i, _ in layers} - {"norm"})
    for i, layer in layers:
        prefix = f"decoder.layers.{i}"
        _encoder_layer(layer, sd, prefix, _DECODER_LAYER_KEYS)
        _mha(layer["multihead_attn"], sd, prefix + ".multihead_attn.")
        _norm(layer["norm3"], sd, prefix + ".norm3")
    _norm(dec["norm"], sd, "decoder.norm")

    _generic_mlp(
        params["encoder_to_decoder_projection"], batch_stats["encoder_to_decoder_projection"],
        sd, "encoder_to_decoder_projection",
        hidden_norm=True, n_hidden=2, out_norm=True, dropout=False,
    )
    _generic_mlp(
        params["query_projection"], {}, sd, "query_projection",
        hidden_norm=False, n_hidden=1, out_norm=False, dropout=False,
    )
    for name in HEAD_NAMES:
        if name in params:
            _generic_mlp(
                params[name], batch_stats.get(name, {}), sd, f"mlp_heads.{name}",
                hidden_norm=True, n_hidden=2, out_norm=False, dropout=True,
            )

    gauss_b = constants.get("pos_embedding", {}).get("gauss_B")
    if gauss_b is not None:
        sd["pos_embedding.gauss_B"] = np.asarray(gauss_b)
    return sd


def _stats_like(tree):
    """A stand-in batch_stats tree: zero statistics for every norm of `tree`."""
    if "scale" in tree:
        return {"mean": np.zeros_like(tree["scale"]), "var": np.zeros_like(tree["scale"])}
    return {k: _stats_like(v) for k, v in tree.items() if isinstance(v, dict)}


def grads_from_flax(grads: dict) -> Dict[str, np.ndarray]:
    """Gradients w.r.t. CoDA3DETR flax params -> {port parameter name: array}
    (buffers such as BatchNorm statistics have none and are left out)."""
    sd = state_dict_from_flax(grads, _stats_like(grads), {})
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    return {k: v for k, v in sd.items() if not k.endswith(buffers)}


def _clip_blocks(tree, sd, prefix):
    blocks = sorted((k for k in tree if k.startswith("resblock")), key=lambda k: int(k[8:]))
    for name in blocks:
        p = tree[name]
        pre = f"{prefix}.resblocks.{name[8:]}."
        _norm(p["ln_1"], sd, pre + "ln_1")
        _mha(p["attn"], sd, pre + "attn.")
        _norm(p["ln_2"], sd, pre + "ln_2")
        _linear(p["c_fc"], sd, pre + "mlp.c_fc")
        _linear(p["c_proj"], sd, pre + "mlp.c_proj")


def clip_state_dict_from_flax(params: dict) -> Dict[str, np.ndarray]:
    """JAX CLIP params ({visual, text, logit_scale}) -> OpenAI state dict."""
    sd: Dict[str, np.ndarray] = {}
    vis, txt = params["visual"], params["text"]
    sd["visual.conv1.weight"] = np.asarray(vis["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    sd["visual.class_embedding"] = np.asarray(vis["class_embedding"])
    sd["visual.positional_embedding"] = np.asarray(vis["positional_embedding"])
    _norm(vis["ln_pre"], sd, "visual.ln_pre")
    _clip_blocks(vis["transformer"], sd, "visual.transformer")
    _norm(vis["ln_post"], sd, "visual.ln_post")
    sd["visual.proj"] = np.asarray(vis["proj"])
    sd["token_embedding.weight"] = np.asarray(txt["token_embedding"]["embedding"])
    sd["positional_embedding"] = np.asarray(txt["positional_embedding"])
    _clip_blocks(txt["transformer"], sd, "transformer")
    _norm(txt["ln_final"], sd, "ln_final")
    sd["text_projection"] = np.asarray(txt["text_projection"])
    sd["logit_scale"] = np.asarray(params["logit_scale"])
    return sd


def to_torch(sd: Dict[str, np.ndarray], device=None) -> dict:
    """numpy state dict -> torch tensors (copies) for `load_state_dict`."""
    import torch

    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in sd.items()}
