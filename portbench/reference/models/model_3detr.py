"""3DETR trunk with CoDA's heads (PyTorch): the eval and training forward.

Counterpart of coda_neurips2023_tpu/models/model_3detr.py.  Parameter names
are the reference state dict's (as `utils.torch_convert.
export_reference_state_dict` in the JAX package writes them), so
`load_state_dict(strict=True)` is the weight contract.

Like the JAX module, the forward returns a dict of per-decoder-layer
tensors with a leading layer axis (`query_xyz`, `enc_xyz` and `enc_inds`
excepted); the criterion reads every layer.  `.eval()` gives the eval
forward; in training mode (`.train()`, the default of a new module)
BatchNorm uses batch statistics and updates its running ones, and dropout
(MLP heads `mlp_dropout`, encoder `enc_dropout`, decoder `dec_dropout`)
draws from the `generator` given to the forward.  `sem_cls_prob` and
`objectness_prob` carry no gradient, as in the JAX module (they only feed
the matcher).

`enc_type` "masked" (--enc_type masked) builds the radius-masked encoder
with its interim downsampling (models/transformer.py), which keeps
preenc_npoints // 2 of the pre-encoder's points; `enc_inds` is then composed
through both samplings, as in the JAX package.  A cloud of more than 3
channels hands the channels after xyz to the pre-encoder as point features
(--use_color: the pre-encoder's MLP takes 3 + 3 inputs).

`compute_dtype` (--compute_dtype) is the JAX module's: bf16 reaches the
pre-encoder's convs, the vanilla encoder, the decoder and the heads, as in
JAX model_3detr.py:65-176; the masked encoder with its interim SA,
`encoder_to_decoder_projection`, `pos_embedding` and `query_projection` stay
fp32, and every head's output is fp32 again.  The parameters stay fp32.
In training mode the bf16 forward keeps these: BatchNorm's batch
statistics and its running averages in fp32 (JAX helpers.py:53-56,
pointnet.py:40-43), the heads' dropout on their fp32 BatchNorm outputs,
the transformer's dropouts on its bf16 activations (models/transformer.py),
the masked encoder in fp32; the parameters and so their gradients stay
fp32, each bf16 product's backward rounding as flax's does.
`remat` (--remat) checkpoints each encoder and decoder layer in training
(models/transformer.py), in fp32 and bf16 alike.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference.models.box_processor import BoxProcessor
from portbench.reference.models.helpers import GenericMLP
from portbench.reference.models.pointnet import PointnetSAModuleVotes
from portbench.reference.models.position_embedding import PositionEmbeddingCoordsSine
from portbench.reference.models.transformer import (
    MaskedTransformerEncoder,
    TransformerDecoder,
    TransformerEncoder,
)
from portbench.reference.ops.sampling import furthest_point_sample, gather_points
from portbench.reference.utils.device import resolve_device


class CoDA3DETR(nn.Module):
    """Class-agnostic 3DETR trunk with CoDA's six MLP heads."""

    def __init__(
        self,
        dataset_config,
        num_cls_predict: int = 1,
        enc_dim: int = 256,
        dec_dim: int = 512,
        enc_type: str = "vanilla",
        enc_nlayers: int = 3,
        enc_nhead: int = 4,
        enc_ffn_dim: int = 128,
        enc_dropout: float = 0.1,
        enc_activation: str = "relu",
        dec_nlayers: int = 8,
        dec_nhead: int = 4,
        dec_ffn_dim: int = 256,
        dec_dropout: float = 0.1,
        preenc_npoints: int = 2048,
        nqueries: int = 128,
        mlp_dropout: float = 0.3,
        position_embedding: str = "fourier",
        with_text_head: bool = True,
        use_color: bool = False,
        device=None,
        compute_dtype: torch.dtype = torch.float32,
        remat: bool = False,
    ):
        super().__init__()
        self.dataset_config = dataset_config
        self.nqueries = nqueries
        self.compute_dtype = compute_dtype
        self.pre_encoder = PointnetSAModuleVotes(
            npoint=preenc_npoints, radius=0.2, nsample=64,
            mlp_dims=(3 * int(use_color), 64, 128, enc_dim), normalize_xyz=True,
            device=device, dtype=compute_dtype,
        )
        if enc_type == "vanilla":
            self.encoder = TransformerEncoder(
                enc_nlayers, enc_dim, enc_nhead, enc_ffn_dim, enc_activation, enc_dropout,
                device=device, dtype=compute_dtype, remat=remat,
            )
        elif enc_type == "masked":  # three layers whatever enc_nlayers says, as in JAX
            self.encoder = MaskedTransformerEncoder(
                enc_dim, preenc_npoints // 2, enc_nhead, enc_ffn_dim, enc_activation,
                enc_dropout, device=device, remat=remat,
            )
        else:
            raise ValueError(f"enc_type {enc_type!r}: expected 'vanilla' or 'masked'")
        self.encoder_to_decoder_projection = GenericMLP(
            enc_dim, (512, 512), dec_dim, norm="bn1d", output_use_activation=True,
            output_use_norm=True, output_use_bias=False, device=device,
        )
        self.pos_embedding = PositionEmbeddingCoordsSine(
            dec_dim, pos_type=position_embedding, device=device
        )
        self.query_projection = GenericMLP(
            dec_dim, (dec_dim,), dec_dim, hidden_use_bias=True,
            output_use_activation=True, device=device,
        )
        self.decoder = TransformerDecoder(
            dec_nlayers, dec_dim, dec_nhead, dec_ffn_dim, dec_dropout, device=device,
            dtype=compute_dtype, remat=remat,
        )
        out_dims = {
            "sem_cls_head": num_cls_predict + 1,
            "center_head": 3,
            "size_head": 3,
            "angle_cls_head": dataset_config.num_angle_bin,
            "angle_residual_head": dataset_config.num_angle_bin,
            "text_correlation_head": 512,  # CLIP embedding width
        }
        if not with_text_head:
            del out_dims["text_correlation_head"]
        self.mlp_heads = nn.ModuleDict({
            name: GenericMLP(
                dec_dim, (dec_dim, dec_dim), dim, norm="bn1d", dropout=mlp_dropout,
                device=device, dtype=compute_dtype,
            )
            for name, dim in out_dims.items()
        })
        self.box_processor = BoxProcessor(dataset_config)

    def run_encoder(self, point_clouds, generator=None):
        xyz = point_clouds[..., 0:3].contiguous()
        features = point_clouds[..., 3:] if point_clouds.shape[-1] > 3 else None
        pre_xyz, pre_feat, pre_inds = self.pre_encoder(xyz, features)
        enc_xyz, enc_feat, enc_inds = self.encoder(pre_feat, xyz=pre_xyz, generator=generator)
        if enc_inds is None:
            return enc_xyz, enc_feat, pre_inds
        return enc_xyz, enc_feat, torch.gather(pre_inds, 1, enc_inds.long())

    def get_query_embeddings(self, enc_xyz, point_cloud_dims):
        query_inds = furthest_point_sample(enc_xyz, self.nqueries)
        query_xyz = gather_points(enc_xyz, query_inds)
        pos_embed = self.pos_embedding(query_xyz, input_range=point_cloud_dims)
        return query_xyz, self.query_projection(pos_embed)

    def get_box_predictions(self, query_xyz, point_cloud_dims, box_features, generator=None):
        """box_features: (L, B, nq, dec_dim) -> dict of stacked per-layer outputs."""
        bp = self.box_processor
        x, g = box_features, generator

        def head(name):  # at least fp32 whatever the compute dtype
            y = self.mlp_heads[name](x, g)
            return y.to(torch.promote_types(y.dtype, torch.float32))

        cls_logits = head("sem_cls_head")
        center_offset = torch.sigmoid(head("center_head")) - 0.5
        size_normalized = torch.sigmoid(head("size_head"))
        angle_logits = head("angle_cls_head")
        angle_residual_normalized = head("angle_residual_head")
        angle_residual = angle_residual_normalized * (
            math.pi / angle_residual_normalized.shape[-1]
        )
        # the layer axis broadcasts through the box decode
        center_norm, center_unnorm = bp.compute_predicted_center(
            center_offset, query_xyz, point_cloud_dims
        )
        angle = bp.compute_predicted_angle(angle_logits, angle_residual)
        size_unnorm = bp.compute_predicted_size(size_normalized, point_cloud_dims)
        semcls_prob, objectness_prob = bp.compute_objectness_and_cls_prob(cls_logits.detach())
        out = {
            "sem_cls_logits": cls_logits,
            "center_offset": center_offset,
            "size_normalized": size_normalized,
            "angle_logits": angle_logits,
            "angle_residual": angle_residual,
            "angle_residual_normalized": angle_residual_normalized,
            "center_normalized": center_norm,
            "center_unnormalized": center_unnorm,
            "angle_continuous": angle,
            "size_unnormalized": size_unnorm,
            "box_corners": bp.box_parametrization_to_corners(center_unnorm, size_unnorm, angle),
            "box_corners_xyz": bp.box_parametrization_to_corners_xyz(
                center_unnorm, size_unnorm, angle
            ),
            "sem_cls_prob": semcls_prob,
            "objectness_prob": objectness_prob,
        }
        if "text_correlation_head" in self.mlp_heads:
            out["text_correlation_embedding"] = head("text_correlation_head")
        return out

    def forward(self, inputs: dict, generator=None):
        """`generator` feeds dropout in training mode (the default generator
        when None); the eval forward draws nothing."""
        enc_xyz, enc_features, enc_inds = self.run_encoder(inputs["point_clouds"], generator)
        enc_features = self.encoder_to_decoder_projection(enc_features)
        point_cloud_dims = (inputs["point_cloud_dims_min"], inputs["point_cloud_dims_max"])
        query_xyz, query_embed = self.get_query_embeddings(enc_xyz, point_cloud_dims)
        enc_pos = self.pos_embedding(enc_xyz, input_range=point_cloud_dims)
        box_features = self.decoder(
            torch.zeros_like(query_embed), enc_features, query_pos=query_embed, pos=enc_pos,
            generator=generator,
        )
        preds = self.get_box_predictions(query_xyz, point_cloud_dims, box_features, generator)
        preds["query_xyz"] = query_xyz
        preds["enc_xyz"] = enc_xyz
        preds["enc_inds"] = enc_inds
        return preds


def get_class_scores(text_correlation_embedding, text_features, logit_scale):
    """Open-vocabulary class scores from the distillation head.

    text_correlation_embedding (..., nq, 512); text_features (ncls, 512),
    rows normalized; logit_scale a scalar (already exp'ed) -> softmax scores
    (..., nq, ncls).
    """
    emb = text_correlation_embedding
    emb = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-32)
    logits = torch.matmul(emb, text_features.t()) * logit_scale
    return torch.softmax(logits, dim=-1)


def _model_kwargs_from_args(args, dataset_config, num_cls_predict, with_text_head, device):
    bf16 = getattr(args, "compute_dtype", "float32") in ("bf16", "bfloat16")
    return dict(
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        dataset_config=dataset_config,
        num_cls_predict=num_cls_predict,
        enc_dim=args.enc_dim,
        dec_dim=args.dec_dim,
        enc_type=args.enc_type,
        enc_nlayers=args.enc_nlayers,
        enc_nhead=args.enc_nhead,
        enc_ffn_dim=args.enc_ffn_dim,
        enc_dropout=getattr(args, "enc_dropout", 0.1),
        enc_activation=args.enc_activation,
        dec_nlayers=args.dec_nlayers,
        dec_nhead=args.dec_nhead,
        dec_ffn_dim=args.dec_ffn_dim,
        dec_dropout=getattr(args, "dec_dropout", 0.1),
        preenc_npoints=args.preenc_npoints,
        nqueries=args.nqueries,
        mlp_dropout=args.mlp_dropout,
        position_embedding=args.pos_embed,
        with_text_head=with_text_head,
        use_color=args.use_color,
        device=device,
        remat=getattr(args, "remat", False),
    )


def build_3detr_predictedbox_distillation_head(args, dataset_config, device="cuda"):
    """The CoDA model: a (1 object + 1 background)-way sem head; open-vocabulary
    classes come from the 512-d text-correlation head against a text bank.
    Built on the card unless `device` says otherwise."""
    model = CoDA3DETR(
        **_model_kwargs_from_args(args, dataset_config, 1, True, resolve_device(device))
    )
    return model, BoxProcessor(dataset_config)


def build_3detr_multiclasshead(args, dataset_config, device="cuda"):
    """Closed-vocabulary baseline: five heads, no text-correlation head.
    Built on the card unless `device` says otherwise."""
    model = CoDA3DETR(
        **_model_kwargs_from_args(args, dataset_config, 1, False, resolve_device(device))
    )
    return model, BoxProcessor(dataset_config)
