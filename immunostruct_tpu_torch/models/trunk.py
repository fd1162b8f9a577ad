"""The ImmunoStruct trunk (counterpart of ``immunostruct_tpu/models/trunk.py``).

One parameterized model covers the zoo; ``ModelSpec`` says which pieces a
registry name uses:

  structure branch : EGNN stack -> node attention (single-head or MHA) -> pool
  sequence branch  : VAE encoder -> reparameterize -> z
  property branch  : 2 -> 32 -> dropout -> property_embedding_dim MLP
  fusion           : concat -> optional "combined attention" -> classifier

``ImmunoStructModel``'s ``state_dict`` names map one to one onto the JAX
package's parameter treepaths (``['gcn'][0]['edge_mlp'][0]['w']`` is
``gcn.0.edge_mlp.0.w``), so JAX checkpoints load with
``utils/checkpoint.py``.

The VAE noise ``eps`` is drawn even when ``deterministic=True``, as in the
JAX package and the reference. The forward takes it as an ``eps`` tensor,
or else draws it from the ``generator`` it is given; dropout (when not
deterministic, the training-mode forward) draws from the same generator,
so a generator seeded alike gives the same forward. ``model_apply`` is the
plain forward, ``model_apply_comparative`` the cancer/WT twin forward with
shared weights (two passes, or one over the stacked twins).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from immunostruct_tpu_torch.ops.attention import (
    MultiHeadAttention, SelfAttention, mha_apply, self_attention_apply,
)
from immunostruct_tpu_torch.ops.egnn import (
    egnn_stack, egnn_stack_apply, stack_aggregation,
)
from immunostruct_tpu_torch.ops.nnp import Linear, draw, dropout, linear_apply
from immunostruct_tpu_torch.ops.pooling import max_pool, mean_pool
from immunostruct_tpu_torch.structs import GraphBatch, map_tensors

NUM_AMINO_ACIDS = 20


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static architecture description (same fields as the JAX package)."""

    name: str = "HybridModelv2"
    # branches
    use_structure: bool = True
    use_sequence: bool = True          # VAE branch
    use_property: bool = True          # property-embedding MLP (2->32->8)
    raw_property_concat: bool = False  # SequenceFpModel: append raw 2 props to z
    # structure branch
    gcn_layers: int = 5                # hidden convs; +1 input conv
    gat_hidden_channels: int = 64
    node_attention: str = "self"       # 'self' | 'mha'
    self_attention_heads: int = 1
    mean_max_pool: bool = False        # StructureModelv2: mean (+) max readout
    # sequence branch
    vae_hidden_dim: int = 512
    vae_latent_dim: int = 32
    property_embedding_dim: int = 8
    # fusion
    combined_attention_dim: int = 0    # 0 = no fusion attention (v1 models)
    combined_attention_heads: int = 8
    # heads
    ssl: bool = False                  # split trunk + classifier/node heads
    mlp_features: int = 32
    comparative: bool = False
    use_wt_for_downstream: bool = True
    dropout_rate: float = 0.1

    @property
    def embedding_dim(self) -> int:
        """Width of the fused per-item embedding entering the classifier."""
        dim = 0
        if self.use_structure:
            dim += self.gat_hidden_channels * (2 if self.mean_max_pool else 1)
        if self.use_sequence:
            dim += self.vae_latent_dim
            if self.use_property:
                dim += self.property_embedding_dim
            if self.raw_property_concat:
                dim += 2
        return dim

    @property
    def classifier_input_dim(self) -> int:
        if self.comparative and self.use_wt_for_downstream:
            return self.embedding_dim * 2
        return self.embedding_dim


class ModelOutput(NamedTuple):
    recon: Optional[torch.Tensor]       # sequence reconstruction (or None)
    mu: Optional[torch.Tensor]
    logvar: Optional[torch.Tensor]
    logits: torch.Tensor                # [B, 1] f32
    node_logits: Optional[torch.Tensor]  # SSL amino-acid prediction [B, 20]
    embedding: Optional[torch.Tensor]   # fused per-item embedding
    attention: Optional[torch.Tensor]   # node attention weights


class _VAE(nn.Module):
    def __init__(self, input_dim: int, hidden: int, latent: int,
                 dec_in: int, **kw):
        super().__init__()
        self.fc1 = Linear(input_dim, hidden, **kw)
        self.fc21 = Linear(hidden, latent, **kw)
        self.fc22 = Linear(hidden, latent, **kw)
        self.fc3 = Linear(dec_in, hidden, **kw)
        self.fc4 = Linear(hidden, input_dim, **kw)


class _Classifier(nn.Module):
    """Linear(D, 32) -> ReLU -> Dropout -> Linear(32, 1); SSL models split
    off ``classifier_head`` and ``node_predictor_head`` instead of ``out``."""

    def __init__(self, spec: ModelSpec, **kw):
        super().__init__()
        self.trunk = Linear(spec.classifier_input_dim, spec.mlp_features, **kw)
        if spec.ssl:
            self.classifier_head = Linear(spec.mlp_features, 1, **kw)
            self.node_predictor_head = Linear(spec.mlp_features,
                                              NUM_AMINO_ACIDS, **kw)
        else:
            self.out = Linear(spec.mlp_features, 1, **kw)


class ImmunoStructModel(nn.Module):
    """Parameters of one zoo model; ``model_apply`` runs it."""

    def __init__(self, spec: ModelSpec, vae_input_dim: int, *,
                 generator: torch.Generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.spec = spec
        kw = dict(generator=generator, device=device, dtype=dtype)
        if spec.use_structure:
            self.gcn = egnn_stack(spec.gcn_layers, NUM_AMINO_ACIDS,
                                  spec.gat_hidden_channels, edge_feat_size=1,
                                  **kw)
            if spec.node_attention == "self":
                self.node_attn = SelfAttention(spec.gat_hidden_channels, **kw)
            else:
                self.node_attn = MultiHeadAttention(
                    spec.gat_hidden_channels, spec.self_attention_heads, **kw)
        if spec.use_sequence:
            dec_in = spec.vae_latent_dim
            if spec.use_property:
                dec_in += spec.property_embedding_dim
            if spec.raw_property_concat:
                dec_in += 2
            self.vae = _VAE(vae_input_dim, spec.vae_hidden_dim,
                            spec.vae_latent_dim, dec_in, **kw)
        if spec.use_property and spec.use_sequence:
            self.property_embedding = nn.ModuleList([
                Linear(2, 32, **kw),
                Linear(32, spec.property_embedding_dim, **kw)])
        if spec.combined_attention_dim > 0:
            self.combined_attention = MultiHeadAttention(
                spec.combined_attention_dim, spec.combined_attention_heads,
                input_dim=1, **kw)
        self.classifier = _Classifier(spec, **kw)


def reset_head(model: ImmunoStructModel, generator: torch.Generator
               ) -> ImmunoStructModel:
    """Re-initialize the classifier for a stage transition, in place
    (``load_trained(new_head=True)``): plain models get a fresh classifier
    (hybrid_models.py:76-79), SSL models a fresh ``classifier_head`` only
    (hybrid_models.py:191-194). Weights are drawn from ``generator``."""
    p = next(model.classifier.parameters())
    kw = dict(generator=generator, device=p.device, dtype=p.dtype)
    if model.spec.ssl:
        model.classifier.classifier_head = Linear(model.spec.mlp_features, 1,
                                                  **kw)
    else:
        model.classifier = _Classifier(model.spec, **kw)
    return model


def _gcn_input(graph: GraphBatch) -> torch.Tensor:
    """The conv stack's node features: the amino-acid one-hot columns."""
    return graph.node_feat[..., :NUM_AMINO_ACIDS]


def gcn_aggregation(model: ImmunoStructModel, graph: GraphBatch,
                    aggregation: str) -> str:
    """The aggregation ``model_apply``'s conv stack runs on ``graph`` (what
    'auto' resolves to for its shapes and device)."""
    return stack_aggregation(aggregation, model.gcn[0], _gcn_input(graph),
                             graph.edge_src, graph.edge_feat)


def _structure_branch(model: ImmunoStructModel, graph: GraphBatch,
                      aggregation: str, compute_dtype,
                      mega_variant: str = "hybrid",
                      fused_stack: bool = False):
    spec = model.spec
    h = _gcn_input(graph).to(compute_dtype)
    x = graph.coords.to(compute_dtype)
    h, _ = egnn_stack_apply(model.gcn, h, x, graph.edge_src, graph.edge_dst,
                            graph.edge_feat, graph.edge_mask,
                            aggregation=aggregation,
                            mega_variant=mega_variant,
                            fused_stack=fused_stack)
    if spec.node_attention == "self":
        attn_out, attn_w = self_attention_apply(model.node_attn, h)
    else:
        attn_out, attn_w = mha_apply(model.node_attn, h,
                                     n_head=spec.self_attention_heads)
    if spec.mean_max_pool:
        pooled = torch.cat([mean_pool(attn_out), max_pool(attn_out)], dim=-1)
    else:
        pooled = mean_pool(attn_out)
    return pooled, attn_w


def _vae_encode(vae: _VAE, seq_flat):
    h1 = torch.relu(linear_apply(vae.fc1, seq_flat))
    return linear_apply(vae.fc21, h1), linear_apply(vae.fc22, h1)


def _vae_decode(vae: _VAE, z):
    h3 = torch.relu(linear_apply(vae.fc3, z)).to(z.dtype)
    return linear_apply(vae.fc4, h3)


def _reparameterize(mu, logvar, eps, generator):
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = draw(torch.randn, std.shape, generator, std.device, std.dtype)
    return mu + eps.to(std.dtype) * std


def _property_branch(layers, props, deterministic, rate, generator):
    h = torch.relu(linear_apply(layers[0], props))
    h = dropout(h, rate, deterministic, generator)
    return torch.relu(linear_apply(layers[1], h))


def forward_item(model: ImmunoStructModel, graph: Optional[GraphBatch],
                 seq_onehot: Optional[torch.Tensor],
                 props: Optional[torch.Tensor], *,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False, aggregation: str = "auto",
                 compute_dtype=torch.float32,
                 eps: Optional[torch.Tensor] = None,
                 mega_variant: str = "hybrid", fused_stack: bool = False):
    """Single-branch forward. Returns (embedding, recon, mu, logvar,
    attention weights); ``embedding`` is [pool | z_vae]. ``mega_variant``:
    the kernel variant of aggregation 'mega'; ``fused_stack``: the conv
    stack through B7, forward only (both ``egnn_stack_apply``'s)."""
    spec = model.spec
    pooled, attn_w, recon, mu, logvar = None, None, None, None, None
    pieces = []
    if spec.use_structure:
        pooled, attn_w = _structure_branch(model, graph, aggregation,
                                           compute_dtype, mega_variant,
                                           fused_stack)
        pieces.append(pooled)
    if spec.use_sequence:
        b = seq_onehot.shape[0]
        seq_flat = seq_onehot.reshape(b, -1).to(compute_dtype)
        mu, logvar = _vae_encode(model.vae, seq_flat)
        z = _reparameterize(mu, logvar, eps, generator)
        if spec.use_property:
            prop_emb = _property_branch(model.property_embedding,
                                        props.to(compute_dtype),
                                        deterministic, spec.dropout_rate,
                                        generator)
            z = torch.cat([z, prop_emb], dim=-1)
        if spec.raw_property_concat:
            z = torch.cat([z, props.to(z.dtype)], dim=-1)
        recon = _vae_decode(model.vae, z)
        pieces.append(z)
    embedding = torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]
    return embedding, recon, mu, logvar, attn_w


def _classify(model: ImmunoStructModel, combined: torch.Tensor,
              deterministic: bool, generator: Optional[torch.Generator]):
    """Optional fusion attention + classifier MLP."""
    spec = model.spec
    if spec.combined_attention_dim > 0:
        # the fused D-wide vector as a length-D sequence of scalars
        c, _ = mha_apply(model.combined_attention, combined[..., None],
                         n_head=spec.combined_attention_heads)
        combined = c.mean(dim=2)
    cls = model.classifier
    h = torch.relu(linear_apply(cls.trunk, combined))
    h = dropout(h, spec.dropout_rate, deterministic, generator)
    if spec.ssl:
        return (linear_apply(cls.classifier_head, h),
                linear_apply(cls.node_predictor_head, h))
    return linear_apply(cls.out, h), None


def model_apply(model: ImmunoStructModel, graph: Optional[GraphBatch],
                seq_onehot: Optional[torch.Tensor],
                props: Optional[torch.Tensor], *,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False, aggregation: str = "auto",
                compute_dtype=torch.float32,
                eps: Optional[torch.Tensor] = None,
                mega_variant: str = "hybrid",
                fused_stack: bool = False) -> ModelOutput:
    """Plain (non-comparative) forward. For comparative specs the item
    embedding is duplicated to fill the 2x-wide classifier, as in the JAX
    package's pretraining path. ``fused_stack`` runs the conv stack through
    B7 (forward only: it raises under a gradient)."""
    embedding, recon, mu, logvar, attn_w = forward_item(
        model, graph, seq_onehot, props, generator=generator,
        deterministic=deterministic, aggregation=aggregation,
        compute_dtype=compute_dtype, eps=eps, mega_variant=mega_variant,
        fused_stack=fused_stack)
    combined = embedding
    if model.spec.comparative and model.spec.use_wt_for_downstream:
        combined = torch.cat([embedding, embedding], dim=-1)
    logits, node_logits = _classify(model, combined, deterministic, generator)
    return ModelOutput(recon=recon, mu=mu, logvar=logvar,
                       logits=logits.float(), node_logits=node_logits,
                       embedding=embedding, attention=attn_w)


def _cat_twins(cancer, wt):
    """Stack a cancer/WT pair of tensors or GraphBatches on the batch axis."""
    if cancer is None:
        return None
    if isinstance(cancer, torch.Tensor):
        return torch.cat([cancer, wt], dim=0)
    return GraphBatch(**{name: torch.cat([getattr(cancer, name),
                                          getattr(wt, name)], dim=0)
                         for name in vars(cancer)})


def model_apply_comparative(model: ImmunoStructModel, graph_pair, seq_pair,
                            props_pair, *,
                            generator: Optional[torch.Generator] = None,
                            deterministic: bool = False,
                            aggregation: str = "auto",
                            compute_dtype=torch.float32,
                            stack_twins: bool = False, eps=None,
                            mega_variant: str = "hybrid",
                            fused_stack: bool = False):
    """Twin forward over (cancer, wt) with shared weights.

    Returns (ModelOutput_cancer, ModelOutput_wt, logits). The logits come
    from the concatenated pair embedding when ``use_wt_for_downstream``;
    both per-item outputs carry their own recon/mu/logvar for the averaged
    twin loss. ``stack_twins`` runs ONE ``forward_item`` over the twins
    stacked on the batch axis instead of two B-sized passes (the same
    math; only the order of the noise draws differs). ``eps``: the VAE
    noise, a (cancer, wt) pair for two passes or one [2B, latent] tensor
    for the stacked pass; None draws it from ``generator``.
    ``fused_stack``: the conv stack through B7, as in ``model_apply``."""
    kw = dict(generator=generator, deterministic=deterministic,
              aggregation=aggregation, compute_dtype=compute_dtype,
              mega_variant=mega_variant, fused_stack=fused_stack)
    if stack_twins:
        b = (seq_pair[0] if seq_pair[0] is not None
             else graph_pair[0].node_feat).shape[0]
        stacked = forward_item(model, _cat_twins(*graph_pair),
                               _cat_twins(*seq_pair), _cat_twins(*props_pair),
                               eps=eps, **kw)
        cancer = [map_tensors(lambda t: t[:b], v) for v in stacked]
        wt = [map_tensors(lambda t: t[b:], v) for v in stacked]
    else:
        eps_c, eps_w = (None, None) if eps is None else eps
        cancer = forward_item(model, graph_pair[0], seq_pair[0],
                              props_pair[0], eps=eps_c, **kw)
        wt = forward_item(model, graph_pair[1], seq_pair[1], props_pair[1],
                          eps=eps_w, **kw)
    emb_c, recon_c, mu_c, logvar_c, attn_c = cancer
    emb_w, recon_w, mu_w, logvar_w, attn_w = wt
    combined = (torch.cat([emb_c, emb_w], dim=-1)
                if model.spec.use_wt_for_downstream else emb_c)
    logits, node_logits = _classify(model, combined, deterministic, generator)
    logits = logits.float()
    out_c = ModelOutput(recon=recon_c, mu=mu_c, logvar=logvar_c,
                        logits=logits, node_logits=node_logits,
                        embedding=emb_c, attention=attn_c)
    out_w = ModelOutput(recon=recon_w, mu=mu_w, logvar=logvar_w,
                        logits=logits, node_logits=node_logits,
                        embedding=emb_w, attention=attn_w)
    return out_c, out_w, logits
