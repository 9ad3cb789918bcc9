"""Graph-MIL: GNN message passing over patch graphs + attention pooling.

Counterpart of ``multimodal_isic_tpu/models/graph_mil.py`` (:28-251), the
reference's ``GraphMIL`` and its layer zoo (``utils_g_mil.py:289-492``), in
the dense-adjacency form: each layer is ``[..., N, N] × [..., N, D]``
products and masked softmaxes (plain torch: ``matmul``, ``einsum``,
``softmax``; the JAX package has no Pallas kernel here either).

Layer semantics follow the published pyg definitions:
  gcn          D̂^{-1/2}(A+I)D̂^{-1/2} X W + b
  gin          MLP((1+ε)·x + Σ_neighbours x), ε trainable (train_eps=True)
  graphsage    W₁x + W₂·mean_neighbours(x), L2-normalised (normalize=True)
  gat          LeakyReLU(a·[Wh_i ‖ Wh_j]) attention, self loops, heads concat
  transformer  scaled dot-product attention a edge with the β-gated skip
               (beta=True) of pyg's TransformerConv

Every tensor may carry leading batch dimensions: one bag ``[N, F]`` trains a
step, a batch of padded bags ``[B, N, F]`` (adjacency ``[B, N, N]``, mask
``[B, N]``) evaluates at once.  LayerNorm is flax's (eps 1e-6, float32
fast-variance statistics: ``models.convmae.LayerNorm``).  Dropout draws its
keep mask from a passed ``torch.Generator`` and takes a float rate or a 0-d
tensor rate (:func:`_dropout`), so per-trial rates can share one program.
Submodule names are flax's (``input_proj``, ``gnn_{i}``, ``ln_{i}``,
``pool_att{j}_fc1/2``, ``cls_fc1..3``, ``cls_ln1/2``), so that
``models.convert.graph_mil_state_dict`` maps a JAX tree by name.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .convmae import LayerNorm

NEG_INF = -1e30
Rate = Union[float, torch.Tensor]
Draws = Union[torch.Generator, Callable[..., torch.Tensor]]


def _with_self_loops(adj: torch.Tensor) -> torch.Tensor:
    n = adj.shape[-1]
    return torch.maximum(adj, torch.eye(n, dtype=adj.dtype,
                                        device=adj.device))


def _dropout(h: torch.Tensor, rate: Rate, train: bool,
             generator: Optional[Draws]) -> torch.Tensor:
    """Dropout with a float or 0-d tensor ``rate`` (JAX :38-50): keep a
    unit where ``u < 1 − rate`` for u drawn uniform from ``generator``,
    scale kept units by 1 / keep.  Identity outside training and at a float
    rate of 0.  ``generator`` is a ``torch.Generator`` (or None), or a draw
    function ``(shape, device, dtype) → u`` (the HPO cohorts' per-trial
    streams, ``hpo.population``)."""
    if not train or (not torch.is_tensor(rate) and float(rate) == 0.0):
        return h
    keep = 1.0 - rate
    if callable(generator):
        u = generator(tuple(h.shape), h.device, h.dtype)
    else:
        u = torch.rand(h.shape, generator=generator, device=h.device,
                       dtype=h.dtype)
    scale = (keep.clamp_min(1e-12) if torch.is_tensor(keep)
             else max(keep, 1e-12))
    return torch.where(u < keep, h / scale, torch.zeros_like(h))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., N, H·D] → [..., N, H, D]."""
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


class GCNLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin = nn.Linear(in_dim, out_dim)

    def forward(self, x, adj):
        a = _with_self_loops(adj)
        d = 1.0 / torch.sqrt(a.sum(-1).clamp_min(1e-12))
        a_norm = a * d[..., :, None] * d[..., None, :]
        return a_norm @ self.lin(x)


class GINLayer(nn.Module):
    """GINConv around the reference's inner MLP (Linear → LayerNorm → ReLU
    → Linear, ``utils_g_mil.py:293-298``)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.mlp_fc1 = nn.Linear(in_dim, out_dim)
        self.mlp_ln = LayerNorm(out_dim)
        self.mlp_fc2 = nn.Linear(out_dim, out_dim)

    def forward(self, x, adj):
        agg = adj @ x + (1.0 + self.eps) * x
        return self.mlp_fc2(F.relu(self.mlp_ln(self.mlp_fc1(agg))))


class GraphSAGELayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.lin_self = nn.Linear(in_dim, out_dim)
        self.lin_nbr = nn.Linear(in_dim, out_dim, bias=False)

    def forward(self, x, adj):
        deg = adj.sum(-1, keepdim=True).clamp_min(1.0)
        out = self.lin_self(x) + self.lin_nbr((adj @ x) / deg)
        if self.normalize:
            out = out / torch.linalg.vector_norm(
                out, dim=-1, keepdim=True).clamp_min(1e-12)
        return out


class GATLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 concat: bool = True, dropout: float = 0.0,
                 negative_slope: float = 0.2):
        super().__init__()
        self.out_dim, self.heads, self.concat = out_dim, heads, concat
        self.dropout, self.negative_slope = dropout, negative_slope
        self.lin = nn.Linear(in_dim, heads * out_dim, bias=False)
        self.att_src = nn.Parameter(torch.empty(heads, out_dim))
        self.att_dst = nn.Parameter(torch.empty(heads, out_dim))
        self.bias = nn.Parameter(torch.zeros(heads * out_dim if concat
                                             else out_dim))

    def forward(self, x, adj, train: bool = False, dropout_rate=None,
                generator=None):
        rate = self.dropout if dropout_rate is None else dropout_rate
        a = _with_self_loops(adj)
        h = _heads(self.lin(x), self.heads)            # [..., N, H, D]
        alpha_src = (h * self.att_src).sum(-1)          # [..., N, H]
        alpha_dst = (h * self.att_dst).sum(-1)
        # e[i, j, h] for the edge j → i, aggregated at node i
        e = alpha_dst[..., :, None, :] + alpha_src[..., None, :, :]
        e = F.leaky_relu(e, self.negative_slope)
        e = e.masked_fill(~(a[..., None] > 0), NEG_INF)
        alpha = _dropout(torch.softmax(e, dim=-2), rate, train, generator)
        out = torch.einsum("...ijh,...jhd->...ihd", alpha, h)
        if self.concat:
            return out.reshape(*out.shape[:-2], -1) + self.bias
        return out.mean(dim=-2) + self.bias


class TransformerConvLayer(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, heads: int = 4,
                 concat: bool = True, dropout: float = 0.0,
                 beta: bool = True):
        super().__init__()
        self.out_dim, self.heads, self.concat = out_dim, heads, concat
        self.dropout, self.beta = dropout, beta
        for name in ("lin_q", "lin_k", "lin_v", "lin_skip"):
            self.add_module(name, nn.Linear(in_dim, heads * out_dim))
        if beta:
            self.lin_beta = nn.Linear(3 * out_dim, 1, bias=False)

    def forward(self, x, adj, train: bool = False, dropout_rate=None,
                generator=None):
        rate = self.dropout if dropout_rate is None else dropout_rate
        a = _with_self_loops(adj)  # pyg's root weight through the skip
        q = _heads(self.lin_q(x), self.heads)
        k = _heads(self.lin_k(x), self.heads)
        v = _heads(self.lin_v(x), self.heads)
        scores = torch.einsum("...ihd,...jhd->...ijh", q, k) / math.sqrt(
            float(self.out_dim))
        scores = scores.masked_fill(~(a[..., None] > 0), NEG_INF)
        alpha = _dropout(torch.softmax(scores, dim=-2), rate, train,
                         generator)
        msg = torch.einsum("...ijh,...jhd->...ihd", alpha, v)
        skip = _heads(self.lin_skip(x), self.heads)
        if self.beta:
            beta = torch.sigmoid(self.lin_beta(
                torch.cat([skip, msg, skip - msg], dim=-1)))
            out = beta * skip + (1.0 - beta) * msg
        else:
            out = skip + msg
        if self.concat:
            return out.reshape(*out.shape[:-2], -1)
        return out.mean(dim=-2)


class GraphMIL(nn.Module):
    """The reference's ``GraphMIL`` (``utils_g_mil.py:329-492``): an input
    projection where residuals need it, ``gnn_layers`` GNN layers each with
    LayerNorm + ReLU + dropout and a residual where the shapes match,
    multi-head Tanh-gated attention pooling (mean of the heads), a light or
    deep classifier, softmax probabilities out."""

    def __init__(self, input_dim: int = 768, gnn_type: str = "gat",
                 gnn_hidden: int = 256, gnn_layers: int = 2,
                 gnn_dropout: float = 0.1, gnn_heads: int = 4,
                 gnn_concat: bool = True, att_dim: int = 128,
                 att_heads: int = 4, pool_dropout: float = 0.2,
                 classifier_dim: int = 128, classifier_light: bool = False,
                 num_classes: int = 7, use_residual: bool = True,
                 use_layer_norm: bool = True):
        super().__init__()
        gnn_type = gnn_type.lower()
        if gnn_type not in ("gcn", "gin", "graphsage", "gat", "transformer"):
            raise ValueError(f"Unsupported gnn_type: {gnn_type}")
        self.gnn_type, self.gnn_layers = gnn_type, gnn_layers
        self.gnn_dropout, self.pool_dropout = gnn_dropout, pool_dropout
        self.att_heads, self.classifier_light = att_heads, classifier_light
        self.use_residual = use_residual
        self.use_layer_norm = use_layer_norm
        width = input_dim
        if use_residual and input_dim != gnn_hidden:
            self.input_proj = nn.Linear(input_dim, gnn_hidden)
            width = gnn_hidden
        for i in range(gnn_layers):
            if gnn_type == "gin":
                layer = GINLayer(width, gnn_hidden)
            elif gnn_type == "graphsage":
                layer = GraphSAGELayer(width, gnn_hidden)
            elif gnn_type == "transformer":
                layer = TransformerConvLayer(width, gnn_hidden, gnn_heads,
                                             gnn_concat, gnn_dropout)
            elif gnn_type == "gat":
                layer = GATLayer(width, gnn_hidden, gnn_heads, gnn_concat,
                                 gnn_dropout)
            else:
                layer = GCNLayer(width, gnn_hidden)
            self.add_module(f"gnn_{i}", layer)
            width = (gnn_hidden * gnn_heads
                     if gnn_type in ("gat", "transformer") and gnn_concat
                     else gnn_hidden)
            if use_layer_norm:
                self.add_module(f"ln_{i}", LayerNorm(width))
        for j in range(att_heads):
            self.add_module(f"pool_att{j}_fc1", nn.Linear(width, att_dim))
            self.add_module(f"pool_att{j}_fc2", nn.Linear(att_dim, 1))
        self.cls_fc1 = nn.Linear(width, classifier_dim)
        if classifier_light:
            self.cls_fc2 = nn.Linear(classifier_dim, num_classes)
        else:
            self.cls_ln1 = LayerNorm(classifier_dim)
            self.cls_fc2 = nn.Linear(classifier_dim, classifier_dim // 2)
            self.cls_ln2 = LayerNorm(classifier_dim // 2)
            self.cls_fc3 = nn.Linear(classifier_dim // 2, num_classes)

    def forward(self, x: torch.Tensor, adj: torch.Tensor,
                valid: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                gnn_dropout_rate: Optional[Rate] = None,
                pool_dropout_rate: Optional[Rate] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [..., N, input_dim], adj [..., N, N], valid [..., N] →
        (probs [..., num_classes], attention [..., N, att_heads]).  The two
        rate arguments override the module's dropout rates (JAX :185-190)."""
        g_rate = self.gnn_dropout if gnn_dropout_rate is None \
            else gnn_dropout_rate
        p_rate = self.pool_dropout if pool_dropout_rate is None \
            else pool_dropout_rate
        h = x
        if hasattr(self, "input_proj"):
            h = self.input_proj(h)
        for i in range(self.gnn_layers):
            h_prev = h
            layer = getattr(self, f"gnn_{i}")
            if self.gnn_type in ("gat", "transformer"):
                h = layer(h, adj, train=train, dropout_rate=g_rate,
                          generator=generator)
            else:
                h = layer(h, adj)
            if self.use_layer_norm:
                h = getattr(self, f"ln_{i}")(h)
            h = _dropout(F.relu(h), g_rate, train, generator)
            if self.use_residual and h_prev.shape == h.shape:
                h = h + h_prev

        attentions, pooled = [], []
        for j in range(self.att_heads):
            scores = getattr(self, f"pool_att{j}_fc2")(torch.tanh(
                getattr(self, f"pool_att{j}_fc1")(h)))
            if valid is not None:
                scores = scores.masked_fill(~valid[..., None], NEG_INF)
            a = torch.softmax(scores, dim=-2)
            attentions.append(a)
            pooled.append(torch.sum(a * h, dim=-2))
        z = torch.stack(pooled, dim=0).mean(dim=0)
        attention = torch.cat(attentions, dim=-1)  # [..., N, att_heads]

        c = self.cls_fc1(z)
        if self.classifier_light:
            c = _dropout(F.relu(c), p_rate, train, generator)
            logits = self.cls_fc2(c)
        else:
            c = _dropout(F.relu(self.cls_ln1(c)), p_rate, train, generator)
            c = self.cls_fc2(c)
            c = _dropout(F.relu(self.cls_ln2(c)), p_rate / 2, train,
                         generator)
            logits = self.cls_fc3(c)
        return torch.softmax(logits, dim=-1), attention
