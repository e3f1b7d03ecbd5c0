"""Pre-LayerNorm transformer encoder/decoder (counterpart of
``detr_tpu/models/transformer.py``).

Module and parameter names follow the reference ``state_dict`` that
``detr_tpu.models.convert.export_detr_state_dict`` writes
(``encoder.layers.0.self_attention.query_proj.weight``,
``encoder.layers.0.ffn.layers.0.weight``, ``bbox_embedding.net.0.weight``).

Dtype islands as in JAX: parameters are fp32; Dense layers compute in
``config.dtype``; LayerNorm runs in fp32 and casts back; every attention goes
through ``ops.masked_attention``.

Dropout in train mode, at the JAX package's sites: attention probabilities
(inside the attention kernel), the residual after ``output_proj``, and both
FFN slots (``layers.2`` and ``layers.4``, so the ``Sequential`` numbering
matches the reference).  All of them are hash dropout: each site draws one
int32 seed per step from a ``torch.Generator`` on the CPU (no device sync),
which the caller passes down through ``forward``; without one, the default
CPU generator is used.  flax's threefry seed streams are not reproduced, so
parity with JAX holds at equal seeds, op by op.

Multi-rank runs (``parallel``): ``batch_offset``, threaded down every
``forward``, is the first row of this rank's block of the global batch, and
every dropout draws the global array's mask for its block.  Under a
tensor-parallel group (``tp``, ``parallel.tp``) ``MultiHeadAttention``
holds H/tp heads and ``FFN`` 1/tp of the hidden width: the q/k/v
projections and fc1 are column splits, ``output_proj`` and fc2 row splits
(``RowDense``), and each block's input passes ``copy_to_group``.

``config.remat`` (in training, with gradients on) wraps every encoder and
decoder layer in ``torch.utils.checkpoint`` (non-reentrant): the layer keeps
only its inputs, and the backward runs its forward again.  Its dropout seeds
must be the same both times, and checkpoint restores the global RNG only, not
the explicit generator the seeds come from.  So ``_layer_call`` fixes the
layer's seeds before the call, as flax's ``nn.remat`` splits its rng: it
saves the generator's state, runs the layer (and its recomputation) on a
copy started from that state, and then moves the caller's generator past the
layer's draws, exactly where a plain call leaves it.  The masks, and so the
loss and the gradients, are those of the plain call.  Under tensor
parallelism the recomputation repeats the layer's collectives, on every rank
alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from detr_tpu_torch.config import DETRConfig
from detr_tpu_torch.ops.dropout import hash_dropout
from detr_tpu_torch.ops.masked_attention import masked_attention
from detr_tpu_torch.parallel.tp import TensorParallel, copy_to_group, reduce_from_group


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One dropout seed in [0, int32 max), as the JAX package draws one per
    site with ``jax.random.randint``."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def _layer_call(layer: nn.Module, remat: bool, args: tuple,
                generator: Optional[torch.Generator], batch_offset: int) -> torch.Tensor:
    """``layer(*args, generator, batch_offset)``, checkpointed when ``remat``
    is on in training with gradients enabled (module docstring)."""
    if not (remat and layer.training and torch.is_grad_enabled()):
        return layer(*args, generator, batch_offset)
    if generator is None:  # the default generator: checkpoint restores it
        return torch.utils.checkpoint.checkpoint(layer, *args, None, batch_offset,
                                                 use_reentrant=False)
    start = generator.get_state()
    after = []

    def run(*inputs):
        seeds = torch.Generator(generator.device)
        seeds.set_state(start)  # the same draws in the forward and the recompute
        out = layer(*inputs, seeds, batch_offset)
        after.append(seeds.get_state())
        return out

    out = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
    generator.set_state(after[0])
    return out


class Dense(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``
    (flax ``nn.Dense(dtype=..., param_dtype=float32)``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class RowDense(Dense):
    """The row split of a ``Dense`` over a tensor-parallel group: this
    rank's input features (its weight's columns), the partial products
    summed over the group, then the replicated bias, added once."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 tp: TensorParallel):
        super().__init__(in_features, out_features, dtype)
        self.tp = tp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        return reduce_from_group(partial, self.tp.group) + self.bias.to(dt)


def _split_dense(in_features: int, out_features: int, dtype: torch.dtype,
                 tp: Optional[TensorParallel]) -> Dense:
    """A row-split Dense under ``tp`` (``in_features`` already this rank's
    share), a plain one without."""
    if tp is None:
        return Dense(in_features, out_features, dtype)
    return RowDense(in_features, out_features, dtype, tp)


def _tp_size(tp: Optional[TensorParallel]) -> int:
    return 1 if tp is None else tp.size


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 whatever the input dtype (an fp32 island)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class HashDropout(nn.Module):
    """A dropout slot: ``hash_dropout`` with one seed drawn per call from
    the generator its forward is given."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                batch_offset: int = 0, col_offset: int = 0,
                total_cols: Optional[int] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        return hash_dropout(x, self.rate, draw_seed(generator), deterministic=False,
                            batch_offset=batch_offset, col_offset=col_offset,
                            total_cols=total_cols)


class MultiHeadAttention(nn.Module):
    """Separate Q/K/V/output projections around the masked-attention core;
    under ``tp``, this rank's heads only."""

    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.config = config
        self.tp = tp
        if config.num_attention_heads % _tp_size(tp):
            raise ValueError(f"{config.num_attention_heads} heads do not split over "
                             f"{_tp_size(tp)} ranks")
        self.heads = config.num_attention_heads // _tp_size(tp)
        dt = getattr(torch, config.dtype)
        d = config.hidden_size
        local = self.heads * config.head_size
        self.query_proj = Dense(d, local, dt)
        self.key_proj = Dense(d, local, dt)
        self.value_proj = Dense(d, local, dt)
        self.output_proj = _split_dense(local, d, dt, tp)
        self.output_dropout = HashDropout(config.hidden_dropout_prob)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> torch.Tensor:
        cfg = self.config
        B, L, _ = query.shape
        S = key.shape[1]
        H, Dh = self.heads, cfg.head_size
        hash_base = None
        if self.tp is not None or batch_offset:
            hash_base = (batch_offset, 0 if self.tp is None else self.tp.rank * H,
                         cfg.num_attention_heads)
        if self.tp is not None:
            # one copy per distinct input tensor (self-attention passes the
            # same one as query and key)
            copies: dict[int, torch.Tensor] = {}
            for x in (query, key, value):
                if id(x) not in copies:
                    copies[id(x)] = copy_to_group(x, self.tp.group)
            query, key, value = (copies[id(x)] for x in (query, key, value))
        q = self.query_proj(query).reshape(B, L, H, Dh)
        k = self.key_proj(key).reshape(B, S, H, Dh)
        v = self.value_proj(value).reshape(B, S, H, Dh)
        rate, seed = 0.0, None
        if self.training and cfg.attention_probs_dropout_prob > 0.0:
            rate, seed = cfg.attention_probs_dropout_prob, draw_seed(generator)
        out, _ = masked_attention(q, k, v, key_padding_mask, rate, seed, hash_base)
        out = self.output_proj(out.reshape(B, L, H * Dh))
        return self.output_dropout(out, generator, batch_offset)


class FFN(nn.Module):
    """Linear(d, 8d) -> GELU(tanh) -> [dropout] -> Linear(8d, d) -> [dropout];
    under ``tp``, this rank's 8d/tp hidden columns.  ``activation`` (a
    module class) replaces the GELU: Deformable DETR's ``nn.ReLU``."""

    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None,
                 activation: Optional[type] = None):
        super().__init__()
        dt = getattr(torch, config.dtype)
        self.tp = tp
        self.width = config.ffn_hidden_size
        if self.width % _tp_size(tp):
            raise ValueError(f"the FFN width {self.width} does not split over {_tp_size(tp)} ranks")
        local = self.width // _tp_size(tp)
        self.col_offset = 0 if tp is None else tp.rank * local
        self.layers = nn.Sequential(
            Dense(config.hidden_size, local, dt),
            nn.GELU(approximate="tanh") if activation is None else activation(),
            HashDropout(config.hidden_dropout_prob),
            _split_dense(local, config.hidden_size, dt, tp),
            HashDropout(config.hidden_dropout_prob),
        )

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                batch_offset: int = 0) -> torch.Tensor:
        fc1, act, drop1, fc2, drop2 = self.layers
        if self.tp is not None:
            x = copy_to_group(x, self.tp.group)
        h = drop1(act(fc1(x)), generator, batch_offset, self.col_offset, self.width)
        return drop2(fc2(h), generator, batch_offset)


class MLP(nn.Module):
    """Box-head MLP: fp32 Dense stack with GELU(tanh) between the layers, or
    ``activation`` (a module class) in its place."""

    def __init__(self, hidden_dim: int, output_dim: int, num_layers: int,
                 activation: Optional[type] = None):
        super().__init__()
        layers: list[nn.Module] = []
        for i in range(num_layers):
            out_dim = output_dim if i == num_layers - 1 else hidden_dim
            layers.append(Dense(hidden_dim, out_dim, torch.float32))
            if i < num_layers - 1:
                layers.append(nn.GELU(approximate="tanh") if activation is None else activation())
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class EncoderLayer(nn.Module):
    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        eps = config.layer_norm_eps
        self.dtype = getattr(torch, config.dtype)
        self.norm1 = LayerNorm32(config.hidden_size, eps=eps)
        self.self_attention = MultiHeadAttention(config, tp)
        self.norm2 = LayerNorm32(config.hidden_size, eps=eps)
        self.ffn = FFN(config, tp)

    def forward(
        self,
        x: torch.Tensor,
        position_embedding: torch.Tensor,
        key_padding_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> torch.Tensor:
        x_attn = self.norm1(x).to(self.dtype)
        qk = x_attn + position_embedding.to(self.dtype)
        x = x + self.self_attention(qk, qk, x_attn, key_padding_mask, generator, batch_offset)
        return x + self.ffn(self.norm2(x).to(self.dtype), generator, batch_offset)


class Encoder(nn.Module):
    """Pre-LN encoder stack + final LayerNorm."""

    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.dtype = getattr(torch, config.dtype)
        self.remat = config.remat
        self.layers = nn.ModuleList(
            EncoderLayer(config, tp) for _ in range(config.num_encoder_layers)
        )
        self.norm = LayerNorm32(config.hidden_size, eps=config.layer_norm_eps)

    def forward(
        self,
        x: torch.Tensor,
        position_embedding: torch.Tensor,
        key_padding_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> torch.Tensor:
        for layer in self.layers:
            x = _layer_call(layer, self.remat, (x, position_embedding, key_padding_mask),
                            generator, batch_offset)
        return self.norm(x).to(self.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        eps = config.layer_norm_eps
        self.dtype = getattr(torch, config.dtype)
        self.norm1 = LayerNorm32(config.hidden_size, eps=eps)
        self.self_attention = MultiHeadAttention(config, tp)
        self.norm2 = LayerNorm32(config.hidden_size, eps=eps)
        self.cross_attention = MultiHeadAttention(config, tp)
        self.norm3 = LayerNorm32(config.hidden_size, eps=eps)
        self.ffn = FFN(config, tp)

    def forward(
        self,
        x: torch.Tensor,
        encoded_image_tokens: torch.Tensor,
        object_query_embedding: torch.Tensor,
        position_embedding: torch.Tensor,
        key_padding_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> torch.Tensor:
        dt = self.dtype
        query_embed = object_query_embedding.to(dt)
        x_attn = self.norm1(x).to(dt)
        qk = x_attn + query_embed
        x = x + self.self_attention(qk, qk, x_attn, None, generator, batch_offset)

        q = self.norm2(x).to(dt) + query_embed
        k = encoded_image_tokens + position_embedding.to(dt)
        x = x + self.cross_attention(q, k, encoded_image_tokens, key_padding_mask, generator,
                                     batch_offset)
        return x + self.ffn(self.norm3(x).to(dt), generator, batch_offset)


class Decoder(nn.Module):
    """Pre-LN decoder from zeros; stacks every layer's shared-norm output
    -> (B, num_layers, Q, D)."""

    def __init__(self, config: DETRConfig, tp: Optional[TensorParallel] = None):
        super().__init__()
        self.dtype = getattr(torch, config.dtype)
        self.remat = config.remat
        self.layers = nn.ModuleList(
            DecoderLayer(config, tp) for _ in range(config.num_decoder_layers)
        )
        self.norm = LayerNorm32(config.hidden_size, eps=config.layer_norm_eps)

    def forward(
        self,
        encoded_image_tokens: torch.Tensor,
        position_embedding: torch.Tensor,
        object_query_embedding: torch.Tensor,
        key_padding_mask: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        batch_offset: int = 0,
    ) -> torch.Tensor:
        x = torch.zeros_like(object_query_embedding, dtype=self.dtype)
        outputs = []
        for layer in self.layers:
            x = _layer_call(layer, self.remat, (x, encoded_image_tokens, object_query_embedding,
                                                position_embedding, key_padding_mask),
                            generator, batch_offset)
            outputs.append(self.norm(x).to(self.dtype))
        return torch.stack(outputs, dim=1)
