"""Decoder-only transformer LM (counterpart of
``paddle_tpu/models/transformer.py``), in two forms:

- the functions at the end of this module that build the training Program
  (`transformer_lm_train_program` and the layers it calls), which emit
  the JAX package's ops, names and shapes through the Fluid front end;
- the generation model `TransformerLM`, an ``nn.Module`` that the decode
  engine serves.

The model is the one the JAX package builds in ``transformer_lm_logits``
and serves through ``transformer_lm_prefill_logits`` /
``transformer_lm_decode_logits``; for ``n_layers = L``:

- input: ``embedding_0.w_0`` [V, d] lookup, times sqrt(d), plus the
  ``pos_encoding_0.w_0`` [max_len, d] rows of each position;
- layer i (post-LN): ``fc_{3i}`` qkv [d, 3d] -> attention (no output
  projection) -> ``layer_norm_{2i}(x + attn)`` -> ``fc_{3i+1}`` [d, d_ff]
  with relu -> ``fc_{3i+2}`` [d_ff, d] -> ``layer_norm_{2i+1}(x + ffn)``,
  eps 1e-5;
- LM head: ``fc_{3L}`` [d, V].

fc weights are ``[in, out]`` and compute ``x @ w + b``.  The names above
are the saved artifact's variable names, which `params_from_numpy` maps
onto the module.  ``precision="bf16"`` holds every parameter and the
activation stream in bf16 (the JAX predictor's cast); the LayerNorm
scale and bias are rounded through bf16 the same way but kept as f32,
which is what the LayerNorm kernel reads.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import layers, nets
from ..core.place import precision_dtype, resolve_device
from ..ops.attention_ops import self_attention
from ..ops.kv_cache_ops import batched_select, pos_encoding_add, write_plan
from ..ops.nn_ops import layer_norm

GENERATION_SPEC_FILENAME = "__generation__.json"
LN_EPSILON = 1e-5


def generation_spec(vocab, max_len, n_layers=2, d_model=64, n_heads=4,
                    d_ff=256, eos_id=None) -> dict:
    """The hyperparameter dict written to ``__generation__.json``."""
    return {"family": "transformer_lm", "vocab": int(vocab),
            "max_len": int(max_len), "n_layers": int(n_layers),
            "d_model": int(d_model), "n_heads": int(n_heads),
            "d_ff": int(d_ff),
            "eos_id": None if eos_id is None else int(eos_id)}


def read_generation_spec(model_dir: str) -> Optional[dict]:
    """The ``__generation__.json`` next to a saved model, or None."""
    try:
        with open(os.path.join(model_dir, GENERATION_SPEC_FILENAME)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def param_shapes(spec: dict) -> Dict[str, Tuple[int, ...]]:
    """Artifact variable name -> shape, for every parameter of the model."""
    v, t, d, ff = spec["vocab"], spec["max_len"], spec["d_model"], spec["d_ff"]
    shapes = {"embedding_0.w_0": (v, d), "pos_encoding_0.w_0": (t, d)}
    for i in range(spec["n_layers"]):
        for j, (fin, fout) in enumerate(((d, 3 * d), (d, ff), (ff, d))):
            shapes[f"fc_{3 * i + j}.w_0"] = (fin, fout)
            shapes[f"fc_{3 * i + j}.b_0"] = (fout,)
        for j in range(2):
            shapes[f"layer_norm_{2 * i + j}.w_0"] = (d,)
            shapes[f"layer_norm_{2 * i + j}.b_0"] = (d,)
    n = 3 * spec["n_layers"]
    shapes[f"fc_{n}.w_0"] = (d, v)
    shapes[f"fc_{n}.b_0"] = (v,)
    return shapes


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """The sinusoidal position table the JAX model initialises."""
    pos = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[:d_model // 2])
    return table


def random_params(spec: dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded random f32 parameters under the artifact's names (Xavier-
    scaled weights, small random biases and LayerNorm affines, the
    sinusoid position table)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in param_shapes(spec).items():
        if name == "pos_encoding_0.w_0":
            out[name] = sinusoid_table(*shape)
        elif name.startswith("layer_norm") and name.endswith("w_0"):
            out[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(
                np.float32)
        elif len(shape) == 1:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        else:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = rng.uniform(-lim, lim, shape).astype(np.float32)
    return out


class KVCache:
    """One forward pass's view of the paged KV cache: the per-layer pool
    pairs, the page table, the write start (``index``), the valid rows of
    a prefill (``length``) and the write plan shared by every layer.
    Each attention call takes the next layer's pools."""

    def __init__(self, mode: str, pools: List[Tuple[torch.Tensor,
                                                    torch.Tensor]],
                 pages: torch.Tensor, index: torch.Tensor, t: int,
                 length: Optional[torch.Tensor] = None):
        if mode not in ("decode", "prefill"):
            raise ValueError(f"mode must be decode|prefill, got {mode!r}")
        self.mode = mode
        self.pools = pools
        self.pages = pages
        self.index = index
        self.length = length
        n, block_len = pools[0][0].shape[0], pools[0][0].shape[1]
        self.plan = write_plan(pages, index, t, block_len, n, length)
        self._cursor = 0

    def next_pools(self):
        pair = self.pools[self._cursor]
        self._cursor += 1
        return pair


class DecoderLayer(nn.Module):
    """One post-LN decoder layer (``transformer_decoder_layer``)."""

    def __init__(self, d_model, n_heads, d_ff, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.n_heads = n_heads
        self.qkv_w = nn.Parameter(torch.empty(d_model, 3 * d_model, **kw))
        self.qkv_b = nn.Parameter(torch.empty(3 * d_model, **kw))
        self.ln1_w = nn.Parameter(torch.empty(d_model, **f32))
        self.ln1_b = nn.Parameter(torch.empty(d_model, **f32))
        self.ffn1_w = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.ffn1_b = nn.Parameter(torch.empty(d_ff, **kw))
        self.ffn2_w = nn.Parameter(torch.empty(d_ff, d_model, **kw))
        self.ffn2_b = nn.Parameter(torch.empty(d_model, **kw))
        self.ln2_w = nn.Parameter(torch.empty(d_model, **f32))
        self.ln2_b = nn.Parameter(torch.empty(d_model, **f32))

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None):
        b, t, d = x.shape
        attn = self_attention(x, self.qkv_w, self.qkv_b, self.n_heads,
                              causal=True, cache=cache)
        x, _, _ = layer_norm(x + attn, self.ln1_w, self.ln1_b, 2, LN_EPSILON)
        h = torch.relu(torch.addmm(self.ffn1_b, x.reshape(b * t, d),
                                   self.ffn1_w))
        ffn = torch.addmm(self.ffn2_b, h, self.ffn2_w).reshape(b, t, d)
        x, _, _ = layer_norm(x + ffn, self.ln2_w, self.ln2_b, 2, LN_EPSILON)
        return x


class TransformerLM(nn.Module):
    """The generation model: `forward` is the full-prefix LM, `prefill`
    and `decode` the two paged-KV programs of the decode engine."""

    def __init__(self, spec: dict, precision: str = "f32", device=None):
        super().__init__()
        if spec.get("family", "transformer_lm") != "transformer_lm":
            raise ValueError(f"unsupported generation family "
                             f"{spec.get('family')!r}")
        if spec["d_model"] % spec["n_heads"]:
            raise ValueError("d_model must be a multiple of n_heads")
        dev = resolve_device(device)
        dtype = precision_dtype(precision)
        self.spec = dict(spec)
        self.precision = precision
        self.dtype = dtype
        self.device = dev
        d, v = spec["d_model"], spec["vocab"]
        self.head_dim = d // spec["n_heads"]
        kw = dict(dtype=dtype, device=dev)
        self.embedding = nn.Parameter(torch.empty(v, d, **kw))
        self.register_buffer("pos_encoding",
                             torch.empty(spec["max_len"], d, **kw))
        self.layers = nn.ModuleList(
            DecoderLayer(d, spec["n_heads"], spec["d_ff"], dtype, dev)
            for _ in range(spec["n_layers"]))
        self.head_w = nn.Parameter(torch.empty(d, v, **kw))
        self.head_b = nn.Parameter(torch.empty(v, **kw))
        self.requires_grad_(False)

    # -- parameter names ------------------------------------------------
    def named_artifact_tensors(self) -> Dict[str, torch.Tensor]:
        """Artifact variable name -> the module tensor that holds it."""
        out = {"embedding_0.w_0": self.embedding,
               "pos_encoding_0.w_0": self.pos_encoding}
        for i, layer in enumerate(self.layers):
            fc = (("qkv", 3 * i), ("ffn1", 3 * i + 1), ("ffn2", 3 * i + 2))
            for attr, k in fc:
                out[f"fc_{k}.w_0"] = getattr(layer, f"{attr}_w")
                out[f"fc_{k}.b_0"] = getattr(layer, f"{attr}_b")
            for j in range(2):
                out[f"layer_norm_{2 * i + j}.w_0"] = getattr(layer,
                                                            f"ln{j + 1}_w")
                out[f"layer_norm_{2 * i + j}.b_0"] = getattr(layer,
                                                            f"ln{j + 1}_b")
        n = 3 * len(self.layers)
        out[f"fc_{n}.w_0"] = self.head_w
        out[f"fc_{n}.b_0"] = self.head_b
        return out

    def new_kv_pools(self, num_blocks: int, block_len: int
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (K, V) pools ``[num_blocks, block_len, heads,
        head_dim]`` in the activation dtype."""
        shape = (num_blocks, block_len, self.spec["n_heads"], self.head_dim)
        return [(torch.zeros(shape, dtype=self.dtype, device=self.device),
                 torch.zeros(shape, dtype=self.dtype, device=self.device))
                for _ in self.layers]

    # -- forward passes ---------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding[tokens] * math.sqrt(self.spec["d_model"])

    def _head(self, x2: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.head_b, x2, self.head_w)

    def forward(self, tokens: torch.Tensor,
                last: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-prefix causal LM over ``tokens [B, T]`` -> logits
        ``[B, T, V]``; with ``last [B]`` only row ``last[b]`` of each
        sequence goes through the LM head -> ``[B, V]``."""
        x = pos_encoding_add(self._embed(tokens), self.pos_encoding)
        for layer in self.layers:
            x = layer(x)
        if last is not None:
            return self._head(batched_select(x, last))
        b, t, d = x.shape
        return self._head(x.reshape(b * t, d)).reshape(b, t, -1)

    def prefill(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
                length: torch.Tensor) -> torch.Tensor:
        """Write the prompt ``tokens [B, T]`` (valid rows ``length [B]``)
        into the paged cache from position 0 and return the next-token
        logits ``[B, V]`` (position ``length - 1``).  Only that row goes
        through the LM head: the JAX program computes all T rows and then
        selects one, the same values at T times the head's cost."""
        b, t = tokens.shape
        index = torch.zeros(b, dtype=torch.int32, device=tokens.device)
        cache = KVCache("prefill", pools, pages, index, t, length)
        x = pos_encoding_add(self._embed(tokens), self.pos_encoding)
        for layer in self.layers:
            x = layer(x, cache)
        return self._head(batched_select(x, length, offset=-1))

    def decode(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
        """One decode iteration for the slot batch: ``tokens [S]`` at
        positions ``index [S]`` -> next-token logits ``[S, V]``, appending
        each slot's K/V to the paged cache."""
        s = tokens.shape[0]
        cache = KVCache("decode", pools, pages, index, 1)
        x = pos_encoding_add(self._embed(tokens), self.pos_encoding, index)
        x = x.reshape(s, 1, -1)
        for layer in self.layers:
            x = layer(x, cache)
        return self._head(x.reshape(s, -1))


def params_from_numpy(spec: dict, arrays: Dict[str, np.ndarray],
                      precision: str = "f32", device=None) -> TransformerLM:
    """Build the model from the artifact's arrays (the weight carry-over
    from the JAX package).  Raises on a missing or surplus name and on a
    shape mismatch."""
    model = TransformerLM(spec, precision=precision, device=device)
    targets = model.named_artifact_tensors()
    missing = sorted(set(targets) - set(arrays))
    surplus = sorted(set(arrays) - set(targets))
    if missing or surplus:
        raise ValueError(f"parameter names do not match the model: missing "
                         f"{missing}, surplus {surplus}")
    for name, dst in targets.items():
        src = np.asarray(arrays[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the model's {tuple(dst.shape)}")
        val = torch.from_numpy(np.ascontiguousarray(src, np.float32))
        # bf16 serving rounds every parameter through bf16 (LayerNorm
        # affines included), whatever dtype the module keeps it in
        val = val.to(model.dtype).to(dst.dtype)
        dst.copy_(val)
    return model


# ---------------------------------------------------------------------------
# training programs (the Fluid front end)
# ---------------------------------------------------------------------------

def _positional_encoding(x, max_len, d_model):
    """The sinusoid table as a trainable=False parameter (no gradient, no
    optimizer state), added to ``x [B, max_len, d]`` through reshape +
    elementwise_add, the JAX package's training emission."""
    from ..initializer import NumpyArrayInitializer
    from ..layer_helper import LayerHelper
    helper = LayerHelper("pos_encoding")
    pe = helper.create_parameter(
        attr=None, shape=[max_len, d_model], dtype="float32",
        default_initializer=NumpyArrayInitializer(
            sinusoid_table(max_len, d_model)))
    pe.trainable = False
    return layers.elementwise_add(x, layers.reshape(
        pe, shape=[1, max_len, d_model]))


def _ffn(x, d_model, d_ff, dropout):
    h = layers.fc(input=x, size=d_ff, num_flatten_dims=2, act="relu")
    h = layers.sharding_constraint(h, ("batch", "length", "mlp"))
    if dropout:
        h = layers.dropout(h, dropout_prob=dropout)
    out = layers.fc(input=h, size=d_model, num_flatten_dims=2)
    return layers.sharding_constraint(out, ("batch", "length", "embed"))


def _residual_norm(x, y, dropout):
    if dropout:
        y = layers.dropout(y, dropout_prob=dropout)
    return layers.layer_norm(layers.elementwise_add(x, y),
                             begin_norm_axis=2)


def transformer_decoder_layer(x, d_model, n_heads, d_ff, dropout=0.0):
    """One post-LN decoder layer: causal self-attention, residual + LN,
    FFN, residual + LN."""
    attn = nets.scaled_dot_product_attention(x, x, x, num_heads=n_heads,
                                             causal=True)
    x = _residual_norm(x, attn, dropout)
    return _residual_norm(x, _ffn(x, d_model, d_ff, dropout), dropout)


def transformer_lm_logits(tokens, vocab, max_len, n_layers=2, d_model=64,
                          n_heads=4, d_ff=256, dropout=0.0):
    """Decoder-only causal LM over [B, T] ids -> pre-softmax [B, T, vocab]."""
    emb = layers.embedding(input=tokens, size=[vocab, d_model])
    x = layers.scale(emb, scale=math.sqrt(d_model))
    x = _positional_encoding(x, max_len, d_model)
    x = layers.amp_cast(x)
    for _ in range(n_layers):
        x = transformer_decoder_layer(x, d_model, n_heads, d_ff, dropout)
    return layers.fc(input=x, size=vocab, num_flatten_dims=2)


def transformer_lm_train_program(vocab=128, max_len=64, n_layers=2,
                                 d_model=64, n_heads=4, d_ff=256,
                                 dropout=0.0, lr=1e-3, amp=False):
    """(tokens, labels, avg_cost): next-token prediction over [B, T] in the
    default programs, with Adam.  The loss head is the fused
    softmax_with_cross_entropy op: no [B, T, V] probability tensor in
    either direction."""
    from .. import optimizer as opt_mod
    tokens = layers.data(name="tokens", shape=[max_len], dtype="int64")
    labels = layers.data(name="labels", shape=[max_len], dtype="int64")
    logits = transformer_lm_logits(tokens, vocab, max_len, n_layers,
                                   d_model, n_heads, d_ff, dropout)
    labels3 = layers.reshape(labels, shape=[-1, max_len, 1])
    cost = layers.softmax_with_cross_entropy(logits=logits, label=labels3)
    avg_cost = layers.mean(cost)
    opt_mod.Adam(learning_rate=lr, amp=amp).minimize(avg_cost)
    return tokens, labels, avg_cost

