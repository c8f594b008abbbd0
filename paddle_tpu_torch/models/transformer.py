"""Decoder-only transformer LM (counterpart of
``paddle_tpu/models/transformer.py``), in two forms:

- the functions at the end of this module that build Programs through
  the Fluid front end, with the JAX package's ops, names and shapes: the
  training Program (`transformer_lm_train_program` and the layers it
  calls) and the generation Programs (`build_generation_programs`: the
  bucketed prefill and the one-token decode step over the paged KV cache,
  through the `KVCache` build handle), which ``DecodeEngine(scope,
  spec)`` serves;
- the generation model `TransformerLM`, an ``nn.Module`` that
  ``DecodeEngine(model)`` and ``DecodeEngine.from_model_dir`` serve, and
  `save_generation_model`, which writes the artifact both packages
  serve.

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
which is what the LayerNorm kernel reads.  ``precision="int8"`` runs the
bf16 activation stream with every f32 matrix of at least
``INT8_MIN_ELEMENTS`` elements held as int8 with per-column scales (the
predictor's quantization, `core.lowering.quantize_int8`), dequantized to
bf16 in every forward as the JAX compiled forward does (the embedding
table only in the rows it gathers); the rest is bf16 and the KV pools
stay f32, as in the JAX decode engine.

``exact=True`` on `forward`, `prefill` and `decode` is the decode
engine's ``numerics="exact"``: every product runs on the row-stable
product kernel and every attention in f32 on the flash forward kernel
(``ops/attention_ops.py``), so a row's logits do not depend on the batch
or the call it is computed in.  Called at ``T = max_len`` (the engine
pads its prefill, `greedy_decode_full` its recompute), the three give a
position bitwise the same logits.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import layers, nets
from ..core.place import precision_dtype, resolve_device
from ..core.lowering import INT8_MIN_ELEMENTS, dequantize_int8, quantize_int8
from ..ops.attention_ops import linear, self_attention
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


def save_generation_model(dirname, vocab, max_len, n_layers=2, d_model=64,
                          n_heads=4, d_ff=256, eos_id=None, seed=None,
                          scope=None, init=True) -> dict:
    """Save a servable generation model, as the JAX package's function of
    this name does: the full-prefix LM inference artifact (``__model__``
    fetching the ``[B, T, V]`` logits, the parameters, the manifest) plus
    ``__generation__.json``, from which a `DecodeEngine` builds the model.
    ``init=True`` runs the startup program (seeded by ``seed``) on the
    CPU first, as the JAX function does; ``init=False`` saves the
    parameters already in ``scope`` (trained weights, or
    `random_params`).  Returns the spec."""
    from .. import io as _io
    from .. import unique_name
    from ..core.executor import Executor
    from ..core.place import CPUPlace
    from ..core.program import Program, program_guard
    from ..core.scope import scope_guard
    spec = generation_spec(vocab, max_len, n_layers, d_model, n_heads,
                           d_ff, eos_id)
    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        tokens = layers.data(name="tokens", shape=[max_len], dtype="int64")
        logits = transformer_lm_logits(tokens, vocab, max_len, n_layers,
                                       d_model, n_heads, d_ff)
    if seed is not None:
        startup.random_seed = seed
    exe = Executor(CPUPlace())
    with contextlib.ExitStack() as stack:
        if scope is not None:
            stack.enter_context(scope_guard(scope))
        if init:
            exe.run(startup)
        _io.save_inference_model(dirname, ["tokens"], [logits], exe,
                                 main_program=main)
        with _io._atomic_write(os.path.join(
                dirname, GENERATION_SPEC_FILENAME)) as f:
            json.dump(spec, f, indent=1)
    return spec


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


class PagedKVView:
    """One `TransformerLM` forward pass's view of the paged KV cache: the
    per-layer pool pairs, the page table, the write start (``index``), the
    valid rows of a prefill (``length``) and the write plan shared by
    every layer.  Each attention call takes the next layer's pools.  (The
    generation Programs' build handle is `KVCache`.)"""

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


def _dequantized(module: nn.Module, attr: str) -> torch.Tensor:
    """``module.<attr>``, dequantized to bf16 when it is held as int8 (its
    scales in the buffer ``<attr>_qscale``)."""
    w = getattr(module, attr)
    scale = getattr(module, attr + "_qscale")
    return w if scale is None else dequantize_int8(w, scale)


class DecoderLayer(nn.Module):
    """One post-LN decoder layer (``transformer_decoder_layer``)."""

    MATRICES = ("qkv_w", "ffn1_w", "ffn2_w")

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
        for attr in self.MATRICES:
            self.register_buffer(attr + "_qscale", None)

    def forward(self, x: torch.Tensor, cache: Optional[PagedKVView] = None,
                exact: bool = False):
        b, t, d = x.shape
        attn = self_attention(x, _dequantized(self, "qkv_w"), self.qkv_b,
                              self.n_heads, causal=True, cache=cache,
                              exact=exact)
        x, _, _ = layer_norm(x + attn, self.ln1_w, self.ln1_b, 2, LN_EPSILON)
        h = torch.relu(linear(x.reshape(b * t, d),
                              _dequantized(self, "ffn1_w"), self.ffn1_b,
                              exact))
        ffn = linear(h, _dequantized(self, "ffn2_w"), self.ffn2_b,
                     exact).reshape(b, t, d)
        x, _, _ = layer_norm(x + ffn, self.ln2_w, self.ln2_b, 2, LN_EPSILON)
        return x


class TransformerLM(nn.Module):
    """The generation model: `forward` is the full-prefix LM, `prefill`
    and `decode` the two paged-KV programs of the decode engine.
    ``precision`` is "f32", "bf16" or "int8" (module docstring)."""

    PRECISIONS = ("f32", "bf16", "int8")

    def __init__(self, spec: dict, precision: str = "f32", device=None):
        super().__init__()
        if spec.get("family", "transformer_lm") != "transformer_lm":
            raise ValueError(f"unsupported generation family "
                             f"{spec.get('family')!r}")
        if spec["d_model"] % spec["n_heads"]:
            raise ValueError("d_model must be a multiple of n_heads")
        if precision not in self.PRECISIONS:
            raise ValueError(f"precision must be one of {self.PRECISIONS}, "
                             f"got {precision!r}")
        dev = resolve_device(device)
        # int8 runs the bf16 activation stream
        dtype = precision_dtype("bf16" if precision == "int8" else precision)
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
        for attr in ("embedding", "pos_encoding", "head_w"):
            self.register_buffer(attr + "_qscale", None)
        self.requires_grad_(False)

    # -- parameter names ------------------------------------------------
    def artifact_slots(self) -> Dict[str, Tuple[nn.Module, str]]:
        """Artifact variable name -> (module, attribute) that holds it."""
        out = {"embedding_0.w_0": (self, "embedding"),
               "pos_encoding_0.w_0": (self, "pos_encoding")}
        for i, layer in enumerate(self.layers):
            fc = (("qkv", 3 * i), ("ffn1", 3 * i + 1), ("ffn2", 3 * i + 2))
            for attr, k in fc:
                out[f"fc_{k}.w_0"] = (layer, f"{attr}_w")
                out[f"fc_{k}.b_0"] = (layer, f"{attr}_b")
            for j in range(2):
                out[f"layer_norm_{2 * i + j}.w_0"] = (layer, f"ln{j + 1}_w")
                out[f"layer_norm_{2 * i + j}.b_0"] = (layer, f"ln{j + 1}_b")
        n = 3 * len(self.layers)
        out[f"fc_{n}.w_0"] = (self, "head_w")
        out[f"fc_{n}.b_0"] = (self, "head_b")
        return out

    def named_artifact_tensors(self) -> Dict[str, torch.Tensor]:
        """Artifact variable name -> the module tensor that holds it."""
        return {name: getattr(mod, attr)
                for name, (mod, attr) in self.artifact_slots().items()}

    def new_kv_pools(self, num_blocks: int, block_len: int
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed per-layer (K, V) pools ``[num_blocks, block_len, heads,
        head_dim]``: bf16 under bf16 serving, f32 otherwise (int8 too, as
        the JAX engine keeps them)."""
        shape = (num_blocks, block_len, self.spec["n_heads"], self.head_dim)
        dtype = torch.bfloat16 if self.precision == "bf16" else torch.float32
        return [(torch.zeros(shape, dtype=dtype, device=self.device),
                 torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in self.layers]

    def step_cost(self, mode: str, batch: int, t: int,
                  span: int = 0) -> Tuple[int, int]:
        """(flops, bytes) of one `prefill` (``batch`` prompts of ``t``
        tokens, attention over ``t`` keys) or `decode` (``batch`` slots,
        attention over each slot's ``span`` of pages) for the cost
        reports (`observability.introspect`): the products the
        generation Programs' cost model counts (2·M·N·K a product, QKᵀ
        and PV), and the bytes of the parameters, the KV rows read and
        written and the logits."""
        spec = self.spec
        d, dff, v = spec["d_model"], spec["d_ff"], spec["vocab"]
        m = batch * t
        keys = t if mode == "prefill" else span
        flops = (len(self.layers) * (2 * m * d * 3 * d + 4 * m * d * dff
                                     + 4 * m * keys * d)
                 + 2 * batch * d * v)
        kv_item = 2 if self.precision == "bf16" else 4
        params = sum(p.numel() * p.element_size()
                     for p in self.named_artifact_tensors().values())
        kv = 2 * len(self.layers) * (batch * keys + m) * d * kv_item
        logits = batch * v * self.dtype.itemsize
        return flops, params + kv + logits

    # -- forward passes ---------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        rows = self.embedding[tokens]
        if self.embedding_qscale is not None:
            rows = dequantize_int8(rows, self.embedding_qscale)
        return rows * math.sqrt(self.spec["d_model"])

    def _pos_add(self, x: torch.Tensor,
                 index: Optional[torch.Tensor] = None) -> torch.Tensor:
        return pos_encoding_add(x, _dequantized(self, "pos_encoding"), index)

    def _head(self, x2: torch.Tensor, exact: bool = False) -> torch.Tensor:
        return linear(x2, _dequantized(self, "head_w"), self.head_b, exact)

    def forward(self, tokens: torch.Tensor,
                last: Optional[torch.Tensor] = None,
                exact: bool = False) -> torch.Tensor:
        """Full-prefix causal LM over ``tokens [B, T]`` -> logits
        ``[B, T, V]``; with ``last [B]`` only row ``last[b]`` of each
        sequence goes through the LM head -> ``[B, V]``."""
        x = self._pos_add(self._embed(tokens))
        for layer in self.layers:
            x = layer(x, exact=exact)
        if last is not None:
            return self._head(batched_select(x, last), exact)
        b, t, d = x.shape
        return self._head(x.reshape(b * t, d), exact).reshape(b, t, -1)

    def prefill(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
                length: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """Write the prompt ``tokens [B, T]`` (valid rows ``length [B]``)
        into the paged cache from position 0 and return the next-token
        logits ``[B, V]`` (position ``length - 1``).  Only that row goes
        through the LM head: the JAX program computes all T rows and then
        selects one, the same values at T times the head's cost."""
        b, t = tokens.shape
        index = torch.zeros(b, dtype=torch.int32, device=tokens.device)
        cache = PagedKVView("prefill", pools, pages, index, t, length)
        x = self._pos_add(self._embed(tokens))
        for layer in self.layers:
            x = layer(x, cache, exact)
        return self._head(batched_select(x, length, offset=-1), exact)

    def decode(self, tokens: torch.Tensor, pools, pages: torch.Tensor,
               index: torch.Tensor, exact: bool = False) -> torch.Tensor:
        """One decode iteration for the slot batch: ``tokens [S]`` at
        positions ``index [S]`` -> next-token logits ``[S, V]``, appending
        each slot's K/V to the paged cache."""
        s = tokens.shape[0]
        cache = PagedKVView("decode", pools, pages, index, 1)
        x = self._pos_add(self._embed(tokens), index)
        x = x.reshape(s, 1, -1)
        for layer in self.layers:
            x = layer(x, cache, exact)
        return self._head(x.reshape(s, -1), exact)


def params_from_numpy(spec: dict, arrays: Dict[str, np.ndarray],
                      precision: str = "f32", device=None) -> TransformerLM:
    """Build the model from the artifact's arrays (the weight carry-over
    from the JAX package).  Raises on a missing or surplus name and on a
    shape mismatch.  Under int8 each matrix of at least
    ``INT8_MIN_ELEMENTS`` elements is quantized on the model's device."""
    model = TransformerLM(spec, precision=precision, device=device)
    slots = model.artifact_slots()
    missing = sorted(set(slots) - set(arrays))
    surplus = sorted(set(arrays) - set(slots))
    if missing or surplus:
        raise ValueError(f"parameter names do not match the model: missing "
                         f"{missing}, surplus {surplus}")
    for name, (mod, attr) in slots.items():
        dst = getattr(mod, attr)
        src = np.asarray(arrays[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the model's {tuple(dst.shape)}")
        val = torch.from_numpy(np.ascontiguousarray(src, np.float32))
        if (precision == "int8" and val.dim() == 2
                and val.numel() >= INT8_MIN_ELEMENTS):
            q, scale = quantize_int8(val.to(model.device))
            dst.data = q
            setattr(mod, attr + "_qscale", scale)
            continue
        # bf16 and int8 serving round every other parameter through bf16
        # (LayerNorm affines included), whatever dtype the module keeps
        val = val.to(model.dtype).to(dst.dtype)
        dst.copy_(val)
    return model


# ---------------------------------------------------------------------------
# training and generation programs (the Fluid front end)
# ---------------------------------------------------------------------------

def _positional_encoding(x, max_len, d_model, index=None, dynamic=False):
    """The sinusoid table as a trainable=False parameter (no gradient, no
    optimizer state).  The training emission adds it to ``x [B, max_len,
    d]`` through reshape + elementwise_add.  The generation programs use
    the ``pos_encoding_add`` op instead: ``dynamic=True`` slices the
    table to x's T (one prefill program serves every prompt bucket), and
    ``index`` adds each decode slot's own position row."""
    from ..initializer import NumpyArrayInitializer
    from ..layer_helper import LayerHelper
    helper = LayerHelper("pos_encoding")
    pe = helper.create_parameter(
        attr=None, shape=[max_len, d_model], dtype="float32",
        default_initializer=NumpyArrayInitializer(
            sinusoid_table(max_len, d_model)))
    pe.trainable = False
    if index is not None or dynamic:
        helper = LayerHelper("pos_encoding_add", input=x)
        out = helper.create_variable_for_type_inference(x.dtype)
        inputs = {"X": [x], "Table": [pe]}
        if index is not None:
            inputs["Index"] = [index]
        helper.append_op(type="pos_encoding_add", inputs=inputs,
                         outputs={"Out": [out]})
        out.desc.shape = x.shape
        return out
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


def transformer_decoder_layer(x, d_model, n_heads, d_ff, dropout=0.0,
                              cache=None):
    """One post-LN decoder layer: causal self-attention (through the paged
    KV cache under a `KVCache` handle), residual + LN, FFN, residual +
    LN."""
    attn = nets.scaled_dot_product_attention(x, x, x, num_heads=n_heads,
                                             causal=True, cache=cache)
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


class KVCache:
    """Build handle of the generation Programs' paged KV cache: the feed
    variables and the updated pools.

    One instance goes through every decoder layer of a generation
    program; each attention call takes the next layer's (PoolK, PoolV)
    feed pair and records its written pools, which
    `build_generation_programs` fetches.  The pool feeds are declared
    ``[-1, block_len, heads, head_dim]``: the engine picks the pool's
    block count without a rebuild.  (A `TransformerLM` forward's runtime
    view is `PagedKVView`.)"""

    def __init__(self, n_layers, n_heads, head_dim, block_len,
                 mode="decode", exact=False, kv_dtype="float32"):
        if mode not in ("decode", "prefill"):
            raise ValueError(f"mode must be decode|prefill, got {mode!r}")
        self.mode = mode
        self.exact = bool(exact)
        self.block_len = int(block_len)
        self.kv_dtype = str(kv_dtype)
        #: decode: the query token's position per slot; prefill: the
        #: write start (0)
        self.index = layers.data(name="kv_index", shape=[1], dtype="int32")
        #: [S, P] block ids per slot; an idle slot's row is num_blocks
        self.pages = layers.data(name="kv_pages", shape=[1], dtype="int32")
        self.length = (layers.data(name="kv_len", shape=[1], dtype="int32")
                       if mode == "prefill" else None)
        self.pools = []
        for i in range(n_layers):
            pk = layers.data(name=f"kv_k_{i}",
                             shape=[block_len, n_heads, head_dim],
                             dtype=kv_dtype)
            pv = layers.data(name=f"kv_v_{i}",
                             shape=[block_len, n_heads, head_dim],
                             dtype=kv_dtype)
            self.pools.append((pk, pv))
        self.updated = []
        self._cursor = 0

    def next_pools(self):
        pair = self.pools[self._cursor]
        self._cursor += 1
        return pair

    def record_update(self, pk_out, pv_out):
        self.updated.append((pk_out, pv_out))

    @property
    def feed_names(self):
        names = ["kv_index", "kv_pages"]
        if self.length is not None:
            names.append("kv_len")
        for pk, pv in self.pools:
            names.extend((pk.name, pv.name))
        return names

    @property
    def updated_vars(self):
        return [v for pair in self.updated for v in pair]


def transformer_lm_decode_logits(tokens, cache, vocab, max_len, n_layers=2,
                                 d_model=64, n_heads=4, d_ff=256):
    """One decode iteration of the slot batch: ``tokens`` [S] (each slot's
    current token, at position ``cache.index[s]``) -> next-token logits
    [S, vocab], appending this position's K/V to the paged cache.  The
    layer calls are `transformer_lm_logits`'s, so parameter names match
    a saved full model."""
    emb = layers.embedding(input=tokens, size=[vocab, d_model])   # [S, d]
    x = layers.scale(emb, scale=math.sqrt(d_model))
    x = _positional_encoding(x, max_len, d_model, index=cache.index)
    x = layers.reshape(x, shape=[0, 1, d_model])                  # [S,1,d]
    x = layers.amp_cast(x)
    for _ in range(n_layers):
        x = transformer_decoder_layer(x, d_model, n_heads, d_ff, 0.0,
                                      cache=cache)
    logits = layers.fc(input=x, size=vocab, num_flatten_dims=2)   # [S,1,V]
    return layers.reshape(logits, shape=[0, vocab])


def transformer_lm_prefill_logits(tokens, cache, vocab, max_len,
                                  n_layers=2, d_model=64, n_heads=4,
                                  d_ff=256):
    """Bucket-padded prompt prefill: ``tokens`` [B, T_bucket] -> the
    next-token logits [B, vocab] (position ``kv_len - 1``), writing the
    prompt's K/V (masked by ``kv_len``) into the paged cache.  The
    positional table is sliced to the fed T, so one program serves every
    bucket."""
    from ..layer_helper import LayerHelper
    emb = layers.embedding(input=tokens, size=[vocab, d_model])
    x = layers.scale(emb, scale=math.sqrt(d_model))
    x = _positional_encoding(x, max_len, d_model, dynamic=True)
    x = layers.amp_cast(x)
    for _ in range(n_layers):
        x = transformer_decoder_layer(x, d_model, n_heads, d_ff, 0.0,
                                      cache=cache)
    logits = layers.fc(input=x, size=vocab, num_flatten_dims=2)  # [B,T,V]
    helper = LayerHelper("batched_select", input=logits)
    out = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="batched_select",
                     inputs={"X": [logits], "Index": [cache.length]},
                     outputs={"Out": [out]}, attrs={"offset": -1})
    out.desc.shape = (-1, vocab)
    return out


def build_generation_programs(spec, block_len=16, exact=False,
                              kv_dtype="float32"):
    """The (prefill, decode) Program pair of a generation spec, each
    built in a fresh Program under a fresh name generator so parameter
    names match a model saved by `save_generation_model`.  Returns a dict
    per mode: {"program", "feed_names", "fetch_vars", "cache"}; the
    fetches are the logits and every written pool.  ``exact=True`` sets
    ``exact_lowering`` (the row-stable kernels) and builds the decode
    attention as the full-span f32 flash forward, bitwise the full-prefix
    recompute."""
    from .. import unique_name
    from ..core.program import Program, program_guard
    if spec.get("family", "transformer_lm") != "transformer_lm":
        raise ValueError(f"unsupported generation family "
                         f"{spec.get('family')!r}")
    head_dim = spec["d_model"] // spec["n_heads"]
    out = {}
    for mode in ("prefill", "decode"):
        main = Program()
        with program_guard(main, Program()), unique_name.guard():
            tokens = layers.data(
                name="tokens",
                shape=[1] if mode == "decode" else [spec["max_len"]],
                dtype="int64")
            cache = KVCache(spec["n_layers"], spec["n_heads"], head_dim,
                            block_len, mode=mode, exact=exact,
                            kv_dtype=kv_dtype)
            build = (transformer_lm_decode_logits if mode == "decode"
                     else transformer_lm_prefill_logits)
            logits = build(tokens, cache, spec["vocab"], spec["max_len"],
                           spec["n_layers"], spec["d_model"],
                           spec["n_heads"], spec["d_ff"])
        main.exact_lowering = bool(exact)
        out[mode] = {"program": main,
                     "feed_names": ["tokens"] + cache.feed_names,
                     "fetch_vars": [logits] + cache.updated_vars,
                     "cache": cache}
    return out


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

