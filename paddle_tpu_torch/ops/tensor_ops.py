"""Tensor creation and manipulation op rules (counterpart of
``paddle_tpu/ops/tensor_ops.py``): constants and casts, concat / split /
stack, shape changes, gather and scatter, ``one_hot``, padding,
``lod_reset``, and the random rules.

Dtypes: a declared dtype is kept as declared (``int64`` stays int64: the
port runs with 64-bit integers, where the JAX package canonicalizes them
to int32); an integer a rule chooses follows the JAX rule (``shape`` and
``sampling_id`` give int32).  Indices widen to int64 only at a gather or
scatter.  Every tensor a rule creates is made on the executor's device."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..core.types import to_torch_dtype


def _dtype(ctx, key="dtype", default="float32") -> torch.dtype:
    return to_torch_dtype(ctx.attr(key, default))


def _batch_size_like_shape(ctx):
    """The ``shape`` attribute with dim ``output_dim_idx`` taken from
    dim ``input_dim_idx`` of the Input tensor."""
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = ctx.input("Input").shape[
        ctx.attr("input_dim_idx", 0)]
    return tuple(shape)


@register_op("fill_constant")
def _fill_constant(ctx):
    ctx.set_output("Out", torch.full(tuple(ctx.attr("shape", [1])),
                                     ctx.attr("value", 0.0),
                                     dtype=_dtype(ctx), device=ctx.device))


@register_op("fill_constant_batch_size_like",
             doc="shape[output_dim_idx] taken from a runtime tensor")
def _fill_cbsl(ctx):
    ctx.set_output("Out", torch.full(_batch_size_like_shape(ctx),
                                     ctx.attr("value", 0.0),
                                     dtype=_dtype(ctx), device=ctx.device))


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx):
    ctx.set_output("Out", torch.zeros_like(ctx.input("X")))


@register_op("assign")
def _assign(ctx):
    ctx.set_output("Out", ctx.input("X"))
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))


@register_op("assign_value")
def _assign_value(ctx):
    vals = torch.tensor(ctx.attr("values"), dtype=_dtype(ctx))
    ctx.set_output("Out", vals.reshape(ctx.attr("shape")).to(ctx.device))


@register_op("cast")
def _cast(ctx):
    ctx.set_output("Out", ctx.input("X").to(_dtype(ctx, "out_dtype")))
    ctx.set_seq_len("Out", ctx.seq_len_of("X"))


@register_op("concat")
def _concat(ctx):
    xs = ctx.inputs("X")
    axis = ctx.attr("axis", 0)
    ctx.set_output("Out", torch.cat(xs, dim=axis))
    # a feature-axis concat of ragged inputs keeps the time structure:
    # carry the @SEQ_LEN companion (sequence_concat owns the time axis)
    if axis != 1 or (xs and xs[0].dim() > 2):
        ctx.set_seq_len("Out", ctx.seq_len_of("X"))


@register_op("split")
def _split(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections")
    if sections:
        parts = torch.split(x, list(sections), dim=axis)
    else:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        parts = torch.split(x, x.shape[axis] // num, dim=axis)
    for i, part in enumerate(parts):
        ctx.set_output("Out", part, i)


@register_op("reshape")
def _reshape(ctx):
    x = ctx.input("X")
    # Fluid semantics: 0 keeps the input's dim, -1 is inferred
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr("shape"))]
    ctx.set_output("Out", x.reshape(shape))


@register_op("squeeze")
def _squeeze(ctx):
    x = ctx.input("X")
    axes = ctx.attr("axes", [])
    if not axes:
        ctx.set_output("Out", torch.squeeze(x))
        return
    if any(x.shape[a] != 1 for a in axes):
        raise ValueError(f"squeeze: axes {list(axes)} of shape "
                         f"{tuple(x.shape)} are not all of size 1")
    ctx.set_output("Out", torch.squeeze(x, dim=tuple(axes)))


@register_op("unsqueeze")
def _unsqueeze(ctx):
    x = ctx.input("X")
    for a in sorted(ctx.attr("axes")):
        x = torch.unsqueeze(x, a)
    ctx.set_output("Out", x)


@register_op("transpose")
def _transpose(ctx):
    ctx.set_output("Out", ctx.input("X").permute(*ctx.attr("axis")))


@register_op("expand", doc="expand_op.cc: tile by expand_times")
def _expand(ctx):
    ctx.set_output("Out", torch.tile(ctx.input("X"),
                                     tuple(ctx.attr("expand_times"))))


@register_op("stack")
def _stack(ctx):
    ctx.set_output("Y", torch.stack(ctx.inputs("X"), dim=ctx.attr("axis", 0)))


@register_op("slice")
def _slice(ctx):
    x = ctx.input("Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(ctx.attr("axes"), ctx.attr("starts"),
                       ctx.attr("ends")):
        idx[a] = slice(s, e)
    ctx.set_output("Out", x[tuple(idx)])


def wrap_indices(idx: torch.Tensor, n: int):
    """``jnp.take``'s index rule over a dim of size ``n``: an index in
    [-n, 0) wraps; -> (int64 indices clamped into [0, n), mask of those
    that were outside [-n, n)).  The clamp keeps every index that reaches
    an indexing kernel in range: on the card an index out of range is a
    device assert, which ends the CUDA context."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    oob = (idx < 0) | (idx >= n)
    return idx.clamp(0, max(n - 1, 0)), oob


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``idx`` (1-D) with ``jnp.take``'s fill mode: an
    index outside [-n, n) gives the fill row (NaN for a float tensor, the
    dtype's minimum for a signed integer one, True for bool)."""
    safe, oob = wrap_indices(idx, x.shape[0])
    rows = torch.index_select(x, 0, safe)
    if x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(x.dtype).min
    return rows.masked_fill(oob.reshape((-1,) + (1,) * (x.dim() - 1)), fill)


@register_op("gather", doc="gather_op.cc: rows of X by Index")
def _gather(ctx):
    x, index = ctx.input("X"), ctx.input("Index")
    idx = index[:, 0] if index.dim() == 2 and index.shape[1] == 1 else index
    ctx.set_output("Out", take_rows(x, idx))
    lens = ctx.seq_len_of("X")
    if lens is not None:
        # an axis-0 gather over a padded sequence batch keeps each row's
        # length (sub_nested_seq_layer selects sub-sequences)
        ctx.set_seq_len("Out", take_rows(lens, idx))


@register_op("scatter", doc="scatter_op.cc: write Updates rows into X")
def _scatter(ctx):
    """``x.at[ids].set`` (or ``.add`` with ``overwrite`` off): an id in
    [-n, 0) wraps, an update at any other id outside [0, n) is dropped,
    as in JAX's scatter."""
    x, ids, upd = ctx.input("X"), ctx.input("Ids"), ctx.input("Updates")
    safe, oob = wrap_indices(ids, x.shape[0])
    keep = ~oob
    safe, upd = safe[keep], upd[keep]
    if ctx.attr("overwrite", True):
        out = x.index_put((safe,), upd.to(x.dtype))
    else:
        out = x.index_add(0, safe, upd.to(x.dtype))
    ctx.set_output("Out", out)


@register_op("one_hot")
def _one_hot(ctx):
    """f32 one-hot rows; an id outside [0, depth) gives a row of zeros
    (``jax.nn.one_hot``)."""
    x = ctx.input("X")
    flat = x[..., 0] if x.dim() and x.shape[-1] == 1 else x
    classes = torch.arange(ctx.attr("depth"), device=ctx.device)
    ctx.set_output("Out", (flat.long()[..., None] == classes).float())


@register_op("shape")
def _shape(ctx):
    ctx.set_output("Out", torch.tensor(tuple(ctx.input("Input").shape),
                                       dtype=torch.int32, device=ctx.device))


@register_op("increment")
def _increment(ctx):
    x = ctx.input("X")
    ctx.set_output("Out", x + torch.tensor(ctx.attr("step", 1.0),
                                           dtype=x.dtype, device=ctx.device))


@register_op("pad", doc="pad_op.cc")
def _pad(ctx):
    x = ctx.input("X")
    p = ctx.attr("paddings")  # flat [before0, after0, before1, ...]
    # F.pad takes the pairs last dim first
    spec = [v for i in reversed(range(x.dim())) for v in (p[2 * i],
                                                         p[2 * i + 1])]
    ctx.set_output("Out", F.pad(x, spec, value=ctx.attr("pad_value", 0.0)))


@register_op("pad_constant_like")
def _pad_constant_like(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    spec = [v for sx, sy in reversed(list(zip(x.shape, y.shape)))
            for v in (0, sx - sy)]
    ctx.set_output("Out", F.pad(y, spec, value=ctx.attr("pad_value", 0.0)))


@register_op("reverse")
def _reverse(ctx):
    ctx.set_output("Out", torch.flip(ctx.input("X"),
                                     tuple(ctx.attr("axis"))))


@register_op("is_empty")
def _is_empty(ctx):
    ctx.set_output("Out", torch.tensor(ctx.input("X").numel() == 0,
                                       device=ctx.device))


@register_op("where_select", doc="elementwise cond ? X : Y")
def _where_select(ctx):
    cond = ctx.input("Cond")
    ctx.set_output("Out", torch.where(cond.bool(), ctx.input("X"),
                                      ctx.input("Y")))


# ---------------------------------------------------------------------------
# random rules: the executor's torch.Generator, not JAX's threefry bits
# ---------------------------------------------------------------------------

def _generator(ctx) -> torch.Generator:
    """A nonzero ``seed`` attribute pins the op's own stream (the JAX
    rule's ``PRNGKey(seed)``); 0 draws from the executor's generator."""
    seed = ctx.attr("seed", 0)
    if not seed:
        return ctx.next_rng()
    g = torch.Generator(device=ctx.device)
    g.manual_seed(int(seed))
    return g


def _uniform(shape, lo, hi, dtype, g, device):
    u = torch.rand(shape, generator=g, dtype=dtype, device=device)
    return u * (hi - lo) + lo


@register_op("uniform_random", draws_rng=True)
def _uniform_random(ctx):
    ctx.set_output("Out", _uniform(tuple(ctx.attr("shape")),
                                   ctx.attr("min", -1.0),
                                   ctx.attr("max", 1.0), _dtype(ctx),
                                   _generator(ctx), ctx.device))


@register_op("uniform_random_batch_size_like", draws_rng=True)
def _uniform_random_bsl(ctx):
    ctx.set_output("Out", _uniform(_batch_size_like_shape(ctx),
                                   ctx.attr("min", -1.0),
                                   ctx.attr("max", 1.0), _dtype(ctx),
                                   ctx.next_rng(), ctx.device))


def _normal(ctx, shape, g):
    n = torch.randn(shape, generator=g, dtype=_dtype(ctx), device=ctx.device)
    return ctx.attr("mean", 0.0) + ctx.attr("std", 1.0) * n


@register_op("gaussian_random", draws_rng=True)
def _gaussian_random(ctx):
    ctx.set_output("Out", _normal(ctx, tuple(ctx.attr("shape")),
                                  _generator(ctx)))


@register_op("gaussian_random_batch_size_like", draws_rng=True)
def _gaussian_random_bsl(ctx):
    ctx.set_output("Out", _normal(ctx, _batch_size_like_shape(ctx),
                                  ctx.next_rng()))


#: the standard normal's CDF at -2 and 2: the truncation bounds
_PHI_LO, _PHI_HI = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                    for b in (-2.0, 2.0))


@register_op("truncated_gaussian_random", draws_rng=True)
def _truncated_gaussian_random(ctx):
    """mean + std * N(0, 1) truncated to [-2, 2], by the inverse CDF of a
    uniform draw between the bounds' CDF values (as
    ``jax.random.truncated_normal``)."""
    u = _uniform(tuple(ctx.attr("shape")), _PHI_LO, _PHI_HI, torch.float32,
                 ctx.next_rng(), ctx.device)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
    ctx.set_output("Out", (ctx.attr("mean", 0.0) + ctx.attr("std", 1.0)
                           * z).to(_dtype(ctx)))


@register_op("sampling_id", draws_rng=True)
def _sampling_id(ctx):
    """One id a row of probabilities X [batch, n], int32: the Gumbel-max
    draw over log(max(x, 1e-20)) that ``jax.random.categorical`` makes."""
    x = ctx.input("X")
    logits = torch.log(torch.clamp(x.float(), min=1e-20))
    u = torch.rand(logits.shape, generator=ctx.next_rng(),
                   device=ctx.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    ctx.set_output("Out", torch.argmax(logits + gumbel, dim=-1
                                       ).to(torch.int32))


@register_op("lod_reset", doc="lod_reset_op.cc: replace the sequence-length "
             "companion")
def _lod_reset(ctx):
    ctx.set_output("Out", ctx.input("X"))
    y = ctx.input("Y")
    if y is not None:
        ctx.set_seq_len("Out", y)
