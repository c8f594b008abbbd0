"""v2 input-type specs (reference: python/paddle/v2/data_type.py).

Each spec records dimensionality, dtype and sequence-ness; sequence specs
lower to lod_level=1 data vars (padded batch + length vector).  Counterpart
of ``paddle_tpu/v2/data_type.py``.
"""
from __future__ import annotations

__all__ = [
    "InputType", "DataType", "SequenceType",
    "dense_vector", "dense_vector_sequence", "dense_array",
    "integer_value", "integer_value_sequence",
    "sparse_binary_vector", "sparse_binary_vector_sequence",
    "sparse_float_vector", "sparse_float_vector_sequence",
]


class DataType(object):
    Dense = 0
    SparseNonValue = 1
    SparseValue = 2
    Index = 3


class SequenceType(object):
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class InputType(object):
    """dim, seq_type, type — mirrors the reference triple; ``dtype`` is the
    array dtype the spec lowers to."""

    def __init__(self, dim, seq_type, tp):
        self.dim = dim
        self.seq_type = seq_type
        self.type = tp

    @property
    def dtype(self):
        return "int64" if self.type == DataType.Index else "float32"

    def __repr__(self):
        return (f"InputType(dim={self.dim}, seq={self.seq_type}, "
                f"type={self.type})")


def dense_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def dense_vector_sequence(dim):
    return dense_vector(dim, SequenceType.SEQUENCE)


def dense_array(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.Dense)


def integer_value(value_range, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(value_range, seq_type, DataType.Index)


def integer_value_sequence(value_range):
    return integer_value(value_range, SequenceType.SEQUENCE)


def sparse_binary_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseNonValue)


def sparse_binary_vector_sequence(dim):
    return sparse_binary_vector(dim, SequenceType.SEQUENCE)


def sparse_float_vector(dim, seq_type=SequenceType.NO_SEQUENCE):
    return InputType(dim, seq_type, DataType.SparseValue)


def sparse_float_vector_sequence(dim):
    return sparse_float_vector(dim, SequenceType.SEQUENCE)
