"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It sits beside the JAX package and imports nothing of it.  Module names
mirror the JAX package's, so each counterpart is found by name.  The
slice ported so far is the serving path of the transformer LM:
`serving.decode_engine.DecodeEngine` over a paged KV cache, with the
paged-attention, FlashAttention-2 forward and LayerNorm forward kernels
written in CUDA (``ops/csrc``).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
