"""Layers, attention and the decoder of the port: dense, MoE, SSM, hybrid
and encoder-decoder families, each with ``forward``, ``prefill`` and
``decode_step``."""

from repro_torch.models.transformer import DecodeState, TransformerLM

__all__ = ["TransformerLM", "DecodeState"]
