"""Serving: batched prefill and greedy decode (``DecodeEngine``)."""
from repro_torch.serving.engine import DecodeEngine, GenResult

__all__ = ["DecodeEngine", "GenResult"]
