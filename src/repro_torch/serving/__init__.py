"""Serving: batched prefill and greedy decode (``DecodeEngine``), and the
online serve/train interleave (``OnlineLearner``)."""
from repro_torch.serving.engine import DecodeEngine, GenResult
from repro_torch.serving.online import OnlineLearner, OnlineResult

__all__ = ["DecodeEngine", "GenResult", "OnlineLearner", "OnlineResult"]
