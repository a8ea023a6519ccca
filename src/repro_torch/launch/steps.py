"""Step functions of the LM serving path (counterpart of
repro/launch/steps.py's ``make_prefill_step`` and ``make_serve_step``).

The port's model holds its parameters, so the steps take no ``params``.
``make_train_step`` and ``make_aa_step`` belong to the training slice.
"""
from __future__ import annotations


def make_prefill_step(model, cache_len: int):
    def prefill_step(tokens, embeds=None):
        return model.prefill(tokens, embeds, cache_len=cache_len)

    return prefill_step


def make_serve_step(model):
    def serve_step(caches, tokens, pos):
        return model.decode_step(caches, tokens, pos)

    return serve_step
