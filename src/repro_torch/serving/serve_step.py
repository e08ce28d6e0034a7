"""Serving steps: prefill + decode with sampling, built on the model API's
KV cache — the counterpart of ``repro.serving.serve_step``.
``make_serve_fns`` returns the callables shared by the RAG pipeline and
the continuous batcher.  Tokens stay on the model's device; sampling
draws from a ``torch.Generator`` (its bits differ from ``jax.random``'s:
the distribution is the same, the draws are not)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def params_device(params) -> torch.device:
    """The device the model's parameters live on."""
    return params["final_norm"].device


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [b, 1, v] -> tokens [b, 1] int32: greedy (first maximum) at
    ``temperature <= 0``, else a draw from ``softmax(logits / T)``
    restricted to the ``top_k`` largest when ``top_k > 0``."""
    lg = logits[:, -1, :].float()
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
    lg = lg / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def make_serve_fns(model, temperature: float = 0.0, top_k: int = 0):
    """Returns (prefill_fn, decode_fn):
    prefill_fn(params, tokens, cache, extra=None) -> (next_token, cache),
    ``extra`` handed to ``model.prefill`` (VLM patches, whisper's frames)
    decode_fn(params, token, cache, pos, generator) -> (next_token, logits,
    cache).  Both write ``cache`` in place."""

    def prefill_fn(params, tokens, cache, extra=None):
        logits, cache = model.prefill(params, tokens, cache, extra)
        nxt = torch.argmax(logits[:, -1, :].float(), dim=-1)
        return nxt[:, None].to(torch.int32), cache

    def decode_fn(params, token, cache, pos, generator=None):
        logits, cache = model.decode_step(params, token, cache, pos)
        nxt = sample_logits(logits, generator, temperature, top_k)
        return nxt, logits, cache

    return prefill_fn, decode_fn


def generate(model, params, prompt_tokens, max_new: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0, extra=None) -> torch.Tensor:
    """Greedy / temperature generation loop: ``[b, max_new]`` int32 tokens
    on the parameters' device.  ``extra`` goes to the prefill (whisper's
    frames ``[b, n_frames, d_model]``, or VLM patches).  With VLM patches
    the decode positions continue after the patch and prompt positions
    the prefill filled (the reference restarts them at the prompt
    length)."""
    dev = params_device(params)
    prompt = torch.as_tensor(np.asarray(prompt_tokens) if not isinstance(
        prompt_tokens, torch.Tensor) else prompt_tokens, device=dev)
    b, s = prompt.shape
    if extra is not None and model.cfg.n_patches:
        s += extra.shape[1]
    max_len = max_len or (s + max_new)
    if s + max_new - 1 > max_len:
        raise ValueError(f"{s} prompt positions and {max_new} new tokens do "
                         f"not fit a cache of {max_len}")
    cache = model.init_cache(b, max_len, device=dev)
    prefill_fn, decode_fn = make_serve_fns(model, temperature)
    tok, cache = prefill_fn(params, prompt, cache, extra)
    out = [tok]
    pos = torch.full((b,), s, dtype=torch.long, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    for _ in range(max_new - 1):
        tok, _, cache = decode_fn(params, tok, cache, pos, gen)
        out.append(tok)
        pos += 1
    return torch.cat(out, dim=1)
