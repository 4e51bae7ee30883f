"""Faults planted in the program under a run, each one a serving cell can
have: a token altered where it is sampled; a step that leaves the KV pools
as they were (its state unchanged); half of the slots handed the other
half's tokens (half the batch left out). ``plant(name, setattr)`` replaces
the engine module's function before the engine is built, so the captured
step holds the fault; pass pytest's ``monkeypatch.setattr`` to have it
undone. One card: there is no exchange between chips to leave out."""
from __future__ import annotations


def _token_altered(eng_mod, setattr):
    import torch

    real = eng_mod.sample

    def sample(logits, generator, cfg):
        tok = real(logits, generator, cfg)
        first = torch.arange(tok.shape[0], device=tok.device) == 0
        return torch.where(first, (tok + 1) % logits.shape[-1],
                           tok).to(tok.dtype)
    setattr(eng_mod, "sample", sample)


def _state_unchanged(eng_mod, setattr):
    real = eng_mod._finish_step

    def finish(cfg, sched_cfg, sample_cfg, kv_aware, final_norm, lm_head,
               state, *a, **kw):
        k, v = state["k"].clone(), state["v"].clone()
        out = real(cfg, sched_cfg, sample_cfg, kv_aware, final_norm,
                   lm_head, state, *a, **kw)
        state["k"].copy_(k)
        state["v"].copy_(v)
        return out
    setattr(eng_mod, "_finish_step", finish)


def _half_the_batch(eng_mod, setattr):
    import torch

    real = eng_mod._step_impl

    def step(*a, **kw):
        toks, logits, stats = real(*a, **kw)
        half = toks.shape[0] // 2
        toks = torch.cat([toks[:half], toks[:toks.shape[0] - half]])
        return toks, logits, stats
    setattr(eng_mod, "_step_impl", step)


FAULTS = {"token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_the_batch": _half_the_batch}


def plant(name: str, setattr=setattr) -> None:
    from repro_torch.serving import engine as eng_mod

    FAULTS[name](eng_mod, setattr)
