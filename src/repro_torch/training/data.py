"""Deterministic synthetic data pipeline.

Stateless in the step index: ``batch(step)`` is a pure function of
(seed, step), which is what makes checkpoint/restart and elastic re-sharding
exact — a restored run consumes the identical stream with no cursor files.

The token stream has learnable structure (a noisy affine-recurrence language)
so smoke-training shows a decreasing loss: token_{t+1} = (a*token_t + b) mod V
with probability 1-noise, else uniform.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticConfig", "SyntheticData"]


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab: int
    seq_len: int
    batch_size: int
    family: str = "dense"        # matches ModelConfig.family
    d_frontend: int = 0
    n_patches: int = 0
    noise: float = 0.1
    seed: int = 0


class SyntheticData:
    def __init__(self, cfg: SyntheticConfig):
        self.cfg = cfg
        self.a = 3
        self.b = 7

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab
        if cfg.family == "encoder":
            frames = rng.standard_normal((B, S, cfg.d_frontend), dtype=np.float32)
            # frame labels = a quantization of the first frontend channel
            labels = ((frames[..., 0] - frames[..., 0].min()) * 7).astype(np.int64)
            return {"frames": frames, "labels": (labels % V).astype(np.int32)}
        start = rng.integers(0, V, size=(B, 1))
        toks = np.zeros((B, S), dtype=np.int64)
        toks[:, :1] = start
        for t in range(1, S):
            nxt = (self.a * toks[:, t - 1] + self.b) % V
            flip = rng.random(B) < cfg.noise
            toks[:, t] = np.where(flip, rng.integers(0, V, size=B), nxt)
        batch = {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.d_frontend), dtype=np.float32
            )
        return batch

    @classmethod
    def for_model(cls, mcfg, batch_size: int, seq_len: int, seed: int = 0):
        s_text = seq_len - (mcfg.n_patches if mcfg.family == "vlm" else 0)
        return cls(
            SyntheticConfig(
                vocab=mcfg.vocab,
                seq_len=s_text,
                batch_size=batch_size,
                family=mcfg.family,
                d_frontend=mcfg.d_frontend,
                n_patches=mcfg.n_patches,
                seed=seed,
            )
        )
