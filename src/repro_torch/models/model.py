"""Top-level model API: forward / loss / prefill / decode_step (the port of
``repro.models.model``).

Batch conventions (token and label arrays int32; numpy arrays or tensors):
  LM (dense/moe/rwkv/hybrid): {"tokens": (B,S), "labels": (B,S)}
  VLM:     {"tokens": (B,S_text), "labels": (B,S_text),
            "patches": (B, n_patches, d_frontend)}
  encoder: {"frames": (B,S,d_frontend), "labels": (B,S)}

Labels < 0 are ignored in the loss.  The loss computes logits in sequence
chunks of ``cfg.logits_chunk``, so the (B,S,V) tensor never materialises.

``build_model(cfg, device="meta")`` builds any full configuration without
allocating: the meta-device counterpart of ``repro``'s ``input_specs``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.models.layers import DTYPES, Norm, dense_init_, new_param, norm_apply
from repro_torch.models.transformer import Block, apply_stack, init_cache, layer_specs

__all__ = ["Model", "build_model"]


class Frontend(nn.Module):
    """The stubbed modality frontend's learned projector."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.proj = new_param((cfg.d_frontend, cfg.d_model), dtype, device)

    def reset_parameters(self, generator):
        dense_init_(self.proj, generator)


class Model(nn.Module):
    """The weights of one configuration and the functions that serve it.
    Attribute paths are ``repro``'s leaf names with one ``layers.{i}`` per
    layer in model order (``models/convert.py`` carries a tree across)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        dtype = DTYPES[cfg.param_dtype]
        d, Vp = cfg.d_model, cfg.padded_vocab
        if cfg.family != "encoder":
            self.embed = new_param((Vp, d), dtype, device)
        if cfg.frontend:
            self.frontend = Frontend(cfg, dtype, device)
        self.layers = nn.ModuleList(Block(cfg, spec, device) for spec in layer_specs(cfg))
        self.final_norm = Norm(d, cfg.norm, dtype, device)
        self.lm_head = new_param((d, Vp), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        """The port's own init from ``generator`` (on the model's device):
        ``repro``'s distributions, not its random stream."""
        if self.cfg.family != "encoder":
            dense_init_(self.embed, generator, scale=0.02)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        dense_init_(self.lm_head, generator)

    @property
    def device(self) -> torch.device:
        return self.lm_head.device

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, batch):
        cfg = self.cfg
        dtype = DTYPES[cfg.act_dtype]
        if cfg.family == "encoder":
            frames = torch.as_tensor(batch["frames"], device=self.device)
            return frames.to(dtype) @ self.frontend.proj.to(dtype), 0
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        tok = F.embedding(tokens, self.embed.to(dtype))
        if cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device)
            patches = patches.to(dtype) @ self.frontend.proj.to(dtype)
            return torch.cat([patches, tok], dim=1), cfg.n_patches
        return tok, 0

    # ------------------------------------------------------------ logits/loss
    def _logits(self, x):
        cfg = self.cfg
        logits = (x @ self.lm_head.to(x.dtype)).float()
        if cfg.padded_vocab != cfg.vocab:   # phantom vocab entries
            valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
            logits = torch.where(valid, logits, -1e30)
        return logits

    def _positions(self, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)

    def loss(self, batch):
        """Mean next-token (or frame-label) CE + aux losses. Returns (loss, metrics)."""
        cfg = self.cfg
        x, n_prefix = self._embed_inputs(batch)
        x, aux = apply_stack(self.layers, x, cfg, self._positions(x.shape[1]), "train")
        x = norm_apply(self.final_norm, x, cfg.norm)
        if n_prefix:
            x = x[:, n_prefix:]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if cfg.family != "encoder":            # next-token shift
            x, labels = x[:, :-1], labels[:, 1:]

        St = x.shape[1]
        chunk = min(cfg.logits_chunk, St)
        n_chunks = -(-St // chunk)
        pad = n_chunks * chunk - St
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int32, device=x.device)
        for c in range(n_chunks):
            lc = labels[:, c * chunk:(c + 1) * chunk]
            lp = torch.log_softmax(self._logits(x[:, c * chunk:(c + 1) * chunk]), -1)
            ll = lp.gather(-1, lc.clamp(min=0).long()[..., None])[..., 0]
            valid = lc >= 0
            tot = tot + torch.where(valid, -ll, 0.0).sum()
            cnt = cnt + valid.sum(dtype=torch.int32)
        ce = tot / cnt.clamp(min=1).float()
        loss = ce + 0.01 * aux["lb"] + 1e-3 * aux["z"]
        return loss, {"ce": ce, "lb_loss": aux["lb"], "z_loss": aux["z"],
                      "tokens": cnt}

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, batch):
        """Full-sequence logits (B, S_text, padded_vocab), float32."""
        cfg = self.cfg
        x, n_prefix = self._embed_inputs(batch)
        x, _ = apply_stack(self.layers, x, cfg, self._positions(x.shape[1]), "forward")
        x = norm_apply(self.final_norm, x, cfg.norm)
        if n_prefix:
            x = x[:, n_prefix:]
        return self._logits(x)

    # ------------------------------------------------------------- serving
    def init_cache(self, B: int, T: int) -> list[dict]:
        return init_cache(self.cfg, B, T, self.device)

    @torch.no_grad()
    def prefill(self, batch, T: int):
        """Process the prompt; returns (caches, last-position logits)."""
        cfg = self.cfg
        x, _ = self._embed_inputs(batch)
        caches = self.init_cache(x.shape[0], T)
        x, _ = apply_stack(self.layers, x, cfg, self._positions(x.shape[1]),
                           "prefill", caches)
        x = norm_apply(self.final_norm, x, cfg.norm)
        return caches, self._logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    def decode_step(self, caches, token, pos: int):
        """One decode step: token (B,1) int32 at position ``pos``.  Returns
        (caches, logits (B, padded_vocab)); the caches are updated in place."""
        cfg = self.cfg
        pos = int(pos)
        token = torch.as_tensor(token, device=self.device)
        x = F.embedding(token, self.embed.to(DTYPES[cfg.act_dtype]))
        positions = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        x, _ = apply_stack(self.layers, x, cfg, positions, "decode", caches, pos=pos)
        x = norm_apply(self.final_norm, x, cfg.norm)
        return caches, self._logits(x)[:, 0]


def build_model(cfg: ModelConfig, device=None, *,
                generator: torch.Generator | None = None) -> Model:
    """The model of ``cfg`` on ``device`` (``None`` means ``"cuda"``, and
    raises without a card), initialised from ``generator`` (on that device;
    ``None`` means one seeded with 0).  ``device="meta"`` allocates nothing
    and leaves the weights uninitialised."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "meta":
        dev = resolve_backend(None, dev)
    model = Model(cfg, dev)
    if dev.type != "meta":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.reset_parameters(generator)
    return model
