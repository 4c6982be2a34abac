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
allocating; ``Model.input_specs`` gives ``meta`` stand-ins of its inputs.

**On a mesh.**  ``build_model(cfg, mesh=mesh)`` (a ``DeviceMesh`` with
``repro``'s axis names) turns on ``repro``'s activation constraints inside
``loss``, ``forward``, ``prefill`` and ``decode_step``: ``shard_heads`` at
the head splits and after the GQA expand, the residual constrainer around
each period (``models/transformer.py``), each a ``redistribute`` of a
``DTensor``.  The weights and the batch are placed by the caller
(``repro_torch.distributed.sharding``).  The plain tensors a step makes
inside the model (positions, masks, the aux-loss zeros) act as replicated:
``sharding_context`` enters ``implicit_replication()`` at those entry points
whenever a mesh is set or the weights are ``DTensor``s, rather than making
each one a ``DTensor`` where it is created.  Without a mesh and with plain
weights every constraint is the identity, bit for bit.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.models.layers import (
    DTYPES,
    Norm,
    decoding,
    dense_init_,
    is_dtensor,
    linear,
    new_param,
    norm_apply,
    pad_seq,
    use_sharding_mesh,
)
from repro_torch.models.transformer import Block, apply_stack, init_cache, layer_specs

__all__ = ["Model", "build_model"]


def _next_token(x, labels, head, chunk: int):
    """``(x[:, :-1], labels[:, 1:])``, the loss's next-token pairs.  Where
    a mesh splits x's sequence on a dim where ``head`` keeps its vocab
    whole and one chunk takes the whole sequence, x keeps its positions
    and its split and the labels end on -1 instead: XLA keeps ``repro``'s
    slice split there, padded to divide the mesh, so each device's logits
    cover its share of the positions; ``DTensor``'s slice of a split dim
    would gather it, and every device would compute every position's
    logits (a 1xM mesh, whose data axis of 1 leaves the head's vocab
    whole over "model" at d_model >= 512)."""
    if (is_dtensor(x) and is_dtensor(head) and chunk >= x.shape[1] - 1
            and any(p.is_shard(1) and not q.is_shard(head.ndim - 1)
                    for p, q in zip(x.placements, head.placements))):
        return x, torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1)
    return x[:, :-1], labels[:, 1:]


class Frontend(nn.Module):
    """The stubbed modality frontend's learned projector."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.proj = new_param((cfg.d_frontend, cfg.d_model), dtype, device)

    def reset_parameters(self, generator):
        dense_init_(self.proj, generator)


_IMPLICIT = contextvars.ContextVar("repro_torch_implicit_replication", default=False)


def _label_log_prob(logits, labels):
    """log_softmax(logits)[label] (a label < 0 reads class 0).  On a
    ``DTensor`` whose vocabulary is sharded the log-sum-exp is taken with
    reductions and the label picked by a one-hot product, so the vocabulary
    stays sharded forward and backward, as XLA partitions ``repro``'s loss
    (``log_softmax`` and ``gather`` over a sharded dim would replicate it
    first, and the LM head's gradient with it)."""
    idx = labels.clamp(min=0).long()
    if not is_dtensor(logits):
        return torch.log_softmax(logits, -1).gather(-1, idx[..., None])[..., 0]
    m = logits.detach().amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True))
    classes = torch.arange(logits.shape[-1], device=idx.device)
    return ((logits - lse) * (idx[..., None] == classes)).sum(-1)


def _in_sharding_context(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with self.sharding_context():
            return fn(self, *args, **kwargs)

    return wrapped


class Model(nn.Module):
    """The weights of one configuration and the functions that serve it.
    Attribute paths are ``repro``'s leaf names with one ``layers.{i}`` per
    layer in model order (``models/convert.py`` carries a tree across)."""

    def __init__(self, cfg: ModelConfig, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
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

    @contextlib.contextmanager
    def sharding_context(self):
        """``use_sharding_mesh(self.mesh)``, with ``implicit_replication()``
        when a mesh is set or the weights are ``DTensor``s; a step's
        backward (and the remat recompute inside it) runs in it too."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(use_sharding_mesh(self.mesh))
            if (self.mesh is not None or is_dtensor(self.lm_head)) and not _IMPLICIT.get():
                from torch.distributed.tensor.experimental import implicit_replication

                # not re-entrant (its exit turns it off): entered once
                stack.enter_context(implicit_replication())
                stack.callback(_IMPLICIT.reset, _IMPLICIT.set(True))
            yield

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, batch):
        cfg = self.cfg
        dtype = DTYPES[cfg.act_dtype]
        if cfg.family == "encoder":
            frames = torch.as_tensor(batch["frames"], device=self.device)
            return linear(frames.to(dtype), self.frontend.proj), 0
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        tok = F.embedding(tokens, self.embed.to(dtype))
        if cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device)
            patches = linear(patches.to(dtype), self.frontend.proj)
            return torch.cat([patches, tok], dim=1), cfg.n_patches
        return tok, 0

    # ------------------------------------------------------------ logits/loss
    def _logits(self, x):
        cfg = self.cfg
        logits = linear(x, self.lm_head).float()
        if cfg.padded_vocab != cfg.vocab:   # phantom vocab entries
            valid = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
            logits = torch.where(valid, logits, -1e30)
        return logits

    def _positions(self, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)

    @_in_sharding_context
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
            x, labels = _next_token(x, labels, self.lm_head, cfg.logits_chunk)

        St = x.shape[1]
        chunk = min(cfg.logits_chunk, St)
        n_chunks = -(-St // chunk)
        pad = n_chunks * chunk - St
        if pad:
            x = pad_seq(x, pad)
            labels = pad_seq(labels, pad, value=-1)
        tot = x.new_zeros((), dtype=torch.float32)   # a DTensor on a mesh
        cnt = x.new_zeros((), dtype=torch.int32)
        for c in range(n_chunks):
            lc = labels[:, c * chunk:(c + 1) * chunk]
            ll = _label_log_prob(self._logits(x[:, c * chunk:(c + 1) * chunk]), lc)
            valid = lc >= 0
            tot = tot + torch.where(valid, -ll, 0.0).sum()
            cnt = cnt + valid.sum(dtype=torch.int32)
        ce = tot / cnt.clamp(min=1).float()
        loss = ce + 0.01 * aux["lb"] + 1e-3 * aux["z"]
        return loss, {"ce": ce, "lb_loss": aux["lb"], "z_loss": aux["z"],
                      "tokens": cnt}

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    @_in_sharding_context
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
        """Zero caches, one dict a layer.  On a mesh each leaf is made
        already placed by ``cache_shardings``: a rank allocates only its
        shard, never the global cache."""
        if self.mesh is None:
            return init_cache(self.cfg, B, T, self.device)
        from repro_torch.distributed.sharding import zero_caches

        return zero_caches(self.cfg, B, T, self.mesh, self.device)

    @torch.no_grad()
    @_in_sharding_context
    def prefill(self, batch, T: int):
        """Process the prompt; returns (caches, last-position logits).  On a
        mesh the caches are placed by ``cache_shardings``."""
        cfg = self.cfg
        x, _ = self._embed_inputs(batch)
        caches = self.init_cache(x.shape[0], T)
        x, _ = apply_stack(self.layers, x, cfg, self._positions(x.shape[1]),
                           "prefill", caches)
        x = norm_apply(self.final_norm, x, cfg.norm)
        return caches, self._logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    @_in_sharding_context
    def decode_step(self, caches, token, pos: int):
        """One decode step: token (B,1) int32 at position ``pos``.  Returns
        (caches, logits (B, padded_vocab)); the caches are updated in place."""
        cfg = self.cfg
        pos = int(pos)
        token = torch.as_tensor(token, device=self.device)
        x = F.embedding(token, self.embed.to(DTYPES[cfg.act_dtype]))
        positions = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        with decoding():
            x, _ = apply_stack(self.layers, x, cfg, positions, "decode", caches, pos=pos)
            x = norm_apply(self.final_norm, x, cfg.norm)
            return caches, self._logits(x)[:, 0]

    # ---------------------------------------------------------- input specs
    def input_specs(self, batch_size: int, seq_len: int, mode: str = "train") -> dict:
        """``meta`` stand-ins of ``repro``'s input shapes and dtypes (the
        dry run's inputs; nothing is allocated).  ``decode`` gives the
        port's per-layer caches of ``seq_len`` and the token."""
        cfg = self.cfg
        act = DTYPES[cfg.act_dtype]

        def meta(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if mode in ("train", "forward", "prefill"):
            want_labels = mode != "prefill"
            if cfg.family == "encoder":
                out = {"frames": meta(batch_size, seq_len, cfg.d_frontend, dtype=act)}
                if want_labels:
                    out["labels"] = meta(batch_size, seq_len)
                return out
            s_text = seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len
            out = {"tokens": meta(batch_size, s_text)}
            if cfg.family == "vlm":
                out["patches"] = meta(batch_size, cfg.n_patches, cfg.d_frontend, dtype=act)
            if want_labels:
                out["labels"] = meta(batch_size, s_text)
            return out
        if mode == "decode":
            return {"caches": init_cache(cfg, batch_size, seq_len, "meta"),
                    "token": meta(batch_size, 1)}
        raise ValueError(mode)


def build_model(cfg: ModelConfig, device=None, *,
                generator: torch.Generator | None = None, mesh=None) -> Model:
    """The model of ``cfg`` on ``device`` (``None`` means ``"cuda"``, and
    raises without a card), initialised from ``generator`` (on that device;
    ``None`` means one seeded with 0).  ``device="meta"`` allocates nothing
    and leaves the weights uninitialised.  ``mesh`` turns on the activation
    constraints (the weights stay where they are: the caller places them)."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "meta":
        dev = resolve_backend(None, dev)
    model = Model(cfg, dev, mesh=mesh)
    if dev.type != "meta":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.reset_parameters(generator)
    return model
