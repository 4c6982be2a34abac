"""Batched LM serving driver: prefill a batch of prompts, decode greedily
(the port of ``repro.launch.serve_lm``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen3-4b \
        --reduced --batch 4 --prompt-len 16 --gen 24 --device cpu

``--device`` defaults to ``cuda``; a full configuration runs on the card.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.dispatch import resolve_backend
from repro_torch.models import build_model
from repro_torch.training.data import SyntheticData

__all__ = ["generate", "serve_batch", "main"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, prompts: dict, *, prompt_len: int, gen: int) -> dict:
    """Prefill ``prompts`` and decode ``gen`` tokens greedily with a built
    model.  Positions follow ``repro``'s driver: the cache holds
    ``prompt_len + gen`` slots (plus ``n_patches`` for a VLM) and decode
    step t sits at ``prompt_len + n_patches + t``.  Returns the generated
    tokens (B, gen) and the prefill and decode times, each ending in a
    device synchronisation."""
    cfg = model.cfg
    off = cfg.n_patches if cfg.family == "vlm" else 0
    T = prompt_len + gen + off
    dev = model.device

    _sync(dev)
    t0 = time.perf_counter()
    caches, logits = model.prefill(prompts, T)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        caches, logits = model.decode_step(caches, tok, prompt_len + off + t)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    batch = out[0].shape[0]
    return {
        "generated": torch.cat(out, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_tok_s": (gen - 1) * batch / max(t_decode, 1e-9),
    }


def serve_batch(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
                device=None) -> dict:
    """Build ``cfg``'s model on ``device`` (``None`` means ``"cuda"``) from a
    generator seeded with ``seed``, draw ``batch`` prompts from
    ``SyntheticData`` and ``generate``."""
    dev = resolve_backend(None, device)
    model = build_model(cfg, dev,
                        generator=torch.Generator(device=dev).manual_seed(seed))
    data = SyntheticData.for_model(cfg, batch, prompt_len, seed=seed).batch(0)
    prompts = {"tokens": data["tokens"]}
    if cfg.family == "vlm":
        prompts["patches"] = data["patches"]
    return generate(model, prompts, prompt_len=prompt_len, gen=gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, device=args.device)
    print(f"[serve] batch={args.batch} prefill={out['prefill_s']*1e3:.1f}ms "
          f"decode={out['decode_tok_s']:.1f} tok/s (first call included)")
    print(f"[serve] sample generation: {out['generated'][0][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
