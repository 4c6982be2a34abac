"""End-to-end driver on the port: train a ~100M-parameter LM on the
synthetic pipeline (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/port_train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples/port_train_lm.py --preset 10m --steps 300 --device cpu

Uses the same launcher/optimizer/checkpoint path as the production configs
(``repro_torch.launch.train``); --resume continues from the last checkpoint
after any interruption.  ``--device`` defaults to the card.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402

PRESETS = {
    # ~104M params: emb 2*32768*512=34M + 16L*(4*512^2 + 3*512*2048)=67M
    "100m": dict(n_layers=16, d_model=512, n_heads=8, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=32768),
    # ~10M params: quick CPU demonstration
    "10m": dict(n_layers=6, d_model=192, n_heads=6, n_kv_heads=2,
                head_dim=32, d_ff=768, vocab=8192),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="10m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_config("qwen3-4b"),     # dense GQA family
        name=f"qwen3-example-{args.preset}",
        qk_norm=True,
        param_dtype="float32",
        act_dtype="float32",
        vocab_pad_to=256,
        logits_chunk=256,
        attn_q_chunk=256,
        **PRESETS[args.preset],
    )
    total, _ = cfg.params_estimate()
    print(f"[train_lm] {cfg.name}: ~{total/1e6:.0f}M params")
    out = train_loop(
        cfg, steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 1),
        resume=args.resume, log_every=10, device=args.device,
    )
    print(f"[train_lm] loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"in {out['steps']} steps ({out['wall_s']:.0f}s)")
    return out


if __name__ == "__main__":
    main()
