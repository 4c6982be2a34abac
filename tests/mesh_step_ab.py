"""The warm train step of qwen3-4b at full size in bf16 (chip_smoke.py
phase 17's setting: batch 2, sequence 256, remat on), plain and with its
state placed on a (1, 1) mesh of an NCCL group of one, for the tree given:
compare two trees in turns in one call on the card (no JAX).

    python tests/mesh_step_ab.py PARENT_TREE; python tests/mesh_step_ab.py .
    python tests/mesh_step_ab.py .; python tests/mesh_step_ab.py PARENT_TREE

Prints one line a run: each kind's warm median (the first step is cold)
and the mesh step over the plain one.
"""
import os
import statistics
import sys
import time

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, tree)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402  (puts the tree's src first on the path)
import repro_torch  # noqa: E402

assert repro_torch.__file__.startswith(tree), repro_torch.__file__
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch.distributed.sharding import place_state, state_shardings  # noqa: E402

STEPS = 5


def main():
    dev = torch.device("cuda", 0)
    cfg = c.get_config("qwen3-4b")
    opt = c.AdamWConfig(peak_lr=c.TRAIN_FULL_LR, warmup_steps=1, total_steps=8)
    data = c.SyntheticData.for_model(cfg, c.TRAIN_FULL["batch_size"], c.TRAIN_FULL["seq_len"],
                                     seed=0)
    model = c.build_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(0))
    state = c.init_train_state(model)
    step = c.make_train_step(model, opt)
    plain = []
    for i in range(STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t) * 1e3)
    del state, step, model
    torch.cuda.empty_cache()
    c.nccl_group(dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        model = c.build_model(cfg, dev, generator=torch.Generator(device=dev).manual_seed(0))
        state = c.init_train_state(model)
        place_state(state, state_shardings(state, mesh))
        meshed = [r[0] for r in c.mesh_steps(state, opt, data, 0, STEPS, timed=True)]
    finally:
        torch.distributed.destroy_process_group()
    p, q = statistics.median(plain[1:]), statistics.median(meshed[1:])
    print(f"{sys.argv[1] if len(sys.argv) > 1 else '.'}: plain warm median {p:.3f} ms "
          f"{[round(x, 1) for x in plain]}; mesh warm median {q:.3f} ms "
          f"{[round(x, 1) for x in meshed]}; x{q / p:.3f}; {c.card_line()}", flush=True)


if __name__ == "__main__":
    main()
