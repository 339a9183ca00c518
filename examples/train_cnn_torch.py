"""End-to-end run of the PyTorch port: train a CNN built from one of the
paper's primitives on the synthetic image pipeline (AdamW, cosine
schedule, async checkpoints, resume, a NaN guard), then re-estimate its BN
statistics, post-training-quantize it to the integer-only plan and compare
float and int8 accuracy: the paper's deployment flow. The port's twin of
``examples/train_cnn.py``; it imports no JAX.

Run (on a card; ``--device cpu`` runs the plain versions on the host):

    PYTHONPATH=src python examples/train_cnn_torch.py --primitive shift --steps 300
    PYTHONPATH=src python examples/train_cnn_torch.py --primitive add --steps 150 --device cpu
"""
import argparse
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, IndexedDataset, PrefetchLoader
from repro_torch.device import exact_float32, resolve_device
from repro_torch.models import (CNNConfig, calibrate_bn, cnn_forward,
                                cnn_value_and_grad, init_cnn, quantize_cnn)
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--primitive", default="standard",
                    choices=["standard", "grouped", "dws", "shift", "add"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "train_cnn_torch_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = CNNConfig(primitive=args.primitive, widths=(16, 32, 64))
    dcfg = DataConfig(kind="image", global_batch=args.batch, image_size=32,
                      num_classes=10, seed=7)
    ds = IndexedDataset(dcfg)
    opt = OptConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps,
                    weight_decay=1e-4, grad_clip=1.0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    params = init_cnn(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    state = init_opt_state(params, opt)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        tree, start = ckpt.restore({"params": params, "opt": state})
        params, state = tree["params"], tree["opt"]
        print(f"resumed from step {start}")

    loader = PrefetchLoader(ds, start_step=start, device=dev)
    t0 = time.perf_counter()
    skipped = 0
    for i in range(start, args.steps):
        with exact_float32():
            (loss, acc), grads = cnn_value_and_grad(params, next(loader), cfg)
            new_params, new_state, _ = apply_updates(params, grads, state,
                                                     opt)
        if not bool(torch.isfinite(loss)):
            skipped += 1                      # NaN guard: reject the step
        else:
            params, state = new_params, new_state
        if (i + 1) % 50 == 0:
            ckpt.save(i + 1, {"params": params, "opt": state})
            print(f"step {i + 1:4d} loss {float(loss):.4f} "
                  f"acc {float(acc):.3f} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)
    ckpt.wait()

    # ---- evaluation: float vs integer-only (the paper's PTQ flow) --------
    test = ds.batch(10_000)
    calib = torch.as_tensor(ds.batch(20_000)["images"], dtype=torch.float32,
                            device=dev)
    x = torch.as_tensor(test["images"], dtype=torch.float32, device=dev)
    labels = torch.as_tensor(test["labels"], device=dev).long()
    params = calibrate_bn(params, cfg, calib)   # deployment BN re-estimation
    with exact_float32():
        logits_f = cnn_forward(params, x, cfg)
    acc_f = float((logits_f.argmax(-1) == labels).float().mean())
    int_fwd = quantize_cnn(params, cfg, calib, method="cuda", device=dev)
    logits_q = int_fwd(x)
    acc_q = float((logits_q.argmax(-1) == labels).float().mean())
    print(f"\nprimitive={args.primitive}  float acc={acc_f:.3f}  "
          f"int8-pow2 acc={acc_q:.3f}  drop={acc_f - acc_q:+.3f}  "
          f"nan_skipped={skipped}")


if __name__ == "__main__":
    main()
