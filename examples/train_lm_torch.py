"""LM pretraining with the PyTorch port: any --arch from the registry at
any --scale, with the fault-tolerant Trainer (async checkpoints, resume,
NaN guard, straggler monitor) on the deterministic synthetic token
pipeline. The port's twin of ``examples/train_lm.py``; it imports no JAX.

Run (on a card; ``--device cpu`` runs the plain versions on the host):

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-0.5b \\
        --scale 100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --arch falcon-mamba-7b \\
        --scale tiny --steps 20 --device cpu
"""
import argparse
import dataclasses
from pathlib import Path

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, IndexedDataset
from repro_torch.models import api
from repro_torch.optim import OptConfig
from repro_torch.train import LoopConfig, TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]

SCALES = {
    # (n_layers, d_model, n_heads, n_kv, d_ff, vocab, seq)
    "tiny": (2, 64, 4, 2, 128, 512, 64),
    "10m": (4, 256, 8, 4, 1024, 4096, 256),
    "100m": (12, 768, 12, 4, 3072, 16384, 512),
}


def scaled_cfg(arch: str, scale: str):
    cfg = get_config(arch)
    L, d, h, kv, ff, v, seq = SCALES[scale]
    kw = dict(n_layers=L, d_model=d, n_heads=h, n_kv_heads=kv, d_ff=ff,
              vocab=v)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8,
                                        top_k=min(cfg.moe.top_k, 2),
                                        d_ff=ff // 4)
    if cfg.family == "hybrid":
        kw.update(n_layers=max(L, 8) // 8 * 8, attn_period=8, attn_offset=4)
    if cfg.family == "encdec":
        kw["n_encoder_layers"] = L
    if cfg.family == "vlm":
        kw["frontend_positions"] = 8
    return dataclasses.replace(cfg, **kw), seq


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=str(ROOT / "build" / "train_lm_torch_ckpt"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg, seq = scaled_cfg(args.arch, args.scale)
    n = cfg.param_count()
    print(f"arch={args.arch} scale={args.scale}: {n/1e6:.1f}M params, "
          f"seq={seq}, batch={args.batch}, device={args.device}")

    kind = {"vlm": "vlm", "encdec": "encdec"}.get(cfg.family, "lm")
    dcfg = DataConfig(kind=kind, vocab=cfg.vocab, seq_len=seq,
                      global_batch=args.batch, seed=11, d_model=cfg.d_model,
                      frontend_positions=cfg.frontend_positions)
    ds = IndexedDataset(dcfg)
    tcfg = TrainConfig(
        opt=OptConfig(lr=3e-4, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps),
        remat="full", attn_impl="full", microbatches=args.microbatches)
    loop = LoopConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 3, 1),
                      ckpt_dir=args.ckpt_dir, log_every=10)
    tr = Trainer(cfg, tcfg, loop, ds,
                 init_params_fn=lambda gen: api.init_params(
                     cfg, gen, device=gen.device),
                 device=args.device)
    tr.install_preemption_handler()
    _, _, step, hist = tr.run()
    first = [h["loss"] for h in hist[:5]]
    last = [h["loss"] for h in hist[-5:]]
    print(f"\ndone at step {step}: loss {sum(first)/len(first):.3f} -> "
          f"{sum(last)/len(last):.3f}; stragglers={tr.monitor.stragglers} "
          f"skipped={tr.skipped}")


if __name__ == "__main__":
    main()
