"""Whether two checkouts of the port compute the same bits on the host:
the single-device train step (two steps, microbatches 1 and 2: losses,
grad norms, every param after them), a prefill and three greedy decode
steps, for every family at a reduced size, in float32 and bfloat16
compute. Each checkout runs in a subprocess of its own::

    python scripts/torch_bitwise_pair.py build/parent      # against .
    python scripts/torch_bitwise_pair.py build/a build/b

prints how many outputs each gave and the names of those that differ
(none: exit 0). A few minutes on the CPU; nothing needs a card."""
import os
import subprocess
import sys
import tempfile

#: every family's config, cut to a size the host trains in seconds
CONFIGS = {
    "granite-34b": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=1,
                        d_ff=64, vocab=128),
    "qwen2-0.5b": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                       d_ff=64, vocab=128),
    "internvl2-1b": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                         d_ff=64, vocab=128, frontend_positions=4),
    "granite-moe-1b-a400m": dict(n_layers=2, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab=128),
    "falcon-mamba-7b": dict(n_layers=2, d_model=32, vocab=64),
    "jamba-v0.1-52b": dict(n_layers=8, attn_period=8, attn_offset=4,
                           d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                           vocab=128),
    "seamless-m4t-large-v2": dict(n_layers=2, n_encoder_layers=2,
                                  d_model=32, n_heads=4, n_kv_heads=2,
                                  d_ff=64, vocab=128),
}


def dump(out: str):
    """Every output of this process's ``repro_torch`` into ``out`` (npz)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.tree import paths
    res = {}
    for arch, kw in CONFIGS.items():
        for cdt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(get_config(arch), **kw,
                                      compute_dtype=cdt)
            tag = f"{arch}/{cdt}"
            params = api.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
            gen = torch.Generator().manual_seed(1)
            s = 17 - (cfg.frontend_positions if cfg.family == "vlm" else 0)
            batch = {"tokens": torch.randint(0, cfg.vocab, (4, s),
                                             generator=gen)}
            if cfg.family == "vlm":
                batch["embeds"] = torch.randn(4, cfg.frontend_positions,
                                              cfg.d_model, generator=gen)
            if cfg.family == "encdec":
                batch["frames"] = torch.randn(4, 8, cfg.d_model,
                                              generator=gen)
            for mb in (1, 2):
                tcfg = TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=0),
                                   microbatches=mb)
                p = copy.deepcopy(params)
                opt = init_opt_state(p, tcfg.opt)
                step = make_train_step(cfg, tcfg)
                for i in range(2):
                    p, opt, m = step(p, opt, batch)
                    res[f"{tag}/{mb}/loss{i}"] = m["loss"].numpy()
                    res[f"{tag}/{mb}/grad_norm{i}"] = m["grad_norm"].numpy()
                for k, v in paths(p):
                    res[f"{tag}/{mb}/params/{k}"] = v.detach().float().numpy()
            with torch.no_grad():
                pre = {k: v[:, :8] if k == "tokens" else v
                       for k, v in batch.items()}
                logits, cache = api.prefill_fn(cfg, 24)(params, pre)
                res[f"{tag}/prefill"] = logits.float().numpy()
                tok = logits[:, -1:].argmax(-1)
                for i in range(3):
                    logits, cache = api.decode_fn(cfg)(params, tok, cache)
                    res[f"{tag}/decode{i}"] = logits.float().numpy()
                    tok = logits[:, -1:].argmax(-1)
    np.savez(out, **res)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--dump":
        dump(argv[1])
        return 0
    if len(argv) not in (1, 2):
        print(__doc__)
        return 2
    import numpy as np
    roots = [os.path.abspath(r) for r in (argv if len(argv) == 2
                                          else [argv[0], "."])]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"{i}.npz") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dump", out],
            env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))
            for root, out in zip(roots, outs)]
        if any(p.wait() for p in procs):
            print("[bitwise] a checkout's dump failed")
            return 1
        a, b = (dict(np.load(o)) for o in outs)
    differ = sorted(k for k in a if k not in b
                    or not np.array_equal(a[k], b[k], equal_nan=True))
    print(f"[bitwise] {roots[0]}: {len(a)} outputs, {roots[1]}: {len(b)}; "
          f"differ: {differ or 'none'}")
    return 1 if differ or set(a) != set(b) else 0


if __name__ == "__main__":
    sys.exit(main())
