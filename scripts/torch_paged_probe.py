#!/usr/bin/env python3
"""Measure what a paged prefix hit's exactness and the paged decode step's
time rest on, on one NVIDIA card, at Qwen2-0.5B's full width (seeded
random weights, made as ``chip_smoke.py``'s phase 6 makes them).

    python3 scripts/torch_paged_probe.py       (from the repository root)

1. Row bits by bucket: six prompts that share a 16-token prefix, each
   prefilled (float, batch 1, the engine's prefill) at its own bucket: 32
   and 128 twice each (other suffixes), 64 and 256 once. Printed: the max
   |diff| of the prefix rows' K and V (all layers) between every pair.
2. Mixed-bucket prefix traffic, shaped as ``chip_smoke.py``'s
   (``LM_MIXED_SHARED`` shared tokens, suffixes in buckets 64 and 128):
   served paged with the prefix cache, its page digests salted by the
   prefill bucket (the card's rule, ``serve.engine.prefix_salt``) and
   unsalted, against the contiguous engine on the same prompts. Printed:
   the hit rate, the share of equal tokens and whether the streams are
   equal.
3. The captured float decode step, contiguous and paged, 8 slots at
   position 128 (``chip_smoke.py``'s breakdown), measured in turns for
   six rounds, the order swapped every round: CUDA-event ms (as the
   breakdown times it), the SM clock that nvidia-smi reads right after,
   and the profiler's device busy ms and operations.

Every line carries the card's name and power limit. It needs a card and
is not on any path of the port.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: section 1: the shared prefix and each prompt's (bucket, length)
PREFIX = 16
PROMPTS = ((32, 24), (32, 30), (64, 40), (128, 90), (128, 100), (256, 200))
#: section 3: rounds and the position of every slot
ROUNDS, POS = 6, 128


def sm_clock() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.check.config import paged_num_blocks
    from repro_torch.configs import get_config
    from repro_torch.graph.capture import capture
    from repro_torch.models import api
    from repro_torch.serve import Engine, Request, ServeConfig
    card = cs.card_line()
    dev = "cuda"
    cfg = get_config(cs.LM_ARCH)
    params = api.init_params(cfg, torch.Generator(device=dev)
                             .manual_seed(cs.SEED), device=dev)

    def engine(**kw):
        return Engine(cfg, params, ServeConfig(
            max_batch=cs.LM_BATCH, max_len=cs.LM_MAX_LEN, **kw))

    # 1. the prefix rows' bits under each bucket
    rng = np.random.default_rng([cs.SEED, 7])
    eng = engine()
    prefix = rng.integers(0, cfg.vocab, (PREFIX,))
    rows = []
    for bucket, n in PROMPTS:
        toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        toks[0, :PREFIX] = torch.from_numpy(prefix)
        toks[0, PREFIX:n] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (n - PREFIX,)))
        _, cache = eng.prefill(eng.params, {
            "tokens": toks, "prompt_lens": torch.tensor(
                [n], dtype=torch.int32, device=dev)})
        rows.append({k: cache[k][:, :, :PREFIX].float() for k in ("k", "v")})
    names = [f"{b}/{n}" for b, n in PROMPTS]
    print(f"[probe] prefix rows' K/V (float, {PREFIX}-token prefix), max "
          f"|diff| by (bucket/prompt length) pair; {card}")
    for i in range(len(rows)):
        for j in range(i + 1, len(rows)):
            d = max((rows[i][k] - rows[j][k]).abs().max().item()
                    for k in ("k", "v"))
            print(f"[probe]   {names[i]} vs {names[j]}: {d}")

    # 2. mixed-bucket prefix traffic, salted and unsalted
    shared = rng.integers(0, cfg.vocab, (cs.LM_MIXED_SHARED,))
    mixed = [np.concatenate([shared, rng.integers(0, cfg.vocab, (int(
        rng.integers(lo, hi + 1)),))]).astype(np.int32)
        for lo, hi in cs.LM_MIXED_SUFFIX * (cs.LM_REQUESTS // 2)]

    def serve(eng):
        for i, p in enumerate(mixed):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=cs.LM_NEW))
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        assert {r.status for r in done} == {"ok"}
        return [r.out_tokens for r in done], eng.stats

    ref, _ = serve(engine())
    for salted in (True, False):
        eng = engine(kv_layout="paged", kv_block_size=cs.LM_BLOCK)
        eng.salt_prefix = salted
        got, st = serve(eng)
        print(f"[probe] mixed-bucket prefix traffic ({len(mixed)} requests, "
              f"{cs.LM_MIXED_SHARED} shared tokens), paged, digests "
              f"{'salted' if salted else 'unsalted'}: prefix_hit_rate "
              f"{st['prefix_hit_rate']:.4f}, {cs.agreement(got, ref):.4f} "
              f"of tokens equal to the contiguous engine's, streams equal "
              f"{got == ref}; {card}")

    # 3. the captured decode step, contiguous and paged, in turns; each
    # graph reads its engine's cast weights, cache and token by address,
    # so all of them are kept alive
    steps, alive = {}, []
    for layout in ("contiguous", "paged"):
        eng = engine(kv_layout=layout, kv_block_size=cs.LM_BLOCK)
        if layout == "paged":
            s, bs = eng.scfg, cs.LM_BLOCK
            cache = api.init_paged_cache(cfg, cs.LM_BATCH,
                                         paged_num_blocks(s), bs,
                                         cs.LM_MAX_LEN, device=dev)
            n = POS // bs + 1
            ids = 1 + torch.arange(cs.LM_BATCH * n, device=dev) \
                .reshape(n, -1).t()
            cache["block_table"][:, :n] = ids
        else:
            cache = api.init_slot_cache(cfg, cs.LM_BATCH, cs.LM_MAX_LEN,
                                        device=dev)
        cache["len"].fill_(POS)
        tok = torch.zeros((cs.LM_BATCH, 1), dtype=torch.long, device=dev)
        cap, _ = capture(
            lambda t, e=eng, c=cache: e.decode(e.params, t, c)[0], (tok,),
            key=f"probe.{layout}")
        steps[layout] = cap.replay
        alive.append((eng, cache, tok, cap))
    order = ["contiguous", "paged"]
    for r in range(ROUNDS):
        for layout in order:
            ms = cs.time_ms(torch, steps[layout], reps=5, trials=3)
            clock = sm_clock()
            kernels = cs.device_kernels(torch, steps[layout], 5)
            busy = sum(k.us for k in kernels) / 1e3
            ops = sum(k.launches for k in kernels)
            print(f"[probe] decode step round {r} {layout:10s}: "
                  f"{ms:.4f} ms (CUDA events), SM clock {clock} after, "
                  f"device busy {busy:.4f} ms in {ops:.0f} operations, "
                  f"idle {1 - busy / ms:.3f}; {card}")
        order.reverse()
    return 0


if __name__ == "__main__":
    sys.exit(main())
