#!/usr/bin/env python3
"""Measure whether a prompt's prefill rows get the same bits under every
prefill bucket on one NVIDIA card, through ``models/api.prefill_fn`` and
through the row-blocked ``api.shared_prefill_fn`` (the prefill of a paged
engine with the prefix cache), and what the blocking costs, at
Qwen2-0.5B's full width (seeded random weights, made as
``chip_smoke.py``'s phase 6 makes them, cast once as the engine casts
them).

    python3 scripts/torch_prefill_rows_probe.py        (from the repo root)

"rows=None" below is ``prefill_fn``; "rows=64" and "rows=128" are
``shared_prefill_fn`` with ``transformer.PREFILL_ROWS`` set to that
(128 is the port's).

1. Row bits by bucket, for rows None, 64 and 128: six prompts that share
   a 16-token prefix, each prefilled (float, batch 1) at its own bucket:
   32 and 128 twice each (other suffixes), 64 and 256 once. Printed: the
   max |diff| of the prefix rows' K and V (all layers) over every pair of
   prompts, and the pairs that are not 0.
2. One prompt of 48 tokens (``chip_smoke.py``'s mixed-bucket prefix)
   prefilled alone at buckets 64, 128 and 256, and inside longer prompts
   at 128 and 256: the max |diff| of its 48 rows' K/V and of the first
   token's logits where the prompt is the same.
3. The captured prefill at each bucket of 16-2048 (phase 6's engine
   allows 256; the larger ones show how the blocks scale), rows None and
   128 in turns, three rounds with the order swapped every round: CUDA
   event ms of one replay.

Every line carries the card's name and power limit. It needs a card and is
not on any path of the port.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PREFIX = 16
PROMPTS = ((32, 24), (32, 30), (64, 40), (128, 90), (128, 100), (256, 200))
BLOCKS = (None, 64, 128)
SHARED = 48
TIMED_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
MAX_LEN = TIMED_BUCKETS[-1]
ROUNDS = 3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.graph.capture import capture
    from repro_torch.models import api
    from repro_torch.models import transformer as T
    card = cs.card_line()
    dev = "cuda"
    cfg = get_config(cs.LM_ARCH)
    params = T.cast_params(api.init_params(
        cfg, torch.Generator(device=dev).manual_seed(cs.SEED), device=dev),
        cfg)
    rng = np.random.default_rng([cs.SEED, 7])

    rows_used = T.PREFILL_ROWS

    def make(rb):
        if rb is None:
            return api.prefill_fn(cfg, MAX_LEN)
        T.PREFILL_ROWS = rb         # read by each shared_prefill call
        return api.shared_prefill_fn(cfg, MAX_LEN)

    def prefill(toks, n, bucket, rb):
        t = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        t[0, :n] = torch.from_numpy(np.asarray(toks[:n])).to(dev)
        return make(rb)(params, {
            "tokens": t, "prompt_lens": torch.tensor(
                [n], dtype=torch.int32, device=dev)})

    def kv_diff(a, b, n):
        return max((a[k][:, :, :n].float() - b[k][:, :, :n].float())
                   .abs().max().item() for k in ("k", "v"))

    # 1. the prefix rows' bits under each bucket
    prefix = rng.integers(0, cfg.vocab, (PREFIX,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, (
        n - PREFIX,))]) for _, n in PROMPTS]
    names = [f"{b}/{n}" for b, n in PROMPTS]
    for rb in BLOCKS:
        caches = [prefill(p, n, b, rb)[1]
                  for p, (b, n) in zip(prompts, PROMPTS)]
        diffs = {(names[i], names[j]): kv_diff(caches[i], caches[j], PREFIX)
                 for i in range(len(caches))
                 for j in range(i + 1, len(caches))}
        bad = {k: v for k, v in diffs.items() if v}
        print(f"[rows] rows={rb}: prefix rows' K/V ({PREFIX}-token "
              f"prefix, float, bucket/length pairs) max |diff| "
              f"{max(diffs.values())}, {len(bad)} of {len(diffs)} pairs "
              f"not 0: {bad}; {card}")

    # 2. the mixed-bucket prefix alone and inside longer prompts
    shared = rng.integers(0, cfg.vocab, (SHARED,))
    longer = np.concatenate([shared, rng.integers(0, cfg.vocab, (100,))])
    for rb in BLOCKS:
        alone = {b: prefill(shared, SHARED, b, rb) for b in (64, 128, 256)}
        inside = {b: prefill(longer, n, b, rb)[1]
                  for b, n in ((128, 100), (256, 148))}
        d_alone = max(kv_diff(alone[64][1], alone[b][1], SHARED)
                      for b in (128, 256))
        d_logits = max((alone[64][0] - alone[b][0]).abs().max().item()
                       for b in (128, 256))
        d_inside = max(kv_diff(alone[64][1], c, SHARED)
                       for c in inside.values())
        print(f"[rows] rows={rb}: a {SHARED}-token prompt at bucket 64 "
              f"against 128 / 256: K/V {d_alone}, first-token logits "
              f"{d_logits}; its rows inside prompts of 100 (bucket 128) and "
              f"148 (256): K/V {d_inside}; {card}")

    # 3. the captured prefill's time by bucket, unblocked and blocked
    T.PREFILL_ROWS = rows_used
    graphs = {}
    for b in TIMED_BUCKETS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, b))).to(dev)
        plen = torch.tensor([b // 2 + 1], dtype=torch.int32, device=dev)
        for rb in (None, 128):
            fn = make(rb)
            # the graph reads its inputs by address: both stay alive in it
            graphs[b, rb], _ = capture(
                lambda t, pl, f=fn: f(params, {"tokens": t,
                                               "prompt_lens": pl})[0],
                (toks, plen), key=f"probe.rows.{b}.{rb}")
    order = [None, 128]
    for r in range(ROUNDS):
        for b in TIMED_BUCKETS:
            ms = {rb: cs.time_ms(torch, graphs[b, rb].replay, reps=10,
                                 trials=3) for rb in order}
            print(f"[rows] round {r} bucket {b}: captured prefill "
                  f"rows=None {ms[None]:.4f} ms, rows=128 "
                  f"{ms[128]:.4f} ms (CUDA events, batch 1); {card}")
        order.reverse()
    return 0


if __name__ == "__main__":
    sys.exit(main())
