"""Wall time of ``chip_smoke.py``'s CNN phases (3, the check phase where
the checkout has it, 4, 5, 8, 9 and the check of their configs) of one
checkout, on the card. Run it over two checkouts in turns in one call to
compare them on one card (parent, change, change, parent)::

    python3 scripts/torch_phase_pair.py build/parent
    python3 scripts/torch_phase_pair.py .

Each checkout builds its own kernel library (``build/repro_torch`` under
it) before its phases are timed; the last line, ``[pair] ...``, gives
each phase's seconds and their sum."""
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else ".").resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    card = cs.card_line()
    info = _build.build()
    _build.library()
    print(f"[pair] {root.name}: build "
          f"{'built' if info['built'] else 'up to date'} "
          f"{info['seconds']:.1f} s on {card}")
    rng = np.random.default_rng(cs.SEED)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    times = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = time.perf_counter() - t0
        return out

    clock("3", lambda: cs.phase_kernels(torch, K, dev, kind, rng))
    resolved = {}
    if hasattr(cs, "phase_check"):
        built = clock("check", lambda: cs.phase_check(torch, K, card, rng))
        with cs.recording_configs(resolved):
            plans = clock("4", lambda: {
                n: cs.phase_plan(torch, K, n, built[n]) for n in cs.PLANS})
            _serve_tune_flow(cs, torch, K, card, rng, plans, clock)
        clock("check configs",
              lambda: cs.phase_check_configs(torch, card, resolved))
    else:               # a checkout from before the check phase
        plans = clock("4", lambda: {n: cs.phase_plan(torch, K, n, rng)
                                    for n in cs.PLANS})
        _serve_tune_flow(cs, torch, K, card, rng, plans, clock)
    print(f"[pair] {root.name}: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
          + f"; phases {sum(times.values()):.1f} s; process "
          f"{time.perf_counter() - t_start:.1f} s")
    return 0


def _serve_tune_flow(cs, torch, K, card, rng, plans, clock):
    """Phases 5, 8 and 9, as ``chip_smoke.main`` runs them."""
    clock("5", lambda: [cs.phase_serve(torch, K, p, plans[p][0], card, rng)
                        for p in cs.SERVED])
    clock("8", lambda: cs.phase_tune(torch, K, card,
                                     {n: plans[n] for n in cs.TUNED_PLANS}))
    clock("9", lambda: cs.phase_cnn_flow(torch, K, card))


if __name__ == "__main__":
    sys.exit(main())
