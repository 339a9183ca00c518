#!/usr/bin/env python3
"""How often a torch.profiler session records no device activity on the
card, and whether freeing a large allocation or a CUDA graph first changes
that.

    python3 scripts/torch_profiler_probe.py          (on a machine with a card)

Each session times 20 launches of one small matmul; a session that sees
fewer than 20 of them lost records. Printed per stretch: the sessions lost,
their indices and seconds into the stretch: 3,000 sessions in a row, then
300 each with 64 GB allocated, after freeing it (``empty_cache``), after a
CUDA graph's capture and replays, and after freeing the graph.
"""
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


def sessions(a, tag, n):
    lost = []
    t0 = time.perf_counter()
    for i in range(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
        got = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
        if got < 20:
            lost.append((i, got, round(time.perf_counter() - t0, 2)))
    print(f"{tag}: {len(lost)} of {n} sessions lost records in "
          f"{time.perf_counter() - t0:.1f} s; (index, launches seen, s): "
          f"{lost[:16]}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    a = torch.randn(256, 256, device="cuda")
    sessions(a, "in a row", 3000)
    big = [torch.randn(1 << 30, device="cuda", dtype=torch.bfloat16)
           for _ in range(30)]                          # 64 GB
    torch.cuda.synchronize()
    sessions(a, "with 64 GB allocated", 300)
    del big
    torch.cuda.empty_cache()
    sessions(a, "after freeing 64 GB and empty_cache", 300)
    x = torch.randn(8, 4096, device="cuda")
    w = torch.randn(4096, 4096, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            x @ w
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x @ w
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    sessions(a, "after a CUDA graph's capture and replays", 300)
    del graph
    torch.cuda.empty_cache()
    sessions(a, "after freeing the graph", 300)


if __name__ == "__main__":
    main()
