"""repro_torch.roofline — a step's work counted as it runs, against the
card's peaks (the counterpart of ``repro/roofline``)."""
from .count import (KERNELS, Count, Work, counting, kernel_call, kernel_of,
                    kernel_work, report, step_report, tree_bytes)

__all__ = ["KERNELS", "Count", "Work", "counting", "kernel_call",
           "kernel_of", "kernel_work", "report", "step_report", "tree_bytes"]
