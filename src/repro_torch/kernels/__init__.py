"""repro_torch.kernels — the port's kernel layer: hand-written CUDA C++
kernels for Hopper (``csrc/``, built at first launch by ``_build.py``),
each with a plain PyTorch version and a launch counter, dispatched by
``ops``. The four weight-carrying convolutions and the LM's matmul have an
int8 mode (``*_q8``) and a W4A8 mode (``*_w4``) that reads nibble-packed
weights; the five convolutions, the pool and the matmul have a float32 /
bfloat16 mode (``*_f``); Mamba's depthwise ``causal_conv1d`` is a float32 /
bfloat16 kernel. Every wrapper takes its launch-shape knobs (a tile,
``threads`` for the pools, ``run`` and ``threads`` for
``causal_conv1d``), which
``repro_torch.tune`` searches; no knob changes an output.

Importing this package builds nothing and needs no ``nvcc``."""
from .conv1d_causal import causal_conv1d, causal_conv1d_plain
from .conv_add import (add_conv2d_f, add_conv2d_f_plain, add_conv2d_q8,
                       add_conv2d_q8_plain, add_conv2d_w4,
                       add_conv2d_w4_plain)
from .conv_dw import (depthwise2d_f, depthwise2d_f_plain, depthwise2d_q8,
                      depthwise2d_q8_plain, depthwise2d_w4,
                      depthwise2d_w4_plain)
from .conv_im2col import (conv2d_f, conv2d_f_plain, conv2d_q8,
                          conv2d_q8_plain, conv2d_w4, conv2d_w4_plain)
from .conv_shift import (shift_conv2d_f, shift_conv2d_f_plain,
                         shift_conv2d_q8, shift_conv2d_q8_plain,
                         shift_conv2d_w4, shift_conv2d_w4_plain)
from .matmul_q8 import (matmul_f, matmul_f_plain, matmul_q8, matmul_q8_plain,
                        matmul_w4, matmul_w4_plain)
from .pool import maxpool2d_f, maxpool2d_plain, maxpool2d_s8

#: the wrappers that carry a ``launches`` counter
KERNELS = (conv2d_q8, depthwise2d_q8, maxpool2d_s8, shift_conv2d_q8,
           add_conv2d_q8, conv2d_w4, depthwise2d_w4, shift_conv2d_w4,
           add_conv2d_w4, matmul_q8, matmul_w4, causal_conv1d, conv2d_f,
           depthwise2d_f, maxpool2d_f, shift_conv2d_f, add_conv2d_f,
           matmul_f)


def reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    for k in KERNELS:
        k.launches = 0


__all__ = ["KERNELS", "add_conv2d_f", "add_conv2d_f_plain", "add_conv2d_q8",
           "add_conv2d_q8_plain", "add_conv2d_w4", "add_conv2d_w4_plain",
           "causal_conv1d", "causal_conv1d_plain", "conv2d_f",
           "conv2d_f_plain", "conv2d_q8", "conv2d_q8_plain", "conv2d_w4",
           "conv2d_w4_plain", "depthwise2d_f", "depthwise2d_f_plain",
           "depthwise2d_q8", "depthwise2d_q8_plain", "depthwise2d_w4",
           "depthwise2d_w4_plain", "matmul_f", "matmul_f_plain", "matmul_q8",
           "matmul_q8_plain", "matmul_w4", "matmul_w4_plain", "maxpool2d_f",
           "maxpool2d_plain", "maxpool2d_s8", "reset_launches",
           "shift_conv2d_f", "shift_conv2d_f_plain", "shift_conv2d_q8",
           "shift_conv2d_q8_plain", "shift_conv2d_w4",
           "shift_conv2d_w4_plain"]
