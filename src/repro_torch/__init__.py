"""repro_torch — the PyTorch / CUDA port of the ``repro`` package.

The integer-only CNN inference path of the paper (power-of-two int8
quantization, the standard / grouped / depthwise-separable / shift / add
primitives, the layer-graph lowering and executor, and the CNN serving
engine), and the LM serve path (a dense LM with the paper's integer FFN,
and the ssm family's Mamba blocks on the depthwise ``causal_conv1d``) on
an NVIDIA Hopper card, with hand-written CUDA C++ kernels under
``kernels/csrc``.

Each module keeps the name and layout of its counterpart in the JAX package
(NHWC activations, HWIO weights, int8 codes with an integer ``frac_bits``),
so tests compare the two with no transposes. This package imports neither
JAX nor the JAX package; importing it builds nothing — the kernels are
compiled at their first launch on a card (``kernels/_build.py``).

Every entry point takes ``device=`` and defaults to ``"cuda"``; with no
card it raises rather than quietly running on the host
(:func:`repro_torch.device.resolve_device`).
"""
