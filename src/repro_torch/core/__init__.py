"""repro_torch.core — quantization, primitives, BN folding and the
integer-only layer forward (ports of ``repro/core``)."""
from .folding import FOLDABLE, fold
from .primitives import (ConvSpec, Primitives, apply, batchnorm_apply, init,
                         init_block)
from .quantize import QTensor, frac_bits_for, quantize, requantize, rshift_round

__all__ = ["FOLDABLE", "fold", "ConvSpec", "Primitives", "apply",
           "batchnorm_apply", "init", "init_block", "QTensor",
           "frac_bits_for", "quantize", "requantize", "rshift_round"]
