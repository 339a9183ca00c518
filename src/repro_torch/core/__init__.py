"""repro_torch.core — quantization, primitives, BN folding and the
integer-only layer forward (ports of ``repro/core``)."""
from .folding import FOLDABLE, fold
from .primitives import (ConvSpec, Primitives, apply, apply_block,
                         batchnorm_apply, init, init_block)
from .quantize import (QTensor, QTensorW4, expand_w4, frac_bits_for,
                       pack_w4, quantize, quantize_w4, requantize,
                       rshift_round, unpack_w4)

__all__ = ["FOLDABLE", "fold", "ConvSpec", "Primitives", "apply",
           "apply_block", "batchnorm_apply", "init", "init_block", "QTensor",
           "QTensorW4", "expand_w4", "frac_bits_for", "pack_w4", "quantize",
           "quantize_w4", "requantize", "rshift_round", "unpack_w4"]
