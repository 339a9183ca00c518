"""repro_torch.models — the paper-side CNN (port of
``repro/models/convnet.py``) and the dense and ssm LMs of the serve path
(``blocks``, ``attention``, ``mamba``, ``transformer``, ``api``; ports of
the same modules of ``repro/models``)."""
from .convnet import (CNNConfig, calibrate_bn, cnn_forward, cnn_loss,
                      cnn_value_and_grad, init_cnn, quantize_cnn)

__all__ = ["CNNConfig", "calibrate_bn", "cnn_forward", "cnn_loss",
           "cnn_value_and_grad", "init_cnn", "quantize_cnn"]
