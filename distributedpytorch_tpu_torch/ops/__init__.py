"""The port's ops: attention (the plain reference, the flash kernels K1-K3
and the ring's K4, K2p, K3p), the conv weight gradient K5, losses,
metrics and pooling.  ``KERNELS`` maps each kernel's name to its wrapper,
whose ``launches`` and ``tensor_core_launches`` count its launches."""

from . import flash_attention as _fa
from .conv import conv3x3_dw as _conv3x3_dw

KERNELS = {"flash_fwd": _fa.flash_attention_fwd,
           "flash_dq": _fa.flash_attention_dq,
           "flash_dkv": _fa.flash_attention_dkv, "conv_dw": _conv3x3_dw,
           "flash_fwd_pos": _fa.flash_attention_partial_fwd,
           "flash_dq_pos": _fa.flash_attention_partial_dq,
           "flash_dkv_pos": _fa.flash_attention_partial_dkv}
