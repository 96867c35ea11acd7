"""flashfftconv_tpu_torch: the PyTorch and CUDA port of flashfftconv_tpu.

Long depthwise FFT convolutions y = iFFT(FFT(u) * FFT(k)) as hand-written
CUDA kernels for Hopper (sm_90a), forward and backward, a short depthwise
conv kernel and its backward, and the Hyena language model on top of them,
with the train step of the JAX package's ``examples/lm`` recipe. From FFT
size 65536 to 4194304 forward and backward run through the butterfly,
band-conv, long-spectrum, band-backward and dk-finish kernels (``models.dna``
serves and trains HyenaDNA on them); up to FFT size 512 the direct-DFT
kernels do (``models.bert`` serves and trains M2-BERT on them). Public API
parity with the JAX package for what this port covers; entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from flashfftconv_tpu_torch.module import FlashDepthWiseConv1d, FlashFFTConv
from flashfftconv_tpu_torch.ops.depthwise import DepthwiseFunction, depthwise_conv1d
from flashfftconv_tpu_torch.ops.dispatch import fft_conv
from flashfftconv_tpu_torch.ops.monarch import fft_conv_plain, fft_conv_reference
from flashfftconv_tpu_torch.ops.monarch_cuda import FftConvFunction
from flashfftconv_tpu_torch.ops.plan import FftPlan, default_factors, make_plan
from flashfftconv_tpu_torch.models.bert import M2BertForMaskedLM
from flashfftconv_tpu_torch.models.m2_bert import BlockdiagLinear, MonarchMixerSequenceMixing
from flashfftconv_tpu_torch.utils.data import lm_batches, mlm_batches
from flashfftconv_tpu_torch.utils.metrics import cross_entropy
from flashfftconv_tpu_torch.utils.optim import make_optimizer
from flashfftconv_tpu_torch.utils.train import (
    bert_optimizer,
    dna_optimizer,
    lm_optimizer,
    make_eval_step,
    make_train_step,
    mlm_loss,
)

__version__ = "0.1.0"

__all__ = [
    "FlashFFTConv",
    "FlashDepthWiseConv1d",
    "FftPlan",
    "make_plan",
    "default_factors",
    "fft_conv",
    "fft_conv_plain",
    "fft_conv_reference",
    "depthwise_conv1d",
    "FftConvFunction",
    "DepthwiseFunction",
    "cross_entropy",
    "make_optimizer",
    "lm_optimizer",
    "dna_optimizer",
    "bert_optimizer",
    "lm_batches",
    "mlm_batches",
    "M2BertForMaskedLM",
    "MonarchMixerSequenceMixing",
    "BlockdiagLinear",
    "make_train_step",
    "mlm_loss",
    "make_eval_step",
]
