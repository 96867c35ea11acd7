"""Parallel paths of the port on ``torch.distributed``: meshes and shardings
for data, tensor and ZeRO parallelism (``mesh``), the differentiable
collectives they use (``comm``), the GPipe pipeline (``pipeline``), and the
sequence-sharded FFT convolution (``seq_conv``), which distributes one long
conv over the ranks of a mesh dimension, with the train-step helpers of a
model whose sequence is sharded."""

from flashfftconv_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    sequence_sharding,
    shard_parameters,
    zero1_shardings,
    zero2_shardings,
)
from flashfftconv_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
    stage_param_shardings,
)
from flashfftconv_tpu_torch.parallel.seq_conv import (
    seq_backward,
    seq_fft_conv,
    seq_fft_conv_padded,
    seq_group,
    seq_halo,
)

__all__ = [
    "batch_sharding",
    "make_mesh",
    "param_shardings",
    "pipeline_apply",
    "sequence_sharding",
    "shard_parameters",
    "stack_stage_params",
    "stage_param_shardings",
    "zero1_shardings",
    "zero2_shardings",
    "seq_fft_conv",
    "seq_fft_conv_padded",
    "seq_halo",
    "seq_group",
    "seq_backward",
]
