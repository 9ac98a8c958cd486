"""Distributed layer: process groups, meshes, shardings and the sharded
sweeps and decoder (the port of ``ldpc_tpu.parallel``)."""

from .mesh import (DATA_AXIS, DCN_AXIS, ICI_AXIS, data_sharding,
                   initialize_distributed, make_hierarchical_mesh,
                   make_mesh, process_batch_slice, replicated_sharding)
from .evaluate import (evaluate_code_sharded, sharded_staged_sweep_step,
                       sharded_sweep_step)
from .rowshard import make_row_sharded_decoder

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "ICI_AXIS", "data_sharding",
    "initialize_distributed", "make_hierarchical_mesh", "make_mesh",
    "process_batch_slice", "replicated_sharding",
    "evaluate_code_sharded", "sharded_staged_sweep_step",
    "sharded_sweep_step",
    "make_row_sharded_decoder",
]
