"""The distributed layer: the sharding rules of the mesh layouts
(:mod:`.sharding`), the int8 error-feedback gradient mean over a process
group (:mod:`.collectives`) and the elastic re-mesh of a data-parallel job
(:mod:`.elastic`)."""
from .collectives import (psum_compressed_leaf, quantize_int8_global,
                          tree_psum, tree_psum_compressed, zeros_residuals)
from .elastic import (RemeshPlan, make_mesh_from_plan, plan_remesh,
                      plan_remesh_shape, reshard_state)
from .sharding import (batch_spec, cache_specs, data_axes, input_shardings,
                       param_specs, state_specs)

__all__ = [
    "RemeshPlan", "batch_spec", "cache_specs", "data_axes",
    "input_shardings", "make_mesh_from_plan", "param_specs", "plan_remesh",
    "plan_remesh_shape", "psum_compressed_leaf", "quantize_int8_global",
    "reshard_state", "state_specs", "tree_psum", "tree_psum_compressed",
    "zeros_residuals",
]
