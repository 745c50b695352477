"""Multi-GPU training over ``torch.distributed``: the mesh and the row
slice (``mesh``), the collectives (``collectives``), tensor and sequence
parallelism (``tensor_parallel``), FSDP (``fsdp``) and the split-vocabulary
cross entropy (``vocab_parallel``)."""

from .mesh import FSDP_MIN_SIZE, TP_RULES, Mesh, batch_axes, local_row_range, make_mesh, param_sharding  # noqa: F401
