"""Rank decomposition of the solvers over ``torch.distributed`` (twin of
``multigrid_tpu/parallel``): :mod:`.sharding` (ranks, the rank grid,
launch), :mod:`.halo` (z-slabs, ghost refresh, ``HaloLaplace``),
:mod:`.dg_halo` (DG cell slabs, the two wires, ``HaloDGLaplace`` and
``HaloDGLaplace2D``), :mod:`.distributed` (``DistributedMultigrid``,
``DistributedMultigridDG``), :mod:`.programs` (rank programs for
:func:`.sharding.launch`)."""
