"""Rank decomposition of the solvers over ``torch.distributed`` (twin of
``multigrid_tpu/parallel``): :mod:`.sharding` (ranks, the rank grid,
launch), :mod:`.halo` (boxes of cells on z or z x y, the two-stage ghost refresh,
``HaloLaplace`` and ``HaloLaplace2D``),
:mod:`.dg_halo` (DG cell boxes, the two wires, ``HaloDGLaplace`` and
``HaloDGLaplace2D``), :mod:`.distributed` (``DistributedMultigrid``,
``DistributedMultigridDG``), :mod:`.programs` (rank programs for
:func:`.sharding.launch`)."""
