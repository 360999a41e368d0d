"""Rank decomposition of the FE_Q brick solver over ``torch.distributed``
(twin of ``multigrid_tpu/parallel``): :mod:`.sharding` (ranks, launch),
:mod:`.halo` (z-slabs, ghost refresh, ``HaloLaplace``),
:mod:`.distributed` (``DistributedMultigrid``), :mod:`.programs` (rank
programs for :func:`.sharding.launch`)."""
