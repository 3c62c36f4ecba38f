"""Multi-process rendering over ``torch.distributed`` (counterpart of
``pathtrace_tpu/parallel``): :mod:`.distributed` forms the process group and
the ``(dp, sp)`` mesh of ranks, :mod:`.sharding` renders over it."""
