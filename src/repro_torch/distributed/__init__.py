"""The port's counterpart of ``repro.distributed``: the ``(part, model)``
mesh of ranks over ``torch.distributed`` and its collectives (``mesh``),
and the straggler monitor of the resilient runner (``straggler``)."""
