"""The port's counterpart of ``repro.distributed``: meshes of ranks over
``torch.distributed`` with their collectives and ``shard_map``
(``mesh``), the partitioning rules (``partition``), GPipe pipelining
(``pipeline``), and the straggler monitor of the resilient runner
(``straggler``)."""
