"""The training step of the port (counterpart of ``repro.train``)."""
