"""The examples of the port, one module each (counterparts of the
repository's ``examples/*.py``):

* ``quickstart`` — the figure-1 scenario through ``run_dsc``;
* ``maritime_clustering`` — AIS-like lanes through ``run_dsc_distributed``
  on a ``('part', 'model') = (4, 2)`` mesh of spawned ranks;
* ``serve_lm`` — the serving launcher on a reduced gemma2-2b;
* ``train_lm`` — the training launcher, checking that the loss drops.

Run each as ``python -m repro_torch.examples.<name>``: on the card unless
``--device cpu`` asks for the CPU (with no card the default raises).  Each
prints the reference example's lines and its ``main(argv=None)`` returns
what it computed.  Importing a module runs nothing.
"""
