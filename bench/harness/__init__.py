"""The benchmark harness of the PyTorch port (``repro_torch``).

``bench/run.py`` is the command.  Everything that belongs to one model
configuration, one traffic mix, one cell or one per-layer metric is a file
of its own under ``bench/`` that the harness finds by name:

* ``configs/<config>.json``: the sizes as run, the source they come from,
  the keys changed from it, and the plain reference module that checks it;
* ``traffic/<traffic>.json``: a mix's parameters (the runner that runs it,
  mesh, sync, batch and sequence a rank, token distribution, optimizer);
* ``workloads/<cell>.json``: a cell, a configuration under a mix, with the
  limits of the comparison that decides ``correct``;
* ``metrics/<metric>.py``: a reader of one per-layer metric;
* ``reference/<module>.py``: a plain reference implementation;
* ``runners/<kind>.py``: the code that runs a kind of mix.

Nothing here imports JAX or the JAX package ``repro``; the references
import nothing of ``repro_torch``.
"""
