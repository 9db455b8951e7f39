"""The fleet drills: the end-to-end checks of what the system promises.

Counterparts of the JAX package's ``scripts/serve_load.py``,
``scripts/soak.py`` and ``scripts/chaos_multihost.py``, each run as
``python -m gameoflifewithactors_torch.drills.<name>`` with the JAX
script's flags, defaults, output lines and report fields, plus
``--device {cuda,cpu}`` (default the card; without one a drill exits
non-zero before it starts anything):

- :mod:`.serve_load`: hundreds of sessions over HTTP, a SIGKILL and
  ``--resume`` of the server, sampled grids held against :mod:`.oracle`;
- :mod:`.soak`: a mixed fleet of supervised soak workers and their
  unfaulted twins under a seeded FaultPlan and ``GOLTPU_SANITIZE=1``;
- :mod:`.chaos_multihost`: an elastic fleet through a kill, a preemption
  and checkpoint rot, its final grid held against the single-device
  packed stepper.

Each keeps its parameters (families, shapes, sessions, processes,
generations) as arguments of a plain function, so that a caller can run
it at other sizes than the CLI's defaults.
"""
