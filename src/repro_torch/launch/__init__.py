"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path) and
``python -m repro_torch.launch.train`` (training), with
:mod:`.mesh`'s ``DeviceMesh`` for data parallelism.  The reference's
``launch/plans.py`` (per-cell sharded plans) and ``make_production_mesh``
are slice 11d, ``launch/dryrun.py`` and ``launch/hlo_cost.py`` slice 12
(``ROADMAP.md``)."""
