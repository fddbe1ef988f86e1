"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path) and
``python -m repro_torch.launch.train`` (training), with :mod:`.mesh`'s
``DeviceMesh`` (the debug and production meshes) and :mod:`.plans`'s
per-cell sharded plans.  The reference's ``launch/dryrun.py`` and
``launch/hlo_cost.py`` are slice 12 (``ROADMAP.md``)."""
