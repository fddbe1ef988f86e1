"""Launchers: ``python -m repro_torch.launch.serve`` (the serving path).

The training launchers are slice 11b of the port (``ROADMAP.md``)."""
