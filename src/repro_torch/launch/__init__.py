"""The port's launchers: ``steps`` (the train, prefill and serve steps)
and ``python -m repro_torch.launch.train``.  The dry-run tooling and the
production meshes wait for the mesh substrate (ROADMAP queue 1, 13.5)."""
