"""The port's launchers: ``steps`` (the train, prefill and serve steps,
the abstract train state and its shardings, the sharded train step),
``mesh`` (the production and test meshes) and
``python -m repro_torch.launch.train``.  The dry-run tooling waits for
ROADMAP queue 1, 13.5d."""
