"""The port's launchers: ``steps`` (the train, prefill and serve steps,
the abstract train state and its shardings, the sharded train step, the
per-rank serving steps, ``SHAPES`` and the dry run's batch and cache specs
and cells), ``mesh`` (the production and test meshes),
``python -m repro_torch.launch.train``, and the dry run: ``dryrun`` (one
cell's per-rank program traced on fake tensors under a fake process
group), ``roofline`` (its H100 terms), ``run_matrix``, ``report``,
``perf`` and ``gen_perf`` (the tools over its JSONs)."""
