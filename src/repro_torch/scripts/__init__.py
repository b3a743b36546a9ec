"""The port's counterparts of the JAX package's scripts that import it,
one module each, run as ``python -m repro_torch.scripts.<name>``:

    chaos_soak   the CI chaos lane: a mixed-tenant workload through the
                 async runtime under the ``REPRO_FAULTS`` plan
    lint         the static-analysis tiers (``repro_torch.analysis``)

Each has ``main(argv=None) -> int``; an exit code other than 0 is the
verdict.
"""
